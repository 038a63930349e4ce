"""Builds of the kernel library held against each other on the card, in
turns: ``ntt_twiddle`` and ``ntt_epilogue`` at every level of the WNN
proof's forward transforms (2^14 and 2^17, six columns), ``field_binop``
(Fq product) at n = 2^17 and 2^20, ``weighted_fold`` at the MSM's shape
(K = 128 rows, 16 lanes) on dense rows and on rows that are mostly the
identity, and the ``scan_bisect`` bodies ``madd``, ``mul_smem`` and
``mul_reg`` at R = 1,024 rows x 2,560 and 20,480 columns (the benchmark's
inputs).

    python -m zerog_tpu_torch.bench.ab DIR[:sum|:nocheck] [DIR ...] [--cases K,..]

builds this tree's ``csrc/`` and each DIR (the ``csrc/`` of another tree, such
as the parent commit's, with the same C functions) into a library of its own
under ``_build/``, runs every case on each library in turns (A B .. B A, so
that drift on the card falls on both alike), holds their outputs equal word
for word, and prints one JSON line a case with each library's ms (the median
of its turns, each turn the median of 5 runs by :func:`time_ms`), then one
line with each library's ``ptxas`` report of the kernels and their
registers and shared memory read by ``cuobjdump -res-usage``, and the
card's name and power limit. It raises without a card or if two libraries
disagree.

A ``ntt_twiddle`` case is what the engine runs between a level's inner
transforms and its outer product: this tree's ``zg_ntt_twiddle`` writes the
outer product's input and its column sums in one launch. A DIR whose
``zg_ntt_twiddle`` takes seven arguments (the twiddle alone, as before the
regroup and the sums were fused into it) is followed, as the engine then
ran it, by the torch regroup copy and the sum of the columns; ``DIR:sum``
follows a fused launch by that sum in place of the kernel's own.
``DIR:nocheck`` times a library whose outputs are not this tree's (a kernel
with a part taken out, to see what that part costs) without holding them
equal. ``--cases`` keeps the kinds of case named (of ``twiddle``,
``binop``, ``epilogue``, ``weighted``, ``bisect``; all by default).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import sys

import numpy as np
import torch

from .. import kernels
from ..curve import pfold, pippenger
from ..curve.jpoints import jac_double, jac_from_affine, points_to_device
from ..curve.bn254 import G1_GEN
from ..poly import pntt
from ..poly.ntt import NttPlan
from . import gpu_line, random_words, sass, time_ms, scan_bisect

__all__ = ["epilogue_cases", "twiddle_cases", "binop_cases", "weighted_cases",
           "bisect_cases", "main"]

DEV = torch.device("cuda", 0)
BATCH = 6          # advice columns of the MNIST-Tiny WNN circuit


def epilogue_cases(seed=1):
    """Every epilogue of one forward transform of BATCH random columns at
    2^14 and at 2^17, as the engine launches them (its real accumulators):
    a case is (name, builder, the input tensors), where builder(lib, spec)
    returns (a run on that library, its output tensors)."""
    rng = np.random.default_rng(seed)
    cases = []
    for log_n in (14, 17):
        plan = NttPlan(log_n, device=DEV)
        limbs = rng.integers(0, 1 << 16, (BATCH, 1 << log_n, 16), dtype=np.int64)
        limbs[..., 15] &= 0x1FFF
        calls = []
        saved = pntt.epilogue

        def record(acc, colsum, rowc, tw=None, out_bytes=True):
            calls.append((acc, colsum, rowc, out_bytes))
            return saved(acc, colsum, rowc, tw, out_bytes)

        pntt.epilogue = record
        try:
            plan.ntt(torch.from_numpy(limbs).to(DEV))
        finally:
            pntt.epilogue = saved
        for i, (acc, colsum, rowc, out_bytes) in enumerate(calls):
            t, lanes = acc.shape[1], acc.shape[2]
            out = ((32, t, lanes), torch.int8) if out_bytes else ((8, t, lanes),
                                                                  torch.int32)
            cases.append((f"ntt_epilogue 2^{log_n} level {i}: t={t} x {lanes} lanes, "
                          f"{'bytes' if out_bytes else 'words'} out",
                          _launcher("zg_ntt_epilogue",
                                    (acc.data_ptr(), colsum.data_ptr(),
                                     rowc.data_ptr(), None),
                                    (t, lanes, int(out_bytes)), [out]),
                          (acc, colsum, rowc)))
    return cases


def twiddle_cases(seed=3):
    """Every ``ntt_twiddle`` of one forward transform of BATCH random columns
    at 2^14 and at 2^17 (the inner and the outer level), on the engine's own
    inputs, as :func:`epilogue_cases` gives them."""
    rng = np.random.default_rng(seed)
    cases = []
    for log_n in (14, 17):
        plan = NttPlan(log_n, device=DEV)
        limbs = rng.integers(0, 1 << 16, (BATCH, 1 << log_n, 16), dtype=np.int64)
        limbs[..., 15] &= 0x1FFF
        calls = []
        saved = pntt.twiddle

        def record(xb, twc):
            calls.append((xb, twc))
            return saved(xb, twc)

        pntt.twiddle = record
        try:
            plan.ntt(torch.from_numpy(limbs).to(DEV))
        finally:
            pntt.twiddle = saved
        for xb, twc in calls:
            s, r = xb.shape[1], twc.shape[2]
            g = xb.shape[2] // r
            cases.append((f"ntt_twiddle 2^{log_n}: s={s}, r={r}, G={g}",
                          _twiddle_builder(xb, twc), (xb, twc)))
    return cases


def _twiddle_builder(xb, twc):
    s, r = xb.shape[1], twc.shape[2]
    g = xb.shape[2] // r

    def build(lib, spec):
        out = torch.empty((32, r, s * g), dtype=torch.int8, device=DEV)
        colsum = torch.empty(s * g, dtype=torch.int32, device=DEV)
        def column_sums():
            torch.sum(out.view(32 * r, s * g), dim=0, dtype=torch.int32, out=colsum)

        if spec["twiddle_args"] == 7:
            mid = torch.empty_like(xb)

            def run():
                with kernels.on_device(xb) as stream:
                    _check(lib.zg_ntt_twiddle(xb.data_ptr(), twc.data_ptr(),
                                              mid.data_ptr(), s, r, g, stream))
                out.view(32, r, s, g).copy_(mid.view(32, s, r, g).transpose(1, 2))
                column_sums()
        else:
            def run():
                with kernels.on_device(xb) as stream:
                    _check(lib.zg_ntt_twiddle(xb.data_ptr(), twc.data_ptr(),
                                              out.data_ptr(), colsum.data_ptr(),
                                              s, r, g, stream))
                if spec["sum"]:
                    column_sums()
        return run, [out, colsum]
    return build


def binop_cases(seed=4):
    """``field_binop`` Fq products at n = 2^17 (8 columns of a k = 14
    proof) and 2^20 (8 columns at the k = 17 Large shape) on random
    canonical word planes."""
    rng = np.random.default_rng(seed)
    cases = []
    for log_n in (17, 20):
        n = 1 << log_n
        a, b = (random_words(rng, (n,)).to(DEV) for _ in range(2))
        cases.append((f"field_binop Fq mul n=2^{log_n}",
                      _launcher("zg_field_binop", (a.data_ptr(), b.data_ptr()),
                                (n, 0, 0), [((8, n), torch.int32)]), (a, b)))
    return cases


def weighted_cases(seed=2, k=128, lanes=16):
    """``weighted_fold`` cases at the MSM's shape, as :func:`epilogue_cases`
    gives them: rows of random Jacobian points (z != 1), every row a point
    (dense) or 97 % of them the identity, and the MSM's bias in every
    lane."""
    rng = np.random.default_rng(seed)
    scalars = [int(s) | 1 for s in rng.integers(1, 1 << 62, 256)]
    aff = jac_from_affine(*points_to_device(
        pippenger.fixed_base_expand(G1_GEN, scalars, device=DEV), device=DEV))
    pool = jac_double(aff)
    _, bias = pippenger._pip_bias(DEV)
    bias_planes = [kernels.to_word_planes(b.expand(lanes, 16)) for b in bias]
    cases = []
    for name, share in (("dense", 0.0), ("97 % identity", 0.97)):
        idx = torch.from_numpy(rng.integers(0, len(scalars), (k, lanes))).to(DEV)
        keep = torch.from_numpy(rng.random((k, lanes)) >= share).to(DEV)[..., None]
        rows = [pfold._rows_to_planes(torch.where(keep, c[idx], 0)) for c in pool]
        planes = rows + bias_planes
        cases.append((f"weighted_fold K={k} x {lanes} lanes, {name}",
                      _launcher("zg_weighted_fold", tuple(p.data_ptr() for p in planes),
                                (k, lanes), [((8, lanes), torch.int32)] * 3),
                      planes))
    return cases


def bisect_cases():
    """``scan_bisect`` ``madd``, ``mul_smem`` and ``mul_reg`` on the
    benchmark's inputs: R = ROWS rows of COLS and WIDE columns, flags at
    10 %."""
    wide_in = [t.to(DEV) for t in scan_bisect.make_inputs(scan_bisect.ROWS,
                                                          scan_bisect.WIDE)]
    cases = []
    for cols in (scan_bisect.COLS, scan_bisect.WIDE):
        sx, sy, flags = (t[..., :cols].contiguous() for t in wide_in)
        for body in ("madd", "mul_smem", "mul_reg"):
            cases.append((f"scan_bisect_{body} R={scan_bisect.ROWS} x {cols} columns",
                          _launcher("zg_scan_bisect",
                                    (scan_bisect.BODIES.index(body), sx.data_ptr(),
                                     sy.data_ptr(), flags.data_ptr()),
                                    (scan_bisect.ROWS, cols), [(tuple(sx.shape),
                                                                torch.int32)]),
                          (sx, sy, flags)))
    return cases


# the kernels whose build reports the last line gives
AB_KERNELS = ("weighted_fold_kernel", "ntt_epilogue_kernel", "ntt_twiddle_kernel",
              "field_binop_kernel", "scan_bisect_")
CASES = {"twiddle": twiddle_cases, "binop": binop_cases, "epilogue": epilogue_cases,
         "weighted": weighted_cases, "bisect": bisect_cases}


def _check(code):
    if code != 0:
        raise RuntimeError(f"kernel launch failed (CUDA error {code})")


def _launcher(fn, ptrs, tail, outs):
    """The builder of a case that calls C function `fn` with the input
    pointers, one new tensor per output (shape, dtype), the trailing int
    arguments and the stream."""
    def build(lib, spec):
        out = [torch.empty(shape, dtype=dtype, device=DEV) for shape, dtype in outs]
        def run():
            with kernels.on_device(out[0]) as stream:
                _check(getattr(lib, fn)(*ptrs, *(o.data_ptr() for o in out),
                                        *tail, stream))
        return run, out
    return build


def _twiddle_args(csrc_dir):
    """The number of arguments of ``zg_ntt_twiddle`` in `csrc_dir`'s
    ``ntt.cu``."""
    with open(os.path.join(csrc_dir, "ntt.cu")) as f:
        m = re.search(r'extern "C" int zg_ntt_twiddle\(([^)]*)\)', f.read())
    return m.group(1).count(",") + 1


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    kinds = list(CASES)
    if "--cases" in args:
        i = args.index("--cases")
        kinds = args[i + 1].split(",")
        del args[i:i + 2]
    if not args or not torch.cuda.is_available() or not set(kinds) <= set(CASES):
        raise SystemExit("usage: python -m zerog_tpu_torch.bench.ab DIR[:sum|:nocheck] "
                         f"... [--cases {','.join(CASES)}] (needs a CUDA card)")
    torch.cuda.set_device(DEV)
    names = ["this tree"] + args
    dirs = [kernels.CSRC_DIR] + [os.path.abspath(a.split(":")[0]) for a in args]
    libs, specs, ptxas, usage = [], [], {}, {}
    for i, src in enumerate(dirs):
        path = kernels.build(force=True, csrc_dir=src,
                             build_dir=os.path.join(kernels.BUILD_DIR, f"ab{i}"))
        lib = kernels.load(path)
        spec = dict(twiddle_args=_twiddle_args(src), sum=names[i].endswith(":sum"))
        if spec["twiddle_args"] == 7:
            lib.zg_ntt_twiddle.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long] * 3 + [
                ctypes.c_void_p]
        libs.append(lib)
        specs.append(spec)
        ptxas[names[i]] = {k: v for k, v in kernels.BUILD_INFO["ptxas"].items()
                           if k.startswith(AB_KERNELS)}
        usage[names[i]] = {k: v for k, v in sass.res_usage(path).items()
                           if k.startswith(AB_KERNELS)}
    order = list(range(len(libs))) + list(range(len(libs)))[::-1]
    for name, build, _ in [case for kind in kinds for case in CASES[kind]()]:
        runs = [build(lib, spec) for lib, spec in zip(libs, specs)]
        for run, _ in runs:
            run()
        torch.cuda.synchronize()
        first = runs[0][1]
        for (_, out), label in zip(runs[1:], names[1:]):
            if label.endswith(":nocheck"):
                continue
            if not all(torch.equal(a, b) for a, b in zip(first, out)):
                raise AssertionError(f"{name}: {label} != this tree")
        turns = {label: [] for label in names}
        for i in order:
            turns[names[i]].append(time_ms(runs[i][0]))
        print(json.dumps(dict(case=name, equal=[n for n in names
                                                 if not n.endswith(":nocheck")], ms={
            label: statistics.median(v) for label, v in turns.items()},
            turns_ms=turns)), flush=True)
    print(json.dumps(dict(ptxas=ptxas, res_usage=usage, gpu=gpu_line())), flush=True)


if __name__ == "__main__":
    main()
