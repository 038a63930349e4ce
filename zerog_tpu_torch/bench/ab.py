"""Builds of the kernel library held against each other on the card, in
turns: ``ntt_epilogue`` at every level of the WNN proof's forward
transforms (2^14 and 2^17, six columns) and ``weighted_fold`` at the MSM's
shape (K = 128 rows, 16 lanes) on dense rows and on rows that are mostly the
identity.

    python -m zerog_tpu_torch.bench.ab DIR [DIR ...]

builds this tree's ``csrc/`` and each DIR (the ``csrc/`` of another tree, such
as the parent commit's, with the same C functions) into a library of its own
under ``_build/``, runs every case on each library in turns (A B .. B A, so
that drift on the card falls on both alike), holds their outputs equal word
for word, and prints one JSON line a case with each library's ms (the median
of its turns, each turn the median of 5 runs by :func:`time_ms`), then one
line with each library's ``ptxas`` report of the two kernels, and the card's
name and power limit. It raises without a card or if two libraries disagree.
"""

from __future__ import annotations

import json
import os
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
from . import gpu_line, time_ms

__all__ = ["epilogue_cases", "weighted_cases", "main"]

DEV = torch.device("cuda", 0)
BATCH = 6          # advice columns of the MNIST-Tiny WNN circuit


def epilogue_cases(seed=1):
    """Every epilogue of one forward transform of BATCH random columns at
    2^14 and at 2^17, as the engine launches them (its real accumulators):
    a case is (name, C function, input pointers, the trailing int arguments,
    the outputs' shapes and dtypes, the input tensors)."""
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
                          "zg_ntt_epilogue",
                          (acc.data_ptr(), colsum.data_ptr(), rowc.data_ptr(), None),
                          (t, lanes, int(out_bytes)), [out], (acc, colsum, rowc)))
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
                      "zg_weighted_fold", tuple(p.data_ptr() for p in planes),
                      (k, lanes), [((8, lanes), torch.int32)] * 3, planes))
    return cases


def _runner(lib, fn, ptrs, tail, outs):
    out = [torch.empty(shape, dtype=dtype, device=DEV) for shape, dtype in outs]
    stream = kernels.current_stream(DEV)

    def run():
        code = getattr(lib, fn)(*ptrs, *(o.data_ptr() for o in out), *tail, stream)
        if code != 0:
            raise RuntimeError(f"{fn}: kernel launch failed (CUDA error {code})")
    return run, out


def main(argv=None):
    dirs = list(sys.argv[1:] if argv is None else argv)
    if not dirs or not torch.cuda.is_available():
        raise SystemExit("usage: python -m zerog_tpu_torch.bench.ab DIR [DIR ...] "
                         "(needs a CUDA card)")
    torch.cuda.set_device(DEV)
    names = ["this tree"] + dirs
    libs, ptxas = [], {}
    for i, src in enumerate([kernels.CSRC_DIR] + dirs):
        path = kernels.build(force=True, csrc_dir=os.path.abspath(src),
                             build_dir=os.path.join(kernels.BUILD_DIR, f"ab{i}"))
        libs.append(kernels.load(path))
        ptxas[names[i]] = {k: v for k, v in kernels.BUILD_INFO["ptxas"].items()
                           if k in ("weighted_fold_kernel", "ntt_epilogue_kernel")}
    order = list(range(len(libs))) + list(range(len(libs)))[::-1]
    for name, fn, ptrs, tail, outs, _ in epilogue_cases() + weighted_cases():
        runs = [_runner(lib, fn, ptrs, tail, outs) for lib in libs]
        for run, _ in runs:
            run()
        torch.cuda.synchronize()
        first = runs[0][1]
        for (_, out), label in zip(runs[1:], names[1:]):
            if not all(torch.equal(a, b) for a, b in zip(first, out)):
                raise AssertionError(f"{name}: {label} != this tree")
        turns = {label: [] for label in names}
        for i in order:
            turns[names[i]].append(time_ms(runs[i][0]))
        print(json.dumps(dict(case=name, equal=True, ms={
            label: statistics.median(v) for label, v in turns.items()},
            turns_ms=turns)), flush=True)
    print(json.dumps(dict(ptxas=ptxas, gpu=gpu_line())), flush=True)


if __name__ == "__main__":
    main()
