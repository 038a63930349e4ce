#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zerog_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

builds the CUDA kernels from ``zerog_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version at the shapes a k = 14 proof gives it
(tolerance zero: exact integer arithmetic), holds the int8-DFT NTT engine
against the butterflies at k = 14 and 17, then drives the port's paths —
``Srs.setup -> keygen -> create_proof -> verify_proof`` at k = 14 on a
filler circuit, and the WNN proof of inference on a seeded model of the
MNIST-Tiny shape (``Wnn.generate_proving_key -> Wnn.proof ->
Wnn.verify_proof``) — with every commitment and every large NTT going
through the kernels, and checks the results by the repo's own means
(commitments against the tau ground truth, the device prediction against the
exact one, proofs verify, tampered proofs and wrong instances rejected, equal
seeds give equal bytes, engine and butterflies give equal bytes).

``flush_scan_affine`` is also held and timed with flags only at row 0
(``one_segment``: every column one segment of all R rows, the worst case
for its segment split). ``flush_scan_jac``, ``sum_rows`` and
``weighted_fold`` are also held and timed on dense inputs (no identity
row, so no add can be skipped). Kernels 2-5 are timed again on the
operands of every launch of the warm WNN proof (``path_kernels`` line: the
launches recorded during that proof, the share of identity or invalid
rows, the adds really required and the longest chain of them, and the
launch with the longest chain — for ``weighted_fold`` the most rows that
are not the identity — held against the plain version, its recorded
output against a rerun; kernel 2 also its segments — the longest, the
columns that are one segment, its chain floor — and, from each launch's
bucket keys, where bucket 0 sits; kernel 5 also the rows before each
lane's first that is not the identity, which cost no product). Their
``bound_ms`` counts the bytes and adds that the operands require (x and y
of a row are read and an add computed only where the row is valid, not the
identity, and not the first of its segment); ``bound_all_rows_ms`` reads
every row and counts an add for every row. The ``ntt`` line gives each
level's epilogue and twiddle time beside its bound (``bound_share``); a
twiddle level, which also regroups the outer level's input and sums its
columns, also the time of that regroup as a torch copy and sum of the same
bytes (``regroup_copy_ms``: what the engine ran before the kernel took it
in). ``field_binop`` is also timed at n = 2^20 (``ms_wide``). The
``kernels`` line ends with ``launch_floor_ms``, a one-element torch add on
the same timer: the part of a short kernel's time that is the launch. Times
are the card's, by CUDA events behind a spin (``bench.time_ms``), so a
short kernel's time leaves out the host's wrappers. The warm WNN proof's
SHA-256 is asserted: a kernel change must leave the proof's bytes as they
were.

The ``cli`` phase (after ``wnn``, which it implies) drives the user's entry
point, ``zerog_tpu_torch.cli``, at the same width: ``generate-srs -k 14``
(its file read back equal to ``Srs.setup(14)``); the ``wnn`` phase's SRS, key
and circuit params written to files (``Srs.write``, ``models.keys_io``,
``models.io``) and read back; the proof made from the files read back, whose
SHA-256 must be the ``wnn`` phase's; ``verify`` from the files; the k = 14
verifier contract (``eth.gen_evm_verifier``) dry-run in the EVM executor,
accepting the proof and reverting a tampered proof and wrong scores;
``deploy-evm-verifier`` and ``submit-proof`` on the local node (state shared
through ``ZEROG_DEV_NODE_STATE``), the tampered proof's submit reverted. The
subcommands that load an HDF5 model or a PNG are replaced by the functions
they call after loading (the card's machine has no h5py and no PIL). Every
MSM and NTT kernel must be launched in the phase; its ``launches`` are the
``cli`` column of the kernel rows' ``launches_by_path``.

The ``mesh`` phase (on by default, after ``wnn``, which it implies;
``--phases env,build,commit,wnn,mesh`` runs just the mesh) repeats the
``wnn`` phase's warm proof with ``create_proof(..., mesh=mesh)`` on a mesh
of 4 entries on the one card (``zerog_tpu_torch.parallel``: commitments
through ``ShardedSrs``, each entry running the bucket pipeline and so
kernels 2-5 on its quarter of the points; NTTs by the four-step
decomposition, whose sub-plans of 2^7-2^9 stay on the butterflies; the
quotient on row blocks), first and warm: the same pk, SRS, image and seed,
so the bytes must be the ``wnn`` phase's (``WNN_PROOF_SHA256``), and the
proof must verify. Its launches are the ``mesh`` column of the kernel rows'
``launches_by_path``; kernels 2-5 must have launched. It then runs
``dryrun_multichip(4, ["cuda:0"] * 4)`` (the toy circuit at k = 6, mesh and
single-device bytes equal) and holds the MSM strategies against the
prover's: ``scan`` and ``danaa`` against ``pippenger`` on 2 rows over the
first 4,096 points of the k = 14 SRS, ``segscan`` against ``fixed`` on 8
rows over its Lagrange window table, points equal. Its line gives the first
and warm mesh proof's seconds beside the single-device warm proof's, each
strategy's seconds and the dry run's ``scaling_proxy``.

The ``bench`` phase drives the two measuring kernels through their
benchmarks' entry points (``zerog_tpu_torch.bench``): ``field_chain``, 16
chained Fr products an element at n = 2^18, beside 16 launches of
``field_binop``; the four ``scan_bisect`` bodies at R = 1,024 rows and
2,560 and 20,480 columns, each beside its bound counted by what its inputs
need (``madd``: the valid rows) and the chain floor of its design
(``madd``: the longest valid count of a column; ``mul_smem`` and
``mul_reg``: their chunked scans' depths, ``mul_reg`` its longest walk of
interleaved rows, twice, and the rounds of its join), beside
``flush_scan_affine`` at R x 2,560
(its chain floor counts its longest segment), and ``torch.cumsum`` beside
``trivial``, which computes the same function. Their rows in the ``kernels`` line count the
launches of that path (``launches_path``); no proof path runs them.

The run keeps the SRS's merged-window tables in a new temporary directory
(``curve.srs.CACHE_DIR``), so each table is first built and written: the
``commit`` phase reads both bases back for a second ``Srs.setup(14)``
(``tables_cached_s``, equal limb for limb to the tables built), and the
``cli`` phase's proof from the files read back may build no table. The
``env`` phase prints the host C compiler and whether CPython's ``Python.h``
is there (the limb codec needs both: without them the run fails), the
``build`` phase the seconds of the codec's build. The ``codec`` phase holds
the C limb codec (``to_limbs`` / ``from_limbs``) against the numpy path
(``_to_limbs_np`` / ``_from_limbs_np``) limb for limb on 20 x 2^14 and
20 x 2^17 Fr and 20 x 2^14 Fq values, both directions, with and without
Montgomery form, with the seconds of both.

The ``field_limbs`` phase (after ``kernels``; ``--phases
env,build,field_limbs`` runs just it) holds JField's kernel path (``add``,
``sub``, ``mul`` on CUDA tensors: one launch of ``field_limbs`` each)
against JField's plain torch bodies (``add_plain``, ``sub_plain``,
``mul_plain``) on the card, limb for limb, and the first 64 elements against
Python ints: Fq and Fr, at 2^17 and 2^20 result elements, in each addressing
mode of the program (same shape, one element, suffix, outer) and one that
the wrapper copies. Its line gives each case's ms beside its byte bound, and
the plain body's ms for Fr products. Every plain version a kernel is held
against (``field_binop``'s, the MSM kernels', the NTT kernels', the
bisection bodies') and the butterflies the NTT engine is held against run
on JField's plain bodies (``bench.plain_field``), not on ``field_limbs``,
and their ``plain_ms`` time those bodies.

The ``large`` phase (``--phases env,build,codec,large`` runs just it)
proves at MNIST-Large's shape, k = 17 (``make_synthetic_wnn(
*MNIST_LARGE_SHAPE)``, ``Srs.setup(17, seed=b"bench-srs")``; NTTs at 2^17
and the extended 2^20, MSM batches of 2): set-up, both tables cold and then
read from the cache by a second Srs, keygen, two proofs under one seed
(equal bytes, SHA-256 ``LARGE_PROOF_SHA256``), verify, a tampered proof and
wrong scores rejected; the proof's first advice commitment against
[a(tau)]G on the host; the proof's advice transform run again with every
kernel 6 and 7 call held against its plain version (those launches are not
counted) and the engine against the butterflies. Its line gives the seconds, the warm proof's marks, the
launches (the ``large`` column of ``launches_by_path``), the peak device
memory and the proof's bytes and SHA-256.

Every ``bound_ms`` counts a Montgomery product as the IMAD-pipe issue
slots that one ``fe_mul`` takes on the card (``bench.IMAD_SLOTS_PER_MUL``).
The ``build`` phase prints, beside what ptxas reported, each kernel's
registers and shared memory read from the built library by ``cuobjdump
-res-usage``, and the slots of one product counted by opcode in the SASS of
``field_chain``'s loop, and whether they equal that constant (a record, not
a check). The ``env`` phase prints the card's highest SM clock, on which the
peak rate of those slots rests.

It prints one JSON object a line; any phase that fails raises and the run
exits non-zero. Without a CUDA device it exits non-zero at once. The last
line is ``{"ok": true, "device": {...}}``. ``--phases a,b`` runs a subset
(for development: ``env,build,commit,wnn,cli`` runs the entry point's
path, ``env,build,commit,wnn,mesh`` the mesh's); with no arguments every
phase runs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import subprocess
import sys
import sysconfig
import tempfile
import time

import numpy as np
import torch

from zerog_tpu_torch import kernels, native, trace
from zerog_tpu_torch.bench import (IMAD_SLOTS_PER_MUL, bound, flush_scan_affine_bound,
                                   gpu_line, plain_field, segment_ids, time_ms,
                                   wall_ms)
from zerog_tpu_torch.bench import field_chain, sass, scan_bisect
from zerog_tpu_torch.field import (FR, FQ, JField, batch_inv, to_limbs, from_limbs,
                                   to_device)
from zerog_tpu_torch.field import jfield, limbs, pfield
from zerog_tpu_torch.curve import Srs, pscan, pfold, pippenger
from zerog_tpu_torch.curve import srs as srs_module
from zerog_tpu_torch.curve.bn254 import G1_GEN, g1_mul
from zerog_tpu_torch.curve.jpoints import points_from_device, points_to_device
from zerog_tpu_torch.plonk import ConstraintSystem
from zerog_tpu_torch.poly import pntt
from zerog_tpu_torch.poly.domain import get_domain
from zerog_tpu_torch.poly.ntt import NttPlan

DEV = torch.device("cuda", 0)
K = 14
SEED = 20240914

MULS_ADD = 16       # general incomplete add, 12M + 4S
# of the mixed add's 11 products, those on the chain from one row's carry to
# the next (z' = z H, H = x_r z^2 - x)
CARRIED_PRODUCTS_MADD = scan_bisect.CARRIED_PRODUCTS["madd"]
# the warm WNN proof's bytes, unchanged by every kernel change since they
# were first recorded
WNN_PROOF_SHA256 = "99df386d0fd592c34ceb405e502e089e204ff6d89ca83dd6f1f9c22b117d9c66"
# the large phase's warm proof at k = 17, as first recorded
LARGE_PROOF_SHA256 = "d6a1d8064c1bcc31a62e663ace7ce21286ac30a45f9f1c272399d8434dc869e5"

KERNEL_META = {
    "field_binop": ("zerog_tpu_torch/csrc/field_binop.cu",
                    "zerog_tpu/field/pfield.py:252"),
    "field_limbs": ("zerog_tpu_torch/csrc/field_limbs.cu",
                    "none: JField's add, sub and mul (zerog_tpu/field/jfield.py, XLA)"),
    "flush_scan_affine": ("zerog_tpu_torch/csrc/flush_scan.cu",
                          "zerog_tpu/curve/pscan.py:191"),
    "flush_scan_jac": ("zerog_tpu_torch/csrc/flush_scan.cu",
                       "zerog_tpu/curve/pscan.py:241"),
    "sum_rows": ("zerog_tpu_torch/csrc/fold.cu",
                 "zerog_tpu/curve/pfold.py:83"),
    "weighted_fold": ("zerog_tpu_torch/csrc/fold.cu",
                      "zerog_tpu/curve/pfold.py:151"),
    "ntt_epilogue": ("zerog_tpu_torch/csrc/ntt.cu",
                     "zerog_tpu/poly/pntt.py:419"),
    "ntt_twiddle": ("zerog_tpu_torch/csrc/ntt.cu",
                    "zerog_tpu/poly/pntt.py:562"),
    "field_chain": ("zerog_tpu_torch/csrc/bench.cu",
                    "scripts/bench_pallas_field.py:107"),
    "scan_bisect_trivial": ("zerog_tpu_torch/csrc/bench.cu",
                            "scripts/bench_pscan_bisect.py:73"),
    "scan_bisect_mul_smem": ("zerog_tpu_torch/csrc/bench.cu",
                             "scripts/bench_pscan_bisect.py:87"),
    "scan_bisect_mul_reg": ("zerog_tpu_torch/csrc/bench.cu",
                            "scripts/bench_pscan_bisect.py:104"),
    "scan_bisect_madd": ("zerog_tpu_torch/csrc/bench.cu",
                         "scripts/bench_pscan_bisect.py:121"),
}
MSM_KERNELS = ("flush_scan_affine", "flush_scan_jac", "sum_rows",
               "weighted_fold")
NTT_KERNELS = ("ntt_epilogue", "ntt_twiddle")
# the measuring kernels: the path of the two benchmarks' entry points
BENCH_KERNELS = ("field_chain",) + tuple(f"scan_bisect_{b}" for b in scan_bisect.BODIES)
CHAIN_LOG_N = 18    # n of the field chain, bench_pallas_field.py's default
# IMAD-pipe issue slots of one REDC of a 9-word value (fe_redc9): 8 steps of
# one mul.lo for m, 8 mad.lo and 8 mad.hi, counted from its PTX (it has no
# loop of its own in the SASS to read them from)
IMAD_SLOTS_PER_REDC = 136
# the WNN model of the smoke run: MNIST-Tiny's shape, registered at k = 14
# (28-bit filter inputs, 256-entry bloom arrays, 1 hash, 1 bit per input)
TINY_SHAPE = (28, 256, 1, 1)
# the large phase: MNIST-Large's shape (models/synthetic.py), whose least k is 17
LARGE_K = 17


def emit(obj):
    print(json.dumps(obj), flush=True)


def sync():
    torch.cuda.synchronize()


# ---- phase 1: env ---------------------------------------------------------------

def phase_env():
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    release = [l for l in nvcc.splitlines() if "release" in l]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()[0]
    # the host C compiler and CPython's header, which the limb codec needs
    try:
        cc = subprocess.run([native.CC, "--version"], capture_output=True,
                            text=True).stdout.splitlines()[0]
    except (FileNotFoundError, IndexError):
        cc = None
    include = sysconfig.get_paths()["include"]
    python_h = os.path.exists(os.path.join(include, "Python.h"))
    info = dict(phase="env", gpu=gpu_line(), clocks_max_sm=clock,
                torch=torch.__version__, cuda=torch.version.cuda,
                nvcc=release[0].strip() if release else nvcc.strip(),
                host_cc=cc or f"{native.CC}: not found", python_include=include,
                python_h=python_h)
    emit(info)
    if cc is None or not python_h:
        raise RuntimeError("the limb codec needs the host C compiler and "
                           f"{include}/Python.h")
    return info


# ---- phase 2: build -------------------------------------------------------------

def phase_build():
    """Build the kernels; print what ptxas reported, each kernel's registers
    and shared memory as ``cuobjdump -res-usage`` reads them from the built
    library, and the IMAD-pipe slots of one product read from its SASS
    beside IMAD_SLOTS_PER_MUL (a record: a mismatch does not fail)."""
    t0 = time.time()
    path = kernels.build(force=True)
    kernels.lib()
    seconds = time.time() - t0
    # the limb codec, with the host C compiler (built once a checkout)
    prebuilt = native.library_path().exists()
    t0 = time.time()
    native.limbcodec()
    emit(dict(phase="build", seconds=round(seconds, 3),
              ptxas=kernels.BUILD_INFO.get("ptxas", {}), res_usage=sass.res_usage(path),
              imad_slots_per_mul=sass.slots_per_mul(path),
              codec=dict(seconds=round(time.time() - t0, 3),
                         library=native.library_path().name, prebuilt=prebuilt)))


# ---- phase 2b: codec — the host limb codec against its numpy path ------------------

# (field, shape) of the codec's inputs: 20 columns at k = 14 and at k = 17
CODEC_CASES = ((FR, (20, 1 << K)), (FR, (20, 1 << LARGE_K)), (FQ, (20, 1 << K)))


def _rand_field(rng, params, shape):
    """Field elements as an object array of Python ints: 32 random bytes an
    element from `rng`, reduced mod p."""
    count = int(np.prod(shape))
    raw = rng.bytes(32 * count)
    out = np.empty(count, dtype=object)
    out[:] = [int.from_bytes(raw[i:i + 32], "little") % params.p
              for i in range(0, 32 * count, 32)]
    return out.reshape(shape)


def _host_s(fn):
    """(fn(), its seconds on the host's clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_codec():
    """``to_limbs`` / ``from_limbs`` (the C codec) against their numpy
    paths (``_to_limbs_np`` / ``_from_limbs_np``) limb for limb, both
    directions, with and without Montgomery form, on 20 x 2^14 and
    20 x 2^17 Fr and 20 x 2^14 Fq values from default_rng(SEED); the
    seconds of both."""
    rng = np.random.default_rng(SEED)
    cases = []
    for params, shape in CODEC_CASES:
        vals = _rand_field(rng, params, shape)
        for mont in (False, True):
            got, to_s = _host_s(lambda: to_limbs(vals, params, mont))
            ref, to_np_s = _host_s(lambda: limbs._to_limbs_np(vals, params, mont))
            if got.dtype != ref.dtype or not np.array_equal(got, ref):
                raise AssertionError(f"codec to_limbs {params.name} {shape} "
                                     f"mont={mont} != numpy path")
            back, from_s = _host_s(lambda: from_limbs(got, params, mont))
            back_np, from_np_s = _host_s(
                lambda: limbs._from_limbs_np(got, params, mont))
            if not ((back == back_np).all() and (back == vals).all()):
                raise AssertionError(f"codec from_limbs {params.name} {shape} "
                                     f"mont={mont} != numpy path")
            cases.append(dict(field=params.name, shape=list(shape), mont=mont,
                              to_limbs_s=round(to_s, 4),
                              to_limbs_np_s=round(to_np_s, 4),
                              from_limbs_s=round(from_s, 4),
                              from_limbs_np_s=round(from_np_s, 4)))
            del got, ref, back, back_np
    emit(dict(phase="codec", equal_to_numpy_path=True, tolerance=0,
              library=native.library_path().name, cases=cases))


# ---- phase 3: kernels against their plain versions ---------------------------------

def _eq(a, b):
    return bool(torch.equal(a, b))


def _max_abs_err(got, ref):
    return max(int((g - r).abs().max()) for g, r in zip(got, ref))


def _nonidentity(z):
    """Rows of z word planes [R, 8, C] that are not the identity (z != 0)."""
    return (z != 0).any(dim=1)


def _segment_adds(nz, flags):
    """Per (column, segment) id of a fold: (ids of the rows [R*C], the rows,
    the required adds). A segment runs from row 0 or a flagged row to the
    next flag; its first row in `nz` (bool [R, C]: not the identity, or
    valid) is copied, every later one is added."""
    r, c = nz.shape
    key = segment_ids(flags).reshape(-1)
    rows = torch.bincount(key, minlength=(r + 1) * c)
    adds = (torch.bincount(key[nz.reshape(-1)], minlength=(r + 1) * c) - 1).clamp(min=0)
    return key, rows, adds


def _fold_work(nz, flags=None):
    """The adds a Jacobian fold really needs, read from its operands: the
    rows that are not the identity, bool [R, C], and flush flags uint8
    [R, C] (None: one fold a column, as in ``sum_rows``). Returns the share
    of identity rows, the required adds and the longest chain of them in
    one segment."""
    r, c = nz.shape
    _, _, adds = _segment_adds(nz, torch.zeros_like(nz) if flags is None else flags)
    return dict(identity_share=1.0 - float(nz.float().mean()),
                nonidentity_rows=int(nz.sum()),
                required_adds=int(adds.sum()), longest_chain=int(adds.max()),
                all_rows_adds=r * c)


def _add_bounds(nbytes, nbytes_all_rows, work):
    """bound_ms from the bytes and the adds (16 products of
    IMAD_SLOTS_PER_MUL issue slots each) that the operands require, and
    beside it the bound that reads every row and counts an add for every
    row."""
    b, by = bound(nbytes, work["required_adds"] * MULS_ADD * IMAD_SLOTS_PER_MUL)
    return dict(bound_ms=b, bound_by=by, bound_all_rows_ms=bound(
        nbytes_all_rows, work["all_rows_adds"] * MULS_ADD * IMAD_SLOTS_PER_MUL)[0])


def _scan_jac_bounds(r, ct, work):
    """Bounds of one Jacobian scan [R, 8, C]: z and the flag of every row are
    read, x and y of its non-identity rows only; every piece and the final
    carries are written."""
    return _add_bounds(r * ct * (32 + 1 + 96) + 64 * work["nonidentity_rows"]
                       + 96 * ct,
                       r * ct * (96 + 1 + 96) + 96 * ct, work)


def _sum_rows_bounds(jobs, work):
    """Bounds of one ``sum_rows`` launch on `jobs` (triples [L, 8, C]): z of
    every row is read, x and y of its non-identity rows only; one point a
    lane is written."""
    lanes = [(j[0].shape[0], j[0].shape[2]) for j in jobs]
    return _add_bounds(sum(l * c * 32 + 96 * c for l, c in lanes)
                       + 64 * work["nonidentity_rows"],
                       sum(l * c * 96 + 96 * c for l, c in lanes), work)


def _weighted_work(z):
    """What one weighted fold needs, read from the z planes [K, 8, C] of its
    rows (k = K-1 .. 0): a lane's a1 stays the identity up to and including
    its first row that is not, so neither add of those rows computes a
    product; after it each row's a2 + a1 does, and its a1 + row where the row
    is not the identity. The longest chain is the most rows of a lane with
    an add."""
    nz = _nonidentity(z)
    k, c = nz.shape
    rows = torch.arange(k, device=z.device)[:, None]
    first = torch.where(nz, rows, k).min(dim=0).values      # k: no such row
    after = rows > first[None, :]
    return dict(identity_share=1.0 - float(nz.float().mean()),
                nonidentity_rows=int(nz.sum()),
                leading_identity_share=float(first.sum()) / (k * c),
                leading_identity_rows_min=int(first.min()),
                required_adds=int(after.sum()) + int((after & nz).sum()),
                longest_chain=int((k - 1 - first).clamp(min=0).max()),
                all_rows_adds=2 * k * c)


def _weighted_case(planes, check=True):
    """`planes`: rows x, y, z [K, 8, C] (k = K-1 .. 0) and the bias x, y, z
    [8, C]. Launch ``weighted_fold``, hold it against the plain version limb
    for limb (if `check`), time it, and count the work its rows need. Its
    bound reads z of every row and x, y of the rows that are not the
    identity, the bias and the result once."""
    out = pfold.weighted_fold_words(*planes)
    sync()
    k, _, c = planes[0].shape
    res = _weighted_work(planes[2])
    if check:
        st = tuple(kernels.from_word_planes(p).reshape(k, c, 1, 16) for p in planes[:3])
        bias = tuple(kernels.from_word_planes(p).reshape(c, 1, 16) for p in planes[3:])
        with plain_field():
            ref, res["plain_ms"] = wall_ms(lambda: pfold.weighted_plain(st, bias))
        got = tuple(kernels.from_word_planes(o).reshape(c, 1, 16) for o in out)
        if not all(_eq(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"weighted_fold K={k} lanes={c} != plain version")
        res["max_abs_err"] = _max_abs_err(got, ref)
    res["ms"] = time_ms(lambda: pfold.weighted_fold_words(*planes))
    # a row's two adds run side by side: the row is the chain's step
    res["us_per_row"] = res["ms"] * 1e3 / k
    res["us_per_add"] = res["ms"] * 1e3 / (2 * k)
    res.update(_add_bounds(k * c * 32 + 64 * res["nonidentity_rows"] + 2 * 96 * c,
                           k * c * 96 + 2 * 96 * c, res))
    res["shape"] = f"K={k} x lanes={c}"
    return res


def _affine_work(valid, flags, buckets=None):
    """What one affine flush scan needs, read from its operands: valid and
    flags uint8 [R, C]. Returns the valid and flag shares, the valid rows,
    the required adds (a segment's first valid row is copied, every later
    valid row added), the longest segment (rows) and chain (adds), and the
    columns that are one segment of all R rows. With `buckets` (each row's
    bucket, int [R, C]), also the share of rows in bucket-0 segments, bucket
    0's share of the required adds, and the longest segment and chain of a
    bucket other than 0."""
    live = valid.bool()
    r, c = live.shape
    key, lengths, adds = _segment_adds(live, flags)
    out = dict(valid_share=float(live.float().mean()),
               flag_share=float(flags.bool().float().mean()),
               valid_rows=int(live.sum()), required_adds=int(adds.sum()),
               all_rows_adds=r * c, longest_segment=int(lengths.max()),
               longest_chain=int(adds.max()),
               one_segment_columns=int((flags[1:] == 0).all(dim=0).sum()))
    if buckets is not None:
        flat = buckets.reshape(-1).to(torch.int64)
        seg_bucket = torch.full_like(lengths, -1)
        seg_bucket[key] = flat
        if not torch.equal(seg_bucket[key], flat):
            raise AssertionError("flush_scan_affine: a segment spans two buckets")
        zero = (lengths > 0) & (seg_bucket == 0)
        other = (lengths > 0) & (seg_bucket != 0)
        out.update(
            bucket0_row_share=float((flat == 0).float().mean()),
            bucket0_adds_share=int(adds[zero].sum()) / max(1, out["required_adds"]),
            longest_segment_nonzero_bucket=int(lengths[other].max()) if other.any() else 0,
            longest_chain_nonzero_bucket=int(adds[other].max()) if other.any() else 0)
    return out


def _scan_affine_bounds(r, ct, work):
    """Bounds of one affine scan [R, 8, C]: the valid and flag bytes of every
    row are read, x and y of its valid rows only, one mixed add a required
    add; every piece and the final carries are written. Beside it the bound
    that reads every row and counts an add for every row."""
    b, by = flush_scan_affine_bound(r, ct, work["valid_rows"], work["required_adds"])
    return dict(bound_ms=b, bound_by=by,
                bound_all_rows_ms=flush_scan_affine_bound(r, ct)[0])


def _scan_affine_case(planes, latency_us, check=True, buckets=None):
    """One affine flush scan on word planes (sx, sy, valid, flags): launch
    and hold against the plain version limb for limb (if `check`), time,
    and read its work (`_affine_work`, with `buckets` if given); its chain
    floor is the longest segment's rows x the 3 products carried from row to
    row x one product's latency. Returns (result dict, pieces as limbs
    [R+1, 1, C, 16] if `check`, else None)."""
    sx, sy, val, fl = planes
    r, _, ct = sx.shape
    res = _affine_work(val, fl, buckets)
    got = None
    if check:
        out = pscan.flush_scan_affine_words(*planes)
        sync()
        got = tuple(pscan.pieces_from_planes(
            torch.cat([out[i], out[3 + i][None]], dim=0), 1, ct) for i in range(3))
        stream = tuple(pscan.pieces_from_planes(p, 1, ct) for p in (sx, sy))
        with plain_field():
            ref, res["plain_ms"] = wall_ms(lambda: pscan.flush_scan_plain(
                stream + (val.bool().reshape(r, 1, ct),), fl.bool().reshape(r, 1, ct),
                affine=True))
        if not all(_eq(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"flush_scan_affine R={r} C={ct} != plain version")
        res["max_abs_err"] = _max_abs_err(got, ref)
        del ref
    res["ms"] = time_ms(lambda: pscan.flush_scan_affine_words(*planes), reps=3)
    res.update(_scan_affine_bounds(r, ct, res))
    res["chain_floor_ms"] = (res["longest_segment"] * CARRIED_PRODUCTS_MADD
                             * latency_us / 1e3)
    res["product_latency_us"] = latency_us
    res["shape"] = f"R={r}, columns={ct}"
    return res, got


def _scan_jac_case(planes, check=True):
    """One Jacobian flush scan on word planes (sx, sy, sz, flags): launch,
    hold against the plain version limb for limb (if `check`), time.
    Returns (result dict, pieces as limbs [R+1, 1, C, 16])."""
    sx, sy, sz, fl = planes
    r, _, ct = sx.shape
    out = pscan.flush_scan_jac_words(*planes)
    sync()
    got = tuple(pscan.pieces_from_planes(
        torch.cat([out[i], out[3 + i][None]], dim=0), 1, ct) for i in range(3))
    res = _fold_work(_nonidentity(sz), fl)
    if check:
        stream = tuple(pscan.pieces_from_planes(p, 1, ct) for p in (sx, sy, sz))
        with plain_field():
            ref, res["plain_ms"] = wall_ms(lambda: pscan.flush_scan_plain(
                stream, fl.bool().reshape(r, 1, ct), affine=False))
        if not all(_eq(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"flush_scan_jac R={r} C={ct} != plain version")
        res["max_abs_err"] = _max_abs_err(got, ref)
        del ref
    res["ms"] = time_ms(lambda: pscan.flush_scan_jac_words(*planes), reps=3)
    res.update(_scan_jac_bounds(r, ct, res))
    res["shape"] = f"R={r}, columns={ct}"
    return res, got


def _merge_work(works):
    """The work of several folds taken together."""
    return dict(identity_share=sum(w["identity_share"] * w["all_rows_adds"]
                                   for w in works)
                / sum(w["all_rows_adds"] for w in works),
                nonidentity_rows=sum(w["nonidentity_rows"] for w in works),
                required_adds=sum(w["required_adds"] for w in works),
                longest_chain=max(w["longest_chain"] for w in works),
                all_rows_adds=sum(w["all_rows_adds"] for w in works))


def _sum_rows_case(jobs, check=True):
    """`jobs`: triples of word planes [L, 8, C], the folds of one MSM batch.
    Launch them (one launch), hold each job against the plain version limb
    for limb (if `check`), time the launch and each job alone."""
    def run():
        out = pfold.sum_rows_words(*(t for job in jobs for t in job))
        return [out[3 * j:3 * j + 3] for j in range(len(jobs))]

    outs = run()
    sync()
    res = _merge_work([_fold_work(_nonidentity(job[2])) for job in jobs])
    if check:
        res["plain_ms"], res["max_abs_err"] = 0.0, 0
        for job, out in zip(jobs, outs):
            l, _, ct = job[0].shape
            xs = tuple(kernels.from_word_planes(p).reshape(l, 1, ct, 16)
                       for p in job)
            with plain_field():
                ref, plain = wall_ms(lambda: pfold.sum_rows_plain(xs))
            got = tuple(kernels.from_word_planes(o).reshape(1, ct, 16)
                        for o in out)
            if not all(_eq(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"sum_rows L={l} C={ct} != plain version")
            res["plain_ms"] += plain
            res["max_abs_err"] = max(res["max_abs_err"], _max_abs_err(got, ref))
    res["ms"] = time_ms(run)
    if len(jobs) > 1:
        res["ms_by_job"] = [time_ms(lambda: pfold.sum_rows_words(*job))
                            for job in jobs]
    res.update(_sum_rows_bounds(jobs, res))
    res["shape"] = " + ".join(f"L={j[0].shape[0]} x lanes={j[0].shape[2]}"
                              for j in jobs)
    return res


class _MsmRecorder:
    """Records the operands and results of every ``flush_scan_affine``,
    ``flush_scan_jac``, ``sum_rows`` and ``weighted_fold`` launch while it is
    active (the wrappers count their launches by kernel name, so the counts
    are unaffected). Each affine launch is paired with the ``_stream_info`` call
    whose flags it scans, for the bucket of every row: the stream's sorted
    digit keys, column-major."""

    def __enter__(self):
        self.affine, self.scans, self.folds, self.weighted = [], [], [], []
        self._infos = []
        self._saved = (pscan.flush_scan_affine_words, pscan.flush_scan_jac_words,
                       pfold.sum_rows_words, pfold.weighted_fold_words,
                       pippenger._stream_info)
        affine, scan, fold, weighted, info = self._saved

        def rec_info(keys, r_rows, nb):
            out = info(keys, r_rows, nb)
            self._infos.append((pippenger._colmaj(keys, r_rows), out[0]))
            return out

        def rec_affine(*planes):
            out = affine(*planes)
            buckets = None
            for i in range(len(self._infos) - 1, -1, -1):
                ksc, flags = self._infos[i]
                if _eq(pscan.stream_to_planes(flags), planes[3]):
                    buckets = ksc.reshape(planes[3].shape)
                    del self._infos[:i + 1]
                    break
            if buckets is None:
                raise AssertionError("flush_scan_affine: no _stream_info call "
                                     "made this launch's flags")
            self.affine.append((planes, out, buckets))
            return out

        def rec_scan(*planes):
            out = scan(*planes)
            self.scans.append((planes, out))
            return out

        def rec_fold(*planes):
            out = fold(*planes)
            self.folds.append((planes, out))
            return out

        def rec_weighted(*planes):
            out = weighted(*planes)
            self.weighted.append((planes, out))
            return out

        (pscan.flush_scan_affine_words, pscan.flush_scan_jac_words,
         pfold.sum_rows_words, pfold.weighted_fold_words, pippenger._stream_info) = (
            rec_affine, rec_scan, rec_fold, rec_weighted, rec_info)
        return self

    def __exit__(self, *exc):
        (pscan.flush_scan_affine_words, pscan.flush_scan_jac_words,
         pfold.sum_rows_words, pfold.weighted_fold_words,
         pippenger._stream_info) = self._saved


def _point_pool(n_pool):
    """n_pool distinct random on-curve points as device mont limbs."""
    rnd = random.Random(SEED)
    scalars = [rnd.getrandbits(200) | 1 for _ in range(n_pool)]
    pts = pippenger.fixed_base_expand(G1_GEN, scalars, device=DEV)
    if pts[0] != g1_mul(G1_GEN, scalars[0]):
        raise AssertionError("fixed_base_expand != host scalar multiplication")
    return points_to_device(pts, device=DEV)


def phase_kernels():
    """Returns {name: dict(ms, plain_ms, bound_ms, bound_by, max_abs_err)}."""
    res = {}
    rng = np.random.default_rng(SEED)
    g_torch = torch.Generator(device="cpu").manual_seed(SEED)

    # -- kernel 1: field_binop, 2^17 elements (8 columns of a k = 14 proof) --
    n1 = 8 << K
    rnd = random.Random(SEED + 1)
    worst = 0
    ms1 = plain1 = None
    for params in (FQ, FR):
        p = params.p
        head = [0, 1, p - 1, 2, p - 2] + [rnd.randrange(p) for _ in range(59)]
        a_np = rng.integers(0, 1 << 16, size=(n1, 16), dtype=np.int64)
        b_np = rng.integers(0, 1 << 16, size=(n1, 16), dtype=np.int64)
        a_np[:, 15] &= 0x1FFF   # < 2^253 < p
        b_np[:, 15] &= 0x1FFF
        a_np[:64] = to_limbs(head)
        b_np[:64] = to_limbs(head[::-1])
        a = torch.from_numpy(a_np).to(DEV)
        b = torch.from_numpy(b_np).to(DEV)
        wa, wb = kernels.to_word_planes(a), kernels.to_word_planes(b)
        rinv = pow(params.r_mont, -1, p)
        truth = dict(
            mul=[x * y * rinv % p for x, y in zip(head, head[::-1])],
            add=[(x + y) % p for x, y in zip(head, head[::-1])],
            sub=[(x - y) % p for x, y in zip(head, head[::-1])])
        for op in ("mul", "add", "sub"):
            got = kernels.from_word_planes(
                pfield.field_binop_words(op, params, wa, wb))
            ref = pfield.field_binop_plain(op, params, a, b)
            sync()
            if not _eq(got, ref):
                raise AssertionError(f"field_binop {params.name}.{op} != plain")
            if list(from_limbs(got[:64])) != truth[op]:
                raise AssertionError(
                    f"field_binop {params.name}.{op} != Python-int truth")
            worst = max(worst, _max_abs_err((got,), (ref,)))
        if params is FQ:
            ms1 = time_ms(lambda: pfield.field_binop_words("mul", FQ, wa, wb))
            plain1 = time_ms(lambda: pfield.field_binop_plain("mul", FQ, a, b),
                             reps=3)
            ms1_add = time_ms(lambda: pfield.field_binop_words("add", FQ, wa, wb))
    b1, by1 = bound(3 * 32 * n1, IMAD_SLOTS_PER_MUL * n1)
    # the same at 8 columns of the k = 17 Large shape, n = 2^20
    n_wide = 8 << 17
    rng_wide = np.random.default_rng(SEED + 17)   # rng's draws stay as they were
    wa = kernels.to_word_planes(_rand_mont(rng_wide, (n_wide,)))
    wb = kernels.to_word_planes(_rand_mont(rng_wide, (n_wide,)))
    got = pfield.field_binop_words("mul", FQ, wa, wb)
    ref = pfield.field_binop_plain("mul", FQ, kernels.from_word_planes(wa),
                                   kernels.from_word_planes(wb))
    if not _eq(kernels.from_word_planes(got), ref):
        raise AssertionError(f"field_binop Fq.mul n={n_wide} != plain")
    del got, ref
    ms_wide = time_ms(lambda: pfield.field_binop_words("mul", FQ, wa, wb))
    b_wide = bound(3 * 32 * n_wide, IMAD_SLOTS_PER_MUL * n_wide)[0]
    res["field_binop"] = dict(
        ms=ms1, plain_ms=plain1, bound_ms=b1, bound_by=by1, max_abs_err=worst,
        shape=f"Fq mul, n={n1}", add_ms=ms1_add, bound_share=b1 / ms1,
        ms_wide=ms_wide, wide_shape=f"Fq mul, n={n_wide}",
        bound_wide_ms=b_wide, bound_share_wide=b_wide / ms_wide)
    del wa, wb

    # -- kernels 2 and 3: flush scans at R = 1024, 2560 columns (k = 14, B = 8) --
    n = 1 << K
    c = pippenger.default_fixed_window(n)
    sizes, _ = pippenger._window_layout(c)
    m = len(sizes) * n
    r_rows = pippenger._pip_r_rows(m)
    g, cdim = 8, (m + r_rows - 1) // r_rows
    ct = g * cdim
    pool = _point_pool(4096)
    idx = torch.randint(0, 4096, (r_rows, g, cdim), generator=g_torch).to(DEV)
    sx, sy = pool[0][idx], pool[1][idx]
    sval = (torch.rand((r_rows, g, cdim), generator=g_torch) > 0.01).to(DEV)
    flags = (torch.rand((r_rows, g, cdim), generator=g_torch) < 0.025).to(DEV)
    flags[0] = True
    planes = [pscan.stream_to_planes(t) for t in (sx, sy, sval, flags)]
    latency = field_chain.product_latency_us(FQ, DEV)
    res["flush_scan_affine"], got = _scan_affine_case(planes, latency)
    ref = tuple(t.reshape(r_rows + 1, g, cdim, 16) for t in got)
    # the worst case for the segment split: flags only at row 0, so that
    # every column is one segment of all R rows
    planes[3] = torch.zeros_like(planes[3])
    planes[3][0] = 1
    res["flush_scan_affine"]["one_segment"], _ = _scan_affine_case(planes, latency)
    del planes, sx, sy, idx

    # Jacobian stream: the affine scan's pieces (zero rows = infinity among
    # them), as the compaction round feeds them back, plus one ragged column
    # block as the padded piece count leaves it
    cdim3 = (((r_rows + 1) * cdim + r_rows - 1) // r_rows)
    pad_c = cdim3 - cdim
    stream3 = tuple(torch.nn.functional.pad(t[:r_rows], (0, 0, 0, pad_c))
                    for t in ref)
    flags3 = (torch.rand((r_rows, g, cdim3), generator=g_torch) < 0.05).to(DEV)
    flags3[0] = True
    ct3 = g * cdim3
    del got, ref
    planes3 = [pscan.stream_to_planes(t) for t in stream3 + (flags3,)]
    res["flush_scan_jac"], got = _scan_jac_case(planes3)
    got = tuple(t.reshape(r_rows + 1, g, cdim3, 16) for t in got)
    del planes3, stream3

    # -- kernel 4: sum_rows at both fold shapes of c = 13 ---------------------
    lo_bits = c // 2
    hi_n, lo_n = 1 << (c - lo_bits), 1 << lo_bits
    flat = tuple(t.reshape(-1, 16) for t in got)     # jac pieces incl. zeros
    fold_shapes = ((2 * lo_n, hi_n), (2 * hi_n, lo_n))
    jobs4 = []
    for l_rows, width in fold_shapes:
        cnt = l_rows * g * width
        pick = torch.randint(0, flat[0].shape[0], (cnt,), generator=g_torch).to(DEV)
        jobs4.append(tuple(pfold._rows_to_planes(t[pick].reshape(l_rows, g, width, 16))
                           for t in flat))
    res["sum_rows"] = _sum_rows_case(jobs4)
    res["sum_rows"]["shape"] += " (one MSM batch)"

    # -- dense inputs for kernels 3 and 4: no identity rows at all, so that
    # no row can be skipped (the inputs above are ~97 % identities) ---------
    g_dense = torch.Generator(device="cpu").manual_seed(SEED + 4)
    real = (flat[2] != 0).any(dim=-1)
    flat_real = tuple(t[real] for t in flat)

    def dense_pick(shape):
        pick = torch.randint(0, flat_real[0].shape[0], (int(np.prod(shape)),),
                             generator=g_dense).to(DEV)
        return tuple(t[pick].reshape(shape + (16,)) for t in flat_real)

    stream_d = dense_pick((r_rows, g, cdim3))
    flags_d = (torch.rand((r_rows, g, cdim3), generator=g_dense) < 0.05).to(DEV)
    flags_d[0] = True
    res["flush_scan_jac"]["dense"], _ = _scan_jac_case(
        [pscan.stream_to_planes(t) for t in stream_d + (flags_d,)])
    del stream_d
    res["sum_rows"]["dense"] = _sum_rows_case(
        [tuple(pfold._rows_to_planes(t) for t in dense_pick((l_rows, g, width)))
         for l_rows, width in fold_shapes])

    # -- kernel 5: weighted_fold, K = 128 rows over 16 lanes: rows drawn from
    # the pieces above (most of them the identity), and dense (none) -------
    k_rows = hi_n
    pick = torch.randint(0, flat[0].shape[0], (k_rows * g * 2,),
                         generator=g_torch).to(DEV)
    _, bias = pippenger._pip_bias(DEV)
    bias5 = [kernels.to_word_planes(b.expand(g * 2, 16)) for b in bias]
    res["weighted_fold"] = _weighted_case(
        [pfold._rows_to_planes(t[pick].reshape(k_rows, g, 2, 16)) for t in flat]
        + bias5)
    res["weighted_fold"]["dense"] = _weighted_case(
        [pfold._rows_to_planes(t) for t in dense_pick((k_rows, g, 2))] + bias5)

    emit(dict(phase="kernel_check", equal_to_plain=True, tolerance=0,
              kernels=res, check_launches=kernels.launch_counts()))
    return res


# ---- phase 3a: field_limbs — JField's kernel path against its plain bodies ---------

LIMBS_ROWS = 8      # the leading dimension of the suffix and outer cases
LIMBS_LOG_N = (17, 20)


def _limbs_case(rng, mode, n, params):
    """(a, b, elements read) of one addressing mode with n result elements:
    canonical random limbs on the card, the first 64 of a row 0, 1, p - 1,
    R mod p, R^2 mod p and random values as Python ints."""
    p = params.p
    rnd = random.Random(SEED + n + len(mode))
    head = [0, 1, p - 1, params.r_mont % p, params.r_mont ** 2 % p]
    head += [rnd.randrange(p) for _ in range(64 - len(head))]
    w = n // LIMBS_ROWS

    def rand(shape):
        x = _rand_mont(rng, shape)
        k = min(64, x.numel() // 16)
        x.reshape(-1, 16)[:k] = to_device(to_limbs(head[:k]), DEV)
        return x

    if mode == "same":
        a, b = rand((n,)), rand((n,))
    elif mode == "one":
        a, b = rand((n,)), to_device(to_limbs(params.r_mont ** 2 % p), DEV)
    elif mode == "suffix":      # coefficients [C, n] times a coset's powers [n]
        a, b = rand((LIMBS_ROWS, w)), rand((w,))
    elif mode == "outer":       # beta delta^j [C, 1] times w^i [1, n]
        a, b = rand((LIMBS_ROWS,))[:, None], rand((w,))[None]
    else:                       # limbs last of word-plane-like [16, n]: a copy
        a = torch.movedim(rand((n,)).t().contiguous(), 0, -1)
        b = rand((n,))
    return a, b, (a.numel() + b.numel()) // 16


def _limbs_truth(params, op, a, b):
    """Python-int values of the first 64 result elements of a row."""
    p = params.p
    rinv = pow(params.r_mont, -1, p)
    fn = {"mul": lambda x, y: x * y * rinv % p, "add": lambda x, y: (x + y) % p,
          "sub": lambda x, y: (x - y) % p}[op]
    xa, xb = (t.expand(torch.broadcast_shapes(a.shape, b.shape)).reshape(-1, 16)[:64]
              for t in (a, b))
    return [fn(int(x), int(y)) for x, y in zip(from_limbs(xa), from_limbs(xb))]


def phase_field_limbs():
    """``field_limbs`` (JField's add, sub and mul on a CUDA tensor) against
    JField's plain torch bodies on the card, limb for limb, and its first 64
    elements against Python ints: Fq and Fr, mul, add and sub, at 2^17 and
    2^20 result elements, in every addressing mode of the program (same
    shape; one element; [8, n/8] against a suffix [n/8]; [8, 1] against
    [1, n/8]) and one the wrapper copies first (limbs not contiguous). Each
    case's ms (CUDA events; a copied case includes its copy) beside its
    bound (the bytes of each operand read once and the result written, at
    3.35e12 B/s, or a product's IMAD slots a result element) and the plain
    body's ms (Fr mul only). Returns {"field_limbs": headline}."""
    rng = np.random.default_rng(SEED + 10)
    kernels.reset_launch_counts()
    cases = []
    worst = 0
    for params in (FQ, FR):
        f = jfield.jfq() if params is FQ else jfield.jfr()
        for log_n in LIMBS_LOG_N:
            n = 1 << log_n
            for mode in ("same", "one", "suffix", "outer", "copied"):
                a, b, elems = _limbs_case(rng, mode, n, params)
                for op in ("mul", "add", "sub"):
                    got = getattr(f, op)(a, b)
                    ref = getattr(f, op + "_plain")(a, b)
                    sync()
                    if not _eq(got, ref):
                        raise AssertionError(f"field_limbs {params.name}.{op} {mode} "
                                             f"n=2^{log_n} != plain body")
                    if (list(from_limbs(got.reshape(-1, 16)[:64]))
                            != _limbs_truth(params, op, a, b)):
                        raise AssertionError(f"field_limbs {params.name}.{op} {mode} "
                                             f"n=2^{log_n} != Python-int truth")
                    worst = max(worst, _max_abs_err((got,), (ref,)))
                    del got, ref
                    b_ms, b_by = bound(128 * (elems + n),
                                       IMAD_SLOTS_PER_MUL * n if op == "mul" else 0)
                    ms = time_ms(lambda: getattr(f, op)(a, b))
                    case = dict(field=params.name, op=op, mode=mode, log_n=log_n,
                                ms=ms, bound_ms=b_ms, bound_by=b_by,
                                bound_share=b_ms / ms)
                    if params is FR and op == "mul":
                        case["plain_ms"] = time_ms(lambda: f.mul_plain(a, b), reps=3)
                    cases.append(case)
                del a, b
    launches = kernels.launch_counts()["field_limbs"]
    emit(dict(phase="field_limbs", equal_to_plain=True, tolerance=0,
              max_abs_err=worst, cases=cases, launches=launches))

    def pick(log_n):
        return next(c for c in cases if c["field"] == "Fr" and c["op"] == "mul"
                    and c["mode"] == "same" and c["log_n"] == log_n)

    narrow, wide = (pick(log_n) for log_n in LIMBS_LOG_N)
    return {"field_limbs": dict(
        ms=narrow["ms"], plain_ms=narrow["plain_ms"], bound_ms=narrow["bound_ms"],
        bound_by=narrow["bound_by"], max_abs_err=worst,
        shape=f"Fr mul, n={1 << LIMBS_LOG_N[0]}, same shape",
        bound_share=narrow["bound_share"], ms_wide=wide["ms"],
        wide_shape=f"Fr mul, n={1 << LIMBS_LOG_N[1]}, same shape",
        bound_wide_ms=wide["bound_ms"],
        bound_share_wide=wide["bound_share"], plain_ms_wide=wide["plain_ms"])}


# ---- phase 3b: bench — the measuring kernels 8 and 9 -----------------------------

def phase_bench():
    """The two benchmarks' entry points (``field_chain.run``,
    ``scan_bisect.run``) with the launch counts set to 0 before and read
    after: the path of kernels 8 and 9. Then each kernel is held against its
    plain version (``check``): ``field_chain`` at n = 2^18 limb for limb and
    its first 64 elements against Python ints; the bisection bodies at
    R = 1,024, C = 2,560 over all rows, the wide run (C = 20,480) against the
    narrow one on the columns they share. ``flush_scan_affine`` is timed on
    the same rows in the same run, and ``torch.cumsum`` (the library call
    that computes ``trivial``'s function on its word planes) beside
    ``trivial``. Returns ({name: result}, launches)."""
    kernels.reset_launch_counts()
    chain, chain_outs = field_chain.run(FR, CHAIN_LOG_N, DEV)
    chain["product_latency_us"] = field_chain.product_latency_us(FR, DEV)
    bisect, (narrow_in, bisect_outs) = scan_bisect.run(DEV)
    launches = kernels.launch_counts()
    for name in BENCH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 "bench path")
    chain["max_abs_err"] = field_chain.check(FR, CHAIN_LOG_N, chain_outs)
    res = {"field_chain": chain}
    checked = scan_bisect.check(narrow_in, bisect_outs)
    for body in scan_bisect.BODIES:
        res[f"scan_bisect_{body}"] = {**bisect["bodies"][body], **checked[body]}
    sx = narrow_in[0]
    if not torch.equal(torch.cumsum(sx, 0, dtype=torch.int32),
                       bisect_outs["trivial"][0]):
        raise AssertionError("torch.cumsum != scan_bisect_trivial")
    res["scan_bisect_trivial"]["library_ms"] = time_ms(
        lambda: torch.cumsum(sx, 0, dtype=torch.int32))
    del sx
    del chain_outs, narrow_in, bisect_outs
    emit(dict(phase="bench", equal_to_plain=True, tolerance=0,
              product_latency_us_fq=bisect["product_latency_us"],
              flush_scan_affine=bisect["bodies"]["flush_scan_affine"],
              kernels=res, launches=launches))
    return res, launches


# ---- phase 4: the int8-DFT NTT engine ---------------------------------------------

def _rand_mont(rng, shape):
    """Canonical field elements (< 2^253 < p) as int64 limbs on the card."""
    a = rng.integers(0, 1 << 16, size=tuple(shape) + (16,), dtype=np.int64)
    a[..., 15] &= 0x1FFF
    return torch.from_numpy(a).to(DEV)


def _rand_word_planes(rng, t, lanes):
    """Canonical field elements as int32 word planes [8, t, lanes]."""
    w = pntt._limbs_to_words(_rand_mont(rng, (t, lanes)))
    return torch.movedim(w, -1, 0).contiguous()


class _LevelRecorder:
    """Records every DFT level (its int8 input) and every kernel call of the
    engine while it is active, with the kernels' outputs."""

    def __enter__(self):
        self.levels, self.epilogues, self.twiddles = [], [], []
        self._saved = (pntt._matmul_level, pntt.epilogue, pntt.twiddle)
        matmul_level, epilogue, twiddle = self._saved

        def rec_level(dp, key, xb, twiddle=None, out_bytes=True, colsum=None):
            self.levels.append((dp, key, xb))
            return matmul_level(dp, key, xb, twiddle, out_bytes, colsum)

        def rec_epilogue(acc, colsum, rowc, tw=None, out_bytes=True):
            out = epilogue(acc, colsum, rowc, tw, out_bytes)
            self.epilogues.append(((acc, colsum, rowc, tw, out_bytes), out))
            return out

        def rec_twiddle(xb, twc):
            out, colsum = twiddle(xb, twc)
            self.twiddles.append(((xb, twc), (out, colsum)))
            return out, colsum

        pntt._matmul_level, pntt.epilogue, pntt.twiddle = (
            rec_level, rec_epilogue, rec_twiddle)
        return self

    def __exit__(self, *exc):
        pntt._matmul_level, pntt.epilogue, pntt.twiddle = self._saved


def _epilogue_bound(t, lanes, with_twiddle):
    elems = t * lanes
    nbytes = elems * (128 + 32) + 4 * lanes + 4 * 32 * t
    slots = elems * IMAD_SLOTS_PER_REDC
    if with_twiddle:
        nbytes += elems * 32
        slots += elems * IMAD_SLOTS_PER_MUL
    return bound(nbytes, slots)


def _check_engine_kernels(rec, rng, n, res, levels_out):
    """Holds every kernel call of one recorded transform against its plain
    version (and the with-twiddle epilogue variants on the same
    accumulators), times each, and adds them up in `res`."""
    for (dp, key, xb), ((acc, colsum, rowc, tw, out_bytes), out) in zip(
            rec.levels, rec.epilogues):
        t, lanes = acc.shape[1], acc.shape[2]
        with plain_field():
            ref, plain = wall_ms(
                lambda: pntt.epilogue_plain(acc, colsum, rowc, tw, out_bytes))
        if not _eq(out, ref):
            raise AssertionError(f"ntt_epilogue t={t} lanes={lanes} != plain")
        ms = time_ms(lambda: pntt.epilogue_words(acc, colsum, rowc, tw,
                                                 out_bytes), reps=5)
        a = xb.reshape(32 * t, lanes)
        mm = time_ms(lambda: torch._int_mm(dp.mats[key], a), reps=5)
        b_ms, b_by = _epilogue_bound(t, lanes, False)
        e = res["ntt_epilogue"]
        e["ms"] += ms
        e["plain_ms"] += plain
        e["bound_ms"] += b_ms
        e["int_mm_ms"] += mm
        e["bound_by"].add(b_by)
        e["shapes"].append(f"n=2^{n.bit_length() - 1}: t={t} x {lanes} lanes "
                           f"({'bytes' if out_bytes else 'words'} out)")
        levels_out.append(dict(
            n=n, t=t, lanes=lanes, out="bytes" if out_bytes else "words",
            epilogue_ms=ms, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
            int_mm_ms=mm,
            int_mm_shape=f"[{32 * t}, {32 * t}] x [{32 * t}, {lanes}]",
            plain_ms=plain))
        # the with-twiddle variants (not launched by the engine) on the same
        # accumulators, with a random twiddle
        twr = _rand_word_planes(rng, t, lanes)
        for ob in (True, False):
            got = pntt.epilogue_words(acc, colsum, rowc, twr, ob)
            with plain_field():
                ref, plain_tw = wall_ms(
                    lambda: pntt.epilogue_plain(acc, colsum, rowc, twr, ob))
            if not _eq(got, ref):
                raise AssertionError(f"ntt_epilogue with twiddle t={t} "
                                     f"lanes={lanes} out_bytes={ob} != plain")
            e["variants_checked"] += 1
        tw_ms = time_ms(lambda: pntt.epilogue_words(acc, colsum, rowc, twr,
                                                    out_bytes), reps=3)
        e["with_twiddle_ms"] += tw_ms
        e["with_twiddle_bound_ms"] += _epilogue_bound(t, lanes, True)[0]
        del twr, got, ref
    for (xb, twc), (out, colsum) in rec.twiddles:
        s, lanes, r = xb.shape[1], xb.shape[2], twc.shape[2]
        g = lanes // r
        with plain_field():
            (ref, ref_sum), plain = wall_ms(lambda: pntt.twiddle_plain(xb, twc))
        if not (_eq(out, ref) and _eq(colsum, ref_sum)):
            raise AssertionError(f"ntt_twiddle s={s} lanes={lanes} != plain")
        ms = time_ms(lambda: pntt.twiddle_words(xb, twc), reps=5)

        def regroup():
            # the data movement the kernel took in: the engine's old regroup
            # copy of the same bytes and the outer product's column sums
            x3 = xb.reshape(32, s, r, g).transpose(1, 2).reshape(32, r, s * g)
            return x3.reshape(32 * r, s * g).sum(dim=0, dtype=torch.int32)
        copy_ms = time_ms(regroup, reps=5)
        elems = s * lanes
        b_ms, b_by = bound(elems * 64 + 32 * s * r + 4 * s * g,
                           elems * IMAD_SLOTS_PER_MUL)
        w = res["ntt_twiddle"]
        w["ms"] += ms
        w["plain_ms"] += plain
        w["bound_ms"] += b_ms
        w["regroup_copy_ms"] += copy_ms
        w["bound_by"].add(b_by)
        w["shapes"].append(f"n=2^{n.bit_length() - 1}: s={s}, r={r}, G={g} "
                           f"({s} x {lanes} -> {r} x {s * g} lanes)")
        level = dict(n=n, twiddle_s=s, twiddle_r=r, twiddle_g=g, twiddle_ms=ms,
                     bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                     regroup_copy_ms=copy_ms, plain_ms=plain)
        w["levels"].append(dict(level))
        levels_out.append(level)


def phase_ntt(batch):
    """Kernels 6 and 7 at the shapes a k = 14 WNN proof gives them (forward
    transforms of `batch` columns at n = 2^14 and 2^17), all four epilogue
    variants; whole transforms of the engine against the butterflies
    (forward, inverse, coset-extended); times by CUDA events."""
    rng = np.random.default_rng(SEED + 3)
    res = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=set(),
                      shapes=[]) for name in NTT_KERNELS}
    res["ntt_epilogue"].update(int_mm_ms=0.0, variants_checked=0,
                               with_twiddle_ms=0.0, with_twiddle_bound_ms=0.0)
    res["ntt_twiddle"].update(regroup_copy_ms=0.0, levels=[])
    levels, transforms = [], []
    t0 = time.time()
    for log_n in (K, K + 3):
        plan = NttPlan(log_n, device=DEV)
        fwd, inv = plan._mxu(False), plan._mxu(True)
        pntt._device_plan(fwd, DEV)
        pntt._device_plan(inv, DEV)
    sync()
    plans_s = time.time() - t0

    for log_n in (K, K + 3):
        n = 1 << log_n
        plan = NttPlan(log_n, device=DEV)
        x = _rand_mont(rng, (batch, n))
        with _LevelRecorder() as rec:
            ev = plan.ntt(x)
            sync()
        co = plan.intt(ev)
        # the butterflies on JField's plain bodies
        with plain_field():
            ev_b = plan._transform(x, plan._fwd_tw)
            co_b = plan._intt_impl(ev)
            butterfly_ms = dict(
                butterfly_fwd_ms=time_ms(lambda: plan._transform(x, plan._fwd_tw),
                                         reps=3),
                butterfly_inv_ms=time_ms(lambda: plan._intt_impl(ev), reps=3))
        if not _eq(ev, ev_b):
            raise AssertionError(f"engine forward n=2^{log_n} != butterflies")
        if not (_eq(co, co_b) and _eq(co, x)):
            raise AssertionError(f"engine inverse n=2^{log_n} != butterflies")
        _check_engine_kernels(rec, rng, n, res, levels)
        del rec
        transforms.append(dict(
            n=n, batch=batch,
            engine_fwd_ms=time_ms(lambda: plan.ntt(x), reps=5),
            engine_inv_ms=time_ms(lambda: plan.intt(ev), reps=5), **butterfly_ms))
        del x, ev, ev_b, co, co_b

    # coset-extended: the prover's k = 14, degree-6 domain (extended 2^17)
    dom = get_domain(K, 6, DEV)
    c = _rand_mont(rng, (batch, 1 << K))
    ext = dom.coeff_to_extended(c)
    back = dom.extended_to_coeff(ext)
    ext_ms = time_ms(lambda: dom.coeff_to_extended(c), reps=5)
    saved = NttPlan.MXU_MIN_LOG_N
    NttPlan.MXU_MIN_LOG_N = 64
    try:
        with plain_field():
            ext_b = dom.coeff_to_extended(c)
            back_b = dom.extended_to_coeff(ext_b)
            ext_b_ms = time_ms(lambda: dom.coeff_to_extended(c), reps=3)
    finally:
        NttPlan.MXU_MIN_LOG_N = saved
    if not (_eq(ext, ext_b) and _eq(back, back_b)
            and _eq(back[:, : 1 << K], c)):
        raise AssertionError("coset-extended transforms: engine != butterflies")
    transforms.append(dict(n=dom.extended_n, batch=batch, coset_extended=True,
                           engine_ms=ext_ms, butterfly_ms=ext_b_ms))
    for name, r in res.items():
        r["max_abs_err"] = 0
        r["bound_by"] = "+".join(sorted(r["bound_by"]))
        r["shape"] = "; ".join(r.pop("shapes")) + f" (B = {batch})"
    emit(dict(phase="ntt", equal_to_plain=True, tolerance=0, batch=batch,
              plans_s=round(plans_s, 3), levels=levels, transforms=transforms,
              engine_equals_butterflies=True, kernels=res))
    return res


# ---- phase 5: commit -------------------------------------------------------------

BASES = ("monomial", "lagrange")


class _NoTableBuild:
    """While active, building a window table raises: every table must come
    from the on-disk cache."""

    def __enter__(self):
        self._saved = srs_module.build_window_table

        def refuse(*args, **kwargs):
            raise AssertionError("a window table was built, not read from the cache")

        srs_module.build_window_table = refuse
        return self

    def __exit__(self, *exc):
        srs_module.build_window_table = self._saved


def _cached_tables(srs, again):
    """Seconds for `again`, an Srs on `srs`'s points, to read both bases'
    tables from the cache (building one raises); the tables are held against
    those `srs` built, limb for limb."""
    with _NoTableBuild():
        t0 = time.time()
        for basis in BASES:
            again.window_table(basis)
        sync()
    secs = time.time() - t0
    for basis in BASES:
        a, b = srs.window_table(basis), again.window_table(basis)
        if not (_eq(a.tx, b.tx) and _eq(a.ty, b.ty) and _eq(a.tvalid, b.tvalid)):
            raise AssertionError(f"k = {srs.k} {basis} table from the cache "
                                 "!= the table built")
    return secs


def phase_commit():
    t0 = time.time()
    srs = Srs.setup(K, seed=b"bench-srs")
    sync()
    t_setup = time.time() - t0
    # a miss (the cache directory is new): built and written to the cache
    t0 = time.time()
    for basis in BASES:
        srs.window_table(basis)
    sync()
    t_tables = time.time() - t0
    # a second Srs.setup reads both from the files
    t0 = time.time()
    again = Srs.setup(K, seed=b"bench-srs")
    sync()
    t_setup2 = time.time() - t0
    if (again.g, again.g_lagrange) != (srs.g, srs.g_lagrange):
        raise AssertionError("two Srs.setup calls of one seed differ")
    t_cached = _cached_tables(srs, again)
    del again
    cache_bytes = {f: os.path.getsize(os.path.join(srs_module.CACHE_DIR, f))
                   for f in sorted(os.listdir(srs_module.CACHE_DIR))}
    n = srs.n
    tau = int.from_bytes(hashlib.blake2b(b"bench-srs", digest_size=32).digest(),
                         "little") % FR.p
    rnd = random.Random(SEED + 2)
    rows = [[rnd.randrange(FR.p) for _ in range(n)] for _ in range(8)]
    kernels.reset_launch_counts()
    t0 = time.time()
    coms = srs.commit(rows)
    sync()
    t_batch = time.time() - t0
    for row, com in zip(rows, coms):
        acc = 0
        for coeff in reversed(row):
            acc = (acc * tau + coeff) % FR.p
        if com != g1_mul(G1_GEN, acc):
            raise AssertionError("commit != (sum row_i tau^i) G")
    t0 = time.time()
    one = srs.commit_lagrange([1] * n)
    sync()
    t_lag = time.time() - t0
    if one != G1_GEN:
        raise AssertionError("commit_lagrange([1]*n) != G")
    launches = kernels.launch_counts()

    # where one batch's time goes: prep (digits, sort, gather, bookkeeping),
    # the bucket pipeline (kernels + layout conversion + scatter), and the
    # host's normalisation of the 16 accumulators in Python ints; and the
    # table build's batch inversion with its one 32-byte round trip
    table = srs.window_table("monomial")
    sl = to_device(to_limbs(np.asarray(rows, dtype=object)), DEV)
    r_rows = pippenger._pip_r_rows(int(table.tx.shape[0]))
    sync()
    t0 = time.time()
    prep = pippenger._pipfb_prep(sl, table.tx, table.ty, table.tvalid,
                                 c=table.c, r_rows=r_rows)
    compact = int(prep[-1]) > r_rows
    sync()
    t_prep = time.time() - t0
    t0 = time.time()
    acc = pippenger._pipeline_device(prep[:-1], r_rows, table.c, compact)
    sync()
    t_pipe = time.time() - t0
    t0 = time.time()
    points_from_device(tuple(comp.reshape(-1, 16) for comp in acc))
    t_host = time.time() - t0
    t0 = time.time()
    pippenger._fq_batch_inv(table.tx)
    sync()
    t_inv = time.time() - t0
    emit(dict(phase="commit", k=K, setup_s=round(t_setup, 3),
              tables_s=round(t_tables, 3), setup_second_s=round(t_setup2, 3),
              tables_cached_s=round(t_cached, 3), tables_cached_equal=True,
              cache_file_bytes=cache_bytes, msm_batch8_s=round(t_batch, 3),
              msm_lagrange_ones_s=round(t_lag, 3), launches=launches,
              msm_breakdown=dict(prep_s=round(t_prep, 4),
                                 pipeline_s=round(t_pipe, 4),
                                 points_from_device_s=round(t_host, 4),
                                 compacted=compact),
              fq_batch_inv_table_s=round(t_inv, 4), ok=True))
    return srs


# ---- phase 6: prove ---------------------------------------------------------------

class NibbleMulFill:
    """The nibble-multiplication circuit (one mul gate, one 16-entry lookup,
    equality on four columns, one instance) laid down `reps` times, operands
    drawn from a handful of values so that advice columns hold runs of equal
    values far longer than the MSM's 1,024 scan rows. The first region's
    product is the public instance."""

    VALUES = ((3, 5), (3, 5), (7, 2), (3, 5))

    def __init__(self, reps):
        self.reps = reps

    def configure(self, cs):
        col_a = cs.advice_column()
        col_b = cs.advice_column()
        col_c = cs.advice_column()
        sel = cs.selector()
        table = cs.lookup_table_column()
        q_look = cs.selector()
        instance = cs.instance_column()
        for c in (col_a, col_b, col_c, instance):
            cs.enable_equality(c)
        cs.create_gate("mul", [sel.expr() * (col_a.cur() * col_b.cur() - col_c.cur())])
        cs.lookup("a_nibble", [(q_look.expr() * col_a.cur(), table)])
        return dict(a=col_a, b=col_b, c=col_c, sel=sel, table=table,
                    q_look=q_look, instance=instance)

    def synthesize(self, cfg, asn):
        asn.assign_table([cfg["table"]], [list(range(16))])
        block = max(1, self.reps // len(self.VALUES))
        for i in range(self.reps):
            a, b = self.VALUES[min(i // block, len(self.VALUES) - 1)]
            row = asn.region([cfg["a"], cfg["b"], cfg["c"], cfg["sel"],
                              cfg["q_look"]], 1)
            (ca,) = asn.assign_advice(cfg["a"], row, a)
            asn.assign_advice(cfg["b"], row, b)
            (cc,) = asn.assign_advice(cfg["c"], row, a * b % FR.p)
            asn.enable_selector(cfg["sel"], row)
            asn.enable_selector(cfg["q_look"], row)
            row2 = asn.region([cfg["b"]], 1)
            (cb2,) = asn.assign_advice(cfg["b"], row2, a)
            asn.copy(ca, cb2)
            if i == 0:
                asn.constrain_instance(cc, cfg["instance"], 0)


def _rejected(verify, *args):
    """True if the verifier refuses (it raises ValueError on a bad proof)."""
    try:
        return not verify(*args)
    except ValueError:
        return True


def phase_prove(srs):
    from zerog_tpu_torch.plonk import (
        ConstraintSystem, create_proof, keygen, verify_proof)

    n = 1 << K
    cs = ConstraintSystem()
    NibbleMulFill(1).configure(cs)
    usable = cs.usable_rows(n)
    reps = (usable - 1) // 2          # two rows a repetition
    circuit = NibbleMulFill(reps)
    instances = [[15]]

    kernels.reset_launch_counts()
    t0 = time.time()
    pk = keygen(circuit, K, srs)
    sync()
    t_keygen = time.time() - t0
    t0 = time.time()
    proof1 = create_proof(pk, srs, circuit, instances, rng_seed=b"chip-smoke")
    sync()
    t_prove1 = time.time() - t0
    timings = {}
    t0 = time.time()
    proof2 = create_proof(pk, srs, circuit, instances, rng_seed=b"chip-smoke",
                          timings=timings)
    sync()
    t_prove2 = time.time() - t0
    t0 = time.time()
    ok = verify_proof(pk.vk, srs, instances, proof2)
    t_verify = time.time() - t0
    launches = kernels.launch_counts()

    if proof1 != proof2:
        raise AssertionError("equal seeds gave different proof bytes")
    if not ok:
        raise AssertionError("proof did not verify")
    bad = bytearray(proof2)
    bad[len(bad) // 2] ^= 1
    if not _rejected(verify_proof, pk.vk, srs, instances, bytes(bad)):
        raise AssertionError("tampered proof accepted")
    if not _rejected(verify_proof, pk.vk, srs, [[16]], proof2):
        raise AssertionError("wrong instance accepted")
    for name in MSM_KERNELS + NTT_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 "prove path")
    emit(dict(phase="prove", k=K, rows_filled=2 * reps, usable_rows=usable,
              keygen_s=round(t_keygen, 3), prove_first_s=round(t_prove1, 3),
              prove_second_s=round(t_prove2, 3), verify_s=round(t_verify, 3),
              timings={k: round(v, 4) for k, v in timings.items()},
              proof_bytes=len(proof2), launches=launches, verified=True,
              tamper_rejected=True, wrong_instance_rejected=True,
              deterministic=True))
    return launches


# ---- phase 7: WNN proof of inference -------------------------------------------------

def tiny_model():
    from zerog_tpu_torch.models import make_synthetic_wnn

    return make_synthetic_wnn(*TINY_SHAPE, seed=0)


def smoke_image():
    return np.random.default_rng(SEED).integers(0, 256, (28, 28)).astype(np.uint8)


def phase_wnn(srs):
    """The system's own path on a seeded model of MNIST-Tiny's shape at
    k = 14: device prediction, keygen, two proofs under one seed, verify,
    rejections, and a third proof on the butterflies alone."""
    wnn = tiny_model()
    image = smoke_image()
    scores = [int(v) for v in wnn.predict(image)]
    t0 = time.time()
    fwd = wnn.predict_fn()
    dev_scores = fwd(image)
    sync()
    t_predict = time.time() - t0
    if dev_scores.device != DEV or dev_scores.tolist() != scores:
        raise AssertionError(f"predict_fn on the card {dev_scores.tolist()} "
                             f"!= predict {scores}")

    kernels.reset_launch_counts()
    t0 = time.time()
    pk = wnn.generate_proving_key(srs)
    sync()
    t_keygen = time.time() - t0
    t0 = time.time()
    proof1, out1 = wnn.proof(pk, srs, image, rng_seed=b"chip-smoke-wnn")
    sync()
    t_prove1 = time.time() - t0
    timings = {}
    t0 = time.time()
    with _MsmRecorder() as rec:
        proof2, out2 = wnn.proof(pk, srs, image, rng_seed=b"chip-smoke-wnn",
                                 timings=timings)
        sync()
    t_prove2 = time.time() - t0
    t0 = time.time()
    ok = wnn.verify_proof(proof2, srs, pk.vk, out2)
    t_verify = time.time() - t0
    launches = kernels.launch_counts()

    if out1 != scores or out2 != scores:
        raise AssertionError("the proof's public scores != predict")
    if proof1 != proof2:
        raise AssertionError("equal seeds gave different WNN proof bytes")
    if hashlib.sha256(proof2).hexdigest() != WNN_PROOF_SHA256:
        raise AssertionError(f"WNN proof SHA-256 {hashlib.sha256(proof2).hexdigest()} "
                             f"!= {WNN_PROOF_SHA256}")
    if not ok:
        raise AssertionError("WNN proof did not verify")
    bad = bytearray(proof2)
    bad[len(bad) // 2] ^= 1
    if not _rejected(wnn.verify_proof, bytes(bad), srs, pk.vk, out2):
        raise AssertionError("tampered WNN proof accepted")
    wrong = list(scores)
    wrong[0] += 1
    if not _rejected(wnn.verify_proof, proof2, srs, pk.vk, wrong):
        raise AssertionError("wrong scores accepted")
    for name in MSM_KERNELS + NTT_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 "WNN path")

    # the whole path on the butterflies alone (a fresh key, so that no
    # cached extended form of the engine is reused): the same bytes; the
    # second, warm proof is timed beside the engine's
    saved = NttPlan.MXU_MIN_LOG_N
    NttPlan.MXU_MIN_LOG_N = 64
    try:
        kernels.reset_launch_counts()
        pk_b = wnn.generate_proving_key(srs)
        proof3, _ = wnn.proof(pk_b, srs, image, rng_seed=b"chip-smoke-wnn")
        timings_b = {}
        t0 = time.time()
        proof4, _ = wnn.proof(pk_b, srs, image, rng_seed=b"chip-smoke-wnn",
                              timings=timings_b)
        sync()
        t_prove_b = time.time() - t0
        butterfly_launches = {k: kernels.launch_counts()[k] for k in NTT_KERNELS}
    finally:
        NttPlan.MXU_MIN_LOG_N = saved
    if any(butterfly_launches.values()):
        raise AssertionError("the butterfly-only proof launched NTT kernels")
    if proof3 != proof2 or proof4 != proof2:
        raise AssertionError("engine and butterflies gave different proof bytes")
    emit(dict(phase="wnn", k=K, model="make_synthetic_wnn(28, 256, 1, 1, seed=0)",
              l=wnn.l, p=wnn.p, scores=scores, predict_fn_s=round(t_predict, 3),
              keygen_s=round(t_keygen, 3), prove_first_s=round(t_prove1, 3),
              prove_second_s=round(t_prove2, 3), verify_s=round(t_verify, 3),
              timings={k: round(v, 4) for k, v in timings.items()},
              butterflies_prove_second_s=round(t_prove_b, 3),
              butterflies_timings={k: round(v, 4) for k, v in timings_b.items()},
              proof_bytes=len(proof2),
              proof_sha256=hashlib.sha256(proof2).hexdigest(),
              launches=launches, verified=True,
              tamper_rejected=True, wrong_scores_rejected=True,
              deterministic=True, engine_equals_butterflies_bytes=True))
    return launches, rec, pk, t_prove2


def _path_affine(rec):
    """Kernel 2 on the operands of every launch of the warm WNN proof: each
    timed again, its segments, the work it needs and where bucket 0 sits;
    the launch with the longest segment held against the plain version limb
    for limb, and its recorded output against a rerun."""
    if not rec.affine:
        raise AssertionError("the warm WNN proof launched no flush_scan_affine")
    latency = field_chain.product_latency_us(FQ, DEV)
    runs = [_scan_affine_case(planes, latency, check=False, buckets=buckets)[0]
            for planes, _, buckets in rec.affine]
    pick = max(range(len(runs)), key=lambda i: (
        runs[i]["longest_segment"], runs[i]["required_adds"]))
    planes, kernel_out, _ = rec.affine[pick]
    checked, _ = _scan_affine_case(planes, latency)
    again = pscan.flush_scan_affine_words(*planes)
    if not all(_eq(a, b) for a, b in zip(kernel_out, again)):
        raise AssertionError("flush_scan_affine: the recorded launch and its "
                             "rerun differ")

    def total(key):
        return sum(r[key] for r in runs)

    return dict(
        launches_per_proof=len(runs), ms_per_proof=total("ms"),
        max_launch_ms=max(r["ms"] for r in runs),
        bound_ms_per_proof=total("bound_ms"),
        bound_all_rows_ms_per_proof=total("bound_all_rows_ms"),
        chain_floor_ms_per_proof=total("chain_floor_ms"),
        product_latency_us=latency,
        valid_share=total("valid_rows") / total("all_rows_adds"),
        flag_share=sum(r["flag_share"] * r["all_rows_adds"] for r in runs)
        / total("all_rows_adds"),
        required_adds=total("required_adds"), all_rows_adds=total("all_rows_adds"),
        longest_segment=max(r["longest_segment"] for r in runs),
        longest_chain=max(r["longest_chain"] for r in runs),
        one_segment_columns=total("one_segment_columns"),
        bucket0_row_share=sum(r["bucket0_row_share"] * r["all_rows_adds"] for r in runs)
        / total("all_rows_adds"),
        bucket0_adds_share=sum(r["bucket0_adds_share"] * r["required_adds"]
                               for r in runs) / max(1, total("required_adds")),
        longest_segment_nonzero_bucket=max(r["longest_segment_nonzero_bucket"]
                                           for r in runs),
        longest_chain_nonzero_bucket=max(r["longest_chain_nonzero_bucket"]
                                         for r in runs),
        checked_launch=dict(index=pick, shape=checked["shape"],
                            plain_ms=checked["plain_ms"],
                            max_abs_err=checked["max_abs_err"],
                            longest_segment=checked["longest_segment"]),
        launches=[{k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in r.items()} for r in runs])


def phase_path_kernels(rec):
    """Kernels 2-5 on the operands of the warm WNN proof (every launch
    recorded by `rec`): each launch timed again, the work it needs, and the
    launch with the longest chain of required adds (kernel 2: the longest
    segment; kernel 5: the most rows that are not the identity) held against
    the plain version limb for limb (its pieces are sorted, with long
    identity runs), and its recorded output against a rerun."""
    out = {"flush_scan_affine": _path_affine(rec)}
    scans = []
    for planes, _ in rec.scans:
        res = _fold_work(_nonidentity(planes[2]), planes[3])
        res["ms"] = time_ms(lambda: pscan.flush_scan_jac_words(*planes), reps=3)
        r, _, ct = planes[0].shape
        res.update(_scan_jac_bounds(r, ct, res))
        scans.append(res)
    folds = [_sum_rows_case([planes[i:i + 3] for i in range(0, len(planes), 3)],
                            check=False) for planes, _ in rec.folds]
    weighted = [_weighted_case(planes, check=False) for planes, _ in rec.weighted]

    def check_scan(planes):
        return _scan_jac_case(planes)[0], pscan.flush_scan_jac_words(*planes)

    def check_fold(planes):
        return (_sum_rows_case([planes[i:i + 3] for i in range(0, len(planes), 3)]),
                pfold.sum_rows_words(*planes))

    def check_weighted(planes):
        return _weighted_case(planes), pfold.weighted_fold_words(*planes)

    chain = ("longest_chain", "required_adds")
    for name, runs, recorded, check, key in (
            ("flush_scan_jac", scans, rec.scans, check_scan, chain),
            ("sum_rows", folds, rec.folds, check_fold, chain),
            ("weighted_fold", weighted, rec.weighted, check_weighted,
             ("nonidentity_rows", "required_adds"))):
        if not runs:
            raise AssertionError(f"the warm WNN proof launched no {name}")
        pick = max(range(len(runs)), key=lambda i: tuple(runs[i][k] for k in key))
        planes, kernel_out = recorded[pick]
        # the recorded launch itself gave the same limbs as this check's
        checked, again = check(planes)
        if not all(_eq(a, b) for a, b in zip(kernel_out, again)):
            raise AssertionError(f"{name}: the recorded launch and its rerun differ")
        work = _merge_work(runs)
        out[name] = dict(
            launches_per_proof=len(runs),
            ms_per_proof=sum(r["ms"] for r in runs),
            max_launch_ms=max(r["ms"] for r in runs),
            bound_ms_per_proof=sum(r["bound_ms"] for r in runs),
            bound_all_rows_ms_per_proof=sum(r["bound_all_rows_ms"] for r in runs),
            identity_share=work["identity_share"],
            required_adds=work["required_adds"],
            all_rows_adds=work["all_rows_adds"],
            longest_chain=work["longest_chain"],
            checked_launch=dict(index=pick, shape=checked["shape"],
                                plain_ms=checked["plain_ms"],
                                max_abs_err=checked["max_abs_err"],
                                longest_chain=checked["longest_chain"]),
            launches=[dict(ms=r["ms"], required_adds=r["required_adds"],
                           longest_chain=r["longest_chain"],
                           identity_share=round(r["identity_share"], 4))
                      for r in runs])
        if name == "weighted_fold":
            # a lane's rows before its a1 first leaves the identity cost no
            # product in either add
            out[name]["leading_identity_share"] = sum(
                r["leading_identity_share"] * r["all_rows_adds"] for r in runs) / sum(
                r["all_rows_adds"] for r in runs)
            out[name]["leading_identity_rows_min"] = min(
                r["leading_identity_rows_min"] for r in runs)
            for r, line in zip(runs, out[name]["launches"]):
                line.update(leading_identity_share=round(r["leading_identity_share"], 4),
                            leading_identity_rows_min=r["leading_identity_rows_min"])
    emit(dict(phase="path_kernels", equal_to_plain=True, tolerance=0, **out))
    return out


# ---- phase 8: the user's entry point: files, CLI, EVM verifier, local chain -----------

def _cli(argv):
    """Run ``zerog_tpu_torch.cli.main(argv)``; return what it printed."""
    import contextlib
    import io

    from zerog_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def phase_cli(srs, pk):
    """The slice's path at full width: the SRS made by ``generate-srs``; the
    ``wnn`` phase's SRS, key and circuit params written to files and read
    back; the proof from the files (its SHA-256 is the ``wnn`` phase's);
    ``verify`` from the files; the k = 14 verifier contract generated and
    dry-run in the EVM executor (a tampered proof and wrong scores
    reverted); ``deploy-evm-verifier`` and ``submit-proof`` on the local
    node, sharing its state through a file. The subcommands that load an
    HDF5 model or a PNG (the card's machine has neither h5py nor PIL) are
    replaced by the port functions they call after loading."""
    import os
    import re
    import tempfile

    from zerog_tpu_torch.eth import dry_run_verifier, gen_evm_verifier
    from zerog_tpu_torch.models.io import (read_circuit_params,
                                           write_circuit_params,
                                           write_proof_with_output)
    from zerog_tpu_torch.models.keys_io import read_pk, read_vk, write_keys

    wnn = tiny_model()
    image = smoke_image()
    secs, sizes = {}, {}

    def timed(name, fn, *args, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        sync()
        secs[name] = round(time.time() - t0, 3)
        return out

    kernels.reset_launch_counts()
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="zg_cli_") as tmp:
        def f(name):
            return os.path.join(tmp, name)

        # the SRS made through the CLI equals one made in the process
        out = timed("generate_srs", _cli, ["generate-srs", "-k", str(K),
                                           "--srs-path", f("srs_cli.bin")])
        if out != f"SRS (k={K}) written to {f('srs_cli.bin')}\n":
            raise AssertionError(f"generate-srs printed {out!r}")
        fresh = timed("setup", Srs.setup, K)
        back = timed("read_srs_cli", Srs.read, f("srs_cli.bin"))
        if (back.g, back.g_lagrange, back.g2, back.s_g2) != (
                fresh.g, fresh.g_lagrange, fresh.g2, fresh.s_g2):
            raise AssertionError("Srs.read of generate-srs's file != Srs.setup(14)")
        del fresh, back

        # the wnn phase's SRS, key and circuit params through files
        params = wnn.get_circuit_params()
        timed("write_srs", srs.write, f("srs.bin"))
        timed("write_keys", write_keys, pk, f("pk.npz"), f("vk.npz"))
        write_circuit_params(params, f("circuit_params.json"))
        srs2 = timed("read_srs", Srs.read, f("srs.bin"))
        params2 = read_circuit_params(f("circuit_params.json"))
        pk2 = timed("read_pk", read_pk, f("pk.npz"), params2)
        vk2 = timed("read_vk", read_vk, f("vk.npz"), params2)
        if params2 != params:
            raise AssertionError("circuit params read back differ")
        if not (pk2.vk.transcript_repr == vk2.transcript_repr
                == pk.vk.transcript_repr):
            raise AssertionError("the key read back has another transcript_repr")
        # the SRS read back finds its window tables on disk
        with _NoTableBuild():
            proof, outputs = timed("prove_from_files", wnn.proof, pk2, srs2, image,
                                   rng_seed=b"chip-smoke-wnn")
        sha = hashlib.sha256(proof).hexdigest()
        if sha != WNN_PROOF_SHA256:
            raise AssertionError(f"proof from the files: SHA-256 {sha} != "
                                 f"{WNN_PROOF_SHA256}")
        write_proof_with_output(proof, outputs, f("proof.json"))
        bad = bytearray(proof)
        bad[len(bad) // 2] ^= 1
        bad = bytes(bad)
        write_proof_with_output(bad, outputs, f("proof_bad.json"))
        for name in ("srs_cli.bin", "srs.bin", "pk.npz", "vk.npz",
                     "circuit_params.json", "proof.json"):
            sizes[name] = os.path.getsize(f(name))

        files = ["--srs-path", f("srs.bin"), "--vk-path", f("vk.npz"),
                 "--circuit-params-path", f("circuit_params.json")]
        out = timed("verify_cli", _cli, ["verify"] + files
                    + ["--proof-path", f("proof.json")])
        if not out.startswith("Proof verified") or str(outputs) not in out:
            raise AssertionError(f"verify printed {out!r}")

        # the EVM verifier of the k = 14 key, dry-run in the executor
        code = timed("codegen", gen_evm_verifier, vk2, srs2, [len(outputs)])
        gas = timed("dry_run", dry_run_verifier, code, [outputs], proof)
        wrong = list(outputs)
        wrong[0] += 1
        for case, args in (("dry_run_tampered", ([outputs], bad)),
                           ("dry_run_wrong_scores", ([wrong], proof))):
            t0 = time.time()
            try:
                dry_run_verifier(code, *args)
            except ValueError:
                secs[case] = round(time.time() - t0, 3)
            else:
                raise AssertionError(f"EVM verifier accepted: {case}")

        # deploy and submit on the local node, its state in a file
        os.environ["ZEROG_DEV_NODE_STATE"] = f("devnode.json")
        try:
            out = timed("deploy_cli", _cli, ["deploy-evm-verifier"] + files
                        + ["--endpoint", "local"])
            found = re.findall(r"^Contract address: (0x[0-9a-f]{40})$", out, re.M)
            if len(found) != 1:
                raise AssertionError(f"deploy-evm-verifier printed {out!r}")
            addr = found[0]
            out = timed("submit_cli", _cli, ["submit-proof", "--proof-path",
                                             f("proof.json"), addr,
                                             "--endpoint", "local"])
            submit_gas = int(re.search(r"Gas used: (\d+)", out).group(1))
            t0 = time.time()
            try:
                _cli(["submit-proof", "--proof-path", f("proof_bad.json"), addr,
                      "--endpoint", "local"])
            except ValueError:
                secs["submit_tampered_cli"] = round(time.time() - t0, 3)
            else:
                raise AssertionError("the local node accepted a tampered proof")
        finally:
            del os.environ["ZEROG_DEV_NODE_STATE"]
    launches = kernels.launch_counts()
    for name in MSM_KERNELS + NTT_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 "cli path")
    total = round(time.time() - t_phase, 3)
    emit(dict(phase="cli", k=K, model="make_synthetic_wnn(28, 256, 1, 1, seed=0)",
              seconds=secs, total_s=total, file_bytes=sizes,
              proof_sha256=sha, proof_bytes=len(proof), tables_from_cache=True,
              transcript_repr_equal=True, srs_cli_equals_setup=True,
              verified_cli=True, evm_code_bytes=len(code), evm_gas=gas,
              evm_tampered_rejected=True, evm_wrong_scores_rejected=True,
              contract_address=addr, submit_gas=submit_gas,
              submit_tampered_rejected=True, launches=launches))
    return launches


# ---- phase: mesh --------------------------------------------------------------------

MESH_ENTRIES = 4       # the deployment a four-card cell will measure
STRATEGY_POINTS = 4096


def _strategy(name, fn, want):
    """Seconds of `fn()` on the card, and its points against `want`."""
    sync()
    t0 = time.time()
    got = fn()
    sync()
    secs = round(time.time() - t0, 3)
    if got != want:
        raise AssertionError(f"MSM strategy {name} != its reference strategy")
    return secs


def phase_mesh(srs, pk, single_warm_s):
    """The mesh path on the card: the ``wnn`` phase's warm proof repeated on
    a mesh of 4 entries on the one card (the same pk, SRS, image and seed;
    commitments through the point-sharded MSM, each entry launching kernels
    2-5 on its shard, the four-step NTTs, the quotient on row blocks), first
    and warm, its bytes the ``wnn`` phase's; the dry run of the toy circuit
    on the same mesh; the strategies ``scan``, ``danaa`` and ``segscan``
    held against ``pippenger`` and ``fixed``, points equal. The launches of
    the two mesh proofs are the ``mesh`` column of ``launches_by_path``."""
    import contextlib
    import io

    from zerog_tpu_torch.curve import msm
    from zerog_tpu_torch.parallel import make_mesh
    from zerog_tpu_torch.parallel.dryrun import dryrun_multichip
    from zerog_tpu_torch.plonk import create_proof

    wnn = tiny_model()
    image = smoke_image()
    outputs = [int(v) for v in wnn.predict(image)]
    mesh = make_mesh(MESH_ENTRIES, [DEV] * MESH_ENTRIES)

    kernels.reset_launch_counts()
    t0 = time.time()
    proof1 = create_proof(pk, srs, wnn.get_circuit(image), [outputs],
                          rng_seed=b"chip-smoke-wnn", mesh=mesh)
    sync()
    t_first = time.time() - t0
    timings = {}
    t0 = time.time()
    proof2 = create_proof(pk, srs, wnn.get_circuit(image), [outputs],
                          rng_seed=b"chip-smoke-wnn", mesh=mesh, timings=timings)
    sync()
    t_warm = time.time() - t0
    launches = kernels.launch_counts()
    sha = hashlib.sha256(proof2).hexdigest()
    if proof1 != proof2:
        raise AssertionError("equal seeds gave different mesh proof bytes")
    if sha != WNN_PROOF_SHA256:
        raise AssertionError(f"mesh WNN proof SHA-256 {sha} != {WNN_PROOF_SHA256}")
    if not wnn.verify_proof(proof2, srs, pk.vk, outputs):
        raise AssertionError("the mesh WNN proof did not verify")
    for name in MSM_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 "mesh path")

    # the dry run's own lines go into the mesh line: one JSON object a line
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        proxy = dryrun_multichip(MESH_ENTRIES, [DEV] * MESH_ENTRIES)
    sync()
    t_dryrun = time.time() - t0

    # the strategies, each against the one the prover runs
    rnd = random.Random(SEED + 3)
    pdev = points_to_device(srs.g[:STRATEGY_POINTS], device=DEV)
    rows = [[rnd.randrange(FR.p) for _ in range(STRATEGY_POINTS)] for _ in range(2)]
    want = msm(rows, pdev, strategy="pippenger", device=DEV)
    secs = {name: _strategy(name, lambda name=name: msm(rows, pdev, strategy=name,
                                                        device=DEV), want)
            for name in ("scan", "danaa")}
    table = srs.window_table("lagrange")
    rows8 = [[rnd.randrange(FR.p) for _ in range(srs.n)] for _ in range(8)]
    t0 = time.time()
    want8 = msm(rows8, table=table, device=DEV)
    sync()
    secs["fixed"] = round(time.time() - t0, 3)
    secs["segscan"] = _strategy("segscan", lambda: msm(
        rows8, table=table, strategy="segscan", device=DEV), want8)

    emit(dict(phase="mesh", k=K, model="make_synthetic_wnn(28, 256, 1, 1, seed=0)",
              entries=[str(d) for d in mesh], prove_first_s=round(t_first, 3),
              prove_warm_s=round(t_warm, 3),
              single_device_prove_warm_s=round(single_warm_s, 3),
              timings={k: round(v, 4) for k, v in timings.items()},
              proof_sha256=sha, proof_bytes=len(proof2), verified=True,
              launches=launches, dryrun_s=round(t_dryrun, 3),
              dryrun=buf.getvalue().splitlines()[0], scaling_proxy=proxy,
              strategies=dict(seconds=secs,
                              scan_danaa=f"2 rows x {STRATEGY_POINTS} points of "
                                         "the k = 14 SRS, against pippenger",
                              segscan="8 rows over the k = 14 Lagrange window "
                                      "table, against fixed",
                              points_equal=True)))
    return launches


# ---- phase: large — the WNN proof at MNIST-Large's shape, k = 17 ---------------------

class _AdviceRecorder:
    """Records the first ``commit_lagrange`` call on `srs` while active: the
    prover's advice columns (blinding rows included) and their points."""

    def __init__(self, srs):
        self.srs = srs

    def __enter__(self):
        self.rows = self.points = None
        commit = self.srs.commit_lagrange

        def rec(values):
            out = commit(values)
            if self.rows is None:
                self.rows, self.points = values, out
            return out

        self.srs.commit_lagrange = rec
        return self

    def __exit__(self, *exc):
        del self.srs.commit_lagrange


def _lagrange_at(values, k, tau):
    """sum_i values_i L_i(tau) over the domain of size 2^k, with L_i(tau) =
    w^i / n (tau^n - 1) / (tau - w^i): the scalar of a Lagrange-form
    commitment, in Python ints."""
    p, n = FR.p, 1 << k
    omega = FR.nth_root_of_unity(k)
    wpows = [1] * n
    for i in range(1, n):
        wpows[i] = wpows[i - 1] * omega % p
    dinv = batch_inv([(tau - w) % p for w in wpows], p)
    acc = sum(int(v) % p * w % p * d for v, w, d in zip(values, wpows, dinv)) % p
    return acc * ((pow(tau, n, p) - 1) % p) % p * FR.inv(n) % p


def _check_levels(rec, n):
    """Every kernel call `rec` recorded in a transform of size `n`, held
    against its plain version limb for limb and timed; returns one dict a
    call."""
    if not rec.epilogues:
        raise AssertionError(f"the n = {n} transform launched no ntt_epilogue")
    out = []
    for (acc, colsum, rowc, tw, out_bytes), got in rec.epilogues:
        with plain_field():
            ref = pntt.epilogue_plain(acc, colsum, rowc, tw, out_bytes)
        if not _eq(got, ref):
            raise AssertionError(f"ntt_epilogue {tuple(acc.shape)} != plain")
        t, lanes = acc.shape[1], acc.shape[2]
        ms = time_ms(lambda: pntt.epilogue_words(acc, colsum, rowc, tw, out_bytes),
                     reps=3)
        b_ms, b_by = _epilogue_bound(t, lanes, tw is not None)
        out.append(dict(kernel="ntt_epilogue", n=n, t=t, lanes=lanes,
                        out="bytes" if out_bytes else "words", ms=ms,
                        bound_ms=b_ms, bound_by=b_by, max_abs_err=0))
        del ref
    for (xb, twc), (got, colsum) in rec.twiddles:
        with plain_field():
            ref, ref_sum = pntt.twiddle_plain(xb, twc)
        if not (_eq(got, ref) and _eq(colsum, ref_sum)):
            raise AssertionError(f"ntt_twiddle {tuple(xb.shape)} != plain")
        s, lanes, r = xb.shape[1], xb.shape[2], twc.shape[2]
        ms = time_ms(lambda: pntt.twiddle_words(xb, twc), reps=3)
        elems = s * lanes
        b_ms, b_by = bound(elems * 64 + 32 * s * r + 4 * s * (lanes // r),
                           elems * IMAD_SLOTS_PER_MUL)
        out.append(dict(kernel="ntt_twiddle", n=n, s=s, r=r, g=lanes // r, ms=ms,
                        bound_ms=b_ms, bound_by=b_by, max_abs_err=0))
        del ref, ref_sum
    return out


class _NoCardConv:
    """While active, JField's float64 convolution (the plain product's) raises
    on a CUDA tensor: every product on the card must take ``field_limbs``."""

    def __enter__(self):
        self._saved = jfield._conv

        def conv(a, b):
            if a.is_cuda:
                raise AssertionError("JField made a float64 block on the card")
            return self._saved(a, b)

        jfield._conv = conv
        return self

    def __exit__(self, *exc):
        jfield._conv = self._saved


class _CardFieldCalls:
    """While active, counts JField's add, sub and mul calls on CUDA tensors
    (``calls``), beside the program's own counter of the kernel that serves
    them."""

    def __enter__(self):
        self.calls = 0
        self._saved = {op: JField.__dict__[op] for op in ("add", "sub", "mul")}
        for op, fn in self._saved.items():
            def counted(f, a, b, _fn=fn):
                self.calls += a.is_cuda
                return _fn(f, a, b)
            setattr(JField, op, counted)
        return self

    def __exit__(self, *exc):
        for op, fn in self._saved.items():
            setattr(JField, op, fn)


def phase_large():
    """The WNN proof of inference at MNIST-Large's shape, k = 17, at full
    width: ``make_synthetic_wnn(*MNIST_LARGE_SHAPE)``, ``Srs.setup(17,
    seed=b"bench-srs")`` and its window tables (built, then read from the
    cache by a second Srs), keygen, two proofs under one seed (equal bytes,
    their SHA-256 asserted), verify, a tampered proof and wrong scores
    rejected. The proof's first
    advice commitment is held against [a(tau)]G on the host. The proof's
    advice transform (2^17 inverse, 2^20 coset-extended) is run again
    with every kernel 6 and 7 call held against its plain version and the
    engine against the butterflies; those launches are not counted. The
    launches of keygen, the two proofs and verify are the ``large`` column
    of ``launches_by_path``. Keygen and the proofs run with JField's float64
    convolution refused on the card (``_NoCardConv``). A third proof under a
    profile of the host gives the program's counters ``field_ops``,
    ``field_kernel`` and ``field_kernel_copies`` (``traced_proof_counters``);
    ``field_kernel`` must equal that proof's JField add, sub and mul calls on
    CUDA tensors, counted apart (``_CardFieldCalls``)."""
    from zerog_tpu_torch.models import MNIST_LARGE_SHAPE, make_synthetic_wnn

    t_phase = time.time()
    secs = {}

    def timed(name, fn, *args, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        sync()
        secs[name] = round(time.time() - t0, 3)
        return out

    wnn = make_synthetic_wnn(*MNIST_LARGE_SHAPE)
    image = np.random.default_rng(SEED + 17).integers(0, 256, (28, 28)).astype(np.uint8)
    scores = [int(v) for v in wnn.predict(image)]
    torch.cuda.reset_peak_memory_stats(DEV)
    srs = timed("setup", Srs.setup, LARGE_K, seed=b"bench-srs")
    timed("tables", lambda: [srs.window_table(b) for b in BASES])
    secs["tables_cached"] = round(_cached_tables(
        srs, Srs(srs.k, srs.g, srs.g_lagrange, srs.g2, srs.s_g2)), 3)

    kernels.reset_launch_counts()
    with _NoCardConv():
        pk = timed("keygen", wnn.generate_proving_key, srs)
        with _AdviceRecorder(srs) as adv:
            proof1, out1 = timed("prove_first", wnn.proof, pk, srs, image,
                                 rng_seed=b"chip-smoke-large")
    before_checks = kernels.launch_counts()

    # the first advice commitment against the tau ground truth
    tau = int.from_bytes(hashlib.blake2b(b"bench-srs", digest_size=32).digest(),
                         "little") % FR.p
    t0 = time.time()
    want = g1_mul(G1_GEN, _lagrange_at(adv.rows[0], LARGE_K, tau))
    if adv.points[0] != want:
        raise AssertionError("advice commitment != [a(tau)]G")
    if proof1[:64] != want[0].to_bytes(32, "big") + want[1].to_bytes(32, "big"):
        raise AssertionError("the proof's first point is not the advice commitment")
    secs["tau_check"] = round(time.time() - t0, 3)

    # the proof's advice transform again: kernels 6 and 7 at its 2^17 and
    # 2^20 levels against their plain versions, engine against butterflies
    dom = get_domain(LARGE_K, pk.vk.cs.degree(), DEV)
    lag = to_device(to_limbs(np.asarray(adv.rows, dtype=object) % FR.p, FR, mont=True),
                    DEV)
    del adv
    with _LevelRecorder() as rec:
        coeff = dom.lagrange_to_coeff(lag)
        sync()
    levels = _check_levels(rec, dom.n)
    with _LevelRecorder() as rec:
        ext = dom.coeff_to_extended(coeff)
        sync()
    levels += _check_levels(rec, dom.extended_n)
    del rec
    saved = NttPlan.MXU_MIN_LOG_N
    NttPlan.MXU_MIN_LOG_N = 64
    try:
        with plain_field():
            same = (_eq(coeff, dom.lagrange_to_coeff(lag))
                    and _eq(ext, dom.coeff_to_extended(coeff)))
        if not same:
            raise AssertionError("k = 17 advice transforms: engine != butterflies")
    finally:
        NttPlan.MXU_MIN_LOG_N = saved
    ext_shape = list(ext.shape)
    del lag, coeff, ext
    after_checks = kernels.launch_counts()
    check_launches = {k: after_checks[k] - before_checks[k] for k in after_checks}
    peak_first = torch.cuda.max_memory_allocated(DEV)

    torch.cuda.reset_peak_memory_stats(DEV)
    timings = {}
    with _NoCardConv():
        proof2, out2 = timed("prove_second", wnn.proof, pk, srs, image,
                             rng_seed=b"chip-smoke-large", timings=timings)
    peak_warm = torch.cuda.max_memory_allocated(DEV)
    ok = timed("verify", wnn.verify_proof, proof2, srs, pk.vk, out2)
    launches = {k: c - check_launches.get(k, 0)
                for k, c in kernels.launch_counts().items()}

    if out1 != scores or out2 != scores:
        raise AssertionError("the k = 17 proof's public scores != predict")
    if proof1 != proof2:
        raise AssertionError("equal seeds gave different k = 17 proof bytes")
    sha = hashlib.sha256(proof2).hexdigest()
    if sha != LARGE_PROOF_SHA256:
        raise AssertionError(f"k = 17 proof SHA-256 {sha} != {LARGE_PROOF_SHA256}")
    if not ok:
        raise AssertionError("the k = 17 WNN proof did not verify")
    bad = bytearray(proof2)
    bad[len(bad) // 2] ^= 1
    if not _rejected(wnn.verify_proof, bytes(bad), srs, pk.vk, out2):
        raise AssertionError("tampered k = 17 proof accepted")
    wrong = list(scores)
    wrong[0] += 1
    if not _rejected(wnn.verify_proof, proof2, srs, pk.vk, wrong):
        raise AssertionError("wrong scores accepted at k = 17")
    # kernel 3 runs only where a column's bucket run outgrows the scan rows
    for name in ("flush_scan_affine", "sum_rows", "weighted_fold",
                 "field_limbs") + NTT_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched by the "
                                 "large path")
    # a third proof under a profile of the host: the program's counters of
    # its field ops; each add, sub and mul on the card is one launch
    before = kernels.launch_counts()["field_limbs"]
    trace.reset()
    with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]),
          _CardFieldCalls() as card_calls):
        proof3, _ = wnn.proof(pk, srs, image, rng_seed=b"chip-smoke-large")
    sync()
    counted = trace.summary()["per_proof"][0]
    trace.reset()
    field_counters = dict(
        field_ops=counted.get("field_ops", 0), field_kernel=counted.get("field_kernel", 0),
        field_kernel_copies=counted.get("field_kernel_copies", 0),
        card_add_sub_mul_calls=card_calls.calls,
        field_limbs_launches=kernels.launch_counts()["field_limbs"] - before)
    if proof3 != proof2:
        raise AssertionError("the traced k = 17 proof's bytes differ")
    if field_counters["field_kernel"] != field_counters["card_add_sub_mul_calls"]:
        raise AssertionError("field_kernel != JField's add, sub and mul calls on "
                             f"the card: {field_counters}")
    emit(dict(phase="large", k=LARGE_K,
              model="make_synthetic_wnn(49, 8192, 4, 6, seed=0)", l=wnn.l, p=wnn.p,
              scores=scores, seconds=secs, total_s=round(time.time() - t_phase, 3),
              timings={k: round(v, 4) for k, v in timings.items()},
              proof_bytes=len(proof2), proof_sha256=sha,
              launches=launches, check_launches=check_launches,
              traced_proof_counters=field_counters,
              max_memory_allocated_gib=dict(
                  through_first_proof_and_checks=round(peak_first / 2**30, 3),
                  warm_proof=round(peak_warm / 2**30, 3)),
              advice_commitment_equals_tau_truth=True, extended=ext_shape,
              ntt_levels=levels, engine_equals_butterflies=True, verified=True,
              tamper_rejected=True, wrong_scores_rejected=True,
              deterministic=True, tables_cached_equal=True))
    return launches


# ---- main --------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="env,build,codec,kernels,field_limbs,bench,"
                                        "ntt,commit,prove,wnn,cli,mesh,large")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if ("cli" in phases or "mesh" in phases) and "wnn" not in phases:
        phases.append("wnn")        # cli and mesh take the wnn phase's key
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    torch.cuda.set_device(DEV)
    # a new window-table cache for this run: every table is first a miss
    with tempfile.TemporaryDirectory(prefix="zg_wtables_") as cache:
        srs_module.CACHE_DIR = cache
        run(phases)


def run(phases):
    t_start = time.time()
    phase_env()
    if "build" in phases:
        phase_build()
    if "codec" in phases:
        phase_codec()
    kres = phase_kernels() if "kernels" in phases else {}
    if "field_limbs" in phases:
        kres.update(phase_field_limbs())
    by_path = {}
    if "bench" in phases:
        bench_res, by_path["bench"] = phase_bench()
        kres.update(bench_res)
    if "ntt" in phases:
        cs = ConstraintSystem()
        tiny_model().get_circuit(np.zeros((28, 28), np.uint8)).configure(cs)
        kres.update(phase_ntt(cs.num_advice))
    path_res = {}
    if {"commit", "prove", "wnn"} & set(phases):
        srs = phase_commit()
        if "prove" in phases:
            by_path["prove"] = phase_prove(srs)
        if "wnn" in phases:
            by_path["wnn"], rec, wnn_pk, warm_s = phase_wnn(srs)
            path_res = phase_path_kernels(rec)
            del rec
            if "cli" in phases:
                by_path["cli"] = phase_cli(srs, wnn_pk)
            if "mesh" in phases:
                by_path["mesh"] = phase_mesh(srs, wnn_pk, warm_s)
            del wnn_pk
        del srs
    if "large" in phases:
        by_path["large"] = phase_large()
    main_path = by_path.get("wnn", by_path.get("prove", by_path.get("large", {})))

    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        r = kres.get(name, {})
        bench = name in BENCH_KERNELS
        row = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=(by_path.get("bench", {}) if bench else main_path).get(name, 0),
            launches_by_path={p: c.get(name, 0) for p, c in by_path.items()},
            max_abs_err=r.get("max_abs_err"), ms=r.get("ms"),
            plain_ms=r.get("plain_ms"), bound_ms=r.get("bound_ms"),
            bound_by=r.get("bound_by"), library_ms=r.get("library_ms"),
            shape=r.get("shape"),
            on_main_path=name != "field_binop" and not bench)
        if bench:
            row["launches_path"] = "bench"
        for key in ("dense", "one_segment", "us_per_add", "us_per_row",
                    "longest_segment", "valid_share", "flag_share",
                    "bound_all_rows_ms", "required_adds", "identity_share",
                    "ms_wide", "wide_shape", "wide_over_narrow", "bound_wide_ms",
                    "chain_floor_ms", "carried_floor_ms", "plain_rows",
                    "chain_products", "chain_floor_wide_ms", "longest_valid",
                    "chunks", "chunks_wide", "chains",
                    "chained_ms", "chained_bound_ms", "ns_per_product",
                    "product_latency_us", "mproducts_per_s"):
            if key in r:
                row[key] = r[key]
        if name in path_res:
            row["wnn_warm_proof"] = {k: v for k, v in path_res[name].items()
                                     if k != "launches"}
        if name == "ntt_twiddle" and r:
            row.update(regroup_copy_ms=r["regroup_copy_ms"], levels=r["levels"])
        if name in ("field_binop", "field_limbs") and r:
            row.update(bound_share=r["bound_share"],
                       bound_share_wide=r["bound_share_wide"])
        if name == "field_limbs" and r:
            row["plain_ms_wide"] = r["plain_ms_wide"]
        if name == "ntt_epilogue" and r:
            row.update(int_mm_ms=r["int_mm_ms"],
                       with_twiddle="not on the path; checked on the path's "
                                    "accumulators",
                       with_twiddle_ms=r["with_twiddle_ms"],
                       with_twiddle_bound_ms=r["with_twiddle_bound_ms"])
        rows.append(row)
    # a one-element torch add on the same timer: how much of a ~10 us
    # kernel is the launch
    one = torch.zeros(1, dtype=torch.int32, device=DEV)
    emit(dict(kernels=rows, launch_floor_ms=time_ms(lambda: one.add_(1), reps=21)))
    emit(dict(phase="total", seconds=round(time.time() - t_start, 1)))
    print(gpu_line(), flush=True)
    emit(dict(ok=True, device=dict(platform="gpu",
                                   kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))


if __name__ == "__main__":
    main()
