"""The CUDA sources of the port built with the host compiler, against the
plain versions, limb for limb.

``zerog_tpu_torch/csrc/*.cu`` also builds with ``g++ -x c++``: every exported
C function then runs the kernel's per-thread function over all threads in a
loop (``flush_scan_affine``: every (row slice, column) item, a group of one
thread; ``flush_scan_jac``: every (row slice, column) pair; ``sum_rows``:
every lane of every job; ``weighted_fold``: every lane, its two adds of a
row in one thread; ``ntt_epilogue``: every element; ``scan_bisect``
``trivial``: every word lane, its chunk totals first, then the running sums
from each chunk's offset; ``mul_reg``: every column, pass 1 of the J
interleaved chunks of each of its four lane groups, the join of their
results in the card's shuffle rounds, then the second walk). That tests
the control logic of the kernels —
the segment walks of both scans, the mixed add's levels overlapped across
rows, the identity cases, the job table of ``sum_rows``, the weighted
fold's rows loaded ahead, the epilogue's carries, REDC and four output
variants, the chunk and tile edges of ``trivial`` — on the CPU,
and the measuring kernels of ``csrc/bench.cu`` (``field_chain``, the four
``scan_bisect`` bodies) against their plain versions. The field arithmetic
of the host build is the C body, not the card's PTX, and the card's work
queues and row staging are not in it; the card's check is
``chip_smoke.py``. The plain versions are held on the same inputs against
``zerog_tpu``'s plain XLA paths (``_flush_scan(..., pallas=False)``,
``_pipv2_sum_rows``, ``_pipv2_weighted``): all cases in one call each, every
case padded with rows that leave the accumulators as they are (unflagged
(0, 0, 0) or invalid rows after a scan's, identity rows in front of a
weighted fold's). Inputs
come from a seeded generator; exact arithmetic, tolerance zero.

Build by hand (what the fixture does):

    g++ -x c++ -std=c++17 -O2 -shared -fPIC zerog_tpu_torch/csrc/*.cu \\
        -o /tmp/libzerog_host.so
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zerog_tpu.curve import pippenger as jpp

from zerog_tpu_torch import kernels
from zerog_tpu_torch.bench import field_chain, scan_bisect
from zerog_tpu_torch.curve import pfold, pippenger, pscan
from zerog_tpu_torch.curve.bn254 import G1_GEN, g1_mul
from zerog_tpu_torch.curve.jpoints import (
    jac_double, jac_from_affine, jac_infinity, points_to_device)
from zerog_tpu_torch.field import FQ, FR, from_limbs, to_limbs
from zerog_tpu_torch.field.pfield import field_binop_plain
from zerog_tpu_torch.poly import pntt

torch.set_num_threads(1)

SLICE = 32          # ZG_SCAN_SLICE in csrc/flush_scan.cu
REF_ROWS = 128      # cases padded to a multiple of the reference's 64-row chunk


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler (g++) here: csrc/ cannot be built for the host")
    out = tmp_path_factory.mktemp("csrc_host") / "libzerog_host.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    *(os.path.join(kernels.CSRC_DIR, f) for f in kernels.SOURCES),
                    "-o", str(out)], check=True, capture_output=True)
    return kernels.load(str(out))


@pytest.fixture(scope="module")
def pool():
    """48 Jacobian points: 24 random affine ones (z = 1) and their doubles
    (z != 1), as [48, 16] limbs."""
    rng = np.random.default_rng(11)
    pts = [g1_mul(G1_GEN, int(s)) for s in rng.integers(1, 1 << 40, 24)]
    aff = jac_from_affine(*points_to_device(pts, device="cpu"))
    dbl = jac_double(aff)
    return tuple(torch.cat([a, d], dim=0) for a, d in zip(aff, dbl))


def _stream(pool, rng, r, c, identity):
    """[R, 1, C] Jacobian rows drawn from the pool; where `identity` is set
    the row is the identity, as (0, 0, 0) or as (1, 1, 0) (even and odd
    columns), both of which a z of 0 marks."""
    idx = torch.from_numpy(rng.integers(0, pool[0].shape[0], (r, 1, c)))
    pts = [comp[idx] for comp in pool]
    ident = torch.from_numpy(identity).reshape(r, 1, c, 1)
    inf = jac_infinity((r, 1, c), device="cpu")
    odd = (torch.arange(c) % 2 == 1).reshape(1, 1, c, 1)
    for i in range(3):
        blank = torch.where(odd, inf[i], torch.zeros_like(inf[i]))
        pts[i] = torch.where(ident, blank, pts[i])
    return tuple(pts)


def _scan_case(name, rng):
    """(R, C, identity mask [R, C], flags [R, C]) of one case."""
    if name == "row0_unflagged":
        r, c = 70, 5
        ident = rng.random((r, c)) < 0.3
        flags = rng.random((r, c)) < 0.1
        flags[0] = False
    elif name == "segment_across_slices":
        r, c = 3 * SLICE + 6, 4
        ident = rng.random((r, c)) < 0.2
        flags = np.zeros((r, c), bool)
        flags[3, 0] = flags[r - 1, 0] = True          # rows 3 .. r-2: 3 slices
        flags[SLICE - 1, 1] = flags[SLICE, 1] = True  # flags at a slice edge
        flags[0, 2] = flags[2 * SLICE + 1, 2] = True  # one segment, slices 0-2
        flags[5, 3] = True                            # to the column's end
    elif name == "all_identity_columns":
        r, c = 70, 4
        ident = np.ones((r, c), bool)
        ident[:, 3] = rng.random(r) < 0.5
        flags = rng.random((r, c)) < 0.1
        flags[0, 1] = True
    elif name == "flag_on_identity":
        r, c = 70, 4
        flags = rng.random((r, c)) < 0.15
        ident = rng.random((r, c)) < 0.2
        ident |= flags & (rng.random((r, c)) < 0.6)
        ident[0] = True
        flags[0, :2] = True
    elif name == "identity_rows_in_run":
        r, c = 70, 4
        flags = np.zeros((r, c), bool)
        flags[[0, 40], 0] = True
        flags[[10, 50], 1] = True
        ident = rng.random((r, c)) < 0.5
        ident[10:14, 1] = True                         # the run starts blank
    elif name == "run_fills_column":
        r, c = 70, 3
        flags = np.zeros((r, c), bool)
        flags[0, 1] = True                             # and one from row 0 on
        ident = rng.random((r, c)) < 0.1
    else:                                              # ragged
        r, c = SLICE + 13, 37
        ident = rng.random((r, c)) < 0.4
        flags = rng.random((r, c)) < 0.08
    return r, c, ident, flags


SCAN_CASES = ["row0_unflagged", "segment_across_slices", "all_identity_columns",
              "flag_on_identity", "identity_rows_in_run", "run_fills_column",
              "ragged"]


def _scan_inputs(pool, case):
    """(stream (x, y, z) [R, 1, C, 16], flags bool [R, 1, C]) of one case."""
    rng = np.random.default_rng(SCAN_CASES.index(case) + 100)
    r, c, ident, flags = _scan_case(case, rng)
    stream = _stream(pool, rng, r, c, ident)
    return stream, torch.from_numpy(flags).reshape(r, 1, c)


def _to_jax(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _pad_rows(t, rows):
    """t [R, ...] with zero rows appended up to `rows`."""
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def _split_lanes(ref, widths):
    """Arrays [..., sum(widths), 16] -> one tuple of torch tensors a case."""
    out, at = [], 0
    for w in widths:
        out.append(tuple(torch.from_numpy(np.asarray(a)[..., at:at + w, :]
                                          .astype(np.int64)) for a in ref))
        at += w
    return out


@pytest.fixture(scope="module")
def scan_reference(pool):
    """zerog_tpu's plain Jacobian flush scan of every case, in one call: the
    cases side by side as columns, padded to REF_ROWS rows. Returns
    {case: pieces [R+1, 1, C, 16] (the final carry last)}."""
    inputs = [_scan_inputs(pool, case) for case in SCAN_CASES]
    assert max(f.shape[0] for _, f in inputs) <= REF_ROWS
    stream = tuple(_to_jax(torch.cat([_pad_rows(s[i], REF_ROWS)
                                      for s, _ in inputs], dim=2))
                   for i in range(3))
    flags = jnp.asarray(torch.cat([_pad_rows(f, REF_ROWS) for _, f in inputs],
                                  dim=2).numpy())
    ref = jpp._flush_scan(stream, flags, affine=False, pallas=False)
    per_case = _split_lanes(ref, [f.shape[2] for _, f in inputs])
    return {case: tuple(torch.cat([a[:f.shape[0]], a[-1:]]) for a in pieces)
            for case, (_, f), pieces in zip(SCAN_CASES, inputs, per_case)}


@pytest.mark.parametrize("case", SCAN_CASES)
def test_flush_scan_jac_host_build_matches_plain(host_lib, pool, scan_reference,
                                                 case):
    stream, flags_t = _scan_inputs(pool, case)
    r, _, c = flags_t.shape
    planes = [pscan.stream_to_planes(t) for t in stream + (flags_t,)]
    pieces = [torch.empty_like(planes[0]) for _ in range(3)]
    carry = [torch.empty((8, c), dtype=torch.int32) for _ in range(3)]
    code = host_lib.zg_flush_scan_jac(
        *(t.data_ptr() for t in planes + pieces + carry), r, c, None)
    assert code == 0
    got = tuple(pscan.pieces_from_planes(torch.cat([p, q[None]], dim=0), 1, c)
                for p, q in zip(pieces, carry))
    ref = pscan.flush_scan_plain(stream, flags_t, affine=False)
    for a, b, j in zip(got, ref, scan_reference[case]):
        assert torch.equal(a, b)
        assert torch.equal(b, j)


def _affine_case(name, rng):
    """(R, C, valid [R, C], flags [R, C]) of one affine-scan case."""
    if name in ("row0_flagged", "row0_unflagged"):
        r, c = 70, 5
        valid = rng.random((r, c)) >= 0.15
        flags = rng.random((r, c)) < 0.1
        flags[0] = name == "row0_flagged"
    elif name == "segment_across_slices":
        r, c = 3 * SLICE + 6, 4
        valid = rng.random((r, c)) >= 0.1
        flags = np.zeros((r, c), bool)
        flags[3, 0] = flags[r - 1, 0] = True          # rows 3 .. r-2: 3 slices
        flags[SLICE - 1, 1] = flags[SLICE, 1] = True  # flags at a slice edge
        flags[0, 2] = flags[2 * SLICE + 1, 2] = True  # one segment, slices 0-2
        flags[5, 3] = True                            # to the column's end
    elif name == "segment_fills_column":
        r, c = 96, 3
        valid = rng.random((r, c)) >= 0.05
        flags = np.zeros((r, c), bool)                # column 0 from the identity
        flags[0, 1:] = True                           # columns 1-2 from row 0
        valid[:5, 2] = False                          # ... which starts blank
    elif name == "flag_on_invalid":
        r, c = 70, 4
        flags = rng.random((r, c)) < 0.15
        valid = rng.random((r, c)) >= 0.2
        valid &= ~(flags & (rng.random((r, c)) < 0.6))
        flags[0, :2] = True
        valid[0, :3] = False
    elif name == "invalid_rows_in_run":
        r, c = 70, 4
        flags = np.zeros((r, c), bool)
        flags[[0, 40], 0] = True
        flags[[10, 50], 1] = True
        valid = rng.random((r, c)) >= 0.5
        valid[10:14, 1] = False                       # the run starts blank
        valid[20:60, 3] = False
    elif name == "ragged":
        r, c = SLICE + 13, 23
        valid = rng.random((r, c)) >= 0.3
        flags = rng.random((r, c)) < 0.08
    elif name == "rows_not_multiple_of_slice":
        r, c = 2 * SLICE + 7, 6
        valid = rng.random((r, c)) >= 0.1
        flags = rng.random((r, c)) < 0.05
        flags[r - 1, 0] = flags[2 * SLICE, 1] = True  # flags in the short slice
    else:                                             # one_row
        r, c = 1, 6
        valid = np.array([[True, False, True, False, True, True]])
        flags = np.array([[True, True, False, False, True, False]])
    return r, c, valid, flags


AFFINE_CASES = ["row0_flagged", "row0_unflagged", "segment_across_slices",
                "segment_fills_column", "flag_on_invalid", "invalid_rows_in_run",
                "ragged", "rows_not_multiple_of_slice", "one_row"]


def _affine_inputs(pool, case):
    """(stream (x, y, valid) [R, 1, C, 16] and [R, 1, C], flags [R, 1, C]) of
    one case. Points come from 6 affine points of the pool, so that a point
    often meets itself: the incomplete add then gives a carry whose z is 0,
    which the next valid row replaces."""
    rng = np.random.default_rng(AFFINE_CASES.index(case) + 200)
    r, c, valid, flags = _affine_case(case, rng)
    idx = torch.from_numpy(rng.integers(0, 6, (r, 1, c)))
    pts = tuple(comp[idx] for comp in pool[:2])       # z = 1: the affine ones
    return (pts + (torch.from_numpy(valid).reshape(r, 1, c),),
            torch.from_numpy(flags).reshape(r, 1, c))


@pytest.fixture(scope="module")
def affine_reference(pool):
    """zerog_tpu's plain affine flush scan of every case, in one call, as
    ``scan_reference`` (padding rows are invalid and unflagged: no-ops)."""
    inputs = [_affine_inputs(pool, case) for case in AFFINE_CASES]
    assert max(f.shape[0] for _, f in inputs) <= REF_ROWS
    stream = tuple(_to_jax(torch.cat([_pad_rows(s[i], REF_ROWS) for s, _ in inputs],
                                     dim=2)) for i in range(2))
    stream += (jnp.asarray(torch.cat([_pad_rows(s[2], REF_ROWS) for s, _ in inputs],
                                     dim=2).numpy()),)
    flags = jnp.asarray(torch.cat([_pad_rows(f, REF_ROWS) for _, f in inputs],
                                  dim=2).numpy())
    ref = jpp._flush_scan(stream, flags, affine=True, pallas=False)
    per_case = _split_lanes(ref, [f.shape[2] for _, f in inputs])
    return {case: tuple(torch.cat([a[:f.shape[0]], a[-1:]]) for a in pieces)
            for case, (_, f), pieces in zip(AFFINE_CASES, inputs, per_case)}


@pytest.mark.parametrize("case", AFFINE_CASES)
def test_flush_scan_affine_host_build_matches_plain(host_lib, pool, affine_reference,
                                                    case):
    stream, flags_t = _affine_inputs(pool, case)
    r, _, c = flags_t.shape
    planes = [pscan.stream_to_planes(t) for t in stream + (flags_t,)]
    pieces = [torch.empty_like(planes[0]) for _ in range(3)]
    carry = [torch.empty((8, c), dtype=torch.int32) for _ in range(3)]
    code = host_lib.zg_flush_scan_affine(
        *(t.data_ptr() for t in planes + pieces + carry), r, c, None)
    assert code == 0
    got = tuple(pscan.pieces_from_planes(torch.cat([p, q[None]], dim=0), 1, c)
                for p, q in zip(pieces, carry))
    ref = pscan.flush_scan_plain(stream, flags_t, affine=True)
    for a, b, j in zip(got, ref, affine_reference[case]):
        assert torch.equal(a, b)
        assert torch.equal(b, j)


def _fold_job(pool, rng, l, c, blank):
    ident = rng.random((l, c)) < blank
    ident[:, 0] = True                                 # an all-identity lane
    ident[: l // 2, 1] = True                          # lane starts blank
    return _stream(pool, rng, l, c, ident)


FOLD_CASES = [
    [(40, 5)],                                 # one job, ragged lanes
    [(16, 33), (40, 9)],                       # the shorter fold given first
    [(1, 2), (17, 6)],                         # a fold of one row
    [(24, 4), (8, 3)],                         # the longer fold given first
]


def _fold_jobs(pool, shapes):
    rng = np.random.default_rng(FOLD_CASES.index(shapes))
    return [_fold_job(pool, rng, l, c, 0.4) for l, c in shapes]


@pytest.fixture(scope="module")
def fold_reference(pool):
    """zerog_tpu's plain fold of every job of every case, in one call: the
    jobs side by side as lanes, padded to the longest. Returns one list of
    results ([1, C, 16] each) a case."""
    jobs = [job for shapes in FOLD_CASES for job in _fold_jobs(pool, shapes)]
    rows = max(job[0].shape[0] for job in jobs)
    xs = tuple(_to_jax(torch.cat([_pad_rows(job[i], rows) for job in jobs],
                                 dim=2)) for i in range(3))
    per_job = iter(_split_lanes(jpp._pipv2_sum_rows(xs),
                                [job[0].shape[2] for job in jobs]))
    return [[next(per_job) for _ in shapes] for shapes in FOLD_CASES]


@pytest.mark.parametrize("shapes", FOLD_CASES)
def test_sum_rows_host_build_matches_plain(host_lib, pool, fold_reference,
                                           shapes):
    jobs = _fold_jobs(pool, shapes)
    planes = [[pfold._rows_to_planes(t) for t in job] for job in jobs]
    outs = [[torch.empty((8, c), dtype=torch.int32) for _ in range(3)]
            for _, c in shapes]
    ptrs = [t.data_ptr() for p, o in zip(planes, outs) for t in p + o]
    n = len(shapes)
    code = host_lib.zg_sum_rows(
        (ctypes.c_void_p * (6 * n))(*ptrs),
        (ctypes.c_long * n)(*(l for l, _ in shapes)),
        (ctypes.c_long * n)(*(c for _, c in shapes)), n, None)
    assert code == 0
    refs = fold_reference[FOLD_CASES.index(shapes)]
    for job, out, (_, c), jref in zip(jobs, outs, shapes, refs):
        ref = pfold.sum_rows_plain(job)
        for o, b, j in zip(out, ref, jref):
            assert torch.equal(kernels.from_word_planes(o).reshape(1, c, 16), b)
            assert torch.equal(b, j)


@pytest.mark.parametrize("kernel", ["field_chain_fr", "field_chain_fq"] + [
    f"scan_bisect_{body}" for body in scan_bisect.BODIES])
def test_bench_kernels_host_build_match_plain(host_lib, kernel):
    """zg_field_chain (k = 16 and k = 3, n not a multiple of a block) and
    every zg_scan_bisect body (ragged columns, flags at 30 %) against the
    plain versions."""
    if kernel.startswith("field_chain"):
        params = FR if kernel.endswith("fr") else FQ
        a, b = field_chain.make_inputs(params, 200)
        for k in (16, 3):
            out = torch.empty_like(a)
            assert host_lib.zg_field_chain(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                           200, int(params is FR), k, None) == 0
            ref = field_chain.field_chain_plain(
                params, kernels.from_word_planes(a), kernels.from_word_planes(b), k)
            assert torch.equal(kernels.from_word_planes(out), ref)
        return
    body = kernel[len("scan_bisect_"):]
    r, c = 40, 37
    sx, sy, _ = scan_bisect.make_inputs(r, c, seed=7)
    flags = torch.from_numpy(
        (np.random.default_rng(8).random((r, c)) < 0.3).astype(np.uint8))
    out = torch.empty_like(sx)
    assert host_lib.zg_scan_bisect(scan_bisect.BODIES.index(body), sx.data_ptr(),
                                   sy.data_ptr(), flags.data_ptr(), out.data_ptr(),
                                   r, c, None) == 0
    ref = scan_bisect.scan_bisect_plain(body, kernels.from_word_planes(sx),
                                        kernels.from_word_planes(sy), flags.bool())
    assert torch.equal(kernels.from_word_planes(out), ref)


TRIVIAL_CASES = {
    "one_row": (1, 5),
    "rows_not_multiple_of_chunk": (45, 7),      # chunks of 32 rows
    "two_tiles": (545, 3),                      # tiles of 16 chunks, 512 rows
    "words_wrap": (64, 4),
}


@pytest.mark.parametrize("case", list(TRIVIAL_CASES))
def test_scan_bisect_trivial_host_build_chunks(host_lib, case):
    """The chunked running word sum of zg_scan_bisect's ``trivial`` body
    against its plain version and ``torch.cumsum``: a lone row, a partial
    chunk, a second tile, words near 2^32 that wrap."""
    r, c = TRIVIAL_CASES[case]
    rng = np.random.default_rng(list(TRIVIAL_CASES).index(case) + 30)
    words = rng.integers(0, 1 << 32, (r, 8, c), dtype=np.uint64)
    if case == "words_wrap":
        words = (1 << 32) - 1 - (words & 0xFF)
    sx = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    flags = torch.zeros((r, c), dtype=torch.uint8)
    out = torch.empty_like(sx)
    assert host_lib.zg_scan_bisect(scan_bisect.BODIES.index("trivial"), sx.data_ptr(),
                                   sx.data_ptr(), flags.data_ptr(), out.data_ptr(),
                                   r, c, None) == 0
    assert torch.equal(out, torch.cumsum(sx, 0, dtype=torch.int32))
    lx = kernels.from_word_planes(sx)
    ref = scan_bisect.scan_bisect_plain("trivial", lx, lx, flags.bool())
    assert torch.equal(kernels.from_word_planes(out), ref)


def _bisect_host(host_lib, body, sx, sy, flags):
    """zg_scan_bisect body `body` of the host build against the plain
    version, limb for limb."""
    r, _, c = sx.shape
    out = torch.empty_like(sx)
    assert host_lib.zg_scan_bisect(scan_bisect.BODIES.index(body), sx.data_ptr(),
                                   sy.data_ptr(), flags.data_ptr(), out.data_ptr(),
                                   r, c, None) == 0
    ref = scan_bisect.scan_bisect_plain(body, kernels.from_word_planes(sx),
                                        kernels.from_word_planes(sy), flags.bool())
    assert torch.equal(kernels.from_word_planes(out), ref)


def _madd_flags(case, rng):
    """Valid bits [R, C] of one madd case; blocks of 32 rows share one word."""
    if case == "no_valid_row_in_a_column":
        f = rng.random((70, 5)) < 0.3
        f[:, 2] = False
    elif case == "every_row_valid":
        f = np.ones((40, 4), bool)
    elif case == "valid_only_at_row_0":
        f = np.zeros((70, 4), bool)
        f[0] = True
    elif case == "valid_only_at_last_row":
        f = np.zeros((70, 4), bool)
        f[69] = True
        f[0, 1] = True                          # and a column with both ends
    elif case == "invalid_run_across_block_edge":
        f = np.zeros((100, 4), bool)
        f[[5, 90], 0] = True                    # two blocks without a valid row
        f[[31, 32], 1] = True                   # the last and first rows of blocks
        f[[30, 70], 2] = True
        f[[63, 64, 95, 99], 3] = True
    else:                                       # ragged: R, C not multiples
        f = rng.random((45, 37)) < 0.1
    return torch.from_numpy(f.astype(np.uint8))


MADD_CASES = ["no_valid_row_in_a_column", "every_row_valid", "valid_only_at_row_0",
              "valid_only_at_last_row", "invalid_run_across_block_edge", "ragged"]


@pytest.mark.parametrize("case", MADD_CASES)
def test_scan_bisect_madd_host_build_skips_invalid_rows(host_lib, case):
    """zg_scan_bisect's ``madd`` walks only the valid rows (taken from the
    bits of each block of 32 rows) and fills the rows between them: no
    valid row in a column, every row valid, valid only at the first or the
    last row, runs of invalid rows across blocks' edges, ragged R and C."""
    rng = np.random.default_rng(MADD_CASES.index(case) + 40)
    flags = _madd_flags(case, rng)
    r, c = flags.shape
    sx, sy, _ = scan_bisect.make_inputs(r, c, seed=MADD_CASES.index(case) + 50)
    _bisect_host(host_lib, "madd", sx, sy, flags)


# (R, C) of each mul_smem case and the chunks K that csrc/bench.cu takes there
MUL_CASES = {
    "rows_not_multiple_of_chunk": (45, 7, 4),     # chunks of 12, 12, 12, 9 rows
    "rows_below_one_chunk": (5, 4, 1),
    "sixteen_chunks_last_short": (200, 9, 16),     # 15 of 13 rows, one of 5
    "empty_last_chunk": (129, 5, 16),              # 14 of 9 rows, one of 3, one empty
    "ragged_columns": (100, 37, 8),                # blocks of 16 columns
}


@pytest.mark.parametrize("case", list(MUL_CASES))
def test_scan_bisect_mul_smem_host_build_chunks(host_lib, case):
    """zg_scan_bisect's ``mul_smem`` as a chunked scan: pass 1 of every
    chunk, the join of the chunk results, pass 2; R not a multiple of the
    chunk or of 32, R below one chunk, the last chunk short or empty,
    ragged C."""
    r, c, k = MUL_CASES[case]
    assert scan_bisect.mul_chunks(r, c) == k
    sx, sy, flags = scan_bisect.make_inputs(r, c, seed=list(MUL_CASES).index(case) + 60)
    _bisect_host(host_lib, "mul_smem", sx, sy, flags)


def test_mul_chunk_plan_mirrors_csrc():
    """The plan of scan_bisect.mul_chunks (its chain floor) uses the
    constants of csrc/bench.cu."""
    with open(os.path.join(kernels.CSRC_DIR, "bench.cu")) as f:
        src = f.read()
    for name in ("MAX_CHUNKS", "MIN_ROWS", "FILL"):
        m = re.search(rf"#define ZG_MUL_{name} (\d+)", src)
        assert m and int(m.group(1)) == getattr(scan_bisect, f"MUL_{name}"), name
    assert [scan_bisect.mul_chunks(1024, c) for c in (2560, 20480, 40)] == [32, 8, 32]
    assert scan_bisect.mul_depth(1024, 2560) == 32 + 5 + 32


# (R, C) of each mul_reg case: K = 8 chunks a column, J = 2 of them a thread
MUL_REG_CASES = {
    "chunk_edges": (256, 9),                 # 8 chunks of exactly 32 rows
    "ragged_last_chunk": (300, 5),           # 7 of 38 rows, one of 34
    "rows_below_k_times_j": (12, 4),         # 6 chunks of 2 rows, 2 empty
    "columns_not_multiple_of_8": (64, 13),   # on the card a warp of 5 columns
    "columns_not_multiple_of_32": (100, 37),  # and 13 rows a chunk, the last 9
    "single_row": (1, 11),                   # chunk 0 alone, 7 empty
}


@pytest.mark.parametrize("case", list(MUL_REG_CASES))
def test_scan_bisect_mul_reg_host_build_chunks(host_lib, case):
    """zg_scan_bisect's ``mul_reg`` in the device's plan, one column at a
    time: pass 1 of the J interleaved chunks of each of the four lane
    groups, each group's prefix, the scan over the groups in the device's
    rounds, pass 2; chunks of exactly L rows, a ragged last chunk, R below
    K x J with empty chunks, C not a multiple of 8 or of 32, a single row."""
    r, c = MUL_REG_CASES[case]
    sx, sy, flags = scan_bisect.make_inputs(r, c,
                                            seed=list(MUL_REG_CASES).index(case) + 70)
    _bisect_host(host_lib, "mul_reg", sx, sy, flags)


def test_mul_reg_plan_mirrors_csrc():
    """The plan of scan_bisect.mul_reg_depth (its chain floor) uses the
    constants of csrc/bench.cu: four lane groups of 8 columns, J = 2 chunks
    a thread, K = 8 a column."""
    with open(os.path.join(kernels.CSRC_DIR, "bench.cu")) as f:
        src = f.read()
    for name in ("GROUPS", "CHAINS"):
        m = re.search(rf"#define ZG_MULREG_{name} (\d+)", src)
        assert m and int(m.group(1)) == getattr(scan_bisect, f"MULREG_{name}"), name
    m = re.search(r"#define ZG_MULREG_SPAN (\d+)", src)
    assert m and int(m.group(1)) * scan_bisect.MULREG_GROUPS == 32
    assert scan_bisect.mul_reg_depth(1024) == 2 * 128 + 1 + 2 + 1
    assert scan_bisect.mul_reg_depth(300) == 2 * 38 + 1 + 2 + 1


# ---- weighted_fold ----------------------------------------------------------------

# (K rows, lanes) of each case; rows ordered k = K-1 .. 0 as the MSM gives them
WEIGHTED_CASES = {
    "one_row": (1, 16),
    "eight_rows": (8, 16),
    "ragged": (13, 5),                  # K and the lanes not multiples of 8
    "identity_runs": (40, 16),
}


def _weighted_inputs(pool, case):
    """Rows [K, C, 1, 16] drawn from the pool, with identity rows at row 0 in
    every lane, a run of them in the middle of some lanes, an all-identity
    lane and ~30 % more at random; and the MSM's bias point [16] limbs."""
    k, c = WEIGHTED_CASES[case]
    rng = np.random.default_rng(list(WEIGHTED_CASES).index(case) + 300)
    ident = rng.random((k, c)) < 0.3
    ident[0] = True
    ident[k // 3:(2 * k) // 3, ::2] = True
    ident[:, 1] = True
    rows = _stream(pool, rng, k, c, ident)
    _, bias = pippenger._pip_bias("cpu")
    return tuple(t.reshape(k, c, 1, 16) for t in rows), bias


@pytest.fixture(scope="module")
def weighted_reference(pool):
    """zerog_tpu's weighted fold of every case, in one call: the cases side by
    side as lanes, padded in front with identity rows (rows of higher k, which
    leave both accumulators as they are) to the longest. Returns {case:
    [C, 1, 16] limbs a coordinate}."""
    inputs = {case: _weighted_inputs(pool, case) for case in WEIGHTED_CASES}
    k_max = max(k for k, _ in WEIGHTED_CASES.values())

    def pad_front(t):
        return torch.cat([t.new_zeros((k_max - t.shape[0],) + t.shape[1:]), t])

    stacked = tuple(_to_jax(torch.cat([pad_front(rows[i]) for rows, _ in inputs.values()],
                                      dim=1)) for i in range(3))
    bias = next(iter(inputs.values()))[1]
    ref = jpp._pipv2_weighted(stacked, tuple(_to_jax(b) for b in bias))
    widths = [c for _, c in WEIGHTED_CASES.values()]
    return dict(zip(WEIGHTED_CASES, _split_lanes(
        tuple(np.asarray(a)[:, 0] for a in ref), widths)))


@pytest.mark.parametrize("case", list(WEIGHTED_CASES))
def test_weighted_fold_host_build_matches_plain(host_lib, pool, weighted_reference,
                                                case):
    """zg_weighted_fold (a lane's two adds of a row in one thread, identity
    operands skipped) against ``weighted_plain``, and that against
    zerog_tpu's ``_pipv2_weighted``, limb for limb."""
    rows, bias = _weighted_inputs(pool, case)
    k, c = WEIGHTED_CASES[case]
    planes = [pfold._rows_to_planes(t) for t in rows] + [
        kernels.to_word_planes(b.expand(c, 16)) for b in bias]
    out = [torch.empty((8, c), dtype=torch.int32) for _ in range(3)]
    assert host_lib.zg_weighted_fold(*(t.data_ptr() for t in planes + out), k, c,
                                     None) == 0
    ref = pfold.weighted_plain(rows, bias)
    for o, b, j in zip(out, ref, weighted_reference[case]):
        assert torch.equal(kernels.from_word_planes(o), b.reshape(c, 16))
        assert torch.equal(b.reshape(c, 16), j)


# ---- ntt_epilogue -------------------------------------------------------------------

def _epilogue_inputs(t, lanes, seed):
    """Raw offset accumulator int32 [32, t, lanes], colsum, rowc and a random
    twiddle (canonical word planes [8, t, lanes]), every corrected column in
    the real range [0, 32 t 255^2], both extremes included."""
    rng = np.random.default_rng(seed)
    top = 32 * t * 255 * 255
    corr = rng.integers(0, top + 1, (32, t, lanes))
    corr[:, 0, 0] = top
    corr[:, 0, 1] = 0
    colsum = rng.integers(-128 * 32 * t, 127 * 32 * t + 1, lanes)
    rowc = rng.integers(-(1 << 26), 1 << 26, 32 * t)
    acc = corr - 128 * colsum[None, None, :] - rowc.reshape(32, t, 1)
    tw = rng.integers(0, 1 << 32, (8, t, lanes), dtype=np.uint64)
    tw[7] &= 0x1FFFFFFF
    return tuple(torch.from_numpy(a.astype(np.int32)) for a in (acc, colsum, rowc)) + (
        torch.from_numpy(tw.astype(np.uint32).view(np.int32)),)


@pytest.mark.parametrize("out_bytes", [True, False], ids=["bytes", "words"])
@pytest.mark.parametrize("with_twiddle", [False, True], ids=["plain", "twiddle"])
def test_ntt_epilogue_host_build_matches_plain(host_lib, with_twiddle, out_bytes):
    """zg_ntt_epilogue, each of its four variants, against ``epilogue_plain``
    at small t and odd lane counts."""
    for t, lanes, seed in ((4, 13, 1), (8, 7, 2)):
        acc, colsum, rowc, tw = _epilogue_inputs(t, lanes, seed)
        tw = tw if with_twiddle else None
        out = torch.empty((32, t, lanes), dtype=torch.int8) if out_bytes else \
            torch.empty((8, t, lanes), dtype=torch.int32)
        assert host_lib.zg_ntt_epilogue(
            acc.data_ptr(), colsum.data_ptr(), rowc.data_ptr(),
            None if tw is None else tw.data_ptr(), out.data_ptr(), t, lanes,
            int(out_bytes), None) == 0
        assert torch.equal(out, pntt.epilogue_plain(acc, colsum, rowc, tw, out_bytes))


# ---- ntt_twiddle ----------------------------------------------------------------------

# (s, r, G): G = 1, 6 (the WNN proof's outer levels) and 200, 384, 600, 800
# (the long lanes of an inner level); s and r not multiples of the tile (40 x
# 30 pairs in tiles of 16 x 24, 20 x 13 and 20 x 14 in 8 x 8, 5 x 3 in 2 x
# 1); tiles of one pair (G = 384, 600: a tile is halved no further); lanes
# split over tiles (G = 800 in two of 400); copies of 1, 4 and 16 bytes.
TWIDDLE_CASES = {"g1": (40, 30, 1), "g6_bytes": (20, 13, 6), "g6_words": (20, 14, 6),
                 "g200": (5, 3, 200), "g384": (3, 5, 384), "g600": (5, 3, 600),
                 "g800_split": (2, 3, 800)}
# Many tiles of the WNN proof's widths: 16 x 8 pairs at G = 6 with a tile of
# 4 rows at the edge of r, and 2 x 1 pairs at G = 384 with one of 1 x 1 at the
# edge of s. Their twiddles are the Montgomery one, so that the reference is
# the regroup and its sums alone (the cases above hold the products).
TWIDDLE_WIDE_CASES = {"g6": (2048, 20, 6), "g384": (33, 17, 384)}


def _twiddle_inputs(s, r, g, seed):
    """Byte planes int8 [32, s, r G] (-128 offset) of canonical Fr elements,
    the first two 0 and p - 1, and a twiddle table of word planes [8, s, r]."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, (8, s, r * g), dtype=np.uint64)
    w[7] &= 0x1FFFFFFF
    edge = kernels.to_word_planes(torch.from_numpy(
        to_limbs([0, FR.p - 1]).astype(np.int64)))
    w[:, 0, :2] = edge.numpy().astype(np.uint32)
    planes = np.stack([(w[b // 4] >> (8 * (b % 4))) & 0xFF for b in range(32)])
    xb = torch.from_numpy((planes.astype(np.int16) - 128).astype(np.int8))
    tw = rng.integers(0, 1 << 32, (8, s, r), dtype=np.uint64)
    tw[7] &= 0x1FFFFFFF
    return xb, torch.from_numpy(tw.astype(np.uint32).view(np.int32))


def _host_twiddle(host_lib, xb, twc, s, r, g):
    out = torch.empty((32, r, s * g), dtype=torch.int8)
    colsum = torch.full((s * g,), 7, dtype=torch.int32)     # the call zeroes it
    assert host_lib.zg_ntt_twiddle(xb.data_ptr(), twc.data_ptr(), out.data_ptr(),
                                   colsum.data_ptr(), s, r, g, None) == 0
    return out, colsum


@pytest.mark.parametrize("case", list(TWIDDLE_CASES))
def test_ntt_twiddle_host_build_matches_plain(host_lib, case):
    """zg_ntt_twiddle (tiles staged, multiplied, stored regrouped, lane sums
    added) against ``twiddle_plain``: the outer level's input bytes and its
    column sums."""
    s, r, g = TWIDDLE_CASES[case]
    xb, twc = _twiddle_inputs(s, r, g, s * r + g)
    out, colsum = _host_twiddle(host_lib, xb, twc, s, r, g)
    ref, ref_sum = pntt.twiddle_plain(xb, twc)
    assert torch.equal(out, ref)
    assert torch.equal(colsum, ref_sum)


@pytest.mark.parametrize("case", list(TWIDDLE_WIDE_CASES))
def test_ntt_twiddle_host_build_wide(host_lib, case):
    """zg_ntt_twiddle over many tiles, against the regroup of its input and
    that regroup's column sums."""
    s, r, g = TWIDDLE_WIDE_CASES[case]
    xb, _ = _twiddle_inputs(s, r, g, s + r)
    one = kernels.to_word_planes(torch.from_numpy(
        to_limbs([FR.r_mont]).astype(np.int64))).reshape(8, 1, 1)
    out, colsum = _host_twiddle(host_lib, xb, one.expand(8, s, r).contiguous(), s, r, g)
    ref = xb.reshape(32, s, r, g).transpose(1, 2).reshape(32, r, s * g)
    assert torch.equal(out, ref)
    assert torch.equal(colsum, ref.reshape(32 * r, s * g).sum(dim=0, dtype=torch.int32))


# ---- field_binop ----------------------------------------------------------------------

@pytest.mark.parametrize("op", ["mul", "add", "sub"])
@pytest.mark.parametrize("params", [FQ, FR], ids=["fq", "fr"])
def test_field_binop_host_build_matches_plain(host_lib, params, op):
    """zg_field_binop (the field and the op as template parameters) against
    ``field_binop_plain`` and Python ints at n = 4, 6, 7 and 130 (word planes
    that start off a 16-byte boundary; a block and a tail), the operands 0, 1
    and p - 1 against each other first."""
    p = params.p
    rng = np.random.default_rng(5)
    edge = [0, 1, p - 1]
    rinv = pow(params.r_mont, -1, p)
    truth = {"mul": lambda x, y: x * y * rinv % p, "add": lambda x, y: (x + y) % p,
             "sub": lambda x, y: (x - y) % p}[op]
    for n in (4, 6, 7, 130):
        xs = [edge[i % 3] for i in range(9)] + [int(v) % p for v in rng.integers(0, 1 << 62, n)]
        ys = [edge[i // 3] for i in range(9)] + [int(v) * 7919 % p
                                                 for v in rng.integers(0, 1 << 62, n)]
        a = torch.from_numpy(to_limbs(xs[:n]).astype(np.int64))
        b = torch.from_numpy(to_limbs(ys[:n]).astype(np.int64))
        wa, wb = kernels.to_word_planes(a), kernels.to_word_planes(b)
        out = torch.empty_like(wa)
        assert host_lib.zg_field_binop(wa.data_ptr(), wb.data_ptr(), out.data_ptr(), n,
                                       0 if params is FQ else 1, ["mul", "add", "sub"].index(op),
                                       None) == 0
        got = kernels.from_word_planes(out)
        assert torch.equal(got, field_binop_plain(op, params, a, b))
        assert list(from_limbs(got)) == [truth(x, y) for x, y in zip(xs[:n], ys[:n])]
