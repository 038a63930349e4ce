"""The port's MSM and SRS (zerog_tpu_torch.curve) against host ground truth
and against zerog_tpu.curve.

Scalars and points come from seeded generators; the JAX side runs its plain
XLA engine (no Pallas on the CPU) and the port its plain versions. Group and
field arithmetic are exact, so affine results are compared for equality and
the pipeline's Jacobian accumulators limb for limb — tolerance zero.
"""

import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zerog_tpu.curve import Srs as JSrs
from zerog_tpu.curve import pippenger as jpp
from zerog_tpu.curve.bn254 import g1_msm_host as j_g1_msm_host
from zerog_tpu.field import to_limbs as j_to_limbs

from zerog_tpu_torch import convert
from zerog_tpu_torch.curve import Srs, msm, points_to_device
from zerog_tpu_torch.curve import pippenger as tpp
from zerog_tpu_torch.curve.bn254 import G1_GEN, g1_mul
from zerog_tpu_torch.curve.jpoints import jac_from_affine, points_from_device
from zerog_tpu_torch.field import FR, to_device, to_numpy

torch.set_num_threads(1)

SLOW = pytest.mark.skipif(not os.environ.get("ZEROG_SLOW_TESTS"),
                          reason="compile-bound on XLA:CPU; set ZEROG_SLOW_TESTS=1")

N = 64
C = 5


def ground(scalars, points):
    """The MSM by zerog_tpu's host point sums (plain Python ints)."""
    return j_g1_msm_host(scalars, points)


@pytest.fixture(scope="module")
def points():
    # random-looking multiples: the incomplete-add contract forbids
    # structured sets like (i+1)*G
    rnd = random.Random(1234)
    scalars = [rnd.getrandbits(62) | 1 for _ in range(N)]
    pts = tpp.fixed_base_expand(G1_GEN, scalars, device="cpu")
    assert pts[:4] == [g1_mul(G1_GEN, s) for s in scalars[:4]]
    return pts


@pytest.fixture(scope="module")
def table(points):
    return tpp.build_window_table(points_to_device(points, device="cpu"),
                                  c=C, device="cpu")


@pytest.fixture(scope="module")
def jax_table(table):
    """The same table as JAX arrays (carried over as numpy)."""
    return jpp.WindowTable(table.c, table.n, jnp.asarray(to_numpy(table.tx)),
                           jnp.asarray(to_numpy(table.ty)),
                           jnp.asarray(table.tvalid.numpy()))


def test_table_layout(points, table):
    """Entry j*N + i must be 2^{offset_j} * P_i (affine Montgomery)."""
    sizes, offsets = tpp._window_layout(C)
    aff = points_from_device(jac_from_affine(table.tx, table.ty, table.tvalid))
    assert table.tx.shape[0] == len(sizes) * N
    for j in (0, 1, len(sizes) - 1):
        for i in (0, N // 2, N - 1):
            assert aff[j * N + i] == g1_mul(points[i], 1 << offsets[j])


def test_window_table_from_numpy_roundtrip(table):
    t2 = convert.window_table_from_numpy(
        table.c, table.n, to_numpy(table.tx), to_numpy(table.ty),
        table.tvalid.numpy(), device="cpu")
    assert t2.c == table.c and t2.n == table.n
    assert torch.equal(t2.tx, table.tx) and torch.equal(t2.ty, table.ty)
    assert torch.equal(t2.tvalid, table.tvalid)


CASES = {
    "random": lambda rnd: [[rnd.randrange(FR.p) for _ in range(N)]
                           for _ in range(3)],
    "skewed": lambda rnd: [[(1 if i % 3 else 0) for i in range(N)], [7] * N],
    "edge": lambda rnd: [[0] * N, [1] + [0] * (N - 1)],
    # 50-bit scalars: digit runs stay under the scan depth, no compaction
    "small": lambda rnd: [[rnd.getrandbits(50) for _ in range(N)]
                          for _ in range(2)],
}


@pytest.mark.parametrize("case", list(CASES))
def test_msm_fixed_matches_ground_truth(points, table, case):
    """Random rows (whose merged digit runs exceed the scan depth and force
    the piece compaction round), witness-like rows, edge rows and short
    scalars through the merged-window table."""
    rows = CASES[case](random.Random(7))
    got = msm(rows, table=table, device="cpu")
    assert got == [ground(r, points) for r in rows]
    if case == "edge":
        assert got[0] is None and got[1] == points[0]


def test_msm_per_window_matches_ground_truth(points):
    rnd = random.Random(8)
    rows = [[rnd.randrange(FR.p) for _ in range(N)] for _ in range(2)]
    pdev = points_to_device(points, device="cpu")
    assert msm(rows, pdev, device="cpu") == [ground(r, points) for r in rows]
    assert msm(rows[0], pdev, device="cpu") == ground(rows[0], points)


@pytest.mark.parametrize("case", ["small", "random"])
def test_pipeline_accumulators_match_reference(table, jax_table, case):
    """The [G, 2, 16] weighted accumulators out of the bucket pipeline equal
    the JAX package's limb for limb (same sort order, same add order), with
    and without the compaction round."""
    rows = CASES[case](random.Random(9))[:2]
    sl = j_to_limbs(np.asarray(rows, dtype=object))
    m = int(table.tx.shape[0])
    r_rows = tpp._pip_r_rows(m)
    assert r_rows == jpp._pip_r_rows(m)
    prep_t = tpp._pipfb_prep(to_device(sl, "cpu"), table.tx, table.ty,
                             table.tvalid, c=C, r_rows=r_rows)
    prep_j = jpp._pipfb_prep(jnp.asarray(sl), jax_table.tx, jax_table.ty,
                             jax_table.tvalid, c=C, r_rows=r_rows)
    assert int(prep_t[-1]) == int(prep_j[-1])
    for a, b in zip(prep_j[:-1], prep_t[:-1]):
        assert np.array_equal(np.asarray(a).astype(np.int64),
                              b.numpy().astype(np.int64))
    compact = int(prep_t[-1]) > r_rows
    assert compact == (case == "random")   # full-width digits: runs > R
    acc_t = tpp._pipeline_device(prep_t[:-1], r_rows, C, compact)
    acc_j = jpp._pipeline_device(prep_j[:-1], r_rows, C, False, compact)
    for a, b in zip(acc_j, acc_t):
        assert np.array_equal(np.asarray(a).astype(np.uint32), to_numpy(b))


# The strategies at N = 32 points and B = 2 rows; "msm_device" is the scan
# strategy's Jacobian window sums, at N = 16 and B = 1 (each of the W = 64
# windows of c = 4 is one lane row, so this keeps it to ~2 s).
STRATEGY_CASES = ["scan", "danaa", "segscan", "msm_device"]
STRATEGY_N = 32


@pytest.fixture(scope="module")
def strategy_inputs(points, table):
    pts = points[:STRATEGY_N]
    pdev = points_to_device(pts, device="cpu")
    # the table of the first STRATEGY_N points: the same rows of each window
    w = int(table.tx.shape[0]) // N
    table = tpp.WindowTable(C, STRATEGY_N, *(
        a.reshape((w, N) + tuple(a.shape[1:]))[:, :STRATEGY_N].reshape(
            (w * STRATEGY_N,) + tuple(a.shape[1:]))
        for a in (table.tx, table.ty, table.tvalid)))
    rnd = random.Random(13)
    rows = [[rnd.randrange(FR.p) for _ in range(STRATEGY_N)] for _ in range(2)]
    return pts, pdev, table, rows


def _port_strategy(case, pdev, table, rows):
    """The port's result of `case`: B affine points, or for msm_device the
    Jacobian window sums of row 0 over the first 16 points."""
    if case == "msm_device":
        sl = to_device(j_to_limbs(np.asarray(rows[:1], dtype=object)[:, :16]),
                       "cpu")
        return tpp.msm_device(sl, pdev[0][:16], pdev[1][:16], pdev[2][:16],
                              c=tpp.default_window(16))
    return msm(rows, pdev, strategy=case, device="cpu",
               table=table if case == "segscan" else None)


@pytest.mark.parametrize("case", STRATEGY_CASES)
def test_msm_strategies_match_ground_truth(strategy_inputs, case):
    """scan, danaa (complete adds) and segscan (log-depth scan over the
    merged-window table) give the MSM; msm_device's window sums are the
    MSMs of each window's digits. zerog_tpu's host point sums are the
    ground truth: its XLA:CPU compiles of these strategies take 39-69 s, so
    the comparison with its msm runs with ZEROG_SLOW_TESTS=1 (below)."""
    pts, pdev, table, rows = strategy_inputs
    got = _port_strategy(case, pdev, table, rows)
    if case != "msm_device":
        assert got == [ground(r, pts) for r in rows]
        return
    c = tpp.default_window(16)
    w = got[0].shape[1]
    assert got[0].shape == (1, w, 16) and w == -(-254 // c)
    sums = points_from_device(tuple(comp.reshape(w, 16) for comp in got))
    for j in (0, 1, w // 2, w - 1):
        digits = [(s >> (c * j)) % (1 << c) for s in rows[0][:16]]
        assert sums[j] == ground(digits, pts[:16])


@SLOW
@pytest.mark.parametrize("case", STRATEGY_CASES)
def test_msm_strategies_equal_reference(strategy_inputs, case):
    """The same calls against zerog_tpu's msm with the same strategy (affine
    points), and msm_device's Jacobian sums limb for limb."""
    _, pdev, table, rows = strategy_inputs
    jdev = tuple(jnp.asarray(to_numpy(a)) if a.dtype != torch.bool
                 else jnp.asarray(a.numpy()) for a in pdev)
    got = _port_strategy(case, pdev, table, rows)
    if case == "msm_device":
        sl = jnp.asarray(j_to_limbs(np.asarray(rows[:1], dtype=object)[:, :16]))
        want = jpp.msm_device(sl, jdev[0][:16], jdev[1][:16], jdev[2][:16],
                              c=jpp.default_window(16))
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), to_numpy(b))
    elif case == "segscan":
        jtable = jpp.WindowTable(table.c, table.n, jnp.asarray(to_numpy(table.tx)),
                                 jnp.asarray(to_numpy(table.ty)),
                                 jnp.asarray(table.tvalid.numpy()))
        with jpp.msm_strategy("segscan"):
            assert got == jpp.msm(rows, table=jtable)
    else:
        assert got == jpp.msm(rows, jdev, strategy=case)


def test_unknown_strategy_raises(points):
    pdev = points_to_device(points, device="cpu")
    with pytest.raises(ValueError, match="unknown MSM strategy"):
        msm([[1] * N], pdev, strategy="flush", device="cpu")
    with pytest.raises(ValueError, match="requires a WindowTable"):
        msm([[1] * N], pdev, strategy="segscan", device="cpu")


def test_default_windows():
    assert tpp.default_fixed_window(1 << 14) == 13
    assert tpp.default_fixed_window(1 << 17) == 16
    assert 4 <= tpp.default_fixed_window(64) <= 6
    for n in (64, 1 << 14, 1 << 17):
        assert tpp.default_window(n) == jpp.default_window(n)
        assert tpp.default_fixed_window(n) == jpp.default_fixed_window(n)
    assert tpp._window_layout(13) == jpp._window_layout(13)
    assert tpp._pip_r_rows(20 << 14) == 1024


@pytest.fixture(scope="module")
def srs_pair():
    return JSrs.setup(4, seed=b"torch-port"), Srs.setup(4, seed=b"torch-port",
                                                       device="cpu")


def test_srs_setup_equals_reference(srs_pair):
    jsrs, srs = srs_pair
    assert srs.g == jsrs.g and srs.g_lagrange == jsrs.g_lagrange
    assert srs.g2 == jsrs.g2 and srs.s_g2 == jsrs.s_g2
    assert srs.MAX_BATCH == jsrs.MAX_BATCH and srs.FIXED_MIN_N == jsrs.FIXED_MIN_N


def test_srs_commit_equals_reference(srs_pair):
    jsrs, srs = srs_pair
    rnd = random.Random(10)
    rows = [[rnd.randrange(FR.p) for _ in range(srs.n)] for _ in range(2)]
    lag = srs.commit_lagrange(rows)
    assert lag == jsrs.commit_lagrange(rows)
    import hashlib

    tau = int.from_bytes(hashlib.blake2b(b"torch-port", digest_size=32).digest(),
                         "little") % FR.p
    short = rows[0][:5]
    assert srs.commit(short) == g1_mul(
        G1_GEN, sum(c * pow(tau, i, FR.p) for i, c in enumerate(short)) % FR.p)
    from zerog_tpu_torch.field import to_limbs

    stack = to_device(to_limbs(rows, FR, mont=True), "cpu")
    assert srs.commit_dev(stack) == srs.commit(rows)
    assert srs.commit_lagrange_dev(stack[0]) == lag[0]


def test_srs_commit_via_table(srs_pair, monkeypatch):
    """With the threshold lowered, commitments route through the merged
    table and equal the per-window path."""
    _, srs = srs_pair
    rnd = random.Random(11)
    rows = [[rnd.randrange(FR.p) for _ in range(srs.n)] for _ in range(2)]
    baseline = srs.commit_lagrange(rows)
    monkeypatch.setattr(Srs, "FIXED_MIN_N", 1)
    srs2 = convert.srs_from_reference(srs.k, srs.g, srs.g_lagrange, srs.g2,
                                      srs.s_g2, device="cpu")
    assert srs2.window_table("lagrange") is not None
    assert srs2.commit_lagrange(rows) == baseline


@pytest.mark.parametrize("fmt", ["native", "halo2"])
def test_srs_file_crosses_packages(srs_pair, tmp_path, fmt):
    """A file written by one package is read by the other, both formats."""
    jsrs, srs = srs_pair
    path = tmp_path / f"jax_{fmt}.srs"
    jsrs.write(path, fmt=fmt)
    back = Srs.read(path, device="cpu")
    assert (back.k, back.g, back.g_lagrange, back.g2, back.s_g2) == (
        srs.k, srs.g, srs.g_lagrange, srs.g2, srs.s_g2)
    path2 = tmp_path / f"torch_{fmt}.srs"
    srs.write(path2, fmt=fmt)
    assert path2.read_bytes() == path.read_bytes()
    jback = JSrs.read(path2)
    assert jback.g == jsrs.g and jback.s_g2 == jsrs.s_g2
