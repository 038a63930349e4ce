"""The port's mesh (zerog_tpu_torch.parallel) on CPU meshes, against
zerog_tpu.parallel, zerog_tpu's host point sums and the port's
single-device path.

A CPU mesh is ``["cpu"] * D``: D entries in one process, the counterpart of
the JAX package's virtual host devices. Everything is exact integer
arithmetic, tolerance zero: NTT outputs and Jacobian limbs compared for
equality, commitments as affine points. zerog_tpu's sharded MSM is
compile-bound on XLA:CPU (36 s cold at its smallest shape), so its
limb-for-limb comparison runs with ZEROG_SLOW_TESTS=1; tier-1 holds the
port's window sums against zerog_tpu.curve.bn254's host sums.
"""

import os
import random

import numpy as np
import pytest
import torch

from zerog_tpu.curve.bn254 import G1_GEN, g1_msm_host, g1_mul

from zerog_tpu_torch.curve import Srs, pippenger as tpp
from zerog_tpu_torch.curve.jpoints import points_from_device, points_to_device
from zerog_tpu_torch.field import FR, from_limbs, to_device, to_limbs, to_numpy
from zerog_tpu_torch.parallel import (
    FourStepNtt, make_mesh, sharded_msm_device,
)
from zerog_tpu_torch.parallel.mesh import all_to_all, halo_rows, shard_axis
from zerog_tpu_torch.parallel.sharded_msm import (
    ShardedWindowTable, _entry_preps, _run_pipelines,
)
from zerog_tpu_torch.parallel.sharded_prover import ShardedSrs

torch.set_num_threads(1)

SLOW = pytest.mark.skipif(not os.environ.get("ZEROG_SLOW_TESTS"),
                          reason="compile-bound on XLA:CPU; set ZEROG_SLOW_TESTS=1")

LOG_N = 4
INVERSE = {"forward": None, "inverse": FR.inv(FR.nth_root_of_unity(LOG_N))}


def cpu_mesh(d):
    return make_mesh(d, ["cpu"] * d)


def test_make_mesh_and_collectives():
    mesh = make_mesh(3, ["cpu"] * 8)
    assert len(mesh) == 3 and all(d == torch.device("cpu") for d in mesh)
    with pytest.raises(ValueError):
        make_mesh(9, ["cpu"] * 8)
    # all_to_all is the distributed transpose: entry e gets chunk e of every
    # entry's split axis
    x = torch.arange(4 * 8 * 2).reshape(4, 8, 2)
    parts = shard_axis(cpu_mesh(4), x, axis=0)              # [1, 8, 2] each
    out = all_to_all(cpu_mesh(4), parts, split_axis=1, concat_axis=0)
    for e, o in enumerate(out):
        assert torch.equal(o, x[:, 2 * e:2 * e + 2])
    # halo_rows: each entry's block of torch.roll(full, -shift) along rows,
    # for shifts inside a block, past one, and negative
    full = torch.arange(5 * 24 * 3).reshape(5, 24, 3)
    blocks = shard_axis(cpu_mesh(4), full, axis=-2)
    for shift in (0, 1, 5, 6, 7, 13, -1, -7, 30):
        want = torch.roll(full, -shift, dims=-2)
        got = torch.cat([halo_rows(blocks, e, shift) for e in range(4)], dim=-2)
        assert torch.equal(got, want), shift


def _dft(vals, omega):
    n = len(vals)
    return [sum(v * pow(omega, i * k, FR.p) for i, v in enumerate(vals)) % FR.p
            for k in range(n)]


@pytest.mark.parametrize("direction", list(INVERSE))
def test_four_step_ntt_matches_dft(direction):
    """FourStepNtt on 4 CPU entries at log_n = 4, log_n1 = 2 (n1 = n2 = 4,
    the mesh size): the natural-order transform, forward and the unscaled
    inverse, against the Python-int DFT and the single-device NttPlan."""
    from zerog_tpu_torch.poly.ntt import NttPlan

    omega = INVERSE[direction]
    fs = FourStepNtt(LOG_N, log_n1=2, omega=omega)
    vals = [i * 7 + 3 for i in range(1 << LOG_N)]
    vl = to_device(to_limbs(vals, FR, mont=True), "cpu")
    out = fs.ntt_sharded(cpu_mesh(4), vl)
    got = [int(v) for v in from_limbs(to_numpy(out), FR, mont=True)]
    assert got == _dft(vals, fs.omega)
    assert torch.equal(out, NttPlan(LOG_N, fs.omega, device="cpu").ntt(vl))
    # a batch axis goes through unchanged
    two = fs.ntt_sharded(cpu_mesh(4), torch.stack([vl, vl]))
    assert torch.equal(two[1], out)


@pytest.mark.parametrize("direction", list(INVERSE))
def test_four_step_ntt_equals_reference(direction):
    """The same transform through zerog_tpu's FourStepNtt on its 4-device
    CPU mesh: equal limb for limb (~10 s a direction, its XLA:CPU
    compile)."""
    import jax.numpy as jnp
    from zerog_tpu.parallel import FourStepNtt as JFourStepNtt
    from zerog_tpu.parallel import make_mesh as j_make_mesh

    omega = INVERSE[direction]
    vals = [i * 7 + 3 for i in range(1 << LOG_N)]
    limbs = to_limbs(vals, FR, mont=True)
    want = JFourStepNtt(LOG_N, log_n1=2, omega=omega).ntt_sharded(
        j_make_mesh(4), jnp.asarray(limbs))
    got = FourStepNtt(LOG_N, log_n1=2, omega=omega).ntt_sharded(
        cpu_mesh(4), to_device(limbs, "cpu"))
    assert np.array_equal(np.asarray(want), to_numpy(got))


@pytest.fixture(scope="module")
def msm_case():
    """32 random-looking points and one row of 62-bit scalars, as
    tests/test_parallel.py."""
    rng = np.random.default_rng(7)
    pts = [g1_mul(G1_GEN, int(rng.integers(1, 1 << 60))) for _ in range(32)]
    scalars = [int(rng.integers(0, 1 << 62)) for _ in range(32)]
    sl = to_device(to_limbs(np.asarray([scalars], dtype=object)), "cpu")
    return pts, scalars, sl


def test_sharded_msm_device_matches_host(msm_case):
    """sharded_msm_device on 4 CPU entries, scalar_bits = 64: each window
    sum is the MSM of that window's digits, and folded on the host they are
    the MSM. Tier-1 runs c = 4 (16 buckets); c = 8 costs ~25 s in the plain
    point ops (its two suffix scans over 255 buckets) and runs against
    zerog_tpu below."""
    pts, scalars, sl = msm_case
    px, py, pv = points_to_device(pts, device="cpu")
    sums = sharded_msm_device(cpu_mesh(4), sl, px, py, pv, c=4, scalar_bits=64)
    w = sums[0].shape[1]
    assert w == 16 and sums[0].shape == (1, 16, 16)
    affine = points_from_device(tuple(comp.reshape(w, 16) for comp in sums))
    for j in (0, 7, 15):
        digit = [(s >> (4 * j)) & 0xF for s in scalars]
        assert affine[j] == g1_msm_host(digit, pts)
    assert tpp._fold_windows_host(affine, 4) == g1_msm_host(scalars, pts)


@SLOW
def test_sharded_msm_device_equals_reference(msm_case):
    import jax.numpy as jnp
    from zerog_tpu.curve import points_to_device as j_points_to_device
    from zerog_tpu.parallel import make_mesh as j_make_mesh
    from zerog_tpu.parallel import sharded_msm_device as j_sharded_msm_device

    pts, _, sl = msm_case
    jx, jy, jv = j_points_to_device(pts)
    want = j_sharded_msm_device(j_make_mesh(4), jnp.asarray(to_numpy(sl)),
                                jnp.asarray(jx), jnp.asarray(jy), jnp.asarray(jv),
                                c=8, scalar_bits=64)
    px, py, pv = points_to_device(pts, device="cpu")
    got = sharded_msm_device(cpu_mesh(4), sl, px, py, pv, c=8, scalar_bits=64)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), to_numpy(b))


TAU = 0x5EED_70C4_3E54  # the k = 6 SRS's secret, so its commitments are known


@pytest.fixture(scope="module")
def srs6():
    """A k = 6 SRS, two rows of scalars, and what they commit to: the
    polynomial they define taken at tau, times G by zerog_tpu's host
    multiplication. Its window tables are built once, on the first
    ShardedSrs, and shared by every mesh below."""
    srs = Srs.setup(6, tau=TAU, device="cpu")
    n, p = srs.n, FR.p
    omega = FR.nth_root_of_unity(6)
    # L_i(tau) = w^i (tau^n - 1) / (n (tau - w^i))
    lag = [pow(omega, i, p) * (pow(TAU, n, p) - 1) * pow(n * (TAU - pow(omega, i, p)), -1, p) % p
           for i in range(n)]
    rnd = random.Random(12)
    rows = [[rnd.randrange(p) for _ in range(n)] for _ in range(2)]
    lagrange = [g1_mul(G1_GEN, sum(v * l for v, l in zip(r, lag)) % p) for r in rows]
    monomial = g1_mul(G1_GEN, sum(v * pow(TAU, i, p) for i, v in enumerate(rows[0])) % p)
    return srs, rows, lagrange, monomial


@pytest.mark.parametrize("d", [8, 3])
def test_sharded_srs_commits_equal_single_device(srs6, d):
    """ShardedSrs at k = 6: commit_lagrange and commit_dev give the points
    the Srs commits to. D = 8 divides the 64 points; D = 3 takes the padding
    path (two zero points make 66)."""
    srs, rows, lagrange, monomial = srs6
    ssrs = ShardedSrs(srs, cpu_mesh(d))
    assert ssrs._pad == (0 if d == 8 else 2) and ssrs.MAX_BATCH == 2
    assert ssrs.commit_lagrange(rows) == lagrange
    stack = to_device(to_limbs(rows, FR, mont=True), "cpu")
    assert ssrs.commit_dev(stack[0]) == monomial
    with pytest.raises(ValueError, match="first entry"):
        ShardedSrs(srs, make_mesh(2, [torch.device("meta")] + ["cpu"]))


def test_padded_table_equals_build_over_padded_points(srs6):
    """The D = 3 table (the Srs's, widened by two zero points) is the table
    that the build over the padded points gives."""
    import torch.nn.functional as F
    from zerog_tpu_torch.parallel.sharded_prover import _padded_table

    srs = srs6[0]
    table = srs.window_table("monomial", min_n=0)
    got = _padded_table(table, 2)
    px, py, pv = srs._pdev("monomial")
    px, py = (F.pad(a, (0, 0, 0, 2)) for a in (px, py))
    want = tpp.build_window_table((px, py, F.pad(pv, (0, 2))), table.c,
                                  device="cpu")
    assert got.n == want.n == 66
    for name in ("tx", "ty", "tvalid"):
        assert torch.equal(getattr(got, name), getattr(want, name))


def test_entry_pipelines_equal_merged_pipeline(srs6):
    """The per-entry pipelines (what CUDA entries run, each launching its
    own kernels) give the accumulators of the one merged pipeline that a
    mesh of CPU entries runs, limb for limb, in the same (entry, batch)
    order: D = 2 over the table of two SRS points, two rows."""
    srs, rows = srs6[:2]
    full = srs.window_table("lagrange", min_n=0)
    w = int(full.tx.shape[0]) // full.n
    two = tpp.WindowTable(full.c, 2, *(
        a.reshape((w, full.n) + tuple(a.shape[1:]))[:, :2].reshape(
            (2 * w,) + tuple(a.shape[1:])) for a in (full.tx, full.ty, full.tvalid)))
    mesh = cpu_mesh(2)
    stable = ShardedWindowTable(mesh, two)
    sl = to_device(to_limbs(np.asarray([r[:2] for r in rows], dtype=object)), "cpu")
    preps, r_rows = _entry_preps(mesh, sl, stable)
    merged = _run_pipelines(preps, r_rows, stable.c, "cpu", merge=True)
    apart = _run_pipelines(preps, r_rows, stable.c, "cpu", merge=False)
    for a, b in zip(merged, apart):
        assert a.shape == (4, 2, 16) and torch.equal(a, b)
