"""The port's curve layer (jpoints, flush scan, bucket folds) against
zerog_tpu.curve, limb for limb.

Inputs come from a seeded generator and go through the JAX functions — the
plain XLA paths, as the JAX package's own tests use on the CPU — and through
the port's plain versions on the CPU. Exact integer arithmetic: tolerance
zero everywhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zerog_tpu.curve import jpoints as J
from zerog_tpu.curve import pippenger as jpp

from zerog_tpu_torch.curve import jpoints as T
from zerog_tpu_torch.curve import pfold, pscan
from zerog_tpu_torch.curve.bn254 import G1_GEN, g1_add, g1_double, g1_mul
from zerog_tpu_torch.field import to_device, to_numpy

torch.set_num_threads(1)


def _same(jax_pt, torch_pt):
    for a, b in zip(jax_pt, torch_pt):
        assert np.array_equal(np.asarray(a).astype(np.uint32), to_numpy(b))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return [g1_mul(G1_GEN, int(s)) for s in rng.integers(1, 1 << 30, n)]


@pytest.fixture(scope="module")
def lanes():
    """12 lanes: p and q as Jacobian points in both packages, with an
    invalid lane, an equal pair (doubling lane) and a shared infinity."""
    pts = _points(12, 0)
    pts[3] = None
    x, y, v = J.points_to_device(pts)
    tx, ty, tv = T.points_to_device(pts, device="cpu")
    assert np.array_equal(np.asarray(x), to_numpy(tx))
    assert np.array_equal(np.asarray(y), to_numpy(ty))
    assert np.array_equal(v, tv.numpy())
    pj = J.jac_from_affine(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v))
    pt = T.jac_from_affine(tx, ty, tv)
    perm = [11, 0, 1, 3, 2, 5, 4, 6, 7, 9, 8, 10]   # lane 5 equal, lane 3 inf
    qj = tuple(c[np.asarray(perm)] for c in pj)
    qt = tuple(c[torch.as_tensor(perm)] for c in pt)
    return pts, perm, pj, pt, qj, qt


def test_from_affine_and_infinity(lanes):
    _, _, pj, pt, _, _ = lanes
    _same(pj, pt)
    _same(J.jac_infinity((2, 3)), T.jac_infinity((2, 3), device="cpu"))
    inf = T.jac_infinity((1,), device="cpu")
    assert T.points_from_device(inf) == [None]


def test_jac_add_matches_reference_and_host(lanes):
    pts, perm, pj, pt, qj, qt = lanes
    got = T.jac_add(pt, qt)
    _same(J.jac_add(pj, qj), got)
    assert T.points_from_device(got) == [
        g1_add(pts[i], pts[perm[i]]) for i in range(12)]


def test_jac_add_incomplete_matches_reference(lanes):
    _, _, pj, pt, qj, qt = lanes
    _same(J.jac_add_incomplete(pj, qj), T.jac_add_incomplete(pt, qt))


def test_jac_double_matches_reference_and_host(lanes):
    pts, _, pj, pt, _, _ = lanes
    got = T.jac_double(pt)
    _same(J.jac_double(pj), got)
    assert T.points_from_device(got) == [g1_double(p) for p in pts]


def test_jac_madd_incomplete_matches_reference(lanes):
    _, perm, pj, pt, qj, qt = lanes
    dj, dt = J.jac_double(pj), T.jac_double(pt)
    vj = np.asarray([i != 3 and i != 7 for i in perm])
    _same(J.jac_madd_incomplete(dj, qj[0], qj[1], jnp.asarray(vj)),
          T.jac_madd_incomplete(dt, qt[0], qt[1], torch.from_numpy(vj)))


def test_jac_select_matches_reference(lanes):
    _, _, pj, pt, qj, qt = lanes
    cond = np.arange(12) % 2 == 0
    _same(J.jac_select(jnp.asarray(cond), pj, qj),
          T.jac_select(torch.from_numpy(cond), pt, qt))


def _toy_stream(r=64, g=2, c=8, seed=3):
    """Random affine stream with flags mimicking sorted digit runs (the toy
    stream of the JAX package's flush-scan parity test)."""
    rng = np.random.default_rng(seed)
    n = r * g * c
    pts = [g1_mul(G1_GEN, int(s)) for s in rng.integers(1, 1 << 30, n)]
    px, py, pv = J.points_to_device(pts)
    sx = np.asarray(px).reshape(r, g, c, 16)
    sy = np.asarray(py).reshape(r, g, c, 16)
    sv = np.asarray(pv).reshape(r, g, c).copy()
    sv[5, :, 2] = False
    flags = rng.random((r, g, c)) < 0.1
    flags[0] = True
    return (sx, sy, sv), flags


@pytest.fixture(scope="module")
def affine_scan():
    (sx, sy, sv), flags = _toy_stream()
    ref = jpp._flush_scan(
        (jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(sv)),
        jnp.asarray(flags), affine=True, pallas=False)
    got = pscan.flush_scan(
        (to_device(sx, "cpu"), to_device(sy, "cpu"), torch.from_numpy(sv)),
        torch.from_numpy(flags), affine=True)
    return ref, got


def test_flush_scan_affine_plain_matches_reference(affine_scan):
    ref, got = affine_scan
    assert got[0].shape == (65, 2, 8, 16)
    _same(ref, got)
    assert pscan.flush_scan_affine_words.launches == 0


def test_flush_scan_jac_plain_matches_reference(affine_scan):
    """Jacobian stream: the affine scan's pieces (zero rows are infinity)."""
    ref, got = affine_scan
    rng = np.random.default_rng(9)
    flags = rng.random((64, 2, 8)) < 0.15
    flags[0] = True
    ref2 = jpp._flush_scan(tuple(c[:64] for c in ref), jnp.asarray(flags),
                           affine=False, pallas=False)
    got2 = pscan.flush_scan(tuple(c[:64] for c in got),
                            torch.from_numpy(flags), affine=False)
    _same(ref2, got2)


def test_sum_rows_plain_matches_reference(affine_scan):
    ref, got = affine_scan
    xs_j = tuple(c[1:25] for c in ref)           # [24, 2, 8, 16]
    xs_t = tuple(c[1:25] for c in got)
    _same(jpp._pipv2_sum_rows(xs_j), pfold.sum_rows(xs_t))
    assert pfold.sum_rows_words.launches == 0


def test_weighted_plain_matches_reference(affine_scan):
    """K = 12 rows: not a multiple of 8, which the port takes as it is."""
    ref, got = affine_scan
    st_j = tuple(c[1:13, :, :2] for c in ref)    # [12, 2, 2, 16]
    st_t = tuple(c[1:13, :, :2] for c in got)
    _, bias_j = jpp._pip_bias()
    from zerog_tpu_torch.curve.pippenger import _pip_bias

    pt, bias_t = _pip_bias("cpu")
    _same(bias_j, bias_t)
    out = pfold.weighted(st_t, bias_t)
    _same(jpp._pipv2_weighted(st_j, bias_j), out)
    assert pfold.weighted_fold_words.launches == 0
