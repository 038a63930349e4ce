"""Vectorized G1 point arithmetic on tensors (Jacobian coordinates over Fq
limbs).

Counterpart of ``zerog_tpu/curve/jpoints.py``. A batch of points is a tuple
``(X, Y, Z)`` of ``int64[..., 16]`` Montgomery limb tensors; the identity is
encoded as Z == 0. The unified `add` computes both the general sum and the
doubling and selects per lane — branch-free, so it vectorizes.

Formulas: standard a=0 Jacobian add/double (~23 field muls per unified add).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import jfq, to_limbs, from_limbs, to_device, FQ

__all__ = [
    "jac_from_affine", "jac_add", "jac_add_incomplete", "jac_madd_incomplete",
    "jac_double", "jac_infinity", "points_to_device", "points_from_device",
    "jac_select", "jac_roll",
]

_f = jfq()


def _one(device):
    return _f._c("one_mont", device)


def jac_infinity(shape, device):
    """The identity as (1, 1, 0) in Montgomery form on `device`: pieces are
    compared bytewise, so the encoding is part of the contract."""
    z = torch.zeros(tuple(shape) + (16,), dtype=torch.int64, device=device)
    one = _one(z.device).expand(tuple(shape) + (16,))
    return (one, one, z)


def jac_from_affine(x, y, valid=None):
    """(x, y) mont limbs -> Jacobian; lanes where valid==False become identity."""
    z = _one(x.device).expand(x.shape)
    if valid is not None:
        z = torch.where(valid.unsqueeze(-1), z, torch.zeros_like(z))
    return (x, y, z)


def jac_double(p):
    x1, y1, z1 = p
    f = _f
    a = f.square(x1)
    b = f.square(y1)
    c = f.square(b)
    d = f.sub(f.square(f.add(x1, b)), f.add(a, c))
    d = f.add(d, d)
    e = f.add(f.add(a, a), a)
    g = f.square(e)
    x3 = f.sub(g, f.add(d, d))
    c8 = f.add(c, c)
    c8 = f.add(c8, c8)
    c8 = f.add(c8, c8)
    y3 = f.sub(f.mul(e, f.sub(d, x3)), c8)
    z3 = f.mul(y1, z1)
    z3 = f.add(z3, z3)
    return (x3, y3, z3)


def jac_select(cond, p, q):
    """Per-lane select: cond bool[...] -> p where True else q. The mask may
    cover only leading batch axes; trailing axes broadcast."""
    out = []
    for a, b in zip(p, q):
        c = cond
        while c.dim() < max(a.dim(), b.dim()):
            c = c.unsqueeze(-1)
        out.append(torch.where(c, a, b))
    return tuple(out)


def jac_add(p, q):
    """Unified Jacobian addition handling identity and doubling lanes."""
    f = _f
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = f.square(z1)
    z2z2 = f.square(z2)
    u1 = f.mul(x1, z2z2)
    u2 = f.mul(x2, z1z1)
    s1 = f.mul(y1, f.mul(z2, z2z2))
    s2 = f.mul(y2, f.mul(z1, z1z1))
    h = f.sub(u2, u1)
    r = f.sub(s2, s1)

    hh = f.square(h)
    hhh = f.mul(h, hh)
    v = f.mul(u1, hh)
    x3 = f.sub(f.sub(f.square(r), hhh), f.add(v, v))
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(s1, hhh))
    z3 = f.mul(f.mul(z1, z2), h)
    res = (x3, y3, z3)

    h_zero = f.is_zero(h)
    r_zero = f.is_zero(r)
    p_inf = f.is_zero(z1)
    q_inf = f.is_zero(z2)
    # same x: either doubling (same y) or inverse points (Z3 = 0 already).
    res = jac_select(h_zero & r_zero & ~p_inf & ~q_inf, jac_double(p), res)
    res = jac_select(p_inf, q, res)
    res = jac_select(q_inf, p, res)
    return res


def jac_add_incomplete(p, q):
    """Jacobian addition handling identity lanes but NOT the doubling case
    (12M + 4S vs the unified add's ~26 mul-ops).

    Contract: if p == q (both non-infinity) the result is silently the
    identity (h = r = 0 makes every output coordinate 0). Safe wherever the
    two operands are sums of disjoint subsets of distinct points with
    random-ish scalars — the MSM bucket pipeline — where a collision has
    probability ~2^-254 and would only corrupt the proof being built (the
    verifier rejects it), never soundness.
    """
    f = _f
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = f.square(z1)
    z2z2 = f.square(z2)
    u1 = f.mul(x1, z2z2)
    u2 = f.mul(x2, z1z1)
    s1 = f.mul(y1, f.mul(z2, z2z2))
    s2 = f.mul(y2, f.mul(z1, z1z1))
    h = f.sub(u2, u1)
    r = f.sub(s2, s1)
    hh = f.square(h)
    hhh = f.mul(h, hh)
    v = f.mul(u1, hh)
    x3 = f.sub(f.sub(f.square(r), hhh), f.add(v, v))
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(s1, hhh))
    z3 = f.mul(f.mul(z1, z2), h)
    res = (x3, y3, z3)
    res = jac_select(f.is_zero(z1), q, res)
    res = jac_select(f.is_zero(z2), p, res)
    return res


def jac_madd_incomplete(p, qx, qy, qvalid):
    """Mixed Jacobian + affine addition (8M + 3S vs the general incomplete
    add's 12M + 4S) handling p == identity and invalid-q lanes but NOT the
    doubling case — same contract as :func:`jac_add_incomplete`: if p equals
    the affine point (both valid) the result silently becomes the identity.

    q is (x, y) Montgomery limbs with an explicit validity mask (there is no
    Z coordinate to encode infinity in affine form)."""
    f = _f
    x1, y1, z1 = p
    z1z1 = f.square(z1)
    u2 = f.mul(qx, z1z1)
    s2 = f.mul(qy, f.mul(z1, z1z1))
    h = f.sub(u2, x1)
    r = f.sub(s2, y1)
    hh = f.square(h)
    hhh = f.mul(h, hh)
    v = f.mul(x1, hh)
    x3 = f.sub(f.sub(f.square(r), hhh), f.add(v, v))
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(y1, hhh))
    z3 = f.mul(z1, h)
    res = (x3, y3, z3)
    res = jac_select(f.is_zero(z1), jac_from_affine(qx, qy, qvalid), res)
    res = jac_select(qvalid, res, p)
    return res


def jac_roll(p, shift, axis=0):
    return tuple(torch.roll(c, shift, dims=axis) for c in p)


# ---- host boundary --------------------------------------------------------

def points_to_device(affine_points, device=None):
    """List of host affine points (int pairs / None) -> (x, y, valid) tensors
    on `device` with coordinates in Montgomery limb form."""
    from ..device import resolve_device

    device = resolve_device(device)
    n = len(affine_points)
    xs = [0] * n
    ys = [0] * n
    valid = np.zeros(n, dtype=bool)
    for i, pt in enumerate(affine_points):
        if pt is not None:
            xs[i], ys[i] = pt
            valid[i] = True
    return (
        to_device(to_limbs(xs, FQ, mont=True), device),
        to_device(to_limbs(ys, FQ, mont=True), device),
        torch.from_numpy(valid).to(device),
    )


def points_from_device(jac):
    """Jacobian tensor points -> list of host affine points (None = identity).
    One stacked download; normalisation runs on the host in Python ints."""
    from .bn254 import jacobian_to_affine_batch

    packed = torch.stack([c.expand(jac[2].shape) for c in jac]).cpu().numpy()
    xs, ys, zs = (np.atleast_1d(from_limbs(comp, FQ, mont=True))
                  for comp in packed)
    return jacobian_to_affine_batch(list(xs), list(ys), list(zs))
