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

from .. import trace
from ..field import jfq, to_limbs, from_limbs, to_device, to_numpy, FQ

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


def _muls(*pairs):
    """Independent products in one call of the field's mul: the operands
    are broadcast to one shape and stacked on a new leading axis (a product
    costs its ~75 torch ops once for every pair)."""
    shape = torch.broadcast_shapes(*(t.shape for pair in pairs for t in pair))
    a = torch.stack([x.expand(shape) for x, _ in pairs])
    b = torch.stack([y.expand(shape) for _, y in pairs])
    return _f.mul(a, b).unbind(0)


def jac_double(p):
    x1, y1, z1 = p
    f = _f
    a, b, yz = _muls((x1, x1), (y1, y1), (y1, z1))
    xb = f.add(x1, b)
    e = f.add(f.add(a, a), a)
    c, xb2, g = _muls((b, b), (xb, xb), (e, e))
    d = f.sub(xb2, f.add(a, c))
    d = f.add(d, d)
    x3 = f.sub(g, f.add(d, d))
    c8 = f.add(c, c)
    c8 = f.add(c8, c8)
    c8 = f.add(c8, c8)
    y3 = f.sub(f.mul(e, f.sub(d, x3)), c8)
    z3 = f.add(yz, yz)
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


def _add_core(p, q):
    """The general Jacobian sum of p and q (12M + 4S, in six calls of the
    field's mul), with h and r: both zero where p == q."""
    f = _f
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = _muls((z1, z1), (z2, z2))
    u1, u2, z2c, z1c = _muls((x1, z2z2), (x2, z1z1), (z2, z2z2), (z1, z1z1))
    s1, s2 = _muls((y1, z2c), (y2, z1c))
    h = f.sub(u2, u1)
    r = f.sub(s2, s1)
    hh, rr, z1z2 = _muls((h, h), (r, r), (z1, z2))
    hhh, v, z3 = _muls((h, hh), (u1, hh), (z1z2, h))
    x3 = f.sub(f.sub(rr, hhh), f.add(v, v))
    ry, sh = _muls((r, f.sub(v, x3)), (s1, hhh))
    return (x3, f.sub(ry, sh), z3), h, r


def jac_add(p, q):
    """Unified Jacobian addition handling identity and doubling lanes."""
    f = _f
    z1, z2 = p[2], q[2]
    res, h, r = _add_core(p, q)
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
    res, _, _ = _add_core(p, q)
    res = jac_select(_f.is_zero(p[2]), q, res)
    res = jac_select(_f.is_zero(q[2]), p, res)
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
    u2, z1c = _muls((qx, z1z1), (z1, z1z1))
    s2 = f.mul(qy, z1c)
    h = f.sub(u2, x1)
    r = f.sub(s2, y1)
    hh, rr, z3 = _muls((h, h), (r, r), (z1, h))
    hhh, v = _muls((h, hh), (x1, hh))
    x3 = f.sub(f.sub(rr, hhh), f.add(v, v))
    ry, yh = _muls((r, f.sub(v, x3)), (y1, hhh))
    res = (x3, f.sub(ry, yh), z3)
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
    if trace.enabled():
        trace.count("h2d_bytes", valid.nbytes)
    return (
        to_device(to_limbs(xs, FQ, mont=True), device),
        to_device(to_limbs(ys, FQ, mont=True), device),
        torch.from_numpy(valid).to(device),
    )


def points_from_device(jac):
    """Jacobian tensor points -> list of host affine points (None = identity).
    One stacked download; normalisation runs on the host in Python ints."""
    from .bn254 import jacobian_to_affine_batch

    packed = to_numpy(torch.stack([c.expand(jac[2].shape) for c in jac]))
    xs, ys, zs = (np.atleast_1d(from_limbs(comp, FQ, mont=True))
                  for comp in packed)
    return jacobian_to_affine_batch(list(xs), list(ys), list(zs))
