"""Fixed-width multi-limb integer arithmetic on tensors.

Counterpart of ``zerog_tpu/ops/limbmath.py``. Used where exact integers
exceed 32 bits but the 254-bit field machinery is more than needed: the WNN
MishMash hash ``(x^3 % p) % 2^l``, where ``x`` has up to 49 bits and ``x^3``
up to 147.

A number is a little-endian array of 16-bit limbs in the last axis of an
``int64`` tensor (PyTorch has no add, shift or compare for ``uint32`` on the
CPU); each limb is < 2^16, so the values equal the JAX package's ``uint32``
limbs. All widths are static.
"""

from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1

__all__ = ["LIMB_BITS", "MASK", "int_to_limbs", "normalize", "lmul",
           "lsub_clamped", "lge", "barrett_mod", "limbs_to_u32_pair"]


def int_to_limbs(x: int, n: int) -> np.ndarray:
    assert x >= 0 and x < (1 << (LIMB_BITS * n))
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(n)], dtype=np.uint32)


def _operand(b, like):
    """A limb operand as an int64 tensor on `like`'s device, broadcast over
    `like`'s batch when it is a constant vector."""
    if not isinstance(b, torch.Tensor):
        b = torch.from_numpy(np.asarray(b, dtype=np.int64))
    b = b.to(device=like.device, dtype=torch.int64)
    if b.dim() == 1:
        b = b.expand(tuple(like.shape[:-1]) + (b.shape[-1],))
    return b


def normalize(cols, n: int):
    out = []
    carry = torch.zeros_like(cols[..., 0])
    for j in range(n):
        v = (cols[..., j] if j < cols.shape[-1] else torch.zeros_like(carry)) + carry
        out.append(v & MASK)
        carry = v >> LIMB_BITS
    return torch.stack(out, dim=-1)


def lmul(a, b, out_limbs: int | None = None):
    """Product of two limb arrays. a: [..., na], b: [..., nb] (or a numpy
    constant vector [nb]) -> [..., na+nb] (or out_limbs)."""
    na = a.shape[-1]
    b = _operand(b, a)
    nb = b.shape[-1]
    nout = out_limbs if out_limbs is not None else na + nb
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    cols = torch.zeros(tuple(lead) + (nout + 1,), dtype=torch.int64,
                       device=a.device)
    for i in range(na):
        hi = min(nb, nout - i)
        if hi <= 0:
            break
        prod = a[..., i : i + 1] * b[..., :hi]
        cols[..., i : i + hi] += prod & MASK
        cols[..., i + 1 : i + 1 + hi] += prod >> LIMB_BITS
    return normalize(cols, nout)


def lsub_clamped(a, b):
    """a - b assuming a >= b (exact); both [..., n]."""
    n = a.shape[-1]
    cols = a + (_operand(b, a) ^ MASK)
    cols[..., 0] += 1
    return normalize(cols, n)  # drops the 2^(16n) carry


def lge(a, b):
    """a >= b elementwise over the batch; both [..., n] (b may be a numpy
    constant)."""
    n = a.shape[-1]
    b = _operand(b, a)
    borrow = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for i in range(n):
        borrow = (a[..., i] - b[..., i] - borrow < 0).to(torch.int64)
    return borrow == 0


def barrett_mod(t, p: int, t_limbs: int):
    """t mod p for t < 2^(16*t_limbs), p a static positive int.

    Classic Barrett: q = (t * mu) >> (16 * t_limbs) with
    mu = floor(2^(16*t_limbs) / p); then r = t - q*p with at most two
    corrective subtractions.
    """
    p_limbs_n = (p.bit_length() + LIMB_BITS - 1) // LIMB_BITS
    mu = (1 << (LIMB_BITS * t_limbs)) // p
    mu_np = int_to_limbs(mu, (mu.bit_length() + LIMB_BITS - 1) // LIMB_BITS or 1)
    p_np = int_to_limbs(p, p_limbs_n)
    q_full = lmul(t, mu_np)
    q = q_full[..., t_limbs:]
    qp = lmul(q, p_np, out_limbs=t_limbs)
    r = lsub_clamped(t, qp)
    for _ in range(2):
        ge = lge(r, int_to_limbs(p, t_limbs))
        r2 = lsub_clamped(r, int_to_limbs(p, t_limbs))
        r = torch.where(ge[..., None], r2, r)
    # result fits in p_limbs_n limbs
    return r[..., : p_limbs_n + 1]


def limbs_to_u32_pair(a):
    """Low 32 and next 32 bits of a limb array -> (lo, hi), each < 2^32."""
    lo = a[..., 0] | (a[..., 1] << 16) if a.shape[-1] > 1 else a[..., 0]
    if a.shape[-1] > 3:
        hi = a[..., 2] | (a[..., 3] << 16)
    elif a.shape[-1] > 2:
        hi = a[..., 2]
    else:
        hi = torch.zeros_like(lo)
    return lo, hi
