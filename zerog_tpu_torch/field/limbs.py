"""Host <-> device conversion between Python ints and limb arrays.

The host keeps field elements as Python ints (arbitrary precision, exact); the
device keeps them as little-endian 16-bit limbs, 16 to an element, in the last
axis (see :mod:`zerog_tpu_torch.field.jfield`). These converters are the only
place where the two representations meet. Conversion is vectorized over whole
columns: arrays go through the C codec of :mod:`zerog_tpu_torch.native`,
whose plain versions are ``_to_limbs_np`` and ``_from_limbs_np`` here. The
numpy side is ``uint32[..., 16]``; :func:`to_device` and :func:`to_numpy`
move it to and from the tensor dtype of the port (int64 lanes: PyTorch has
no add, shift or compare for uint32 on the CPU).

Traced (:mod:`zerog_tpu_torch.trace`): the spans ``codec.encode``
(:func:`to_limbs`) and ``codec.decode`` (:func:`from_limbs`), and the
counters ``h2d_bytes`` (what :func:`to_device` hands to the device) and
``d2h_bytes`` (what :func:`to_numpy` takes off a tensor), counted on the CPU
too, where the same steps copy within the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import trace
from .params import FieldParams, NLIMB, LIMB_BITS, MASK

__all__ = ["to_limbs", "from_limbs", "ints_to_mont_limbs", "mont_limbs_to_ints",
           "to_device", "to_numpy"]


def _native():
    from ..native import limbcodec

    return limbcodec()


@functools.cache
def _mont_ctx(p: int):
    """(p as 32 bytes LE, -p^-1 mod 2^64, R^2 mod p as 32 bytes LE): the
    codec's Montgomery constants for the field of modulus `p`."""
    inv = (-pow(p, -1, 1 << 64)) % (1 << 64)
    r2 = pow(1 << 256, 2, p)
    return (p.to_bytes(32, "little"), inv, r2.to_bytes(32, "little"))


@trace.spanned("codec.encode")
def to_limbs(values, params: FieldParams | None = None, mont: bool = False) -> np.ndarray:
    """Convert int / list of ints / object ndarray -> uint32[..., 16].

    If ``mont`` is set, values are converted to Montgomery form first
    (requires ``params``). Arrays go through the C codec
    (:mod:`zerog_tpu_torch.native`); scalars, and arrays holding a value
    the codec refuses (negative, >= 2^256, not an int), take the exact
    numpy path, :func:`_to_limbs_np`."""
    arr = np.asarray(values, dtype=object)
    if arr.ndim > 0 and arr.size:
        flat = arr.reshape(-1).tolist()
        out = np.empty((len(flat), NLIMB), dtype=np.uint32)
        try:
            _native().ints_to_limbs(flat, out, _mont_ctx(params.p) if mont else None)
        except (OverflowError, TypeError, ValueError):
            pass  # negative, huge or not an int: the exact numpy path
        else:
            return out.reshape(arr.shape + (NLIMB,))
    return _to_limbs_np(arr, params, mont)


def _to_limbs_np(values, params: FieldParams | None = None,
                 mont: bool = False) -> np.ndarray:
    """The plain version of :func:`to_limbs`: 32 little-endian bytes an int,
    viewed as limbs; where an element is not an int in [0, 2^256),
    object-array shifts and masks, one pass a limb (negative values give
    their two's complement limbs, bits from 2^256 up are dropped, what
    supports no ``&`` raises)."""
    arr = np.asarray(values, dtype=object)
    if mont:
        assert params is not None
        arr = np.asarray((arr * params.r_mont) % params.p, dtype=object)
    out = np.empty(arr.shape + (NLIMB,), dtype=np.uint32)
    if arr.ndim == 0:
        v = int(arr[()])
        for j in range(NLIMB):
            out[j] = (v >> (LIMB_BITS * j)) & MASK
        return out
    try:
        raw = b"".join(v.to_bytes(32, "little") for v in arr.reshape(-1))
    except (AttributeError, OverflowError):
        pass  # not an int, negative or >= 2^256: one pass a limb
    else:
        return np.frombuffer(raw, dtype="<u2").astype(np.uint32).reshape(out.shape)
    cur = arr
    for j in range(NLIMB):
        out[..., j] = (cur & MASK).astype(np.uint32)
        cur = cur >> LIMB_BITS
    return out


@trace.spanned("codec.decode")
def from_limbs(limbs, params: FieldParams | None = None, mont: bool = False):
    """Convert [..., 16] limbs (numpy or tensor) -> object ndarray of Python
    ints (or a scalar int for a single element). If ``mont``, converts out of
    Montgomery form. Arrays go through the C codec; a single element or an
    empty array takes :func:`_from_limbs_np`."""
    limbs = to_numpy(limbs)
    shape = limbs.shape[:-1]
    if shape == () or not limbs.size:
        return _from_limbs_np(limbs, params, mont)
    flat = np.ascontiguousarray(limbs.reshape(-1, NLIMB), dtype=np.uint32)
    vals = _native().limbs_to_ints(flat, flat.shape[0],
                                   _mont_ctx(params.p) if mont else None)
    return np.asarray(vals, dtype=object).reshape(shape)


def _from_limbs_np(limbs, params: FieldParams | None = None, mont: bool = False):
    """The plain version of :func:`from_limbs`: of an array, each limb's
    low 16 bits, as the codec reads them; a single element's limbs shifted
    and or-ed, as in the JAX package."""
    limbs = to_numpy(limbs)
    shape = limbs.shape[:-1]
    if shape == ():
        acc = 0
        for j in range(NLIMB - 1, -1, -1):
            acc = (acc << LIMB_BITS) | int(limbs[j])
        if mont:
            acc = acc * pow(params.r_mont, -1, params.p) % params.p
        return acc
    raw = np.ascontiguousarray(limbs.reshape(-1, NLIMB).astype("<u2")).tobytes()
    vals = [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]
    if mont:
        assert params is not None
        rinv = pow(params.r_mont, -1, params.p)
        p = params.p
        vals = [v * rinv % p for v in vals]
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return out.reshape(shape)


def ints_to_mont_limbs(values, params: FieldParams) -> np.ndarray:
    return to_limbs(values, params, mont=True)


def mont_limbs_to_ints(limbs, params: FieldParams):
    return from_limbs(limbs, params, mont=True)


def to_device(limbs, device) -> torch.Tensor:
    """uint32 numpy limbs or indices (or a tensor) -> int64 tensor on
    `device`; a host array's int64 bytes, and a tensor's where it changes
    device, count as ``h2d_bytes``."""
    if isinstance(limbs, torch.Tensor):
        out = limbs.to(device=device, dtype=torch.int64)
        if trace.enabled() and out.device != limbs.device:
            trace.count("h2d_bytes", out.nbytes)
        return out
    arr = np.asarray(limbs).astype(np.int64)
    if trace.enabled():
        trace.count("h2d_bytes", arr.nbytes)
    return torch.from_numpy(arr).to(device)


def to_numpy(limbs) -> np.ndarray:
    """Tensor (any device) or array of limbs -> uint32 numpy array; a
    tensor's bytes count as ``d2h_bytes``."""
    if isinstance(limbs, torch.Tensor):
        if trace.enabled():
            trace.count("d2h_bytes", limbs.nbytes)
        return limbs.detach().cpu().numpy().astype(np.uint32)
    return np.asarray(limbs)
