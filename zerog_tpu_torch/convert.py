"""Carry state across from the JAX package without importing it.

What both packages must share to compute the same thing is the SRS, the
window table, the proving key and the WNN model. These functions take
plain Python and numpy data — the fields of the JAX package's objects, pulled
out by the caller (``np.asarray`` on device arrays) — and make the port's
objects from them. An SRS file written by either package's ``Srs.write`` and
read by the other's ``Srs.read`` is the second carrier.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve.pippenger import WindowTable
from .curve.srs import Srs
from .device import resolve_device
from .field import to_device
from .models.wnn import Wnn
from .plonk.cs import ConstraintSystem
from .plonk.keygen import ProvingKey, VerifyingKey

__all__ = ["srs_from_reference", "window_table_from_numpy",
           "proving_key_from_reference", "wnn_from_reference"]


def _point(pt):
    return None if pt is None else (int(pt[0]), int(pt[1]))


def srs_from_reference(k, g, g_lagrange, g2, s_g2, device=None) -> Srs:
    """An :class:`Srs` from host affine points (int pairs, None = identity),
    as ``zerog_tpu.curve.Srs`` holds them in ``g``, ``g_lagrange``, ``g2``
    and ``s_g2``."""
    return Srs(int(k), [_point(p) for p in g], [_point(p) for p in g_lagrange],
               g2, s_g2, device=device)


def window_table_from_numpy(c, n, tx, ty, tvalid, device=None) -> WindowTable:
    """A :class:`WindowTable` from the arrays of the JAX package's table:
    tx, ty uint32[W*n, 16] affine Montgomery limbs, tvalid bool[W*n]."""
    device = resolve_device(device)
    return WindowTable(
        int(c), int(n), to_device(np.asarray(tx), device),
        to_device(np.asarray(ty), device),
        torch.from_numpy(np.asarray(tvalid).astype(bool)).to(device))


def proving_key_from_reference(k, circuit, fixed_values, sigma_values,
                               fixed_commitments, permutation_commitments,
                               compression=None) -> ProvingKey:
    """A :class:`ProvingKey` from the JAX package's key material. The
    constraint system is made by running `circuit.configure` (a circuit
    declared against the port's IR) through the port's own
    :class:`ConstraintSystem`; values and commitments are taken as given.
    `compression` is ``(keep, combos)`` of the selector-compression record
    on the reference key's constraint system (``pk.vk.cs.compression``) when
    its keygen compressed selectors: it is replayed on the fresh constraint
    system so that the fixed-column layout matches `fixed_values`."""
    cs = ConstraintSystem()
    circuit.configure(cs)
    if compression is not None:
        from .plonk.selectors import SelectorCompression, apply_layout_to_cs

        keep, combos = compression
        apply_layout_to_cs(cs, SelectorCompression(
            tuple(int(i) for i in keep),
            tuple(tuple(int(i) for i in combo) for combo in combos)))
    vk = VerifyingKey(int(k), cs,
                      [_point(p) for p in fixed_commitments],
                      [_point(p) for p in permutation_commitments])
    as_obj = lambda col: np.asarray([int(v) for v in col], dtype=object)
    return ProvingKey(vk, [as_obj(c) for c in fixed_values],
                      [as_obj(c) for c in sigma_values])


def wnn_from_reference(num_classes, num_filter_inputs, num_filter_entries,
                       num_filter_hashes, p, bloom_filters, input_permutation,
                       binarization_thresholds) -> Wnn:
    """A :class:`Wnn` from the fields of a ``zerog_tpu.models.Wnn`` (Python
    ints and numpy arrays), so that both packages prove the same model."""
    return Wnn(
        num_classes=int(num_classes),
        num_filter_inputs=int(num_filter_inputs),
        num_filter_entries=int(num_filter_entries),
        num_filter_hashes=int(num_filter_hashes),
        p=int(p),
        bloom_filters=np.asarray(bloom_filters).astype(bool),
        input_permutation=np.asarray(input_permutation).astype(np.int64),
        binarization_thresholds=np.asarray(binarization_thresholds).astype(
            np.uint16))
