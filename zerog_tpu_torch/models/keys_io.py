"""Proving/verifying key serialization.

Counterpart of ``zerog_tpu/models/keys_io.py`` (reference src/io.rs:159-176,
`write_keys`/`read_pk`/`read_vk` in RawBytes format), with the same file
layout: keys serialize to npz (limb-array columns, raw point bytes) and
deserialize *against the circuit shape* reconstructed from the circuit
params — exactly the reference's convention. A key read back holds host
columns only; the prover rebuilds its extended-form caches on the device of
the SRS it is given.
"""

from __future__ import annotations

import numpy as np

from ..curve.bn254 import g1_to_bytes, g1_from_bytes
from ..field import to_limbs, from_limbs
from ..plonk.cs import ConstraintSystem
from ..plonk.keygen import ProvingKey, VerifyingKey

__all__ = ["write_keys", "read_pk", "read_vk"]


def _points_to_arr(points):
    return np.frombuffer(
        b"".join(g1_to_bytes(pt) for pt in points), dtype=np.uint8
    ).reshape(len(points), 64)


def _arr_to_points(arr):
    return [g1_from_bytes(bytes(row.tobytes())) for row in arr]


def _compression_arrays(vk):
    """Flattened selector-compression layout (halo2 stores raw selector
    activations in the vk for the same reason: the compressed CS must be
    reconstructible at read time)."""
    info = vk.cs.compression
    if info is None:
        return dict(sel_keep=np.asarray([-1], np.int64))
    flat = [c for combo in info.combos for c in combo]
    lens = [len(combo) for combo in info.combos]
    return dict(
        sel_keep=np.asarray(list(info.keep), np.int64),
        sel_combo_flat=np.asarray(flat, np.int64),
        sel_combo_len=np.asarray(lens, np.int64),
    )


def write_keys(pk: ProvingKey, pk_path, vk_path=None):
    vk = pk.vk
    np.savez_compressed(
        pk_path,
        k=np.int64(vk.k),
        fixed_commitments=_points_to_arr(vk.fixed_commitments),
        permutation_commitments=_points_to_arr(vk.permutation_commitments),
        fixed_values=np.stack([to_limbs(c) for c in pk.fixed_values])
        if pk.fixed_values else np.zeros((0, vk.n, 16), np.uint32),
        sigma_values=np.stack([to_limbs(s) for s in pk.sigma_values])
        if pk.sigma_values else np.zeros((0, vk.n, 16), np.uint32),
        **_compression_arrays(vk),
    )
    if vk_path is not None:
        np.savez_compressed(
            vk_path,
            k=np.int64(vk.k),
            fixed_commitments=_points_to_arr(vk.fixed_commitments),
            permutation_commitments=_points_to_arr(vk.permutation_commitments),
            **_compression_arrays(vk),
        )


def _rebuild_cs(circuit_params, data) -> ConstraintSystem:
    from ..gadgets.wnn_circuit import WnnCircuit
    from ..plonk.selectors import SelectorCompression, apply_layout_to_cs

    cs = ConstraintSystem()
    WnnCircuit.configure_with_params(cs, circuit_params)
    keep = data["sel_keep"] if "sel_keep" in data else np.asarray([-1])
    if keep[0] != -1:
        flat = list(data["sel_combo_flat"]) if "sel_combo_flat" in data else []
        lens = list(data["sel_combo_len"]) if "sel_combo_len" in data else []
        combos, off = [], 0
        for ln in lens:
            combos.append(tuple(int(c) for c in flat[off : off + int(ln)]))
            off += int(ln)
        info = SelectorCompression(tuple(int(c) for c in keep), tuple(combos))
        apply_layout_to_cs(cs, info)
    return cs


def read_vk(path, circuit_params) -> VerifyingKey:
    data = np.load(path)
    cs = _rebuild_cs(circuit_params, data)
    return VerifyingKey(
        int(data["k"]), cs,
        _arr_to_points(data["fixed_commitments"]),
        _arr_to_points(data["permutation_commitments"]),
    )


def read_pk(path, circuit_params) -> ProvingKey:
    data = np.load(path)
    vk = read_vk(path, circuit_params)
    fixed = [from_limbs(a) for a in data["fixed_values"]]
    sigmas = [from_limbs(a) for a in data["sigma_values"]]
    return ProvingKey(vk, fixed, sigmas)
