"""The device mesh: entries in one process, and the collectives between them.

Counterpart of ``zerog_tpu/parallel/mesh.py``. ``zerog_tpu`` drives its mesh
from one controller (one process, many devices; ``shard_map`` and GSPMD put in
the collectives). The port does the same: a :class:`Mesh` is a tuple of
``torch.device`` entries, each entry holds one shard, and the collectives
below are explicit functions on lists of per-entry tensors, each named after
the ``jax.lax`` collective it replaces. An entry may repeat a device:
``["cpu"] * 8`` is the counterpart of the 8 virtual host devices of the JAX
package's tests, ``["cuda:0"] * 4`` runs four shards on one card.

The three hot spots shard over the mesh as in the reference:

- MSM: points partitioned across entries, per-entry bucket pipelines, the
  partial sums gathered and folded (point addition is the reduction op).
- NTT: four-step (Bailey) decomposition with one ``all_to_all`` transpose
  between the two local NTT stages.
- Quotient evaluation: row-sharded extended domain; rotations read the rows
  they need from the neighbouring block (:func:`halo_rows`).
"""

from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["Mesh", "make_mesh", "mesh_key", "AXIS", "shard_axis", "gather",
           "all_gather", "all_to_all", "halo_rows"]

#: the name of the mesh's one axis, as in the reference
AXIS = "shard"


class Mesh(tuple):
    """A 1-D mesh: a tuple of ``torch.device`` entries, one shard each."""

    def __new__(cls, devices):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one entry")
        return super().__new__(cls, devs)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of the first `n_devices` of `devices`. Given no devices, the
    mesh is every CUDA card, and the call raises on a machine without one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no devices given and no CUDA device "
                               "is available; pass devices=['cpu'] * n")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    return Mesh(devices[:n_devices])


def mesh_key(mesh: Mesh):
    """Hashable identity of a mesh: its device strings and its entry count."""
    return (tuple(str(d) for d in mesh), len(mesh))


def shard_axis(mesh: Mesh, x: torch.Tensor, axis: int) -> list:
    """`x` sharded along `axis`: equal blocks, block e on entry e's device
    (the counterpart of placing an array with the reference's
    ``shard_axis`` sharding)."""
    d = len(mesh)
    if x.shape[axis] % d:
        raise ValueError(f"axis of {x.shape[axis]} not divisible by the mesh "
                         f"size {d}")
    return [blk.to(dev) for blk, dev in zip(torch.chunk(x, d, dim=axis), mesh)]


def gather(parts, axis: int, device) -> torch.Tensor:
    """Concatenate per-entry blocks along `axis` on `device`."""
    return torch.cat([p.to(device) for p in parts], dim=axis)


def all_gather(parts, device) -> torch.Tensor:
    """``jax.lax.all_gather``: the entries' tensors stacked on a new leading
    axis, on `device` (the entry that consumes them)."""
    return torch.stack([p.to(device) for p in parts])


def all_to_all(mesh: Mesh, parts, split_axis: int, concat_axis: int) -> list:
    """``jax.lax.all_to_all(..., tiled=True)``: entry e receives chunk e of
    every entry's `split_axis`, concatenated along `concat_axis` in entry
    order, on its own device."""
    d = len(mesh)
    if any(p.shape[split_axis] % d for p in parts):
        raise ValueError("all_to_all: split axis not divisible by the mesh "
                         "size")
    chunks = [torch.chunk(p, d, dim=split_axis) for p in parts]
    return [torch.cat([chunks[src][dst].to(dev) for src in range(d)],
                      dim=concat_axis)
            for dst, dev in enumerate(mesh)]


def halo_rows(blocks, e: int, shift: int) -> torch.Tensor:
    """Entry e's block of a row-sharded array rotated by `shift` rows along
    axis -2 (row i of the result is row start_e + i + shift, mod n, of the
    whole array): the collective permute that XLA inserts for a rotation.
    The rows lie in at most two neighbouring blocks; they are copied to
    entry e's device."""
    d = len(blocks)
    blk = blocks[0].shape[-2]
    q, rem = divmod(shift % (blk * d), blk)
    dev = blocks[e].device
    first = blocks[(e + q) % d]
    if rem == 0:
        return first.to(dev)
    second = blocks[(e + q + 1) % d]
    return torch.cat([first[..., rem:, :].to(dev), second[..., :rem, :].to(dev)],
                     dim=-2)
