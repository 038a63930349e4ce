"""Mesh Pippenger MSM: points partitioned over the mesh's entries.

Counterpart of ``zerog_tpu/parallel/sharded_msm.py``. Two paths:

- :func:`sharded_msm_device`: each entry runs the per-window scan strategy
  (``pippenger._one_window``) over its point shard; the per-window partial
  sums are all-gathered and folded with a log-depth complete point add (the
  reduction op is the group law, so the collective is all_gather + fold
  rather than psum).
- :func:`msm_fixed_sharded`, the prover's path: the merged-window fixed-base
  pipeline is linear in the point set, so the mesh version partitions the
  TABLE POINTS. Entry d runs the whole bucket pipeline
  (``pippenger._prep_core`` and ``_pipeline_device``, so on a CUDA entry the
  flush-scan and fold kernels launch with that shard's shapes) over its
  point shard, giving per-(entry, batch) weighted accumulators; the host
  folds the D partial results per batch row in the reference's order.
"""

from __future__ import annotations

import torch

from ..curve.bn254 import g1_add, g1_mul
from ..curve.jpoints import jac_add, jac_roll, jac_select, points_from_device
from ..curve.pippenger import (
    _digits, _digits_balanced, _one_window, _pip_bias_np, _pip_r_rows,
    _pipeline_device, _prep_core, _window_layout, WindowTable,
)
from ..field import FQ
from .mesh import Mesh, all_gather, shard_axis

__all__ = ["sharded_msm_device", "ShardedWindowTable", "msm_fixed_sharded"]


def _fold_points(points, m: int):
    """Log-depth fold of a leading axis of m Jacobian points (complete add);
    row 0 of the result holds the sum."""
    if m == 1:
        return points
    full = 1 << (m - 1).bit_length()
    if points[0].shape[0] < full:
        pad = full - points[0].shape[0]
        points = tuple(torch.cat([c, c.new_zeros((pad,) + tuple(c.shape[1:]))])
                       for c in points)
    idx = torch.arange(full, device=points[0].device)
    for s in range(full.bit_length() - 1):
        shift = full >> (s + 1)
        rolled = jac_roll(points, -shift)
        points = jac_select(idx < shift, jac_add(points, rolled), points)
    return points


def sharded_msm_device(mesh: Mesh, scalar_limbs, px, py, pvalid, c: int,
                       scalar_bits: int = 254):
    """scalar_limbs: [B, N, 16] canonical; points [N, 16] with N divisible
    by the mesh size, entry e taking points block e. Returns Jacobian window
    sums on the device of `px`, components [B, W, 16] (W = ceil(scalar_bits
    / c)). Pass `scalar_bits` to bound the number of windows when the
    scalars are known to be small."""
    digits = _digits(scalar_limbs, c, scalar_bits)     # [W, B, N]
    w, b, _ = digits.shape
    sums = []
    for dg, x, y, v in zip(shard_axis(mesh, digits, 2), shard_axis(mesh, px, 0),
                           shard_axis(mesh, py, 0),
                           shard_axis(mesh, pvalid, 0)):
        # digits: [W, B, Nlocal] for the local point shard
        sums.append(_one_window(dg.reshape(w * b, dg.shape[2]), x, y, v, c))
    gathered = tuple(all_gather([s[k] for s in sums], px.device)
                     for k in range(3))                # [D, W*B, 16]
    folded = _fold_points(gathered, len(mesh))
    return tuple(torch.movedim(comp[0].reshape(w, b, 16), 1, 0)
                 for comp in folded)


class ShardedWindowTable:
    """A merged-window table re-laid out as [D, W*Nloc, 16] (entry d's rows
    j*Nloc + i_loc hold 2^{offset_j} * P_{d*Nloc + i_loc}), entry d's block
    on its device. Built from a single-device :class:`WindowTable` whose
    point count is a multiple of the mesh size."""

    __slots__ = ("mesh", "c", "n", "n_local", "d", "w", "tx", "ty", "tvalid")

    def __init__(self, mesh: Mesh, table: WindowTable):
        d = len(mesh)
        n = table.n
        if n % d:
            raise ValueError(
                f"table point count {n} not divisible by mesh size {d}; "
                "pad the point set before building the table")
        w = len(_window_layout(table.c)[0])
        nloc = n // d
        self.mesh, self.c, self.n, self.n_local, self.d, self.w = (
            mesh, table.c, n, nloc, d, w)

        def relay(a):
            trailing = tuple(a.shape[1:])
            a = a.reshape((w, d, nloc) + trailing)
            a = torch.movedim(a, 1, 0).reshape((d, w * nloc) + trailing)
            return [a[i].to(dev) for i, dev in enumerate(mesh)]

        self.tx = relay(table.tx)
        self.ty = relay(table.ty)
        self.tvalid = relay(table.tvalid)


def _entry_preps(mesh: Mesh, sl, stable: ShardedWindowTable):
    """Per entry, the pipeline prep of its (entry, batch) groups on its
    device (minus max_run), and the rows of a scan column."""
    b = int(sl.shape[0])
    c, d = stable.c, stable.d
    r_rows = _pip_r_rows(stable.w * stable.n_local)
    digits = _digits_balanced(sl, c)                   # [W, B, N]
    w, _, n = digits.shape
    # groups are (entry, batch) pairs g = dd*B + bb
    ds = (digits.reshape(w, b, d, n // d).permute(2, 1, 0, 3)
          .reshape(d * b, w * (n // d)))
    preps = [_prep_core(ds[dd * b:(dd + 1) * b].to(dev), stable.tx[dd],
                        stable.ty[dd], stable.tvalid[dd], r_rows, 1 << c)[:-1]
             for dd, dev in enumerate(mesh)]
    return preps, r_rows


def _run_pipelines(preps, r_rows: int, c: int, device, merge: bool):
    """The bucket pipelines of the entries' preps; returns the weighted
    accumulators of every (entry, batch) group, entry-major, on `device`.
    Each entry runs its own pipeline, so a CUDA entry launches the kernels
    with its shard's shapes. With `merge` (a mesh of CPU entries: no
    kernels) the plain versions run every entry's groups in one pipeline:
    groups never meet, so the values are those of one run an entry, and the
    per-row cost of the plain scans is paid once."""
    if merge:
        return _pipeline_device(
            tuple(torch.cat(parts, dim=0 if parts[0].dim() == 2 else 1)
                  for parts in zip(*preps)), r_rows, c, compact=True)
    accs = [_pipeline_device(prep, r_rows, c, compact=True) for prep in preps]
    return tuple(torch.cat([a[k].to(device) for a in accs]) for k in range(3))


def msm_fixed_sharded(mesh: Mesh, sl, stable: ShardedWindowTable):
    """Point-sharded merged-window fixed-base MSM.

    sl: [B, N, 16] canonical scalar limbs (N = table point count). Returns
    [B] affine host points, identical to the single-device
    ``msm_fixed_host`` result (exact group arithmetic). The compaction round
    always runs on the mesh path, as in the reference, so the launch
    structure does not depend on the data."""
    b = int(sl.shape[0])
    c, d = stable.c, stable.d
    preps, r_rows = _entry_preps(mesh, sl, stable)
    acc2 = _run_pipelines(preps, r_rows, c, sl.device,
                          merge=all(dev.type == "cpu" for dev in mesh))
    host = points_from_device(tuple(comp.reshape(d * b * 2, 16) for comp in acc2))
    bias_pt, _ = _pip_bias_np()
    neg_k = (bias_pt[0], (-bias_pt[1]) % FQ.p)
    lo_bits = c // 2
    results = []
    for bb in range(b):
        acc = None
        for dd in range(d):
            g = dd * b + bb
            w_hi = g1_add(host[2 * g], neg_k)
            w_lo = g1_add(host[2 * g + 1], neg_k)
            part = g1_add(g1_mul(w_hi, 1 << lo_bits), w_lo)
            acc = part if acc is None else g1_add(acc, part)
        results.append(acc)
    return results
