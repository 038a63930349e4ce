"""Mesh proving: :class:`ShardedSrs` routes every commitment through the
point-sharded merged-window fixed-base MSM (``sharded_msm.msm_fixed_sharded``
— the single-device prover's pipeline, partitioned over the mesh), and
``create_proof(..., mesh=...)`` row-shards the quotient evaluation and runs
its NTTs through the four-step decomposition (``sharded_domain``).

Counterpart of ``zerog_tpu/parallel/sharded_prover.py``. All paths are exact
field arithmetic, so a mesh proof is byte-identical to the single-device
proof under the same seed.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from .. import trace
from ..curve.pippenger import WindowTable, default_fixed_window
from ..field import FR, jfr, to_device, to_limbs
from .mesh import Mesh
from .sharded_msm import ShardedWindowTable, msm_fixed_sharded

__all__ = ["ShardedSrs"]


def _padded_table(table: WindowTable, pad: int) -> WindowTable:
    """`table` with `pad` zero points appended to the point set: in every
    window their entries are zero and invalid, which is what the build over
    the padded points gives."""
    w = int(table.tx.shape[0]) // table.n

    def widen(a):
        a = a.reshape((w, table.n) + tuple(a.shape[1:]))
        a = F.pad(a, (0, 0, 0, pad)) if a.dim() == 3 else F.pad(a, (0, pad))
        return a.reshape((w * (table.n + pad),) + tuple(a.shape[2:]))

    return WindowTable(table.c, table.n + pad, widen(table.tx),
                       widen(table.ty), widen(table.tvalid))


class ShardedSrs:
    """Drop-in Srs facade whose commitment MSMs shard points over a mesh.

    Each entry runs the complete merged-window bucket pipeline over its
    point shard; the host folds the D partial sums per batch row. All group
    arithmetic is exact, so commitments are the same points as the
    single-device ``Srs.commit*`` results. The mesh's first entry must be
    the SRS's device: the data lives there between the sharded stages.
    """

    def __init__(self, srs, mesh: Mesh):
        if mesh[0] != srs.device:
            raise ValueError(f"the mesh's first entry {mesh[0]} is not the "
                             f"SRS's device {srs.device}")
        self.srs = srs
        self.mesh = mesh
        self.device = srs.device
        self.k = srs.k
        self.g2 = srs.g2
        self.s_g2 = srs.s_g2
        d = len(mesh)
        self._pad = (-srs.n) % d
        self.n = srs.n  # logical SRS size (gwc sizes host polys from this)
        self._tables: dict = {}

    # -- core --------------------------------------------------------------
    def _table(self, basis: str) -> ShardedWindowTable:
        t = self._tables.get(basis)
        if t is None:
            # the Srs's own table (built once per SRS, at any size); its c is
            # the reference's default_fixed_window(n + pad), as n = 2^k and
            # n + pad < 2n have one bit length
            table = self.srs.window_table(basis, min_n=0)
            assert table.c == default_fixed_window(self.n + self._pad)
            if self._pad:
                table = _padded_table(table, self._pad)
            t = self._tables[basis] = ShardedWindowTable(self.mesh, table)
        return t

    @property
    def MAX_BATCH(self) -> int:
        """Commitments per pipeline run: 2 on the CPU (entries there share
        the host's memory), else the SRS's own. Batching does not change the
        committed points."""
        if self.device.type == "cpu":
            return 2
        return self.srs.MAX_BATCH

    def _msm_sharded(self, sl, basis: str):
        """sl: canonical [B, N, 16] (unpadded N) on the SRS's device;
        returns B host points."""
        b = int(sl.shape[0])
        if self._pad:
            sl = F.pad(sl, (0, 0, 0, self._pad))
        table = self._table(basis)
        out = []
        for i in range(0, b, self.MAX_BATCH):
            chunk = sl[i:i + self.MAX_BATCH]
            short = self.MAX_BATCH - int(chunk.shape[0])
            if short:  # pad the batch so every run has one batch shape
                chunk = F.pad(chunk, (0, 0, 0, 0, 0, short))
            out.extend(msm_fixed_sharded(self.mesh, chunk, table)[
                : self.MAX_BATCH - short])
        return out[:b]

    def _rows_to_limbs(self, rows):
        arr = np.asarray([[int(v) % FR.p for v in r] for r in rows], dtype=object)
        return to_device(to_limbs(arr), self.device)

    # -- Srs-compatible commitment API, each call the span ``msm`` ------------
    @trace.spanned("msm")
    def commit_lagrange(self, values):
        single = not isinstance(values[0], (list, tuple, np.ndarray))
        rows = [values] if single else list(values)
        out = self._msm_sharded(self._rows_to_limbs(rows), "lagrange")
        return out[0] if single else out

    @trace.spanned("msm")
    def commit(self, coeffs):
        single = not isinstance(coeffs[0], (list, tuple, np.ndarray))
        rows = [coeffs] if single else list(coeffs)
        rows = [list(r) + [0] * (self.srs.n - len(r)) for r in rows]
        out = self._msm_sharded(self._rows_to_limbs(rows), "monomial")
        return out[0] if single else out

    def _dev_canonical(self, stack):
        if stack.dim() == 2:
            stack = stack[None]
        return jfr().from_mont(stack.to(self.device))

    @trace.spanned("msm")
    def commit_lagrange_dev(self, stack):
        single = stack.dim() == 2
        out = self._msm_sharded(self._dev_canonical(stack), "lagrange")
        return out[0] if single else out

    @trace.spanned("msm")
    def commit_dev(self, stack):
        single = stack.dim() == 2
        out = self._msm_sharded(self._dev_canonical(stack), "monomial")
        return out[0] if single else out
