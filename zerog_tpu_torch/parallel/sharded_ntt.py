"""Mesh NTT: four-step (Bailey) decomposition n = n1 * n2.

Counterpart of ``zerog_tpu/parallel/sharded_ntt.py``:

- stage A: local length-n2 NTTs, each entry on its block of the i1 axis;
- stage B: pointwise twiddle by omega_n^(i1*k2) (each entry its rows);
- stage C: ``all_to_all`` re-shard (the distributed transpose);
- stage D: local length-n1 NTTs.

Index math: with i = i1 + n1*i2 and k = k2 + n2*k1,
  X[k2 + n2*k1] = sum_{i1} w_n^{i1*k2} w_{n1}^{i1*k1} sum_{i2} w_{n2}^{i2*k2} x[i1 + n1*i2].

The result is the natural-order NTT, gathered on the input's device in the
reference's layout. Passing ``omega = FR.inv(nth_root)`` gives the UNSCALED
inverse transform (callers multiply by 1/n), which is how
:class:`~zerog_tpu_torch.parallel.sharded_domain.ShardedDomain` builds the
mesh counterparts of ``Domain.lagrange_to_coeff`` and ``extended_to_coeff``.
All arithmetic is exact: the result equals the single-device transform limb
for limb.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import FR, jfr, to_device, to_limbs
from ..poly.ntt import NttPlan
from .mesh import Mesh, all_to_all, gather, shard_axis

__all__ = ["FourStepNtt"]


class FourStepNtt:
    def __init__(self, log_n: int, log_n1: int | None = None,
                 omega: int | None = None):
        self.log_n = log_n
        self.n = 1 << log_n
        if log_n1 is None:
            log_n1 = log_n // 2
        self.log_n1 = log_n1
        self.log_n2 = log_n - log_n1
        self.n1 = 1 << self.log_n1
        self.n2 = 1 << self.log_n2
        omega = omega if omega is not None else FR.nth_root_of_unity(log_n)
        self.omega = omega
        # sub-transform roots MUST be w_n^(n/ni) (for the canonical root this
        # equals nth_root_of_unity(log_ni); for an inverse/coset root it
        # does not, hence the explicit powers)
        self._root1 = pow(omega, self.n2, FR.p)
        self._root2 = pow(omega, self.n1, FR.p)
        tw = np.empty((self.n1, self.n2), dtype=object)
        for i1 in range(self.n1):
            base = pow(omega, i1, FR.p)
            cur = 1
            for k2 in range(self.n2):
                tw[i1, k2] = cur
                cur = cur * base % FR.p
        self.twiddle = to_limbs(tw, FR, mont=True)  # [n1, n2, 16]
        self._per_device: dict = {}

    def _device_parts(self, mesh: Mesh):
        """Per entry: its block of twiddle rows and the two sub-plans on its
        device (cached per mesh)."""
        key = tuple(str(d) for d in mesh)
        parts = self._per_device.get(key)
        if parts is None:
            tw = shard_axis(mesh, to_device(self.twiddle, mesh[0]), axis=0)
            plans = {}
            for dev in mesh:
                if str(dev) not in plans:
                    plans[str(dev)] = (NttPlan(self.log_n1, self._root1, dev),
                                       NttPlan(self.log_n2, self._root2, dev))
            parts = self._per_device[key] = [
                (t, *plans[str(dev)]) for t, dev in zip(tw, mesh)]
        return parts

    def ntt_sharded(self, mesh: Mesh, values):
        """values: mont limbs [..., n, 16] (leading batch axes allowed) on
        any device. Returns the natural-order NTT as [..., n, 16] on the
        same device."""
        n1, n2 = self.n1, self.n2
        d = len(mesh)
        if n1 % d or n2 % d:
            raise ValueError(f"n1 = {n1} and n2 = {n2} must both be divisible "
                             f"by the mesh size {d}")
        f = jfr()
        batch = tuple(values.shape[:-2])
        x_mat = values.reshape(batch + (n2, n1, 16))   # x[i1 + n1*i2] at [i2, i1]
        blocks = shard_axis(mesh, x_mat, axis=-2)      # [..., n2, n1/D, 16]
        stage_b = []
        for x_block, (tw_block, _, plan2) in zip(blocks, self._device_parts(mesh)):
            a = torch.swapaxes(x_block, -3, -2)        # [..., n1/D, n2, 16]
            a = plan2.ntt(a)                           # local length-n2 NTTs
            stage_b.append(f.mul(a, tw_block))         # twiddle
        # all_to_all: split the n2 axis, concatenate the i1 axis
        stage_c = all_to_all(mesh, stage_b, split_axis=-2, concat_axis=-3)
        out = []
        for c, (_, plan1, _) in zip(stage_c, self._device_parts(mesh)):
            dd = torch.swapaxes(c, -3, -2)             # [..., n2/D, n1, 16]
            dd = plan1.ntt(dd)                         # local length-n1 NTTs
            out.append(torch.swapaxes(dd, -3, -2))     # [..., n1, n2/D, 16]
        full = gather(out, axis=-2, device=values.device)  # [..., n1(k1), n2(k2), 16]
        return full.reshape(batch + (self.n, 16))     # X[k2 + n2*k1] at n2*k1+k2
