"""NTT over Fr on tensors: radix-2 butterflies, and the int8-DFT engine for
large transforms.

Counterpart of ``zerog_tpu/poly/ntt.py`` in the JAX package's default
accelerator configuration: a transform of ``log_n >= MXU_MIN_LOG_N`` goes to
the int8-DFT engine (:mod:`zerog_tpu_torch.poly.pntt`, kernels
``ntt_epilogue`` and ``ntt_twiddle`` on a CUDA tensor, their plain versions
on a CPU tensor), a smaller one to the butterflies. The butterflies are
decimation-in-time with a bit-reversal pre-permutation: every stage is a
full-width vectorized butterfly (one Montgomery mul + modular add/sub over
the whole array). Both give the same values bit for bit.

Twiddle tables are host-precomputed per domain (Montgomery form) and kept on
the plan's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..field import FR, jfr, to_limbs, to_device
from ..field.params import bit_reverse
from .pntt import get_pntt_plan, pntt_transform

__all__ = ["NttPlan"]


class NttPlan:
    """Precomputed tables for forward/inverse NTT of size 2^log_n over Fr."""

    def __init__(self, log_n: int, omega: int | None = None, device=None):
        self.device = resolve_device(device)
        self.log_n = log_n
        self.n = 1 << log_n
        self.omega = omega if omega is not None else FR.nth_root_of_unity(log_n)
        self.omega_inv = FR.inv(self.omega)
        self.n_inv = FR.inv(self.n)
        self.bitrev = torch.from_numpy(np.array(
            [bit_reverse(i, log_n) for i in range(self.n)], dtype=np.int64
        )).to(self.device)
        self._fwd_tw = self._twiddles(self.omega)
        self._inv_tw = self._twiddles(self.omega_inv)
        self._n_inv_limbs = to_device(to_limbs(self.n_inv, FR, mont=True),
                                      self.device)

    #: transforms of at least this size go to the int8-DFT engine
    MXU_MIN_LOG_N = 12

    def _mxu(self, inverse: bool):
        """The engine's plan (cached, built at first use). The inverse plan
        folds n^-1 into its outermost matrix."""
        if inverse:
            return get_pntt_plan(self.log_n, self.omega_inv, self.n_inv)
        return get_pntt_plan(self.log_n, self.omega, 1)

    def _use_mxu(self) -> bool:
        return self.log_n >= self.MXU_MIN_LOG_N

    def _twiddles(self, omega: int):
        tables = []
        for s in range(self.log_n):
            m = 1 << (s + 1)
            w_m = pow(omega, self.n // m, FR.p)
            ws = []
            w = 1
            for _ in range(m // 2):
                ws.append(w)
                w = w * w_m % FR.p
            tables.append(to_device(to_limbs(ws, FR, mont=True), self.device))
        return tables

    def _transform(self, values, tables):
        """values: mont limbs [..., n, 16] -> same shape."""
        f = jfr()
        x = values.index_select(-2, self.bitrev)
        batch = tuple(x.shape[:-2])
        for s in range(self.log_n):
            m = 1 << (s + 1)
            x = x.reshape(batch + (self.n // m, m, 16))
            lo = x[..., : m // 2, :]
            hi = x[..., m // 2 :, :]
            t = f.mul(hi, tables[s])  # twiddles [m//2, 16]
            x = torch.cat([f.add(lo, t), f.sub(lo, t)], dim=-2)
        return x.reshape(batch + (self.n, 16))

    def _intt_impl(self, evals):
        f = jfr()
        out = self._transform(evals, self._inv_tw)
        return f.mul(out, self._n_inv_limbs)

    def ntt(self, coeffs):
        """Coefficients -> evaluations at [omega^0, omega^1, ...]."""
        if self._use_mxu():
            return pntt_transform(self._mxu(False), coeffs)
        return self._transform(coeffs, self._fwd_tw)

    def intt(self, evals):
        """Evaluations -> coefficients."""
        if self._use_mxu():
            return pntt_transform(self._mxu(True), evals)
        return self._intt_impl(evals)


@functools.cache
def _plan(log_n: int, device) -> NttPlan:
    return NttPlan(log_n, device=device)


def get_plan(log_n: int, device=None) -> NttPlan:
    return _plan(log_n, resolve_device(device))
