"""Mesh evaluation domain: a Domain whose four big NTTs run through the
four-step ``all_to_all`` decomposition (:class:`FourStepNtt`).

Counterpart of ``zerog_tpu/parallel/sharded_domain.py``.
``create_proof(..., mesh=...)`` swaps its Domain for this wrapper, so that
the lagrange->coeff, coeff->extended-coset, extended->coeff and
coeff->lagrange transforms run sharded over the mesh; the pointwise steps
(zeta coset scaling, vanishing division) and the host algebra delegate to
the wrapped Domain. It adds :meth:`rotate_extended_sharded` for the
row-sharded quotient. All arithmetic is exact, so proofs stay
byte-identical to the single-device path.
"""

from __future__ import annotations

import torch

from ..field import FR, jfr, to_device, to_limbs
from ..poly.domain import Domain
from .mesh import Mesh, halo_rows
from .sharded_ntt import FourStepNtt

__all__ = ["ShardedDomain"]


class ShardedDomain:
    def __init__(self, domain: Domain, mesh: Mesh):
        self._domain = domain
        self.mesh = mesh
        d = len(mesh)
        log_d = max(1, (d - 1).bit_length())
        self._f = jfr()

        def mk(log_n, omega):
            # both n1 (shard axis) and n2 (all_to_all split axis) must be
            # divisible by the mesh size
            if log_n < 2 * log_d:
                return None  # domain smaller than mesh^2: keep local NTTs
            log_n1 = max(log_d, log_n // 2)
            return FourStepNtt(log_n, log_n1=log_n1, omega=omega)

        self._base_fwd = mk(domain.k, domain.omega)
        self._base_inv = mk(domain.k, domain.omega_inv)
        self._ext_fwd = mk(domain.extended_k, domain.extended_omega)
        self._ext_inv = mk(domain.extended_k, domain.extended_omega_inv)
        dev = domain.device
        self._n_inv = to_device(to_limbs(FR.inv(domain.n), FR, mont=True), dev)
        self._ext_n_inv = to_device(
            to_limbs(FR.inv(domain.extended_n), FR, mont=True), dev)

    def __getattr__(self, name):
        return getattr(self._domain, name)

    # ---- device transforms (mesh four-step) ------------------------------
    def lagrange_to_coeff(self, values):
        if self._base_inv is None:
            return self._domain.lagrange_to_coeff(values)
        out = self._base_inv.ntt_sharded(self.mesh, values)
        return self._f.mul(out, self._n_inv)

    def coeff_to_lagrange(self, coeffs):
        if self._base_fwd is None:
            return self._domain.coeff_to_lagrange(coeffs)
        return self._base_fwd.ntt_sharded(self.mesh, coeffs)

    def coeff_to_extended(self, coeffs):
        if self._ext_fwd is None:
            return self._domain.coeff_to_extended(coeffs)
        dom = self._domain
        pad = dom.extended_n - coeffs.shape[-2]
        if pad:
            coeffs = torch.nn.functional.pad(coeffs, (0, 0, 0, pad))
        scaled = self._f.mul(coeffs, dom._zeta_pows)
        return self._ext_fwd.ntt_sharded(self.mesh, scaled)

    def extended_to_coeff(self, evals):
        if self._ext_inv is None:
            return self._domain.extended_to_coeff(evals)
        dom = self._domain
        coeffs = self._ext_inv.ntt_sharded(self.mesh, evals)
        coeffs = self._f.mul(coeffs, self._ext_n_inv)
        return self._f.mul(coeffs, dom._zeta_inv_pows)

    # ---- row-sharded quotient ------------------------------------------------
    def rotate_extended_sharded(self, blocks, e: int, rotation: int):
        """Entry e's block of ``rotate_extended(full, rotation)``, where
        `blocks` are the entries' row blocks of `full` (axis -2)."""
        scale = self.extended_n // self.n
        return halo_rows(blocks, e, rotation * scale)
