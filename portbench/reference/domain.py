"""The evaluation domain's host algebra: n = 2^k rows, the extended degree,
the vanishing polynomial and the Lagrange basis at a point.

Frozen copy of ``HostDomain`` of ``zerog_tpu_torch/poly/domain.py``, taken
when the benchmark was defined.
"""

from __future__ import annotations

import functools

from .field import FR, batch_inv

__all__ = ["HostDomain", "get_host_domain"]


def _log2_ceil(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


class HostDomain:
    """n = 2^k rows; extended domain of size 2^extended_k for degree-(d) gates.

    ``degree`` is the max constraint degree d; the quotient polynomial has
    degree (d-1)*n - n, committed in (d-1) chunks of size n.
    """

    def __init__(self, k: int, degree: int):
        self.k = k
        self.n = 1 << k
        self.degree = degree
        self.quotient_poly_degree = degree - 1
        self.extended_k = k + _log2_ceil(self.quotient_poly_degree)
        self.extended_n = 1 << self.extended_k

        self.omega = FR.nth_root_of_unity(k)
        self.omega_inv = FR.inv(self.omega)
        self.extended_omega = FR.nth_root_of_unity(self.extended_k)
        self.extended_omega_inv = FR.inv(self.extended_omega)
        self.g_coset = FR.zeta            # order 3
        self.g_coset_inv = FR.mul(FR.zeta, FR.zeta)

    def eval_vanishing(self, x: int) -> int:
        return (pow(x, self.n, FR.p) - 1) % FR.p

    def l_i_range(self, x: int, rotations) -> dict[int, int]:
        """l_{i}(x) for i in `rotations` (may be negative, mod n).

        l_i(x) = omega^i/n * (x^n - 1)/(x - omega^i).
        """
        xn1 = self.eval_vanishing(x)
        idxs = [r % self.n for r in rotations]
        denoms = [(x - pow(self.omega, i, FR.p)) % FR.p for i in idxs]
        dinv = batch_inv(denoms, FR.p)
        n_inv = FR.inv(self.n)
        out = {}
        for r, i, d in zip(rotations, idxs, dinv):
            out[r] = pow(self.omega, i, FR.p) * n_inv % FR.p * xn1 % FR.p * d % FR.p
        return out

    def rotate_point(self, x: int, rotation: int) -> int:
        if rotation >= 0:
            return x * pow(self.omega, rotation, FR.p) % FR.p
        return x * pow(self.omega_inv, -rotation, FR.p) % FR.p


@functools.cache
def get_host_domain(k: int, degree: int) -> HostDomain:
    return HostDomain(k, degree)
