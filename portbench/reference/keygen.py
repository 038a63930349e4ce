"""The verifying key, worked out again from the circuit: synthesized with a
zero image as keygen does, selectors compressed, the permutation's sigma
columns built, and every fixed and sigma column committed as [f(tau)]G1 with
the SRS's trapdoor tau (f in the Lagrange basis, so f(tau) = sum f_i L_i(tau)).

``build_sigmas`` and ``VerifyingKey`` are frozen copies from
``zerog_tpu_torch/plonk/keygen.py``, taken when the benchmark was defined.
"""

from __future__ import annotations

import numpy as np

from .assignment import Assignment
from .bn254 import G1_GEN, g1_mul
from .cs import ConstraintSystem
from .domain import get_host_domain
from .field import FR, batch_inv
from .pinned import transcript_repr_from_pinned
from .selectors import compress_selectors_pass

__all__ = ["VerifyingKey", "build_sigmas", "lagrange_at", "verifying_key"]


class VerifyingKey:
    def __init__(self, k, cs, fixed_commitments, permutation_commitments):
        self.k = k
        self.n = 1 << k
        self.cs = cs
        self.fixed_commitments = fixed_commitments
        self.permutation_commitments = permutation_commitments
        self.transcript_repr = transcript_repr_from_pinned(
            self, get_host_domain(k, cs.degree()))


def build_sigmas(cs: ConstraintSystem, assignment: Assignment, n: int):
    """Returns sigma value columns (list per permutation column, object [n])."""
    perm_cols = cs.permutation_columns
    col_pos = {(c.kind, c.index): j for j, c in enumerate(perm_cols)}
    m = len(perm_cols)

    # mapping as successor pointers, packed j * n + i
    mapping = np.arange(m * n, dtype=np.int64)
    parent = np.arange(m * n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    def cell_index(cell):
        kind, col, row = cell
        j = col_pos.get((kind, col))
        if j is None:
            raise ValueError(
                f"copy constraint touches column ({kind}, {col}) without "
                f"equality enabled"
            )
        if row >= n:
            raise ValueError(f"copy constraint row {row} out of range")
        return j * n + row

    for a, b in assignment.copies:
        ia, ib = cell_index(a), cell_index(b)
        ra, rb = find(ia), find(ib)
        if ra == rb:
            continue
        parent[ra] = rb
        mapping[ia], mapping[ib] = mapping[ib], mapping[ia]

    # id(j, i) = delta^j * omega^i
    omega = FR.nth_root_of_unity(int(n).bit_length() - 1)
    omega_pows = np.empty(n, dtype=object)
    cur = 1
    for i in range(n):
        omega_pows[i] = cur
        cur = cur * omega % FR.p
    deltas = [pow(FR.delta, j, FR.p) for j in range(m)]

    sigmas = []
    for j in range(m):
        tgt = mapping[j * n : (j + 1) * n]
        tj = tgt // n
        ti = tgt % n
        col_vals = omega_pows[ti].copy()
        for jj in range(m):
            mask = tj == jj
            if mask.any():
                col_vals[mask] = (col_vals[mask] * deltas[jj]) % FR.p
        sigmas.append(col_vals)
    return sigmas


def lagrange_at(k: int, tau: int) -> np.ndarray:
    """L_i(tau) for i < 2^k, object [n]: omega^i/n (tau^n - 1)/(tau - omega^i)."""
    p = FR.p
    n = 1 << k
    omega = FR.nth_root_of_unity(k)
    wpows = [1] * n
    for i in range(1, n):
        wpows[i] = wpows[i - 1] * omega % p
    scale = (pow(tau, n, p) - 1) * FR.inv(n) % p
    dinv = batch_inv([(tau - w) % p for w in wpows], p)
    return np.array([w * scale % p * d % p for w, d in zip(wpows, dinv)],
                    dtype=object)


def commit_at_tau(values, lagrange) -> tuple:
    """[sum_i values_i L_i(tau)] G1 of one column in the Lagrange basis."""
    col = np.asarray(values, dtype=object)
    return g1_mul(G1_GEN, int(np.dot(col, lagrange[:len(col)])) % FR.p)


def verifying_key(circuit, k: int, tau: int) -> VerifyingKey:
    """The key of `circuit` (synthesized as given: keygen's zero image)."""
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    n = 1 << k
    assignment = Assignment(cs, n)
    circuit.synthesize(config, assignment)
    assignment.finalize_tables()
    compress_selectors_pass(cs, assignment)
    sigmas = build_sigmas(cs, assignment, n)
    lag = lagrange_at(k, tau)
    return VerifyingKey(k, cs, [commit_at_tau(c, lag) for c in assignment.fixed],
                        [commit_at_tau(s, lag) for s in sigmas])
