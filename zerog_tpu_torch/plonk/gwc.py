"""GWC19 multi-open for KZG: group openings by point, batch with challenge v,
one witness commitment per point, pairing check batched with challenge u.

Counterpart of ``zerog_tpu/plonk/gwc.py`` (halo2's `ProverGWC` /
`VerifierGWC` + `SingleStrategy`).
"""

from __future__ import annotations

import dataclasses
import numpy as np

from ..field import FR
from ..curve.bn254 import g1_add, g1_mul, g1_neg, G1_GEN, pairing_product_is_one

__all__ = ["ProverQuery", "VerifierQuery", "multiopen_prove", "multiopen_verify"]


@dataclasses.dataclass
class ProverQuery:
    poly: np.ndarray     # coefficient form, object [<= n]
    rotation: int        # opening point = x * omega^rotation


@dataclasses.dataclass
class VerifierQuery:
    commitment: object   # G1 point (or a list of (point, scalar) pairs to combine)
    rotation: int
    eval: int


def _group_rotations(queries):
    order = []
    groups = {}
    for i, q in enumerate(queries):
        if q.rotation not in groups:
            groups[q.rotation] = []
            order.append(q.rotation)
        groups[q.rotation].append(i)
    return [(rot, groups[rot]) for rot in order]


def _synthetic_div(coeffs, z: int):
    """(p(X) - p(z)) / (X - z): returns quotient coeffs (len-1)."""
    p = FR.p
    n = len(coeffs)
    q = [0] * (n - 1)
    acc = 0
    for i in range(n - 1, 0, -1):
        acc = (acc * z + int(coeffs[i])) % p
        q[i - 1] = acc
    return q


def multiopen_prove(queries, x: int, domain, srs, transcript):
    """Write one witness commitment per distinct opening point (host path;
    kept for reference and small tests — create_proof uses the device path)."""
    v = transcript.squeeze_challenge()
    p = FR.p
    n = srs.n
    for rot, idxs in _group_rotations(queries):
        z = domain.rotate_point(x, rot)
        combined = np.zeros(n, dtype=object)
        for i in idxs:
            poly = queries[i].poly
            combined = (combined * v) % p
            combined[: len(poly)] = (combined[: len(poly)] + poly) % p
        q = _synthetic_div(combined, z)
        w = srs.commit(q)
        transcript.write_point(w)


@dataclasses.dataclass
class DeviceQuery:
    row: int             # row index into the prover's Lagrange stack
    rotation: int
    eval: int            # p(x * w^rotation), already written to the transcript


def _v_fold_device(stack, v: int):
    """Horner-combine [C, n, 16] mont Lagrange rows with challenge v:
    out = sum_j v^(C-1-j) * row_j (row 0 highest power, like the verifier's
    c_batch fold)."""
    from ..field import jfr, to_limbs, to_device

    f = jfr()
    v_limbs = to_device(to_limbs(v, FR, mont=True), stack.device)
    acc = stack[0]
    for j in range(1, stack.shape[0]):
        acc = f.add(f.mul(acc, v_limbs), stack[j])
    return acc


def multiopen_prove_device(queries, lag_stack, x: int, domain, srs, transcript):
    """GWC prove with tensor algebra: per rotation group, v-fold the queried
    Lagrange rows, Kate-divide on the evaluation domain (elementwise, using
    batched (z - w^i)^-1), and commit the witness in the Lagrange basis.

    Replaces the host synthetic division (`_synthetic_div`) — the quotient
    (p(X) - p(z))/(X - z) has degree n-2, so its Lagrange values
    (v_i - e) * (w^i - z)^-1 determine it exactly.

    queries: list of DeviceQuery (order defines the group order — must match
    the verifier); lag_stack: [C, n, 16] mont Lagrange values.
    """
    import torch

    from ..field import to_device
    from ..poly.eval import domain_inverses, kate_quotient_lagrange

    v = transcript.squeeze_challenge()
    p = FR.p
    groups = _group_rotations(queries)
    rots = [rot for rot, _ in groups]
    zs = [domain.rotate_point(x, rot) for rot in rots]
    dinv, _ = domain_inverses(domain.k, zs, lag_stack.device)
    qs = []
    for gi, (rot, idxs) in enumerate(groups):
        rows = lag_stack[to_device([queries[i].row for i in idxs],
                                   lag_stack.device)]
        combined = _v_fold_device(rows, v)
        e = 0
        for i in idxs:
            e = (e * v + queries[i].eval) % p
        qs.append(kate_quotient_lagrange(combined, e, dinv[gi]))
    ws = srs.commit_lagrange_dev(torch.stack(qs))
    for w in ws:
        transcript.write_point(w)


def multiopen_verify(queries, x: int, domain, g2, s_g2, transcript) -> bool:
    """Read witness commitments, batch the pairing check."""
    v = transcript.squeeze_challenge()
    p = FR.p
    groups = _group_rotations(queries)
    ws = [transcript.read_point() for _ in groups]
    u = transcript.squeeze_challenge()

    # e(sum u^i W_i, s_g2) == e(sum u^i (z_i W_i + C_i - e_i G), g2)
    left = None
    right = None
    for (rot, idxs), w in zip(groups, ws):
        z = domain.rotate_point(x, rot)
        c_batch = None
        e_batch = 0
        for i in idxs:
            q = queries[i]
            c_batch = g1_mul(c_batch, v) if c_batch is not None else None
            e_batch = e_batch * v % p
            com = q.commitment
            if isinstance(com, list):
                pt = None
                for base, scalar in com:
                    pt = g1_add(pt, g1_mul(base, scalar))
                com = pt
            c_batch = g1_add(c_batch, com)
            e_batch = (e_batch + q.eval) % p
        term = g1_add(g1_mul(w, z), g1_add(c_batch, g1_neg(g1_mul(G1_GEN, e_batch))))
        left = g1_add(g1_mul(left, u) if left is not None else None, w)
        right = g1_add(g1_mul(right, u) if right is not None else None, term)

    return pairing_product_is_one([(left, s_g2), (g1_neg(right), g2)])
