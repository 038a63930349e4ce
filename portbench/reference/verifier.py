"""The proof's check: halo2's `verify_proof` with `VerifierGWC` and
`SingleStrategy` over the Keccak transcript, the instance evaluations worked
out from the public scores.

Frozen copy of ``zerog_tpu_torch/plonk/verifier.py`` and of
``multiopen_verify`` of ``zerog_tpu_torch/plonk/gwc.py``, taken when the
benchmark was defined. One change: the benchmark made the SRS from a seed and
knows its trapdoor tau, so the closing pairing check is made in G1 by one
product with tau.
"""

from __future__ import annotations

import dataclasses

from .bn254 import G1_GEN, g1_add, g1_mul, g1_neg
from .domain import get_host_domain
from .expression import evaluate
from .field import FR
from .keygen import VerifyingKey
from .transcript import KeccakTranscriptReader

__all__ = ["verify_proof"]


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


def multiopen_verify(queries, x: int, domain, tau: int, transcript) -> bool:
    """Read witness commitments and batch the opening check. With the
    trapdoor tau known, the pairing check e(left, [tau]G2) = e(right, G2)
    is the check [tau] left = right in G1."""
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

    return g1_mul(left, tau) == right


class _EvalOps:
    """Expression evaluation at the point x, given transcript evals."""

    def __init__(self, advice_evals, fixed_evals, instance_evals,
                 advice_idx, fixed_idx, instance_idx):
        self.advice_evals = advice_evals
        self.fixed_evals = fixed_evals
        self.instance_evals = instance_evals
        self.advice_idx = advice_idx
        self.fixed_idx = fixed_idx
        self.instance_idx = instance_idx
        self.p = FR.p

    def constant(self, c):
        return c % self.p

    def fixed(self, col, rot):
        return self.fixed_evals[self.fixed_idx[(col, rot)]]

    def advice(self, col, rot):
        return self.advice_evals[self.advice_idx[(col, rot)]]

    def instance(self, col, rot):
        return self.instance_evals[self.instance_idx[(col, rot)]]

    def add(self, a, b):
        return (a + b) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def scale(self, a, s):
        return a * (s % self.p) % self.p


def verify_proof(vk: VerifyingKey, tau: int, instances, proof: bytes) -> bool:
    cs = vk.cs
    k = vk.k
    n = 1 << k
    p = FR.p
    domain = get_host_domain(k, cs.degree())
    bf = cs.blinding_factors()
    u = cs.usable_rows(n)
    tr = KeccakTranscriptReader(proof)

    for col_vals in instances:
        if len(col_vals) > u:
            raise ValueError("instance too long")
    tr.common_scalar(vk.transcript_repr)
    for col_vals in instances:
        for v in col_vals:
            tr.common_scalar(int(v) % p)

    advice_coms = [tr.read_point() for _ in range(cs.num_advice)]
    theta = tr.squeeze_challenge()

    lookup_perm_coms = []
    for _ in cs.lookups:
        a_com = tr.read_point()
        s_com = tr.read_point()
        lookup_perm_coms.append((a_com, s_com))

    beta = tr.squeeze_challenge()
    gamma = tr.squeeze_challenge()

    num_chunks = cs.num_permutation_chunks() if cs.permutation_columns else 0
    perm_z_coms = [tr.read_point() for _ in range(num_chunks)]
    lookup_z_coms = [tr.read_point() for _ in cs.lookups]

    random_com = tr.read_point()
    y = tr.squeeze_challenge()

    h_coms = [tr.read_point() for _ in range(domain.quotient_poly_degree)]
    x = tr.squeeze_challenge()

    advice_queries = cs.advice_queries()
    fixed_queries = cs.fixed_queries()
    instance_queries = cs.instance_queries()

    advice_evals = [tr.read_scalar() for _ in advice_queries]
    fixed_evals = [tr.read_scalar() for _ in fixed_queries]
    random_eval = tr.read_scalar()
    sigma_evals = [tr.read_scalar() for _ in cs.permutation_columns]
    perm_z_evals = []
    for _ in range(num_chunks):
        z_x = tr.read_scalar()
        z_xn = tr.read_scalar()
        perm_z_evals.append([z_x, z_xn, None])
    for i in range(num_chunks - 2, -1, -1):
        perm_z_evals[i][2] = tr.read_scalar()
    lookup_evals = []
    for _ in cs.lookups:
        lookup_evals.append(dict(
            z=tr.read_scalar(), z_next=tr.read_scalar(),
            a_perm=tr.read_scalar(), a_perm_prev=tr.read_scalar(),
            s_perm=tr.read_scalar(),
        ))

    # ---- instance evaluations (computed, not read) -----------------------
    instance_evals = []
    for col, rot in instance_queries:
        pt = domain.rotate_point(x, rot)
        vals = instances[col] if col < len(instances) else []
        lis = domain.l_i_range(pt, range(len(vals))) if len(vals) else {}
        acc = 0
        for i, v in enumerate(vals):
            acc = (acc + int(v) * lis[i]) % p
        instance_evals.append(acc)

    advice_idx = {q: i for i, q in enumerate(advice_queries)}
    fixed_idx = {q: i for i, q in enumerate(fixed_queries)}
    instance_idx = {q: i for i, q in enumerate(instance_queries)}
    ops = _EvalOps(advice_evals, fixed_evals, instance_evals,
                   advice_idx, fixed_idx, instance_idx)

    # lagrange helpers at x
    lis = domain.l_i_range(x, [0, u] + list(range(u + 1, n)))
    l0 = lis[0]
    l_last = lis[u]
    l_blind = sum(lis[i] for i in range(u + 1, n)) % p
    l_active = (1 - l_last - l_blind) % p

    # ---- fold constraint terms with y (same order as prover) -------------
    terms = []
    for _, polys in cs.gates:
        for poly in polys:
            terms.append(evaluate(poly, ops))

    def column_eval(col):
        if col.kind == "advice":
            return advice_evals[advice_idx[(col.index, 0)]]
        if col.kind == "fixed":
            return fixed_evals[fixed_idx[(col.index, 0)]]
        return instance_evals[instance_idx[(col.index, 0)]]

    if cs.permutation_columns:
        chunk = cs.permutation_chunk_len()
        terms.append(l0 * (1 - perm_z_evals[0][0]) % p)
        zl = perm_z_evals[-1][0]
        terms.append(l_last * (zl * zl - zl) % p)
        for i in range(1, num_chunks):
            terms.append(l0 * (perm_z_evals[i][0] - perm_z_evals[i - 1][2]) % p)
        for si, start in enumerate(range(0, len(cs.permutation_columns), chunk)):
            cols = cs.permutation_columns[start : start + chunk]
            left = perm_z_evals[si][1]
            right = perm_z_evals[si][0]
            for j, col in enumerate(cols, start=start):
                ve = column_eval(col)
                left = left * ((ve + beta * sigma_evals[j] + gamma) % p) % p
                right = right * ((ve + beta * pow(FR.delta, j, p) % p * x + gamma) % p) % p
            terms.append(l_active * (left - right) % p)

    for li, (_, pairs) in enumerate(cs.lookups):
        ev = lookup_evals[li]
        a_comp = 0
        for i_expr, _ in pairs:
            a_comp = (a_comp * theta + evaluate(i_expr, ops)) % p
        s_comp = 0
        for _, t_expr in pairs:
            s_comp = (s_comp * theta + evaluate(t_expr, ops)) % p
        terms.append(l0 * (1 - ev["z"]) % p)
        terms.append(l_last * (ev["z"] * ev["z"] - ev["z"]) % p)
        lhs = ev["z_next"] * ((ev["a_perm"] + beta) % p) % p * ((ev["s_perm"] + gamma) % p) % p
        rhs = ev["z"] * ((a_comp + beta) % p) % p * ((s_comp + gamma) % p) % p
        terms.append(l_active * (lhs - rhs) % p)
        terms.append(l0 * (ev["a_perm"] - ev["s_perm"]) % p)
        terms.append(
            l_active * ((ev["a_perm"] - ev["s_perm"]) % p) % p
            * ((ev["a_perm"] - ev["a_perm_prev"]) % p) % p
        )

    folded = 0
    for t in terms:
        folded = (folded * y + t) % p
    xn = pow(x, n, p)
    vanishing_eval = (xn - 1) % p
    h_eval = folded * pow(vanishing_eval, -1, p) % p

    # ---- multiopen queries (same order as prover) ------------------------
    queries = []
    for qi, (col, rot) in enumerate(advice_queries):
        queries.append(VerifierQuery(advice_coms[col], rot, advice_evals[qi]))
    for i in range(num_chunks):
        queries.append(VerifierQuery(perm_z_coms[i], 0, perm_z_evals[i][0]))
        queries.append(VerifierQuery(perm_z_coms[i], 1, perm_z_evals[i][1]))
    for i in range(num_chunks - 2, -1, -1):
        queries.append(VerifierQuery(perm_z_coms[i], -(bf + 1), perm_z_evals[i][2]))
    for i in range(len(cs.lookups)):
        ev = lookup_evals[i]
        a_com, s_com = lookup_perm_coms[i]
        queries.append(VerifierQuery(lookup_z_coms[i], 0, ev["z"]))
        queries.append(VerifierQuery(a_com, 0, ev["a_perm"]))
        queries.append(VerifierQuery(s_com, 0, ev["s_perm"]))
        queries.append(VerifierQuery(a_com, -1, ev["a_perm_prev"]))
        queries.append(VerifierQuery(lookup_z_coms[i], 1, ev["z_next"]))
    for qi, (col, rot) in enumerate(fixed_queries):
        queries.append(VerifierQuery(vk.fixed_commitments[col], rot, fixed_evals[qi]))
    for j in range(len(cs.permutation_columns)):
        queries.append(VerifierQuery(vk.permutation_commitments[j], 0, sigma_evals[j]))
    h_combined = [(h_coms[i], pow(xn, i, p)) for i in range(len(h_coms))]
    queries.append(VerifierQuery(h_combined, 0, h_eval))
    queries.append(VerifierQuery(random_com, 0, random_eval))

    ok = multiopen_verify(queries, x, domain, tau, tr)
    if not ok:
        raise ValueError("proof verification failed: opening check")
    if not tr.finished():
        raise ValueError("trailing bytes in proof")
    return True
