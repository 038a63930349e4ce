"""halo2's pinned-verification-key digest, reimplemented byte-for-byte.

halo2's `VerifyingKey::from_parts` (halo2_proofs v2023_04_20, consumed by the
reference at src/wnn.rs:226 via keygen_vk) computes the transcript
representation as

    let s = format!("{:?}", vk.pinned());
    hasher.update(&(s.len() as u64).to_le_bytes());
    hasher.update(s.as_bytes());
    transcript_repr = Fr::from_uniform_bytes(blake2b-512(s, person=b"Halo2-Verify-Key"))

where `vk.pinned()` is the `PinnedVerificationKey` struct whose DERIVED Debug
output is a stable single-line text format. This module renders that text
from this repo's VerifyingKey and hashes it identically, closing PARITY.md #1
at the FORMAT level: the grammar below mirrors Rust's `{:?}` for every type
that appears (derived struct/tuple/list debug, halo2's custom Expression and
column-type Debug impls, halo2curves' `(0x.., 0x..)` affine point Debug and
64-hex-digit field Debug). Residual risk is inventoried in PARITY.md: it is
structural (does our CS contain byte-identical expression trees / query
orders to halo2's for the same circuit — PARITY #6/#7), not format-level.

Rendering rules (Rust `{:?}`, non-alternate):
- derived struct   -> `Name { field: v, field2: v2 }`
- derived tuple    -> `Name(v1, v2)`; plain tuples `(a, b)`
- Vec              -> `[a, b]`, empty `[]`
- &str             -> `"..."`
- u32/usize/i32    -> decimal
- Option           -> `None` / `Some(v)`
- Fq / Fr          -> `0x` + 64 lowercase hex digits (canonical, BE)
- G1Affine         -> `(x, y)` with field Debug coords, identity `Infinity`
- Expression       -> halo2's custom impl: `Constant(..)`, `Fixed { query_index,
                      column_index, rotation }`, `Advice { .. }` (phase 0
                      omitted), `Instance { .. }`, `Negated(..)`, `Sum(.., ..)`,
                      `Product(.., ..)`, `Scaled(.., 0x..)`
- Column<T>        -> `Column { index: N, column_type: Advice|Fixed|Instance }`
- Rotation         -> `Rotation(N)`

Frozen copy of ``zerog_tpu_torch/plonk/pinned.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import hashlib

from .field import FR, FQ
from .expression import (
    AdviceQuery, Constant, Expr, FixedQuery, InstanceQuery, Product, Scaled,
    Sum,
)

__all__ = ["pinned_text", "transcript_repr_from_pinned"]

# halo2curves bn256 modulus strings (Fq::MODULUS / Fr::MODULUS)
_BASE_MODULUS = (
    "0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47"
)
_SCALAR_MODULUS = (
    "0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001"
)

_KIND_NAME = {"advice": "Advice", "fixed": "Fixed", "instance": "Instance"}


def _fe(v: int, p: int = FR.p) -> str:
    """Field element Debug: 0x + 64 lowercase hex digits of the canonical
    value (halo2curves prints to_repr() bytes reversed = big-endian)."""
    return f"0x{v % p:064x}"


def _point(pt) -> str:
    """halo2curves affine Debug: `(x, y)` with Fq Debug coords; identity
    prints `Infinity`."""
    if pt is None:
        return "Infinity"
    return f"({_fe(pt[0], FQ.p)}, {_fe(pt[1], FQ.p)})"


def _column(kind: str, index: int) -> str:
    return f"Column {{ index: {index}, column_type: {_KIND_NAME[kind]} }}"


def _expr(e: Expr, qidx) -> str:
    """halo2's custom Expression Debug. `qidx` maps ("advice"|"fixed"|
    "instance", column, rotation) -> query index."""
    if isinstance(e, Constant):
        return f"Constant({_fe(e.value)})"
    if isinstance(e, FixedQuery):
        qi = qidx[("fixed", e.column, e.rotation)]
        return (f"Fixed {{ query_index: {qi}, column_index: {e.column}, "
                f"rotation: Rotation({e.rotation}) }}")
    if isinstance(e, AdviceQuery):
        qi = qidx[("advice", e.column, e.rotation)]
        return (f"Advice {{ query_index: {qi}, column_index: {e.column}, "
                f"rotation: Rotation({e.rotation}) }}")
    if isinstance(e, InstanceQuery):
        qi = qidx[("instance", e.column, e.rotation)]
        return (f"Instance {{ query_index: {qi}, column_index: {e.column}, "
                f"rotation: Rotation({e.rotation}) }}")
    if isinstance(e, Sum):
        return f"Sum({_expr(e.a, qidx)}, {_expr(e.b, qidx)})"
    if isinstance(e, Product):
        return f"Product({_expr(e.a, qidx)}, {_expr(e.b, qidx)})"
    if isinstance(e, Scaled):
        # Rust `-expr` builds Negated; our IR canonicalizes it to
        # Scaled(expr, -1). Render the operator form Rust would print.
        if e.scalar % FR.p == FR.p - 1:
            return f"Negated({_expr(e.a, qidx)})"
        return f"Scaled({_expr(e.a, qidx)}, {_fe(e.scalar)})"
    raise TypeError(e)


def _queries(pairs, kind: str) -> str:
    items = ", ".join(
        f"({_column(kind, col)}, Rotation({rot}))" for col, rot in pairs)
    return f"[{items}]"


def pinned_text(vk, domain) -> str:
    """Render `format!("{:?}", vk.pinned())` for this verifying key."""
    cs = vk.cs
    aq = cs.advice_queries()
    fq = cs.fixed_queries()
    iq = cs.instance_queries()
    qidx = {}
    for kind, lst in (("advice", aq), ("fixed", fq), ("instance", iq)):
        for i, (col, rot) in enumerate(lst):
            qidx[(kind, col, rot)] = i

    gates = ", ".join(
        _expr(p, qidx) for _, polys in cs.gates for p in polys)
    lookups = ", ".join(
        "([" + ", ".join(_expr(i, qidx) for i, _ in pairs) + "], ["
        + ", ".join(_expr(t, qidx) for _, t in pairs) + "])"
        for _, pairs in cs.lookups)
    perm_cols = ", ".join(
        _column(c.kind, c.index) for c in cs.permutation_columns)
    constants = (
        f"[{_column('fixed', cs.constants_column.index)}]"
        if cs.constants_column is not None else "[]")

    cs_text = (
        "PinnedConstraintSystem { "
        f"num_fixed_columns: {cs.num_fixed}, "
        f"num_advice_columns: {cs.num_advice}, "
        f"num_instance_columns: {cs.num_instance}, "
        f"num_selectors: {cs.num_selectors}, "
        f"gates: [{gates}], "
        f"advice_queries: {_queries(aq, 'advice')}, "
        f"instance_queries: {_queries(iq, 'instance')}, "
        f"fixed_queries: {_queries(fq, 'fixed')}, "
        f"permutation: Argument {{ columns: [{perm_cols}] }}, "
        f"lookups: [{lookups}], "
        f"constants: {constants}, "
        "minimum_degree: None }"
    )

    domain_text = (
        "PinnedEvaluationDomain { "
        f"k: {domain.k}, extended_k: {domain.extended_k}, "
        f"omega: {_fe(domain.omega)} }}"
    )

    fixed_coms = ", ".join(_point(pt) for pt in vk.fixed_commitments)
    perm_coms = ", ".join(_point(pt) for pt in vk.permutation_commitments)

    return (
        "PinnedVerificationKey { "
        f'base_modulus: "{_BASE_MODULUS}", '
        f'scalar_modulus: "{_SCALAR_MODULUS}", '
        f"domain: {domain_text}, "
        f"cs: {cs_text}, "
        f"fixed_commitments: [{fixed_coms}], "
        f"permutation: VerifyingKey {{ commitments: [{perm_coms}] }} }}"
    )


def transcript_repr_from_pinned(vk, domain) -> int:
    """halo2's `VerifyingKey::from_parts` hash: blake2b-512 with personal
    `Halo2-Verify-Key` over `(len as u64 LE) || pinned_text`, wide-reduced
    into Fr (from_uniform_bytes = 64 LE bytes mod r)."""
    s = pinned_text(vk, domain).encode()
    h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
    h.update(len(s).to_bytes(8, "little"))
    h.update(s)
    return int.from_bytes(h.digest(), "little") % FR.p
