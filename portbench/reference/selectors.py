"""Simple-selector compression (halo2's `compress_selectors`, SURVEY.md:130).

halo2's keygen packs boolean "simple" selector columns into combined fixed
columns: a combination of k selectors with pairwise-disjoint activations
becomes ONE column holding value q (1-based position) on rows where selector
q-1 is enabled and 0 elsewhere; each member's query is replaced by the
degree-k interpolation polynomial that is 1 exactly on its own value and 0 on
every other value the column takes. This removes (k-1) fixed commitments per
combination from the vk, (k-1) fixed evaluations from every proof, and the
matching EVM verifier gas — without raising the circuit's constraint degree
(combinations are sized against the pre-compression degree bound).

A selector is compressible iff it is boolean-valued, queried only at
rotation 0, absent from every lookup expression (halo2's simple-vs-complex
distinction), not a table/constants column, and not under equality.

The compression is deterministic from the ConstraintSystem + activations, so
keys reconstructed from circuit params (models/keys_io.py) agree with the
originals. The prover re-applies the recorded layout to freshly synthesized
fixed columns via :func:`apply_to_fixed`.

Frozen copy of ``zerog_tpu_torch/plonk/selectors.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .field import FR
from .cs import ConstraintSystem
from .expression import (
    Constant, Expr, FixedQuery, Product, Scaled, Sum, collect_queries, degree,
)

__all__ = [
    "SelectorCompression", "compress_selectors_pass", "apply_layout_to_cs",
    "apply_to_fixed",
]


@dataclasses.dataclass(frozen=True)
class SelectorCompression:
    """Recorded layout transform from the synthesis-time fixed columns to the
    compressed key layout: `keep[i]` = original index of new column i; each
    `combos[j]` lists the original selector columns packed into new column
    len(keep)+j, in value order (member q holds value q+1)."""

    keep: tuple[int, ...]
    combos: tuple[tuple[int, ...], ...]


def _substitute_fixed(e: Expr, mapping: dict[int, "Expr | int"]) -> Expr:
    """Rebuild `e` with every FixedQuery(col, rot) replaced: int mapping
    values reindex the column; Expr values substitute (rotation must be 0)."""
    if isinstance(e, FixedQuery):
        target = mapping[e.column]
        if isinstance(target, int):
            return FixedQuery(target, e.rotation)
        assert e.rotation == 0, "compressed selector queried at a rotation"
        return target
    if isinstance(e, Sum):
        return Sum(_substitute_fixed(e.a, mapping), _substitute_fixed(e.b, mapping))
    if isinstance(e, Product):
        return Product(_substitute_fixed(e.a, mapping), _substitute_fixed(e.b, mapping))
    if isinstance(e, Scaled):
        return Scaled(_substitute_fixed(e.a, mapping), e.scalar)
    return e


def _selector_expr(new_col: int, value: int, k: int) -> Expr:
    """Interpolation polynomial over the combination column: 1 when the
    column equals `value`, 0 on every other value in {0, 1, .., k}."""
    q = FixedQuery(new_col, 0)
    expr: Expr | None = None
    norm = 1
    for w in range(k + 1):
        if w == value:
            continue
        factor = Sum(q, Constant((-w) % FR.p))
        expr = factor if expr is None else Product(expr, factor)
        norm = norm * (value - w) % FR.p
    return Scaled(expr, pow(norm, -1, FR.p))


def compress_selectors_pass(cs: ConstraintSystem, assignment) -> None:
    """Keygen entry point: choose a compression layout from the selector
    activations, rewrite `cs` into it, and transform the assignment's fixed
    columns and copy cells to match."""
    info = _choose_layout(cs, assignment)
    apply_layout_to_cs(cs, info)
    assignment.fixed = apply_to_fixed(info, assignment.fixed, assignment.n)
    new_index = {orig: i for i, orig in enumerate(info.keep)}
    assignment.copies = [
        tuple(
            (kind, new_index[col], row) if kind == "fixed" else (kind, col, row)
            for kind, col, row in pair
        )
        for pair in assignment.copies
    ]


def _choose_layout(cs: ConstraintSystem, assignment) -> SelectorCompression:
    """Greedy grouping of compressible selectors (halo2's algorithm shape):
    disjoint activations, and every member keeps len(combo) + inner_degree
    <= the pre-compression degree bound."""
    lookup_fixed: set[int] = set()
    for _, pairs in cs.lookups:
        for inp, tab in pairs:
            for kind, col, _ in collect_queries(inp) | collect_queries(tab):
                if kind == "fixed":
                    lookup_fixed.add(col)
    perm_fixed = {c.index for c in cs.permutation_columns if c.kind == "fixed"}
    const_col = cs.constants_column.index if cs.constants_column else None

    # gate occurrences: fixed col -> (rotations, max inner degree)
    occurrences: dict[int, list] = {}
    for _, polys in cs.gates:
        for poly in polys:
            for kind, col, rot in collect_queries(poly):
                if kind != "fixed":
                    continue
                inner = degree(_substitute_fixed(poly, _SubstOne(col)))
                rots, d = occurrences.get(col, (set(), 0))
                occurrences[col] = (rots | {rot}, max(d, inner))

    def boolean(col: int) -> bool:
        vals = assignment.fixed[col]
        return all(int(v) in (0, 1) for v in vals)

    candidates = []
    for col in sorted(cs.selector_fixed):
        if col in lookup_fixed or col in perm_fixed or col in cs.table_fixed:
            continue
        if col == const_col:
            continue
        rots, inner = occurrences.get(col, ({0}, 0))
        if rots != {0}:
            continue
        if not boolean(col):
            continue
        # apply_to_fixed packs activations over ALL n rows, but disjointness
        # below is judged on [:usable] — a selector active in the blinding
        # region could silently overwrite a combo partner there, so such
        # columns (none in practice: regions lay out inside usable rows)
        # stay uncompressed.
        if any(int(v) for v in assignment.fixed[col][assignment.usable:]):
            continue
        candidates.append((col, inner))

    if not candidates:
        return SelectorCompression((*range(cs.num_fixed),), ())

    cap = cs.degree()
    usable = assignment.usable
    # greedy pack: largest inner degree first; a selector joins the first
    # combination where activations stay disjoint and every member keeps
    # len(combo) + inner_degree <= cap
    candidates.sort(key=lambda t: -t[1])
    combos: list[dict] = []  # {cols: [..], inners: [..], act: bool array}
    for col, inner in candidates:
        act = np.asarray([bool(int(v)) for v in assignment.fixed[col][:usable]])
        placed = False
        for combo in combos:
            k = len(combo["cols"]) + 1
            if any(k + d > cap for d in combo["inners"] + [inner]):
                continue
            if np.any(combo["act"] & act):
                continue
            combo["cols"].append(col)
            combo["inners"].append(inner)
            combo["act"] |= act
            placed = True
            break
        if not placed:
            combos.append({"cols": [col], "inners": [inner], "act": act.copy()})

    compressed = {c for combo in combos for c in combo["cols"]}
    keep = tuple(i for i in range(cs.num_fixed) if i not in compressed)
    return SelectorCompression(keep, tuple(tuple(c["cols"]) for c in combos))


def apply_layout_to_cs(cs: ConstraintSystem, info: SelectorCompression) -> None:
    """Rewrite `cs` into the compressed layout described by `info` (pure
    substitution/reindex — no activations needed, so deserialized keys can
    rebuild the exact compressed CS from circuit params + the stored
    layout; models/keys_io.py)."""
    if cs.compression is not None:
        raise ValueError("constraint system already compressed")
    new_index = {orig: i for i, orig in enumerate(info.keep)}
    compressed = {c for combo in info.combos for c in combo}

    mapping: dict[int, Expr | int] = dict(new_index)
    for j, cols in enumerate(info.combos):
        new_col = len(info.keep) + j
        k = len(cols)
        for q, orig in enumerate(cols):
            mapping[orig] = _selector_expr(new_col, q + 1, k)

    cs.gates = [
        (name, [_substitute_fixed(p, mapping) for p in polys])
        for name, polys in cs.gates
    ]
    cs.lookups = [
        (name, [(_substitute_fixed(i, mapping), _substitute_fixed(t, mapping))
                for i, t in pairs])
        for name, pairs in cs.lookups
    ]
    cs.table_fixed = {new_index[c] for c in cs.table_fixed}
    cs.selector_fixed = {new_index[c] for c in cs.selector_fixed
                         if c not in compressed}
    if cs.constants_column is not None:
        from .cs import Column

        cs.constants_column = Column("fixed", new_index[cs.constants_column.index])
    cs.permutation_columns = [
        c if c.kind != "fixed" else type(c)("fixed", new_index[c.index])
        for c in cs.permutation_columns
    ]
    cs.num_fixed = len(info.keep) + len(info.combos)
    cs.compression = info


class _SubstOne(dict):
    """Substitution map replacing ONE fixed column's query with Constant(1)
    (for inner-degree computation) and reindexing every other column to
    itself."""

    def __init__(self, target):
        super().__init__()
        self._target = target

    def __missing__(self, col):
        return Constant(1) if col == self._target else col


def apply_to_fixed(info: SelectorCompression, fixed_cols, n: int):
    """Transform freshly synthesized fixed columns (original layout) into the
    compressed layout recorded at keygen (the prover-side counterpart)."""
    out = [fixed_cols[i] for i in info.keep]
    for cols in info.combos:
        col_vals = np.zeros(n, dtype=object)
        for q, orig in enumerate(cols):
            vals = np.asarray([int(v) for v in fixed_cols[orig]])
            col_vals[np.nonzero(vals)[0]] = q + 1
        out.append(col_vals)
    return out
