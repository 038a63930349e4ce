"""PLONKish constraint system: columns, gates, lookups, permutation bookkeeping.

Counterpart of `halo2_proofs::plonk::ConstraintSystem` (reference gadgets
register gates/lookups against it throughout src/gadgets/; SURVEY.md §2b).

Design notes:
- A `Selector` is a thin wrapper over a fixed column whose query is a
  `FixedQuery`; halo2-style selector compression (packing disjoint boolean
  selectors into combined fixed columns) is a separate keygen pass in
  `plonk/selectors.py`, recorded on the CS as `cs.compression`.
- Lookup table columns are fixed columns tagged as tables.
Both keep the proving semantics identical while making witness construction a
pure vectorized array build.

Frozen copy of ``zerog_tpu_torch/plonk/cs.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

from .expression import (
    Expr, FixedQuery, AdviceQuery, InstanceQuery, collect_queries, degree,
)

__all__ = ["Column", "Selector", "TableColumn", "ConstraintSystem"]


@dataclasses.dataclass(frozen=True)
class Column:
    kind: str  # 'advice' | 'fixed' | 'instance'
    index: int

    def query(self, rotation: int = 0) -> Expr:
        if self.kind == "advice":
            return AdviceQuery(self.index, rotation)
        if self.kind == "fixed":
            return FixedQuery(self.index, rotation)
        return InstanceQuery(self.index, rotation)

    def cur(self):
        return self.query(0)

    def next(self):
        return self.query(1)

    def prev(self):
        return self.query(-1)


@dataclasses.dataclass(frozen=True)
class Selector:
    column: Column  # fixed

    def expr(self) -> Expr:
        return self.column.cur()


@dataclasses.dataclass(frozen=True)
class TableColumn:
    column: Column  # fixed


class ConstraintSystem:
    def __init__(self):
        self.num_advice = 0
        self.num_fixed = 0
        self.num_instance = 0
        # original selector count (pre-compression) — pinned-vk metadata,
        # matching halo2's cs.num_selectors which survives compression
        self.num_selectors = 0
        self.gates: list[tuple[str, list[Expr]]] = []
        # each lookup: (name, [(input_expr, table_expr)])
        self.lookups: list[tuple[str, list[tuple[Expr, Expr]]]] = []
        self.permutation_columns: list[Column] = []
        self.selector_fixed: set[int] = set()
        self.table_fixed: set[int] = set()
        self.constants_column: Column | None = None
        # set by plonk.selectors.compress_selectors_pass at keygen; the
        # prover re-applies it to freshly synthesized fixed columns
        self.compression = None

    # ---- column allocation ----------------------------------------------
    def advice_column(self) -> Column:
        c = Column("advice", self.num_advice)
        self.num_advice += 1
        return c

    def fixed_column(self) -> Column:
        c = Column("fixed", self.num_fixed)
        self.num_fixed += 1
        return c

    def instance_column(self) -> Column:
        c = Column("instance", self.num_instance)
        self.num_instance += 1
        return c

    def selector(self) -> Selector:
        col = self.fixed_column()
        self.selector_fixed.add(col.index)
        self.num_selectors += 1
        return Selector(col)

    def complex_selector(self) -> Selector:
        return self.selector()

    def lookup_table_column(self) -> TableColumn:
        col = self.fixed_column()
        self.table_fixed.add(col.index)
        return TableColumn(col)

    # ---- registration ----------------------------------------------------
    def enable_equality(self, column: Column):
        if column not in self.permutation_columns:
            self.permutation_columns.append(column)

    def enable_constant(self, column: Column):
        assert column.kind == "fixed"
        self.constants_column = column
        self.enable_equality(column)

    def create_gate(self, name: str, polys: list[Expr]):
        assert polys, "gate must have at least one constraint"
        self.gates.append((name, list(polys)))

    def lookup(self, name: str, pairs: list[tuple[Expr, "TableColumn | Expr"]]):
        norm = []
        for inp, tab in pairs:
            if isinstance(tab, TableColumn):
                tab = tab.column.cur()
            norm.append((inp, tab))
        self.lookups.append((name, norm))

    # ---- derived metadata ------------------------------------------------
    def degree(self) -> int:
        d = 3  # permutation baseline
        for _, polys in self.gates:
            for poly in polys:
                d = max(d, degree(poly))
        for _, pairs in self.lookups:
            a = max(degree(i) for i, _ in pairs)
            s = max(degree(t) for _, t in pairs)
            # activity * (Z(wX)(A'+beta)(S'+gamma) - Z(A+beta)(S+gamma))
            d = max(d, 1 + 1 + a + s, 3)
        return d

    def permutation_chunk_len(self) -> int:
        return self.degree() - 2

    def num_permutation_chunks(self) -> int:
        chunk = self.permutation_chunk_len()
        return (len(self.permutation_columns) + chunk - 1) // chunk

    def blinding_factors(self) -> int:
        # max distinct rotations queried on any one advice column
        counts: dict[int, set[int]] = {}
        for _, _, queries in [("g", p, collect_queries(p)) for _, ps in self.gates for p in ps] + [
            ("l", None, collect_queries(i) | collect_queries(t))
            for _, prs in self.lookups
            for i, t in prs
        ]:
            for kind, col, rot in queries:
                if kind == "advice":
                    counts.setdefault(col, set()).add(rot)
        for col in self.permutation_columns:
            if col.kind == "advice":
                counts.setdefault(col.index, set()).add(0)
        factors = max((len(v) for v in counts.values()), default=1)
        factors = max(3, factors)
        # +1 for multiopen evaluation, +1 margin (same as halo2's accounting)
        return factors + 2

    def usable_rows(self, n: int) -> int:
        """Rows available to the circuit: n - (blinding_factors + 1)."""
        return n - (self.blinding_factors() + 1)

    # ---- deterministic query lists (define transcript order) -------------
    def _ordered_queries(self, kind: str):
        seen = []
        def visit(e):
            for k, col, rot in sorted(collect_queries(e)):
                if k == kind and (col, rot) not in seen:
                    seen.append((col, rot))
        for _, polys in self.gates:
            for p in polys:
                visit(p)
        for _, pairs in self.lookups:
            for i, t in pairs:
                visit(i)
                visit(t)
        for col in self.permutation_columns:
            if col.kind == kind and (col.index, 0) not in seen:
                seen.append((col.index, 0))
        return seen

    def advice_queries(self):
        return self._ordered_queries("advice")

    def fixed_queries(self):
        return self._ordered_queries("fixed")

    def instance_queries(self):
        return self._ordered_queries("instance")
