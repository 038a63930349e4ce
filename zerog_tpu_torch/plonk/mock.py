"""MockProver analogue: evaluate every gate/lookup/copy constraint on the
witness matrices and report failures.

Counterpart of `halo2_proofs::dev::MockProver` (the reference's testing
workhorse, src/wnn.rs:204-210 and every gadget test; SURVEY.md §4). Gates are
evaluated whole-column with numpy object arrays (exact Python ints, rotations
via np.roll) — the same Expression trees the device quotient evaluator compiles.
"""

from __future__ import annotations

import numpy as np

from ..field import FR
from .assignment import Assignment
from .expression import evaluate

__all__ = ["MockProver"]


class _Namespace:
    pass


def _make_ops(assignment, instance_padded):
    """Row-wise host evaluator: expressions -> object arrays of ints mod r."""
    p = FR.p
    ops = _Namespace()
    ops.constant = lambda c: c % p
    ops.fixed = lambda col, rot: np.roll(assignment.fixed[col], -rot)
    ops.advice = lambda col, rot: np.roll(assignment.advice[col], -rot)
    ops.instance = lambda col, rot: np.roll(instance_padded[col], -rot)
    ops.add = lambda x, y: (x + y) % p
    ops.mul = lambda x, y: (x * y) % p
    ops.scale = lambda x, s: (x * (s % p)) % p
    return ops


class MockProver:
    def __init__(self, assignment: Assignment, instance_columns):
        """instance_columns: list of lists of ints (one per instance column)."""
        self.a = assignment
        self.n = assignment.n
        self.cs = assignment.cs
        self.instance = [
            np.asarray(list(col) + [0] * (self.n - len(col)), dtype=object)
            for col in instance_columns
        ]
        while len(self.instance) < self.cs.num_instance:
            self.instance.append(np.zeros(self.n, dtype=object))

    @classmethod
    def run(cls, circuit, instance_columns, n=None, k=None):
        """circuit: object with .configure(cs) -> config and
        .synthesize(config, assignment)."""
        from .cs import ConstraintSystem

        cs = ConstraintSystem()
        config = circuit.configure(cs)
        if n is None:
            n = 1 << k
        assignment = Assignment(cs, n)
        circuit.synthesize(config, assignment)
        assignment.finalize_tables()
        return cls(assignment, instance_columns)

    def verify(self) -> list[str]:
        errors = []
        usable = self.a.usable
        ops = _make_ops(self.a, self.instance)

        for name, polys in self.cs.gates:
            for pi, poly in enumerate(polys):
                vals = evaluate(poly, ops)
                vals = np.asarray(vals, dtype=object)
                if vals.ndim == 0:
                    vals = np.full(self.n, vals[()], dtype=object)
                bad = np.nonzero(vals[:usable])[0]
                if len(bad):
                    errors.append(
                        f"gate '{name}' poly {pi} unsatisfied at rows "
                        f"{list(bad[:5])}{'...' if len(bad) > 5 else ''}"
                    )

        for name, pairs in self.cs.lookups:
            inputs = [np.asarray(evaluate(i, ops), dtype=object) for i, _ in pairs]
            tables = [np.asarray(evaluate(t, ops), dtype=object) for _, t in pairs]
            inputs = [
                np.full(self.n, v[()], dtype=object) if v.ndim == 0 else v for v in inputs
            ]
            tables = [
                np.full(self.n, v[()], dtype=object) if v.ndim == 0 else v for v in tables
            ]
            table_set = set(zip(*(t[:usable] for t in tables)))
            bad_rows = [
                r for r in range(usable)
                if tuple(v[r] for v in inputs) not in table_set
            ]
            if bad_rows:
                errors.append(
                    f"lookup '{name}' unsatisfied at rows {bad_rows[:5]}"
                    f"{'...' if len(bad_rows) > 5 else ''}"
                )

        for a, b in self.a.copies:
            va = self.a.cell_value(a, self.instance)
            vb = self.a.cell_value(b, self.instance)
            if va % FR.p != vb % FR.p:
                errors.append(f"copy constraint {a} == {b} violated: {va} != {vb}")
                if len(errors) > 20:
                    break

        return errors

    def assert_satisfied(self):
        errors = self.verify()
        if errors:
            raise AssertionError(
                "circuit not satisfied:\n" + "\n".join(errors[:20])
            )
