"""Witness assignment: vectorized trace construction + first-fit floor planner.

Counterpart of halo2's `SimpleFloorPlanner`/`Layouter`/`Region` machinery
(used by every `assign_region` in reference src/gadgets/). Instead of
cell-at-a-time closures, a region declares the columns it touches and its
height, gets an absolute start row (first-fit per-column watermark — the same
placement rule as SimpleFloorPlanner), and then writes whole vectors into the
column arrays. Copy (equality) constraints are recorded as cell-pair lists
feeding the permutation argument.

Values are canonical Python ints (numpy object arrays); they convert to
Montgomery limb arrays only at the device boundary in the prover.

Frozen copy of ``zerog_tpu_torch/plonk/assignment.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import numpy as np

from .cs import ConstraintSystem, Column, Selector, TableColumn

__all__ = ["Cell", "Assignment"]

# A cell is (kind, column_index, row).
Cell = tuple


class Assignment:
    def __init__(self, cs: ConstraintSystem, n: int):
        self.cs = cs
        self.n = n
        self.usable = cs.usable_rows(n)
        self.advice = [np.zeros(n, dtype=object) for _ in range(cs.num_advice)]
        self.fixed = [np.zeros(n, dtype=object) for _ in range(cs.num_fixed)]
        self.copies: list[tuple[Cell, Cell]] = []
        self._watermark: dict[tuple[str, int], int] = {}
        self._table_height = 0
        self._table_assigned: dict[int, int] = {}  # fixed col -> rows filled
        self._constants: dict[int, Cell] = {}
        self._const_row = 0

    # ---- regions ---------------------------------------------------------
    def region(self, columns, height: int) -> int:
        """Allocate `height` rows over `columns` (first-fit, SimpleFloorPlanner
        placement). Returns the absolute start row."""
        keys = []
        for c in columns:
            if isinstance(c, Selector):
                c = c.column
            if isinstance(c, TableColumn):
                raise ValueError("table columns cannot be used in regions")
            keys.append((c.kind, c.index))
        start = max((self._watermark.get(k, 0) for k in keys), default=0)
        if start + height > self.usable:
            raise ValueError(
                f"circuit does not fit: region of height {height} at row {start} "
                f"exceeds usable rows {self.usable} (n={self.n})"
            )
        for k in keys:
            self._watermark[k] = start + height
        return start

    # ---- raw writes ------------------------------------------------------
    def assign_advice(self, column: Column, rows, values) -> list[Cell]:
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        values = np.atleast_1d(np.asarray(values, dtype=object))
        self.advice[column.index][rows] = values
        return [("advice", column.index, int(r)) for r in rows]

    def assign_fixed(self, column: Column, rows, values) -> list[Cell]:
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        values = np.atleast_1d(np.asarray(values, dtype=object))
        self.fixed[column.index][rows] = values
        return [("fixed", column.index, int(r)) for r in rows]

    def enable_selector(self, sel: Selector, rows):
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        self.fixed[sel.column.index][rows] = 1

    # ---- equality / constants -------------------------------------------
    def copy(self, a: Cell, b: Cell):
        self.copies.append((a, b))

    def copy_many(self, cells_a, cells_b):
        self.copies.extend(zip(cells_a, cells_b))

    def constant_cell(self, value: int) -> Cell:
        """A cell in the constants fixed column holding `value` (deduped)."""
        value = int(value)
        if value in self._constants:
            return self._constants[value]
        col = self.cs.constants_column
        assert col is not None, "no constants column enabled"
        row = self._const_row
        if row >= self.usable:
            raise ValueError("constants column overflow")
        self._const_row += 1
        self.fixed[col.index][row] = value
        cell = ("fixed", col.index, row)
        self._constants[value] = cell
        return cell

    def assign_constant(self, column: Column, row: int, value: int) -> Cell:
        """assign_advice_from_constant: write value and copy-constrain to the
        constants column."""
        if column.kind == "advice":
            (cell,) = self.assign_advice(column, row, value)
        else:
            (cell,) = self.assign_fixed(column, row, value)
        self.copy(cell, self.constant_cell(value))
        return cell

    def constrain_instance(self, cell: Cell, instance_column: Column, row: int):
        self.copy(cell, ("instance", instance_column.index, row))

    # ---- tables ----------------------------------------------------------
    def assign_table(self, columns, value_lists):
        """Fill table columns from row 0. All columns of one table must be
        assigned together with equal lengths."""
        lengths = {len(v) for v in value_lists}
        assert len(lengths) == 1
        (length,) = lengths
        for col, values in zip(columns, value_lists):
            if isinstance(col, TableColumn):
                col = col.column
            prev = self._table_assigned.get(col.index, 0)
            if prev + length > self.usable:
                raise ValueError(
                    f"table exceeds usable rows: {prev + length} > {self.usable}"
                )
            self.fixed[col.index][prev : prev + length] = np.asarray(values, dtype=object)
            self._table_assigned[col.index] = prev + length
        self._table_height = max(self._table_height, max(self._table_assigned.values()))

    def finalize_tables(self):
        """Pad each table column's unused usable rows by repeating its row-0
        value (safe: duplicates an existing tuple, adds no new ones)."""
        for col_idx in self.cs.table_fixed:
            filled = self._table_assigned.get(col_idx, 0)
            self.fixed[col_idx][filled : self.usable] = self.fixed[col_idx][0]

    # ---- lookup of cell values ------------------------------------------
    def cell_value(self, cell: Cell, instance=None) -> int:
        kind, col, row = cell
        if kind == "advice":
            return int(self.advice[col][row])
        if kind == "fixed":
            return int(self.fixed[col][row])
        if instance is None:
            raise ValueError("instance values not provided")
        vals = instance[col]
        return int(vals[row]) if row < len(vals) else 0
