"""Greater-than gadget: is_gt = (x > y) for byte x and constant byte y.

Counterpart of reference src/gadgets/greater_than.rs:55-103. One row:

  | x | y (const) | diff | is_gt |    with gate  x + diff = 256*is_gt + y

plus byte range checks on x (witness variant) and diff, and a bit check on
is_gt, all via :class:`RangeCheckChip`.

Frozen copy of ``zerog_tpu_torch/gadgets/greater_than.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

from ..cs import ConstraintSystem, Column, Selector
from ..assignment import Assignment
from ..expression import Product, Scaled, Sum
from .range_check import RangeCheckChip, RangeCheckConfig

__all__ = ["GreaterThanConfig", "GreaterThanChip"]


@dataclasses.dataclass
class GreaterThanConfig:
    x: Column
    y: Column
    diff: Column
    is_gt: Column
    q_gt: Selector
    rc: RangeCheckConfig


class GreaterThanChip:
    @staticmethod
    def configure(cs: ConstraintSystem, x: Column, y: Column, diff: Column,
                  is_gt: Column, rc: RangeCheckConfig) -> GreaterThanConfig:
        q_gt = cs.selector()
        cs.create_gate(
            "x + diff = 256*is_gt + y",
            [Product(q_gt.expr(), Sum(Sum(x.cur(), diff.cur()),
                                      Sum(Scaled(is_gt.cur(), -256), Scaled(y.cur(), -1))))],
        )
        return GreaterThanConfig(x=x, y=y, diff=diff, is_gt=is_gt, q_gt=q_gt, rc=rc)

    def __init__(self, config: GreaterThanConfig):
        self.config = config
        self.rc = RangeCheckChip(config.rc)

    def _assign_row(self, asn: Assignment, x_val: int, y: int):
        cfg = self.config
        assert 0 <= y <= 255, "y must be a byte"
        gt = int(x_val > y)
        diff = 256 * gt + y - x_val
        row = asn.region([cfg.x, cfg.y, cfg.diff, cfg.is_gt, cfg.q_gt], 1)
        (x_cell,) = asn.assign_advice(cfg.x, row, x_val)
        asn.assign_constant(cfg.y, row, y)
        (diff_cell,) = asn.assign_advice(cfg.diff, row, diff)
        (gt_cell,) = asn.assign_advice(cfg.is_gt, row, gt)
        asn.enable_selector(cfg.q_gt, row)
        return x_cell, diff_cell, gt_cell, diff, gt

    def greater_than_witness(self, asn: Assignment, x_val: int, y: int):
        """Witness x; returns (x_cell, gt_cell). x is byte-range-checked here
        (reference src/gadgets/greater_than.rs:135-165)."""
        x_cell, diff_cell, gt_cell, diff, gt = self._assign_row(asn, x_val, y)
        self.rc.range_check(asn, x_cell, x_val, 8)
        self.rc.range_check(asn, gt_cell, gt, 1)
        self.rc.range_check(asn, diff_cell, diff, 8)
        return x_cell, gt_cell

    def greater_than_copy(self, asn: Assignment, x_cell, x_val: int, y: int):
        """Copy x from an existing (already range-checked) cell; returns gt_cell."""
        cfg = self.config
        new_x, diff_cell, gt_cell, diff, gt = self._assign_row(asn, x_val, y)
        asn.copy(x_cell, new_x)
        self.rc.range_check(asn, gt_cell, gt, 1)
        self.rc.range_check(asn, diff_cell, diff, 8)
        return gt_cell
