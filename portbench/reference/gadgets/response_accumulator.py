"""Response accumulator: sum bloom responses 4 per row.

Counterpart of reference src/gadgets/response_accumulator.rs:41-133.
Gate: q * (x1 + x2 + x3 + x4 + acc_cur - acc_next); missing slots in the last
row are constant zeros.

Frozen copy of ``zerog_tpu_torch/gadgets/response_accumulator.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

from ..assignment import Assignment
from ..cs import ConstraintSystem, Column, Selector
from ..expression import Product, Scaled, Sum

__all__ = ["ResponseAccumulatorConfig", "ResponseAccumulatorChip"]


@dataclasses.dataclass
class ResponseAccumulatorConfig:
    advice: list  # 5 columns: 4 response slots + accumulator
    q: Selector


class ResponseAccumulatorChip:
    @staticmethod
    def configure(cs: ConstraintSystem, advice) -> ResponseAccumulatorConfig:
        assert len(advice) == 5
        q = cs.selector()
        expr = Sum(
            Sum(Sum(advice[0].cur(), advice[1].cur()), Sum(advice[2].cur(), advice[3].cur())),
            Sum(advice[4].cur(), Scaled(advice[4].next(), -1)),
        )
        cs.create_gate("accumulate_responses", [Product(q.expr(), expr)])
        return ResponseAccumulatorConfig(advice=list(advice), q=q)

    def __init__(self, config: ResponseAccumulatorConfig):
        self.config = config

    def accumulate(self, asn: Assignment, cells, values):
        cfg = self.config
        n = len(cells)
        rows_needed = (n + 3) // 4
        start = asn.region(cfg.advice + [cfg.q], rows_needed + 1)
        rows = list(range(start, start + rows_needed + 1))
        acc = 0
        asn.assign_constant(cfg.advice[4], rows[0], 0)
        acc_vals = []
        for r in range(rows_needed):
            for i in range(4):
                idx = r * 4 + i
                if idx < n:
                    (cell,) = asn.assign_advice(cfg.advice[i], rows[r], int(values[idx]))
                    asn.copy(cells[idx], cell)
                    acc += int(values[idx])
                else:
                    asn.assign_constant(cfg.advice[i], rows[r], 0)
            acc_vals.append(acc)
        acc_cells = asn.assign_advice(cfg.advice[4], rows[1:], acc_vals)
        asn.enable_selector(cfg.q, rows[:rows_needed])
        return acc_cells[-1], acc
