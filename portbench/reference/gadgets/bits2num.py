"""Bits-to-number gadget: running sum acc_next = 2*acc_cur + bit.

Counterpart of reference src/gadgets/bits2num.rs:40-133. Bits are assumed
range-checked elsewhere.

Frozen copy of ``zerog_tpu_torch/gadgets/bits2num.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

from ..assignment import Assignment
from ..cs import ConstraintSystem, Column, Selector
from ..expression import Product, Scaled, Sum

__all__ = ["Bits2NumConfig", "Bits2NumChip"]


@dataclasses.dataclass
class Bits2NumConfig:
    input: Column
    accumulator: Column
    q: Selector


class Bits2NumChip:
    @staticmethod
    def configure(cs: ConstraintSystem, input_col: Column, acc_col: Column) -> Bits2NumConfig:
        q = cs.selector()
        cs.create_gate(
            "bits2num",
            [Product(q.expr(), Sum(acc_col.next(),
                                   Sum(Scaled(acc_col.cur(), -2), Scaled(input_col.cur(), -1))))],
        )
        return Bits2NumConfig(input=input_col, accumulator=acc_col, q=q)

    def __init__(self, config: Bits2NumConfig):
        self.config = config

    def convert_be(self, asn: Assignment, bit_cells, bit_values):
        """Big-endian bits -> number. Returns (result_cell, result_value)."""
        cfg = self.config
        n = len(bit_cells)
        start = asn.region([cfg.input, cfg.accumulator, cfg.q], n + 1)
        accs = [0]
        for v in bit_values:
            accs.append(accs[-1] * 2 + int(v))
        acc_cells = asn.assign_advice(cfg.accumulator, list(range(start, start + n + 1)), accs)
        asn.copy(acc_cells[0], asn.constant_cell(0))
        in_cells = asn.assign_advice(cfg.input, list(range(start, start + n)),
                                     [int(v) for v in bit_values])
        asn.copy_many(bit_cells, in_cells)
        asn.enable_selector(cfg.q, list(range(start, start + n)))
        return acc_cells[-1], accs[-1]

    def convert_le(self, asn: Assignment, bit_cells, bit_values):
        """Little-endian bits -> number (reverse then BE, as the reference)."""
        return self.convert_be(asn, list(reversed(bit_cells)), list(reversed(bit_values)))
