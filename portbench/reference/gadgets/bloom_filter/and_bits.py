"""And-bits: AND-fold n bits with a product accumulator.

Counterpart of reference src/gadgets/bloom_filter/and_bits.rs:27-122.
Gate: q * (acc_cur * bit - acc_next); acc starts at constant 1.

Frozen copy of ``zerog_tpu_torch/gadgets/bloom_filter/and_bits.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

from ...assignment import Assignment
from ...cs import ConstraintSystem, Column, Selector
from ...expression import Product, Scaled, Sum

__all__ = ["AndBitsConfig", "AndBitsChip"]


@dataclasses.dataclass
class AndBitsConfig:
    bits: Column
    acc: Column
    q: Selector


class AndBitsChip:
    @staticmethod
    def configure(cs: ConstraintSystem, bits: Column, acc: Column) -> AndBitsConfig:
        q = cs.selector()
        cs.create_gate("and_bits", [
            Product(q.expr(), Sum(Product(acc.cur(), bits.cur()), Scaled(acc.next(), -1)))
        ])
        return AndBitsConfig(bits=bits, acc=acc, q=q)

    def __init__(self, config: AndBitsConfig):
        self.config = config

    def and_bits(self, asn: Assignment, bit_cells, bit_values):
        cfg = self.config
        n = len(bit_cells)
        start = asn.region([cfg.bits, cfg.acc, cfg.q], n + 1)
        rows = list(range(start, start + n + 1))
        accs = [1]
        for v in bit_values:
            accs.append(accs[-1] * int(v))
        in_cells = asn.assign_advice(cfg.bits, rows[:n], [int(v) for v in bit_values])
        asn.copy_many(bit_cells, in_cells)
        asn.assign_constant(cfg.acc, rows[0], 1)
        acc_cells = asn.assign_advice(cfg.acc, rows[1:], accs[1:])
        asn.enable_selector(cfg.q, rows[:n])
        return acc_cells[-1], accs[-1]
