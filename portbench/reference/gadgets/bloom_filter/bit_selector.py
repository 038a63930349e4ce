"""Bit selector: extract bit `index` (big-endian) of a byte via a static
(byte, index, bit) lookup table of 256*8 rows.

Counterpart of reference src/gadgets/bloom_filter/bit_selector.rs:38-164.
The byte table column is shared with the range-check and byte-selector
gadgets. Inactive rows look up (0,0,0), which is in the table.
Implicitly range-checks `index` to [0, 8).

Frozen copy of ``zerog_tpu_torch/gadgets/bloom_filter/bit_selector.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

from ...assignment import Assignment
from ...cs import ConstraintSystem, Column, Selector, TableColumn
from ...expression import Product

__all__ = ["BitSelectorConfig", "BitSelectorChip"]


@dataclasses.dataclass
class BitSelectorConfig:
    byte: Column
    index: Column
    bit: Column
    byte_table: TableColumn
    index_table: TableColumn
    bit_table: TableColumn
    q_bit: Selector


class BitSelectorChip:
    @staticmethod
    def configure(cs: ConstraintSystem, byte, index, bit) -> BitSelectorConfig:
        q_bit = cs.complex_selector()
        byte_table = cs.lookup_table_column()
        index_table = cs.lookup_table_column()
        bit_table = cs.lookup_table_column()
        q = q_bit.expr()
        cs.lookup("bit_lookup", [
            (Product(q, byte.cur()), byte_table),
            (Product(q, index.cur()), index_table),
            (Product(q, bit.cur()), bit_table),
        ])
        return BitSelectorConfig(byte=byte, index=index, bit=bit,
                                 byte_table=byte_table, index_table=index_table,
                                 bit_table=bit_table, q_bit=q_bit)

    def __init__(self, config: BitSelectorConfig):
        self.config = config

    def load(self, asn: Assignment):
        bytes_col, idx_col, bit_col = [], [], []
        for b in range(256):
            for i in range(8):
                bytes_col.append(b)
                idx_col.append(i)
                bit_col.append((b >> (7 - i)) & 1)
        asn.assign_table(
            [self.config.byte_table, self.config.index_table, self.config.bit_table],
            [bytes_col, idx_col, bit_col],
        )

    def select_bit(self, asn: Assignment, byte_cell, byte_val: int,
                   index_cell, index_val: int):
        cfg = self.config
        bit = (byte_val >> (7 - index_val)) & 1
        row = asn.region([cfg.byte, cfg.index, cfg.bit, cfg.q_bit], 1)
        (b_cell,) = asn.assign_advice(cfg.byte, row, byte_val)
        asn.copy(byte_cell, b_cell)
        (i_cell,) = asn.assign_advice(cfg.index, row, index_val)
        asn.copy(index_cell, i_cell)
        (bit_cell,) = asn.assign_advice(cfg.bit, row, bit)
        asn.enable_selector(cfg.q_bit, row)
        return bit_cell, bit
