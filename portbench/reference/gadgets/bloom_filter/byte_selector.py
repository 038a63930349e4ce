"""Byte selector: extract byte `index` (big-endian) of a word without a
dynamic lookup, via a one-hot selector column.

Counterpart of reference src/gadgets/bloom_filter/byte_selector.rs:42-351.
Layout over num_bytes+1 rows (byte decomposition is little-endian; the
byte_index column counts down so the selection is big-endian):

  | byte_decomp | lookup_index | byte_index | selector | sel_acc | byte_acc |

Gates: selector is a bit; sel_acc accumulates to 1; selector forces
lookup_index == byte_index; byte_acc accumulates selector * reconstructed
byte; the byte reconstruction (z_cur - 256 z_next) is byte-table-checked.
Implicitly range-checks lookup_index to [0, num_bytes).

Frozen copy of ``zerog_tpu_torch/gadgets/bloom_filter/byte_selector.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

from ...assignment import Assignment
from ...cs import ConstraintSystem, Column, Selector, TableColumn
from ...expression import Product, Scaled, Sum

__all__ = ["ByteSelectorConfig", "ByteSelectorChip"]


@dataclasses.dataclass
class ByteSelectorConfig:
    byte_decomposition: Column
    lookup_index: Column
    byte_index: Column
    byte_selector: Column
    selector_acc: Column
    byte_acc: Column
    q_decomp: Selector
    q_is_bit: Selector
    q_sel_acc: Selector
    q_right_byte: Selector
    q_byte_acc: Selector


class ByteSelectorChip:
    @staticmethod
    def configure(cs: ConstraintSystem, byte_decomposition, lookup_index, byte_index,
                  byte_selector, selector_acc, byte_acc,
                  byte_table: TableColumn) -> ByteSelectorConfig:
        q_decomp = cs.complex_selector()
        q_is_bit = cs.selector()
        q_sel_acc = cs.selector()
        q_right_byte = cs.selector()
        q_byte_acc = cs.selector()

        def reconstruct_byte():
            return Sum(byte_decomposition.cur(), Scaled(byte_decomposition.next(), -256))

        cs.lookup("byte_decomposition",
                  [(Product(q_decomp.expr(), reconstruct_byte()), byte_table)])
        s = byte_selector.cur()
        cs.create_gate("selector_is_bit",
                       [Product(q_is_bit.expr(), Sum(Product(s, s), Scaled(s, -1)))])
        cs.create_gate("selector_acc", [
            Product(q_sel_acc.expr(),
                    Sum(selector_acc.next(), Sum(Scaled(selector_acc.cur(), -1), Scaled(s, -1))))
        ])
        cs.create_gate("right_byte_selected", [
            Product(q_right_byte.expr(),
                    Product(s, Sum(lookup_index.cur(), Scaled(byte_index.cur(), -1))))
        ])
        cs.create_gate("byte_acc", [
            Product(q_byte_acc.expr(),
                    Sum(byte_acc.next(),
                        Sum(Scaled(byte_acc.cur(), -1),
                            Scaled(Product(s, reconstruct_byte()), -1))))
        ])
        return ByteSelectorConfig(
            byte_decomposition=byte_decomposition, lookup_index=lookup_index,
            byte_index=byte_index, byte_selector=byte_selector,
            selector_acc=selector_acc, byte_acc=byte_acc,
            q_decomp=q_decomp, q_is_bit=q_is_bit, q_sel_acc=q_sel_acc,
            q_right_byte=q_right_byte, q_byte_acc=q_byte_acc,
        )

    def __init__(self, config: ByteSelectorConfig):
        self.config = config

    def select_byte(self, asn: Assignment, word_cell, word_val: int,
                    index_cell, index_val: int, num_bytes: int):
        """Returns (byte_cell, byte_value): byte `index_val` of the word in
        big-endian order."""
        cfg = self.config
        nb = num_bytes
        bytes_be = [(word_val >> (8 * (nb - 1 - i))) & 0xFF for i in range(nb)]
        ith_byte = bytes_be[index_val]

        start = asn.region(
            [cfg.byte_decomposition, cfg.lookup_index, cfg.byte_index,
             cfg.byte_selector, cfg.selector_acc, cfg.byte_acc,
             cfg.q_decomp, cfg.q_is_bit, cfg.q_sel_acc, cfg.q_right_byte,
             cfg.q_byte_acc], nb + 1,
        )
        rows = list(range(start, start + nb + 1))
        # little-endian byte peeling
        decomp = [word_val]
        for i in range(nb):
            decomp.append((decomp[-1] - bytes_be[nb - 1 - i]) >> 8)
        assert decomp[-1] == 0
        d_cells = asn.assign_advice(cfg.byte_decomposition, rows, decomp)
        asn.copy(word_cell, d_cells[0])
        asn.copy(d_cells[nb], asn.constant_cell(0))

        idx_cells = asn.assign_advice(cfg.lookup_index, rows[:nb], [index_val] * nb)
        asn.copy_many([index_cell] * nb, idx_cells)
        for i in range(nb):
            asn.assign_constant(cfg.byte_index, rows[nb - 1 - i], i)
        sel = [1 if (nb - 1 - i) == index_val else 0 for i in range(nb)]
        asn.assign_advice(cfg.byte_selector, rows[:nb], sel)
        sel_acc = [1 if (nb - i) <= index_val else 0 for i in range(1, nb)]
        acc0 = asn.assign_constant(cfg.selector_acc, rows[0], 0)
        if nb > 1:
            asn.assign_advice(cfg.selector_acc, rows[1:nb], sel_acc)
        asn.assign_constant(cfg.selector_acc, rows[nb], 1)
        byte_acc = [ith_byte if (nb - i) <= index_val else 0 for i in range(1, nb + 1)]
        asn.assign_constant(cfg.byte_acc, rows[0], 0)
        bacc_cells = asn.assign_advice(cfg.byte_acc, rows[1:], byte_acc)

        for q in (cfg.q_decomp, cfg.q_is_bit, cfg.q_sel_acc, cfg.q_right_byte,
                  cfg.q_byte_acc):
            asn.enable_selector(q, rows[:nb])
        return bacc_cells[-1], ith_byte
