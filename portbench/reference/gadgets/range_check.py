"""Byte-decomposition range check + less-or-equal-constant gadget.

Behavioral counterpart of reference src/gadgets/range_check.rs (which wraps
halo2_gadgets' LookupRangeCheckConfig with K=8). Redesigned for a single
lookup with a fixed "running" flag column instead of halo2_gadgets' two-phase
short check:

Layout in one shared advice column z (plus fixed columns):

  range_check(x, n_bits) with w = n_bits // 8, s = n_bits % 8:
    row 0..w:   z_0 = x (copy), z_{i+1} = (z_i - b_i) / 256
    per row i < w:  q_lookup=1, q_running=1  ->  (z_i - 256 z_{i+1}) in bytes
    if s == 0:  z_w copy-constrained to constant 0
    if s > 0:   row w+1 holds z_w * 2^(8-s); gate q_shift enforces the shift
                (multiplier from the fixed column), and q_lookup with
                q_running=0 byte-checks BOTH z_w (row w) and the shifted
                value (row w+1): z_w < 256 and z_w * 2^(8-s) < 256 together
                give z_w < 2^s with no field wraparound.

  le_constant(x, y): rows [x (copy); y (constant); diff], gate
    q_le * (z_prev + z_next - z_cur) = 0, then range_check(diff, bitlen(y))
    — same layout as the reference (src/gadgets/range_check.rs:35-91).

Frozen copy of ``zerog_tpu_torch/gadgets/range_check.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

from ..cs import ConstraintSystem, Column, Selector, TableColumn
from ..assignment import Assignment
from ..expression import Constant, Product, Scaled, Sum

__all__ = ["RangeCheckConfig", "RangeCheckChip"]


@dataclasses.dataclass
class RangeCheckConfig:
    z: Column               # advice
    shift_mult: Column      # fixed
    q_running: Column       # fixed (1 = mid-decomposition row)
    q_lookup: Selector
    q_shift: Selector
    q_le: Selector
    byte_table: TableColumn


class RangeCheckChip:
    @staticmethod
    def configure(cs: ConstraintSystem, z: Column, byte_table: TableColumn) -> RangeCheckConfig:
        shift_mult = cs.fixed_column()
        q_running = cs.fixed_column()
        q_lookup = cs.complex_selector()
        q_shift = cs.selector()
        q_le = cs.selector()

        zc = z.cur()
        zn = z.next()
        zp = z.prev()
        # q_lookup * (z_cur - q_running * 256 * z_next)  in byte table
        word = Sum(zc, Scaled(Product(q_running.cur(), zn), -256))
        cs.lookup("range_check_bytes", [(Product(q_lookup.expr(), word), byte_table)])
        # q_shift * (z_next - z_cur * shift_mult) = 0
        cs.create_gate(
            "range_check_shift",
            [Product(q_shift.expr(), Sum(zn, Scaled(Product(zc, shift_mult.cur()), -1)))],
        )
        # q_le * (z_prev + z_next - z_cur) = 0   (x + diff = y)
        cs.create_gate("le", [Product(q_le.expr(), Sum(Sum(zp, zn), Scaled(zc, -1)))])

        return RangeCheckConfig(
            z=z, shift_mult=shift_mult, q_running=q_running,
            q_lookup=q_lookup, q_shift=q_shift, q_le=q_le, byte_table=byte_table,
        )

    def __init__(self, config: RangeCheckConfig):
        self.config = config

    def range_check(self, asn: Assignment, cell, value: int, n_bits: int):
        """Constrain the value behind `cell` (known to be `value`) to
        [0, 2^n_bits)."""
        cfg = self.config
        w, s = divmod(n_bits, 8)
        height = w + 1 + (1 if s else 0)
        start = asn.region(
            [cfg.z, cfg.shift_mult, cfg.q_running, cfg.q_lookup, cfg.q_shift], height
        )
        zs = [int(value)]
        for _ in range(w):
            zs.append(zs[-1] >> 8)
        if s:
            zs.append(zs[w] << (8 - s))
        rows = list(range(start, start + height))
        cells = asn.assign_advice(cfg.z, rows, zs)
        asn.copy(cell, cells[0])
        if w:
            asn.enable_selector(cfg.q_lookup, rows[:w])
            asn.assign_fixed(cfg.q_running, rows[:w], [1] * w)
        if s:
            asn.enable_selector(cfg.q_shift, rows[w])
            asn.assign_fixed(cfg.shift_mult, rows[w], 1 << (8 - s))
            # Soundness: byte-check BOTH the terminal limb z_w itself (row w,
            # where q_running=0 so the looked-up word is z_w directly) and the
            # shifted value z_w * 2^(8-s) (row w+1). Together these give
            # z_w < 2^s without field wraparound; checking only the shifted
            # row would admit any z_w = b * 2^(s-8) mod r. Mirrors
            # halo2_gadgets' short_range_check, which enables the lookup on
            # both the word row and the shifted row.
            asn.enable_selector(cfg.q_lookup, [rows[w], rows[w + 1]])
        else:
            asn.copy(cells[w], asn.constant_cell(0))

    def le_constant(self, asn: Assignment, cell, value: int, y: int):
        """Constrain value <= y (y a public constant).

        Self-contained soundness: BOTH value and diff = y - value are
        range-checked to bitlen(y) bits, so value + diff = y holds over the
        integers (max sum 2^(b+1) - 2 << r, no wraparound) regardless of any
        caller-side bound on value. The reference relies on the caller
        bounding value (src/gadgets/range_check.rs:35-91); we pay ~w+2 extra
        rows to make the contract explicit in-gadget.
        """
        cfg = self.config
        start = asn.region([cfg.z, cfg.q_le], 3)
        diff = y - int(value)
        assert diff >= 0, "le_constant witness out of range"
        cells = asn.assign_advice(cfg.z, [start, start + 1, start + 2],
                                  [int(value), y, diff])
        asn.copy(cell, cells[0])
        asn.copy(cells[1], asn.constant_cell(y))
        asn.enable_selector(cfg.q_le, start + 1)
        self.range_check(asn, cells[0], int(value), y.bit_length())
        self.range_check(asn, cells[2], diff, y.bit_length())
