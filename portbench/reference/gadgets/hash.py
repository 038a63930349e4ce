"""MishMash hash gadget: h(x) = (x^3 % p) % 2^l.

Counterpart of reference src/gadgets/hash.rs:44-210. One row:

  | input (copy) | quotient | remainder | msb | hash |

gates:  x^3 = quotient*p + remainder;  remainder = msb*2^l + hash
post-checks: quotient in [0, 2^(3n-l)); msb a bit; remainder <= p-1.
The input is range-checked elsewhere; the hash output's range is enforced by
the bloom array-lookup's terminal-zero decomposition (reference
src/gadgets/hash.rs:185-207).

Frozen copy of ``zerog_tpu_torch/gadgets/hash.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

from ..assignment import Assignment
from ..cs import ConstraintSystem, Column, Selector
from ..expression import Constant, Product, Scaled, Sum
from .range_check import RangeCheckChip, RangeCheckConfig

__all__ = ["HashFunctionConfig", "HashConfig", "HashChip"]


@dataclasses.dataclass
class HashFunctionConfig:
    p: int
    l: int
    n_bits: int  # input bits


@dataclasses.dataclass
class HashConfig:
    input: Column
    quotient: Column
    remainder: Column
    msb: Column
    hash: Column
    q_hash: Selector
    rc: RangeCheckConfig
    hf: HashFunctionConfig


class HashChip:
    @staticmethod
    def configure(cs: ConstraintSystem, input_col, quotient, remainder, msb,
                  hash_col, rc: RangeCheckConfig, hf: HashFunctionConfig) -> HashConfig:
        q = cs.selector()
        x = input_col.cur()
        cube = Product(Product(x, x), x)
        mod_p = Sum(Scaled(quotient.cur(), hf.p), remainder.cur())
        mod_2l = Sum(Scaled(msb.cur(), 1 << hf.l), hash_col.cur())
        cs.create_gate("hash", [
            Product(q.expr(), Sum(cube, Scaled(mod_p, -1))),
            Product(q.expr(), Sum(remainder.cur(), Scaled(mod_2l, -1))),
        ])
        return HashConfig(input=input_col, quotient=quotient, remainder=remainder,
                          msb=msb, hash=hash_col, q_hash=q, rc=rc, hf=hf)

    def __init__(self, config: HashConfig):
        assert 3 * config.hf.n_bits < 254, "field too small for x^3"
        self.config = config
        self.rc = RangeCheckChip(config.rc)

    def hash(self, asn: Assignment, input_cell, input_value: int):
        cfg = self.config
        p, l, n_bits = cfg.hf.p, cfg.hf.l, cfg.hf.n_bits
        x = int(input_value)
        cube = x ** 3
        quotient, remainder = divmod(cube, p)
        msb, h = divmod(remainder, 1 << l)
        assert msb <= 1

        row = asn.region(
            [cfg.input, cfg.quotient, cfg.remainder, cfg.msb, cfg.hash, cfg.q_hash], 1
        )
        (in_cell,) = asn.assign_advice(cfg.input, row, x)
        asn.copy(input_cell, in_cell)
        (q_cell,) = asn.assign_advice(cfg.quotient, row, quotient)
        (r_cell,) = asn.assign_advice(cfg.remainder, row, remainder)
        (m_cell,) = asn.assign_advice(cfg.msb, row, msb)
        (h_cell,) = asn.assign_advice(cfg.hash, row, h)
        asn.enable_selector(cfg.q_hash, row)

        self.rc.range_check(asn, q_cell, quotient, n_bits * 3 - l)
        self.rc.range_check(asn, m_cell, msb, 1)
        self.rc.le_constant(asn, r_cell, remainder, p - 1)
        return h_cell, h
