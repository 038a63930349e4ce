"""Bloom filter lookup: 3-way decomposition (word / byte / bit) with a
word-packed table.

Counterpart of reference src/gadgets/bloom_filter.rs:71-192: ArrayLookup
decomposes the hash and looks up the packed word; ByteSelector extracts the
addressed byte; BitSelector extracts the bit via a static (byte, index, bit)
table; AndBits folds the per-hash bits.

Frozen copy of ``zerog_tpu_torch/gadgets/bloom_filter/__init__.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...assignment import Assignment
from ...cs import ConstraintSystem
from .array_lookup import ArrayLookupChip, ArrayLookupConfig, array_lookup_params
from .byte_selector import ByteSelectorChip, ByteSelectorConfig
from .bit_selector import BitSelectorChip, BitSelectorConfig
from .and_bits import AndBitsChip, AndBitsConfig

__all__ = [
    "BloomFilterConfig", "BloomFilterChipConfig", "BloomFilterChip",
    "ArrayLookupChip", "ByteSelectorChip", "BitSelectorChip", "AndBitsChip",
]


@dataclasses.dataclass
class BloomFilterConfig:
    n_hashes: int
    bits_per_hash: int


@dataclasses.dataclass
class BloomFilterChipConfig:
    array_lookup: ArrayLookupConfig
    byte_selector: ByteSelectorConfig
    bit_selector: BitSelectorConfig
    and_bits: AndBitsConfig


class BloomFilterChip:
    @staticmethod
    def configure(cs: ConstraintSystem, advice, bf_config: BloomFilterConfig) -> BloomFilterChipConfig:
        """advice: 6 shared advice columns (reference src/gadgets/bloom_filter.rs:118-161)."""
        al_cfg = ArrayLookupChip.configure(
            cs, advice[0], advice[1], advice[2], advice[3], advice[4],
            array_lookup_params(bf_config.n_hashes, bf_config.bits_per_hash),
        )
        bit_cfg = BitSelectorChip.configure(cs, advice[0], advice[1], advice[2])
        byte_cfg = ByteSelectorChip.configure(
            cs, advice[0], advice[1], advice[2], advice[3], advice[4], advice[5],
            bit_cfg.byte_table,
        )
        and_cfg = AndBitsChip.configure(cs, advice[4], advice[5])
        return BloomFilterChipConfig(
            array_lookup=al_cfg, byte_selector=byte_cfg,
            bit_selector=bit_cfg, and_bits=and_cfg,
        )

    def __init__(self, config: BloomFilterChipConfig, bloom_filter_arrays: np.ndarray):
        """bloom_filter_arrays: bool [num_arrays, 2^bits_per_hash] (already
        flattened from (C, N, E) to (C*N, E) by the caller)."""
        self.config = config
        self.array_lookup = ArrayLookupChip(config.array_lookup, bloom_filter_arrays)
        self.byte_selector = ByteSelectorChip(config.byte_selector)
        self.bit_selector = BitSelectorChip(config.bit_selector)
        self.and_bits = AndBitsChip(config.and_bits)

    def load(self, asn: Assignment):
        self.array_lookup.load(asn)
        self.bit_selector.load(asn)

    def bloom_lookup(self, asn: Assignment, hash_cell, hash_value: int, bloom_index: int):
        """Returns (bit_cell, bit_value)."""
        results = self.array_lookup.array_lookup(asn, hash_cell, hash_value, bloom_index)
        bits = []
        bit_vals = []
        for res in results:
            byte_cell, byte_val = self.byte_selector.select_byte(
                asn, res["word_cell"], res["word_val"],
                res["byte_index_cell"], res["byte_index_val"],
                self.array_lookup.bytes_per_word,
            )
            bit_cell, bit_val = self.bit_selector.select_bit(
                asn, byte_cell, byte_val, res["bit_index_cell"], res["bit_index_val"]
            )
            bits.append(bit_cell)
            bit_vals.append(bit_val)
        return self.and_bits.and_bits(asn, bits, bit_vals)
