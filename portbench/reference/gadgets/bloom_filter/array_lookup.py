"""Array lookup: decompose the hash into per-hash digits and look up the
word-packed bloom entry in a (bloom_index, word_index, word) table.

Counterpart of reference src/gadgets/bloom_filter/array_lookup.rs:94-301.
The running hash decomposition implicitly range-checks the full hash (the
terminal cell is constant 0); the word index is reconstructed inside the
lookup expression via a constant multiplicative-inverse shift. Inactive rows
look up the sentinel (-1, -1, -1) table row via the selector-default trick.

Frozen copy of ``zerog_tpu_torch/gadgets/bloom_filter/array_lookup.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...field import FR
from ...assignment import Assignment
from ...cs import ConstraintSystem, Column, Selector, TableColumn
from ...expression import Constant, Product, Scaled, Sum

__all__ = ["ArrayLookupParams", "ArrayLookupConfig", "ArrayLookupChip", "array_lookup_params"]


@dataclasses.dataclass
class ArrayLookupParams:
    n_hashes: int
    bits_per_hash: int
    word_index_bits: int


def array_lookup_params(n_hashes: int, bits_per_hash: int) -> ArrayLookupParams:
    """Balance advice rows vs table rows (reference array_lookup.rs:49-75)."""
    if bits_per_hash < 7:
        raise ValueError("use a single-bit bloom filter for tiny arrays")
    import math

    byte_index_bits = int((bits_per_hash - 3) / 2 - math.floor(math.log2(n_hashes)))
    word_bits = byte_index_bits + 3
    return ArrayLookupParams(n_hashes, bits_per_hash, bits_per_hash - word_bits)


@dataclasses.dataclass
class ArrayLookupConfig:
    hash_decomposition: Column
    byte_index: Column
    bit_index: Column
    bloom_index: Column
    bloom_value: Column
    q_bloom: Selector
    t_bloom_index: TableColumn
    t_word_index: TableColumn
    t_word: TableColumn
    params: ArrayLookupParams


class ArrayLookupChip:
    @staticmethod
    def configure(cs: ConstraintSystem, hash_decomposition, byte_index, bit_index,
                  bloom_index, bloom_value, params: ArrayLookupParams) -> ArrayLookupConfig:
        assert params.bits_per_hash <= 32
        t_bloom_index = cs.lookup_table_column()
        t_word_index = cs.lookup_table_column()
        t_word = cs.lookup_table_column()
        q_bloom = cs.complex_selector()

        q = q_bloom.expr()
        cur = hash_decomposition.cur()
        nxt = hash_decomposition.next()
        # current per-hash digit: cur - next * 2^bits_per_hash
        current_hash = Sum(cur, Scaled(nxt, -(1 << params.bits_per_hash)))
        inv_shift = pow(1 << (params.bits_per_hash - params.word_index_bits), -1, FR.p)
        word_index = Scaled(
            Sum(current_hash,
                Sum(Scaled(byte_index.cur(), -8), Scaled(bit_index.cur(), -1))),
            inv_shift,
        )
        minus_one = FR.p - 1

        def with_default(x):
            # q*x + (1-q)*(-1)
            return Sum(Product(q, x), Sum(Constant(minus_one), Scaled(Product(q, Constant(minus_one)), -1)))

        cs.lookup("bloom_filter", [
            (with_default(bloom_index.cur()), t_bloom_index),
            (with_default(word_index), t_word_index),
            (with_default(bloom_value.cur()), t_word),
        ])
        return ArrayLookupConfig(
            hash_decomposition=hash_decomposition, byte_index=byte_index,
            bit_index=bit_index, bloom_index=bloom_index, bloom_value=bloom_value,
            q_bloom=q_bloom, t_bloom_index=t_bloom_index, t_word_index=t_word_index,
            t_word=t_word, params=params,
        )

    def __init__(self, config: ArrayLookupConfig, bloom_filter_arrays: np.ndarray):
        self.config = config
        p = config.params
        word_len = 1 << (p.bits_per_hash - p.word_index_bits)
        n_arrays, n_bits = bloom_filter_arrays.shape
        assert n_bits == 1 << p.bits_per_hash
        # pack big-endian bit chunks into word integers
        # (reference array_lookup.rs:139-159)
        bits = bloom_filter_arrays.astype(np.uint8).reshape(n_arrays, n_bits // word_len, word_len)
        weights = np.array([1 << (word_len - 1 - i) for i in range(word_len)], dtype=object)
        self.words = (bits * weights).sum(axis=2)  # object [n_arrays, n_words]

    @property
    def bytes_per_word(self) -> int:
        p = self.config.params
        return 1 << (p.bits_per_hash - p.word_index_bits - 3)

    def load(self, asn: Assignment):
        cfg = self.config
        n_arrays, n_words = self.words.shape
        bloom_idx = np.repeat(np.arange(n_arrays, dtype=object), n_words)
        word_idx = np.tile(np.arange(n_words, dtype=object), n_arrays)
        vals = self.words.reshape(-1)
        minus_one = FR.p - 1
        asn.assign_table(
            [cfg.t_bloom_index, cfg.t_word_index, cfg.t_word],
            [list(bloom_idx) + [minus_one], list(word_idx) + [minus_one],
             list(vals) + [minus_one]],
        )

    def array_lookup(self, asn: Assignment, hash_cell, hash_value: int, bloom_index: int):
        """Returns per-hash dicts (big-endian order, reference
        array_lookup.rs:442-452) with word/byte_index/bit_index cells+values."""
        cfg = self.config
        p = cfg.params
        h = p.n_hashes
        bph = p.bits_per_hash
        mask = (1 << bph) - 1

        digits = [(hash_value >> (k * bph)) & mask for k in range(h)]  # LE order
        decomp = [hash_value]
        for k in range(h):
            decomp.append((decomp[-1] - digits[k]) >> bph)
        assert decomp[-1] == 0, "hash exceeds n_hashes * bits_per_hash bits"

        start = asn.region(
            [cfg.hash_decomposition, cfg.byte_index, cfg.bit_index,
             cfg.bloom_index, cfg.bloom_value, cfg.q_bloom], h + 1,
        )
        rows = list(range(start, start + h + 1))
        d_cells = asn.assign_advice(cfg.hash_decomposition, rows, decomp)
        asn.copy(hash_cell, d_cells[0])
        asn.copy(d_cells[h], asn.constant_cell(0))

        results = []
        lo_bits = bph - p.word_index_bits
        for k in range(h):
            d = digits[k]
            word_index = d >> lo_bits
            byte_index = (d & ((1 << lo_bits) - 1)) >> 3
            bit_index = d & 0b111
            word_val = int(self.words[bloom_index, word_index])
            asn.assign_constant(cfg.bloom_index, rows[k], bloom_index)
            (bi_cell,) = asn.assign_advice(cfg.byte_index, rows[k], byte_index)
            (bit_cell,) = asn.assign_advice(cfg.bit_index, rows[k], bit_index)
            (w_cell,) = asn.assign_advice(cfg.bloom_value, rows[k], word_val)
            results.append(dict(
                word_cell=w_cell, word_val=word_val,
                byte_index_cell=bi_cell, byte_index_val=byte_index,
                bit_index_cell=bit_cell, bit_index_val=bit_index,
            ))
        asn.enable_selector(cfg.q_bloom, rows[:h])
        return list(reversed(results))
