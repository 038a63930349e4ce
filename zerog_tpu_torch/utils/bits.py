"""Bit/limb utilities (host, Python ints).

Counterpart of ``zerog_tpu/utils/bits.py`` (reference src/utils.rs:35-108),
over plain ints (field elements on the host are ints in [0, p)).
"""

from __future__ import annotations

__all__ = ["to_be_bits", "from_be_bits", "decompose_word_be", "argmax", "integer_division"]


def to_be_bits(x: int, n_bits: int) -> list[bool]:
    """Big-endian bits of the n_bits least-significant bits of x."""
    return [bool((x >> (n_bits - 1 - i)) & 1) for i in range(n_bits)]


def from_be_bits(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(bool(b))
    return v


def decompose_word_be(word: int, num_windows: int, window_bits: int) -> list[int]:
    """Fixed-width big-endian windows of the low num_windows*window_bits bits."""
    mask = (1 << window_bits) - 1
    return [
        (word >> ((num_windows - 1 - i) * window_bits)) & mask for i in range(num_windows)
    ]


def argmax(values) -> int:
    best, idx = 0, 0
    for i, v in enumerate(values):
        if v > best:
            best, idx = v, i
    return idx


def integer_division(x: int, divisor: int) -> int:
    return int(x) // int(divisor)
