from .bits import to_be_bits, from_be_bits, decompose_word_be, argmax, integer_division

__all__ = ["to_be_bits", "from_be_bits", "decompose_word_be", "argmax", "integer_division"]
