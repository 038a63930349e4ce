"""The WNN circuit's gadgets (chips) over the port's PLONK IR.

Counterpart of ``zerog_tpu/gadgets``: host Python that declares columns,
gates and lookups on a :class:`~zerog_tpu_torch.plonk.ConstraintSystem` and
fills an :class:`~zerog_tpu_torch.plonk.Assignment`; the same modules, names
and layout, so both packages synthesize the same circuit cell for cell.

Frozen copy of ``zerog_tpu_torch/gadgets/__init__.py``, taken when the benchmark was
defined; only its imports differ.
"""

from .range_check import RangeCheckChip, RangeCheckConfig
from .greater_than import GreaterThanChip, GreaterThanConfig
from .encode_image import EncodeImageChip, EncodeImageConfig
from .bits2num import Bits2NumChip, Bits2NumConfig
from .hash import HashChip, HashConfig, HashFunctionConfig
from .response_accumulator import ResponseAccumulatorChip, ResponseAccumulatorConfig
from .bloom_filter import (
    BloomFilterChip, BloomFilterChipConfig, BloomFilterConfig,
    ArrayLookupChip, ByteSelectorChip, BitSelectorChip, AndBitsChip,
)
from .wnn_circuit import WnnCircuit, WnnCircuitParams

__all__ = [
    "RangeCheckChip", "RangeCheckConfig", "GreaterThanChip", "GreaterThanConfig",
    "EncodeImageChip", "EncodeImageConfig", "Bits2NumChip", "Bits2NumConfig",
    "HashChip", "HashConfig", "HashFunctionConfig",
    "ResponseAccumulatorChip", "ResponseAccumulatorConfig",
    "BloomFilterChip", "BloomFilterChipConfig", "BloomFilterConfig",
    "ArrayLookupChip", "ByteSelectorChip", "BitSelectorChip", "AndBitsChip",
    "WnnCircuit", "WnnCircuitParams",
]
