"""Image binarization gadget: thermometer-encode pixel intensities against
per-pixel thresholds.

Counterpart of reference src/gadgets/encode_image.rs:75-151. Semantics:
bit = (intensity >= threshold); since the greater-than gadget computes strict
>, the threshold is shifted by one; threshold 0 yields a constant-1 cell; the
first use of a pixel witnesses its intensity (byte range-checked), later
thresholds copy-constrain the same intensity cell.

Frozen copy of ``zerog_tpu_torch/gadgets/encode_image.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..assignment import Assignment
from ..cs import ConstraintSystem, Column
from .greater_than import GreaterThanChip, GreaterThanConfig
from .range_check import RangeCheckConfig

__all__ = ["EncodeImageConfig", "EncodeImageChip"]


@dataclasses.dataclass
class EncodeImageConfig:
    gt: GreaterThanConfig
    one_column: Column  # where constant-1 bits live (the is_gt column)


class EncodeImageChip:
    @staticmethod
    def configure(cs: ConstraintSystem, x: Column, y: Column, diff: Column,
                  is_gt: Column, rc: RangeCheckConfig) -> EncodeImageConfig:
        gt = GreaterThanChip.configure(cs, x, y, diff, is_gt, rc)
        return EncodeImageConfig(gt=gt, one_column=is_gt)

    def __init__(self, config: EncodeImageConfig, binarization_thresholds: np.ndarray):
        self.config = config
        self.thresholds = binarization_thresholds  # uint16 [W, H, B], values in [0, 256]

    def encode_image(self, asn: Assignment, image: np.ndarray):
        """Returns bit cells in (bit-plane, row, col) order — matching
        Wnn.thermometer_encoding (reference src/wnn.rs:81-96)."""
        gt_chip = GreaterThanChip(self.config.gt)
        w, h, planes = self.thresholds.shape
        intensity_cells = {}
        bit_cells = []
        for b in range(planes):
            for i in range(w):
                for j in range(h):
                    t = int(self.thresholds[i, j, b])
                    assert t <= 256
                    if t == 0:
                        row = asn.region([self.config.one_column], 1)
                        cell = asn.assign_constant(self.config.one_column, row, 1)
                        bit_cells.append(cell)
                        continue
                    x_val = int(image[i, j])
                    if (i, j) not in intensity_cells:
                        x_cell, gt_cell = gt_chip.greater_than_witness(asn, x_val, t - 1)
                        intensity_cells[(i, j)] = x_cell
                    else:
                        gt_cell = gt_chip.greater_than_copy(
                            asn, intensity_cells[(i, j)], x_val, t - 1
                        )
                    bit_cells.append(gt_cell)
        return bit_cells
