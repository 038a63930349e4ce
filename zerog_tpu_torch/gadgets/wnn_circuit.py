"""The WNN proof-of-inference circuit: the full chip stack wired over 6 shared
advice columns, proving that the secret image produces the public per-class
score vector.

Counterpart of reference src/gadgets/wnn.rs (WnnChip / WnnCircuit): encode
image -> permute bits -> bits2num per filter -> MishMash hash -> bloom lookups
(n_classes x n_inputs, array_index = c * n_inputs + i) -> response
accumulation -> instance constraints. Column sharing matches the reference's
WnnChip::configure (src/gadgets/wnn.rs:125-172).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import trace
from ..plonk.assignment import Assignment
from ..plonk.cs import ConstraintSystem
from .bits2num import Bits2NumChip
from .bloom_filter import BloomFilterChip, BloomFilterConfig
from .encode_image import EncodeImageChip
from .hash import HashChip, HashFunctionConfig
from .range_check import RangeCheckChip
from .response_accumulator import ResponseAccumulatorChip

__all__ = ["WnnCircuitParams", "WnnCircuit"]


@dataclasses.dataclass
class WnnCircuitParams:
    p: int
    l: int
    n_hashes: int
    bits_per_hash: int
    bits_per_filter: int
    n_classes: int

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: int(v) for k, v in d.items()})


class WnnCircuit:
    """Circuit object (configure/synthesize protocol). The witness is the
    image; bloom arrays / thresholds / permutation are circuit constants."""

    def __init__(self, image: np.ndarray, bloom_filter_arrays: np.ndarray,
                 binarization_thresholds: np.ndarray, input_permutation: np.ndarray,
                 params: WnnCircuitParams):
        assert bloom_filter_arrays.shape[0] == params.n_classes
        self.image = image
        self.bloom_filter_arrays = bloom_filter_arrays
        self.binarization_thresholds = binarization_thresholds
        self.input_permutation = input_permutation
        self.params = params

    def without_witnesses(self):
        return WnnCircuit(
            np.zeros_like(self.image), self.bloom_filter_arrays,
            self.binarization_thresholds, self.input_permutation, self.params,
        )

    def configure(self, cs: ConstraintSystem):
        return self.configure_with_params(cs, self.params)

    @staticmethod
    def configure_with_params(cs: ConstraintSystem, params: WnnCircuitParams):
        """Shape-only configuration (reference src/gadgets/wnn.rs:334-371);
        used to reconstruct keys against the circuit shape without model data."""
        instance = cs.instance_column()
        advice = [cs.advice_column() for _ in range(6)]
        for col in advice:
            cs.enable_equality(col)
        cs.enable_equality(instance)
        constants = cs.fixed_column()
        cs.enable_constant(constants)

        bloom_cfg = BloomFilterChip.configure(
            cs, advice, BloomFilterConfig(params.n_hashes, params.bits_per_hash)
        )
        rc_cfg = RangeCheckChip.configure(cs, advice[5], bloom_cfg.bit_selector.byte_table)
        encode_cfg = EncodeImageChip.configure(
            cs, advice[0], advice[1], advice[2], advice[3], rc_cfg
        )
        hash_cfg = HashChip.configure(
            cs, advice[0], advice[1], advice[2], advice[3], advice[4], rc_cfg,
            HashFunctionConfig(p=params.p, l=params.l, n_bits=params.bits_per_filter),
        )
        acc_cfg = ResponseAccumulatorChip.configure(cs, advice[:5])
        b2n_cfg = Bits2NumChip.configure(cs, advice[3], advice[4])
        return dict(
            instance=instance, advice=advice, bloom=bloom_cfg, rc=rc_cfg,
            encode=encode_cfg, hash=hash_cfg, acc=acc_cfg, b2n=b2n_cfg,
        )

    def synthesize(self, config, asn: Assignment):
        with trace.span("frontend.synthesize"):
            params = self.params
            c, n_inputs, e = self.bloom_filter_arrays.shape
            flat = self.bloom_filter_arrays.reshape(c * n_inputs, e)

            bloom_chip = BloomFilterChip(config["bloom"], flat)
            with trace.span("frontend.bloom_load"):
                bloom_chip.load(asn)

            encode_chip = EncodeImageChip(config["encode"], self.binarization_thresholds)
            with trace.span("frontend.encode_image"):
                bit_cells = encode_chip.encode_image(asn, self.image)

            # recompute bit values for witness bookkeeping
            img = np.asarray(self.image, dtype=np.uint16)
            thr = self.binarization_thresholds
            bits = (img[None, :, :] >= thr.transpose(2, 0, 1)).reshape(-1).astype(int)

            perm = self.input_permutation.astype(np.int64)
            permuted_cells = [bit_cells[i] for i in perm]
            permuted_bits = bits[perm]

            b2n_chip = Bits2NumChip(config["b2n"])
            hash_chip = HashChip(config["hash"])
            nfi = params.bits_per_filter

            hash_cells = []
            hash_values = []
            for i in range(n_inputs):
                with trace.span("frontend.hash"):
                    chunk_cells = permuted_cells[i * nfi : (i + 1) * nfi]
                    chunk_bits = permuted_bits[i * nfi : (i + 1) * nfi]
                    num_cell, num_val = b2n_chip.convert_le(asn, chunk_cells, chunk_bits)
                    h_cell, h_val = hash_chip.hash(asn, num_cell, num_val)
                hash_cells.append(h_cell)
                hash_values.append(h_val)

            acc_chip = ResponseAccumulatorChip(config["acc"])
            score_cells = []
            for cls in range(params.n_classes):
                resp_cells = []
                resp_vals = []
                for i in range(n_inputs):
                    array_index = cls * n_inputs + i
                    with trace.span("frontend.bloom_lookup"):
                        bit_cell, bit_val = bloom_chip.bloom_lookup(
                            asn, hash_cells[i], hash_values[i], array_index
                        )
                    resp_cells.append(bit_cell)
                    resp_vals.append(bit_val)
                with trace.span("frontend.accumulate"):
                    s_cell, s_val = acc_chip.accumulate(asn, resp_cells, resp_vals)
                score_cells.append((s_cell, s_val))

            for i, (cell, _) in enumerate(score_cells):
                asn.constrain_instance(cell, config["instance"], i)
            return [v for _, v in score_cells]
