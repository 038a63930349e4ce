"""BTHOWeN-style weightless neural network (WNN): model container + inference.

Counterpart of ``zerog_tpu/models/wnn.py`` (the reference `Wnn`, src/wnn.rs):
thermometer encoding, input-bit permutation, little-endian bit packing,
MishMash hash ``(x^3 % p) % E^h`` and bloom-filter lookups. Two inference
paths:

- :meth:`Wnn.predict` — exact numpy/Python-int path (ground truth; used for
  witness generation and the public instance).
- :meth:`Wnn.predict_fn` — a vectorized torch forward pass on a device; the
  cube mod p uses Barrett reduction over 16-bit limbs
  (:mod:`zerog_tpu_torch.ops.limbmath`) because intermediates reach 147 bits.

Both agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..ops import limbmath as lm

__all__ = ["Wnn"]


@dataclasses.dataclass
class Wnn:
    """A WNN model. Construct directly, from a seed
    (:func:`zerog_tpu_torch.models.make_synthetic_wnn`) or from the JAX
    package's fields (:func:`zerog_tpu_torch.convert.wnn_from_reference`)."""

    num_classes: int
    num_filter_inputs: int    # bits per filter input
    num_filter_entries: int   # bloom array length E (power of two)
    num_filter_hashes: int    # h
    p: int                    # MishMash prime
    bloom_filters: np.ndarray          # bool [C, N, E]
    input_permutation: np.ndarray      # int64 [num_input_bits]
    binarization_thresholds: np.ndarray  # uint16 [W, H, B], values in [0, 256]

    # ---- derived shapes --------------------------------------------------
    @property
    def num_inputs(self) -> int:
        return self.bloom_filters.shape[1]

    @property
    def bits_per_hash(self) -> int:
        return int(math.log2(self.num_filter_entries))

    @property
    def l(self) -> int:
        return self.num_filter_hashes * self.bits_per_hash

    @property
    def img_shape(self):
        return self.binarization_thresholds.shape[:2]

    # ---- exact host inference (ground truth) -----------------------------
    def thermometer_encoding(self, image: np.ndarray) -> np.ndarray:
        """bool bits in (bit-plane, row, col) order (reference: src/wnn.rs:81-96)."""
        img = np.asarray(image, dtype=np.uint16)
        thr = self.binarization_thresholds  # [W, H, B]
        bits = img[None, :, :] >= thr.transpose(2, 0, 1)  # [B, W, H]
        return bits.reshape(-1)

    def encode_image(self, image: np.ndarray) -> np.ndarray:
        """Permute bits and pack little-endian into filter indices
        (reference: src/wnn.rs:106-128)."""
        bits = self.thermometer_encoding(image)
        assert bits.shape[0] == self.input_permutation.shape[0]
        permuted = bits[self.input_permutation.astype(np.int64)]
        chunks = permuted.reshape(-1, self.num_filter_inputs)
        weights = (1 << np.arange(self.num_filter_inputs, dtype=object))
        return (chunks * weights).sum(axis=1)  # object ints (may exceed 64 bits)

    def mish_mash_hash(self, x: int) -> int:
        """(x^3 % p) % E^h (reference: src/wnn.rs:98-103)."""
        return (pow(int(x), 3) % self.p) % (self.num_filter_entries ** self.num_filter_hashes)

    def bloom_filter_lookup(self, bloom_array: np.ndarray, filter_index: int) -> bool:
        h = self.mish_mash_hash(filter_index)
        e = self.num_filter_entries
        for i in range(self.num_filter_hashes):
            if not bloom_array[(h // (e ** i)) % e]:
                return False
        return True

    def predict(self, image: np.ndarray) -> np.ndarray:
        """Per-class scores (the public instance), exact (reference: src/wnn.rs:152-173)."""
        with trace.span("frontend.predict"):
            filter_indices = self.encode_image(image)
            assert filter_indices.shape[0] == self.num_inputs
            scores = np.zeros(self.num_classes, dtype=np.int64)
            for c in range(self.num_classes):
                for n, idx in enumerate(filter_indices):
                    scores[c] += self.bloom_filter_lookup(self.bloom_filters[c, n], idx)
            return scores

    # ---- proving workflow (reference src/wnn.rs:175-280) -----------------
    def get_circuit_params(self):
        from ..gadgets.wnn_circuit import WnnCircuitParams

        return WnnCircuitParams(
            p=self.p,
            l=self.l,
            n_hashes=self.num_filter_hashes,
            bits_per_hash=self.bits_per_hash,
            bits_per_filter=self.num_filter_inputs,
            n_classes=self.bloom_filters.shape[0],
        )

    def get_circuit(self, image: np.ndarray):
        from ..gadgets.wnn_circuit import WnnCircuit

        return WnnCircuit(
            np.asarray(image), self.bloom_filters, self.binarization_thresholds,
            self.input_permutation, self.get_circuit_params(),
        )

    def mock_proof(self, image: np.ndarray, k: int):
        """Assert all constraints are satisfied (reference src/wnn.rs:204-210)."""
        from ..plonk.mock import MockProver

        outputs = [int(v) for v in self.predict(image)]
        prover = MockProver.run(self.get_circuit(image), [outputs], k=k)
        prover.assert_satisfied()

    def plot_circuit(self, filename: str, k: int):
        """Render the circuit layout (reference src/wnn.rs:198-201)."""
        from ..plonk.mock import MockProver
        from ..plonk.layout import render_layout

        dummy = np.zeros(self.img_shape, dtype=np.uint8)
        outputs = [int(v) for v in self.predict(dummy)]
        prover = MockProver.run(self.get_circuit(dummy), [outputs], k=k)
        return render_layout(prover.a, filename, title="WNN Layout")

    def generate_proving_key(self, srs):
        """Keys are input-independent: synthesize with a dummy zero image
        (reference src/wnn.rs:219-229). Runs on the SRS's device."""
        from ..plonk.keygen import keygen

        dummy = np.zeros(self.img_shape, dtype=np.uint8)
        return keygen(self.get_circuit(dummy), srs.k, srs)

    def proof(self, pk, srs, image: np.ndarray, rng_seed=None, timings=None):
        """Returns (proof_bytes, outputs) (reference src/wnn.rs:232-262).
        `timings`: optional dict filled with per-phase prover wall times.
        Runs on the SRS's device, inside the root span ``proof``
        (:mod:`zerog_tpu_torch.trace`)."""
        from ..plonk.prover import create_proof

        with trace.proof():
            outputs = [int(v) for v in self.predict(image)]
            proof = create_proof(pk, srs, self.get_circuit(image), [outputs],
                                 rng_seed=rng_seed, timings=timings)
        return proof, outputs

    @staticmethod
    def verify_proof(proof: bytes, srs, vk, outputs) -> bool:
        from ..plonk.verifier import verify_proof

        return verify_proof(vk, srs, [[int(v) for v in outputs]], proof)

    # ---- device inference ------------------------------------------------
    def predict_fn(self, device=None):
        """Returns ``f(image_u8[W, H]) -> scores int32[C]`` on `device`
        (``None`` means the CUDA card).

        The model (bloom filters, thresholds, permutation) is held on the
        device; only the image is an argument, matching the secret-witness
        role it plays in the circuit.
        """
        dev = resolve_device(device)
        thr = torch.from_numpy(
            self.binarization_thresholds.astype(np.int64)).to(dev)  # [W,H,B]
        perm = torch.from_numpy(self.input_permutation.astype(np.int64)).to(dev)
        bloom = torch.from_numpy(self.bloom_filters.astype(np.uint8)).to(dev)
        fi = self.num_filter_inputs
        n_hashes = self.num_filter_hashes
        bph = self.bits_per_hash
        p = self.p
        x_limbs = (fi + lm.LIMB_BITS - 1) // lm.LIMB_BITS
        cube_limbs = (3 * fi + lm.LIMB_BITS - 1) // lm.LIMB_BITS

        def forward(image):
            if isinstance(image, torch.Tensor):
                img = image.to(device=dev, dtype=torch.int64)
            else:
                img = torch.from_numpy(np.asarray(image).astype(np.int64)).to(dev)
            bits = (img[None, :, :] >= thr.permute(2, 0, 1)).reshape(-1)
            chunks = bits[perm].to(torch.int64).reshape(-1, fi)  # [N, fi]
            # pack little-endian into 16-bit limbs
            limbs = []
            for j in range(x_limbs):
                sl = chunks[:, j * 16 : min((j + 1) * 16, fi)]
                w = 1 << torch.arange(sl.shape[1], dtype=torch.int64, device=dev)
                limbs.append((sl * w).sum(dim=1))
            x = torch.stack(limbs, dim=-1)  # [N, x_limbs]
            x3 = lm.lmul(lm.lmul(x, x), x, out_limbs=cube_limbs)
            hmod = lm.barrett_mod(x3, p, cube_limbs)  # [N, <=5 limbs]
            # split into n_hashes digits of bph bits each
            digits = []
            for k in range(n_hashes):
                a = k * bph
                j, r = a // 16, a % 16
                v = hmod[..., j] >> r
                if j + 1 < hmod.shape[-1]:
                    v = v | (hmod[..., j + 1] << (16 - r))
                if 16 - r + 16 < bph + 16 and j + 2 < hmod.shape[-1]:
                    v = v | (hmod[..., j + 2] << (32 - r))
                digits.append(v & ((1 << bph) - 1))
            dig = torch.stack(digits, dim=-1)  # [N, h]
            idx = dig[None].expand((bloom.shape[0],) + tuple(dig.shape))
            gathered = torch.gather(bloom, 2, idx)  # [C, N, h]
            resp = (gathered > 0).all(dim=2)  # [C, N]
            return resp.sum(dim=1, dtype=torch.int32)  # [C]

        return forward
