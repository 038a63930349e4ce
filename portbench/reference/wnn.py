"""BTHOWeN-style weightless neural network: the model the benchmark makes from
a configuration's seed, its exact inference (the public scores) and its
circuit.

Frozen copy of ``Wnn`` of ``zerog_tpu_torch/models/wnn.py`` (without the
device inference and the proving calls) and of
``zerog_tpu_torch/models/synthetic.py``, taken when the benchmark was
defined.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Wnn", "make_synthetic_wnn", "largest_prime_below"]


@dataclasses.dataclass
class Wnn:
    """A WNN model: its arrays, exact inference and its circuit."""

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
        filter_indices = self.encode_image(image)
        assert filter_indices.shape[0] == self.num_inputs
        scores = np.zeros(self.num_classes, dtype=np.int64)
        for c in range(self.num_classes):
            for n, idx in enumerate(filter_indices):
                scores[c] += self.bloom_filter_lookup(self.bloom_filters[c, n], idx)
        return scores

    # ---- proving workflow (reference src/wnn.rs:175-280) -----------------
    def get_circuit_params(self):
        from .gadgets.wnn_circuit import WnnCircuitParams

        return WnnCircuitParams(
            p=self.p,
            l=self.l,
            n_hashes=self.num_filter_hashes,
            bits_per_hash=self.bits_per_hash,
            bits_per_filter=self.num_filter_inputs,
            n_classes=self.bloom_filters.shape[0],
        )

    def get_circuit(self, image: np.ndarray):
        from .gadgets.wnn_circuit import WnnCircuit

        return WnnCircuit(
            np.asarray(image), self.bloom_filters, self.binarization_thresholds,
            self.input_permutation, self.get_circuit_params(),
        )

    def predict_float64(self, image: np.ndarray) -> np.ndarray:
        """The scores with the MishMash cube taken in float64, the precision
        below the exact integers the model states: the control of the
        benchmark's check (x^3 overflows the 53-bit mantissa)."""
        e = self.num_filter_entries
        scores = np.zeros(self.num_classes, dtype=np.int64)
        for n, idx in enumerate(self.encode_image(image)):
            h = int(math.fmod(math.fmod(float(idx) ** 3, float(self.p)),
                              float(e ** self.num_filter_hashes)))
            for c in range(self.num_classes):
                scores[c] += all(self.bloom_filters[c, n][(h // (e ** i)) % e]
                                 for i in range(self.num_filter_hashes))
        return scores


def _is_probable_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def largest_prime_below(bound: int) -> int:
    n = bound - 1
    while not _is_probable_prime(n):
        n -= 1
    return n


def make_synthetic_wnn(num_filter_inputs: int = 49,
                       num_filter_entries: int = 8192,
                       num_filter_hashes: int = 4,
                       bits_per_input: int = 6,
                       img_shape=(28, 28),
                       num_classes: int = 10,
                       density: float = 0.3,
                       seed: int = 0) -> Wnn:
    """A random model with the given circuit shape. The MishMash prime is
    the largest prime below 2^(l+1), matching the checked-in models
    (e.g. MNIST-Small: l=20, p=2097143 = largest prime < 2^21)."""
    total_bits = img_shape[0] * img_shape[1] * bits_per_input
    if total_bits % num_filter_inputs:
        raise ValueError(
            f"{total_bits} input bits not divisible by {num_filter_inputs}")
    n_filters = total_bits // num_filter_inputs
    rng = np.random.default_rng(seed)
    l_bits = num_filter_hashes * int(np.log2(num_filter_entries))
    p = largest_prime_below(1 << (l_bits + 1))
    thresholds = np.sort(
        rng.integers(1, 256, (img_shape[0], img_shape[1], bits_per_input)),
        axis=2,
    ).astype(np.uint16)
    return Wnn(
        num_classes=num_classes,
        num_filter_inputs=num_filter_inputs,
        num_filter_entries=num_filter_entries,
        num_filter_hashes=num_filter_hashes,
        p=p,
        bloom_filters=rng.random((num_classes, n_filters, num_filter_entries))
        < density,
        input_permutation=rng.permutation(total_bits).astype(np.int64),
        binarization_thresholds=thresholds,
    )
