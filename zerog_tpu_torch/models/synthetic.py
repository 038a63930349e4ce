"""Synthetic WNN models for scale rehearsal.

The reference strips the MNIST-Large blob from its repo (src/lib.rs:51 keeps
only the path and k=17), so scale testing uses a synthesized model with the
exact same shape: 49-bit filter inputs, 8192-entry bloom arrays, 4 hashes,
6 bits/input -> l = 52, minimum k = 17.
"""

from __future__ import annotations

import numpy as np

from .wnn import Wnn

__all__ = ["make_synthetic_wnn", "MNIST_LARGE_SHAPE", "largest_prime_below"]

# (num_filter_inputs, num_filter_entries, num_filter_hashes, bits_per_input)
MNIST_LARGE_SHAPE = (49, 8192, 4, 6)


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
