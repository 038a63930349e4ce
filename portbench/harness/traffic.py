"""The one generator of requests, driven by a traffic mix's file.

A mix (``portbench/traffic/<name>.json``) gives:

- ``loop``: ``"closed"``: the client sends its next request when the last
  one is answered;
- ``clients``: 1, the one client the harness drives (several clients on one
  card wait for a mix of client processes);
- ``image``: ``{"pixels": "uniform_u8", "shape": [H, W]}``: every request
  carries a new image, its pixels drawn uniformly from 0-255.

Request ``index`` under ``--seed`` always carries the same image and the same
blinding seed, whatever the timing: the work of a run is fixed by the seed,
the mix and the number of requests the window holds.
"""

from __future__ import annotations

import hashlib

import numpy as np

WARMUP = -1     # the index of set-up's warm proof


def image(mix: dict, seed: int, index: int) -> np.ndarray:
    spec = mix["image"]
    if spec["pixels"] != "uniform_u8":
        raise ValueError(f"unknown pixel rule {spec['pixels']!r}")
    rng = np.random.default_rng([int(seed) % (1 << 64), index + 1])
    return rng.integers(0, 256, tuple(spec["shape"])).astype(np.uint8)


def rng_seed(seed: int, index: int) -> bytes:
    """The prover's blinding seed of one request."""
    return hashlib.blake2b(f"{int(seed)}:{index}".encode(), digest_size=32).digest()


def check_mix(mix: dict) -> None:
    if mix.get("loop") != "closed":
        raise ValueError(f"unknown loop {mix.get('loop')!r}: only closed loops")
    if int(mix["clients"]) != 1:
        raise ValueError("only one client: several on one card need a mix of "
                         "client processes, which the harness does not drive")
