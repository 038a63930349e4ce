"""Whether what the timed path produced is correct.

Once the window has closed and the program's state is freed, a sample of the
finished requests, drawn from the seed, is judged by the plain reference
(``portbench/reference``), which imports nothing of the program and takes
nothing it made: the reference works the model's scores out again from the
image, works the verifying key out again from the model (the circuit, its
fixed columns and permutation, each committed with the SRS's trapdoor tau,
which the benchmark knows because it made the SRS from a seed), and checks
each proof against that key and those scores.

Two numbers are compared, each with the limit 0, since both are exact:

- ``scores_wrong``: sampled requests whose public scores differ from the
  reference's;
- ``proofs_rejected``: sampled proofs that the reference's check refuses
  under the scores the request returned with them, as a user's verifier
  would hold them (a bad commitment, quotient, evaluation, grand product or
  opening fails it, and so do scores that the image does not give).

A request that never came back (it raised) counts in ``failed``; a run with
one is not correct either.
"""

from __future__ import annotations

import hashlib
import random
import sys

import numpy as np

from reference.keygen import verifying_key
from reference.verifier import verify_proof

# the most requests judged in one run: every proof of a Large window, few
# enough to judge in less time than the window
SAMPLE = 8

LIMITS = {"scores_wrong": 0, "proofs_rejected": 0}


def srs_tau(seed: str) -> int:
    """The trapdoor of the SRS made from `seed`: blake2b-256 of the seed's
    bytes, little-endian, mod r (the program's ``Srs.setup`` rule)."""
    p = 21888242871839275222246405745257275088548364400416034343698204186575808495617
    return int.from_bytes(hashlib.blake2b(seed.encode(), digest_size=32).digest(),
                          "little") % p


def sample(requests, seed: int):
    """The finished requests to judge: all of them up to SAMPLE, else SAMPLE
    drawn from the seed."""
    ok = [r for r in requests if r.error is None]
    if len(ok) <= SAMPLE:
        return ok
    return random.Random(int(seed)).sample(ok, SAMPLE)


def reference_key(model, config: dict):
    """(verifying key, tau): the key worked out by the reference from the
    model and the SRS's trapdoor."""
    tau = srs_tau(config["srs_seed"])
    circuit = model.get_circuit(np.zeros(model.img_shape, np.uint8))
    return verifying_key(circuit, int(config["k"]), tau), tau


def judge(model, config: dict, judged, scores_of=None, key=None):
    """The numbers compared, for `judged` requests. `scores_of(request)`
    gives the scores each request returned (default: the program's own);
    `key` is :func:`reference_key`'s, worked out here if not given."""
    vk, tau = key if key is not None else reference_key(model, config)
    wrong = rejected = 0
    for r in judged:
        want = [int(v) for v in model.predict(r.image)]
        got = [int(v) for v in (scores_of(r) if scores_of else r.scores)]
        wrong += got != want
        try:
            verify_proof(vk, tau, [got], r.proof)
        except (ValueError, ZeroDivisionError) as e:
            print(f"request {r.index}: {e}", file=sys.stderr)
            rejected += 1
    return {"scores_wrong": wrong, "proofs_rejected": rejected}


def verdict(numbers: dict, failed: int, judged: int) -> bool:
    return (failed == 0 and judged > 0
            and all(numbers[k] <= LIMITS[k] for k in LIMITS))
