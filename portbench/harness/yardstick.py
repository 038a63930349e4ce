"""The benchmark's yardstick for the kernel layer: the card's peaks, the cost
of one field product, and the least time a call's inputs need.

Everything here is frozen with the benchmark, so that a later change to a
kernel cannot move the count it is measured against. The constants and
``bound`` are copies of ``zerog_tpu_torch/bench/__init__.py`` (``bound`` at
its line 100); ``segment_adds`` is a copy of ``_segment_adds`` of
``chip_smoke.py:358``; the product counts of an add are chip_smoke's
(``MULS_ADD``, ``chip_smoke.py:175``) and ``flush_scan_affine_bound``'s
(``zerog_tpu_torch/bench/__init__.py:110``, 11 products a mixed add).

The work is counted from what a call is given, never from what the program
launches for it:

- an MSM call (``Srs.commit*``) gets m columns of n scalars over a fixed
  basis of n points. A bucket method with window c = ``msm_window(n)`` needs,
  for each column, one mixed add for every nonzero window digit after the
  first in its bucket, and two general adds for each nonempty bucket after
  the first to weigh the buckets together; it reads each scalar once and, of
  the points, only those a nonzero digit selects, once for the whole call.
- an NTT call (``NttPlan.ntt`` / ``intt``) gets B columns of n values. The
  engine multiplies on the tensor cores, so the integer products it needs
  depend on its design; its least time is the bytes: each value read once
  and written once, 32 bytes each.
"""

from __future__ import annotations

import numpy as np
import torch

# Published peaks of one H100 SXM: 3.35 TB/s of device memory, and
# 132 SMs x 64 lanes x 1.98 GHz (clocks.max.sm) = 16.75e12 issue slots a
# second of the pipe that issues 32-bit integer multiply-adds (IMAD).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_MAD_PER_S = 16.75e12
# IMAD-pipe issue slots of one Montgomery product of 8-word operands, read
# from the SASS of the port's product (fe_mul) on sm_90a when the benchmark
# was defined.
IMAD_SLOTS_PER_MUL = 256
# products of one mixed add (affine point into a Jacobian sum) and of one
# general Jacobian add (12M + 4S)
MULS_MIXED_ADD = 11
MULS_ADD = 16

FR_P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
_R_INV = pow(1 << 256, -1, FR_P)
SCALAR_BITS = 254


def bound(nbytes, slots):
    """(seconds, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the IMAD-pipe issue slots over their peak rate."""
    tb = nbytes / PEAK_BYTES_PER_S
    to = slots / PEAK_INT32_MAD_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def segment_ids(flags):
    """Flush flags [R, C] -> int64 [R, C]: one id a (column, segment), below
    (R + 1) C. A segment runs from row 0 or a flagged row up to the next
    flag."""
    r, c = flags.shape
    seg = torch.cumsum(flags.to(torch.int64), dim=0)
    return seg + (r + 1) * torch.arange(c, device=flags.device)[None, :]


def segment_adds(nz, flags):
    """Per (column, segment) id of a fold: (ids of the rows [R*C], the rows,
    the required adds). A segment runs from row 0 or a flagged row to the
    next flag; its first row in `nz` (bool [R, C]) is copied, every later one
    is added."""
    r, c = nz.shape
    key = segment_ids(flags).reshape(-1)
    rows = torch.bincount(key, minlength=(r + 1) * c)
    adds = (torch.bincount(key[nz.reshape(-1)], minlength=(r + 1) * c) - 1).clamp(min=0)
    return key, rows, adds


def msm_window(n: int) -> int:
    """The bucket method's window width at n points."""
    return max(4, min(16, int(n).bit_length() - 2))


def scalars_to_words(values) -> np.ndarray:
    """Canonical scalars -> uint64 [m, n, 4], little-endian words.

    `values` is what a commit call was given: a list of columns of ints (or
    one column), or a Montgomery-form limb tensor [..., n, 16] (16-bit limbs
    in int64 lanes), which is brought out of Montgomery form here."""
    if isinstance(values, torch.Tensor):
        limbs = values.detach().to("cpu", torch.int64).numpy().astype(np.uint16)
        limbs = limbs.reshape(-1, limbs.shape[-2], 16)
        m, n, _ = limbs.shape
        raw = limbs.reshape(m * n, 32 // 2).tobytes()
        canon = [int.from_bytes(raw[32 * i:32 * i + 32], "little") * _R_INV % FR_P
                 for i in range(m * n)]
        buf = b"".join(v.to_bytes(32, "little") for v in canon)
        return np.frombuffer(buf, dtype=np.uint64).reshape(m, n, 4)
    cols = [values] if not isinstance(values[0], (list, tuple, np.ndarray)) else values
    n = max(len(c) for c in cols)
    out = np.zeros((len(cols), n, 4), dtype=np.uint64)
    for j, col in enumerate(cols):
        buf = b"".join((int(v) % FR_P).to_bytes(32, "little") for v in col)
        out[j, :len(col)] = np.frombuffer(buf, dtype=np.uint64).reshape(-1, 4)
    return out


def window_digits(words: np.ndarray, c: int) -> np.ndarray:
    """uint64 [..., 4] -> int64 [W, ...] c-bit window digits, W = ceil(254/c)."""
    w = (SCALAR_BITS + c - 1) // c
    out = np.empty((w,) + words.shape[:-1], dtype=np.int64)
    mask = np.uint64((1 << c) - 1)
    for j in range(w):
        lo = j * c
        q, r = divmod(lo, 64)
        d = words[..., q] >> np.uint64(r)
        if r + c > 64 and q + 1 < 4:
            d = d | (words[..., q + 1] << np.uint64(64 - r))
        out[j] = (d & mask).astype(np.int64)
    return out


def msm_work(words: np.ndarray, n_points: int) -> dict:
    """What one commit call needs, from its scalars (uint64 [m, n, 4]) over a
    basis of `n_points` points."""
    c = msm_window(n_points)
    m, n, _ = words.shape
    digits = window_digits(words, c)                     # [W, m, n]
    nz = digits != 0
    mixed = general = 0
    for j in range(m):
        d = digits[:, j, :].reshape(-1)
        live = d != 0
        # rows sorted by bucket, flagged where the bucket changes: each
        # bucket is one segment, its first digit copied and every later one
        # added
        b = np.sort(d[live])
        if b.size == 0:
            continue
        flags = np.ones(b.size, dtype=bool)
        flags[1:] = b[1:] != b[:-1]
        flags[0] = False
        _, _, adds = segment_adds(torch.ones(b.size, 1, dtype=torch.bool),
                                  torch.from_numpy(flags)[:, None])
        buckets = int(flags.sum()) + 1
        mixed += int(adds.sum())
        general += 2 * (buckets - 1)
    points_read = int(nz.any(axis=1).sum())            # (window, point) pairs
    nbytes = m * n * 32 + points_read * 64 + m * 64
    slots = (mixed * MULS_MIXED_ADD + general * MULS_ADD) * IMAD_SLOTS_PER_MUL
    least_s, by = bound(nbytes, slots)
    return dict(columns=m, n=n, window=c, nonzero_digits=int(nz.sum()),
                mixed_adds=mixed, general_adds=general, bytes=nbytes,
                least_s=least_s, bound_by=by)


def ntt_work(shape) -> dict:
    """What one transform of a [..., n, 16] limb tensor needs."""
    n = int(shape[-2])
    cols = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    nbytes = 2 * 32 * cols * n
    least_s, by = bound(nbytes, 0)
    return dict(columns=cols, n=n, bytes=nbytes, least_s=least_s, bound_by=by)
