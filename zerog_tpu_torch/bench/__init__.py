"""Measuring kernels of the port and their benchmarks on the card.

Counterparts of the JAX package's two TPU benchmark scripts, each a kernel
with its plain version and a ``main``:

    python -m zerog_tpu_torch.bench.field_chain [log_n]   # kernel 8
    python -m zerog_tpu_torch.bench.scan_bisect           # kernel 9

Both run on the CUDA card and raise without one. This module holds what they
share: seeded canonical inputs, CUDA-event timing, and the least time the
card could take for a piece of work (its bound), and :func:`plain_field`, under
which the plain versions of the kernels run plain torch arithmetic on the card.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time

import numpy as np
import torch

from ..field.jfield import JField

__all__ = ["PEAK_BYTES_PER_S", "PEAK_INT32_MAD_PER_S", "IMAD_SLOTS_PER_MUL",
           "random_words", "time_ms", "wall_ms", "plain_field", "bound",
           "flush_scan_affine_bound", "segment_ids", "gpu_line"]

# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of device
# memory; 67 TFLOP/s float32 outside the tensor cores = 33.5e12 fused
# multiply-adds a second, and the pipe that issues 32-bit integer
# multiply-adds (IMAD) takes half as many lanes: 132 SMs x 64 lanes x 1.98
# GHz (the card's clocks.max.sm) = 16.7e12 issue slots a second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_MAD_PER_S = 16.75e12
# IMAD-pipe issue slots of one Montgomery product of 8-word operands
# (fe_mul<F> of csrc/field.cuh) on sm_90a: the loop of field_chain_kernel<1>,
# one product an iteration, read by `python -m zerog_tpu_torch.bench.sass`
# (cuobjdump -sass of the built library). IMAD, IMAD.HI, IMAD.X, IMAD.MOV,
# IMAD.IADD and IMAD.SHL take one slot, IMAD.WIDE two. Read with nvcc 12.9
# for an NVIDIA H100 80GB HBM3: 119 IMAD.WIDE (22 IMAD.WIDE.U32, 97
# IMAD.WIDE.U32.X) = 238 slots, 9 IMAD.HI.U32, 9 IMAD; no IMAD.X, IMAD.MOV,
# IMAD.IADD or IMAD.SHL. ptxas fuses the PTX's mad.lo / madc.hi pairs into
# IMAD.WIDE, so the 264 multiply-adds of the PTX take 256 slots. The loop's
# other 50 instructions (38 IADD3, 8 LOP3.LUT, the loop's count and branch)
# run on other pipes and are left out.
IMAD_SLOTS_PER_MUL = 256


def random_words(rng: np.random.Generator, shape) -> torch.Tensor:
    """Canonical field elements (< 2^253, below both BN254 primes) drawn from
    `rng` as int32 word planes ``shape[:-1] + (8, shape[-1])``: the top word
    keeps 29 bits, the top 16-bit limb 13, as the kernels' checks mask it."""
    *lead, n = shape
    w = rng.integers(0, 1 << 32, size=(*lead, 8, n), dtype=np.uint32)
    w[..., 7, :] &= 0x1FFFFFFF
    return torch.from_numpy(w.view(np.int32))


# cycles the card spins before each timed run (~1 ms at 1.98 GHz)
LEAD_CYCLES = 2_000_000


def time_ms(fn, reps=5, warm=1):
    """Median milliseconds of `fn`'s work on the card by CUDA events, after a
    warm-up. Each run waits on the card behind a spin of LEAD_CYCLES, so that
    the host has enqueued its launches before the first event fires: the
    events time the card's work, not the host's wrappers around it (which
    take longer than a short kernel)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(LEAD_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def wall_ms(fn):
    """(fn(), its milliseconds on the host's clock), the card synchronised
    before and after: for a plain version's one run."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t0) * 1e3


@contextlib.contextmanager
def plain_field():
    """While active, JField's add, sub and mul run their plain torch bodies
    (``add_plain``, ``sub_plain``, ``mul_plain``) on every device, and so do
    the ops derived from them. The plain versions of the kernels reach JField
    (through ``jpoints``, ``pntt``'s plain bodies, the NTT butterflies); on a
    CUDA tensor its ops are otherwise launches of ``field_limbs``, built on
    the same ``field.cuh`` bodies as the kernels those plain versions check."""
    saved = {op: JField.__dict__[op] for op in ("add", "sub", "mul")}
    for op in saved:
        setattr(JField, op, JField.__dict__[op + "_plain"])
    try:
        yield
    finally:
        for op, fn in saved.items():
            setattr(JField, op, fn)


def bound(nbytes, slots):
    """(ms, "bytes" or "operations"): the larger of the bytes over the memory
    rate and the IMAD-pipe issue slots over their peak rate."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = slots / PEAK_INT32_MAD_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def flush_scan_affine_bound(rows, cols, valid_rows=None, adds=None):
    """bound() of one ``flush_scan_affine`` launch over R x C: the valid and
    flag bytes of every row read and x, y of `valid_rows` rows, the three
    output words written every row and the carry's once; one mixed add (11
    products) for each of `adds`. Both default to every row."""
    n = rows * cols
    valid_rows = n if valid_rows is None else valid_rows
    adds = n if adds is None else adds
    return bound(n * (2 + 3 * 32) + 2 * 32 * valid_rows + 3 * 32 * cols,
                 adds * 11 * IMAD_SLOTS_PER_MUL)


def segment_ids(flags):
    """Flush flags [R, C] -> int64 [R, C]: one id a (column, segment), below
    (R + 1) C. A segment of a flush scan runs from row 0 or a flagged row up
    to the next flag."""
    r, c = flags.shape
    seg = torch.cumsum(flags.to(torch.int64), dim=0)
    return seg + (r + 1) * torch.arange(c, device=flags.device)[None, :]


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
