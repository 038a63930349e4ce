"""Kernel 8, ``field_chain``: k chained Montgomery products an element in one
launch, its plain version, and the benchmark around it.

Counterpart of ``scripts/bench_pallas_field.py`` (the ``fused16`` kernel and
the script that times it beside 16 launches of the elementwise product and
beside the plain chain). The public layout is :mod:`..field.pfield`'s:
``[16, M, 128]`` limb planes. :func:`field_chain` takes planes on either
device: a CPU tensor goes to the plain version, a CUDA tensor to the kernel.

    python -m zerog_tpu_torch.bench.field_chain [log_n]

prints, at n = 2^log_n elements of Fr (18 by default, the script's), M
products/s for 16 launches of ``field_binop`` (the script's "pallas
chained"), for the fused chain and for the plain version (the script's XLA
chain), then checks that the three agree limb for limb. It runs on the card
and raises without one.

Inputs: canonical Montgomery values made with numpy from a seed, the top
16-bit limb masked to 13 bits, 0, 1 and p - 1 among them. The TPU script
draws 31 random bytes mod p; the port's product is exact on canonical
operands only, so no input is at or above p.

Kernel note — ``field_chain`` replaces ``fused16`` of
``scripts/bench_pallas_field.py``. One thread an element over word planes
``int32[8, n]``: it reads 64 bytes, does k products (IMAD_SLOTS_PER_MUL
issue slots of the multiply-add pipe each, read from the kernel's SASS) with
the running value in registers, and writes 32 bytes. At k = 16 the
operations bound it on this card (:func:`chain_bound`: n = 2^18, 0.0641 ms
against 0.0075 ms of bytes). The design keeps every thread independent and
the planes coalesced, so that its time at full occupancy, beside the latency
of one dependent chain (:func:`product_latency_us`), says what one product
costs a full card.
"""

from __future__ import annotations

import random
import sys

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..field import FR, from_limbs, to_limbs
from ..field.params import FieldParams, NLIMB
from ..field.pfield import field_binop_plain, field_binop_words
from . import IMAD_SLOTS_PER_MUL, bound, gpu_line, random_words, time_ms, wall_ms

__all__ = ["field_chain", "field_chain_words", "field_chain_plain",
           "head_values", "make_inputs", "product_latency_us", "chain_bound", "run",
           "check", "main"]

DEFAULT_K = 16
SEED = 5            # the TPU script's
HEAD = 64           # leading elements held against Python ints
LATENCY_K = 4096    # products in the one chain that times a product's latency


def field_chain_plain(params: FieldParams, a, b, k: int = DEFAULT_K):
    """Plain version: `k` Montgomery products x <- x * b from x = a, over
    limb tensors [..., 16] (a * b^k * R^-k mod p)."""
    x = a
    for _ in range(k):
        x = field_binop_plain("mul", params, x, b)
    return x


@kernels.register("field_chain")
def field_chain_words(params: FieldParams, a, b, k: int = DEFAULT_K):
    """Launch ``field_chain`` on word planes int32[8, n] (CUDA). Returns the
    result planes."""
    if params.name not in ("Fq", "Fr"):
        raise ValueError(f"field_chain: no kernel for field {params.name}")
    if not isinstance(a, torch.Tensor) or a.dim() != 2:
        raise ValueError("field_chain: expected word planes [8, n]")
    if k < 0:
        raise ValueError("field_chain: k must be >= 0")
    n = a.shape[1]
    kernels.check_planes("field_chain a", a, (8, n))
    kernels.check_planes("field_chain b", b, (8, n))
    if b.device != a.device:
        raise ValueError("field_chain: operands on different devices")
    out = torch.empty_like(a)
    with kernels.on_device(a) as stream:
        code = kernels.lib().zg_field_chain(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            0 if params.name == "Fq" else 1, k, stream)
    kernels.launched("field_chain", code)
    return out


def field_chain(params: FieldParams, a, b, k: int = DEFAULT_K):
    """`k` chained products of plane arrays [16, M, 128]: the plain version
    for CPU tensors, the kernel for CUDA tensors."""
    if a.shape != b.shape or a.dim() != 3 or a.shape[0] != NLIMB:
        raise ValueError("field_chain: expected two [16, M, 128] plane tensors")
    if not a.is_cuda:
        out = field_chain_plain(params, torch.movedim(a, 0, -1),
                                torch.movedim(b, 0, -1), k)
        return torch.movedim(out, -1, 0)
    n = a.shape[1] * a.shape[2]
    wa = kernels.to_word_planes(a.reshape(NLIMB, n).t())
    wb = kernels.to_word_planes(b.reshape(NLIMB, n).t())
    out = kernels.from_word_planes(field_chain_words(params, wa, wb, k))
    return out.t().reshape(a.shape)


# ---- the benchmark -------------------------------------------------------------

def head_values(params: FieldParams, n: int):
    """The first min(HEAD, n) values of the benchmark's `a`: 0, 1, p - 1,
    2, p - 2, then random values below p (`b` takes them in reverse order)."""
    p, rnd = params.p, random.Random(SEED)
    head = [0, 1, p - 1, 2, p - 2] + [rnd.randrange(p) for _ in range(HEAD - 5)]
    return head[:min(HEAD, n)]


def make_inputs(params: FieldParams, n: int):
    """(a, b): canonical word planes int32[8, n] on the CPU, from SEED, that
    begin with :func:`head_values` (b with them reversed)."""
    rng = np.random.default_rng(SEED)
    a, b = random_words(rng, (n,)), random_words(rng, (n,))
    head = head_values(params, n)
    limbs = torch.from_numpy(to_limbs(head).astype(np.int64))
    a[:, :len(head)] = kernels.to_word_planes(limbs)
    b[:, :len(head)] = kernels.to_word_planes(limbs.flip(0))
    return a, b


def product_latency_us(params: FieldParams, device) -> float:
    """Microseconds a product in one chain of dependent products: one warp,
    each thread LATENCY_K products in a row."""
    a, b = (t.to(device) for t in make_inputs(params, 32))
    return (time_ms(lambda: field_chain_words(params, a, b, LATENCY_K), reps=3)
            * 1e3 / LATENCY_K)


def chain_bound(n: int, k: int = DEFAULT_K):
    """bound() of one launch of ``field_chain`` over n elements: a and b
    read and the result written (96 bytes an element), k products of
    IMAD_SLOTS_PER_MUL issue slots each."""
    return bound(3 * 32 * n, IMAD_SLOTS_PER_MUL * k * n)


def run(params: FieldParams, log_n: int, device):
    """The benchmark: the fused chain of DEFAULT_K products, as many launches
    of ``field_binop`` and the plain version, each timed on the card at
    n = 2^log_n. Returns a result dict and the three outputs (word planes,
    word planes, limbs)."""
    n, k = 1 << log_n, DEFAULT_K
    a, b = (t.to(device) for t in make_inputs(params, n))
    la, lb = kernels.from_word_planes(a), kernels.from_word_planes(b)

    def chained():
        x = a
        for _ in range(k):
            x = field_binop_words("mul", params, x, b)
        return x

    fused_out, chained_out = field_chain_words(params, a, b, k), chained()
    plain_out, plain_ms = wall_ms(lambda: field_chain_plain(params, la, lb, k))
    ms = time_ms(lambda: field_chain_words(params, a, b, k))
    chained_ms = time_ms(chained)
    bms, by = chain_bound(n, k)
    res = dict(shape=f"{params.name}, n={n}, k={k}", ms=ms, chained_ms=chained_ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               chained_bound_ms=k * chain_bound(n, 1)[0],
               ns_per_product=ms * 1e6 / (k * n),
               mproducts_per_s=dict(chained=k * n / chained_ms / 1e3,
                                    fused=k * n / ms / 1e3,
                                    plain=k * n / plain_ms / 1e3))
    return res, (fused_out, chained_out, plain_out)


def check(params: FieldParams, log_n: int, outs) -> int:
    """Hold the outputs of :func:`run` against each other limb for limb and
    the leading elements against Python ints (a * b^k * R^-k mod p, k =
    DEFAULT_K). Raises on a difference; returns the largest absolute limb
    difference (0)."""
    fused, chained, plain = outs
    k = DEFAULT_K
    got = kernels.from_word_planes(fused)
    if not torch.equal(got, plain):
        raise AssertionError(f"field_chain {params.name} != plain version")
    if not torch.equal(fused, chained):
        raise AssertionError(f"field_chain {params.name} != {k} field_binop launches")
    head = head_values(params, 1 << log_n)
    p = params.p
    rinv_k = pow(pow(params.r_mont, -1, p), k, p)
    truth = [x * pow(y, k, p) * rinv_k % p for x, y in zip(head, head[::-1])]
    if list(from_limbs(got[:len(truth)])) != truth:
        raise AssertionError(f"field_chain {params.name} != Python-int truth")
    return int((got - plain).abs().max())


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    device = resolve_device(None)
    log_n = int(argv[0]) if argv else 18
    print(gpu_line(), flush=True)
    res, outs = run(FR, log_n, device)
    rate = res["mproducts_per_s"]
    print(f"field_binop x{DEFAULT_K} [{res['shape']}]: {res['chained_ms']:.4f} ms"
          f" -> {rate['chained']:.0f} M products/s", flush=True)
    print(f"field_chain fused  [{res['shape']}]: {res['ms']:.4f} ms -> "
          f"{rate['fused']:.0f} M products/s ({res['ns_per_product']:.4f} ns a "
          f"product; bound {res['bound_ms']:.4f} ms by {res['bound_by']})",
          flush=True)
    print(f"plain chain        [{res['shape']}]: {res['plain_ms']:.3f} ms -> "
          f"{rate['plain']:.0f} M products/s", flush=True)
    print(f"one dependent chain (one warp): "
          f"{product_latency_us(FR, device):.4f} us a product", flush=True)
    check(FR, log_n, outs)
    print("parity OK", flush=True)


if __name__ == "__main__":
    main()
