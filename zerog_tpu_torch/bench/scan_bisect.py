"""Kernel 9, ``scan_bisect``: the affine flush scan's bisection bodies, their
plain version, and the bisection of ``flush_scan_affine``'s time.

Counterpart of ``scripts/bench_pscan_bisect.py``, which bisects the TPU
flush scan with four bodies, one kernel each here. Every row writes the
carry's x.

- ``trivial``: the carry is the running sum of the rows, word by word mod
  2^32, from 0. The sum is exact in any grouping, so a thread owns one of
  the 8 C word lanes, and chunks of 32 rows are loaded together and joined
  by a prefix of their totals. It reads the memory floor of a scan over
  this layout with its rows in flight, against ``torch.cumsum`` (the same
  function).
- ``mul_smem``: carry <- carry * x_r (Fq, Montgomery) from carry = x_0. The
  product is exact on canonical operands and so associative: the kernel is
  a chunked scan, K chunks a column (:func:`mul_chunks`), the chunk results
  joined by a log-depth prefix in shared memory, about 2 R C products with
  a chain of 2 L + log2 K (:func:`mul_depth`) instead of R.
- ``mul_reg``: the same function as a chunked scan whose chunk results meet
  in registers: a warp owns 8 neighbouring columns, each of its four lane
  groups J = 2 chunks of a column (K = 8 a column), walked side by side;
  the chunk results are joined by warp shuffles in two rounds, with no
  shared memory, and the rows walked again from their chunk's start. About
  2 R C products with a chain of 2 L + J + 2 (:func:`mul_reg_depth`).
- ``madd``: carry <- ``jac_madd_incomplete(carry, x_r, y_r, flag_r)`` from
  (x_0, y_0, 0): kernel 2's mixed add, 11 products a valid row. An invalid
  row leaves the carry as it is, so the kernel walks the valid rows only,
  four threads sharing each add; its chain is the column with the most
  valid rows.

    python -m zerog_tpu_torch.bench.scan_bisect

times the four bodies at R = 1,024 rows and C = 2,560 columns (kernel 2's
shape in a k = 14 proof; the TPU script used 2,048) and at 8x the columns,
and ``flush_scan_affine`` at R x C, each beside its bound (counted by what
the inputs need; ``bound_all_rows_ms`` every row read and added) and its
design's chain floor (the products on its longest dependent chain x the
latency of one product in a dependent chain, measured in the same run:
``madd`` the longest valid count x 3 carried products, ``mul_smem`` and
``mul_reg`` their chunked scans' depths); then checks every body against
the plain version. A time that stays flat from C to 8 C columns is bound by
the chain with the card mostly idle; one that grows 8x had the card full
already. It runs on the card and raises without one.

:func:`scan_bisect` takes limb tensors on either device: a CPU tensor goes
to the plain version, a CUDA tensor to the kernel.

Inputs: canonical Montgomery values made with numpy from a seed, the top
16-bit limb masked to 13 bits, flags at 10 % as the TPU script's. The TPU
script feeds raw 16-bit limbs, which can be at or above q; no scan ever
sees such an input, and the port's product is exact on canonical operands
only.

``trivial`` in two layouts: the TPU adds 16-bit limbs in 32-bit lanes with
no carry between limbs, the port adds 32-bit words mod 2^32. With S_i the
TPU's running sum of limb i, word w of the port's carry is
(S_{2w} + (S_{2w+1} << 16)) mod 2^32: the same function, exact while
R < 2^16.

Kernel note — ``scan_bisect_{trivial,mul_smem,mul_reg,madd}`` replace the
bodies ``k_trivial``, ``k_mul``, ``k_mul_reg`` and ``k_madd`` of
``scripts/bench_pscan_bisect.py`` (``run``). ``trivial`` and the two
``mul`` bodies are bound by bytes (64 R C: a row read, the carry written;
the R C products of ``mul`` take less), ``madd`` by what its valid rows
need (11 products of IMAD_SLOTS_PER_MUL issue slots a valid row after its
column's first). ``trivial`` loads its rows together, the two ``mul``
bodies regroup their product into chunks joined in shared memory
(``mul_smem``) or by warp shuffles (``mul_reg``), and ``madd`` skips its
invalid rows (``csrc/bench.cu`` says how).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..curve.jpoints import jac_madd_incomplete
from ..curve.pscan import flush_scan_affine_words
from ..device import resolve_device
from ..field import FQ, jfq
from . import (IMAD_SLOTS_PER_MUL, bound, flush_scan_affine_bound, gpu_line,
               plain_field, random_words, segment_ids, time_ms, wall_ms)
from .field_chain import product_latency_us

__all__ = ["BODIES", "scan_bisect", "scan_bisect_words", "scan_bisect_plain",
           "make_inputs", "bisect_bound", "mul_chunks", "mul_depth", "mul_reg_depth",
           "madd_counts", "run", "check", "main"]

BODIES = ("trivial", "mul_smem", "mul_reg", "madd")
ROWS = 1024
COLS = 2560             # flush_scan_affine's columns in a k = 14 proof
WIDE = 8 * COLS
FLAG_RATE = 0.1         # the TPU script's
SEED = 0                # the TPU script's
# products a row: all that one thread issues, in order, and those on the
# chain carried from row to row (madd: z' = z (x_r z^2 - x), three)
PRODUCTS = {"trivial": 0, "mul_smem": 1, "mul_reg": 1, "madd": 11}
CARRIED_PRODUCTS = {"trivial": 0, "mul_smem": 1, "mul_reg": 1, "madd": 3}
# mul_smem's plan, as csrc/bench.cu chooses it (ZG_MUL_*)
MUL_MAX_CHUNKS = 32
MUL_MIN_ROWS = 8
MUL_FILL = 131072
# mul_reg's plan, as csrc/bench.cu has it (ZG_MULREG_*): lane groups of a
# warp, and J, the chunks of a thread
MULREG_GROUPS = 4
MULREG_CHAINS = 2


def scan_bisect_plain(body: str, sx, sy, flags):
    """Plain version of body `body`. sx, sy: canonical limbs [R, C, 16];
    flags: bool [R, C]. Returns the carry's x after every row, [R, C, 16]."""
    if body == "trivial":
        words = sx[..., 0::2] | (sx[..., 1::2] << 16)
        acc = torch.cumsum(words, dim=0) & 0xFFFFFFFF
        return torch.stack([acc & 0xFFFF, acc >> 16], dim=-1).reshape(sx.shape)
    rows = []
    if body in ("mul_smem", "mul_reg"):
        carry = sx[0]
        for r in range(sx.shape[0]):
            carry = jfq().mul(carry, sx[r])
            rows.append(carry)
    elif body == "madd":
        carry = (sx[0], sy[0], torch.zeros_like(sx[0]))
        for r in range(sx.shape[0]):
            carry = jac_madd_incomplete(carry, sx[r], sy[r], flags[r])
            rows.append(carry[0])
    else:
        raise ValueError(f"scan_bisect: no body {body!r}")
    return torch.stack(rows)


def _wrapper(body: str):
    name = "scan_bisect_" + body

    def words(sx, sy, flags):
        if not isinstance(sx, torch.Tensor) or sx.dim() != 3:
            raise ValueError(f"{name}: expected word planes [R, 8, C]")
        r, _, c = sx.shape
        kernels.check_planes(f"{name} x", sx, (r, 8, c))
        kernels.check_planes(f"{name} y", sy, (r, 8, c))
        kernels.check_planes(f"{name} flags", flags, (r, c), torch.uint8)
        if sy.device != sx.device or flags.device != sx.device:
            raise ValueError(f"{name}: operands on different devices")
        out = torch.empty_like(sx)
        with kernels.on_device(sx) as stream:
            code = kernels.lib().zg_scan_bisect(
                BODIES.index(body), sx.data_ptr(), sy.data_ptr(),
                flags.data_ptr(), out.data_ptr(), r, c, stream)
        kernels.launched(name, code)
        return out

    words.__name__ = words.__qualname__ = f"{name}_words"
    words.__doc__ = (f"Launch ``{name}``. sx, sy: int32 word planes [R, 8, C]; "
                     "flags: uint8 [R, C]. Returns the carry's x after every "
                     "row, word planes [R, 8, C].")
    return kernels.register(name)(words)


#: one registered wrapper (and launch count) a body
WORDS = {body: _wrapper(body) for body in BODIES}


def scan_bisect_words(body: str, sx, sy, flags):
    """Launch the kernel of body `body` on word planes (CUDA)."""
    if body not in WORDS:
        raise ValueError(f"scan_bisect: no body {body!r}")
    return WORDS[body](sx, sy, flags)


def scan_bisect(body: str, sx, sy, flags):
    """Body `body` over limbs sx, sy [R, C, 16] and flags bool [R, C]: the
    plain version for CPU tensors, the kernel for CUDA tensors."""
    if not sx.is_cuda:
        return scan_bisect_plain(body, sx, sy, flags)
    out = scan_bisect_words(body, kernels.to_word_planes(sx),
                            kernels.to_word_planes(sy),
                            flags.to(torch.uint8).contiguous())
    return kernels.from_word_planes(out)


# ---- the bisection ----------------------------------------------------------------

def make_inputs(rows: int, cols: int, seed: int = SEED):
    """(sx, sy, flags) on the CPU: canonical word planes int32[R, 8, C] and
    flags uint8 [R, C] at FLAG_RATE."""
    rng = np.random.default_rng(seed)
    sx, sy = random_words(rng, (rows, cols)), random_words(rng, (rows, cols))
    flags = torch.from_numpy((rng.random((rows, cols)) < FLAG_RATE).astype(np.uint8))
    return sx, sy, flags


def mul_chunks(rows: int, cols: int) -> int:
    """K, the chunks of a column in ``scan_bisect_mul_smem``: the least
    power of two that puts MUL_FILL threads in flight, at most
    MUL_MAX_CHUNKS, chunks of at least MUL_MIN_ROWS rows."""
    k = 1
    while (k < MUL_MAX_CHUNKS and k * cols < MUL_FILL
           and 2 * k * MUL_MIN_ROWS <= rows):
        k *= 2
    return k


def mul_depth(rows: int, cols: int) -> int:
    """Dependent products on ``scan_bisect_mul_smem``'s longest chain: pass
    1 (chunk 0 walks its L rows, the others reduce theirs), the log2 K
    rounds of the prefix of the chunk results, then a chunk's rows again."""
    k = mul_chunks(rows, cols)
    if k == 1:
        return rows
    length = -(-rows // k)
    spans = [max(0, min(rows, (c + 1) * length) - c * length) for c in range(k)]
    first = max([spans[0]] + [n - 1 for n in spans[1:]])
    return first + (k - 1).bit_length() + max(spans[1:])


def mul_reg_depth(rows: int) -> int:
    """Dependent products on ``scan_bisect_mul_reg``'s longest chain: pass 1
    (L = ceil(R / K) steps of its interleaved walks, chunk 0 the longest),
    the thread's prefix of its J results (J - 1), the scan over the four
    lane groups (2 rounds), a chunk's start (1), then pass 2 (L steps)."""
    length = -(-rows // (MULREG_GROUPS * MULREG_CHAINS))
    return (2 * length + (MULREG_CHAINS - 1) + (MULREG_GROUPS - 1).bit_length()
            + 1)


def madd_counts(flags):
    """(valid rows, required adds, longest valid count of a column) of
    flags [R, C]: every valid row after its column's first is an add (the
    first takes the row's point)."""
    valid = flags.bool()
    n = int(valid.sum())
    return n, n - int(valid.any(dim=0).sum()), int(valid.sum(dim=0).max())


def bisect_bound(body: str, rows: int, cols: int, flags=None):
    """(ms, by) of one launch, counted by what the inputs need: a row of x
    read and the carry's x written; the products' IMAD-pipe issue slots.
    ``madd`` with `flags`: x of every row written, its flag read, x and y of
    the valid rows and x of row 0 read, 11 products an add
    (:func:`madd_counts`).
    Without `flags` every row is read and added (``bound_all_rows_ms``)."""
    n = rows * cols
    if body == "madd" and flags is not None:
        valid, adds, _ = madd_counts(flags)
        return bound(33 * n + 64 * valid + 32 * cols,
                     adds * PRODUCTS["madd"] * IMAD_SLOTS_PER_MUL)
    return bound((97 if body == "madd" else 64) * n,
                 PRODUCTS[body] * IMAD_SLOTS_PER_MUL * n)


def _chain(body, rows, cols, flags):
    """Dependent products on the longest chain of the body's design."""
    if body == "madd":
        return madd_counts(flags)[2] * CARRIED_PRODUCTS["madd"]
    if body == "mul_smem":
        return mul_depth(rows, cols)
    if body == "mul_reg":
        return mul_reg_depth(rows)
    return rows * CARRIED_PRODUCTS[body]


def _floors(rows, products, carried, latency_us):
    return dict(chain_floor_ms=rows * products * latency_us / 1e3,
                carried_floor_ms=rows * carried * latency_us / 1e3)


def run(device):
    """Time every body at COLS and WIDE columns of ROWS rows (the first COLS
    columns of the wide inputs are the narrow ones) and
    ``flush_scan_affine`` at COLS, beside their bounds and chain floors.
    Returns the results and what :func:`check` needs: the narrow inputs and
    each body's two outputs."""
    rows, cols, wide = ROWS, COLS, WIDE
    latency = product_latency_us(FQ, device)
    wide_in = tuple(t.to(device) for t in make_inputs(rows, wide))
    narrow_in = tuple(t[..., :cols].contiguous() for t in wide_in)
    res, outs = {}, {}
    for body in BODIES:
        outs[body] = (scan_bisect_words(body, *narrow_in),
                      scan_bisect_words(body, *wide_in))
        ms = time_ms(lambda: scan_bisect_words(body, *narrow_in), reps=3)
        ms_wide = time_ms(lambda: scan_bisect_words(body, *wide_in), reps=3)
        bms, by = bisect_bound(body, rows, cols, narrow_in[2])
        chain = _chain(body, rows, cols, narrow_in[2])
        res[body] = dict(shape=f"R={rows}, columns={cols}", ms=ms, ms_wide=ms_wide,
                         wide_shape=f"R={rows}, columns={wide}",
                         wide_over_narrow=ms_wide / ms, bound_ms=bms, bound_by=by,
                         bound_all_rows_ms=bisect_bound(body, rows, cols)[0],
                         bound_wide_ms=bisect_bound(body, rows, wide, wide_in[2])[0],
                         chain_products=chain,
                         chain_floor_ms=chain * latency / 1e3,
                         chain_floor_wide_ms=_chain(body, rows, wide, wide_in[2])
                         * latency / 1e3)
        if body == "madd":
            res[body]["longest_valid"] = madd_counts(narrow_in[2])[2]
        if body == "mul_smem":
            res[body]["chunks"] = mul_chunks(rows, cols)
            res[body]["chunks_wide"] = mul_chunks(rows, wide)
        if body == "mul_reg":
            res[body]["chains"] = MULREG_CHAINS
            res[body]["chunks"] = MULREG_GROUPS * MULREG_CHAINS
    # kernel 2 itself on the same rows, valid at 99 % and flags at 2.5 % as
    # in the kernel check of chip_smoke.py
    rng = np.random.default_rng(SEED + 1)
    valid = torch.from_numpy((rng.random((rows, cols)) >= 0.01).astype(np.uint8))
    flags = torch.from_numpy((rng.random((rows, cols)) < 0.025).astype(np.uint8))
    affine = (narrow_in[0], narrow_in[1], valid.to(device), flags.to(device))
    bms, by = flush_scan_affine_bound(rows, cols)
    # its segments do not depend on each other: the floors count the longest
    longest = int(torch.bincount(segment_ids(flags).reshape(-1)).max())
    res["flush_scan_affine"] = dict(
        shape=f"R={rows}, columns={cols}", bound_ms=bms, bound_by=by,
        ms=time_ms(lambda: flush_scan_affine_words(*affine), reps=3),
        longest_segment=longest,
        **_floors(longest, PRODUCTS["madd"], CARRIED_PRODUCTS["madd"], latency))
    return dict(product_latency_us=latency, bodies=res), (narrow_in, outs)


def check(narrow_in, outs):
    """Hold the outputs of :func:`run` against the plain version limb for
    limb over all rows, and every wide output's first columns against the
    narrow output. Raises on a difference; returns {body: plain_ms,
    max_abs_err}."""
    sx, sy, flags = narrow_in
    cols = sx.shape[2]
    lx, ly, lf = (kernels.from_word_planes(sx), kernels.from_word_planes(sy),
                  flags.bool())
    for body in BODIES:
        narrow, wide = outs[body]
        if not torch.equal(wide[..., :cols], narrow):
            raise AssertionError(f"scan_bisect_{body}: the wide run's first "
                                 f"{cols} columns differ from the narrow run")
    with plain_field():
        plain = {body: wall_ms(lambda: scan_bisect_plain(body, lx, ly, lf))
                 for body in ("trivial", "mul_reg", "madd")}
    plain["mul_smem"] = plain["mul_reg"]
    res = {}
    for body in BODIES:
        ref, ms = plain[body]
        got = kernels.from_word_planes(outs[body][0])
        if not torch.equal(got, ref):
            raise AssertionError(f"scan_bisect_{body} != plain version")
        res[body] = dict(plain_ms=ms, max_abs_err=int((got - ref).abs().max()))
    return res


def main(argv=None) -> None:
    device = resolve_device(None)
    print(gpu_line(), flush=True)
    res, (narrow_in, outs) = run(device)
    print(f"one dependent chain (one warp): {res['product_latency_us']:.4f} us a "
          "product", flush=True)
    for name, r in res["bodies"].items():
        wide = (f"; 8x columns {r['ms_wide']:.3f} ms ({r['wide_over_narrow']:.2f}x)"
                if "ms_wide" in r else "")
        print(f"{name:18s} [{r['shape']}]: {r['ms']:.3f} ms; bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}; chain floor "
              f"{r['chain_floor_ms']:.3f} ms{wide}", flush=True)
    for body in check(narrow_in, outs):
        print(f"{body}: equal to the plain version over all {ROWS} rows",
              flush=True)


if __name__ == "__main__":
    main()
