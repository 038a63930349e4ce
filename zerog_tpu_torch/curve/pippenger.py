"""Pippenger multi-scalar multiplication on tensors.

Counterpart of ``zerog_tpu/curve/pippenger.py`` — the MSM behind every
commitment of keygen and create_proof. Two strategies are ported:

- "pippenger" (default): bucketed column-scan Pippenger — sort by window
  digit, flush-scan bucket accumulation, marginal-split weighted sum. The
  flush scan and the bucket folds are CUDA kernels on the card
  (curve/pscan.py, curve/pfold.py) and plain loops on the CPU. Uses the
  INCOMPLETE Jacobian add, so it requires pairwise-distinct, random-looking
  base points (SRS tau powers qualify: an internal add collision has
  probability ~2^-254 and would only corrupt the proof being built, which
  the verifier then rejects). Do NOT use it on structured point sets (e.g.
  small multiples of G, adversarial proof-supplied points).
- "fixed": the same bucket pipeline over a precomputed merged-window table
  (:func:`build_window_table`), one accumulation for all windows.

The "danaa", "scan" and "segscan" strategies of the JAX package are not
ported yet (ROADMAP.md, queue 1, item f).

Bucket accumulation has no cross-lane work in the hot loop: sort each
(window, scalar-row) digit lane ONCE, lay the sorted points out column-major
[R rows x C columns], and scan DOWN the rows: each step adds one point row
into a per-column carry, flushing the carry to the output when a new digit
run starts. A run of equal digits is contiguous in column-major order, so a
bucket's total is split across at most ceil(run/R)+1 flushed "pieces". When
every nonzero run fits in one column (max_run <= R, the random-scalar case)
the pieces scatter directly into [G, 2, 2^c] bucket slots; otherwise ONE
compaction round (stable-sort pieces by bucket, rerun the same flush scan)
reduces any distribution — witness columns are full of repeated values — to
<= C pieces per bucket, which the second round's columns always absorb.

Windows are BALANCED (sizes floor/ceil of 254/W) so no window has a tiny
bit-range whose digit multiplicity would blow up max_run structurally.

The weighted sum  sum_b b*B_b  uses the marginal split b = hi*2^lo + lo:
    sum_b b*B_b = 2^lo * sum_hi hi*R_hi + sum_lo lo*C_lo,
with R/C marginals from two more reduce folds and the two small weighted
sums from one final fold.

The stable sorts fix the order in which points are added, hence the Jacobian
limbs of every piece: both sorts here ask for ``stable=True``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..field import FR, FQ, jfq, shift_fill, to_limbs, from_limbs, to_device
from .jpoints import (
    jac_double, jac_from_affine, jac_infinity, jac_madd_incomplete,
    points_from_device, points_to_device,
)
from .bn254 import G1_GEN, g1_add, g1_double, g1_mul
from .pscan import flush_scan
from .pfold import sum_rows_many, weighted

__all__ = ["msm", "msm_pippenger_host", "msm_fixed_host",
           "fixed_base_expand", "default_window", "default_fixed_window",
           "build_window_table", "WindowTable"]


def default_window(n: int) -> int:
    """Window width heuristic shared by every MSM entry point."""
    return max(4, min(10, int(n).bit_length() - 4))


SCALAR_BITS = 254
_PIP_R = 128       # least rows per column in the accumulation scan
_INT32_MAX = (1 << 31) - 1


def _window_layout(c: int, total_bits: int = SCALAR_BITS):
    """Balanced window sizes/offsets: W = ceil(bits/c) windows of width
    floor(bits/W) or floor(bits/W)+1 covering exactly `total_bits`."""
    w = (total_bits + c - 1) // c
    base = total_bits // w
    extra = total_bits - base * w
    sizes = [base + 1] * extra + [base] * (w - extra)
    offsets = []
    off = 0
    for s in sizes:
        offsets.append(off)
        off += s
    return tuple(sizes), tuple(offsets)


def _digits_balanced(scalar_limbs, c: int):
    """[..., 16] canonical limbs -> int64[W, ...] balanced-window digits."""
    sizes, offsets = _window_layout(c)
    outs = []
    for size, off in zip(sizes, offsets):
        j, r = divmod(off, 16)
        v = scalar_limbs[..., j] >> r
        if j + 1 < 16 and r + size > 16:
            v = v | (scalar_limbs[..., j + 1] << (16 - r))
        outs.append(v & ((1 << size) - 1))
    return torch.stack(outs, dim=0)


def _colmaj(a, r_rows: int):
    """[G, M, ...] -> [R, G, C, ...] with flat index = col*R + row."""
    g, m = a.shape[0], a.shape[1]
    a2 = a.reshape((g, m // r_rows, r_rows) + tuple(a.shape[2:]))
    return torch.movedim(a2, 2, 0)


def _stream_info(keys, r_rows: int, nb: int):
    """Bookkeeping for a grouped key stream [G, M] (equal keys contiguous;
    key == nb marks dropped entries, grouped at the tail).

    Returns (flags, pb, pr, pbf, prf, max_run): column-major [R, G, C] flush
    flags, per-flush bucket/rank (pb == nb -> dropped), final-carry
    bucket/rank, and the longest run with 0 < key < nb."""
    g, m = keys.shape
    idx = torch.arange(m, device=keys.device)
    new_seg = torch.cat(
        [torch.ones((g, 1), dtype=torch.bool, device=keys.device),
         keys[:, 1:] != keys[:, :-1]], dim=1)
    start_flat = torch.cummax(
        torch.where(new_seg, idx[None, :], torch.zeros_like(idx)[None, :]),
        dim=1).values
    run_pos = idx[None, :] - start_flat
    max_run = torch.where((keys > 0) & (keys < nb), run_pos,
                          torch.zeros_like(run_pos)).max() + 1

    ksc = _colmaj(keys, r_rows)                     # [R, G, C]
    nsc = _colmaj(new_seg, r_rows)
    flags = nsc.clone()
    flags[0] = True                                 # each column: fresh carry
    cdim = m // r_rows
    rank = (torch.arange(cdim, device=keys.device)[None, None, :]
            - _colmaj(start_flat // r_rows, r_rows))
    valid = flags.clone()
    valid[0] = False
    pb = torch.where(valid, torch.roll(ksc, 1, dims=0),
                     torch.full_like(ksc, nb))
    pr = torch.where(valid, torch.roll(rank, 1, dims=0),
                     torch.zeros_like(rank))
    return flags, pb, pr, ksc[-1], rank[-1], max_run


def _prep_core(ds, px, py, pvalid, r_rows: int, nb: int):
    """Shared level-1 prep from a digit matrix: mask invalid lanes to bucket
    0, pad the point axis to an r_rows multiple, sort each lane's digits
    (stably), gather points into column-major scan order, and build the
    flush-scan bookkeeping. ds: int64[G, M] digits; points [M, 16] affine
    mont shared by every lane group."""
    m0 = ds.shape[1]
    ds = torch.where(pvalid[None, :], ds, torch.zeros_like(ds))  # invalid -> bucket 0
    m = ((m0 + r_rows - 1) // r_rows) * r_rows
    if m > m0:
        pad = m - m0
        ds = F.pad(ds, (0, pad))
        pvalid = F.pad(pvalid, (0, pad))
        px = F.pad(px, (0, 0, 0, pad))
        py = F.pad(py, (0, 0, 0, pad))
    ds, order = torch.sort(ds, dim=-1, stable=True)
    gx, gy, gv = px[order], py[order], pvalid[order]
    sx = _colmaj(gx, r_rows)                        # [R, G, C, 16]
    sy = _colmaj(gy, r_rows)
    sval = _colmaj(gv, r_rows)
    info = _stream_info(ds, r_rows, nb)
    return (sx, sy, sval) + info


def _pipv2_prep(scalar_limbs, px, py, pvalid, c: int, r_rows: int):
    """Level-1 prep: balanced-window digits, per-lane sort, point gather.
    Scalars [B, N, 16]; points [N, 16] affine mont + valid [N]."""
    digits = _digits_balanced(scalar_limbs, c)      # [W, B, N]
    w, b, n0 = digits.shape
    ds = digits.reshape(w * b, n0)
    return _prep_core(ds, px, py, pvalid, r_rows, 1 << c)


def _pipfb_prep(scalar_limbs, tx, ty, tvalid, c: int, r_rows: int):
    """Merged-window prep for the fixed-base path: each scalar row's W digit
    vectors are concatenated window-major (index j*N + i, matching the
    shifted-table layout), so one bucket accumulation covers every window.
    Scalars [B, N, 16]; table [W*N, 16] affine mont + valid [W*N]."""
    digits = _digits_balanced(scalar_limbs, c)      # [W, B, N]
    w, b, n0 = digits.shape
    ds = torch.movedim(digits, 0, 1).reshape(b, w * n0)
    return _prep_core(ds, tx, ty, tvalid, r_rows, 1 << c)


def _pipv2_compact(pieces, pb_all, r_rows: int):
    """Stable-sort the flat piece stream so real pieces (pb < nb) lead,
    grouped by bucket (they already are — stable sort keeps flat order),
    then re-lay column-major for a second flush scan. Any bucket has at
    most C pieces, so the second round always fits P = 2."""
    rp1, g, cdim = pb_all.shape
    m = rp1 * cdim

    def flat(a):  # [R+1, G, C, ...] -> [G, M, ...] in flat piece order
        return torch.movedim(a, 0, 2).reshape((g, m) + tuple(a.shape[3:]))

    keys, order = torch.sort(flat(pb_all), dim=-1, stable=True)
    idx = order.unsqueeze(-1).expand(g, m, 16)
    stream = tuple(torch.gather(flat(comp), 1, idx) for comp in pieces)
    m2 = ((m + r_rows - 1) // r_rows) * r_rows
    if m2 > m:
        # pad with drop-key entries (infinity points)
        keys = F.pad(keys, (0, m2 - m), value=_INT32_MAX)
        stream = tuple(F.pad(compp, (0, 0, 0, m2 - m)) for compp in stream)
    return tuple(_colmaj(compp, r_rows) for compp in stream), keys


def _pipv2_scatter(pieces, pb, pr, p_max: int, c: int):
    """Pieces jac [R+1, G, C] -> bucket slots [G, p_max, 2^c]. The three
    coordinates are packed into one [..., 48] tensor so a single scatter
    runs. Out-of-range rank (only weight-0 bucket 0) and pb >= 2^c are
    dropped: they go to one spare slot past the end, which is sliced off.
    Real (rank, bucket) pairs are unique, so the scatter is deterministic."""
    nb = 1 << c
    g = pb.shape[1]
    packed = torch.cat(pieces, dim=-1)              # [R+1, G, C, 48]
    garr = torch.arange(g, device=pb.device)[None, :, None]
    slots = p_max * nb
    keep = (pb >= 0) & (pb < nb) & (pr >= 0) & (pr < p_max)
    flat_idx = torch.where(keep, garr * (slots + 1) + pr * nb + pb,
                           garr * (slots + 1) + slots)
    out = torch.zeros((g * (slots + 1), 48), dtype=packed.dtype,
                      device=packed.device)
    out[flat_idx.reshape(-1)] = packed.reshape(-1, 48)
    out = out.reshape(g, slots + 1, 48)[:, :slots].reshape(g, p_max, nb, 48)
    return out[..., :16], out[..., 16:32], out[..., 32:]


@functools.cache
def _pip_bias_np():
    """Fixed bias point K (known scalar) as host numpy limbs."""
    k_scalar = 0xB1A5_0FF5_E7D0_1234_5678_9ABC_DEF0_1357
    pt = g1_mul(G1_GEN, k_scalar)
    x = to_limbs(pt[0], FQ, mont=True)
    y = to_limbs(pt[1], FQ, mont=True)
    z = to_limbs(FQ.r_mont)  # Z = 1 in Montgomery form
    return pt, (x, y, z)


def _pip_bias(device):
    pt, comps = _pip_bias_np()
    return pt, tuple(to_device(c, device) for c in comps)


def _pip_r_rows(m: int) -> int:
    """r_rows >= sqrt(m) so that level-2 runs (<= C = m/r_rows pieces per
    bucket) always fit one level-2 column; capped below by _PIP_R."""
    return min(1 << max(1, (m - 1).bit_length()),
               max(_PIP_R, 1 << ((m - 1).bit_length() + 1) // 2))


def _pipeline_device(arrs, r_rows: int, c: int, compact: bool):
    """Bucket pipeline on tensors: flush scan -> (optional) compaction ->
    scatter -> marginal-split weighted sum. `arrs` are the prep outputs
    minus max_run; returns the weighted accumulators, jac components
    [G, 2, 16]."""
    nb = 1 << c
    sx, sy, sval, flags, pb, pr, pbf, prf = arrs
    pieces = flush_scan((sx, sy, sval), flags, affine=True)
    pb_all = torch.cat([pb, pbf[None]], dim=0)
    pr_all = torch.cat([pr, prf[None]], dim=0)
    if compact:
        # skewed digit distribution (common for witness columns): compact
        # pieces by bucket and rerun the flush scan — bounds pieces <= C
        stream2, keys2 = _pipv2_compact(pieces, pb_all, r_rows)
        flags, pb, pr, pbf, prf, _ = _stream_info(keys2, r_rows, nb)
        pieces = flush_scan(stream2, flags, affine=False)
        pb_all = torch.cat([pb, pbf[None]], dim=0)
        pr_all = torch.cat([pr, prf[None]], dim=0)
    buckets = _pipv2_scatter(pieces, pb_all, pr_all, p_max=2, c=c)

    g = int(pb_all.shape[1])
    lo_bits = c // 2
    hi_n, lo_n = 1 << (c - lo_bits), 1 << lo_bits
    r_hi, c_lo = sum_rows_many([
        tuple(comp.reshape(g, 2, hi_n, lo_n, 16).permute(1, 3, 0, 2, 4)
              .reshape(2 * lo_n, g, hi_n, 16) for comp in buckets),
        tuple(comp.reshape(g, 2, hi_n, lo_n, 16).permute(1, 2, 0, 3, 4)
              .reshape(2 * hi_n, g, lo_n, 16) for comp in buckets),
    ])

    _, bias_dev = _pip_bias(sx.device)
    stacked = tuple(
        torch.movedim(
            torch.flip(torch.stack(
                [rh, F.pad(cl, (0, 0, 0, hi_n - lo_n))], dim=2
            ), dims=(1,)), 1, 0)                    # [K, G, 2, 16]
        for rh, cl in zip(r_hi, c_lo)
    )
    return weighted(stacked, bias_dev)


def _bucket_pipeline(prep, r_rows: int, c: int):
    """Host-facing bucket stage. Returns ((w_hi, w_lo) host points per lane
    group as a flat list [2*G], neg_bias, lo_bits). Reads `max_run` back
    from the device to decide on the compaction round."""
    max_run = prep[-1]
    compact = int(max_run) > r_rows
    acc2 = _pipeline_device(prep[:-1], r_rows, c, compact)
    g = int(acc2[0].shape[0])
    host = points_from_device(tuple(comp.reshape(g * 2, 16) for comp in acc2))
    bias_pt, _ = _pip_bias_np()
    neg_k = (bias_pt[0], (-bias_pt[1]) % FQ.p)
    return host, neg_k, c // 2


def msm_pippenger_host(sl, px, py, pvalid, c: int):
    """Column-scan Pippenger. sl: [B, N, 16] canonical scalar limbs; points
    on the same device. Returns [B] affine host points."""
    b = int(sl.shape[0])
    r_rows = _pip_r_rows(int(px.shape[0]))
    prep = _pipv2_prep(sl, px, py, pvalid, c=c, r_rows=r_rows)
    host, neg_k, lo_bits = _bucket_pipeline(prep, r_rows, c)
    sizes, _ = _window_layout(c)
    results = []
    w = len(host) // (2 * b)
    for bi in range(b):
        window_sums = []
        for wi in range(w):
            gi = wi * b + bi
            w_hi = g1_add(host[2 * gi], neg_k)
            w_lo = g1_add(host[2 * gi + 1], neg_k)
            window_sums.append(g1_add(g1_mul(w_hi, 1 << lo_bits), w_lo))
        results.append(_fold_windows_host(window_sums, sizes))
    return results


def _fold_windows_host(window_points, c):
    """Horner fold of window sums (host; W is tiny). `c` is either a uniform
    window width or a per-window width sequence (LSB window first)."""
    sizes = [c] * len(window_points) if isinstance(c, int) else list(c)
    acc = None
    for pt, size in zip(reversed(window_points), reversed(sizes)):
        for _ in range(size):
            acc = g1_double(acc) if acc is not None else None
        acc = g1_add(acc, pt)
    return acc


# ---- fixed-base merged-window Pippenger -------------------------------------
#
# The prover's bases are FIXED (SRS monomial/Lagrange powers; every proof
# commits dozens of polynomials against the same two point sets), so we
# precompute per-window shifted copies  Q[j*N + i] = 2^{offset_j} * P_i  once
# and merge ALL windows into a single bucket accumulation over M = W*N
# points: the O(2^c) bucket fold is paid once per scalar row instead of once
# per (window x row), so wide windows become economical, and the per-window
# host fold collapses to one hi*2^lo + lo combination per row.
# Table build is ~254 elementwise doubling passes over N lanes plus one
# batched affine normalization — amortized across every later commitment.
# Incomplete-add contract: table entries 2^{o_j} * P_i are pairwise distinct
# for random-looking bases (SRS powers; collision ~2^-254).

_fq = jfq()
_FQ_ONE = to_limbs(1, FQ, mont=True)


def _fq_prefix_products(flat):
    """[M, 16] FQ mont limbs -> inclusive prefix products (log-depth
    Hillis-Steele doubling; shifted-in lanes are multiplicative ones)."""
    m = flat.shape[0]
    steps = max(1, (m - 1).bit_length())
    one = _fq._c("one_mont", flat.device)
    out = flat
    for s in range(steps):
        out = _fq.mul(out, shift_fill(out, 1 << s, fill=one, axis=0))
    return out


def _fq_finish_inverses(flat, prefix, total_inv):
    """inv_i = prefix_{i-1} * total_inv * rev_prefix(rev flat)_{i+1}."""
    rev_pref = _fq_prefix_products(torch.flip(flat, dims=(0,)))
    suffix = torch.flip(rev_pref, dims=(0,))
    one = _fq._c("one_mont", flat.device)[None]
    suffix_next = torch.cat([suffix[1:], one], dim=0)
    prefix_prev = torch.cat([one, prefix[:-1]], dim=0)
    return _fq.mul(_fq.mul(prefix_prev, suffix_next), total_inv)


def _fq_batch_inv(vals):
    """vals [M, 16] FQ mont limbs, all nonzero -> elementwise inverses (one
    32-byte host round trip for the single total inversion)."""
    prefix = _fq_prefix_products(vals)
    total = from_limbs(prefix[-1], FQ, mont=True)
    total_inv = to_device(
        to_limbs(pow(int(total), -1, FQ.p), FQ, mont=True), vals.device)
    return _fq_finish_inverses(vals, prefix, total_inv)


class WindowTable:
    """Precomputed per-window shifted base points for the merged-window MSM.

    Layout: entry j*N + i is 2^{offset_j} * P_i (affine Montgomery limbs),
    offsets from the balanced window layout for width c."""

    __slots__ = ("c", "n", "tx", "ty", "tvalid")

    def __init__(self, c, n, tx, ty, tvalid):
        self.c, self.n, self.tx, self.ty, self.tvalid = c, n, tx, ty, tvalid


def default_fixed_window(n: int) -> int:
    """Width heuristic for the merged fixed-base path: cost model
    ceil(254/c)*N + ~4*2^c is minimized near log2(N) - 1."""
    return max(4, min(16, int(n).bit_length() - 2))


def build_window_table(points_dev, c: int, device=None) -> WindowTable:
    """Build the merged-window table for a fixed point set ((x, y, valid)
    from points_to_device). One doubling chain of 254 elementwise passes over
    N lanes + one batched affine normalization."""
    device = resolve_device(device)
    px, py, pvalid = (torch.as_tensor(a).to(device) for a in points_dev)
    n = int(px.shape[0])
    sizes, _ = _window_layout(c)
    cur = jac_from_affine(px, py, pvalid)
    comps = ([cur[0]], [cur[1]], [cur[2]])
    for size in sizes[:-1]:
        for _ in range(size):
            cur = jac_double(cur)
        for lst, comp in zip(comps, cur):
            lst.append(comp)
    jx, jy, jz = (torch.cat(lst, dim=0) for lst in comps)
    tvalid = pvalid.repeat(len(sizes))
    # batch-normalize to affine: x/z^2, y/z^3 (invalid lanes use z=1)
    one = _fq._c("one_mont", device).expand(jz.shape)
    z = torch.where(tvalid[:, None], jz, one)
    zinv = _fq_batch_inv(z)
    zinv2 = _fq.square(zinv)
    tx = _fq.mul(jx, zinv2)
    ty = _fq.mul(jy, _fq.mul(zinv, zinv2))
    return WindowTable(c, n, tx, ty, tvalid)


def msm_fixed_host(sl, table: WindowTable):
    """Merged-window fixed-base MSM. sl: [B, N, 16] canonical scalar limbs
    on the table's device; table from build_window_table. Returns [B] affine
    host points."""
    b = int(sl.shape[0])
    c = table.c
    m = int(table.tx.shape[0])
    r_rows = _pip_r_rows(m)
    prep = _pipfb_prep(sl, table.tx, table.ty, table.tvalid, c=c,
                       r_rows=r_rows)
    host, neg_k, lo_bits = _bucket_pipeline(prep, r_rows, c)
    results = []
    for bi in range(b):
        w_hi = g1_add(host[2 * bi], neg_k)
        w_lo = g1_add(host[2 * bi + 1], neg_k)
        results.append(g1_add(g1_mul(w_hi, 1 << lo_bits), w_lo))
    return results


def msm(scalars, points_dev=None, c: int | None = None,
        strategy: str = "pippenger", table: WindowTable | None = None,
        device=None):
    """Host-facing MSM.

    scalars: 2D list/array [B][N] of ints in [0, r) (or 1D for B=1);
    points_dev: (px, py, pvalid) from :func:`points_to_device`, or pass
    `table` (a :class:`WindowTable`) to use the merged-window fixed-base
    path (strategy "fixed"). `device=None` means the CUDA card.
    Returns list of B affine points (or a single point for 1D input).
    """
    device = resolve_device(device)
    if strategy not in ("pippenger", "fixed"):
        raise NotImplementedError(
            f"MSM strategy {strategy!r} is not ported yet (ROADMAP.md, "
            "queue 1, item f: segscan/danaa/scan strategies)")
    single = not isinstance(scalars[0], (list, tuple, np.ndarray))
    if single:
        scalars = [scalars]
    if table is not None:
        strategy = "fixed"
    b_real = len(scalars)
    b_pad = 1
    while b_pad < b_real:
        b_pad *= 2
    if b_pad > b_real:
        scalars = list(scalars) + [[0] * len(scalars[0])] * (b_pad - b_real)
    sl = to_device(to_limbs(np.asarray(scalars, dtype=object) % FR.p), device)

    if strategy == "fixed":
        if table is None:
            raise ValueError("strategy='fixed' requires a WindowTable")
        results = msm_fixed_host(sl, table)
    else:
        px, py, pvalid = (torch.as_tensor(a).to(device) for a in points_dev)
        if c is None:
            c = default_window(px.shape[0])
        results = msm_pippenger_host(sl, px, py, pvalid, c)
    results = results[:b_real]
    return results[0] if single else results


def fixed_base_expand(base, scalars, device=None):
    """Compute [s * base for s in scalars] on the device (for SRS generation).

    base: host affine point; scalars: list of ints. Returns affine host
    points. Uses the mixed incomplete add over the doubling table of the
    base: the incomplete contract's only broken case (acc == entry, both
    valid) cannot occur — after processing bits < i the accumulator is
    (k mod 2^i) * base with k mod 2^i < 2^i <= 2^253 < r, so its scalar never
    equals the entry's 2^i. The cancellation lane acc == -entry (possible at
    i = 253 since r - 2^253 < 2^253) IS handled: h = 0, r != 0 gives Z3 = 0,
    the correct identity encoding."""
    device = resolve_device(device)
    scalars = [int(s) % FR.p for s in scalars]
    n = len(scalars)
    doublings = []
    pt = base
    for _ in range(SCALAR_BITS):
        doublings.append(pt)
        pt = g1_double(pt)
    dx, dy, _ = points_to_device(doublings, device=device)
    raw = b"".join(s.to_bytes(32, "little") for s in scalars)
    bytes_arr = np.frombuffer(raw, dtype=np.uint8).reshape(n, 32)
    bits = np.unpackbits(bytes_arr, axis=1, bitorder="little")[:, :SCALAR_BITS]
    bits = torch.from_numpy(np.ascontiguousarray(bits.T).astype(bool)).to(device)
    acc = jac_infinity((n,), device=device)
    for i in range(SCALAR_BITS):
        acc = jac_madd_incomplete(acc, dx[i].expand(n, 16), dy[i].expand(n, 16),
                                  bits[i])
    return points_from_device(acc)
