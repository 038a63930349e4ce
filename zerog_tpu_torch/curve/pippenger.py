"""Pippenger multi-scalar multiplication on tensors.

Counterpart of ``zerog_tpu/curve/pippenger.py`` — the MSM behind every
commitment of keygen and create_proof. Strategies, chosen by argument:

- "pippenger" (default): bucketed column-scan Pippenger — sort by window
  digit, flush-scan bucket accumulation, marginal-split weighted sum. The
  flush scan and the bucket folds are CUDA kernels on the card
  (curve/pscan.py, curve/pfold.py) and plain loops on the CPU. Uses the
  INCOMPLETE Jacobian add, so it requires pairwise-distinct, random-looking
  base points (SRS tau powers qualify: an internal add collision has
  probability ~2^-254 and would only corrupt the proof being built, which
  the verifier then rejects). Do NOT use it on structured point sets (e.g.
  small multiples of G, adversarial proof-supplied points); use "danaa".
- "fixed": the same bucket pipeline over a precomputed merged-window table
  (:func:`build_window_table`), one accumulation for all windows.
- "segscan": the log-depth segmented-scan pipeline over the same table
  (``msm_fixed_host(..., strategy="segscan")``).
- "danaa": lane-parallel double-and-add with the unified (complete) add;
  correct for arbitrary points.
- "scan": the per-window segmented-scan pipeline (complete add),
  :func:`msm_device`.

The last three are plain torch, as their counterparts are plain ``jnp``.

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
limbs of every piece: every sort here asks for ``stable=True``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import trace
from ..device import resolve_device
from ..field import FR, FQ, jfq, shift_fill, to_limbs, from_limbs, to_device
from .jpoints import (
    jac_add, jac_add_incomplete, jac_double, jac_from_affine, jac_infinity,
    jac_madd_incomplete, jac_roll, jac_select, points_from_device,
    points_to_device,
)
from .bn254 import G1_GEN, g1_add, g1_double, g1_mul
from .pscan import flush_scan
from .pfold import sum_rows_many, weighted

__all__ = ["msm", "msm_device", "msm_pippenger_host", "msm_fixed_host",
           "fixed_base_expand", "default_window", "default_fixed_window",
           "build_window_table", "WindowTable"]


def default_window(n: int) -> int:
    """Window width heuristic shared by every MSM entry point."""
    return max(4, min(10, int(n).bit_length() - 4))


SCALAR_BITS = 254
_PIP_R = 128       # least rows per column in the accumulation scan
_INT32_MAX = (1 << 31) - 1


def _digits(scalar_limbs, c: int, scalar_bits: int = SCALAR_BITS):
    """[..., 16] canonical limbs -> int64[W, ...] window digits."""
    num_windows = (scalar_bits + c - 1) // c
    outs = []
    for w in range(num_windows):
        j, r = divmod(w * c, 16)
        v = scalar_limbs[..., j] >> r
        if j + 1 < 16 and r + c > 16:
            v = v | (scalar_limbs[..., j + 1] << (16 - r))
        outs.append(v & ((1 << c) - 1))
    return torch.stack(outs, dim=0)


def _suffix_scan(p, m: int):
    """Inclusive suffix sum along axis 0 of a length-m batch of points:
    out[i] = sum_{j>=i} p[j] (complete add)."""
    idx = torch.arange(m, device=p[0].device)
    for s in range(max(1, (m - 1).bit_length())):
        shift = 1 << s
        q = jac_roll(p, -shift)
        p = jac_select(idx + shift < m, jac_add(p, q), p)
    return p


def _scatter_buckets(p, key, nb: int):
    """Jacobian lanes p [G, M] into bucket slots [G, nb] (empty slots
    all-zero, Z = 0 = infinity): lane (g, i) goes to slot key[g, i], and
    key nb drops it (to a spare slot past the end, sliced off). The kept
    keys of a group are distinct, so the scatter is deterministic."""
    g, m = key.shape
    packed = torch.cat(p, dim=-1).reshape(g * m, 48)
    flat = torch.arange(g, device=key.device)[:, None] * (nb + 1) + key
    out = torch.zeros((g * (nb + 1), 48), dtype=packed.dtype, device=key.device)
    out[flat.reshape(-1)] = packed
    out = out.reshape(g, nb + 1, 48)[:, :nb]
    return out[..., :16], out[..., 16:32], out[..., 32:]


def _one_window(d, px, py, pvalid, c: int):
    """Window sums  sum_i d[g, i] * P_i  for digit rows d [G, n] in
    [0, 2^c) over shared points [n, 16]: sort each row (stably, as
    ``jnp.argsort``), a segmented inclusive scan over runs of equal digit,
    each run's last lane into its bucket, then sum_b b * B_b by two suffix
    scans. Returns Jacobian components [G, 16]."""
    g, n = d.shape
    dev = d.device
    ds, order = torch.sort(d, dim=-1, stable=True)
    val = pvalid[order] & (ds > 0)
    p = jac_from_affine(px[order], py[order], valid=val)

    idx = torch.arange(n, device=dev)
    for s in range(max(1, (n - 1).bit_length())):
        shift = 1 << s
        q = jac_roll(p, shift, axis=1)
        same = (ds == torch.roll(ds, shift, dims=1)) & (idx >= shift)
        p = jac_select(same, jac_add(p, q), p)

    is_end = torch.cat([ds[:, :-1] != ds[:, 1:],
                        torch.ones((g, 1), dtype=torch.bool, device=dev)], dim=1)
    nb = 1 << c
    buckets = _scatter_buckets(p, torch.where(is_end & (ds > 0), ds, nb), nb)
    # weighted sum over buckets 1..nb-1: two suffix passes, bucket axis first
    s = tuple(torch.movedim(comp[:, 1:], 1, 0) for comp in buckets)
    s = _suffix_scan(s, nb - 1)          # s[i] = sum_{b >= i+1} B_b
    t = _suffix_scan(s, nb - 1)          # t[0] = sum_i s[i] = sum_b b*B_b
    return tuple(comp[0] for comp in t)


def msm_device(scalar_limbs, px, py, pvalid, c: int):
    """scalar_limbs: [B, N, 16] canonical; points: mont affine [N, 16] on
    the same device. Returns Jacobian window sums, components [B, W, 16].
    Every window of every row runs in one batch of lanes."""
    digits = _digits(scalar_limbs, c)                  # [W, B, N]
    w, b, n = digits.shape
    sums = _one_window(digits.reshape(w * b, n), px, py, pvalid, c)
    return tuple(torch.movedim(comp.reshape(w, b, 16), 1, 0) for comp in sums)


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
    if trace.enabled():
        trace.count("d2h_bytes", max_run.nbytes)
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


def msm_fixed_host(sl, table: WindowTable, strategy: str = "flush"):
    """Merged-window fixed-base MSM. sl: [B, N, 16] canonical scalar limbs
    on the table's device; table from build_window_table. Returns [B] affine
    host points. `strategy` "flush" runs the bucket pipeline of the flush
    scan (the kernels on the card), "segscan" the log-depth segmented scan."""
    if strategy == "segscan":
        return _msm_fixed_segscan(sl, table)
    if strategy != "flush":
        raise ValueError(f"unknown fixed-base MSM strategy {strategy!r}")
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


# ---- log-depth segmented-scan bucket pipeline --------------------------------
#
# Alternative to the flush scan over the same merged-window table. Three
# log-depth stages:
#
#   1. segmented inclusive scan (Hillis-Steele) over the sorted digit stream:
#      log2(M) full-width steps, each ONE incomplete add over all M lanes
#      (safe: operands are sums of disjoint subsets of distinct table points).
#   2. one scatter of each segment's last lane into the bucket array.
#   3. weighted bucket fold sum_k k*B_k via per-bucket bias injection
#      B'_k = B_k + (k+1)*K — every partial sum carries a DISTINCT multiple
#      of the bias point K, so incomplete adds cannot collide even between
#      empty-bucket runs — then a log-depth suffix scan + log-depth tree
#      reduction, and the host subtracts the known total bias multiple.

#: lanes of one step of the segmented scan: rows of the batch are scanned in
#: groups of at most this many lanes (each row is independent), which bounds
#: the limb products' temporaries (~4 KB a lane)
_SEGSCAN_LANES = 1 << 19


def _segscan_prep(sl, tx, ty, tv, c: int):
    """Sort the merged digit stream (stably) and gather table points into
    stream order. Returns (ds, gx, gy, gv, seg_id, last)."""
    digits = _digits_balanced(sl, c)                # [W, B, N]
    w, b, n = digits.shape
    ds = torch.movedim(digits, 0, 1).reshape(b, w * n)
    ds = torch.where(tv[None, :], ds, torch.zeros_like(ds))  # invalid -> bucket 0
    ds, order = torch.sort(ds, dim=-1, stable=True)
    gx, gy, gv = tx[order], ty[order], tv[order]
    new_seg = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=ds.device),
         ds[:, 1:] != ds[:, :-1]], dim=1)
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=1)
    last = torch.cat([new_seg[:, 1:],
                      torch.ones((b, 1), dtype=torch.bool, device=ds.device)],
                     dim=1)
    return ds, gx, gy, gv, seg_id, last


def _segscan_run(gx, gy, gv, seg_id, steps: int):
    """Hillis-Steele segmented inclusive point scan along axis 1: after
    `steps` rounds each lane holds the sum of the up-to-2^steps preceding
    lanes of its segment. Shifted-in point lanes are all-zero (Z = 0,
    infinity) and shifted-in segment ids -1 (no segment), so no wraparound
    masking is needed."""
    acc = jac_from_affine(gx, gy, gv)
    for s in range(steps):
        shift = 1 << s
        shifted = tuple(shift_fill(comp, shift, fill=0, axis=1) for comp in acc)
        ok = seg_id == shift_fill(seg_id, shift, fill=-1, axis=1)
        acc = jac_select(ok, jac_add_incomplete(acc, shifted), acc)
    return acc


def _segscan_buckets(acc, ds, last, c: int):
    """Scatter each segment's final lane into [B, 2^c] bucket slots. Bucket
    0 is dropped (weight 0), and so are the lanes that end no segment."""
    nb = 1 << c
    return _scatter_buckets(acc, torch.where(last & (ds > 0), ds, nb), nb)


_SEGSCAN_BIAS: dict = {}


def _segscan_bias(c: int, device):
    """Table of multiples (k+1)*K for k = 0..2^c-1 on `device` (built with
    the COMPLETE add — equal operands occur while doubling), plus the host
    total bias multiple M_total = sum_{j=1}^{nb-1} sum_{k=j}^{nb-1} (k+1).
    Cached per (c, device)."""
    key = (c, str(device))
    hit = _SEGSCAN_BIAS.get(key)
    if hit is not None:
        return hit
    nb = 1 << c
    _, (kx, ky, kz) = _pip_bias(device)
    arr = tuple(comp.expand(nb, 16) for comp in (kx, ky, kz))
    for s in range(c):
        shifted = tuple(shift_fill(comp, 1 << s, fill=0, axis=0) for comp in arr)
        arr = jac_add(arr, shifted)
    m_total = sum((nb * (nb + 1) - j * (j + 1)) // 2 for j in range(1, nb))
    hit = _SEGSCAN_BIAS[key] = (arr, m_total)
    return hit


def _segscan_fold(bx, by, bz, bias, c: int):
    """sum_k k*B_k via biased suffix scan: S_j = sum_{k>=j} (B_k + (k+1)K),
    then T = sum_{j>=1} S_j; the caller subtracts M_total*K. Incomplete adds
    are collision-free because every operand embeds a distinct multiple of
    K. Backward shifts bring in all-zero (infinity) lanes, which the
    incomplete add treats as identity — no edge masking needed."""
    nb = 1 << c
    b = bx.shape[0]
    acc = jac_add_incomplete(
        (bx, by, bz), tuple(comp.expand(b, nb, 16) for comp in bias))

    def suffix(acc, shift):
        shifted = tuple(shift_fill(comp, shift, fill=0, axis=1, backward=True)
                        for comp in acc)
        return jac_add_incomplete(acc, shifted)

    for s in range(c):
        acc = suffix(acc, 1 << s)
    # drop S_0 (weight starts at j=1), then tree-reduce lanes 1..nb-1
    first = torch.arange(nb, device=bx.device)[None, :] == 0
    acc = jac_select(first, jac_infinity((b, nb), device=bx.device), acc)
    for s in reversed(range(c)):
        acc = suffix(acc, 1 << s)
    return tuple(comp[:, 0] for comp in acc)


def _msm_fixed_segscan(sl, table: WindowTable):
    c = table.c
    ds, gx, gy, gv, seg_id, last = _segscan_prep(
        sl, table.tx, table.ty, table.tvalid, c=c)
    b, m = ds.shape
    # full log2(M) steps always, as the reference: enough for the worst skew
    steps = max(1, int(m - 1).bit_length())
    rows = max(1, _SEGSCAN_LANES // m)
    parts = [_segscan_run(gx[i:i + rows], gy[i:i + rows], gv[i:i + rows],
                          seg_id[i:i + rows], steps)
             for i in range(0, b, rows)]
    acc = tuple(torch.cat([part[k] for part in parts], dim=0) for k in range(3))
    bx, by, bz = _segscan_buckets(acc, ds, last, c=c)
    bias, m_total = _segscan_bias(c, bx.device)
    host = points_from_device(_segscan_fold(bx, by, bz, bias, c=c))
    kp, _ = _pip_bias_np()
    neg_bias_total = g1_mul((kp[0], (-kp[1]) % FQ.p), m_total)
    return [g1_add(pt, neg_bias_total) for pt in host]


# ---- lane-parallel double-and-add -------------------------------------------

BIT_CHUNK = 32


def _bits_device(scalar_limbs):
    """[B, N, 16] -> bool[256, B, N], MSB first (top 2 bits are zero for
    canonical Fr scalars; leading zeros are free in double-and-add)."""
    rows = [((scalar_limbs[..., j // 16] >> (j % 16)) & 1) > 0
            for j in range(255, -1, -1)]
    return torch.stack(rows, dim=0)


def _danaa_chunk(acc, bits_chunk, px, py, pvalid):
    """BIT_CHUNK double-and-add steps. acc: Jacobian [B, N]; bits_chunk:
    bool[BIT_CHUNK, B, N] (MSB first)."""
    b, n = bits_chunk.shape[1], bits_chunk.shape[2]
    base = jac_from_affine(px.expand(b, n, 16), py.expand(b, n, 16),
                           pvalid.expand(b, n))
    for bit_row in bits_chunk:
        acc = jac_double(acc)
        acc = jac_select(bit_row, jac_add(acc, base), acc)
    return acc


def _reduce_lanes(acc):
    """Fold the N axis of Jacobian [B, N] points into [B]."""
    n = acc[0].shape[1]
    total = _suffix_scan(tuple(torch.swapaxes(comp, 0, 1) for comp in acc), n)
    return tuple(comp[0] for comp in total)


def _msm_danaa_device(bits, px, py, pvalid):
    """Lane-parallel double-and-add MSM. bits: bool[256, B, N] (MSB first);
    points: mont affine [N, 16]. Returns Jacobian [B] points. The complete
    (unified) add makes this the safe strategy for arbitrary point sets."""
    b, n = bits.shape[1], bits.shape[2]
    acc = jac_infinity((b, n), device=px.device)
    for i in range(0, 256, BIT_CHUNK):
        acc = _danaa_chunk(acc, bits[i:i + BIT_CHUNK], px, py, pvalid)
    return _reduce_lanes(acc)


STRATEGIES = ("pippenger", "fixed", "segscan", "danaa", "scan")


def msm(scalars, points_dev=None, c: int | None = None,
        strategy: str = "pippenger", table: WindowTable | None = None,
        device=None):
    """Host-facing MSM.

    scalars: 2D list/array [B][N] of ints in [0, r) (or 1D for B=1);
    points_dev: (px, py, pvalid) from :func:`points_to_device` for the
    strategies "pippenger", "danaa" and "scan", or pass `table` (a
    :class:`WindowTable`) for the merged-window fixed-base path ("fixed",
    or "segscan"). `device=None` means the CUDA card.
    Returns list of B affine points (or a single point for 1D input).
    """
    device = resolve_device(device)
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown MSM strategy {strategy!r}")
    single = not isinstance(scalars[0], (list, tuple, np.ndarray))
    if single:
        scalars = [scalars]
    if table is not None and strategy != "segscan":
        strategy = "fixed"
    b_real = len(scalars)
    b_pad = 1
    while b_pad < b_real:
        b_pad *= 2
    if b_pad > b_real:
        scalars = list(scalars) + [[0] * len(scalars[0])] * (b_pad - b_real)
    sl = to_device(to_limbs(np.asarray(scalars, dtype=object) % FR.p), device)

    if strategy in ("fixed", "segscan"):
        if table is None:
            raise ValueError(f"strategy={strategy!r} requires a WindowTable")
        results = msm_fixed_host(
            sl, table, strategy="segscan" if strategy == "segscan" else "flush")
        results = results[:b_real]
        return results[0] if single else results

    px, py, pvalid = (torch.as_tensor(a).to(device) for a in points_dev)
    if c is None:
        c = default_window(px.shape[0])
    if strategy == "pippenger":
        results = msm_pippenger_host(sl, px, py, pvalid, c)[:b_real]
    elif strategy == "danaa":
        acc = _msm_danaa_device(_bits_device(sl), px, py, pvalid)
        results = points_from_device(tuple(comp[:b_real] for comp in acc))
    else:
        # "scan": window sums normalized in one host batch, folded on the host
        sums = tuple(comp[:b_real] for comp in msm_device(sl, px, py, pvalid, c))
        w = sums[0].shape[1]
        affine = points_from_device(tuple(comp.reshape(b_real * w, 16)
                                          for comp in sums))
        results = [_fold_windows_host(affine[i * w:(i + 1) * w], c)
                   for i in range(b_real)]
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
