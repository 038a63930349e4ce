"""The MSM flush scan: CUDA kernels ``flush_scan_affine`` and
``flush_scan_jac``, and their plain version.

Counterpart of ``zerog_tpu/curve/pscan.py``. A stream of R point rows over
[G, C] columns is scanned down the rows: each column keeps a Jacobian carry
that starts at infinity; per row the carry is emitted as a piece where the
flush flag is set (zeros elsewhere), then the carry restarts from the row's
point (flag set) or takes the point in by an incomplete add. Returns the
pieces of all R rows and, as row R, the final carries.

:func:`flush_scan` is the only entry: a CPU stream goes to the plain version
(a Python loop over rows calling :mod:`jpoints` — the same arithmetic in the
same order), a CUDA stream to the kernel.

Kernel note — ``flush_scan_affine`` replaces ``_scan_kernel_affine`` and
``flush_scan_jac`` replaces ``_scan_kernel_jac`` of
``zerog_tpu/curve/pscan.py`` (reached through ``flush_scan_pallas``). There
the sequential row axis is the grid's inner axis and the carry lives in
scratch memory between grid steps; on this card blocks run in no order. The
stream is laid out ``[R, word, column]`` so a warp's loads and stores
coalesce, and the ragged edge is masked instead of padding rows to 8 and
columns to 1,024. Both scans cut each column at its flush flags into
segments, which do not depend on each other (a flagged row restarts the
carry from its point, bit for bit), and give a group of four threads each
slice of 32 rows of a column: it folds the segments that start in its
slice, past the slice if need be, the four threads sharing the products of
each add. The identity cases of the add (a row or a carry whose z is 0; an
invalid affine point) are the incomplete add's selects, so every limb
equals the plain scan's. Both are bounded by the longest chain of adds one
segment needs, not by R adds a column. The affine scan runs the mixed add's
11 products as three rounds a row (a row's first two levels beside the row
before's last two), stages its rows 32 at a time in shared memory, and
keeps the groups of a warp in step; a proof's streams hold segments of all
1,024 rows, so a launch takes ~1,024 x 2.4 us on the H100. The Jacobian
scan takes an identity row without a product; on a proof's compaction
round its chain is one bucket's pieces, up to ~320.
"""

from __future__ import annotations

import torch

from .. import kernels
from .jpoints import (
    jac_add_incomplete, jac_from_affine, jac_infinity, jac_madd_incomplete,
    jac_select,
)

__all__ = ["flush_scan", "flush_scan_plain", "flush_scan_affine_words",
           "flush_scan_jac_words", "stream_to_planes", "pieces_from_planes"]


# ---- plain version ------------------------------------------------------------

def flush_scan_plain(stream, flags, affine: bool):
    """Plain flush scan. stream: (x, y, valid) for an affine stream or
    (x, y, z) for a Jacobian one, coordinates [R, G, C, 16], valid/flags bool
    [R, G, C]. Returns jac pieces [R+1, G, C, 16] (row r = piece flushed at
    step r; row R = final carry)."""
    r_total, g, cdim = flags.shape
    carry = jac_infinity((g, cdim), device=flags.device)
    zeros = (torch.zeros_like(stream[0][0]),) * 3
    rows = []
    for i in range(r_total):
        flag = flags[i]
        rows.append(jac_select(flag, carry, zeros))
        if affine:
            x, y, val = stream[0][i], stream[1][i], stream[2][i]
            carry = jac_select(flag, jac_from_affine(x, y, val),
                               jac_madd_incomplete(carry, x, y, val))
        else:
            pt = (stream[0][i], stream[1][i], stream[2][i])
            carry = jac_select(flag, pt, jac_add_incomplete(carry, pt))
    rows.append(carry)
    return tuple(torch.stack([row[comp] for row in rows], dim=0)
                 for comp in range(3))


# ---- layout converters ----------------------------------------------------------

def stream_to_planes(arr):
    """[R, G, C, 16] limbs -> int32 word planes [R, 8, G*C]; a mask
    [R, G, C] -> uint8 [R, G*C] (one byte per entry)."""
    r = arr.shape[0]
    if arr.dim() == 4:
        return kernels.to_word_planes(arr.reshape(r, -1, 16))
    return arr.reshape(r, -1).to(torch.uint8).contiguous()


def pieces_from_planes(planes, g: int, c: int):
    """int32 word planes [R, 8, G*C] -> limbs [R, G, C, 16]."""
    r = planes.shape[0]
    return kernels.from_word_planes(planes).reshape(r, g, c, 16)


# ---- kernel wrappers --------------------------------------------------------------

def _scan_launch(name: str, sx, sy, third, third_dtype, flags):
    if not isinstance(sx, torch.Tensor) or sx.dim() != 3:
        raise ValueError(f"{name}: expected word planes [R, 8, C]")
    r, _, ct = sx.shape
    kernels.check_planes(f"{name} x", sx, (r, 8, ct))
    kernels.check_planes(f"{name} y", sy, (r, 8, ct))
    if third_dtype == torch.uint8:
        kernels.check_planes(f"{name} valid", third, (r, ct), torch.uint8)
    else:
        kernels.check_planes(f"{name} z", third, (r, 8, ct))
    kernels.check_planes(f"{name} flags", flags, (r, ct), torch.uint8)
    for t in (sy, third, flags):
        if t.device != sx.device:
            raise ValueError(f"{name}: operands on different devices")
    pieces = tuple(torch.empty_like(sx) for _ in range(3))
    carry = tuple(torch.empty((8, ct), dtype=torch.int32, device=sx.device)
                  for _ in range(3))
    with kernels.on_device(sx) as stream:
        code = getattr(kernels.lib(), "zg_" + name)(
            sx.data_ptr(), sy.data_ptr(), third.data_ptr(), flags.data_ptr(),
            *(t.data_ptr() for t in pieces), *(t.data_ptr() for t in carry),
            r, ct, stream)
    kernels.launched(name, code)
    return pieces + carry


@kernels.register("flush_scan_affine")
def flush_scan_affine_words(sx, sy, valid, flags):
    """Launch the affine flush scan. sx, sy: int32 word planes [R, 8, C];
    valid, flags: uint8 [R, C] (one byte per entry, nonzero = set). Returns
    (px, py, pz, cx, cy, cz): pieces [R, 8, C] and final carries [8, C]."""
    return _scan_launch("flush_scan_affine", sx, sy, valid, torch.uint8, flags)


@kernels.register("flush_scan_jac")
def flush_scan_jac_words(sx, sy, sz, flags):
    """Launch the Jacobian flush scan. sx, sy, sz: int32 word planes
    [R, 8, C]; flags: uint8 [R, C]. Returns pieces and final carries like
    :func:`flush_scan_affine_words`."""
    return _scan_launch("flush_scan_jac", sx, sy, sz, torch.int32, flags)


def flush_scan(stream, flags, affine: bool):
    """Flush scan over a stream [R, G, C] — affine (x, y, valid) or jacobian
    (x, y, z) per `affine` — returning jac pieces [R+1, G, C, 16]."""
    if not flags.is_cuda:
        return flush_scan_plain(stream, flags, affine)
    _, g, cdim = flags.shape
    wrapper = flush_scan_affine_words if affine else flush_scan_jac_words
    out = wrapper(*(stream_to_planes(a) for a in stream),
                  stream_to_planes(flags))
    return tuple(
        pieces_from_planes(torch.cat([out[i], out[3 + i][None]], dim=0), g, cdim)
        for i in range(3))
