"""KZG structured reference string (powers of tau), the `ParamsKZG` equivalent.

Counterpart of ``zerog_tpu/curve/srs.py``. Holds both the monomial basis
{tau^i G} and the Lagrange basis {L_i(tau) G} (as halo2's ParamsKZG does), so
the prover can commit Lagrange-form polynomials without an iNTT. Generation
runs the fixed-base expansion on the device; tau is derived from a seed
(INSECURE test setup, same trust model as `ParamsKZG::setup` with a known
RNG). The host point lists are device-independent; tensors (point sets,
window tables) live on the device the SRS was made for.
"""

from __future__ import annotations

import hashlib
import os
import struct
import tempfile

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..field import FR, batch_inv, jfr, to_numpy
from .bn254 import (
    G1_GEN, G2_GEN, g2_mul, g1_to_bytes, g1_from_bytes, g2_to_bytes, g2_from_bytes,
)
from .pippenger import (
    fixed_base_expand, msm, build_window_table, default_fixed_window,
    default_window, msm_fixed_host, msm_pippenger_host)
from .jpoints import points_to_device

__all__ = ["Srs", "CACHE_DIR"]

_MAGIC = b"ZGTPUSRS"

# where merged-window tables are kept between processes (expanded when a
# table is looked up, so a caller may point it elsewhere)
CACHE_DIR = "~/.cache/zerog_tpu_torch"


def _table_key(k: int, c: int, points) -> str:
    """The JAX package's cache key of a point set's window table: blake2b
    of ``wtable:{k}:{c}:`` and x, y (32 bytes LE) of points 0, 1, -1 and
    n/2, skipping the point at infinity."""
    h = hashlib.blake2b(f"wtable:{k}:{c}:".encode(), digest_size=16)
    for pt in (points[0], points[1], points[-1], points[len(points) // 2]):
        if pt is not None:
            h.update(pt[0].to_bytes(32, "little"))
            h.update(pt[1].to_bytes(32, "little"))
    return h.hexdigest()


def _write_table(path: str, table) -> None:
    """Write `table` to `path` through a temporary file renamed into place,
    so a reader never sees half a file and concurrent writers leave one
    whole one. A write that fails (read-only or full disk) is skipped: the
    cache only saves time."""
    tmp = None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz.tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, tx=to_numpy(table.tx), ty=to_numpy(table.ty),
                     tv=table.tvalid.cpu().numpy().astype(bool))
        os.replace(tmp, path)
    except OSError:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)


class Srs:
    def __init__(self, k: int, g, g_lagrange, g2, s_g2, device=None):
        self.device = resolve_device(device)
        self.k = k
        self.n = 1 << k
        self.g = g                  # [n] affine host points, g[i] = tau^i * G
        self.g_lagrange = g_lagrange  # [n] affine host points, L_i(tau) * G
        self.g2 = g2
        self.s_g2 = s_g2
        self._g_dev = None
        self._lag_dev = None
        self._tables = {}           # basis -> WindowTable (merged-window MSM)

    # ---- generation ------------------------------------------------------
    @classmethod
    def setup(cls, k: int, seed: bytes | int = b"zerog-tpu-test-srs",
              tau: int | None = None, device=None):
        device = resolve_device(device)
        n = 1 << k
        if tau is None:
            if isinstance(seed, int):
                seed = seed.to_bytes(32, "little")
            tau = int.from_bytes(hashlib.blake2b(seed, digest_size=32).digest(), "little") % FR.p
        # monomial scalars
        powers = [1] * n
        for i in range(1, n):
            powers[i] = powers[i - 1] * tau % FR.p
        # lagrange scalars: L_i(tau) = w^i/n * (tau^n - 1)/(tau - w^i)
        omega = FR.nth_root_of_unity(k)
        tn1 = (pow(tau, n, FR.p) - 1) % FR.p
        if tn1 == 0:
            raise ValueError("tau in evaluation domain; pick another seed")
        wpows = [1] * n
        for i in range(1, n):
            wpows[i] = wpows[i - 1] * omega % FR.p
        denoms = [(tau - w) % FR.p for w in wpows]
        dinv = batch_inv(denoms, FR.p)
        ninv = FR.inv(n)
        lag_scalars = [w * ninv % FR.p * tn1 % FR.p * d % FR.p for w, d in zip(wpows, dinv)]
        # both bases in ONE expansion: the 254 steps are launch-bound, so
        # 2n lanes cost little more than n
        pts = fixed_base_expand(G1_GEN, powers + lag_scalars, device=device)
        return cls(k, pts[:n], pts[n:], G2_GEN, g2_mul(G2_GEN, tau), device=device)

    # ---- device caches ---------------------------------------------------
    def g_dev(self):
        if self._g_dev is None:
            self._g_dev = points_to_device(self.g, device=self.device)
        return self._g_dev

    def g_lagrange_dev(self):
        if self._lag_dev is None:
            self._lag_dev = points_to_device(self.g_lagrange, device=self.device)
        return self._lag_dev

    # ---- commitments -----------------------------------------------------
    # below this row count the merged-window table costs more than it saves
    # (and CPU test circuits stay on the per-window path)
    FIXED_MIN_N = 4096

    @property
    def MAX_BATCH(self) -> int:
        """Commitments per bucket-pipeline run. The pipeline is bound by its
        sequential scan steps, whose cost is nearly batch-independent, so
        batch as wide as device memory allows: the merged stream + piece
        arrays are O(B * W * n) with W ~ 20 windows — hence the n-based
        taper."""
        if self.n <= (1 << 15):
            return 8
        if self.n <= (1 << 16):
            return 4
        return 2

    def window_table(self, basis: str, min_n: int | None = None):
        """Cached merged-window table (see pippenger.build_window_table) for
        one of the two fixed SRS point sets; None below `min_n`
        (FIXED_MIN_N unless given: the mesh path takes a table at any
        size).

        The table is deterministic from the point set, so it is also kept
        on disk, in :data:`CACHE_DIR`, and a later process reads it instead
        of running the doubling chain again. The file is the JAX package's:
        ``wtable_<key>.npz`` with ``tx``, ``ty`` (uint32[W*n, 16]) and
        ``tv`` (bool[W*n]), keyed by :func:`_table_key`, so a file written
        by either package loads in the other. A basis takes ~42 MB at
        k = 14 (c = 13, 20 windows) and ~271 MB at k = 17 (c = 16, 16
        windows): 129 bytes a point a window. Deleting the directory clears
        the cache."""
        if self.n < (self.FIXED_MIN_N if min_n is None else min_n):
            return None
        if basis not in self._tables:
            from ..convert import window_table_from_numpy  # convert imports Srs

            c = default_fixed_window(self.n)
            points = self.g_lagrange if basis == "lagrange" else self.g
            path = os.path.join(os.path.expanduser(CACHE_DIR),
                                f"wtable_{_table_key(self.k, c, points)}.npz")
            if os.path.exists(path):
                with np.load(path) as d:
                    table = window_table_from_numpy(
                        c, self.n, d["tx"], d["ty"], d["tv"], device=self.device)
            else:
                table = build_window_table(self._pdev(basis), c, device=self.device)
                _write_table(path, table)
            self._tables[basis] = table
        return self._tables[basis]

    def _pdev(self, basis: str):
        return self.g_lagrange_dev() if basis == "lagrange" else self.g_dev()

    def _msm_chunked(self, rows, basis: str):
        table = self.window_table(basis)
        pdev = None if table is not None else self._pdev(basis)
        # pad the batch to a MAX_BATCH multiple with zero rows so every
        # run has ONE batch shape (and the JAX package's lane layout)
        b = len(rows)
        short = (-b) % self.MAX_BATCH
        if short:
            rows = list(rows) + [[0] * len(rows[0])] * short
        out = []
        for i in range(0, len(rows), self.MAX_BATCH):
            out.extend(msm(rows[i : i + self.MAX_BATCH], pdev, table=table,
                           device=self.device))
        return out[:b]
    # each commitment call is the span ``msm`` (zerog_tpu_torch.trace), from
    # its entry until its points are on the host
    @trace.spanned("msm")
    def commit_lagrange(self, values):
        """values: [n] ints or [B][n] -> affine point(s). KZG ignores blinds
        (hiding comes from randomized rows, as in halo2)."""
        single = not isinstance(values[0], (list, tuple, np.ndarray))
        rows = [values] if single else list(values)
        out = self._msm_chunked(rows, "lagrange")
        return out[0] if single else out

    @trace.spanned("msm")
    def commit(self, coeffs):
        """Commit coefficient-form poly(s) of length <= n."""
        single = not isinstance(coeffs[0], (list, tuple, np.ndarray))
        rows = [coeffs] if single else list(coeffs)
        n = self.n
        padded = [list(r) + [0] * (n - len(r)) for r in rows]
        out = self._msm_chunked(padded, "monomial")
        return out[0] if single else out

    # ---- device-resident commitment paths ---------------------------------
    # Scalars that already live on the device in Montgomery limb form (the
    # prover's Lagrange/coefficient stacks) commit without a host round trip:
    # demont on device, feed the Pippenger pipeline directly.
    def _msm_dev(self, stack, basis: str):
        if stack.dim() == 2:
            stack = stack[None]
        b = stack.shape[0]
        b_pad = ((b + self.MAX_BATCH - 1) // self.MAX_BATCH) * self.MAX_BATCH
        sl = jfr().from_mont(stack.to(self.device))
        if b_pad > b:
            sl = torch.cat(
                [sl, torch.zeros((b_pad - b,) + tuple(sl.shape[1:]),
                                 dtype=sl.dtype, device=sl.device)], dim=0)
        table = self.window_table(basis)
        out = []
        for i in range(0, b_pad, self.MAX_BATCH):
            if table is not None:
                res = msm_fixed_host(sl[i : i + self.MAX_BATCH], table)
            else:
                px, py, pvalid = self._pdev(basis)
                res = msm_pippenger_host(
                    sl[i : i + self.MAX_BATCH], px, py, pvalid,
                    c=default_window(self.n))
            out.extend(res)
        return out[:b]

    @trace.spanned("msm")
    def commit_lagrange_dev(self, stack):
        """stack: mont limb tensor [B, n, 16] (or [n, 16]) of Lagrange
        values -> list of B affine host points."""
        single = stack.dim() == 2
        out = self._msm_dev(stack, "lagrange")
        return out[0] if single else out

    @trace.spanned("msm")
    def commit_dev(self, stack):
        """stack: device mont limbs [B, n, 16] coefficient-form."""
        single = stack.dim() == 2
        out = self._msm_dev(stack, "monomial")
        return out[0] if single else out

    # ---- serialization ----------------------------------------------------
    # Two on-disk formats, both `k:u32 LE || g[n] || g_lagrange[n] || g2 ||
    # s_g2` with 64-byte G1 / 128-byte G2 points:
    #
    # - "native":  MAGIC-prefixed, coordinates canonical little-endian
    #   (`FQ.to_bytes`).
    # - "halo2":   halo2's `ParamsKZG::write` with `SerdeFormat::RawBytes`
    #   : NO magic, each Fq coordinate is the
    #   internal *Montgomery form* (value * 2^256 mod q) as 4 u64 limbs
    #   little-endian, G2 Fq2 as c0 || c1. Files produced by the reference
    #   CLI's generate-srs load directly; files written here load in halo2.
    #
    # `read` autodetects (the magic cannot collide with a u32 k).
    def write(self, path, fmt: str = "native"):
        if fmt not in ("native", "halo2"):
            raise ValueError(f"unknown SRS format {fmt!r}")
        g1b = g1_to_bytes if fmt == "native" else _g1_to_halo2
        g2b = g2_to_bytes if fmt == "native" else _g2_to_halo2
        with open(path, "wb") as f:
            if fmt == "native":
                f.write(_MAGIC)
            f.write(struct.pack("<I", self.k))
            for pt in self.g:
                f.write(g1b(pt))
            for pt in self.g_lagrange:
                f.write(g1b(pt))
            f.write(g2b(self.g2))
            f.write(g2b(self.s_g2))

    @classmethod
    def read(cls, path, device=None):
        device = resolve_device(device)
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        if data[:8] == _MAGIC:
            off = 8
            g1r, g2r = g1_from_bytes, g2_from_bytes
        else:
            g1r, g2r = _g1_from_halo2, _g2_from_halo2
        (k,) = struct.unpack_from("<I", data, off)
        off += 4
        n = 1 << k
        expected = off + 2 * n * 64 + 2 * 128
        if len(data) != expected:
            raise ValueError(
                f"SRS file length {len(data)} != expected {expected} for k={k}")
        g = []
        for _ in range(n):
            g.append(g1r(data[off : off + 64]))
            off += 64
        lag = []
        for _ in range(n):
            lag.append(g1r(data[off : off + 64]))
            off += 64
        g2 = g2r(data[off : off + 128])
        off += 128
        s_g2 = g2r(data[off : off + 128])
        # G2 has cofactor > 1: on-curve alone does not imply r-torsion
        # membership, so check [r]P = O for both G2 points of a loaded SRS.
        for pt in (g2, s_g2):
            if g2_mul(pt, FR.p) is not None:
                raise ValueError("SRS G2 point not in the r-torsion subgroup")
        return cls(k, g, lag, g2, s_g2, device=device)


# ---- halo2 RawBytes coordinate codec ----------------------------------------

_R_MONT = 1 << 256


def _fq_to_halo2(v: int) -> bytes:
    from ..field import FQ

    return (v * _R_MONT % FQ.p).to_bytes(32, "little")


def _fq_from_halo2(b: bytes) -> int:
    from ..field import FQ

    raw = int.from_bytes(b, "little")
    if raw >= FQ.p:
        raise ValueError("non-canonical halo2 field element")
    return raw * pow(_R_MONT, -1, FQ.p) % FQ.p


def _g1_to_halo2(pt) -> bytes:
    x, y = pt if pt is not None else (0, 0)
    return _fq_to_halo2(x) + _fq_to_halo2(y)


def _g1_from_halo2(b: bytes):
    x = _fq_from_halo2(b[:32])
    y = _fq_from_halo2(b[32:64])
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    from .bn254 import g1_is_on_curve

    if not g1_is_on_curve(pt):
        raise ValueError("halo2 SRS point not on curve")
    return pt


def _g2_to_halo2(pt) -> bytes:
    (x0, x1), (y0, y1) = pt if pt is not None else ((0, 0), (0, 0))
    return b"".join(_fq_to_halo2(c) for c in (x0, x1, y0, y1))


def _g2_from_halo2(b: bytes):
    from .bn254 import g2_is_on_curve

    x = (_fq_from_halo2(b[:32]), _fq_from_halo2(b[32:64]))
    y = (_fq_from_halo2(b[64:96]), _fq_from_halo2(b[96:128]))
    if x == (0, 0) and y == (0, 0):
        return None
    pt = (x, y)
    if not g2_is_on_curve(pt):
        raise ValueError("halo2 SRS G2 point not on curve")
    return pt
