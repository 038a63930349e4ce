"""The int8-DFT NTT engine over Fr: the CUDA kernels ``ntt_epilogue`` and
``ntt_twiddle`` and their plain versions.

Counterpart of ``zerog_tpu/poly/pntt.py``. An NTT is a linear map; over the
32 little-endian bytes of each element it becomes dense int8 matrix products.

Scheme (recursive four-step, factors <= 256):
    n = r * s,  x[i1 + r*i2]  (i1 in [r], i2 in [s])
    1. s-point sub-NTTs along i2 (batched over i1)     -> S[i1, j2]
    2. twiddle  S'[i1, j2] = omega^(i1*j2) * S[i1, j2]   (kernel ntt_twiddle,
       which also regroups S' for step 3 and sums its columns)
    3. r-point DFT product along i1 (batched over j2)  -> X[s*j1 + j2]
Base case t <= 256: one dense DFT product.

Each t-point DFT over Fr is one int8 product: multiplication by the constant
entry w = omega_t^(jk) is Z-linear in the bytes,

    out_bytes[(b, j)] = sum_{k, a} byte_b(w_{jk} * R * 2^(8a) mod p) * x_bytes[(a, k)]

and the R factor pre-folds one Montgomery reduction: the accumulator V
satisfies V = R * y (mod p) with V < 2^286, so one REDC(V) returns the
canonical Montgomery form of y — bit-identical to the butterflies.

Both sides of the product are stored shifted by -128 (int8); the exact
correction is applied in the epilogue:

    M @ x = (M - 128)(x - 128) + 128 * colsum(x - 128)  [per output column]
          + 128 * rowsum(M - 128) + 128 * 128 * K       [static per row: rowc]

Matrix rows are byte-major (row = b*t + j) and activations element-per-lane
(``[32 * t, G]``), so a level's accumulator is an int32 ``[32, t, G]`` tensor
whose 32 byte columns the epilogue carries into one 256-bit value.

The product is ``torch._int_mm`` (int8 x int8 -> int32, exact: |acc| <=
32t * 128^2 <= 2^27), as the JAX package leaves it to an XLA dot. The two
kernels around it are CUDA C++ (``csrc/ntt.cu``):

Kernel note — ``ntt_epilogue`` replaces ``_epilogue_call`` /
``_epilogue_kernel_body`` with ``_redc_limbs`` of ``zerog_tpu/poly/pntt.py``.
One thread per element (row j, lane g, g fastest so that each of the 32
plane loads of a warp is one coalesced line). It adds the -128 correction
itself (``colsum``, ``rowc``: the JAX code does that in a separate pass over
the int32 accumulator; for an outer level the column sums come from
``ntt_twiddle``), carries the 32 byte columns into 8 words plus a high
word (< 2^22), does one 9-word Montgomery REDC (PTX carry chains) and one
conditional subtract, optionally a Montgomery product by a twiddle, and
writes int8 byte planes (-128 offset) or int32 word planes. Per element it
reads 128 bytes and writes 32 against 64 multiply-adds (128 more with the
twiddle): bound by bytes, and on the card it also issues ~800 instructions
an element, so it reaches ~70 % of the bytes bound at 2^17. Splitting an
element over several threads, or packing several elements into a thread's
wide loads and stores, measured slower (``csrc/ntt.cu``).

Kernel note — ``ntt_twiddle`` replaces ``_twiddle_call`` of the same file
and the regroup that follows it in its ``_run_device`` (and so the copy the
regroup was here, and the sum of the outer product's columns). One pass: it
reads the inner transforms' bytes [32, s, r * G] (-128 offset) and the
compact ``[8, s, r]`` word table (lane l of row j2 takes column l // G; the
G-times-larger broadcast never exists), multiplies element (j2, i1, g) by
omega_m^(i1*j2) (Montgomery), writes the outer level's input [32, r, s * G]
directly and the byte sum of each of its lanes, which ``_matmul_level``
takes instead of summing that input again. A block owns a tile of
(j2, i1) pairs with all G lanes of each, so that both its reads and its
writes are runs of bytes (48 and 96 bytes at the 2^17 outer level); it
stages the tile's 32 planes in shared memory by 16-byte ``cp.async``,
multiplies from registers, writes the bytes back in output order and adds
each lane's sum with one ``atomicAdd`` a tile. 64 bytes an element against
the 128 multiply-adds of one product: bound by bytes, and the products'
issued instructions take nearly as long. On the card a 2^17 level takes
~2.9x its bytes bound: the staged copies and the products do not overlap
(``csrc/ntt.cu``, ``PERF.md``).

A CPU tensor takes the plain versions (:func:`epilogue_plain`,
:func:`twiddle_plain`, tensor field arithmetic), a CUDA tensor the kernels;
that is the only dispatch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..field import FR, jfr, to_limbs
from ..field.jfield import _normalize

__all__ = ["PnttPlan", "get_pntt_plan", "pntt_transform", "epilogue",
           "epilogue_plain", "epilogue_words", "twiddle", "twiddle_plain",
           "twiddle_words", "limbs_to_byteplanes", "limbs_from_word_planes"]

P = FR.p
R256 = 1 << 256
NPRIME = (-pow(P, -1, R256)) % (1 << 256)  # -p^-1 mod 2^256


def _factors(log_n: int) -> tuple[int, ...]:
    """Split log_n into ceil(log_n/8) near-equal factors (each 2^f <= 256):
    fewest levels first — the per-level epilogue and twiddle cost
    dominates."""
    levels = max(1, -(-log_n // 8))
    base, extra = divmod(log_n, levels)
    return tuple(1 << (base + (1 if i < extra else 0)) for i in range(levels))


def _byte_matrix(t: int, omega_t: int, post_scale: int = 1) -> np.ndarray:
    """Dense int16 byte matrix for the t-point DFT (values 0..255; the int8
    offset shift happens at pack time). M[(b*t + j), (a*t + k)] = byte b of
    (omega_t^(j*k) * post_scale * R * 2^(8a) mod p)."""
    m = np.zeros((32 * t, 32 * t), dtype=np.int16)
    w_pows = np.empty(t, dtype=object)
    cur = 1
    for k in range(t):
        w_pows[k] = cur
        cur = cur * omega_t % P
    base = post_scale * R256 % P
    for j in range(t):
        wj = w_pows[j]
        c = base
        row_vals = np.empty(t, dtype=object)
        # c_k = omega^(j*k) * base: incremental multiply by omega^j
        for k in range(t):
            row_vals[k] = c
            c = c * wj % P
        for a in range(32):
            col = a * t
            # v_a = row_vals * 2^(8a) mod p, then its 32 bytes spread rows
            if a:
                row_vals = row_vals * 256 % P
            raw = b"".join(int(v).to_bytes(32, "little") for v in row_vals)
            bytes_jk = np.frombuffer(raw, dtype=np.uint8).reshape(t, 32)
            # rows b*t + j, column col + k  <- byte b of v_a[k]
            m[j::t, col : col + t] = bytes_jk.T[:, :]
    return m


def _redc(v: int) -> int:
    """Montgomery REDC: v < R*p -> v * R^-1 mod p, canonical."""
    mm = (v * NPRIME) % R256
    t = (v + mm * P) >> 256
    return t - P if t >= P else t


class PnttPlan:
    """Per (log_n, omega, n_scale) host tables for the int8-DFT NTT."""

    def __init__(self, log_n: int, omega: int, n_scale: int = 1):
        self.log_n = log_n
        self.n = 1 << log_n
        self.omega = omega
        self.n_scale = n_scale            # folded into the LAST level matrix
        self.factors = _factors(log_n)
        # matrices per level position (distinct (t, omega_t, scale) combos)
        self._mats: dict = {}
        self._twiddles: dict = {}
        # n_scale is applied exactly once per element: folded into the
        # outermost level's matrix (the one applied last); inner levels get
        # scale 1.
        self._program = self._build_program(self.log_n, self.omega, True)

    def _build_program(self, log_m: int, omega_m: int, outermost: bool):
        """Returns the recursive step descriptor tree."""
        fs = _factors(log_m)
        r = fs[0]
        scale = self.n_scale if outermost else 1
        if len(fs) == 1:
            key = (r, omega_m % P, scale)
            if key not in self._mats:
                self._mats[key] = _byte_matrix(r, omega_m, scale)
            return {"kind": "base", "t": r, "mat": key}
        log_r = (r - 1).bit_length()
        s = (1 << log_m) // r
        omega_r = pow(omega_m, s, P)
        key = (r, omega_r, scale)
        if key not in self._mats:
            self._mats[key] = _byte_matrix(r, omega_r, scale)
        inner = self._build_program(log_m - log_r, pow(omega_m, r, P), False)
        return {
            "kind": "split", "r": r, "s": s, "log_m": log_m,
            "omega": omega_m % P, "mat": key, "inner": inner,
        }

    def twiddle_bytes(self, log_m: int, omega_m: int, r: int, s: int):
        """Montgomery-form twiddles omega_m^(i1*j2) as uint32 16-limb
        trailing arrays [r, s, 16] (host, cached)."""
        key = ("tw", log_m, omega_m, r, s)
        tw = self._twiddles.get(key)
        if tw is None:
            rows = np.empty((r, s), dtype=object)
            for i1 in range(r):
                w = pow(omega_m, i1, P)
                cur = R256 % P  # 1 in Montgomery form
                for j2 in range(s):
                    rows[i1, j2] = cur
                    cur = cur * w % P
            # the rows are already * R: plain limbs of the Montgomery values
            tw = self._twiddles[key] = to_limbs(rows)
        return tw

    def ntt_ref(self, values: np.ndarray) -> np.ndarray:
        """Reference transform on host ints: values [n] Python-int
        Montgomery residues (v*R mod p) -> transformed Montgomery residues
        [n]. Pins the engine independently of the butterflies."""
        def run(prog, vec):
            m = len(vec)
            if prog["kind"] == "base":
                t = prog["t"]
                out = [0] * t
                _, omega_t, scale = prog["mat"]
                for j in range(t):
                    acc = 0
                    for k in range(t):
                        acc += pow(omega_t, j * k, P) * vec[k]
                    out[j] = acc * scale % P
                return out
            r_, s_ = prog["r"], prog["s"]
            omega_m = prog["omega"]
            _, omega_r, scale = prog["mat"]
            cols = []
            for i1 in range(r_):
                sub = [vec[i1 + r_ * i2] for i2 in range(s_)]
                cols.append(run(prog["inner"], sub))
            out = [0] * m
            for j2 in range(s_):
                for j1 in range(r_):
                    acc = 0
                    for i1 in range(r_):
                        tw = pow(omega_m, i1 * j2, P)
                        acc += pow(omega_r, j1 * i1, P) * tw % P * cols[i1][j2]
                    out[s_ * j1 + j2] = acc * scale % P
            return out

        vec = [int(v) for v in values]
        return np.array(run(self._program, vec), dtype=object)


# ---------------------------------------------------------------------------
# Device engine. Layout between levels: int8 byte planes [32, m, G] storing
# byte - 128; element i of transform g has its 32 little-endian bytes along
# axis 0. The last level writes int32 word planes [8, m, G] (8 little-endian
# 32-bit words, the kernels' element form).
# ---------------------------------------------------------------------------

def _words_to_limbs(words):
    """int32 words [..., 8] -> int64 16-bit limbs [..., 16]."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
        w.shape[:-1] + (16,))


def _limbs_to_words(limbs):
    """int64 16-bit limbs [..., 16] -> int32 words [..., 8]."""
    return (limbs[..., 0::2] | (limbs[..., 1::2] << 16)).to(torch.int32)


def _bytes_to_limbs(xb):
    """int8 byte planes [32, ...] (-128 offset) -> int64 limbs [..., 16]."""
    b = xb.to(torch.int64) + 128
    return torch.movedim(b[0::2] | (b[1::2] << 8), 0, -1)


def _limbs_to_bytes(limbs):
    """int64 limbs [..., 16] -> int8 byte planes [32, ...] (-128 offset)."""
    planes = torch.stack([limbs & 0xFF, limbs >> 8], dim=-1)   # [..., 16, 2]
    planes = planes.reshape(limbs.shape[:-1] + (32,))
    return (torch.movedim(planes, -1, 0) - 128).to(torch.int8).contiguous()


def epilogue_plain(acc, colsum, rowc, tw=None, out_bytes: bool = True):
    """Plain version of ``ntt_epilogue``: acc int32 [32, t, G] (the raw
    offset product), colsum int32 [G], rowc int32 [32 * t], tw None or int32
    word planes [8, t, G] -> int8 byte planes [32, t, G] or int32 word
    planes [8, t, G] of REDC(corrected acc) (times tw, Montgomery)."""
    f = jfr()
    t = acc.shape[1]
    v = (acc.to(torch.int64) + 128 * colsum.to(torch.int64)
         + rowc.to(torch.int64).reshape(32, t, 1))             # exact, >= 0
    cols = torch.movedim(v[0::2] + (v[1::2] << 8), 0, -1)      # [t, G, 16]
    low, c_hi = _normalize(cols, 16, 2)                        # V = low + c_hi R
    # REDC(V) = low * R^-1 + c_hi (mod p); c_hi < 2^22 < p
    one = torch.zeros(16, dtype=torch.int64, device=acc.device)
    one[0] = 1
    hi = torch.zeros_like(low)
    hi[..., 0] = c_hi & 0xFFFF
    hi[..., 1] = c_hi >> 16
    res = f.add(f.mul(low, one), hi)
    if tw is not None:
        res = f.mul(res, _words_to_limbs(torch.movedim(tw, 0, -1)))
    if out_bytes:
        return _limbs_to_bytes(res)
    return torch.movedim(_limbs_to_words(res), -1, 0).contiguous()


@kernels.register("ntt_epilogue")
def epilogue_words(acc, colsum, rowc, tw=None, out_bytes: bool = True):
    """Launch ``ntt_epilogue`` (CUDA tensors; arguments as
    :func:`epilogue_plain`)."""
    if not isinstance(acc, torch.Tensor) or acc.dim() != 3 or acc.shape[0] != 32:
        raise ValueError("ntt_epilogue: expected an accumulator [32, t, G]")
    t, g = acc.shape[1], acc.shape[2]
    kernels.check_planes("ntt_epilogue acc", acc, (32, t, g))
    kernels.check_planes("ntt_epilogue colsum", colsum, (g,))
    kernels.check_planes("ntt_epilogue rowc", rowc, (32 * t,))
    if tw is not None:
        kernels.check_planes("ntt_epilogue tw", tw, (8, t, g))
    if out_bytes:
        out = torch.empty((32, t, g), dtype=torch.int8, device=acc.device)
    else:
        out = torch.empty((8, t, g), dtype=torch.int32, device=acc.device)
    with kernels.on_device(acc) as stream:
        code = kernels.lib().zg_ntt_epilogue(
            acc.data_ptr(), colsum.data_ptr(), rowc.data_ptr(),
            None if tw is None else tw.data_ptr(), out.data_ptr(), t, g,
            int(bool(out_bytes)), stream)
    kernels.launched("ntt_epilogue", code)
    return out


def epilogue(acc, colsum, rowc, tw=None, out_bytes: bool = True):
    if acc.is_cuda:
        return epilogue_words(acc, colsum, rowc, tw, out_bytes)
    return epilogue_plain(acc, colsum, rowc, tw, out_bytes)


def twiddle_plain(xb, twc):
    """Plain version of ``ntt_twiddle``: xb int8 byte planes [32, s, r * G]
    (-128 offset), twc int32 word planes [8, s, r] -> (int8 [32, r, s * G],
    int32 [s * G]): each element times twc[:, j2, lane // G] (Montgomery),
    regrouped for the outer product (element (j2, i1, g) to row i1, lane
    j2 * G + g), and each output lane's byte sum over its rows and planes."""
    s, lanes = xb.shape[1], xb.shape[2]
    r = twc.shape[2]
    g = lanes // r
    tw = _words_to_limbs(torch.movedim(twc, 0, -1))             # [s, r, 16]
    tw = tw[:, :, None, :].expand(s, r, g, 16).reshape(s, lanes, 16)
    prod = _limbs_to_bytes(jfr().mul(_bytes_to_limbs(xb), tw))
    out = prod.reshape(32, s, r, g).transpose(1, 2).reshape(32, r, s * g)
    return out, out.reshape(32 * r, s * g).sum(dim=0, dtype=torch.int32)


@kernels.register("ntt_twiddle")
def twiddle_words(xb, twc):
    """Launch ``ntt_twiddle`` (CUDA tensors; arguments and results as
    :func:`twiddle_plain`)."""
    if not isinstance(xb, torch.Tensor) or xb.dim() != 3 or xb.shape[0] != 32:
        raise ValueError("ntt_twiddle: expected byte planes [32, s, r * G]")
    s, lanes = xb.shape[1], xb.shape[2]
    if twc.dim() != 3 or lanes % twc.shape[2]:
        raise ValueError("ntt_twiddle: expected a twiddle table [8, s, r] "
                         "with r dividing the lanes")
    r = twc.shape[2]
    g = lanes // r
    kernels.check_planes("ntt_twiddle xb", xb, (32, s, lanes), torch.int8)
    kernels.check_planes("ntt_twiddle twc", twc, (8, s, r))
    out = torch.empty((32, r, s * g), dtype=torch.int8, device=xb.device)
    colsum = torch.empty(s * g, dtype=torch.int32, device=xb.device)
    with kernels.on_device(xb) as stream:
        code = kernels.lib().zg_ntt_twiddle(
            xb.data_ptr(), twc.data_ptr(), out.data_ptr(), colsum.data_ptr(), s,
            r, g, stream)
    kernels.launched("ntt_twiddle", code)
    return out, colsum


def twiddle(xb, twc):
    if xb.is_cuda:
        return twiddle_words(xb, twc)
    return twiddle_plain(xb, twc)


class _DevicePlan:
    """Tables of one PnttPlan on one device: int8 matrices, row-correction
    vectors, compact twiddle word planes."""

    def __init__(self, plan: PnttPlan, device):
        self.plan = plan
        self.device = device
        self.mats = {}
        self.rowc = {}
        for key, m in plan._mats.items():
            m8 = (m.astype(np.int32) - 128).astype(np.int8)
            self.mats[key] = torch.from_numpy(m8).to(device)
            # static correction: 128*rowsum(M') + 128*128*K per output row
            k_dim = m.shape[1]
            rc = 128 * m8.astype(np.int64).sum(axis=1) + 128 * 128 * k_dim
            self.rowc[key] = torch.from_numpy(rc.astype(np.int32)).to(device)
        self._tw = {}

    def twiddle_planes(self, log_m, omega_m, r, s):
        """int32 word planes [8, s, r]: the compact table; the kernel reads
        column lane // G, so the per-lane broadcast never exists."""
        key = (log_m, omega_m, r, s)
        tw = self._tw.get(key)
        if tw is None:
            host = self.plan.twiddle_bytes(log_m, omega_m, r, s)   # [r, s, 16]
            words = _limbs_to_words(torch.from_numpy(host.astype(np.int64)))
            tw = self._tw[key] = words.permute(2, 1, 0).contiguous().to(
                self.device)
        return tw


_device_plans: dict = {}


def _device_plan(plan: PnttPlan, device) -> _DevicePlan:
    key = (id(plan), str(device))
    dp = _device_plans.get(key)
    if dp is None:
        dp = _device_plans[key] = _DevicePlan(plan, device)
    return dp


def _matmul_level(dp: _DevicePlan, key, xb, twiddle=None,
                  out_bytes: bool = True, colsum=None):
    """One DFT level: xb int8 [32, t, G] -> epilogue output. The product is
    ``torch._int_mm`` (s8 x s8 -> s32); the epilogue (correction, carry,
    REDC, optional twiddle) is the kernel. `colsum`, the byte sums of xb's
    lanes, comes from the twiddle pass before an outer level; other levels
    sum xb here."""
    t = key[0]
    g = xb.shape[2]
    a = xb.reshape(32 * t, g)
    acc = torch._int_mm(dp.mats[key], a)
    if colsum is None:
        colsum = a.sum(dim=0, dtype=torch.int32)
    return epilogue(acc.view(32, t, g), colsum, dp.rowc[key], twiddle,
                    out_bytes)


def _run_device(dp: _DevicePlan, prog, xb, out_bytes: bool):
    """The recursive four-step transform on byte planes [32, m, G]."""
    if prog["kind"] == "base":
        return _matmul_level(dp, prog["mat"], xb, out_bytes=out_bytes)
    r, s = prog["r"], prog["s"]
    g = xb.shape[2]
    m = r * s
    # inner s-point transforms along i2, batched over (i1, g): axis 1
    # (i = i1 + r*i2) reshapes to [s, r] with i2 major — a view
    inner_out = _run_device(dp, prog["inner"], xb.reshape(32, s, r * g),
                            out_bytes=True)
    # twiddle omega_m^(i1*j2): the outer product contracts over i1, so its
    # inputs are twiddled first (an epilogue fold would need i1-dependent
    # matrices); the same pass regroups them for the outer r-point
    # transforms along i1, batched over (j2, g), and sums their columns
    twc = dp.twiddle_planes(prog["log_m"], prog["omega"], r, s)   # [8, s, r]
    xb3, colsum = twiddle(inner_out, twc)
    out = _matmul_level(dp, prog["mat"], xb3, out_bytes=out_bytes,
                        colsum=colsum)
    # output index j = s*j1 + j2: [.., r(j1), s*g] -> [.., m, g] directly
    return out.reshape(out.shape[0], m, g)


def limbs_to_byteplanes(x):
    """int64 limbs [B, n, 16] -> int8 byte planes [32, n, B] with the -128
    offset."""
    return _limbs_to_bytes(x.permute(1, 0, 2))


def limbs_from_word_planes(planes):
    """int32 word planes [8, n, B] -> int64 limbs [B, n, 16]."""
    return _words_to_limbs(planes.permute(2, 1, 0))


def _lane_align(plan: PnttPlan) -> int:
    """Batch multiple that keeps every level's lane count a multiple of 8
    (``torch._int_mm`` on CUDA needs it): a level of t rows has n / t lanes
    per transform."""
    return max(1, 8 // (plan.n // max(plan.factors)))


def pntt_transform(plan: PnttPlan, values):
    """values: int64 Montgomery limbs [..., n, 16] -> transformed (natural
    order), same shape and device. Bit-exact against the butterflies of
    :class:`~zerog_tpu_torch.poly.ntt.NttPlan`."""
    lead = tuple(values.shape[:-2])
    x = values.reshape((-1,) + tuple(values.shape[-2:]))
    b = x.shape[0]
    pad = (-b) % _lane_align(plan)
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    dp = _device_plan(plan, x.device)
    out = _run_device(dp, plan._program, limbs_to_byteplanes(x),
                      out_bytes=False)
    return limbs_from_word_planes(out)[:b].reshape(lead + (plan.n, 16))


@functools.cache
def get_pntt_plan(log_n: int, omega: int, n_scale: int = 1) -> PnttPlan:
    return PnttPlan(log_n, omega, n_scale)
