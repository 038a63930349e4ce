"""Vectorized prime-field arithmetic on PyTorch tensors.

Counterpart of ``zerog_tpu/field/jfield.py`` with the same values at the
module boundary:

- A field element is a little-endian array of 16 limbs x 16 bits in the last
  axis of an ``int64`` tensor (PyTorch has no add, shift or compare for
  ``uint32`` on the CPU; a 16x16-limb schoolbook column of 16-bit products
  stays under 2^36, so int64 lanes never overflow).
- Multiplication is Montgomery with R = 2^256:
      T = a * b                         (31 column sums, one outer product)
      m = (T mod R) * (-p^{-1}) mod R   (low-half convolution)
      res = (T + m * p) / R             (convolution + exact shift)
  followed by one conditional subtraction. The convolutions are matrix
  products in float64, which hold every product and column sum exactly
  (each under 2^53). Any Montgomery product that ends fully reduced in
  [0, p) has the same canonical limbs, so results equal the JAX package's
  limb for limb.
- Carry propagation is not a 32-step ripple: two shift-and-add passes bring
  every limb under 2^16 + 33, and the remaining 0/1 carries are resolved by
  one integer addition of the packed generate/propagate masks (the carry
  chain of an adder is exactly the limb carry chain).

All functions are shape-polymorphic over leading batch dimensions and
broadcast as torch broadcasts. On a CPU tensor ``add``, ``sub`` and ``mul``
run the plain torch bodies above (``add_plain``, ``sub_plain``,
``mul_plain``); on a CUDA tensor each is one launch of the kernel
``field_limbs`` (``csrc/field_limbs.cu``: the field bodies of ``field.cuh``
on the same int64 limb layout, every operand addressed with its own strides,
a broadcast one with a stride of 0), whose results equal the plain bodies'
limb for limb. The derived ops (``square``, ``neg``, ``to_mont``,
``from_mont``, ``pow_const``, ``sum``) follow them.

Traced (:mod:`zerog_tpu_torch.trace`), each call of a public op of
:class:`JField` adds 1 to the counter ``field_ops``, a call made inside
another op too (``square`` counts itself and its ``mul``); each launch of
the kernel adds 1 to ``field_kernel``, and each operand that it had to copy
first (a view that one stride a dimension cannot address) 1 to
``field_kernel_copies``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels, trace
from .params import FieldParams, FR, FQ, NLIMB, LIMB_BITS, MASK

__all__ = [
    "NLIMB", "LIMB_BITS", "JField", "jfr", "jfq", "shift_fill",
    "plan_strides", "limbs_operands", "field_limbs",
]


def shift_fill(a, shift: int, fill=0, axis: int = 0, backward: bool = False):
    """Shift `a` by `shift` lanes along `axis`, filling vacated lanes.

    forward (default): out[i] = a[i-shift] for i >= shift, else fill.
    backward=True:     out[i] = a[i+shift] for i < size-shift, else fill.

    `fill` is a scalar or a tensor broadcastable over the trailing dims (e.g.
    the Montgomery one-limbs for multiplicative scans)."""
    size = a.shape[axis]
    shift = min(int(shift), size)
    pad_shape = list(a.shape)
    pad_shape[axis] = shift
    if isinstance(fill, torch.Tensor):
        pad = fill.to(a.dtype).expand(pad_shape)
    else:
        pad = torch.full(pad_shape, fill, dtype=a.dtype, device=a.device)
    if backward:
        return torch.cat([a.narrow(axis, shift, size - shift), pad], dim=axis)
    return torch.cat([pad, a.narrow(axis, 0, size - shift)], dim=axis)


def _int_to_limbs_np(x: int) -> np.ndarray:
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(NLIMB)],
                    dtype=np.int64)


@functools.cache
def _pow2(n: int, device) -> torch.Tensor:
    return (torch.ones(n, dtype=torch.int64, device=device)
            << torch.arange(n, dtype=torch.int64, device=device))


@functools.cache
def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _carry_passes(cols, passes: int):
    """`passes` shift-and-add rounds: each column keeps its low 16 bits and
    takes the high bits of the column below. Returns the columns and the sum
    of the carries out of the top one (None after no pass)."""
    top = None
    for _ in range(passes):
        hi = cols >> LIMB_BITS
        cols = cols & MASK
        cols[..., 1:] += hi[..., :-1]
        top = hi[..., -1] if top is None else top + hi[..., -1]
    return cols, top


def _normalize(cols, ncols: int, passes: int):
    """Carry-propagate non-negative int64 columns into canonical 16-bit limbs.
    Returns (limbs [..., ncols], carry [...]) with value(cols) = value(limbs)
    + carry * 2^(16*ncols).

    `passes` shift-and-add rounds must bring every column under 2^17 - 1
    with "bit 16 set implies low half != 0xFFFF" (two rounds do for columns
    under 2^38, three for columns under 2^57, one for three summed limb
    vectors, none for a sum of two canonical
    limb vectors); the last 0/1 ripple is one packed integer add."""
    m = cols.shape[-1]
    if m < ncols:
        cols = F.pad(cols, (0, ncols - m))
    elif m > ncols:
        cols = cols[..., :ncols]
    cols, top = _carry_passes(cols, passes)
    low = cols & MASK
    g = cols >> LIMB_BITS                       # 0 or 1
    w = _pow2(ncols, cols.device)
    y = (g * w).sum(-1)
    x = y | ((low == MASK).to(torch.int64) * w).sum(-1)
    carries = (x + y) ^ x ^ y                   # bit i = carry into limb i
    cin = (carries.unsqueeze(-1) >> _arange(ncols, cols.device)) & 1
    limbs = (low + cin) & MASK
    cout = (carries >> ncols) & 1
    return limbs, (cout if top is None else top + cout)


@functools.cache
def _column_sums(device) -> torch.Tensor:
    """[256, 32] float64 0/1 matrix: row 16 i + j has its one in column
    i + j (column 31 stays zero, so a product has 32 columns)."""
    idx = torch.arange(NLIMB * NLIMB)
    out = torch.zeros(NLIMB * NLIMB, 2 * NLIMB, dtype=torch.float64)
    out[idx, idx // NLIMB + idx % NLIMB] = 1
    return out.to(device)


def _toeplitz(limbs: np.ndarray, ncols: int) -> np.ndarray:
    """[16, ncols] float64: row i holds `limbs` from column i on, so that
    x @ T is the convolution of x with `limbs`, cut to `ncols` columns."""
    out = np.zeros((NLIMB, ncols), dtype=np.float64)
    for i in range(NLIMB):
        k = min(NLIMB, ncols - i)
        if k > 0:
            out[i, i:i + k] = limbs[:k]
    return out


def _conv(a, b):
    """Column sums of the limb product: a [..., 16] x b [..., 16] -> [..., 32],
    column k = sum_{i+j=k} a_i * b_j (column 31 is zero). One outer product
    and one matrix product in float64: every product of two limbs is under
    2^32 and every column sum under 2^36, so float64 holds them exactly and
    any order of summation gives the same integers."""
    outer = a.unsqueeze(-1).to(torch.float64) * b.unsqueeze(-2).to(torch.float64)
    flat = outer.reshape(outer.shape[:-2] + (NLIMB * NLIMB,))
    return (flat @ _column_sums(a.device)).to(torch.int64)


# ---- the kernel path: field_limbs ------------------------------------------------

_OPS = {"mul": 0, "add": 1, "sub": 2}


def plan_strides(shape_a, stride_a, shape_b, stride_b):
    """How ``field_limbs`` addresses a binary op on two limb tensors.

    `shape_x` and `stride_x` are an operand's element dimensions (the limb
    axis left out) and their strides in int64 words. Returns ``(out_shape,
    rows, cols, (sr_a, sc_a), (sr_b, sc_b))``: the broadcast element shape,
    and the result's elements as ``[rows, cols]`` with element (r, c) of
    each operand at ``r * sr + c * sc``; a broadcast dimension has stride 0.
    Dimensions of size 1 are dropped and neighbours that both operands step
    through evenly are merged; None where more than two remain."""
    out = tuple(torch.broadcast_shapes(tuple(shape_a), tuple(shape_b)))

    def expanded(shape, stride):
        pad = len(out) - len(shape)
        return [0 if i < pad or shape[i - pad] == 1 else stride[i - pad]
                for i in range(len(out))]

    dims = []           # (size, stride of a, stride of b), outermost first
    for size, sa, sb in zip(out, expanded(shape_a, stride_a),
                            expanded(shape_b, stride_b)):
        if size == 1:
            continue
        if dims and dims[-1][1] == sa * size and dims[-1][2] == sb * size:
            dims[-1] = (dims[-1][0] * size, sa, sb)
        else:
            dims.append((size, sa, sb))
    if len(dims) > 2:
        return None
    dims = [(1, 0, 0)] * (2 - len(dims)) + dims
    (rows, ra, rb), (cols, ca, cb) = dims
    return out, rows, cols, (ra, ca), (rb, cb)


def _fresh(x, shape):
    """`x` broadcast to `shape` + the limb axis, as a new contiguous tensor."""
    out = torch.empty(tuple(shape) + (NLIMB,), dtype=x.dtype, device=x.device)
    return out.copy_(x.expand_as(out))


def _addressable(x):
    """Whether the kernel can read `x` in place: limbs contiguous, 16-byte
    aligned, every element stride even (16-byte loads of limb pairs)."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % 2 == 0 for s, n in zip(x.stride()[:-1], x.shape[:-1])
                    if n > 1))


def limbs_operands(a, b):
    """The operands of one ``field_limbs`` launch on int64 limb tensors `a`
    and `b`, on any device: ``(out_shape, rows, cols, a, (sr_a, sc_a), b,
    (sr_b, sc_b))`` as :func:`plan_strides` gives them. An operand that the
    kernel cannot read in place, or every operand not already contiguous at
    the result's shape where more than two dimensions are left, is first
    copied, contiguous at the result's shape, and counted in
    ``field_kernel_copies``."""
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.int64 or x.dim() == 0 or x.shape[-1] != NLIMB:
            raise ValueError(f"field_limbs: {name} is not an int64 limb tensor "
                             f"[..., {NLIMB}] (got {x.dtype} {tuple(x.shape)})")

    def plan(x, y):
        return plan_strides(x.shape[:-1], x.stride()[:-1], y.shape[:-1], y.stride()[:-1])

    planned = plan(a, b)
    out = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    ops = [a, b]
    for i, x in enumerate(ops):
        full = tuple(x.shape[:-1]) == out and x.is_contiguous()
        if not _addressable(x) or (planned is None and not full):
            # a contiguous operand steps evenly through every dimension, so
            # the plan again merges at least what it merged before
            ops[i] = _fresh(x, out)
            trace.count("field_kernel_copies")
    if ops[0] is not a or ops[1] is not b:
        planned = plan(*ops)
    out, rows, cols, sa, sb = planned
    return out, rows, cols, ops[0], sa, ops[1], sb


@kernels.register("field_limbs")
def field_limbs(params: FieldParams, op: str, a, b):
    """Launch ``field_limbs``: `op` (mul, add or sub) of Fq or Fr over int64
    limb tensors [..., 16] on one CUDA device, broadcast as torch
    broadcasts. Returns a new contiguous tensor of the broadcast shape.
    Each launch is counted in ``field_kernel``."""
    if params.name not in ("Fq", "Fr"):
        raise ValueError(f"field_limbs: no kernel for field {params.name}")
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.is_cuda and b.device == a.device):
        raise ValueError("field_limbs: expected two CUDA tensors on one device")
    out_shape, rows, cols, a, (sra, sca), b, (srb, scb) = limbs_operands(a, b)
    out = torch.empty(out_shape + (NLIMB,), dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out
    trace.count("field_kernel")
    with kernels.on_device(a) as stream:
        code = kernels.lib().zg_field_limbs(
            a.data_ptr(), sra, sca, b.data_ptr(), srb, scb, out.data_ptr(),
            rows, cols, 0 if params.name == "Fq" else 1, _OPS[op], stream)
    kernels.launched("field_limbs", code)
    return out


class JField:
    """Tensor arithmetic for one prime field, in Montgomery form."""

    def __init__(self, params: FieldParams):
        self.params = params
        self.p_limbs = _int_to_limbs_np(params.p)
        # 2^256 - p, for complement-based subtraction
        self.negp_limbs = _int_to_limbs_np((1 << 256) - params.p)
        # p + 1 as columns (limb 0 may reach 2^16): the "+1" of the complement
        self.p1_limbs = self.p_limbs.copy()
        self.p1_limbs[0] += 1
        # -p^{-1} mod 2^256 (full width; only the low product is used)
        self.n_prime = _int_to_limbs_np((-pow(params.p, -1, 1 << 256)) % (1 << 256))
        self.r2_limbs = _int_to_limbs_np(params.to_mont(params.r_mont))  # R^2 in "plain" limbs
        self.one_mont = _int_to_limbs_np(params.r_mont)  # 1 in Montgomery form
        self.zero = _int_to_limbs_np(0)
        # float64 convolution matrices of mul (see there): the product by p,
        # and the low half of the product by n' for the two 16-bit halves of
        # a column side by side
        self.p_conv = _toeplitz(self.p_limbs, 2 * NLIMB)
        low = _toeplitz(self.n_prime, NLIMB)
        self.nprime_conv = np.block([[low, np.zeros_like(low)],
                                     [np.zeros_like(low), low]])
        self._dev_consts = {}

    # -- helpers -----------------------------------------------------------
    def _c(self, name: str, device) -> torch.Tensor:
        """A limb constant of this field as a tensor on `device` (cached)."""
        key = (name, str(device))
        t = self._dev_consts.get(key)
        if t is None:
            t = self._dev_consts[key] = torch.from_numpy(
                getattr(self, name)).to(device)
        return t

    def const(self, x: int, mont: bool = True, *, device):
        """A host int as a tensor constant on `device` (Montgomery form by
        default)."""
        v = self.params.to_mont(x % self.params.p) if mont else (x % self.params.p)
        return torch.from_numpy(_int_to_limbs_np(v)).to(device)

    def _cond_sub_p(self, r):
        # d = r - p via addition of the two's complement; keep r if it would
        # underflow (no carry out), else keep d.
        d, carry = _normalize(r + self._c("negp_limbs", r.device), NLIMB, 0)
        return torch.where((carry > 0).unsqueeze(-1), d, r)

    # -- ring ops ----------------------------------------------------------
    def add(self, a, b):
        trace.count("field_ops")
        if a.is_cuda:
            return field_limbs(self.params, "add", a, b)
        return self.add_plain(a, b)

    def sub(self, a, b):
        trace.count("field_ops")
        if a.is_cuda:
            return field_limbs(self.params, "sub", a, b)
        return self.sub_plain(a, b)

    def mul(self, a, b):
        """Montgomery product: (a * b * R^{-1}) mod p."""
        trace.count("field_ops")
        if a.is_cuda:
            return field_limbs(self.params, "mul", a, b)
        return self.mul_plain(a, b)

    def neg(self, a):
        trace.count("field_ops")
        return self.sub(torch.zeros_like(a), a)

    # -- the plain bodies: torch ops on any device ---------------------------
    def add_plain(self, a, b):
        s, _ = _normalize(a + b, NLIMB, 0)  # a + b < 2p < 2^255: no carry out
        return self._cond_sub_p(s)

    def sub_plain(self, a, b):
        # a - b = a + p + (2^256 - b) mod 2^256; all columns non-negative.
        cols = a + self._c("p1_limbs", a.device) + (b ^ MASK)
        d, _ = _normalize(cols, NLIMB, 1)  # drop the 2^256 carry
        return self._cond_sub_p(d)

    def mul_plain(self, a, b):
        dev = a.device
        t = _conv(a, b)                                        # < 2^36
        # m = T_lo * n' mod 2^256 straight from the raw low columns (their
        # value is T mod 2^256 up to multiples of 2^256). A column times a
        # limb of n' may pass 2^53, so each column goes in as its two 16-bit
        # halves and their products are put together in int64: < 2^57
        low = t[..., :NLIMB]
        halves = torch.cat([low & MASK, low >> LIMB_BITS], dim=-1)
        mh = (halves.to(torch.float64) @ self._c("nprime_conv", dev)).to(torch.int64)
        # three passes bring m's columns under 2^16 + 2^11; m counts only
        # mod 2^256 (the carries out of the top are multiples of it) and by
        # its size, under 1.04 * 2^256, which keeps (T + m*p)/R under
        # p^2/R + 1.04 p < 2p, so it needs no final ripple
        m, _ = _carry_passes(mh[..., :NLIMB] + (mh[..., NLIMB:] << LIMB_BITS), 3)
        mp = (m.to(torch.float64) @ self._c("p_conv", dev)).to(torch.int64)
        limbs, _ = _normalize(t + mp, 2 * NLIMB, 2)            # < 2^38
        # (T + m*p)/R < 2p < 2^255: the high half, top carry 0
        return self._cond_sub_p(limbs[..., NLIMB:])

    def square(self, a):
        trace.count("field_ops")
        return self.mul(a, a)

    def to_mont(self, a):
        trace.count("field_ops")
        return self.mul(a, self._c("r2_limbs", a.device))

    def from_mont(self, a):
        trace.count("field_ops")
        one = torch.zeros(NLIMB, dtype=torch.int64, device=a.device)
        one[0] = 1
        return self.mul(a, one)

    def select(self, cond_bool, a, b):
        """cond_bool: bool[...] -> limbwise select."""
        trace.count("field_ops")
        return torch.where(cond_bool.unsqueeze(-1), a, b)

    def is_zero(self, a):
        trace.count("field_ops")
        return (a == 0).all(dim=-1)

    def eq(self, a, b):
        trace.count("field_ops")
        return (a == b).all(dim=-1)

    def pow_const(self, a, e: int):
        """a^e for a small *static* exponent, via square-and-multiply. Use
        only for tiny exponents (e.g. 3, 5)."""
        trace.count("field_ops")
        assert e >= 0
        result = self._c("one_mont", a.device).expand(a.shape)
        base = a
        while e:
            if e & 1:
                result = self.mul(result, base)
            e >>= 1
            if e:
                base = self.square(base)
        return result

    # -- reductions --------------------------------------------------------
    def sum(self, a, axis: int = 0):
        """Modular sum along an axis via pairwise (log-depth) reduction."""
        trace.count("field_ops")
        a = torch.movedim(a, axis, 0)
        n = a.shape[0]
        while n > 1:
            half = n // 2
            merged = self.add(a[:half], a[half: 2 * half])
            if n % 2:
                merged = torch.cat([merged, a[2 * half: n]], dim=0)
            a = merged
            n = a.shape[0]
        return a[0]


@functools.cache
def _cached(name: str) -> JField:
    return JField(FR if name == "Fr" else FQ)


def jfr() -> JField:
    return _cached("Fr")


def jfq() -> JField:
    return _cached("Fq")
