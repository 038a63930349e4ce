"""Plane-layout field arithmetic: the CUDA kernel ``field_binop`` and its
plain version.

Counterpart of ``zerog_tpu/field/pfield.py``. The public layout is the JAX
package's: ``[16, M, 128]`` limb planes for N = M * 128 elements (limb index
leads), values equal limb for limb. :class:`PField` takes planes on either
device: a CPU tensor goes to the plain version (the tensor field of
:mod:`jfield`), a CUDA tensor to the kernel, and that is the only dispatch.

Kernel note — ``field_binop`` replaces ``PField._binary_kernel`` of
``zerog_tpu/field/pfield.py`` (the bodies ``_mul_body``, ``_add_body``,
``_sub_body``), Fq and Fr. An element moves 96 bytes (two operands read, one
result written) for at most 128 32-bit multiply-adds (64 for the product, 64
for the reduction), so on this card every one of its operations is bound by
bytes. The field and the operation are template parameters (one
branch-free body a launch); one thread owns one element, keeps its 8 words
in registers for the whole word-serial Montgomery pass and reads and writes
each word plane coalesced, and a wave of 128-thread blocks at 40 registers
keeps enough warps on an SM that their loads overlap the others' products.
Two or four elements a thread with 8- or 16-byte loads, and a grid of the
card's size striding over the elements with the next ones loaded ahead,
were slower on the card (``csrc/field_binop.cu``). The same device
functions are what the MSM kernels inline.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from .jfield import jfr, jfq
from .params import FieldParams, FR, FQ, NLIMB

__all__ = [
    "to_planes", "from_planes", "PField", "pfr", "pfq", "PLANE_LANES",
    "field_binop_words", "field_binop_plain",
]

PLANE_LANES = 128
_OPS = {"mul": 0, "add": 1, "sub": 2}


def to_planes(limbs):
    """[..., N, 16] trailing-limb -> plane layout [..., 16, M, 128]
    (N must be a multiple of 128; pad first if needed)."""
    n = limbs.shape[-2]
    assert n % PLANE_LANES == 0, f"N={n} not a multiple of {PLANE_LANES}"
    m = n // PLANE_LANES
    batch = limbs.shape[:-2]
    x = limbs.reshape(batch + (m, PLANE_LANES, NLIMB))
    return torch.movedim(x, -1, -3)      # [..., 16, m, 128]


def from_planes(planes):
    """Inverse of :func:`to_planes`."""
    batch = planes.shape[:-3]
    m = planes.shape[-2]
    x = torch.movedim(planes, -3, -1)    # [..., m, 128, 16]
    return x.reshape(batch + (m * PLANE_LANES, NLIMB))


def field_binop_plain(op: str, params: FieldParams, a, b):
    """Plain version of the kernel: `op` in mul/add/sub over limb tensors
    [..., 16], through the tensor field's plain torch body (on a CUDA tensor
    too, where the tensor field's own op is the kernel ``field_limbs``)."""
    f = jfr() if params.name == "Fr" else jfq()
    return getattr(f, op + "_plain")(a, b)


@kernels.register("field_binop")
def field_binop_words(op: str, params: FieldParams, a, b):
    """Launch ``field_binop`` on word planes int32[8, n] (CUDA). Returns the
    result planes."""
    if params.name not in ("Fq", "Fr"):
        raise ValueError(f"field_binop: no kernel for field {params.name}")
    if not isinstance(a, torch.Tensor) or a.dim() != 2:
        raise ValueError("field_binop: expected word planes [8, n]")
    n = a.shape[1]
    kernels.check_planes("field_binop a", a, (8, n))
    kernels.check_planes("field_binop b", b, (8, n))
    if b.device != a.device:
        raise ValueError("field_binop: operands on different devices")
    out = torch.empty_like(a)
    with kernels.on_device(a) as stream:
        code = kernels.lib().zg_field_binop(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            0 if params.name == "Fq" else 1, _OPS[op], stream)
    kernels.launched("field_binop", code)
    return out


class PField:
    """Plane-layout arithmetic for one prime field."""

    def __init__(self, params: FieldParams):
        self.params = params

    def _binary(self, op: str, a, b):
        if a.shape != b.shape or a.dim() != 3 or a.shape[0] != NLIMB:
            raise ValueError("PField: expected two [16, M, 128] plane tensors")
        if not a.is_cuda:
            out = field_binop_plain(op, self.params, torch.movedim(a, 0, -1),
                                    torch.movedim(b, 0, -1))
            return torch.movedim(out, -1, 0)
        n = a.shape[1] * a.shape[2]
        wa = kernels.to_word_planes(a.reshape(NLIMB, n).t())
        wb = kernels.to_word_planes(b.reshape(NLIMB, n).t())
        out = kernels.from_word_planes(field_binop_words(op, self.params, wa, wb))
        return out.t().reshape(a.shape)

    def mul(self, a, b):
        """Montgomery product of plane arrays [16, M, 128]."""
        return self._binary("mul", a, b)

    def add(self, a, b):
        return self._binary("add", a, b)

    def sub(self, a, b):
        return self._binary("sub", a, b)


@functools.cache
def pfr() -> PField:
    return PField(FR)


@functools.cache
def pfq() -> PField:
    return PField(FQ)
