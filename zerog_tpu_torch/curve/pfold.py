"""The MSM bucket folds: CUDA kernels ``sum_rows`` and ``weighted_fold``, and
their plain versions.

Counterpart of ``zerog_tpu/curve/pfold.py``. :func:`sum_rows` folds
[L, G, W] Jacobian rows into [G, W] with a left-to-right incomplete-add
chain that starts at infinity. :func:`weighted` takes rows [K, G, 2] ordered
k = K-1 .. 0 and a bias point and returns bias + sum_k k * row_k by the
running-sum recurrence (a2 += a1; a1 += row). A CPU tensor goes to the plain
version (a Python loop over rows calling :mod:`jpoints`), a CUDA tensor to
the kernel; the add order is the same, so results are equal limb for limb.

Incomplete adds are safe here: the carry after step i is the sum of rows
< i, a bucket subset disjoint from row i; the weighted fold's outer
accumulator, which would see structurally equal operands when marginals are
empty, starts from a fixed bias point that the caller subtracts afterwards.

Kernel note — ``sum_rows`` replaces ``_sum_rows_call`` and ``weighted_fold``
replaces ``_weighted_call`` of ``zerog_tpu/curve/pfold.py``. Each row costs
16 (or 32) field products for 96 bytes read, and a lane's rows are a chain
of dependent adds over few lanes (a few hundred for ``sum_rows``, 2 * G =
16 for ``weighted_fold``): the chain's latency bounds them on this card,
not bytes or the product rate. A group of four threads shares the products
of each add, level by level, and a row or an accumulator whose z is 0 is
taken by the add's selects without a product. ``sum_rows`` also folds both
fold shapes of an MSM batch in one launch (:func:`sum_rows_many`), the
longer first; most bucket slots are empty, so its chain is short.
``weighted_fold`` runs a row's two adds (a2 + a1, a1 + row: both read the
a1 of the row before) side by side in two groups of a lane's eight threads
and loads the next row ahead: a row costs one add. Its a2 is a chain of K
adds whatever the rows hold, so it keeps the serial row order: a log-depth
tree over the rows would give other limbs than the JAX package's and meet
structurally equal operands at identity rows, where the incomplete add is
wrong. There is no chunking of the row axis, so any K is taken (no
multiple-of-8 rule).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .jpoints import jac_add_incomplete, jac_infinity

__all__ = ["sum_rows", "sum_rows_many", "weighted", "sum_rows_plain",
           "weighted_plain", "sum_rows_words", "weighted_fold_words"]


# ---- plain versions ---------------------------------------------------------------

def sum_rows_plain(xs):
    """Fold [L, G, W] jac rows into [G, W], row 0 first."""
    acc = jac_infinity(xs[0].shape[1:3], device=xs[0].device)
    for i in range(xs[0].shape[0]):
        acc = jac_add_incomplete(acc, tuple(c[i] for c in xs))
    return acc


def weighted_plain(stacked, bias):
    """stacked: jac [K, G, 2] rows ordered k = K-1 .. 0; bias: jac point
    ([16] limbs each). Computes bias + sum_k k * row_k via (a2 += a1;
    a1 += row)."""
    a1 = jac_infinity(stacked[0].shape[1:3], device=stacked[0].device)
    a2 = tuple(b.expand(a.shape) for b, a in zip(bias, a1))
    for i in range(stacked[0].shape[0]):
        a2 = jac_add_incomplete(a2, a1)
        a1 = jac_add_incomplete(a1, tuple(c[i] for c in stacked))
    return a2


# ---- kernel wrappers ----------------------------------------------------------------

def _check_rows(name, comps):
    if not isinstance(comps[0], torch.Tensor) or comps[0].dim() != 3:
        raise ValueError(f"{name}: expected word planes [L, 8, C]")
    l, _, ct = comps[0].shape
    for label, t in zip("xyz", comps):
        kernels.check_planes(f"{name} {label}", t, (l, 8, ct))
        if t.device != comps[0].device:
            raise ValueError(f"{name}: operands on different devices")
    return l, ct


@kernels.register("sum_rows")
def sum_rows_words(*planes):
    """Launch ``sum_rows`` once on one or two folds (jobs): int32 word
    planes x, y, z [L_j, 8, C_j] for each job, in triples. Returns three
    [8, C_j] planes a job, in the same order."""
    if len(planes) not in (3, 6):
        raise ValueError("sum_rows: expected one or two triples of word planes")
    jobs = [planes[i:i + 3] for i in range(0, len(planes), 3)]
    shapes = [_check_rows("sum_rows", job) for job in jobs]
    dev = planes[0].device
    if any(t.device != dev for t in planes):
        raise ValueError("sum_rows: operands on different devices")
    out = tuple(torch.empty((8, ct), dtype=torch.int32, device=dev)
                for _, ct in shapes for _ in range(3))
    ptrs = []
    for j, job in enumerate(jobs):
        ptrs += [t.data_ptr() for t in job] + [t.data_ptr()
                                               for t in out[3 * j:3 * j + 3]]
    n = len(jobs)
    with kernels.on_device(out[0]) as stream:
        code = kernels.lib().zg_sum_rows(
            (ctypes.c_void_p * (6 * n))(*ptrs),
            (ctypes.c_long * n)(*(l for l, _ in shapes)),
            (ctypes.c_long * n)(*(ct for _, ct in shapes)), n, stream)
    kernels.launched("sum_rows", code)
    return out


@kernels.register("weighted_fold")
def weighted_fold_words(x, y, z, bx, by, bz):
    """Launch ``weighted_fold`` on int32 word planes: rows [K, 8, C], bias
    [8, C] (one bias point per lane); returns three [8, C] planes."""
    k, ct = _check_rows("weighted_fold", (x, y, z))
    for label, t in zip("xyz", (bx, by, bz)):
        kernels.check_planes(f"weighted_fold bias {label}", t, (8, ct))
        if t.device != x.device:
            raise ValueError("weighted_fold: operands on different devices")
    out = tuple(torch.empty((8, ct), dtype=torch.int32, device=x.device)
                for _ in range(3))
    with kernels.on_device(x) as stream:
        code = kernels.lib().zg_weighted_fold(
            x.data_ptr(), y.data_ptr(), z.data_ptr(),
            bx.data_ptr(), by.data_ptr(), bz.data_ptr(),
            *(t.data_ptr() for t in out), k, ct, stream)
    kernels.launched("weighted_fold", code)
    return out


def _rows_to_planes(comp):
    return kernels.to_word_planes(comp.reshape(comp.shape[0], -1, 16))


def sum_rows(xs):
    """Fold [L, G, W] jac rows into [G, W] with a left-to-right
    incomplete-add chain."""
    return sum_rows_many([xs])[0]


def sum_rows_many(folds):
    """:func:`sum_rows` of each of `folds` (one or two, jac rows
    [L_j, G_j, W_j]); on the card one launch folds them all."""
    if not folds[0][0].is_cuda:
        return [sum_rows_plain(xs) for xs in folds]
    out = sum_rows_words(*(_rows_to_planes(c) for xs in folds for c in xs))
    return [tuple(kernels.from_word_planes(o).reshape(xs[0].shape[1:3] + (16,))
                  for o in out[3 * j:3 * j + 3])
            for j, xs in enumerate(folds)]


def weighted(stacked, bias):
    """stacked jac [K, G, 2] rows (k = K-1 .. 0); returns
    bias + sum_k k*row_k as [G, 2]."""
    if not stacked[0].is_cuda:
        return weighted_plain(stacked, bias)
    _, g, two = stacked[0].shape[:3]
    bias_planes = tuple(
        kernels.to_word_planes(b.expand(g * two, 16)) for b in bias)
    out = weighted_fold_words(*(_rows_to_planes(c) for c in stacked),
                              *bias_planes)
    return tuple(kernels.from_word_planes(o).reshape(g, two, 16) for o in out)
