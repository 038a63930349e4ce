"""The port's field layer (zerog_tpu_torch.field) against zerog_tpu.field and
against Python ints.

The same inputs, made with a seeded generator, go through the JAX functions
and their PyTorch counterparts on the CPU. Everything is exact integer
arithmetic, so every comparison is limb for limb with tolerance zero.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zerog_tpu.field import jfq as j_jfq, jfr as j_jfr
from zerog_tpu.field import to_limbs as j_to_limbs

from zerog_tpu_torch.field import (
    FQ, FR, from_limbs, jfq, jfr, shift_fill, to_device, to_limbs, to_numpy,
)
from zerog_tpu_torch.field import pfield

torch.set_num_threads(1)

N = 256


def _values(p, seed):
    rnd = random.Random(seed)
    return [0, 1, p - 1, 2, p - 2, (1 << 253) % p] + [
        rnd.randrange(p) for _ in range(N - 6)]


def _same(jax_arr, tensor):
    assert np.array_equal(np.asarray(jax_arr).astype(np.uint32),
                          to_numpy(tensor))


FIELDS = [("Fr", FR, jfr, j_jfr), ("Fq", FQ, jfq, j_jfq)]


@pytest.mark.parametrize("name,params,tf,jf", FIELDS, ids=["Fr", "Fq"])
def test_limb_codec_roundtrip_and_matches_reference(name, params, tf, jf):
    vals = _values(params.p, 1)
    for mont in (False, True):
        ours = to_limbs(vals, params, mont=mont)
        assert ours.dtype == np.uint32 and ours.shape == (N, 16)
        assert np.array_equal(ours, j_to_limbs(vals, params, mont=mont))
        assert list(from_limbs(ours, params, mont=mont)) == vals
        assert list(from_limbs(to_device(ours, "cpu"), params, mont=mont)) == vals
    assert from_limbs(to_limbs(vals[7])) == vals[7]


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
@pytest.mark.parametrize("name,params,tf,jf", FIELDS, ids=["Fr", "Fq"])
def test_binary_ops_match_reference_and_ints(name, params, tf, jf, op):
    p = params.p
    a, b = _values(p, 2), _values(p, 3)[::-1]
    la, lb = to_limbs(a), to_limbs(b)
    got = getattr(tf(), op)(to_device(la, "cpu"), to_device(lb, "cpu"))
    _same(getattr(jf(), op)(jnp.asarray(la), jnp.asarray(lb)), got)
    rinv = pow(params.r_mont, -1, p)
    truth = {"mul": lambda x, y: x * y * rinv % p,
             "add": lambda x, y: (x + y) % p,
             "sub": lambda x, y: (x - y) % p}[op]
    assert list(from_limbs(got)) == [truth(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("name,params,tf,jf", FIELDS, ids=["Fr", "Fq"])
def test_unary_and_reductions_match_reference(name, params, tf, jf):
    p = params.p
    a = _values(p, 4)
    la = to_limbs(a, params, mont=True)
    t, j = to_device(la, "cpu"), jnp.asarray(la)
    f, g = tf(), jf()
    _same(g.neg(j), f.neg(t))
    _same(g.square(j), f.square(t))
    _same(g.to_mont(j), f.to_mont(t))
    _same(g.from_mont(j), f.from_mont(t))
    _same(g.pow_const(j, 5), f.pow_const(t, 5))
    _same(g.sum(j.reshape(8, N // 8, 16), axis=1),
          f.sum(t.reshape(8, N // 8, 16), axis=1))
    _same(g.const(12345), f.const(12345, device="cpu"))
    assert list(from_limbs(f.from_mont(t))) == a
    assert list(from_limbs(f.pow_const(t, 3), params, mont=True)) == [
        pow(x, 3, p) for x in a]
    assert from_limbs(f.sum(t, axis=0), params, mont=True) == sum(a) % p
    cond = torch.arange(N) % 3 == 0
    sel = f.select(cond, t, f.neg(t))
    assert list(from_limbs(sel, params, mont=True)) == [
        x if i % 3 == 0 else (-x) % p for i, x in enumerate(a)]
    assert f.is_zero(t).tolist() == [x == 0 for x in a]
    assert f.eq(t, torch.flip(t, dims=(0,))).tolist() == [
        x == y for x, y in zip(a, a[::-1])]


def test_shift_fill_matches_reference():
    from zerog_tpu.field import shift_fill as j_shift_fill

    x = np.arange(5 * 16, dtype=np.uint32).reshape(5, 16)
    one = j_to_limbs(FR.r_mont)
    for shift, back in ((1, False), (2, True), (4, False)):
        _same(j_shift_fill(jnp.asarray(x), shift, fill=jnp.asarray(one),
                           backward=back),
              shift_fill(to_device(x, "cpu"), shift,
                         fill=to_device(one, "cpu"), backward=back))
    _same(j_shift_fill(jnp.asarray(x), 1, fill=7),
          shift_fill(to_device(x, "cpu"), 1, fill=7))


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_binop_plain_matches_jfq(op):
    """Kernel 1's plain version, through the plane layout of PField."""
    a, b = _values(FQ.p, 5), _values(FQ.p, 6)[::-1]
    la, lb = to_limbs(a), to_limbs(b)
    ref = getattr(j_jfq(), op)(jnp.asarray(la), jnp.asarray(lb))
    _same(ref, pfield.field_binop_plain(op, FQ, to_device(la, "cpu"),
                                        to_device(lb, "cpu")))
    pa = pfield.to_planes(to_device(la, "cpu"))
    pb = pfield.to_planes(to_device(lb, "cpu"))
    assert pa.shape == (16, N // 128, 128)
    out = getattr(pfield.pfq(), op)(pa, pb)
    _same(ref, pfield.from_planes(out))
    assert pfield.field_binop_words.launches == 0
