"""The port's int8-DFT NTT engine (zerog_tpu_torch/poly/pntt.py) against
zerog_tpu's, on the CPU, tolerance zero: exact integer arithmetic, and
canonical Montgomery forms are unique.

Piece by piece: host tables, the reference transform, and the plain versions
of the two kernels against the bodies of the Pallas kernels they replace.
Whole: transforms against zerog_tpu's butterflies (which tests/test_pntt.py
holds equal to zerog_tpu's engine) and the port's own, the NttPlan route and
the coset-extended domain. The comparisons against zerog_tpu's Pallas calls in
interpret mode and its whole engine are compile-bound on XLA:CPU (minutes
cold), so they run with ZEROG_SLOW_TESTS=1.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from zerog_tpu.field import FR as JFR, to_limbs as j_to_limbs
from zerog_tpu.field.pfield import _mul_body as j_mul_body
from zerog_tpu.poly import pntt as J
from zerog_tpu.poly.domain import Domain as JDomain
from zerog_tpu.poly.ntt import NttPlan as JNttPlan

from zerog_tpu_torch.field import FR, to_limbs, to_device
from zerog_tpu_torch.poly import pntt as T
from zerog_tpu_torch.poly.domain import Domain
from zerog_tpu_torch.poly.ntt import NttPlan

torch.set_num_threads(1)

SLOW = pytest.mark.skipif(not os.environ.get("ZEROG_SLOW_TESTS"),
                          reason="compile-bound on XLA:CPU; set ZEROG_SLOW_TESTS=1")


def _rand_vals(rng, shape):
    """Field elements (Python ints) spread over the whole range."""
    hi = rng.integers(0, 1 << 62, shape).astype(object)
    lo = rng.integers(0, 1 << 62, shape).astype(object)
    return (hi * (1 << 190) + lo * 12345678901) % JFR.p


def _mont_limbs(vals):
    """(port int64 tensor, zerog_tpu uint32 array) of the same limbs."""
    lj = j_to_limbs(vals, JFR, mont=True)
    return to_device(to_limbs(vals, FR, mont=True), "cpu"), jnp.asarray(lj)


def _words(limbs_u32):
    """uint32 limbs [..., 16] (numpy) -> int32 word planes [8, ...]."""
    w = T._limbs_to_words(torch.from_numpy(np.asarray(limbs_u32).astype(np.int64)))
    return torch.movedim(w, -1, 0).contiguous()


# ---- host tables ------------------------------------------------------------

@pytest.mark.parametrize("log_n", [8, 9, 14, 16, 17])
def test_factors(log_n):
    assert T._factors(log_n) == J._factors(log_n)


@pytest.mark.parametrize("t,scale", [(8, 1), (16, 5), (32, 1)])
def test_byte_matrix(t, scale):
    omega = FR.nth_root_of_unity(t.bit_length() - 1)
    assert np.array_equal(T._byte_matrix(t, omega, scale),
                          J._byte_matrix(t, omega, scale))


@pytest.mark.parametrize("log_n,inverse", [(9, False), (10, True)])
def test_plan_tables(log_n, inverse):
    """Programs, matrices (n^-1 folded into the outermost one) and twiddle
    tables of a plan equal zerog_tpu's."""
    omega = FR.nth_root_of_unity(log_n)
    args = ((log_n, FR.inv(omega), FR.inv(1 << log_n)) if inverse
            else (log_n, omega))
    tp, jp = T.PnttPlan(*args), J.PnttPlan(*args)
    assert tp._program == jp._program
    assert tp._mats.keys() == jp._mats.keys()
    for key in tp._mats:
        assert np.array_equal(tp._mats[key], jp._mats[key])
    prog = tp._program
    tw_args = (prog["log_m"], prog["omega"], prog["r"], prog["s"])
    assert np.array_equal(tp.twiddle_bytes(*tw_args), jp.twiddle_bytes(*tw_args))


def test_ntt_ref():
    log_n = 6
    rng = np.random.default_rng(0)
    vals = [int(v) for v in _rand_vals(rng, 1 << log_n)]
    omega = FR.nth_root_of_unity(log_n)
    got = T.PnttPlan(log_n, omega).ntt_ref(vals)
    assert [int(v) for v in got] == [
        int(v) for v in J.PnttPlan(log_n, omega).ntt_ref(vals)]
    # and against the port's butterflies (the residues are Montgomery limbs)
    bfly = NttPlan(log_n, device="cpu").ntt(to_device(to_limbs(vals), "cpu"))
    assert np.array_equal(bfly.numpy().astype(np.uint32),
                          to_limbs([int(v) for v in got]))


# ---- the two kernels' plain versions against the Pallas kernel bodies ----------

def _epilogue_inputs(t, g, seed):
    """Raw offset accumulator, colsum, rowc (port) and the corrected
    accumulator (zerog_tpu's kernel input), inside the real range: every
    corrected column in [0, 32 t 255^2], the extremes included."""
    rng = np.random.default_rng(seed)
    top = 32 * t * 255 * 255
    corr = rng.integers(0, top + 1, (32, t, g))
    corr[:, 0, 0] = top
    corr[:, 0, 1] = 0
    colsum = rng.integers(-128 * 32 * t, 127 * 32 * t + 1, g)
    rowc = rng.integers(-(1 << 26), 1 << 26, 32 * t)
    acc = corr - 128 * colsum[None, None, :] - rowc.reshape(32, t, 1)
    tw = j_to_limbs(_rand_vals(rng, (t, g)), JFR, mont=True)      # [t, g, 16]
    return (torch.from_numpy(acc.astype(np.int32)),
            torch.from_numpy(colsum.astype(np.int32)),
            torch.from_numpy(rowc.astype(np.int32)),
            corr.astype(np.int32), tw)


def _jax_epilogue_body(corr, tw16, with_twiddle, out_bytes):
    """zerog_tpu's epilogue kernel body, run eagerly on whole arrays."""
    out = {}
    J._epilogue_kernel_body(jnp.asarray(corr), jnp.asarray(tw16), out,
                            with_twiddle=with_twiddle, out_bytes=out_bytes)
    return np.stack([np.asarray(out[i]) for i in range(len(out))])


def _port_epilogue_as_jax(acc, colsum, rowc, tw, with_twiddle, out_bytes):
    got = T.epilogue(acc, colsum, rowc, _words(tw) if with_twiddle else None,
                     out_bytes)
    if out_bytes:
        return got.numpy()
    limbs = T._words_to_limbs(torch.movedim(got, 0, -1))         # [t, g, 16]
    return np.moveaxis(limbs.numpy(), -1, 0).astype(np.uint32)


@pytest.mark.parametrize("with_twiddle", [False, True])
@pytest.mark.parametrize("out_bytes", [True, False])
def test_epilogue_equals_kernel_body(with_twiddle, out_bytes):
    t, g = 8, 128
    acc, colsum, rowc, corr, tw = _epilogue_inputs(t, g, 11)
    tw16 = np.moveaxis(tw, -1, 0)                                 # [16, t, g]
    want = _jax_epilogue_body(corr, tw16, with_twiddle, out_bytes)
    got = _port_epilogue_as_jax(acc, colsum, rowc, tw, with_twiddle, out_bytes)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_epilogue_redc_truth():
    """One element against the Python-int REDC of its 286-bit value."""
    acc, colsum, rowc, corr, _ = _epilogue_inputs(8, 16, 3)
    words = T.epilogue(acc, colsum, rowc, None, out_bytes=False)
    for j, lane in ((0, 0), (0, 1), (5, 9)):
        v = sum(int(corr[b, j, lane]) << (8 * b) for b in range(32))
        got = sum((int(w) & 0xFFFFFFFF) << (32 * k)
                  for k, w in enumerate(words[:, j, lane]))
        assert got == T._redc(v) == J._redc(v)


def _twiddle_inputs(s, r, g, seed):
    rng = np.random.default_rng(seed)
    x = j_to_limbs(_rand_vals(rng, (s, r * g)), JFR, mont=True)  # [s, L, 16]
    twc = j_to_limbs(_rand_vals(rng, (s, r)), JFR, mont=True)     # [s, r, 16]
    xb = T._limbs_to_bytes(torch.from_numpy(x.astype(np.int64)))
    return xb, twc


def _jax_twiddle_body(xb, twc, g):
    """zerog_tpu's twiddle kernel body (bytes -> limbs, _mul_body, bytes)
    on whole arrays, the twiddle broadcast over the g lanes of each column."""
    x = jnp.asarray(xb.numpy())
    tw = jnp.asarray(np.repeat(np.moveaxis(twc, -1, 0), g, axis=2))  # [16, s, L]
    v16 = [(x[2 * j].astype(jnp.int32) + 128).astype(jnp.uint32)
           + ((x[2 * j + 1].astype(jnp.int32) + 128).astype(jnp.uint32) << 8)
           for j in range(16)]
    res = j_mul_body(v16, [tw[i] for i in range(16)],
                     (J._P_LIMBS, J._NPRIME_LIMBS, J._NEGP_LIMBS))
    out = []
    for j in range(16):
        out.append(((res[j] & 0xFF).astype(jnp.int32) - 128).astype(jnp.int8))
        out.append(((res[j] >> 8).astype(jnp.int32) - 128).astype(jnp.int8))
    return np.stack([np.asarray(o) for o in out])


def _jax_regroup(xb2, s, r, g):
    """zerog_tpu's regroup of the twiddled bytes for the outer transforms
    (``_run_device``'s transpose) and the column sums its ``_matmul_level``
    takes of that outer level's input."""
    xb3 = (jnp.asarray(xb2).reshape(32, s, r, g).transpose(0, 2, 1, 3)
           .reshape(32, r, s * g))
    colsum = jnp.sum(xb3.reshape(32 * r, s * g).astype(jnp.int32), axis=0)
    return np.asarray(xb3), np.asarray(colsum)


def test_twiddle_equals_kernel_body():
    """The port's one pass (twiddle, regroup, column sums) against
    zerog_tpu's twiddle kernel body followed by its regroup and sums."""
    s, r, g = 8, 16, 8
    xb, twc = _twiddle_inputs(s, r, g, 7)
    got, got_sum = T.twiddle(xb, _words(twc))
    want, want_sum = _jax_regroup(_jax_twiddle_body(xb, twc, g), s, r, g)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got_sum.numpy(), want_sum)


# ---- whole transforms --------------------------------------------------------

@pytest.mark.parametrize("log_n,b", [(9, 1), (10, 3)])
def test_transform_equals_butterflies(log_n, b):
    """Forward and inverse against the port's butterflies; at (10, 3) also
    against zerog_tpu's (each of its transforms is a ~5 s XLA:CPU compile,
    so one size carries that comparison)."""
    rng = np.random.default_rng(log_n)
    x, xj = _mont_limbs(_rand_vals(rng, (b, 1 << log_n)))
    tplan = NttPlan(log_n, device="cpu")
    fwd = T.pntt_transform(T.get_pntt_plan(log_n, tplan.omega), x)
    inv = T.pntt_transform(
        T.get_pntt_plan(log_n, tplan.omega_inv, tplan.n_inv), x)
    assert torch.equal(fwd, tplan._transform(x, tplan._fwd_tw))
    assert torch.equal(inv, tplan._intt_impl(x))
    if log_n == 10:
        jplan = JNttPlan(log_n)
        assert np.array_equal(fwd.numpy().astype(np.uint32),
                              np.asarray(jplan.ntt(xj)))
        assert np.array_equal(inv.numpy().astype(np.uint32),
                              np.asarray(jplan.intt(xj)))


def test_nttplan_routes_through_engine(monkeypatch):
    calls = []
    real = T.pntt_transform
    monkeypatch.setattr(NttPlan, "MXU_MIN_LOG_N", 9)
    monkeypatch.setattr("zerog_tpu_torch.poly.ntt.pntt_transform",
                        lambda plan, v: calls.append(plan.n_scale) or real(plan, v))
    rng = np.random.default_rng(5)
    plan = NttPlan(9, device="cpu")
    x, _ = _mont_limbs(_rand_vals(rng, (2, 1 << 9)))
    ev = plan.ntt(x)
    assert torch.equal(ev, plan._transform(x, plan._fwd_tw))
    assert torch.equal(plan.intt(ev), x)
    assert calls == [1, plan.n_inv]
    assert NttPlan(8, device="cpu")._use_mxu() is False


def test_domain_extended_via_engine(monkeypatch):
    """coeff_to_extended / extended_to_coeff at k = 9 (extended k = 10), both
    transforms on the engine, against zerog_tpu's butterfly domain."""
    monkeypatch.setattr(NttPlan, "MXU_MIN_LOG_N", 9)
    rng = np.random.default_rng(9)
    c, cj = _mont_limbs(_rand_vals(rng, (2, 1 << 9)))
    dom, jdom = Domain(9, 3, device="cpu"), JDomain(9, 3)
    ext = dom.coeff_to_extended(c)
    assert np.array_equal(ext.numpy().astype(np.uint32),
                          np.asarray(jdom.coeff_to_extended(cj)))
    back = dom.extended_to_coeff(ext)
    assert np.array_equal(back.numpy().astype(np.uint32),
                          np.asarray(jdom.extended_to_coeff(jnp.asarray(
                              ext.numpy().astype(np.uint32)))))
    assert torch.equal(back[:, : 1 << 9], c)


# ---- against zerog_tpu's Pallas calls and engine (ZEROG_SLOW_TESTS=1) ------------

@SLOW
@pytest.mark.parametrize("with_twiddle", [False, True])
@pytest.mark.parametrize("out_bytes", [True, False])
def test_epilogue_equals_interpret_kernel(with_twiddle, out_bytes):
    t, g = 8, 128
    acc, colsum, rowc, corr, tw = _epilogue_inputs(t, g, 11)
    tw16 = jnp.asarray(np.moveaxis(tw, -1, 0))
    call = jax.jit(J._epilogue_call(t, g, with_twiddle, out_bytes, True))
    want = np.asarray(call(jnp.asarray(corr), tw16) if with_twiddle
                      else call(jnp.asarray(corr)))
    got = _port_epilogue_as_jax(acc, colsum, rowc, tw, with_twiddle, out_bytes)
    assert np.array_equal(got, want)


@SLOW
def test_twiddle_equals_interpret_kernel():
    s, r, g = 8, 16, 8
    xb, twc = _twiddle_inputs(s, r, g, 7)
    tw = jnp.asarray(np.repeat(np.moveaxis(twc, -1, 0), g, axis=2))
    want, want_sum = _jax_regroup(jax.jit(J._twiddle_call(s, r * g, True))(
        jnp.asarray(xb.numpy()), tw), s, r, g)
    got, got_sum = T.twiddle(xb, _words(twc))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got_sum.numpy(), want_sum)


@SLOW
@pytest.mark.parametrize("log_n,b", [(9, 1), (10, 3)])
@pytest.mark.parametrize("inverse", [False, True])
def test_transform_equals_jax_engine(log_n, b, inverse):
    rng = np.random.default_rng(log_n)
    x, xj = _mont_limbs(_rand_vals(rng, (b, 1 << log_n)))
    if b == 1:
        x, xj = x[0], xj[0]
    omega = FR.nth_root_of_unity(log_n)
    args = ((log_n, FR.inv(omega), FR.inv(1 << log_n)) if inverse
            else (log_n, omega))
    got = T.pntt_transform(T.get_pntt_plan(*args), x)
    want = np.asarray(J.pntt_transform(J.get_pntt_plan(*args), xj))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
