"""JField's kernel path, ``field_limbs`` (``csrc/field_limbs.cu``), on the CPU.

The source built with the host compiler runs the card's three steps a warp
(gather of whole elements by 8 lanes each into a swizzled buffer, the field
body a thread, scatter) one lane after another, so its addressing, swizzle
and ragged tail are tested here; the card's PTX field bodies are checked by
``chip_smoke.py``. Each case goes through :func:`jfield.limbs_operands`, the
wrapper's own planning and copies, and is held limb for limb against
JField's plain torch bodies (``add_plain``, ``sub_plain``, ``mul_plain``,
the CPU path) and against Python ints. Exact arithmetic, tolerance zero.

Build by hand (what the fixture does):

    g++ -x c++ -std=c++17 -O2 -shared -fPIC \\
        zerog_tpu_torch/csrc/field_limbs.cu -o /tmp/libfield_limbs.so
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zerog_tpu_torch import kernels, trace
from zerog_tpu_torch.field import FQ, FR, jfield, jfq, jfr

torch.set_num_threads(1)

OPS = ("mul", "add", "sub")
SIZES = (1, 7, 130, 4099)
MODES = ("same", "one", "suffix", "outer", "copied")
ROWS = 3            # the leading dimension of the suffix and outer cases


@pytest.fixture(scope="module")
def host_fn(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler (g++) here: field_limbs.cu cannot be built "
                    "for the host")
    out = tmp_path_factory.mktemp("field_limbs") / "libfield_limbs.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    os.path.join(kernels.CSRC_DIR, "field_limbs.cu"), "-o", str(out)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).zg_field_limbs
    fn.argtypes = kernels._SIGNATURES["zg_field_limbs"]
    fn.restype = ctypes.c_int
    return fn


def _limbs(vals, shape):
    """Python ints -> int64 limbs [*shape, 16]."""
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    arr = np.frombuffer(raw, dtype="<u2").astype(np.int64)
    return torch.from_numpy(arr).reshape(tuple(shape) + (16,))


def _ints(limbs):
    """int64 limbs [..., 16] -> flat list of Python ints."""
    raw = limbs.reshape(-1, 16).numpy().astype("<u2").tobytes()
    return [int.from_bytes(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]


def _values(params, n, rng, shift):
    """n values mod p: 0, 1, p - 1, R mod p and R^2 mod p first (rotated by
    `shift`), then random ones."""
    p = params.p
    edge = [0, 1, p - 1, params.r_mont % p, params.r_mont ** 2 % p]
    edge = edge[shift:] + edge[:shift]
    raw = rng.bytes(32 * n)
    return [edge[i] if i < len(edge) else int.from_bytes(raw[32 * i:32 * i + 32],
                                                         "little") % p
            for i in range(n)]


def _case(params, mode, n, rng):
    """(a, b) limb tensors of one addressing mode with n elements a row."""
    if mode == "same":
        return (_limbs(_values(params, n, rng, 0), (n,)),
                _limbs(_values(params, n, rng, 2), (n,)))
    if mode == "one":
        return (_limbs(_values(params, n, rng, 0), (n,)),
                _limbs([params.r_mont ** 2 % params.p], ()))
    if mode == "suffix":      # [C, n] against [n]: a coset's powers
        return (_limbs(_values(params, ROWS * n, rng, 1), (ROWS, n)),
                _limbs(_values(params, n, rng, 3), (n,)))
    if mode == "outer":       # [C, 1] against [1, n]: beta delta^j w^i
        return (_limbs(_values(params, ROWS, rng, 4), (ROWS,))[:, None],
                _limbs(_values(params, n, rng, 0), (n,))[None])
    # limbs not contiguous (the word-plane layout [16, n] moved to the end),
    # copied by the wrapper, against every other element of a longer tensor
    # (read in place, 32 words apart)
    a = _limbs(_values(params, n, rng, 2), (n,)).t().contiguous()
    b = _limbs(_values(params, 2 * n, rng, 1), (2 * n,))[::2]
    return torch.movedim(a, 0, -1), b


def _truth(params, op, a, b):
    p = params.p
    rinv = pow(params.r_mont, -1, p)
    fn = {"mul": lambda x, y: x * y * rinv % p, "add": lambda x, y: (x + y) % p,
          "sub": lambda x, y: (x - y) % p}[op]
    xa, xb = torch.broadcast_tensors(a[..., 0], b[..., 0])
    ia = _ints(a.expand(xa.shape + (16,)))
    ib = _ints(b.expand(xb.shape + (16,)))
    return [fn(x, y) for x, y in zip(ia, ib)]


def _host(fn, params, op, a, b):
    out_shape, rows, cols, a, (sra, sca), b, (srb, scb) = jfield.limbs_operands(a, b)
    out = torch.full(out_shape + (16,), -1, dtype=torch.int64)
    code = fn(a.data_ptr(), sra, sca, b.data_ptr(), srb, scb, out.data_ptr(),
              rows, cols, 0 if params is FQ else 1, OPS.index(op), None)
    assert code == 0
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("params", [FQ, FR], ids=["fq", "fr"])
def test_host_build_matches_plain_body_and_ints(host_fn, params, op, mode, n):
    f = jfq() if params is FQ else jfr()
    rng = np.random.default_rng([n, MODES.index(mode), OPS.index(op)])
    a, b = _case(params, mode, n, rng)
    got = _host(host_fn, params, op, a, b)
    ref = getattr(f, op + "_plain")(a, b)
    assert got.shape == ref.shape
    assert torch.equal(got, ref)
    assert _ints(got) == _truth(params, op, a, b)
    assert int(got.min()) >= 0 and int(got.max()) < 1 << 16


def test_host_build_refuses_bad_arguments(host_fn):
    z = torch.zeros(16, dtype=torch.int64)
    args = (z.data_ptr(), 0, 0, z.data_ptr(), 0, 0, z.data_ptr(), 1, 1)
    assert host_fn(*args, 2, 0, None) == -1
    assert host_fn(*args, 0, 3, None) == -1
    assert host_fn(z.data_ptr(), 0, 0, z.data_ptr(), 0, 0, z.data_ptr(), 0, 5,
                   0, 0, None) == 0


def _meta(*shape):
    return torch.empty(shape + (16,), dtype=torch.int64, device="meta")


def _plan(a, b):
    return jfield.plan_strides(a.shape[:-1], a.stride()[:-1], b.shape[:-1],
                               b.stride()[:-1])


N_EXT, N, U = 1 << 20, 1 << 17, 131066     # extended and base rows; usable rows


@pytest.mark.parametrize("case", [
    "quotient_h_y", "quotient_same", "coset_powers", "permutation_outer",
    "permutation_beta", "eval_denoms", "eval_weights", "eval_halves", "sum_halves",
    "vanishing_period", "scalar_by_scalar"])
def test_planner_addresses_the_programs_shapes_without_copies(case):
    """The shapes the prover gives JField, as [rows, cols] with each
    operand's element strides (int64 words): none needs a copy."""
    h, y = _meta(N_EXT), _meta()
    stack = _meta(14, N_EXT)
    acc = _meta(8, N)
    want = {
        # h * y, then + t (plonk/prover.py _eval_quotient)
        "quotient_h_y": ((h, y), ((N_EXT,), 1, N_EXT, (0, 16), (0, 0))),
        "quotient_same": ((h, h), ((N_EXT,), 1, N_EXT, (0, 16), (0, 16))),
        # [14, 2^20] coefficients times the coset's powers [2^20]
        # (Domain.coeff_to_extended)
        "coset_powers": ((stack, _meta(N_EXT)),
                         ((14, N_EXT), 14, N_EXT, (16 * N_EXT, 16), (0, 16))),
        # beta_deltas[:, None] * omega_pows[None] (plonk/permutation.py)
        "permutation_outer": ((_meta(4)[:, None], _meta(U)[None]),
                              ((4, U), 4, U, (16, 0), (0, 16))),
        # beta[None, None] * sigmas [4, u]: both merge into one row
        "permutation_beta": ((_meta()[None, None], _meta(4, U)),
                             ((4, U), 1, 4 * U, (0, 0), (0, 16))),
        # zs[:, None] - ws[None] (poly/eval.py domain_inverses)
        "eval_denoms": ((_meta(3)[:, None, :], _meta(N)[None, :, :]),
                        ((3, N), 3, N, (16, 0), (0, 16))),
        # stack * weights[None] (poly/eval.py _bary_weighted_sum)
        "eval_weights": ((acc, _meta(N)[None]),
                         ((8, N), 8, N, (16 * N, 16), (0, 16))),
        # acc[:, :half] + acc[:, half:] of the log-tree sum
        "eval_halves": ((acc[:, : N // 2], acc[:, N // 2:]),
                        ((8, N // 2), 8, N // 2, (16 * N, 16), (16 * N, 16))),
        # JField.sum's pairwise halves
        "sum_halves": ((stack[:7], stack[7:14]),
                       ((7, N_EXT), 1, 7 * N_EXT, (0, 16), (0, 16))),
        # evals * t_inv repeated (Domain.divide_by_vanishing_poly)
        "vanishing_period": ((h, _meta(8).repeat(N_EXT // 8, 1)),
                             ((N_EXT,), 1, N_EXT, (0, 16), (0, 16))),
        "scalar_by_scalar": ((y, y), ((), 1, 1, (0, 0), (0, 0))),
    }
    (a, b), expect = want[case]
    assert _plan(a, b) == expect


def test_planner_merges_and_refuses():
    # [2, 3, 5] contiguous against [3, 1]: three dimensions stay
    assert _plan(_meta(2, 3, 5), _meta(3, 1)) is None
    # [2, 3, 5] against [5]: six rows of 5
    assert _plan(_meta(2, 3, 5), _meta(5)) == ((2, 3, 5), 6, 5, (80, 16), (0, 16))
    # size-1 dimensions vanish; a broadcast against a broadcast is one element
    assert _plan(_meta(1, 1), _meta(1)) == ((1, 1), 1, 1, (0, 0), (0, 0))
    with pytest.raises(RuntimeError):
        _plan(_meta(3), _meta(4))


def _traced(fn):
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    counters = trace.summary()["counters"]
    trace.reset()
    return out, counters


def test_operands_copy_only_what_the_strides_cannot_address():
    x = torch.zeros((3, 5, 16), dtype=torch.int64)
    # in place: suffix broadcast, rows of a slice
    (_, rows, cols, a, _, b, _), counts = _traced(
        lambda: jfield.limbs_operands(x[:, 1:], x[0, 1:]))
    assert (rows, cols) == (3, 4) and a.data_ptr() == x[:, 1:].data_ptr()
    assert b.data_ptr() == x[0, 1:].data_ptr()
    assert counts.get("field_kernel_copies", 0) == 0
    # limbs not contiguous: that operand is copied, once
    moved = torch.movedim(x[0].t().contiguous(), 0, -1)
    (_, _, _, a, _, b, _), counts = _traced(lambda: jfield.limbs_operands(moved, x[0]))
    assert a.is_contiguous() and b.data_ptr() == x[0].data_ptr()
    assert counts["field_kernel_copies"] == 1
    # three dimensions left: the broadcast operand is copied at the result's shape
    y = torch.zeros((2, 3, 5, 16), dtype=torch.int64)
    (shape, rows, cols, a, sa, b, sb), counts = _traced(
        lambda: jfield.limbs_operands(y, x[:, :1]))
    assert shape == (2, 3, 5) and (rows, cols) == (1, 30)
    assert a.data_ptr() == y.data_ptr() and tuple(b.shape) == (2, 3, 5, 16)
    assert sa == sb == (0, 16)
    assert counts["field_kernel_copies"] == 1
    # an operand the kernel cannot read is copied once, at the result's shape
    odd = torch.zeros(5 * 16 + 1, dtype=torch.int64)[1:].reshape(5, 16)
    (shape, rows, cols, a, sa, b, sb), counts = _traced(
        lambda: jfield.limbs_operands(x, odd[None, 0]))
    assert shape == (3, 5) and (rows, cols) == (1, 15)
    assert a.data_ptr() == x.data_ptr() and tuple(b.shape) == (3, 5, 16)
    assert b.is_contiguous() and sa == sb == (0, 16)
    assert counts["field_kernel_copies"] == 1
    with pytest.raises(ValueError, match="int64 limb tensor"):
        jfield.limbs_operands(x.to(torch.int32), x)
    with pytest.raises(ValueError, match="int64 limb tensor"):
        jfield.limbs_operands(x[..., :8], x)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((4, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        jfield.field_limbs(FR, "mul", x, x)


def test_cpu_ops_take_the_plain_bodies_and_launch_nothing():
    """A JField op on CPU tensors is its plain body: no launch, no build,
    ``field_ops`` counted and ``field_kernel`` not."""
    f = jfr()
    rng = np.random.default_rng(3)
    a = _limbs(_values(FR, 9, rng, 0), (9,))
    b = _limbs(_values(FR, 9, rng, 1), (9,))
    kernels.reset_launch_counts()
    outs, counts = _traced(lambda: [f.mul(a, b), f.add(a, b), f.sub(a, b),
                                    f.square(a), f.neg(b)])
    assert kernels.launch_counts()["field_limbs"] == 0
    assert counts["field_ops"] == 7 and "field_kernel" not in counts
    plain = [f.mul_plain(a, b), f.add_plain(a, b), f.sub_plain(a, b),
             f.mul_plain(a, a), f.sub_plain(torch.zeros_like(b), b)]
    assert all(torch.equal(x, y) for x, y in zip(outs, plain))


def test_plain_field_binds_the_plain_bodies_and_restores_the_ops():
    """``bench.plain_field``, the context of every plain version that
    ``chip_smoke.py`` holds a kernel against: inside it JField's add, sub and
    mul are the plain bodies on any device (no ``field_ops`` counted); after
    it, the ops they were."""
    from zerog_tpu_torch.bench import plain_field

    f = jfq()
    rng = np.random.default_rng(4)
    a = _limbs(_values(FQ, 7, rng, 0), (7,))
    b = _limbs(_values(FQ, 7, rng, 1), (7,))
    ops = {op: jfield.JField.__dict__[op] for op in ("add", "sub", "mul")}
    with plain_field():
        for op in ops:
            assert jfield.JField.__dict__[op] is jfield.JField.__dict__[op + "_plain"]
        outs, counts = _traced(lambda: [f.mul(a, b), f.square(a), f.neg(b)])
    assert counts.get("field_ops", 0) == 2        # square and neg themselves
    assert {op: jfield.JField.__dict__[op] for op in ops} == ops
    plain = [f.mul_plain(a, b), f.mul_plain(a, a),
             f.sub_plain(torch.zeros_like(b), b)]
    assert all(torch.equal(x, y) for x, y in zip(outs, plain))
    with pytest.raises(RuntimeError, match="inside"):
        with plain_field():
            raise RuntimeError("inside")
    assert {op: jfield.JField.__dict__[op] for op in ops} == ops
