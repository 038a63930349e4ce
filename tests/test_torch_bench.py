"""The plain versions of the port's measuring kernels (kernel 8
``field_chain``, kernel 9 ``scan_bisect``) against zerog_tpu, on the CPU,
tolerance zero.

``field_chain_plain`` is held against the two chains of
``scripts/bench_pallas_field.py``: ``jfr().mul`` applied 16 times (the
script's XLA chain) and ``pfield._mul_body`` applied 16 times (the body of
its ``fused16`` kernel). The bisection bodies of
``scripts/bench_pscan_bisect.py`` are held body by body: ``trivial`` against
the TPU body's limb-wise running sum through the word relation of
:mod:`zerog_tpu_torch.bench.scan_bisect`, the ``mul`` bodies against
``_mul_body`` looped over the rows, ``madd`` against
``pscan._madd_incomplete``. Inputs are canonical values made with numpy from
seeds (the benchmarks' own makers); the limb lists of the JAX bodies are
[rows, 128] arrays, as inside a Pallas block.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zerog_tpu.curve.pscan import _madd_incomplete
from zerog_tpu.field import jfr as j_jfr
from zerog_tpu.field.pfield import _mul_body, pfq as j_pfq, pfr as j_pfr

from zerog_tpu_torch import kernels
from zerog_tpu_torch.bench import field_chain as fc
from zerog_tpu_torch.bench import scan_bisect as sb
from zerog_tpu_torch.field import FR, from_limbs

torch.set_num_threads(1)

LANES = 128
# field_chain's bound at n = 2^18, k = 16: 2^18 x 16 x IMAD_SLOTS_PER_MUL
# slots at 16.75e12 a second
WORKED_CHAIN_BOUND_MS = 0.064104


def _body_params(pf):
    return (pf.p_limbs, pf.nprime, pf.negp)


def _limb_list(limbs):
    """int64 limbs [n, 16] -> 16 uint32 arrays [n / 128, 128] (a Pallas
    block's limb planes)."""
    arr = limbs.numpy().astype(np.uint32)
    return [jnp.asarray(arr[:, i].reshape(-1, LANES)) for i in range(16)]


def _from_limb_list(planes):
    """16 arrays [m, 128] -> int64 limbs [m * 128, 16]."""
    return torch.from_numpy(np.stack([np.asarray(p).reshape(-1) for p in planes],
                                     axis=-1).astype(np.int64))


@pytest.fixture(scope="module")
def chain_inputs():
    a, b = fc.make_inputs(FR, 1024)
    return kernels.from_word_planes(a), kernels.from_word_planes(b)


def test_field_chain_inputs_are_canonical_with_edge_values(chain_inputs):
    a, b = chain_inputs
    for x in (a, b):
        vals = list(from_limbs(x))
        assert all(0 <= v < FR.p for v in vals)
        assert {0, 1, FR.p - 1} <= set(vals[:fc.HEAD])
    assert list(from_limbs(b[:fc.HEAD])) == list(from_limbs(a[:fc.HEAD]))[::-1]


def test_field_chain_plain_matches_the_scripts_xla_chain(chain_inputs):
    a, b = chain_inputs
    got = fc.field_chain_plain(FR, a, b)
    x, y = (jnp.asarray(t.numpy().astype(np.uint32)) for t in (a, b))
    mul = jax.jit(j_jfr().mul)          # the script jits its chain
    for _ in range(fc.DEFAULT_K):
        x = mul(x, y)
    assert np.array_equal(np.asarray(x).astype(np.int64), got.numpy())


def test_field_chain_plain_matches_the_fused16_body(chain_inputs):
    a, b = chain_inputs
    got = fc.field_chain_plain(FR, a, b)
    x, y = _limb_list(a), _limb_list(b)
    for _ in range(fc.DEFAULT_K):
        x = _mul_body(x, y, _body_params(j_pfr()))
    assert torch.equal(_from_limb_list(x), got)


def test_field_chain_check_holds_against_python_ints(chain_inputs):
    a, b = chain_inputs
    plain = fc.field_chain_plain(FR, a, b)
    words = kernels.to_word_planes(plain)
    assert fc.check(FR, 10, (words, words, plain)) == 0
    bad = plain.clone()
    bad[3, 0] ^= 1                      # a head element (p - 2 against 2)
    with pytest.raises(AssertionError, match="Python-int truth"):
        fc.check(FR, 10, (kernels.to_word_planes(bad), kernels.to_word_planes(bad),
                          bad))


def _bisect_inputs(rows, cols, seed, flag_rate=sb.FLAG_RATE):
    sx, sy, _ = sb.make_inputs(rows, cols, seed)
    flags = np.random.default_rng(seed + 1).random((rows, cols)) < flag_rate
    return (kernels.from_word_planes(sx), kernels.from_word_planes(sy),
            torch.from_numpy(flags))


def test_trivial_is_the_tpu_limb_sum_in_words():
    """word w = (S_{2w} + (S_{2w+1} << 16)) mod 2^32, S_i the TPU body's
    running sum of limb i (uint32 lanes, no carry between limbs)."""
    sx, sy, flags = _bisect_inputs(1024, 16, seed=3)
    s = np.cumsum(sx.numpy().astype(np.uint32), axis=0, dtype=np.uint32)
    words = (s[..., 0::2].astype(np.uint64) + (s[..., 1::2].astype(np.uint64) << 16)) \
        % (1 << 32)
    got = sb.scan_bisect_plain("trivial", sx, sy, flags)
    got_words = got[..., 0::2] | (got[..., 1::2] << 16)
    assert np.array_equal(got_words.numpy().astype(np.uint64), words)
    assert torch.equal(sb.scan_bisect("trivial", sx, sy, flags), got)


def test_mul_bodies_match_the_mul_body_looped_over_rows():
    sx, sy, flags = _bisect_inputs(8, LANES, seed=4)
    got = sb.scan_bisect_plain("mul_reg", sx, sy, flags)
    assert torch.equal(sb.scan_bisect("mul_smem", sx, sy, flags), got)
    carry = _limb_list(sx[0])
    for r in range(sx.shape[0]):
        carry = _mul_body(carry, _limb_list(sx[r]), _body_params(j_pfq()))
        assert torch.equal(_from_limb_list(carry), got[r]), r


def test_madd_matches_the_pscan_madd_looped_over_rows():
    sx, sy, flags = _bisect_inputs(4, LANES, seed=5, flag_rate=0.3)
    assert 0.2 < float(flags.float().mean()) < 0.4
    assert bool((flags.sum(dim=0) >= 2).any())       # some column adds two points
    got = sb.scan_bisect_plain("madd", sx, sy, flags)
    assert torch.equal(sb.scan_bisect("madd", sx, sy, flags), got)
    px, py = _limb_list(sx[0]), _limb_list(sy[0])
    pz = [jnp.zeros_like(v) for v in px]
    for r in range(sx.shape[0]):
        qv = jnp.asarray(flags[r].numpy().reshape(-1, LANES))
        px, py, pz = _madd_incomplete(px, py, pz, _limb_list(sx[r]),
                                      _limb_list(sy[r]), qv)
        assert torch.equal(_from_limb_list(px), got[r]), r


def test_operation_bounds_count_a_product_as_its_imad_slots():
    """The operation bounds of ``field_chain`` and of the bisection count a
    Montgomery product as IMAD_SLOTS_PER_MUL issue slots (read from the
    product's SASS) at PEAK_INT32_MAD_PER_S: n = 2^18, k = 16 is n k slots /
    peak, operations over 96 bytes an element."""
    from zerog_tpu_torch.bench import IMAD_SLOTS_PER_MUL, PEAK_INT32_MAD_PER_S, bound

    n, k = 1 << 18, 16
    ms, by = fc.chain_bound(n, k)
    assert by == "operations"
    assert ms == pytest.approx(n * k * IMAD_SLOTS_PER_MUL / PEAK_INT32_MAD_PER_S * 1e3)
    assert ms == pytest.approx(WORKED_CHAIN_BOUND_MS, rel=1e-4)
    assert fc.chain_bound(n, 1)[0] == pytest.approx(3 * 32 * n / 3.35e12 * 1e3)
    rows, cols = sb.ROWS, sb.COLS
    # every row added: 11 products a row of madd, operations
    ms, by = sb.bisect_bound("madd", rows, cols)
    assert by == "operations"
    assert ms == pytest.approx(rows * cols * 11 * IMAD_SLOTS_PER_MUL
                               / PEAK_INT32_MAD_PER_S * 1e3)
    # by the valid rows: an add for each after its column's first
    flags = torch.zeros((rows, cols), dtype=torch.uint8)
    flags[::4] = 1
    _, adds, _ = sb.madd_counts(flags)
    assert adds == (rows // 4 - 1) * cols
    ms, by = sb.bisect_bound("madd", rows, cols, flags)
    assert ms == pytest.approx(max(bound(33 * rows * cols + 64 * (rows // 4) * cols
                                         + 32 * cols, 0)[0],
                                   adds * 11 * IMAD_SLOTS_PER_MUL
                                   / PEAK_INT32_MAD_PER_S * 1e3))
    # one product a row: bytes bound the mul bodies, the slots beside them
    for body in ("mul_smem", "mul_reg"):
        ms, by = sb.bisect_bound(body, rows, cols)
        assert by == "bytes"
        assert ms == pytest.approx(64 * rows * cols / 3.35e12 * 1e3)
        assert ms > rows * cols * IMAD_SLOTS_PER_MUL / PEAK_INT32_MAD_PER_S * 1e3
