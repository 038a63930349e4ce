"""The port's WNN frontend (models, ops/limbmath, gadgets, MockProver)
against zerog_tpu's, on the CPU, tolerance zero.

Models are made from seeds by both packages' ``make_synthetic_wnn`` (the
MNIST-Tiny shape and the MNIST-Large shape) or carried over with
``convert.wnn_from_reference`` (the toy worked example of the reference,
src/gadgets/wnn.rs:409-488, rebuilt here). Circuits synthesized by both
packages are compared column for column. The whole toy proof at k = 12 —
byte-identical proofs, each verifier accepting the other's — is minutes of
CPU time in each package, so it runs with ZEROG_SLOW_TESTS=1.
"""

import os
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from zerog_tpu.gadgets import WnnCircuit as JWnnCircuit
from zerog_tpu.gadgets import WnnCircuitParams as JParams
from zerog_tpu.models.synthetic import make_synthetic_wnn as j_make
from zerog_tpu.models.synthetic import MNIST_LARGE_SHAPE as J_LARGE
from zerog_tpu.models.wnn import Wnn as JWnn
from zerog_tpu.ops import limbmath as jlm
from zerog_tpu.plonk import MockProver as JMockProver
from zerog_tpu.plonk.assignment import Assignment as JAssignment
from zerog_tpu.plonk.cs import ConstraintSystem as JCS
from zerog_tpu.plonk.pinned import pinned_text as j_pinned_text

from zerog_tpu_torch import convert
from zerog_tpu_torch.models import MNIST_LARGE_SHAPE, make_synthetic_wnn
from zerog_tpu_torch.ops import limbmath as lm
from zerog_tpu_torch.plonk import Assignment, ConstraintSystem, MockProver
from zerog_tpu_torch.plonk.pinned import pinned_text

torch.set_num_threads(1)

TINY_SHAPE = (28, 256, 1, 1)      # model_28input_256entry_1hash_1bpi, k = 14
SHAPES = {"tiny": TINY_SHAPE, "large": MNIST_LARGE_SHAPE}


def _images(seed, count):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (28, 28)).astype(np.uint8) for _ in range(count)]


def _fields(w):
    return (w.num_classes, w.num_filter_inputs, w.num_filter_entries,
            w.num_filter_hashes, w.p, w.bloom_filters, w.input_permutation,
            w.binarization_thresholds)


# ---- models -------------------------------------------------------------------

def test_large_shape_constant():
    assert MNIST_LARGE_SHAPE == J_LARGE


@pytest.mark.parametrize("shape", ["tiny", "large"])
@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_models_equal(shape, seed):
    tm = make_synthetic_wnn(*SHAPES[shape], seed=seed)
    jm = j_make(*SHAPES[shape], seed=seed)
    assert (tm.num_classes, tm.num_filter_inputs, tm.num_filter_entries,
            tm.num_filter_hashes, tm.p, tm.l) == (
        jm.num_classes, jm.num_filter_inputs, jm.num_filter_entries,
        jm.num_filter_hashes, jm.p, jm.l)
    assert np.array_equal(tm.bloom_filters, jm.bloom_filters)
    assert np.array_equal(tm.input_permutation, jm.input_permutation)
    assert np.array_equal(tm.binarization_thresholds, jm.binarization_thresholds)


def test_tiny_shape_circuit_parameters():
    tm = make_synthetic_wnn(*TINY_SHAPE, seed=0)
    assert (tm.l, tm.p, tm.bloom_filters.shape) == (8, 509, (10, 28, 256))


@pytest.mark.parametrize("shape", ["tiny", "large"])
def test_predict_equal(shape):
    tm = make_synthetic_wnn(*SHAPES[shape], seed=0)
    jm = j_make(*SHAPES[shape], seed=0)
    for img in _images(1, 2):
        assert np.array_equal(tm.predict(img), jm.predict(img))


@pytest.mark.parametrize("shape", ["tiny", "large"])
def test_predict_fn_equal(shape):
    tm = make_synthetic_wnn(*SHAPES[shape], seed=0)
    jm = j_make(*SHAPES[shape], seed=0)
    fwd, jfwd = tm.predict_fn(device="cpu"), jm.predict_fn()
    for img in _images(2, 3):
        got = fwd(img)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(jfwd(jnp.asarray(img))))
        assert np.array_equal(got.numpy(), tm.predict(img))


def test_convert_carries_the_model():
    jm = j_make(*TINY_SHAPE, seed=1)
    tm = convert.wnn_from_reference(*_fields(jm))
    assert _fields(tm)[:5] == _fields(jm)[:5]
    img = _images(3, 1)[0]
    assert np.array_equal(tm.predict(img), jm.predict(img))


# ---- limbmath -------------------------------------------------------------------

def _limb_pair(rng, shape, n):
    a = rng.integers(0, 1 << 16, shape + (n,)).astype(np.uint32)
    return torch.from_numpy(a.astype(np.int64)), jnp.asarray(a)


def _same(t, j):
    assert np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


def test_limbmath_equal():
    rng = np.random.default_rng(4)
    a, aj = _limb_pair(rng, (64,), 4)
    b, bj = _limb_pair(rng, (64,), 3)
    assert np.array_equal(lm.int_to_limbs(12345678901234, 4),
                          jlm.int_to_limbs(12345678901234, 4))
    cols = rng.integers(0, 1 << 20, (64, 5)).astype(np.uint32)
    _same(lm.normalize(torch.from_numpy(cols.astype(np.int64)), 6),
          jlm.normalize(jnp.asarray(cols), 6))
    _same(lm.lmul(a, b), jlm.lmul(aj, bj))
    _same(lm.lmul(a, b, out_limbs=5), jlm.lmul(aj, bj, out_limbs=5))
    const = jlm.int_to_limbs(2097143, 2)
    _same(lm.lmul(a, const), jlm.lmul(aj, const))
    small = torch.minimum(a, torch.cat([b, b[:, :1]], dim=1))
    smallj = jnp.asarray(small.numpy().astype(np.uint32))
    _same(lm.lge(a, small), jlm.lge(aj, smallj))
    _same(lm.lge(small, a), jlm.lge(smallj, aj))
    x3 = lm.lmul(lm.lmul(a[:, :2], a[:, :2]), a[:, :2], out_limbs=6)
    x3j = jlm.lmul(jlm.lmul(aj[:, :2], aj[:, :2]), aj[:, :2], out_limbs=6)
    _same(x3, x3j)
    const6 = jlm.int_to_limbs(2097143, 6)
    _same(lm.lsub_clamped(x3, const6), jlm.lsub_clamped(x3j, const6))
    for p in (509, 2097143, 9007199254740881):
        _same(lm.barrett_mod(x3, p, 6), jlm.barrett_mod(x3j, p, 6))
    for n in (1, 3, 4):
        lo, hi = lm.limbs_to_u32_pair(a[:, :n])
        jlo, jhi = jlm.limbs_to_u32_pair(aj[:, :n])
        _same(lo, jlo)
        _same(hi, jhi)


# ---- the toy worked example -------------------------------------------------------

TOY = dict(
    image=np.array([[70, 100, 150], [20, 110, 200], [27, 50, 211], [200, 100, 3]],
                   dtype=np.uint8),
    thresholds=np.array(
        [[[50, 150], [0, 50], [200, 256]],
         [[10, 80], [100, 200], [50, 150]],
         [[0, 100], [100, 200], [0, 100]],
         [[0, 100], [100, 200], [0, 100]]], dtype=np.uint16),
    permutation=np.array([6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
                          20, 21, 22, 23, 0, 1, 2, 3, 4, 5], dtype=np.int64),
)


def _toy_bloom():
    # filter indices 2237, 3788; hashes -> (966, 805) and (494, 46)
    bloom = np.zeros((2, 2, 1024), dtype=bool)
    for c, n, e in ((0, 0, 966), (0, 0, 805), (0, 1, 494), (1, 0, 966),
                    (1, 0, 805), (1, 1, 494), (1, 1, 46)):
        bloom[c, n, e] = True
    return bloom


def _toy_jax():
    return JWnn(2, 12, 1024, 2, 2097143, _toy_bloom(), TOY["permutation"],
                TOY["thresholds"])


def _toy_port():
    return convert.wnn_from_reference(*_fields(_toy_jax()))


def test_toy_scores_and_mock_prover():
    wnn = _toy_port()
    assert list(wnn.predict(TOY["image"])) == [1, 2]
    assert wnn.get_circuit_params().to_dict() == dict(
        p=2097143, l=20, n_hashes=2, bits_per_hash=10, bits_per_filter=12,
        n_classes=2)
    wnn.mock_proof(TOY["image"], k=12)
    circuit = wnn.get_circuit(TOY["image"])
    MockProver.run(circuit, [[1, 2]], k=12).assert_satisfied()
    errs = MockProver.run(circuit, [[1, 3]], k=12).verify()
    assert any("copy constraint" in e for e in errs)
    prover = MockProver.run(circuit, [[1, 2]], k=12)
    col = prover.a.advice[1]                 # the hash quotient column
    first = next(i for i in range(len(col)) if col[i] != 0)
    col[first] = int(col[first]) + 1
    assert prover.verify()
    jerrs = JMockProver.run(JWnnCircuit(
        TOY["image"], _toy_bloom(), TOY["thresholds"], TOY["permutation"],
        JParams(**wnn.get_circuit_params().to_dict())), [[1, 3]], k=12).verify()
    assert errs == jerrs


def _synth(circuit, cs_cls, asn_cls, k):
    cs = cs_cls()
    cfg = circuit.configure(cs)
    asn = asn_cls(cs, 1 << k)
    scores = circuit.synthesize(cfg, asn)
    asn.finalize_tables()
    return cs, asn, scores


def _cs_text(cs, render, k):
    """The `cs:` part of the pinned verifying key, rendered without keys."""
    vk = types.SimpleNamespace(cs=cs, fixed_commitments=[],
                               permutation_commitments=[])
    dom = types.SimpleNamespace(k=k, extended_k=k, omega=1)
    return render(vk, dom)


@pytest.mark.parametrize("model,k", [("toy", 12), ("tiny", 14)])
def test_synthesized_circuits_equal(model, k):
    if model == "toy":
        jm, image = _toy_jax(), TOY["image"]
    else:
        jm, image = j_make(*TINY_SHAPE, seed=0), _images(0, 1)[0]
    tm = convert.wnn_from_reference(*_fields(jm))
    cs, asn, scores = _synth(tm.get_circuit(image), ConstraintSystem,
                             Assignment, k)
    jcs, jasn, jscores = _synth(jm.get_circuit(image), JCS, JAssignment, k)
    assert scores == jscores == [int(v) for v in jm.predict(image)]
    assert len(asn.advice) == len(jasn.advice) and len(asn.fixed) == len(jasn.fixed)
    for a, b in zip(asn.advice + asn.fixed, jasn.advice + jasn.fixed):
        assert np.array_equal(a, b)
    assert cs.table_fixed == jcs.table_fixed
    assert cs.selector_fixed == jcs.selector_fixed
    assert cs.constants_column.index == jcs.constants_column.index
    assert asn.copies == jasn.copies
    assert cs.num_instance == jcs.num_instance == 1
    assert _cs_text(cs, pinned_text, k) == _cs_text(jcs, j_pinned_text, k)
    assert cs.degree() == jcs.degree()
    assert MockProver(asn, [scores]).verify() == []


# ---- the whole toy proof at k = 12 (ZEROG_SLOW_TESTS=1) -----------------------------

@pytest.mark.skipif(not os.environ.get("ZEROG_SLOW_TESTS"),
                    reason="minutes of CPU in each package; ZEROG_SLOW_TESTS=1")
def test_toy_proof_k12_byte_identical():
    from zerog_tpu.curve import Srs as JSrs
    from zerog_tpu.plonk import verify_proof as j_verify_proof
    from zerog_tpu_torch.curve import Srs

    k, seed, rng_seed = 12, b"wnn-toy-k12", b"wnn-toy-proof"
    jm, tm = _toy_jax(), _toy_port()
    jsrs = JSrs.setup(k, seed=seed)
    srs = Srs.setup(k, seed=seed, device="cpu")
    jpk = jm.generate_proving_key(jsrs)
    pk = tm.generate_proving_key(srs)
    assert pk.vk.transcript_repr == jpk.vk.transcript_repr
    jproof, jout = jm.proof(jpk, jsrs, TOY["image"], rng_seed=rng_seed)
    proof, out = tm.proof(pk, srs, TOY["image"], rng_seed=rng_seed)
    assert out == jout == [1, 2]
    assert proof == jproof
    assert tm.verify_proof(jproof, srs, pk.vk, out)
    assert j_verify_proof(jpk.vk, jsrs, [out], proof)
