"""The benchmark's plain reference against the program, on the CPU, at small
sizes: the model and its scores, the circuit the key is worked out from, and
the proof's check on a program proof at k = 6."""

import hashlib

import numpy as np
import pytest

from harness.check import srs_tau
from harness.serve import program_model
from reference import keygen as rkeygen
from reference import verifier as rverifier
from reference.assignment import Assignment as RAssignment
from reference.cs import ConstraintSystem as RConstraintSystem
from reference.selectors import compress_selectors_pass as r_compress
from reference.wnn import make_synthetic_wnn

from zerog_tpu_torch.curve import Srs
from zerog_tpu_torch.field import FR
from zerog_tpu_torch.models import make_synthetic_wnn as p_make
from zerog_tpu_torch.plonk import Assignment, ConstraintSystem, create_proof, keygen
from zerog_tpu_torch.plonk.keygen import build_sigmas
from zerog_tpu_torch.plonk.selectors import compress_selectors_pass

SHAPES = {"tiny": (28, 256, 1, 1), "large": (49, 8192, 4, 6)}


def _images(seed, count):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (28, 28)).astype(np.uint8) for _ in range(count)]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_and_scores_equal_the_programs(shape):
    ref = make_synthetic_wnn(*SHAPES[shape], seed=0)
    prog = p_make(*SHAPES[shape], seed=0)
    assert np.array_equal(ref.bloom_filters, prog.bloom_filters)
    assert np.array_equal(ref.input_permutation, prog.input_permutation)
    assert np.array_equal(ref.binarization_thresholds, prog.binarization_thresholds)
    handed = program_model(ref)
    for img in _images(5, 3):
        assert list(ref.predict(img)) == list(prog.predict(img)) == list(handed.predict(img))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_control_scores_differ(shape):
    """The control (the cube in float64) gets the scores wrong."""
    ref = make_synthetic_wnn(*SHAPES[shape], seed=0)
    imgs = _images(11, 4)
    assert all(list(ref.predict(i)) != list(ref.predict_float64(i)) for i in imgs)


def test_tiny_circuit_equals_the_programs_column_for_column():
    """The key's columns at MNIST-Tiny's k = 14: fixed columns (selectors
    compressed) and the permutation's sigmas."""
    k = 14
    ref = make_synthetic_wnn(*SHAPES["tiny"], seed=0)
    zero = np.zeros((28, 28), np.uint8)
    out = []
    for model, CS, Asn, compress, sig in (
            (ref, RConstraintSystem, RAssignment, r_compress, rkeygen.build_sigmas),
            (program_model(ref), ConstraintSystem, Assignment, compress_selectors_pass,
             build_sigmas)):
        cs = CS()
        circuit = model.get_circuit(zero)
        config = circuit.configure(cs)
        asn = Asn(cs, 1 << k)
        circuit.synthesize(config, asn)
        asn.finalize_tables()
        compress(cs, asn)
        out.append(([list(c) for c in asn.fixed], [list(s) for s in sig(cs, asn, 1 << k)],
                    cs.degree(), len(cs.lookups)))
    assert out[0] == out[1]


class NibbleMulCircuit:
    """a*b = c (public) with a nibble-range lookup on a, declared once for
    either constraint system (they share the interface)."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def configure(self, cs):
        col_a, col_b, col_c = cs.advice_column(), cs.advice_column(), cs.advice_column()
        sel, table, q_look = cs.selector(), cs.lookup_table_column(), cs.selector()
        instance = cs.instance_column()
        for c in (col_a, col_b, col_c, instance):
            cs.enable_equality(c)
        cs.create_gate("mul", [sel.expr() * (col_a.cur() * col_b.cur() - col_c.cur())])
        cs.lookup("a_nibble", [(q_look.expr() * col_a.cur(), table)])
        return dict(a=col_a, b=col_b, c=col_c, sel=sel, table=table,
                    q_look=q_look, instance=instance)

    def synthesize(self, cfg, asn):
        asn.assign_table([cfg["table"]], [list(range(16))])
        row = asn.region([cfg["a"], cfg["b"], cfg["c"], cfg["sel"], cfg["q_look"]], 1)
        (ca,) = asn.assign_advice(cfg["a"], row, self.a % FR.p)
        asn.assign_advice(cfg["b"], row, self.b % FR.p)
        (cc,) = asn.assign_advice(cfg["c"], row, self.a * self.b % FR.p)
        asn.enable_selector(cfg["sel"], row)
        asn.enable_selector(cfg["q_look"], row)
        row2 = asn.region([cfg["b"]], 1)
        (cb2,) = asn.assign_advice(cfg["b"], row2, self.a % FR.p)
        asn.copy(ca, cb2)
        asn.constrain_instance(cc, cfg["instance"], 0)


@pytest.fixture(scope="module")
def k6():
    seed = "portbench-k6"
    srs = Srs.setup(6, seed=seed.encode(), device="cpu")
    pk = keygen(NibbleMulCircuit(0, 0), 6, srs)
    proof = create_proof(pk, srs, NibbleMulCircuit(3, 5), [[15]], rng_seed=b"portbench")
    tau = srs_tau(seed)
    return pk, proof, tau, rkeygen.verifying_key(NibbleMulCircuit(0, 0), 6, tau)


def test_tau_is_the_programs(k6):
    pk, _, tau, _ = k6
    seed = "portbench-k6"
    assert tau == int.from_bytes(hashlib.blake2b(seed.encode(), digest_size=32).digest(),
                                 "little") % FR.p


def test_key_worked_out_with_tau_equals_the_programs(k6):
    pk, _, _, vk = k6
    assert vk.fixed_commitments == pk.vk.fixed_commitments
    assert vk.permutation_commitments == pk.vk.permutation_commitments
    assert vk.transcript_repr == pk.vk.transcript_repr


def test_reference_accepts_the_programs_proof(k6):
    _, proof, tau, vk = k6
    assert rverifier.verify_proof(vk, tau, [[15]], proof)


@pytest.mark.parametrize("case", ["byte", "scalar", "instance", "short"])
def test_reference_rejects_a_wrong_proof(k6, case):
    _, proof, tau, vk = k6
    inst = [[15]]
    if case == "byte":
        proof = bytes(b ^ (i == 10) for i, b in enumerate(proof))
    elif case == "scalar":
        b = bytearray(proof)
        b[-40] ^= 4
        proof = bytes(b)
    elif case == "instance":
        inst = [[16]]
    else:
        proof = proof[:-32]
    with pytest.raises(ValueError):
        rverifier.verify_proof(vk, tau, inst, proof)
