"""The port's PLONK prover core (keygen, create_proof, verify_proof) against
zerog_tpu.plonk on the shared k = 6 setup.

The SRS and the proving key of ``conftest.k6_setup`` are carried over by
``zerog_tpu_torch.convert`` as plain Python and numpy data; the circuit is
re-declared here against the port's IR. Everything is exact integer
arithmetic: keys, commitments and proof bytes are compared for equality —
tolerance zero.
"""

import pytest
import torch

from zerog_tpu.plonk import verify_proof as j_verify_proof

from zerog_tpu_torch import convert
from zerog_tpu_torch.field import FR
from zerog_tpu_torch.plonk import (
    Assignment, ConstraintSystem, create_proof, keygen, verify_proof,
)
from zerog_tpu_torch.plonk.pinned import pinned_text
from zerog_tpu_torch.poly import get_host_domain

torch.set_num_threads(1)

K = 6
# the frozen value of tests/test_pinned.py for this circuit and SRS seed
K6_TRANSCRIPT_REPR = (
    0xAF207B0DC257E1B07453766D68B8523128750F0677B48A4AB64E94ABD0A9CCB
)


class NibbleMulCircuit:
    """a*b = c (public) with a nibble-range lookup on a — the k=6 exercise
    of gates, lookups and copies of the JAX package's tests, declared
    against the port's constraint system."""

    def __init__(self, a, b):
        self.a = a
        self.b = b

    def configure(self, cs: ConstraintSystem):
        col_a = cs.advice_column()
        col_b = cs.advice_column()
        col_c = cs.advice_column()
        sel = cs.selector()
        table = cs.lookup_table_column()
        q_look = cs.selector()
        instance = cs.instance_column()
        for c in (col_a, col_b, col_c, instance):
            cs.enable_equality(c)
        cs.create_gate("mul", [sel.expr() * (col_a.cur() * col_b.cur() - col_c.cur())])
        cs.lookup("a_nibble", [(q_look.expr() * col_a.cur(), table)])
        return dict(a=col_a, b=col_b, c=col_c, sel=sel, table=table,
                    q_look=q_look, instance=instance)

    def synthesize(self, cfg, asn: Assignment):
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
def carried(k6_setup):
    """(jax srs, jax pk, port srs, port pk built from the JAX key material)."""
    jsrs, jpk = k6_setup
    srs = convert.srs_from_reference(jsrs.k, jsrs.g, jsrs.g_lagrange, jsrs.g2,
                                     jsrs.s_g2, device="cpu")
    comp = jpk.vk.cs.compression
    pk = convert.proving_key_from_reference(
        K, NibbleMulCircuit(0, 0), jpk.fixed_values, jpk.sigma_values,
        jpk.vk.fixed_commitments, jpk.vk.permutation_commitments,
        compression=None if comp is None else (comp.keep, comp.combos))
    return jsrs, jpk, srs, pk


@pytest.fixture(scope="module")
def port_proof(carried):
    _, _, srs, pk = carried
    timings = {}
    proof = create_proof(pk, srs, NibbleMulCircuit(3, 5), [[15]],
                         rng_seed=b"k6-shared-proof", timings=timings)
    assert "commit_advice" in timings and "multiopen" in timings
    return proof


@pytest.fixture(scope="module")
def evm_code(carried):
    """The port's verifier contract for the carried k = 6 key, and
    zerog_tpu's for the same key."""
    from zerog_tpu.eth import gen_evm_verifier as j_gen_evm_verifier
    from zerog_tpu_torch.eth import gen_evm_verifier

    jsrs, jpk, srs, pk = carried
    return gen_evm_verifier(pk.vk, srs, [1]), j_gen_evm_verifier(jpk.vk, jsrs, [1])


def test_evm_verifier_bytes_equal_reference(evm_code):
    code, jcode = evm_code
    assert code == jcode and len(code) > 1000


def test_evm_dry_run_accepts_port_proof_with_reference_gas(evm_code, port_proof):
    """The port's executor accepts the port's proof, and spends the gas that
    zerog_tpu's executor spends on the same code and calldata."""
    from zerog_tpu.eth import dry_run_verifier as j_dry_run_verifier
    from zerog_tpu_torch.eth import dry_run_verifier

    code, _ = evm_code
    gas = dry_run_verifier(code, [[15]], port_proof)
    assert 0 < gas < 5_000_000
    assert gas == j_dry_run_verifier(code, [[15]], port_proof)


@pytest.mark.parametrize("case", ["flip_40", "flip_middle", "flip_end",
                                  "wrong_instance"])
def test_evm_dry_run_rejects(evm_code, port_proof, case):
    """As tests/test_evm_verifier.py: three tampered bytes, a wrong
    instance; the verifier reverts and the dry run raises."""
    from zerog_tpu_torch.eth import dry_run_verifier

    code, _ = evm_code
    proof, instance = bytearray(port_proof), [[15]]
    pos = {"flip_40": 40, "flip_middle": len(proof) // 2,
           "flip_end": len(proof) - 10}.get(case)
    if pos is None:
        instance = [[16]]
    else:
        proof[pos] ^= 1
    with pytest.raises(ValueError, match="reverted"):
        dry_run_verifier(code, instance, bytes(proof))


def test_carried_key_has_reference_digest(carried):
    _, jpk, _, pk = carried
    assert pk.vk.transcript_repr == jpk.vk.transcript_repr == K6_TRANSCRIPT_REPR
    from zerog_tpu.plonk.pinned import pinned_text as j_pinned_text
    from zerog_tpu.poly.domain import get_domain as j_get_domain

    assert pinned_text(pk.vk, get_host_domain(K, pk.vk.cs.degree())) == \
        j_pinned_text(jpk.vk, j_get_domain(K, jpk.vk.cs.degree()))


def test_port_keygen_equals_reference(carried):
    """The port's own keygen, through its flush engine, gives the same fixed
    and sigma values, the same commitments and the same vk digest."""
    _, jpk, srs, _ = carried
    pk = keygen(NibbleMulCircuit(0, 0), K, srs)
    assert len(pk.fixed_values) == len(jpk.fixed_values)
    for a, b in zip(pk.fixed_values, jpk.fixed_values):
        assert list(a) == list(b)
    for a, b in zip(pk.sigma_values, jpk.sigma_values):
        assert list(a) == list(b)
    assert pk.vk.fixed_commitments == jpk.vk.fixed_commitments
    assert pk.vk.permutation_commitments == jpk.vk.permutation_commitments
    assert pk.vk.transcript_repr == K6_TRANSCRIPT_REPR


def test_port_proof_equals_reference_bytes(port_proof, k6_proof):
    assert port_proof == k6_proof


def test_each_verifier_accepts_the_others_proof(carried, port_proof, k6_proof):
    jsrs, jpk, srs, pk = carried
    assert verify_proof(pk.vk, srs, [[15]], k6_proof)
    assert j_verify_proof(jpk.vk, jsrs, [[15]], port_proof)


def test_port_verifier_rejects_tampering(carried, port_proof):
    _, _, srs, pk = carried
    assert verify_proof(pk.vk, srs, [[15]], port_proof)
    with pytest.raises(ValueError):
        verify_proof(pk.vk, srs, [[16]], port_proof)
    bad = bytearray(port_proof)
    bad[40] ^= 1
    with pytest.raises(ValueError):
        verify_proof(pk.vk, srs, [[15]], bytes(bad))


def test_create_proof_refuses_foreign_device(carried):
    _, _, srs, pk = carried
    if torch.cuda.is_available():
        pytest.skip("only meaningful on a machine without a CUDA device")
    with pytest.raises(RuntimeError):
        create_proof(pk, srs, NibbleMulCircuit(3, 5), [[15]], device="cuda")


@pytest.fixture(scope="module")
def mesh_proof(carried):
    """The same proof on a mesh of 8 CPU entries: point-sharded commitments,
    four-step NTTs, the quotient on row blocks."""
    from zerog_tpu_torch.parallel import make_mesh

    _, _, srs, pk = carried
    return create_proof(pk, srs, NibbleMulCircuit(3, 5), [[15]],
                        rng_seed=b"k6-shared-proof",
                        mesh=make_mesh(8, ["cpu"] * 8))


def test_mesh_proof_equals_reference_bytes(mesh_proof, k6_proof):
    assert mesh_proof == k6_proof


def test_mesh_proof_passes_both_verifiers(carried, mesh_proof):
    jsrs, jpk, srs, pk = carried
    assert verify_proof(pk.vk, srs, [[15]], mesh_proof)
    assert j_verify_proof(jpk.vk, jsrs, [[15]], mesh_proof)


def test_mesh_must_start_on_the_srs_device(carried):
    from zerog_tpu_torch.parallel import make_mesh

    _, _, srs, pk = carried
    with pytest.raises(ValueError, match="first entry"):
        create_proof(pk, srs, NibbleMulCircuit(3, 5), [[15]],
                     mesh=make_mesh(2, ["meta", "cpu"]))
