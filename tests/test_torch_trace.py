"""The port's spans and counters (``zerog_tpu_torch.trace``) around small
proofs, on the CPU.

One proof is made with no profile and two under ``torch.profiler``, on a
k = 5 circuit with a lookup and copies. The test SRS commits with its
trapdoor, [f(tau)]G1 for each column: the points the MSM gives, in one
scalar product a column, so that a proof takes about a second here. Its
commitment calls are the SRS's own (``Srs.commit*``, the ``msm`` spans).
"""

import pathlib
import re
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import zerog_tpu_torch
from zerog_tpu_torch import trace
from zerog_tpu_torch.curve.bn254 import G1_GEN, G2_GEN, g1_mul, g2_mul
from zerog_tpu_torch.curve.srs import Srs
from zerog_tpu_torch.field import FR, from_limbs, limbs
from zerog_tpu_torch.plonk import Assignment, ConstraintSystem, create_proof, keygen
from zerog_tpu_torch.plonk.prover import PHASES

torch.set_num_threads(1)

K = 5
SEED = b"trace-proof"


class NibbleMulCircuit:
    """a*b = c (public), a in a nibble table, a copied to a second row."""

    def __init__(self, a, b):
        self.a = a
        self.b = b

    def configure(self, cs: ConstraintSystem):
        col_a, col_b, col_c = (cs.advice_column() for _ in range(3))
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
        (ca,) = asn.assign_advice(cfg["a"], row, self.a)
        asn.assign_advice(cfg["b"], row, self.b)
        (cc,) = asn.assign_advice(cfg["c"], row, self.a * self.b % FR.p)
        asn.enable_selector(cfg["sel"], row)
        asn.enable_selector(cfg["q_look"], row)
        row2 = asn.region([cfg["b"]], 1)
        (cb2,) = asn.assign_advice(cfg["b"], row2, self.a)
        asn.copy(ca, cb2)
        asn.constrain_instance(cc, cfg["instance"], 0)


class TauSrs(Srs):
    """An SRS that commits with its trapdoor: [f(tau)]G1, from the column's
    values weighted by tau^i (coefficients) or L_i(tau) (Lagrange values)."""

    def __init__(self, k: int, tau: int):
        super().__init__(k, None, None, G2_GEN, g2_mul(G2_GEN, tau), device="cpu")
        p, n = FR.p, self.n
        self.weights = dict(monomial=[pow(tau, i, p) for i in range(n)], lagrange=[])
        omega, w = FR.nth_root_of_unity(k), 1
        scale = (pow(tau, n, p) - 1) * pow(n, -1, p) % p
        for _ in range(n):
            self.weights["lagrange"].append(w * scale * pow(tau - w, -1, p) % p)
            w = w * omega % p

    def _commit_rows(self, rows, basis):
        weights = self.weights[basis]
        return [g1_mul(G1_GEN, sum(int(v) * c for v, c in zip(row, weights)) % FR.p)
                for row in rows]

    def _msm_chunked(self, rows, basis):
        return self._commit_rows(rows, basis)

    def _msm_dev(self, stack, basis):
        return self._commit_rows(from_limbs(stack.reshape(-1, self.n, 16), FR, mont=True),
                                 basis)


def _prove(setup, **kw):
    srs, pk = setup
    return create_proof(pk, srs, NibbleMulCircuit(3, 5), [[15]], rng_seed=SEED, **kw)


def _recording_to_device(monkeypatch, given):
    """Replaces every binding of ``to_device`` in the port's modules by one
    that records the bytes of each host array it is given as int64."""
    orig = limbs.to_device

    def recorded(x, device):
        if not isinstance(x, torch.Tensor):
            given.append(np.asarray(x).astype(np.int64).nbytes)
        return orig(x, device)

    for name, mod in list(sys.modules.items()):
        if name.startswith("zerog_tpu_torch") and getattr(mod, "to_device", None) is orig:
            monkeypatch.setattr(mod, "to_device", recorded)


@pytest.fixture(scope="module")
def setup():
    srs = TauSrs(K, tau=0x5EED)
    return srs, keygen(NibbleMulCircuit(0, 0), K, srs)


@pytest.fixture(scope="module")
def proofs(setup):
    """The untraced proof with what it recorded, and two traced proofs (the
    first with `timings`) with their spans, summary and the bytes given to
    ``to_device`` while they ran."""
    trace.reset()
    plain = _prove(setup)
    out = dict(plain=plain, plain_spans=trace.spans(), plain_summary=trace.summary())
    given, timings = [], {}
    with pytest.MonkeyPatch.context() as mp:
        _recording_to_device(mp, given)
        with profile(activities=[ProfilerActivity.CPU]):
            out["traced"] = [_prove(setup, timings=timings), _prove(setup)]
    out.update(spans=trace.spans(), summary=trace.summary(), given=given,
               timings=timings)
    trace.reset()
    return out


def test_untraced_proof_records_nothing(proofs):
    assert proofs["plain_spans"] == []
    assert proofs["plain_summary"]["counters"] == {}
    assert proofs["plain_summary"]["spans"] == {}


def test_traced_proof_bytes_equal_untraced(proofs):
    assert proofs["traced"][0] == proofs["plain"]
    assert proofs["traced"][1] == proofs["plain"]


def test_phase_spans_are_the_timings_contiguous_and_cover_the_root(proofs):
    spans = proofs["spans"]
    roots = [s for s in spans if s.name == "proof"]
    assert len(roots) == 2 and proofs["summary"]["proofs"] == 2
    for root in roots:
        assert root.parent is None and root.proof == root.id
        assert all(s.proof == root.id for s in spans
                   if root.start_ns <= s.start_ns < root.end_ns)
        phases = [s for s in spans if s.parent == root.id and s.name.startswith("phase.")]
        assert [s.name for s in phases] == [f"phase.{p}" for p in PHASES]
        for a, b in zip(phases, phases[1:]):
            assert a.end_ns == b.start_ns
        covered = phases[-1].end_ns - phases[0].start_ns
        assert covered >= 0.99 * (root.end_ns - root.start_ns)
    # the first proof's timings are its phase spans, to the ns
    first = [s for s in spans if s.proof == roots[0].id and s.name.startswith("phase.")]
    assert set(proofs["timings"]) == set(PHASES)
    for s in first:
        assert proofs["timings"][s.name[len("phase."):]] == (s.end_ns - s.start_ns) / 1e9


def test_named_spans_nest_in_their_phases(proofs):
    spans = proofs["spans"]
    by_id = {s.id: s for s in spans}

    def phase_of(s):
        while not by_id[s.parent].name.startswith("phase."):
            s = by_id[s.parent]
        return by_id[s.parent].name

    where = {s.name: phase_of(s) for s in spans if s.name.startswith("prover.")}
    assert where == {"prover.blind": "phase.synthesize",
                     "prover.lookup_compress": "phase.lookup_permute_commit",
                     "prover.lookup_permute": "phase.lookup_permute_commit",
                     "prover.grand_products": "phase.grand_products_commit",
                     "prover.random_poly": "phase.random_poly_commit"}
    summary = proofs["summary"]["spans"]
    assert summary["msm"]["count"] > 0 and summary["codec.encode"]["count"] > 0
    for e in summary.values():
        assert 0 <= e["self_seconds"] <= e["seconds"] + 1e-9


def test_span_is_stamped_on_the_profile_clock():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.outer"):
            time.sleep(0.02)
            with trace.span("test.inner"):
                time.sleep(0.02)
            time.sleep(0.02)
    (inner,) = trace.spans()
    trace.reset()
    (outer,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "test.outer"]
    assert outer.start_ns() < inner.start_ns < inner.end_ns < outer.start_ns() + outer.duration_ns()


def test_counters_repeat_and_count_what_to_device_was_given(proofs):
    per_proof = proofs["summary"]["per_proof"]
    assert len(per_proof) == 2
    assert per_proof[0]["field_ops"] == per_proof[1]["field_ops"] > 0
    assert per_proof[0]["h2d_bytes"] == per_proof[1]["h2d_bytes"]
    assert proofs["summary"]["counters"]["h2d_bytes"] == sum(proofs["given"]) > 0
    assert per_proof[0]["d2h_bytes"] > 0


def test_a_proof_that_raises_leaves_no_open_span(setup, monkeypatch):
    def fail(*a):
        raise RuntimeError("no commitment")

    monkeypatch.setattr(TauSrs, "_msm_chunked", fail)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="no commitment"):
            _prove(setup)
    spans = trace.spans()
    trace.reset()
    assert [s.name for s in spans if s.name in ("proof", "phase.commit_advice", "msm")] \
        == ["proof", "phase.commit_advice", "msm"]
    assert all(s.end_ns is not None for s in spans)


def test_no_program_module_opens_a_profiler_range_or_syncs_for_a_span():
    root = pathlib.Path(zerog_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        assert not re.search(r"record_function\s*\(", path.read_text()), path
    assert not re.search(r"synchronize\s*\(", (root / "trace.py").read_text())
