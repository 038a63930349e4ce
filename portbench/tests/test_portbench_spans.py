"""The per-layer metrics that read the program's spans and counters
(``zerog_tpu_torch.trace.summary()``): each gives its per-proof mean, and
nothing where the program recorded nothing of its name or has no spans."""

import sys

import numpy as np
import pytest

from harness.cells import Benchmark
from harness.metrics import Run
from harness.serve import Request

import zerog_tpu_torch
from zerog_tpu_torch import trace


def _span(seconds):
    return dict(count=1, seconds=seconds, self_seconds=seconds, counts={})


SUMMARY = dict(
    spans={"prover.random_poly": _span(3.0), "prover.lookup_compress": _span(1.5),
           "prover.lookup_permute": _span(0.75), "prover.grand_products": _span(6.0),
           "msm": _span(2.25), "codec.encode": _span(0.6), "codec.decode": _span(1.2),
           "phase.synthesize": _span(9.0)},
    counters={"h2d_bytes": 3 * 2 ** 20, "d2h_bytes": 3 * 2 ** 19, "field_ops": 3 * 7001},
    proofs=3, per_proof=[])

# each metric's per-proof mean over the 3 proofs of SUMMARY
EXPECTED = {
    "random_poly_s.latency": 1.0,
    "lookup_host_s.latency": 0.75,
    "grand_products_host_s.latency": 2.0,
    "msm_s.latency": 0.75,
    "codec_s.latency": 0.6,
    "transfer_mib_per_proof.latency": 1.5,
    "field_ops_per_proof.latency": 7001,
}


def _run(proofs=3):
    reqs = [Request(i, np.zeros((28, 28), np.uint8)) for i in range(proofs)]
    return Run(requests=reqs, window_s=6.0, setup=dict(setup_s=30.0), trace=None,
               memory_peak_bytes=0)


def test_every_new_metric_is_in_the_benchmark():
    per_layer = {m["name"]: m for m in Benchmark().spec["per_layer"]}
    for name in EXPECTED:
        assert per_layer[name]["source"] == "program_span"
        assert per_layer[name]["workloads"] == ["mnist_large.prove_serial"]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_the_per_proof_mean(name, monkeypatch):
    monkeypatch.setattr(trace, "summary", lambda: SUMMARY)
    assert Benchmark().reader(name)(_run()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_without_its_spans(name, monkeypatch):
    monkeypatch.setattr(trace, "summary",
                        lambda: dict(spans={"phase.synthesize": _span(9.0)},
                                     counters={}, proofs=3, per_proof=[]))
    read = Benchmark().reader(name)
    assert read(_run()) is None
    monkeypatch.setattr(trace, "summary", lambda: SUMMARY)
    assert read(_run(proofs=0)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_from_a_program_without_spans(name, monkeypatch):
    """The parent of the spans has no ``zerog_tpu_torch.trace``."""
    monkeypatch.setattr(trace, "summary", lambda: SUMMARY)
    monkeypatch.delattr(zerog_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "zerog_tpu_torch.trace", None)
    with pytest.raises(ImportError):
        from zerog_tpu_torch import trace as _  # noqa: F401
    assert Benchmark().reader(name)(_run()) is None
