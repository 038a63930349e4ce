"""Cells, configurations, traffic mixes and per-layer metrics are found by
name; new ones are added as new files and entries only."""

import json
import os
import shutil
import types

import numpy as np
import pytest

from harness import traffic
from harness.cells import ROOT, Benchmark
from harness.metrics import Run, end_to_end
from harness.serve import Request
from reference.wnn import make_synthetic_wnn


@pytest.fixture(scope="module")
def bench():
    return Benchmark()


def test_every_cell_resolves(bench):
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(bench.reader(m["name"]))
        traffic.check_mix(cell.traffic)


def test_each_config_file_is_its_own(bench):
    files = [c["file"] for c in bench.spec["configs"]]
    assert len(set(files)) == len(files)
    for c in bench.spec["configs"]:
        assert bench.config(c["name"])["name"] == c["name"]


def test_per_layer_metrics_name_a_reported_metric(bench):
    e2e = {m["name"]: m for m in bench.spec["end_to_end"]}
    for m in bench.spec["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])


def test_requests_are_fixed_by_the_seed():
    mix = Benchmark().traffic("prove_serial")
    seed = 3_000_000_017
    a = traffic.image(mix, seed, 5)
    assert a.shape == (28, 28) and a.dtype == np.uint8
    assert np.array_equal(a, traffic.image(mix, seed, 5))
    assert not np.array_equal(a, traffic.image(mix, seed, 6))
    assert not np.array_equal(a, traffic.image(mix, seed + 1, 5))
    assert traffic.rng_seed(seed, 5) == traffic.rng_seed(seed, 5)
    assert traffic.rng_seed(seed, 5) != traffic.rng_seed(seed, 6)
    assert traffic.rng_seed(seed, 5) != traffic.rng_seed(seed + 1, 5)


@pytest.mark.parametrize("change", [dict(clients=2), dict(loop="open")])
def test_a_mix_the_harness_cannot_drive_is_refused(change):
    mix = dict(Benchmark().traffic("prove_serial"), **change)
    with pytest.raises(ValueError):
        traffic.check_mix(mix)


def _run(trace=None):
    reqs = []
    for i in range(3):
        r = Request(i, np.zeros((28, 28), np.uint8))
        r.timings = {"synthesize": 0.5 + i, "quotient_eval": 1.0}
        reqs.append(r)
    return Run(requests=reqs, window_s=6.0, setup=dict(keygen_s=2.0, setup_s=30.0),
               trace=trace, memory_peak_bytes=3 * 2 ** 30)


def test_end_to_end_metrics_of_a_run(bench):
    cell = bench.cell("mnist_large.prove_serial")
    m = end_to_end(_run(), cell.end_to_end)
    assert m["proof_s"] == {"value": 2.0, "unit": "s"}
    assert m["setup_s"]["value"] == 30.0
    assert m["peak_device_gib"]["value"] == 3.0


def test_a_new_config_traffic_and_metric_are_found_from_new_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix and a
    per-layer metric as new files; only BENCHMARK.json's lists grow."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(ROOT, "portbench/configs/mnist_large.json")))
    cfg.update(name="mnist_small", k=15)
    cfg["model"].update(num_filter_inputs=28, num_filter_entries=1024,
                        num_filter_hashes=2, bits_per_input=2)
    (root / "portbench/configs/mnist_small.json").write_text(json.dumps(cfg))
    mix = json.load(open(os.path.join(ROOT, "portbench/traffic/prove_serial.json")))
    mix["about"] = "the same loop under another name"
    (root / "portbench/traffic/prove_again.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/first_synthesize_s.py").write_text(
        "def read(run):\n    return run.requests[0].timings['synthesize']\n")
    spec["configs"].append(dict(name="mnist_small", source="https://arxiv.org/abs/2203.01479",
                                file="portbench/configs/mnist_small.json", reduced=[],
                                why="the 2-hash path"))
    spec["workloads"].append(dict(name="mnist_small.prove_again", config="mnist_small",
                                  traffic="prove_again", chips=1, why="a new cell"))
    spec["per_layer"].append(dict(name="first_synthesize_s", unit="s", better="lower",
                                  source="program_span", layer="frontend",
                                  moves="setup_s", workloads=["mnist_small.prove_again"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Benchmark(str(root))
    cell = bench.cell("mnist_small.prove_again")
    assert cell.traffic["about"] == mix["about"] and cell.config["k"] == 15
    traffic.check_mix(cell.traffic)
    model = make_synthetic_wnn(**cell.config["model"])
    assert (model.num_filter_hashes, model.l) == (2, 20)
    assert [m["name"] for m in cell.per_layer] == ["first_synthesize_s"]
    assert bench.reader("first_synthesize_s")(_run()) == 0.5
    # the existing cells are as they were
    assert Benchmark(str(root)).cell("mnist_large.prove_serial") == \
        Benchmark().cell("mnist_large.prove_serial")


def test_a_suffixed_metric_reads_its_base_file(bench):
    assert bench.reader("synthesize_s.latency")(_run()) == pytest.approx(1.5)
    assert bench.reader("quotient_eval_s.latency")(_run()) == 1.0
    assert bench.reader("keygen_s")(_run()) == 2.0
    assert bench.reader("device_idle.latency")(_run()) is None


def test_device_readers_read_nothing_where_no_kernel_was_tied_to_a_call(bench):
    """A profile that tied no kernel to any MSM or NTT call gives no device
    time and no roofline, not a time from another source."""
    trace = types.SimpleNamespace(
        attributed=False, window_s=1.0, busy_s=0.5, kernels=10,
        calls=[dict(kind="msm", inputs=[[1, 2]], n_points=2, device_s=0.0, number=0),
               dict(kind="ntt", shape=(1, 2, 4), device_s=0.0, number=1)])
    run = _run(trace)
    assert run.device_s("msm") is None and run.device_s("ntt") is None
    for name in ("msm_device_ms.latency", "msm_roofline.latency", "ntt_roofline.latency"):
        assert bench.reader(name)(run) is None
    assert bench.reader("device_idle.latency")(run) == pytest.approx(50.0)
