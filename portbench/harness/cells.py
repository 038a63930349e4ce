"""What the benchmark runs, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations and the metrics. Everything that belongs to one of them sits in
files of its own that are found by name, so that a later cell, configuration,
traffic mix or per-layer metric is added as new files and entries without
editing an existing file:

- a configuration: the ``file`` its entry names (``portbench/configs/<name>.json``);
- a traffic mix: ``portbench/traffic/<name>.json``;
- a per-layer metric: ``portbench/metrics/<name>.py``, or, for a name with a
  suffix (``quotient_eval_s.latency``), ``portbench/metrics/<name before the
  first dot>.py``. The module's ``read(run)`` returns one number, or None
  where the run has nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # metric entries of BENCHMARK.json this cell reports
    per_layer: list


class Benchmark:
    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _path(self, *parts) -> str:
        return os.path.join(self.root, *parts)

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        with open(self._path(entry["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self._path("portbench", "traffic", f"{name}.json")) as f:
            return json.load(f)

    def cell(self, name: str) -> Cell:
        matches = [w for w in self.spec["workloads"] if w["name"] == name]
        if not matches:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = matches[0]

        def here(metric):
            return name in metric.get("workloads", [name])

        e2e = [m for m in self.spec["end_to_end"] if here(m)]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in self.spec["per_layer"]
                     if here(m) and m["moves"] in reported]
        return Cell(name, w["chips"], self.config(w["config"]),
                    self.traffic(w["traffic"]), e2e, per_layer)

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric's module."""
        for stem in (metric, metric.split(".")[0]):
            path = self._path("portbench", "metrics", f"{stem}.py")
            if os.path.exists(path):
                spec = importlib.util.spec_from_file_location(
                    f"portbench_metric_{stem.replace('.', '_')}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod.read
        raise FileNotFoundError(f"no reader for per-layer metric {metric!r}")
