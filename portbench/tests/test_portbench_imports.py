"""What a run loads, in a fresh interpreter: never JAX nor the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference nothing of the program."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

LOAD_RUN = """
import json, sys
sys.argv = ["run.py"]
sys.path.insert(0, {here!r})
import run
from harness import check, serve, metrics, yardstick
from harness.cells import Benchmark
from harness.trace import Tracer
import control
b = Benchmark()
for m in b.spec["per_layer"]:
    b.reader(m["name"])
Tracer().install()          # imports every program module the traced run wraps
serve.program_model(__import__("reference.wnn").wnn.make_synthetic_wnn(28, 256, 1, 1))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys, pkgutil, importlib
sys.path.insert(0, {here!r})
import reference
for m in pkgutil.walk_packages(reference.__path__, "reference."):
    importlib.import_module(m.name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code.format(here=HERE)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    names = _top_level(LOAD_RUN)
    assert "zerog_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "zerog_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(LOAD_REFERENCE)
    assert "reference" in names
    assert not names & {"zerog_tpu_torch", "zerog_tpu", "jax", "jaxlib", "flax", "torch"}


def test_without_a_card_a_run_exits_nonzero_with_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mnist_large.prove_serial",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
