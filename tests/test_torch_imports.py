"""Import hygiene and device dispatch of the port.

The port imports torch, never jax and nothing of zerog_tpu; its entry points
mean the CUDA card when no device is named and raise without one; a kernel
wrapper given a CPU tensor takes its plain version and never touches the
kernel build. No numerics here beyond equality of the plain paths with
themselves (tolerance zero).
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

PORT_MODULES = [
    "zerog_tpu_torch", "zerog_tpu_torch.field", "zerog_tpu_torch.field.pfield",
    "zerog_tpu_torch.curve", "zerog_tpu_torch.curve.pscan",
    "zerog_tpu_torch.curve.pfold", "zerog_tpu_torch.curve.pippenger",
    "zerog_tpu_torch.poly", "zerog_tpu_torch.poly.eval",
    "zerog_tpu_torch.poly.pntt", "zerog_tpu_torch.ops.limbmath",
    "zerog_tpu_torch.transcript", "zerog_tpu_torch.plonk",
    "zerog_tpu_torch.plonk.mock", "zerog_tpu_torch.gadgets",
    "zerog_tpu_torch.gadgets.bloom_filter", "zerog_tpu_torch.gadgets.wnn_circuit",
    "zerog_tpu_torch.models", "zerog_tpu_torch.models.wnn",
    "zerog_tpu_torch.models.synthetic",
    "zerog_tpu_torch.convert", "zerog_tpu_torch.kernels", "zerog_tpu_torch.native",
    "zerog_tpu_torch.bench", "zerog_tpu_torch.bench.field_chain",
    "zerog_tpu_torch.bench.scan_bisect", "zerog_tpu_torch.bench.ab",
    "zerog_tpu_torch.parallel", "zerog_tpu_torch.parallel.mesh",
    "zerog_tpu_torch.parallel.sharded_ntt",
    "zerog_tpu_torch.parallel.sharded_domain",
    "zerog_tpu_torch.parallel.sharded_msm",
    "zerog_tpu_torch.parallel.sharded_prover",
    "zerog_tpu_torch.parallel.dryrun",
]
# the user's entry point and its host modules: none of them may need h5py,
# PIL or matplotlib to import (the card's machine has none of the three)
HOST_IO_MODULES = [
    "zerog_tpu_torch.cli", "zerog_tpu_torch.eth", "zerog_tpu_torch.eth.client",
    "zerog_tpu_torch.models.io", "zerog_tpu_torch.models.keys_io",
    "zerog_tpu_torch.plonk.layout", "zerog_tpu_torch.utils",
]
PORT_MODULES += HOST_IO_MODULES


def _fresh(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_fresh_interpreter_imports_no_jax(target):
    mods = PORT_MODULES if target == "package" else ["chip_smoke"]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
          " or m == 'jaxlib' or m == 'zerog_tpu' or m.startswith('zerog_tpu.')]\n"
          "assert not bad, bad\n"
          "assert 'torch' in sys.modules\n"
          "print('clean')\n")
    out = _fresh(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_host_io_modules_import_without_h5py_pil_matplotlib():
    blocked = ["h5py", "PIL", "matplotlib"]
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in blocked)
        + "".join(f"import {m}\n" for m in HOST_IO_MODULES)
        + f"assert all(sys.modules[m] is None for m in {blocked!r})\n"
          "from zerog_tpu_torch.models import load_wnn\n"
          "try:\n"
          "    load_wnn('missing.hdf5')\n"
          "except ImportError:\n"
          "    print('clean')\n")
    out = _fresh(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_sources_name_no_jax_import():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|zerog_tpu)\b", re.M)
    files = list((ROOT / "zerog_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        assert not pat.search(path.read_text()), path


def _launch_sites(tree):
    """(call, enclosing with-items) for every call in `tree` that launches a
    kernel: a call of a ``zg_*`` attribute of the loaded library, or of
    ``getattr(<library>, name)`` (the form of the A/B harness and of the
    flush scan's wrapper)."""
    import ast

    sites = []

    def visit(node, withs):
        if isinstance(node, ast.With):
            withs = withs + [item.context_expr for item in node.items]
        if isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute) and fn.attr.startswith("zg_")) or (
                    isinstance(fn, ast.Call) and isinstance(fn.func, ast.Name)
                    and fn.func.id == "getattr" and "lib" in ast.unparse(fn.args[0])):
                sites.append((node, withs))
        for child in ast.iter_child_nodes(node):
            visit(child, withs)

    visit(tree, [])
    return sites


def test_every_launch_goes_to_its_operands_device():
    """Every ``zg_*`` launch in the port sits inside ``with
    kernels.on_device(t) as stream`` and passes that stream, so it goes to
    the device that holds its operands (also a card other than the current
    one); ``ntt.cu`` sets its shared-memory attribute per device."""
    import ast

    files = list((ROOT / "zerog_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    found = 0
    for path in files:
        src = path.read_text()
        assert "current_stream(" not in src.replace("torch.cuda.current_stream(", ""), path
        for call, withs in _launch_sites(ast.parse(src)):
            where = f"{path.name}:{call.lineno}"
            guards = [w for w in withs if isinstance(w, ast.Call)
                      and ast.unparse(w.func) in ("kernels.on_device", "on_device")]
            assert guards, f"{where}: launch outside kernels.on_device"
            last = call.args[-1] if call.args else None
            assert isinstance(last, ast.Name) and last.id == "stream", \
                f"{where}: the launch's last argument is not the device's stream"
            found += 1
    assert found >= 10       # the nine wrappers' launches and the A/B harness's
    ntt = (ROOT / "zerog_tpu_torch" / "csrc" / "ntt.cu").read_text()
    tw = ntt[ntt.index("static int tw_launch"):]
    tw = tw[:tw.index("\n}\n")]
    assert "cudaGetDevice(&dev)" in tw and "attr[dev]" in tw


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("only meaningful on a machine without a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _entry_points():
    from zerog_tpu_torch.curve import (
        Srs, fixed_base_expand, msm, points_to_device)
    from zerog_tpu_torch.curve.pippenger import build_window_table
    from zerog_tpu_torch.models import make_synthetic_wnn
    from zerog_tpu_torch.poly import NttPlan, get_domain
    from zerog_tpu_torch.bench import field_chain, scan_bisect
    from zerog_tpu_torch import cli
    from zerog_tpu_torch.parallel import make_mesh
    from zerog_tpu_torch.parallel.dryrun import dryrun_multichip

    return {
        "Srs.setup": lambda: Srs.setup(2),
        "Srs.read": lambda: Srs.read("missing.srs"),
        "NttPlan": lambda: NttPlan(3),
        "get_domain": lambda: get_domain(3, 3),
        "msm": lambda: msm([[1, 2]], None),
        "build_window_table": lambda: build_window_table((None, None, None), 4),
        "points_to_device": lambda: points_to_device([(1, 2)]),
        "fixed_base_expand": lambda: fixed_base_expand((1, 2), [1]),
        "Wnn.predict_fn": lambda: make_synthetic_wnn(28, 256, 1, 1).predict_fn(),
        "bench.field_chain.main": lambda: field_chain.main([]),
        "bench.scan_bisect.main": lambda: scan_bisect.main([]),
        "cli.main": lambda: cli.main(["generate-srs", "-k", "2",
                                      "--srs-path", "missing.srs"]),
        "make_mesh": lambda: make_mesh(),
        "dryrun_multichip": lambda: dryrun_multichip(4),
    }


ENTRY_POINT_NAMES = ["Srs.setup", "Srs.read", "NttPlan", "get_domain", "msm",
                     "build_window_table", "points_to_device",
                     "fixed_base_expand", "Wnn.predict_fn",
                     "bench.field_chain.main", "bench.scan_bisect.main",
                     "cli.main", "make_mesh", "dryrun_multichip"]


@pytest.mark.parametrize("name", ENTRY_POINT_NAMES)
def test_entry_point_with_no_device_raises_without_cuda(name):
    """device=None means the card: nothing carries on on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("only meaningful on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_public_helpers_need_a_device():
    """The tensor-making helpers take no default device (the JAX package's
    take none at all): a call without one raises."""
    from zerog_tpu_torch.curve.jpoints import jac_infinity
    from zerog_tpu_torch.field import jfr

    with pytest.raises(TypeError):
        jfr().const(5)
    with pytest.raises(TypeError):
        jac_infinity((2,))
    assert jfr().const(5, device="cpu").device.type == "cpu"
    assert jac_infinity((2,), device="cpu")[2].device.type == "cpu"


def test_keygen_and_prove_follow_the_srs_device():
    """keygen and create_proof take their device from the SRS they are
    given; an SRS cannot be made for the card without one."""
    if torch.cuda.is_available():
        pytest.skip("only meaningful on a machine without a CUDA device")
    from zerog_tpu_torch.curve import Srs
    from zerog_tpu_torch.curve.bn254 import G1_GEN, G2_GEN

    with pytest.raises(RuntimeError, match="CUDA"):
        Srs(1, [G1_GEN] * 2, [G1_GEN] * 2, G2_GEN, G2_GEN)
    assert Srs(1, [G1_GEN] * 2, [G1_GEN] * 2, G2_GEN, G2_GEN,
               device="cpu").device.type == "cpu"


def test_cpu_tensors_take_plain_versions_and_leave_the_build_alone():
    from zerog_tpu_torch import kernels
    from zerog_tpu_torch.bench import field_chain, scan_bisect
    from zerog_tpu_torch.curve import pfold, pscan
    from zerog_tpu_torch.curve.jpoints import jac_infinity
    from zerog_tpu_torch.field import FQ, FR, to_device, to_limbs
    from zerog_tpu_torch.field import pfield
    from zerog_tpu_torch.poly import pntt

    torch.set_num_threads(1)
    build_dir = pathlib.Path(kernels.BUILD_DIR)
    existed = build_dir.exists()
    kernels.reset_launch_counts()

    a = pfield.to_planes(to_device(to_limbs(list(range(128))), "cpu"))
    out = pfield.pfq().add(a, a)
    assert pfield.from_planes(out)[5, 0] == 10

    inf = jac_infinity((2, 1, 3), device="cpu")       # [R=2, G=1, C=3]
    flags = torch.zeros((2, 1, 3), dtype=torch.bool)
    pieces = pscan.flush_scan(inf, flags, affine=False)
    assert pieces[0].shape == (3, 1, 3, 16)
    assert torch.equal(pieces[2][-1], torch.zeros(1, 3, 16, dtype=torch.int64))
    folded = pfold.sum_rows(inf)
    assert torch.equal(folded[2], torch.zeros(1, 3, 16, dtype=torch.int64))
    bias = tuple(c[0, 0, 0] for c in inf)
    assert pfold.weighted(tuple(c[:, :, :2] for c in inf), bias)[0].shape == (1, 2, 16)
    acc = torch.zeros((32, 2, 8), dtype=torch.int32)
    zero8 = torch.zeros(8, dtype=torch.int32)
    rowc = torch.zeros(64, dtype=torch.int32)
    assert pntt.epilogue(acc, zero8, rowc).shape == (32, 2, 8)
    assert pntt.epilogue(acc, zero8, rowc, out_bytes=False).shape == (8, 2, 8)
    xb = torch.full((32, 2, 8), -128, dtype=torch.int8)
    out, colsum = pntt.twiddle(xb, torch.zeros((8, 2, 4), dtype=torch.int32))
    assert torch.equal(out, xb.reshape(32, 4, 4))        # zeros, regrouped
    assert torch.equal(colsum, torch.full((4,), -128 * 32 * 4, dtype=torch.int32))
    rone = pfield.to_planes(to_device(to_limbs([FR.r_mont] * 128), "cpu"))
    assert torch.equal(field_chain.field_chain(FR, a, rone, k=2), a)   # x * 1 * 1
    one = to_device(to_limbs([FQ.r_mont] * 3), "cpu").reshape(1, 3, 16)
    for body in scan_bisect.BODIES:
        x = scan_bisect.scan_bisect(body, one.expand(2, 3, 16), one.expand(2, 3, 16),
                                    torch.zeros((2, 3), dtype=torch.bool))
        assert x.shape == (2, 3, 16)

    assert kernels._LIB is None
    assert build_dir.exists() == existed
    assert set(kernels.launch_counts()) == {
        "field_binop", "field_limbs", "flush_scan_affine", "flush_scan_jac", "sum_rows",
        "weighted_fold", "ntt_epilogue", "ntt_twiddle", "field_chain",
        "scan_bisect_trivial", "scan_bisect_mul_smem", "scan_bisect_mul_reg",
        "scan_bisect_madd"}
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_kernel_wrappers_refuse_cpu_tensors():
    """The word-plane wrappers launch or raise; they never fall back."""
    from zerog_tpu_torch.curve import pfold, pscan
    from zerog_tpu_torch.field import FQ
    from zerog_tpu_torch.field import pfield

    w = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pfield.field_binop_words("mul", FQ, w, w)
    rows = torch.zeros((2, 8, 4), dtype=torch.int32)
    mask = torch.zeros((2, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        pscan.flush_scan_affine_words(rows, rows, mask, mask)
    with pytest.raises(ValueError, match="CUDA"):
        pscan.flush_scan_jac_words(rows, rows, rows, mask)
    with pytest.raises(ValueError, match="CUDA"):
        pfold.sum_rows_words(rows, rows, rows)
    with pytest.raises(ValueError, match="CUDA"):
        pfold.weighted_fold_words(rows, rows, rows, w, w, w)
    from zerog_tpu_torch.poly import pntt

    acc = torch.zeros((32, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pntt.epilogue_words(acc, acc[0, 0], acc[:, :, 0].reshape(64))
    with pytest.raises(ValueError, match="CUDA"):
        pntt.twiddle_words(acc.to(torch.int8), torch.zeros((8, 2, 4), dtype=torch.int32))
    from zerog_tpu_torch.bench import field_chain, scan_bisect

    with pytest.raises(ValueError, match="CUDA"):
        field_chain.field_chain_words(FQ, w, w)
    for body in scan_bisect.BODIES:
        with pytest.raises(ValueError, match="CUDA"):
            scan_bisect.scan_bisect_words(body, rows, rows, mask)
