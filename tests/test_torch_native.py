"""The port's C limb codec (zerog_tpu_torch.native) against zerog_tpu's
``to_limbs`` / ``from_limbs`` and against the port's own numpy path, limb
for limb (tolerance zero: integer conversions), and how the library is built
from the repo's source.

Values come from a numpy seed, with the edges spliced in: 0, 1, p - 1, p,
2^256 - 1 (which the codec takes), and -1, 2^256 and numpy integers (which
it refuses, so the exact numpy path answers). zerog_tpu's codec reads a numpy
integer held in an object array as if it were a Python int (its value is
lost), so for those the reference is zerog_tpu's own numpy path.
"""

import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from zerog_tpu.field import limbs as jlimbs

from zerog_tpu_torch import native
from zerog_tpu_torch.field import FQ, FR
from zerog_tpu_torch.field import limbs

torch.set_num_threads(1)

SHAPES = [(), (0,), (1,), (3, 5), (2, 4096)]
KINDS = ["values", "negative", "huge", "int64"]


def _values(params, shape, kind):
    """An object array (or a scalar for shape ()) of the given kind."""
    p = params.p
    rng = np.random.default_rng(20241018 + len(shape) + sum(shape))
    size = int(np.prod(shape)) if shape else 1
    words = rng.integers(0, 1 << 63, size=(size, 5), dtype=np.int64)
    flat = [sum(int(w) << (63 * i) for i, w in enumerate(row)) % (1 << 256)
            for row in words]
    flat = [v % p if i % 3 else v for i, v in enumerate(flat)]
    edges = {"values": [0, 1, p - 1, p, (1 << 256) - 1],
             "negative": [-1], "huge": [1 << 256]}.get(kind, [])
    flat[:len(edges)] = edges[:size]
    if kind == "int64":
        flat = [np.int64(v % (1 << 62)) for v in flat]
    if shape == ():
        return flat[0]
    arr = np.empty(size, dtype=object)
    arr[:] = flat
    return arr.reshape(shape)


def _outcome(fn, *args):
    """The limbs `fn` returns, or the type of what it raised."""
    try:
        return fn(*args)
    except (OverflowError, TypeError) as e:
        return type(e)


def _same(a, b):
    if isinstance(a, type) or isinstance(b, type):
        return a is b
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("mont", [False, True], ids=["plain", "mont"])
@pytest.mark.parametrize("params", [FR, FQ], ids=lambda f: f.name)
def test_codec_equals_reference_and_numpy_path(params, mont, shape, kind,
                                               monkeypatch):
    vals = _values(params, shape, kind)
    got = _outcome(limbs.to_limbs, vals, params, mont)
    plain = _outcome(limbs._to_limbs_np, vals, params, mont)
    if kind == "int64":     # zerog_tpu's numpy path
        monkeypatch.setattr(jlimbs, "_native", lambda: None)
    ref = _outcome(jlimbs.to_limbs, vals, params, mont)
    assert _same(got, ref) and _same(got, plain)
    if isinstance(got, type):
        return
    assert got.dtype == np.uint32 and got.shape == tuple(shape) + (16,)
    back = limbs.from_limbs(got, params, mont)
    back_plain = limbs._from_limbs_np(got, params, mont)
    back_ref = jlimbs.from_limbs(got, params, mont)
    if shape == ():
        assert back == back_plain == back_ref
    else:
        assert back.dtype == object and back.shape == tuple(shape)
        assert (back == back_plain).all() and (back == back_ref).all()


@pytest.mark.parametrize("params", [FR, FQ], ids=lambda f: f.name)
def test_int64_arrays_take_the_codec(params):
    """An int64 numpy array becomes Python ints, which the codec takes."""
    arr = np.random.default_rng(7).integers(0, 1 << 62, size=(4, 33), dtype=np.int64)
    for mont in (False, True):
        got = limbs.to_limbs(arr, params, mont)
        assert _same(got, jlimbs.to_limbs(arr, params, mont))
        assert _same(got, limbs._to_limbs_np(arr, params, mont))


def test_codec_refuses_what_is_not_an_int():
    codec = limbs._native()
    out = np.empty((1, 16), dtype=np.uint32)
    for bad, exc in ((np.int64(5), TypeError), (1.5, TypeError),
                     (-1, OverflowError), (1 << 256, OverflowError)):
        with pytest.raises(exc):
            codec.ints_to_limbs([bad], out, None)
    with pytest.raises(TypeError):
        limbs.to_limbs([1.5, 2])
    with pytest.raises(ValueError):
        codec.ints_to_limbs([1, 2], out, None)


def test_library_is_built_from_the_repo_source():
    mod = limbs._native()
    so = native.library_path()
    assert so.parent == pathlib.Path(limbs.__file__).resolve().parents[1] / "_build"
    assert so.exists() and pathlib.Path(mod.__file__) == so
    assert so.name.startswith("_limbcodec_") and so.suffix == ".so"


def test_stale_library_is_rebuilt(tmp_path):
    src = tmp_path / "limbcodec.c"
    shutil.copy(native.SOURCE, src)
    build_dir = tmp_path / "_build"
    first = native.build(src, build_dir)
    stamp = first.stat().st_mtime_ns
    assert native.build(src, build_dir) == first          # no second build
    assert first.stat().st_mtime_ns == stamp
    src.write_text(src.read_text() + "\n/* edited */\n")
    second = native.build(src, build_dir)
    assert second != first and second.exists()
    assert native.load(src, build_dir).limbs_to_ints(
        np.arange(16, dtype=np.uint32), 1, None) == [
        sum(j << (16 * j) for j in range(16))]
    assert not list(build_dir.glob("*.tmp"))


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "limbcodec.c"
    src.write_text(native.SOURCE.read_text() + "\nthis is not C;\n")
    with pytest.raises(RuntimeError, match="error"):
        native.load(src, tmp_path / "_build")
    assert not list((tmp_path / "_build").iterdir())


def test_concurrent_builds_leave_one_library(tmp_path):
    """Six processes build the same source into one directory at once, as
    the test workers do: one whole library, no temporary file left."""
    src = tmp_path / "limbcodec.c"
    shutil.copy(native.SOURCE, src)
    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import pathlib, sys; from zerog_tpu_torch import native; "
            "m = native.load(pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2])); "
            "print(m.limbs_to_ints(bytes(64), 1, None))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src),
                               str(tmp_path / "_build")], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert out.strip() == "[0]"
    assert [f.name for f in (tmp_path / "_build").iterdir()] == [
        native.library_path(src).name]


def test_native_reads_no_environment():
    for path in (native.SOURCE, pathlib.Path(native.__file__)):
        text = path.read_text()
        assert "environ" not in text and "getenv" not in text, path
