"""The on-disk cache of merged-window tables (``Srs.window_table``) against
zerog_tpu's: the same file name and arrays, so that a file written by either
package loads in the other without a build, and a hit gives the tables a
build gives (limb for limb, tolerance zero).

k = 5 with the table threshold lowered to 1; the port's cache directory and
zerog_tpu's home directory lie under the test's temporary directory.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zerog_tpu.curve import pippenger as jpp
from zerog_tpu.curve import srs as jsrs_mod

from zerog_tpu_torch.curve import Srs
from zerog_tpu_torch.curve import pippenger as tpp
from zerog_tpu_torch.curve import srs as srs_mod
from zerog_tpu_torch.field import to_numpy

torch.set_num_threads(1)

K = 5


def _no_build(*args, **kwargs):
    raise AssertionError("a window table was built where the cache should hit")


def _equal(a, b):
    return (torch.equal(a.tx, b.tx) and torch.equal(a.ty, b.ty)
            and torch.equal(a.tvalid, b.tvalid) and (a.c, a.n) == (b.c, b.n))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A k = 5 SRS and both bases' tables as built, with no cache in play."""
    srs = Srs.setup(K, seed=b"table-cache", device="cpu")
    tables = {basis: tpp.build_window_table(srs._pdev(basis),
                                            tpp.default_fixed_window(srs.n),
                                            device="cpu")
              for basis in ("lagrange", "monomial")}
    return srs, tables


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(Srs, "FIXED_MIN_N", 1)
    monkeypatch.setattr(srs_mod, "CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path / "cache"


def _fresh(srs):
    """A new Srs on the same points: no table in memory."""
    return Srs(srs.k, srs.g, srs.g_lagrange, srs.g2, srs.s_g2, device="cpu")


@pytest.mark.parametrize("basis", ["lagrange", "monomial"])
def test_miss_writes_one_file_and_hit_equals_build(built, cache, basis,
                                                   monkeypatch):
    srs, tables = built
    first = _fresh(srs).window_table(basis)
    assert _equal(first, tables[basis])
    files = list(cache.iterdir())
    assert len(files) == 1 and files[0].name.startswith("wtable_")
    monkeypatch.setattr(srs_mod, "build_window_table", _no_build)
    assert _equal(_fresh(srs).window_table(basis), tables[basis])


def test_mesh_sized_table_is_cached(built, cache, monkeypatch):
    """`min_n` (the mesh path's table at any size) goes through the cache."""
    monkeypatch.setattr(Srs, "FIXED_MIN_N", 1 << 20)
    srs, tables = built
    assert _fresh(srs).window_table("lagrange") is None
    assert _equal(_fresh(srs).window_table("lagrange", min_n=0), tables["lagrange"])
    monkeypatch.setattr(srs_mod, "build_window_table", _no_build)
    assert _equal(_fresh(srs).window_table("lagrange", min_n=0), tables["lagrange"])
    assert len(list(cache.iterdir())) == 1


def _jax_srs(srs):
    return jsrs_mod.Srs(srs.k, srs.g, srs.g_lagrange, srs.g2, srs.s_g2)


def test_port_file_loads_in_zerog_tpu(built, cache, tmp_path, monkeypatch):
    srs, tables = built
    _fresh(srs).window_table("lagrange")
    (written,) = cache.iterdir()
    home = tmp_path / "home"
    (home / ".cache" / "zerog_tpu").mkdir(parents=True)
    shutil.copy(written, home / ".cache" / "zerog_tpu" / written.name)
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr(jsrs_mod.Srs, "FIXED_MIN_N", 1)
    monkeypatch.setattr(jsrs_mod, "build_window_table", _no_build)
    jt = _jax_srs(srs).window_table("lagrange")
    t = tables["lagrange"]
    assert (jt.c, jt.n) == (t.c, t.n)
    assert np.array_equal(np.asarray(jt.tx), to_numpy(t.tx))
    assert np.array_equal(np.asarray(jt.ty), to_numpy(t.ty))
    assert np.array_equal(np.asarray(jt.tvalid), t.tvalid.numpy())


def test_zerog_tpu_file_loads_in_port(built, cache, tmp_path, monkeypatch):
    """zerog_tpu writes the file on its miss (its build handed the port's
    arrays, so no XLA doubling chain runs); the port reads it unbuilt."""
    srs, tables = built
    t = tables["monomial"]
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr(jsrs_mod.Srs, "FIXED_MIN_N", 1)
    monkeypatch.setattr(jsrs_mod, "build_window_table", lambda pdev, c: jpp.WindowTable(
        c, srs.n, jnp.asarray(to_numpy(t.tx)), jnp.asarray(to_numpy(t.ty)),
        jnp.asarray(t.tvalid.numpy())))
    _jax_srs(srs).window_table("monomial")
    jax_dir = home / ".cache" / "zerog_tpu"
    assert len(list(jax_dir.iterdir())) == 1
    monkeypatch.setattr(srs_mod, "CACHE_DIR", str(jax_dir))
    monkeypatch.setattr(srs_mod, "build_window_table", _no_build)
    assert _equal(_fresh(srs).window_table("monomial"), t)


def test_concurrent_writers_leave_one_readable_file(built, cache):
    srs, tables = built
    t = tables["lagrange"]
    path = str(cache / "wtable_same.npz")
    threads = [threading.Thread(target=lambda: [srs_mod._write_table(path, t)
                                                for _ in range(3)])
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert [f.name for f in cache.iterdir()] == ["wtable_same.npz"]
    with np.load(path) as d:
        assert np.array_equal(d["tx"], to_numpy(t.tx))
        assert np.array_equal(d["ty"], to_numpy(t.ty))
        assert np.array_equal(d["tv"], t.tvalid.numpy())


def test_unwritable_cache_is_skipped(built, tmp_path, monkeypatch):
    srs, tables = built
    blocker = tmp_path / "not_a_directory"
    blocker.write_text("")
    monkeypatch.setattr(Srs, "FIXED_MIN_N", 1)
    monkeypatch.setattr(srs_mod, "CACHE_DIR", str(blocker / "cache"))
    assert _equal(_fresh(srs).window_table("lagrange"), tables["lagrange"])
