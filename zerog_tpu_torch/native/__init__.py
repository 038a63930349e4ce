"""Native (C) host code of the port, built from the repo's source at first use.

`limbcodec` (``limbcodec.c``): Python int <-> ``uint32[16]`` limb conversion,
into or out of Montgomery form, the codec of ``field/limbs.py``. It is plain
host C on the CPython API, not a CUDA kernel: the host C compiler (``cc``)
builds it into ``zerog_tpu_torch/_build/`` under a name that carries a hash
of the source, so an edited source builds a new library and a stale one is
never loaded. Builds go to a temporary name and are renamed into place, so
processes that build at the same moment leave one whole library. A failed
build raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import os
import pathlib
import subprocess
import sysconfig
import tempfile

__all__ = ["limbcodec", "library_path", "build", "load"]

SOURCE = pathlib.Path(__file__).resolve().parent / "limbcodec.c"
BUILD_DIR = SOURCE.parent.parent / "_build"
CC = "cc"


def library_path(src: pathlib.Path = SOURCE,
                 build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Where the library built from `src` lives: its name carries a hash of
    the source's bytes."""
    tag = hashlib.blake2b(pathlib.Path(src).read_bytes(), digest_size=8).hexdigest()
    return pathlib.Path(build_dir) / f"_limbcodec_{tag}.so"


def build(src: pathlib.Path = SOURCE,
          build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile `src` unless the library of its current bytes exists; returns
    the library's path. Raises RuntimeError with the compiler's stderr."""
    so = library_path(src, build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=so.parent, prefix=so.name + ".", suffix=".tmp")
    os.close(fd)
    include = sysconfig.get_paths()["include"]
    cmd = [CC, "-O3", "-shared", "-fPIC", f"-I{include}", str(src), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src} failed ({' '.join(cmd)}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load(src: pathlib.Path = SOURCE, build_dir: pathlib.Path = BUILD_DIR):
    """The extension module built from `src` (built first if needed)."""
    so = build(src, build_dir)
    spec = importlib.util.spec_from_file_location("_limbcodec", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def limbcodec():
    """The codec of this checkout, built at first use."""
    return load()
