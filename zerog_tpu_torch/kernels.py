"""Build and load the CUDA kernels; the word-plane codecs.

The kernels are CUDA C++ under ``csrc/``. At first use the sources are
compiled with ``nvcc`` for ``sm_90a`` (one compiler process per source, all
started together, then one link) into a single shared library with a plain C
interface under ``_build/`` beside this file, and loaded with ``ctypes``. No
PyTorch header is included, so a build takes seconds. A failed build raises.

Kernels take *word planes*: a field element is 8 little-endian 32-bit words
(two of the tensor form's 16-bit limbs in each), stored word-major with the
element index as the fastest axis, ``int32[..., 8, n]`` (the bit pattern of
``uint32``), so that neighbouring threads touch neighbouring addresses.
:func:`to_word_planes` and :func:`from_word_planes` convert from and to the
``int64[..., n, 16]`` limb tensors of the plain code. One kernel,
``field_limbs`` (JField's add, sub and mul), takes those limb tensors
themselves, each operand with its own element strides.

Each wrapper that launches a kernel registers itself here and carries a
``launches`` integer; :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import time

import torch

__all__ = ["build", "load", "lib", "demangle", "register", "launch_counts",
           "reset_launch_counts", "to_word_planes", "from_word_planes",
           "check_planes", "on_device", "BUILD_INFO"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("field_binop.cu", "field_limbs.cu", "flush_scan.cu", "fold.cu", "ntt.cu",
           "bench.cu")
HEADERS = ("field.cuh",)
LIB_NAME = "libzerog_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: filled by :func:`build`: seconds, and per kernel what ptxas reported
#: (registers, stack frame, spill stores and loads in bytes)
BUILD_INFO: dict = {}

_LIB = None
_WRAPPERS: dict = {}

_P = ctypes.c_void_p
_L = ctypes.c_long
_I = ctypes.c_int
_SIGNATURES = {
    "zg_field_binop": [_P, _P, _P, _L, _I, _I, _P],
    "zg_field_limbs": [_P, _L, _L, _P, _L, _L, _P, _L, _L, _I, _I, _P],
    "zg_flush_scan_affine": [_P] * 10 + [_L, _L, _P],
    "zg_flush_scan_jac": [_P] * 10 + [_L, _L, _P],
    "zg_sum_rows": [_P, _P, _P, _I, _P],
    "zg_weighted_fold": [_P] * 9 + [_L, _L, _P],
    "zg_ntt_epilogue": [_P] * 5 + [_L, _L, _I, _P],
    "zg_ntt_twiddle": [_P] * 4 + [_L, _L, _L, _P],
    "zg_field_chain": [_P, _P, _P, _L, _I, _I, _P],
    "zg_scan_bisect": [_I] + [_P] * 4 + [_L, _L, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("zerog_tpu_torch.kernels: nvcc not found; the CUDA "
                       "kernels cannot be built on this machine")


def demangle(mangled: str) -> str:
    """A kernel's mangled name demangled as far as the identifier and its
    integer template arguments, e.g. ``field_binop_kernel<0,0,4>`` (a field
    argument is 0 for Fq, 1 for Fr); a name that is not mangled as it is."""
    mm = re.match(r"_Z(\d+)", mangled)
    if not mm:
        return mangled
    end = mm.end() + int(mm.group(1))
    name = mangled[mm.end():end]
    targs = re.match(r"I((?:Li-?\d+E)+)E", mangled[end:])
    if targs:
        name += "<" + ",".join(re.findall(r"Li(-?\d+)E", targs.group(1))) + ">"
    return name


def _parse_ptxas(text: str) -> dict:
    """'ptxas info' lines -> {kernel name: {registers, stack, spill_stores,
    spill_loads}}, names as :func:`demangle` gives them."""
    out = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = demangle(m.group(1))
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def _stale(target: str, csrc_dir: str) -> bool:
    if not os.path.exists(target):
        return True
    built = os.path.getmtime(target)
    return any(os.path.getmtime(os.path.join(csrc_dir, f)) > built
               for f in SOURCES + HEADERS)


def build(force: bool = False, csrc_dir: str = CSRC_DIR,
          build_dir: str = BUILD_DIR) -> str:
    """Compile ``csrc/*.cu`` (or the same sources under `csrc_dir`) into the
    shared library under `build_dir` if it is missing or older than a source;
    returns its path. Raises on any compiler error."""
    target = os.path.join(build_dir, LIB_NAME)
    if not force and not _stale(target, csrc_dir):
        return target
    nvcc = _nvcc()
    os.makedirs(build_dir, exist_ok=True)
    t0 = time.time()
    procs = []
    for src in SOURCES:
        obj = os.path.join(build_dir, src.replace(".cu", ".o"))
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(csrc_dir, src), "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log = []
    objs = []
    for src, obj, proc in procs:
        out, err = proc.communicate()
        log.append(err)
        if proc.returncode != 0:
            for _, _, other in procs:
                if other.poll() is None:
                    other.kill()
            raise RuntimeError(f"nvcc failed on {src}:\n{out}\n{err}")
        objs.append(obj)
    tmp = target + f".tmp{os.getpid()}"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, target)
    BUILD_INFO.update(seconds=time.time() - t0,
                      ptxas=_parse_ptxas("\n".join(log)))
    return target


def load(path: str):
    """A built kernel library, its C functions typed by ``_SIGNATURES``."""
    handle = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def lib():
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        _LIB = load(build())
    return _LIB


@contextlib.contextmanager
def on_device(t: torch.Tensor):
    """Make the device that holds tensor `t` current and yield the handle of
    its current stream: a launch inside goes to that device's context, so a
    kernel runs where its operands lie, also on a card other than the current
    one. Every ``zg_*`` launch is made inside this context."""
    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream(t.device).cuda_stream


# ---- launch counters -----------------------------------------------------------

def register(name: str):
    """Decorator: give a kernel wrapper its ``launches`` count and list it."""
    def deco(fn):
        fn.launches = 0
        fn.kernel_name = name
        _WRAPPERS[name] = fn
        return fn
    return deco


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def launched(name: str, code: int) -> None:
    """Count one launch of kernel `name` on its registered wrapper; raise if
    the launch was refused."""
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {code})")
    _WRAPPERS[name].launches += 1


# ---- word planes -----------------------------------------------------------------

def to_word_planes(limbs: torch.Tensor) -> torch.Tensor:
    """int64[..., n, 16] 16-bit limbs -> int32[..., 8, n] word planes."""
    words = limbs[..., 0::2] | (limbs[..., 1::2] << 16)
    return words.to(torch.int32).transpose(-1, -2).contiguous()


def from_word_planes(planes: torch.Tensor) -> torch.Tensor:
    """int32[..., 8, n] word planes -> int64[..., n, 16] 16-bit limbs."""
    words = planes.transpose(-1, -2).to(torch.int64) & 0xFFFFFFFF
    out = torch.stack([words & 0xFFFF, words >> 16], dim=-1)
    return out.reshape(words.shape[:-1] + (16,))


def check_planes(name: str, t: torch.Tensor, shape, dtype=torch.int32) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype and shape."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
