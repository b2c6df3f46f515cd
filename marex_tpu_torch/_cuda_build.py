"""
Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use they are
compiled with ``nvcc`` for ``sm_90a`` (Hopper) into one shared library under
``_build/`` (named by a hash of the sources and flags, so an edited source is
rebuilt) and loaded with ``ctypes``. Nothing here runs at import time: the
CPU-only test environment imports every module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .exceptions import DeviceError

_PKG = Path(__file__).resolve().parent
_SOURCES = (_PKG / "csrc" / "min_stencil.cu",)
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: seconds the last build took in this process (0.0 when the library was already built)
last_build_seconds = 0.0
#: ptxas report of the last build (registers, spills, shared memory per kernel)
last_build_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise DeviceError(
            "nvcc not found: the CUDA kernels cannot be built",
            details=f"looked in {candidate} and on PATH",
            suggestions=["Install the CUDA toolkit or set CUDA_HOME to it"],
        )
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libmarex_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless an up-to-date one exists; return its path."""
    global last_build_seconds, last_build_log
    lib = _library_path()
    if lib.exists():
        last_build_seconds = 0.0
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise DeviceError(
            "nvcc failed to build the CUDA kernels",
            details=f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}",
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    last_build_seconds = time.perf_counter() - t0
    last_build_log = proc.stderr
    return lib


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature declared."""
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.marex_ccl_step.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.marex_ccl_step.restype = i
    lib.marex_pointer_jump.argtypes = [p, p, ll, ll, p]
    lib.marex_pointer_jump.restype = i
    return lib
