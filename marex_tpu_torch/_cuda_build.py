"""
Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use they are
compiled with ``nvcc`` for ``sm_90a`` (Hopper), one ``nvcc`` a source and all
started together, and linked into one shared library under ``_build/`` (named
by a hash of the sources and flags, so an edited source is rebuilt) that is
loaded with ``ctypes``. Nothing here runs at import time: the
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
_SOURCES = (_PKG / "csrc" / "min_stencil.cu", _PKG / "csrc" / "graph_step.cu", _PKG / "csrc" / "partition.cu")
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

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
    nvcc = _nvcc()
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    objects = [tmp.with_suffix(f".{src.stem}.o") for src in _SOURCES]
    t0 = time.perf_counter()
    compiles = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in ([nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(_SOURCES, objects))
    ]
    try:
        outputs = [(cmd, proc, *proc.communicate()) for cmd, proc in compiles]
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        linked = subprocess.run(link, capture_output=True, text=True)
        outputs.append((link, linked, linked.stdout, linked.stderr))
        for cmd, proc, out, err in outputs:
            if proc.returncode != 0:
                raise DeviceError("nvcc failed to build the CUDA kernels", details=f"{' '.join(cmd)}\n{out}\n{err}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    last_build_seconds = time.perf_counter() - t0
    last_build_log = "".join(err for _, _, _, err in outputs)
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
    lib.marex_graph_step.argtypes = [p, p, ll, p, p, p, i, i, p]
    lib.marex_graph_step.restype = i
    lib.marex_graph_jump.argtypes = [p, p, ll, p, i, p]
    lib.marex_graph_jump.restype = i
    lib.marex_active_tiles.argtypes = [ll]
    lib.marex_active_tiles.restype = ll
    lib.marex_count_active.argtypes = [p, ll, p, p]
    lib.marex_count_active.restype = i
    lib.marex_write_active.argtypes = [p, ll, p, p, p]
    lib.marex_write_active.restype = i
    lib.marex_partition_grid.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.marex_partition_grid.restype = i
    return lib
