"""
Host routines in C++: the union-find of event clustering and the LZ4 block
decoder of blosc-compressed zarr chunks.

The package's own ``csrc/marex_host.cpp`` (the two routines of the
repository's ``csrc/marex_host.cpp`` that the port calls, so that an
installed port carries its source) is compiled with ``g++`` at first use into
``_build/`` (named by a hash of the source and flags, so an edited source is
rebuilt) and loaded with ``ctypes``. Its two entry points are
``marex_union_find`` and ``marex_lz4_decompress``: the merge march's other
host work is array code on the tracker's device.

:func:`union_find_plain` and :func:`lz4_decompress_plain` are the Python
versions (``marex_tpu/_native.py``'s fallbacks). The union-finds number
components by their smallest node position, so event ids do not depend on
which one ran; :func:`union_find` and :func:`lz4_decompress` take the
library when it builds and the Python version otherwise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from .logging_config import get_logger

logger = get_logger(__name__)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "marex_host.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
# no -march=native: a library built on one host must load on another
_GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"libmarex_host_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded host library (built if needed), or None when the source
    or ``g++`` is missing or the build fails."""
    if not _SOURCE.exists():
        logger.warning(f"{_SOURCE} not found: the numpy union-find runs instead")
        return None
    lib_path = _library_path()
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".tmp{os.getpid()}.so")
        try:
            subprocess.run(["g++", *_GXX_FLAGS, str(_SOURCE), "-o", str(tmp)], check=True, capture_output=True,
                           timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning(f"building {_SOURCE.name} failed ({e}): the numpy union-find runs instead")
            return None
        os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(lib_path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.marex_union_find.restype = None
    lib.marex_union_find.argtypes = [i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.marex_lz4_decompress.restype = ctypes.c_int64
    lib.marex_lz4_decompress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    return lib


def has_native() -> bool:
    return get_lib() is not None


def union_find(edges: np.ndarray, node_ids: np.ndarray) -> np.ndarray:
    """Connected components: edges (N, 2), node_ids (M,) -> (M,) int32
    component index, numbered in order of each component's first node."""
    lib = get_lib()
    if lib is None:
        return union_find_plain(edges, node_ids)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    node_ids = np.ascontiguousarray(node_ids, dtype=np.int64)
    ea = np.ascontiguousarray(edges[:, 0])
    eb = np.ascontiguousarray(edges[:, 1])
    comp = np.empty(len(node_ids), np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.marex_union_find(
        ea.ctypes.data_as(i64p),
        eb.ctypes.data_as(i64p),
        len(ea),
        node_ids.ctypes.data_as(i64p),
        len(node_ids),
        comp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return comp


def union_find_plain(edges: np.ndarray, node_ids: np.ndarray) -> np.ndarray:
    """The numpy union-find (path compression, smaller root wins)."""
    node_ids = np.asarray(node_ids, dtype=np.int64)
    id_to_idx = {int(v): i for i, v in enumerate(node_ids)}
    parent = np.arange(len(node_ids), dtype=np.int64)

    def find(i: int) -> int:
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for aa, bb in np.asarray(edges).reshape(-1, 2):
        ia = id_to_idx.get(int(aa))
        ib = id_to_idx.get(int(bb))
        if ia is None or ib is None:
            continue
        ra, rb = find(ia), find(ib)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(i) for i in range(len(node_ids))], dtype=np.int64)
    _, comp = np.unique(roots, return_inverse=True)
    return comp.astype(np.int32).reshape(-1)


def lz4_decompress(src: bytes, dst_size: int) -> bytes:
    """
    LZ4 block-format decompression (the payload format inside blosc frames,
    the reference ecosystem's default zarr codec) into at most ``dst_size``
    bytes: the library's ``marex_lz4_decompress`` when it builds, else
    :func:`lz4_decompress_plain`. Raises ``ValueError`` on a malformed block.
    """
    lib = get_lib()
    if lib is None:
        return lz4_decompress_plain(src, dst_size)
    sbuf = np.frombuffer(src, dtype=np.uint8)
    dbuf = np.empty(dst_size, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.marex_lz4_decompress(sbuf.ctypes.data_as(u8p), len(sbuf), dbuf.ctypes.data_as(u8p), dst_size)
    if n < 0:
        raise ValueError("malformed LZ4 block")
    return dbuf[:n].tobytes()


def lz4_decompress_plain(src: bytes, dst_size: int) -> bytes:
    """The pure-Python LZ4 block decoder."""
    dst = bytearray(dst_size)
    si, di, n = 0, 0, len(src)
    while si < n:
        token = src[si]
        si += 1
        lit = token >> 4
        if lit == 15:
            while True:
                x = src[si]
                si += 1
                lit += x
                if x != 255:
                    break
        if lit:
            dst[di : di + lit] = src[si : si + lit]
            si += lit
            di += lit
        if si >= n:
            break
        offset = src[si] | (src[si + 1] << 8)
        si += 2
        if offset == 0 or offset > di:
            raise ValueError("malformed LZ4 block")
        mlen = token & 15
        if mlen == 15:
            while True:
                x = src[si]
                si += 1
                mlen += x
                if x != 255:
                    break
        mlen += 4
        if offset >= mlen:
            dst[di : di + mlen] = dst[di - offset : di - offset + mlen]
            di += mlen
        else:  # an overlapping match repeats the last ``offset`` bytes
            for _ in range(mlen):
                dst[di] = dst[di - offset]
                di += 1
    return bytes(dst[:di])
