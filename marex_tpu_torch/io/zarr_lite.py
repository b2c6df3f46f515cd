"""
zarr-lite: dependency-free zarr-v2 store reader/writer.

A copy of ``marex_tpu/io/zarr_lite.py`` for the port (that module imports
nothing of JAX, but importing anything of ``marex_tpu`` does). It reads and
writes directory-style zarr v2 stores with stdlib ``json`` + ``zlib``
(compressor id "zlib"), raw (compressor ``null``) chunks, and the xarray
``_ARRAY_DIMENSIONS`` convention, including minimal CF datetime decoding;
blosc chunks (lz4, zlib, zstd inside) are decoded too, lz4 by the host
library's ``marex_lz4_decompress`` (``_native.py``). Stores written by
either package read back bit for bit in the other: the metadata and chunk
bytes are made by the same code. A torch tensor payload is written from its
host copy (``.cpu().numpy()``).

Stores written here are valid zarr v2 and readable by the real ``zarr``
package; externally-produced stores with other codecs require the optional
``zarr`` dependency (gated via the dependency registry).
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import pandas as pd
import torch

from .._dependencies import has_dependency
from ..core.field import Coord, Field, FieldSet, gathered, is_dtensor
from ..exceptions import DataValidationError, DependencyError

_DEFAULT_CHUNK_BYTES = 64 * 2**20


# ----------------------------------------------------------------------------
# Writing
# ----------------------------------------------------------------------------


def _choose_chunks(shape: Tuple[int, ...], itemsize: int) -> Tuple[int, ...]:
    """Chunk along the leading axis so each chunk stays under ~64 MB."""
    if not shape:
        return ()
    row_bytes = itemsize * int(np.prod(shape[1:])) if len(shape) > 1 else itemsize
    lead = max(1, min(shape[0], _DEFAULT_CHUNK_BYTES // max(row_bytes, 1)))
    return (lead,) + tuple(shape[1:])


def _encode_datetimes(arr: np.ndarray) -> Tuple[np.ndarray, Dict[str, Any]]:
    if np.issubdtype(arr.dtype, np.datetime64):
        ns = arr.astype("datetime64[ns]").astype(np.int64)
        return ns, {"units": "nanoseconds since 1970-01-01", "calendar": "proleptic_gregorian"}
    return arr, {}


def _host(arr: Any) -> np.ndarray:
    """A payload as a host numpy array (a tensor through ``.cpu().numpy()``,
    a DTensor gathered first)."""
    if isinstance(arr, torch.Tensor):
        return gathered(arr).detach().cpu().numpy()
    return np.asarray(arr)


def _write_array(
    group_path: str,
    name: str,
    arr: Any,
    dims: Tuple[str, ...],
    attrs: Dict[str, Any],
    chunks: Optional[Tuple[int, ...]] = None,
) -> None:
    arr = np.ascontiguousarray(_host(arr))
    arr, time_attrs = _encode_datetimes(arr)
    a_attrs = dict(attrs)
    a_attrs.update(time_attrs)
    a_attrs["_ARRAY_DIMENSIONS"] = list(dims)

    apath = os.path.join(group_path, name)
    os.makedirs(apath, exist_ok=True)

    if chunks is None:
        chunks = _choose_chunks(arr.shape, arr.dtype.itemsize)
    else:
        chunks = tuple(min(int(c), s) for c, s in zip(chunks, arr.shape))
    chunks = tuple(max(1, c) for c in chunks)  # zarr's chunks are >= 1; an empty dim has no chunk files
    zarray = {
        "zarr_format": 2,
        "shape": list(arr.shape),
        "chunks": list(chunks) if chunks else [1],
        "dtype": arr.dtype.str if arr.dtype.kind != "b" else "|b1",
        "compressor": {"id": "zlib", "level": 1},
        "fill_value": None,
        "order": "C",
        "filters": None,
        "dimension_separator": ".",
    }
    with open(os.path.join(apath, ".zarray"), "w") as f:
        json.dump(zarray, f)
    with open(os.path.join(apath, ".zattrs"), "w") as f:
        json.dump(a_attrs, f, default=str)

    if arr.ndim == 0:
        data = zlib.compress(arr.tobytes(), 1)
        with open(os.path.join(apath, "0"), "wb") as f:
            f.write(data)
        return

    grid = [range(0, s, c) for s, c in zip(arr.shape, chunks)]

    def write_chunk(starts: Tuple[int, ...]) -> None:
        idx = tuple(slice(st, min(st + c, s)) for st, c, s in zip(starts, chunks, arr.shape))
        block = arr[idx]
        # pad partial edge chunks to full chunk shape (zarr v2 requirement)
        if block.shape != tuple(chunks):
            padded = np.zeros(chunks, dtype=arr.dtype)
            padded[tuple(slice(0, b) for b in block.shape)] = block
            block = padded
        key = ".".join(str(st // c) for st, c in zip(starts, chunks))
        with open(os.path.join(apath, key), "wb") as f:
            f.write(zlib.compress(np.ascontiguousarray(block).tobytes(), 1))

    import itertools

    for starts in itertools.product(*grid):
        write_chunk(starts)


def to_zarr(
    data: Union[Field, FieldSet],
    path: str,
    mode: str = "w",
    chunks: Optional[Dict[str, int]] = None,
) -> None:
    """
    Write a Field or FieldSet as a zarr v2 group (xarray-compatible layout).
    ``chunks`` maps dimension name -> chunk length (defaults: ~64 MB chunks
    along the leading axis) — spatially-chunked stores are what the streaming
    reader needs for bounded-memory tile reads. DTensor payloads (a mesh
    run's) are gathered on every rank, which must all call this, and the
    first rank writes the store.
    """
    if isinstance(data, Field):
        data = FieldSet({data.name or "data": data})
    if any(is_dtensor(f.data) for f in data.data_vars.values()):
        import torch.distributed as dist

        whole = FieldSet({k: f._replace(data=gathered(f.data)) for k, f in data.data_vars.items()}, data.coords,
                         data.attrs)
        if dist.get_rank() == 0:
            to_zarr(whole, path, mode=mode, chunks=chunks)
        dist.barrier()
        return
    if mode == "w" and os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)

    with open(os.path.join(path, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    with open(os.path.join(path, ".zattrs"), "w") as f:
        json.dump(dict(data.attrs), f, default=str)

    def _chunks_for(dims: Tuple[str, ...], shape: Tuple[int, ...]) -> Optional[Tuple[int, ...]]:
        if not chunks:
            return None
        if not any(d in chunks for d in dims):
            return None
        return tuple(int(chunks.get(d, s)) for d, s in zip(dims, shape))

    for name, fld in data.data_vars.items():
        attrs = dict(fld.attrs)
        # xarray convention: auxiliary coords (not named after their dim,
        # e.g. per-cell lat/lon on unstructured meshes) are recorded in the
        # variable's "coordinates" attribute so readers re-attach them
        aux = [
            c for c, coord in data.coords.items()
            if c not in data.data_vars and set(coord.dims) <= set(fld.dims) and tuple(coord.dims) != (c,)
        ]
        if aux:
            attrs["coordinates"] = " ".join(sorted(aux))
        _write_array(path, name, fld.data, fld.dims, attrs, chunks=_chunks_for(fld.dims, fld.shape))
    for name, coord in data.coords.items():
        if name in data.data_vars:
            continue
        _write_array(path, name, np.asarray(coord.values), coord.dims, {})


# ----------------------------------------------------------------------------
# Region writing (streamed output stores)
# ----------------------------------------------------------------------------


def create_group(path: str, attrs: Optional[Dict[str, Any]] = None, mode: str = "w") -> None:
    """Create an (empty) zarr v2 group."""
    if mode == "w" and os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    with open(os.path.join(path, ".zattrs"), "w") as f:
        json.dump(dict(attrs or {}), f, default=str)


def create_array(
    group_path: str,
    name: str,
    shape: Tuple[int, ...],
    dtype: Any,
    dims: Tuple[str, ...],
    chunks: Tuple[int, ...],
    attrs: Optional[Dict[str, Any]] = None,
    compressor: Optional[str] = "zlib",
) -> None:
    """
    Create array metadata only (no chunk payloads): the streamed-output
    counterpart of the reference's zarr region stores (track.py:4237-4367).
    Chunks are filled later with :func:`write_region`; unwritten chunks read
    back as zeros (zarr fill-value semantics).
    """
    dtype = np.dtype(dtype)
    chunks = tuple(min(int(c), s) for c, s in zip(chunks, shape))
    apath = os.path.join(group_path, name)
    os.makedirs(apath, exist_ok=True)
    zarray = {
        "zarr_format": 2,
        "shape": list(shape),
        "chunks": list(chunks) if chunks else [1],
        "dtype": dtype.str if dtype.kind != "b" else "|b1",
        "compressor": {"id": "zlib", "level": 1} if compressor == "zlib" else None,
        "fill_value": None,
        "order": "C",
        "filters": None,
        "dimension_separator": ".",
    }
    with open(os.path.join(apath, ".zarray"), "w") as f:
        json.dump(zarray, f)
    a_attrs = dict(attrs or {})
    a_attrs["_ARRAY_DIMENSIONS"] = list(dims)
    with open(os.path.join(apath, ".zattrs"), "w") as f:
        json.dump(a_attrs, f, default=str)


def write_region(group_path: str, name: str, starts: Tuple[int, ...], block: Any) -> None:
    """
    Write a hyperslab starting at ``starts`` (must be chunk-aligned in every
    dimension; the block may end mid-chunk only at the array edge). Each
    covered chunk is compressed and written independently, so disjoint
    regions can be written by concurrent processes.
    """
    with open(os.path.join(group_path, name, ".zarray")) as f:
        meta = json.load(f)
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    comp = meta.get("compressor")
    sep = meta.get("dimension_separator", ".")
    apath = os.path.join(group_path, name)

    block = np.ascontiguousarray(_host(block), dtype=dtype)
    for st, c, b, s in zip(starts, chunks, block.shape, shape):
        if st % c != 0:
            raise DataValidationError(
                f"write_region start {st} is not aligned to chunk size {c} for array '{name}'"
            )
        if (st + b) % c != 0 and (st + b) != s:
            raise DataValidationError(
                f"write_region block end {st + b} is neither chunk-aligned nor the array edge "
                f"(chunk {c}, dim size {s}) for array '{name}'"
            )

    import itertools

    grids = [range(st // c, -(-(st + b) // c)) for st, c, b in zip(starts, chunks, block.shape)]
    for gi in itertools.product(*grids):
        sl_block = tuple(
            slice(i * c - st, min((i + 1) * c, s) - st) for i, c, st, s in zip(gi, chunks, starts, shape)
        )
        sub = block[sl_block]
        if sub.shape != tuple(chunks):
            padded = np.zeros(chunks, dtype=dtype)
            padded[tuple(slice(0, d) for d in sub.shape)] = sub
            sub = padded
        key = sep.join(str(i) for i in gi)
        if comp is None:
            payload = np.ascontiguousarray(sub).tobytes()
        elif comp.get("id") == "zlib":
            payload = zlib.compress(np.ascontiguousarray(sub).tobytes(), comp.get("level", 1))
        else:  # pragma: no cover - we only create zlib/raw stores
            raise DataValidationError(f"write_region: unsupported compressor {comp}")
        with open(os.path.join(apath, key), "wb") as f:
            f.write(payload)


class RegionWriter:
    """
    :func:`write_region` calls run in background threads, at most
    ``max_pending`` at once (zlib and file writes release the GIL, so a
    streamed pipeline's compute goes on while its output is compressed and
    written). A block is cut at the array's chunk boundaries along its first
    axis and each piece written by its own call, so one block's chunks
    compress in parallel. A tensor block is copied to the host when it is
    handed over; a numpy block must not be changed afterwards. :meth:`flush`
    waits for every write so far and re-raises the first failure.
    """

    def __init__(self, workers: int = 4, max_pending: int = 16):
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="zarr-writer")
        self._pending: deque = deque()
        self._max = max_pending
        self._lead: Dict[Tuple[str, str], int] = {}

    def write(self, group_path: str, name: str, starts: Tuple[int, ...], block: Any) -> None:
        block = _host(block)
        key = (group_path, name)
        if key not in self._lead:
            with open(os.path.join(group_path, name, ".zarray")) as f:
                self._lead[key] = int(json.load(f)["chunks"][0])
        step = self._lead[key] if starts[0] % self._lead[key] == 0 else block.shape[0]
        for a in range(0, block.shape[0], step):
            while len(self._pending) >= self._max:
                self._pending.popleft().result()
            piece = block[a : a + step]
            self._pending.append(self._pool.submit(write_region, group_path, name, (starts[0] + a,) + tuple(starts[1:]),
                                                   piece))

    def flush(self) -> None:
        while self._pending:
            fut: Future = self._pending.popleft()
            fut.result()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "RegionWriter":
        return self

    def __exit__(self, *exc: Any) -> None:
        if exc[0] is None:
            self.close()
        else:  # already failing: let the pending writes finish, keep the first error
            self._pool.shutdown(wait=True)


# ----------------------------------------------------------------------------
# Reading
# ----------------------------------------------------------------------------


def _unshuffle(buf: bytes, typesize: int) -> bytes:
    """Undo blosc's byte-shuffle filter on one block (trailing bytes that do
    not fill a whole element are stored unshuffled, matching c-blosc)."""
    nelem = len(buf) // typesize
    main = nelem * typesize
    arr = np.frombuffer(buf, dtype=np.uint8, count=main)
    out = arr.reshape(typesize, nelem).T.tobytes()
    if main != len(buf):
        out += buf[main:]
    return out


def _bitunshuffle(buf: bytes, typesize: int) -> bytes:
    """Undo blosc's bit-shuffle filter on one block (bitshuffle library
    semantics: bit b of byte-lane j of all elements stored contiguously;
    the non-multiple-of-8-elements tail is stored unshuffled)."""
    nelem = len(buf) // typesize
    n8 = nelem - nelem % 8
    main = n8 * typesize
    if n8 == 0:
        return buf
    # stored layout: (typesize, 8 bit positions, n8/8 bytes)
    arr = np.frombuffer(buf, dtype=np.uint8, count=main).reshape(typesize * 8, n8 // 8)
    bits = np.unpackbits(arr, axis=1, bitorder="little")  # (T*8, n8)
    bits = bits.reshape(typesize, 8, n8).transpose(2, 0, 1)  # (n8, T, 8)
    out = np.packbits(bits, axis=2, bitorder="little").reshape(n8, typesize).tobytes()
    if main != len(buf):
        out += buf[main:]
    return out


def _decode_blosc(raw: bytes) -> bytes:
    """
    Decode a c-blosc1 frame (the default codec of every zarr store the
    reference ecosystem writes, numcodecs.Blosc). Frame layout
    (c-blosc blosc.c): 16-byte header [version, versionlz, flags, typesize,
    nbytes u32, blocksize u32, cbytes u32], then (unless memcpyed) one u32
    start offset per block; each block holds `nsplits` sub-streams, each
    prefixed by an i32 compressed size (== stream size means stored raw).
    Byte-shuffle is undone per block after stream reassembly.
    """
    import struct

    from .._native import lz4_decompress

    if len(raw) < 16:
        raise DataValidationError("truncated blosc frame")
    flags, typesize = raw[2], raw[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", raw, 4)
    if nbytes == 0:
        return b""
    doshuffle = bool(flags & 0x1)
    memcpyed = bool(flags & 0x2)
    bitshuffle = bool(flags & 0x4)
    dont_split = bool(flags & 0x10)
    compcode = (flags & 0xE0) >> 5  # 0 blosclz 1 lz4 2 snappy 3 zlib 4 zstd
    if memcpyed:
        return raw[16 : 16 + nbytes]

    nblocks = (nbytes + blocksize - 1) // blocksize
    leftover = nbytes % blocksize
    bstarts = struct.unpack_from("<%dI" % nblocks, raw, 16)

    def _stream(chunk: bytes, out_size: int) -> bytes:
        if compcode == 1:  # lz4 / lz4hc share the block format
            return lz4_decompress(chunk, out_size)
        if compcode == 3:
            return zlib.decompress(chunk)
        if compcode == 4:
            import zstandard

            return zstandard.ZstdDecompressor().decompress(chunk, max_output_size=out_size)
        raise DependencyError(
            f"blosc inner compressor code {compcode} not supported by zarr-lite",
            details="supported: lz4/lz4hc, zlib, zstd",
            suggestions=["Install the 'zarr' package to read this store"],
        )

    out = bytearray(nbytes)
    pos = 0
    for j in range(nblocks):
        leftoverblock = j == nblocks - 1 and leftover != 0
        bsize = leftover if leftoverblock else blocksize
        # split rule mirrors c-blosc1 blosc_d: the compressor records
        # non-splitting codecs via the dont_split header bit
        if 0 < typesize <= 16 and blocksize // max(typesize, 1) >= 128 and not leftoverblock and not dont_split:
            nsplits = typesize
        else:
            nsplits = 1
        neblock = bsize // nsplits
        off = int(bstarts[j])
        block = bytearray(bsize)
        tpos = 0
        for _ in range(nsplits):
            (cb,) = struct.unpack_from("<i", raw, off)
            off += 4
            if cb == neblock:
                block[tpos : tpos + neblock] = raw[off : off + neblock]
            else:
                block[tpos : tpos + neblock] = _stream(raw[off : off + cb], neblock)
            off += cb
            tpos += neblock
        if doshuffle and typesize > 1:
            out[pos : pos + bsize] = _unshuffle(bytes(block), typesize)
        elif bitshuffle:
            out[pos : pos + bsize] = _bitunshuffle(bytes(block), typesize)
        else:
            out[pos : pos + bsize] = block
        pos += bsize
    return bytes(out)


def _decompress(raw: bytes, compressor: Optional[Dict[str, Any]]) -> bytes:
    if compressor is None:
        return raw
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.decompress(raw)
    if cid == "gzip":
        import gzip

        return gzip.decompress(raw)
    if cid == "blosc":
        return _decode_blosc(raw)
    if cid == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(raw)
    if has_dependency("zarr"):
        import numcodecs  # type: ignore

        return numcodecs.get_codec(compressor).decode(raw)
    raise DependencyError(
        f"Unsupported zarr compressor '{cid}'",
        details="zarr-lite decodes zlib/gzip/blosc(lz4,zlib,zstd)/zstd/raw chunks natively",
        suggestions=["Install the 'zarr' package to read this store", "Re-write the store with zlib compression"],
        context={"compressor": compressor},
    )


class LazyZarrArray:
    """
    Lazy ndarray-like view of one zarr v2 array: only the chunks intersecting
    a requested hyperslab are read and decompressed, so slicing a spatial
    tile out of a larger-than-RAM store touches a bounded set of chunk files
    — the zero-dependency analogue of a dask-backed zarr array (the
    reference's ingest substrate, detect.py:558-568).

    Supports basic indexing with integers and slices (no steps, no fancy
    indexing), ``np.asarray`` (full read), and the shape/dtype/ndim protocol
    that :class:`~marex_tpu_torch.core.field.Field` requires of a payload.
    """

    def __init__(self, apath: str):
        self.apath = apath
        with open(os.path.join(apath, ".zarray")) as f:
            meta = json.load(f)
        self.shape: Tuple[int, ...] = tuple(meta["shape"])
        self.chunks: Tuple[int, ...] = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self._comp = meta.get("compressor")
        self._sep = meta.get("dimension_separator", ".")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    def _read_box(self, starts: Tuple[int, ...], stops: Tuple[int, ...]) -> np.ndarray:
        out_shape = tuple(b - a for a, b in zip(starts, stops))
        out = np.zeros(out_shape, dtype=self.dtype)
        if any(s == 0 for s in out_shape):
            return out

        import itertools

        grids = [range(a // c, -(-b // c)) for a, b, c in zip(starts, stops, self.chunks)]
        for gi in itertools.product(*grids):
            key = self._sep.join(str(i) for i in gi)
            fpath = os.path.join(self.apath, key)
            c_lo = tuple(i * c for i, c in zip(gi, self.chunks))
            # intersection of chunk box and request box
            lo = tuple(max(a, cl) for a, cl in zip(starts, c_lo))
            hi = tuple(min(b, cl + c) for b, cl, c in zip(stops, c_lo, self.chunks))
            dst = tuple(slice(a - s, b - s) for a, b, s in zip(lo, hi, starts))
            if not os.path.exists(fpath):
                continue  # missing chunk = fill_value (zeros)
            with open(fpath, "rb") as f:
                block = np.frombuffer(_decompress(f.read(), self._comp), dtype=self.dtype).reshape(self.chunks)
            src = tuple(slice(a - cl, b - cl) for a, b, cl in zip(lo, hi, c_lo))
            out[dst] = block[src]
        return out

    def __getitem__(self, idx: Any) -> np.ndarray:
        if not isinstance(idx, tuple):
            idx = (idx,)
        if any(i is Ellipsis for i in idx):
            n_explicit = sum(i is not Ellipsis for i in idx)
            pos = idx.index(Ellipsis)
            idx = idx[:pos] + (slice(None),) * (self.ndim - n_explicit) + idx[pos + 1 :]
        idx = idx + (slice(None),) * (self.ndim - len(idx))
        starts, stops, squeeze = [], [], []
        for ax, (i, n) in enumerate(zip(idx, self.shape)):
            if isinstance(i, (int, np.integer)):
                i = int(i)
                if i < 0:
                    i += n
                if not (0 <= i < n):
                    raise IndexError(f"index {i} out of bounds for axis {ax} with size {n}")
                starts.append(i)
                stops.append(i + 1)
                squeeze.append(ax)
            elif isinstance(i, slice):
                if i.step not in (None, 1):
                    raise IndexError("LazyZarrArray supports only contiguous slices (step 1)")
                a, b, _ = i.indices(n)
                starts.append(a)
                stops.append(max(a, b))
            else:
                raise IndexError(f"LazyZarrArray does not support index {i!r}; read a block first")
        out = self._read_box(tuple(starts), tuple(stops))
        if squeeze:
            out = out.reshape(tuple(s for ax, s in enumerate(out.shape) if ax not in squeeze))
        return out

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        if not self.shape:
            with open(os.path.join(self.apath, "0"), "rb") as f:
                arr = np.frombuffer(_decompress(f.read(), self._comp), dtype=self.dtype).reshape(())
        else:
            arr = self._read_box((0,) * self.ndim, self.shape)
        return arr.astype(dtype) if dtype is not None else arr

    def astype(self, dtype) -> np.ndarray:
        return self.__array__(dtype)

    def __repr__(self) -> str:  # pragma: no cover
        return f"LazyZarrArray(shape={self.shape}, chunks={self.chunks}, dtype={self.dtype}, path={self.apath!r})"


def _read_array(apath: str, lazy: bool = False) -> Tuple[Any, List[str], Dict[str, Any]]:
    attrs: Dict[str, Any] = {}
    zattrs_path = os.path.join(apath, ".zattrs")
    if os.path.exists(zattrs_path):
        with open(zattrs_path) as f:
            attrs = json.load(f)

    handle = LazyZarrArray(apath)
    dims = attrs.pop("_ARRAY_DIMENSIONS", [f"dim_{i}" for i in range(handle.ndim)])
    if lazy and handle.ndim:
        return handle, dims, attrs
    return np.asarray(handle), dims, attrs


def _decode_cf_time(arr: np.ndarray, attrs: Dict[str, Any]) -> np.ndarray:
    units = attrs.get("units", "")
    if not isinstance(units, str) or " since " not in units:
        return arr
    unit, _, epoch = units.partition(" since ")
    unit_map = {
        "nanoseconds": "ns",
        "microseconds": "us",
        "milliseconds": "ms",
        "seconds": "s",
        "minutes": "m",
        "hours": "h",
        "days": "D",
    }
    pd_unit = unit_map.get(unit.strip().lower())
    if pd_unit is None:
        return arr
    try:
        origin = pd.Timestamp(epoch.strip())
        return (origin + pd.to_timedelta(arr.astype("float64"), unit=pd_unit)).to_numpy()
    except Exception:
        return arr


def open_zarr(path: str, chunks: Optional[Dict[str, int]] = None, lazy: Optional[bool] = None) -> FieldSet:
    """
    Open a zarr v2 group as a FieldSet.

    With ``chunks`` (any dask-style mapping) or ``lazy=True``, data variables
    are returned LAZILY: each ``Field`` wraps a :class:`LazyZarrArray` whose
    slices read only the intersecting chunk files — the larger-than-memory
    ingest path (the reference opens everything through chunked dask,
    README.md:161). Coordinates (and CF-time variables) are always decoded
    eagerly; ``field.values`` on a lazy payload materialises the full array.
    """
    if not os.path.isdir(path):
        raise DataValidationError(f"Not a zarr store: {path}")
    want_lazy = bool(lazy) or chunks is not None

    group_attrs: Dict[str, Any] = {}
    gattrs = os.path.join(path, ".zattrs")
    if os.path.exists(gattrs):
        with open(gattrs) as f:
            group_attrs = json.load(f)

    arrays: Dict[str, Tuple[Any, List[str], Dict[str, Any]]] = {}
    for name in sorted(os.listdir(path)):
        apath = os.path.join(path, name)
        if os.path.isdir(apath) and os.path.exists(os.path.join(apath, ".zarray")):
            arrays[name] = _read_array(apath, lazy=want_lazy)

    # split coords vs data vars: 1-D arrays named after their dim, or listed
    # in any variable's "coordinates" attribute
    coord_names = set()
    for name, (arr, dims, attrs) in arrays.items():
        if list(dims) == [name]:
            coord_names.add(name)
        for c in str(attrs.get("coordinates", "")).split():
            coord_names.add(c)

    coords: Dict[str, Coord] = {}
    data_vars: Dict[str, Field] = {}
    for name, (arr, dims, attrs) in arrays.items():
        if name in coord_names or "since" in str(attrs.get("units", "")):
            arr = np.asarray(arr)  # coords & CF-time are always eager
        if "since" in str(attrs.get("units", "")):
            arr = _decode_cf_time(arr, attrs)
            attrs = {k: v for k, v in attrs.items() if k not in ("units", "calendar")}
        if name in coord_names:
            coords[name] = Coord(tuple(dims), arr)
        else:
            data_vars[name] = Field(arr, tuple(dims), name=name, attrs=attrs)

    # attach group coords to each variable whose dims cover them (xarray behaviour)
    for name, fld in data_vars.items():
        fld_dims = set(fld.dims)
        for cname, coord in coords.items():
            if set(coord.dims) <= fld_dims:
                fld.coords.setdefault(cname, coord)

    fs = FieldSet(data_vars, coords, group_attrs)
    return fs
