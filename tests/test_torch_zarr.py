"""The port's zarr store (``marex_tpu_torch/io/zarr_lite.py``), its LZ4
binding and its lazy ``Field`` payloads.

Round trips for every dtype through raw and zlib chunks and datetime
coordinates; region writes, their alignment error and the rejection of fancy
indexing; stores written by ``marex_tpu.io.zarr_lite`` read back bit for bit
by the port's and the reverse (the files themselves are identical); the
native LZ4 decoder against the Python one on hand-made blocks; ``concat``
and a lazy payload that stays lazy; zero-size arrays (the tables of a run
with no event).
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import marex_tpu_torch as port
from marex_tpu.core.field import Field as RefField
from marex_tpu.io import zarr_lite as ref_zl
from marex_tpu_torch import _native
from marex_tpu_torch.io import zarr_lite as zl

DTYPES = [bool, np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.int64, np.float32, np.float64]


def _values(dtype, shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "b":
        return rng.random(shape) < 0.4
    if np.dtype(dtype).kind == "f":
        v = rng.standard_normal(shape).astype(dtype)
        v.flat[::7] = np.nan
        return v
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), shape).astype(dtype)


def _files(path: str) -> dict:
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), path)] = f.read()
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("compressor", [None, "zlib"])
def test_region_round_trip_every_dtype(tmp_path, dtype, compressor):
    arr = _values(dtype, (23, 10, 12))
    q = str(tmp_path / "s.zarr")
    zl.create_group(q, {"a": 1})
    zl.create_array(q, "v", arr.shape, dtype, ("t", "y", "x"), (8, 5, 12), compressor=compressor)
    for t0 in range(0, 23, 8):
        for y0 in (0, 5):
            zl.write_region(q, "v", (t0, y0, 0), arr[t0 : t0 + 8, y0 : y0 + 5])
    back = zl.open_zarr(q)
    got = back["v"].values
    assert got.dtype == np.dtype(dtype)
    assert np.array_equal(got, arr, equal_nan=got.dtype.kind == "f")
    assert back.attrs == {"a": 1}
    lazy = zl.open_zarr(q, lazy=True)["v"].data
    assert isinstance(lazy, zl.LazyZarrArray)
    assert np.array_equal(lazy[3:19, 2:9, 1:], arr[3:19, 2:9, 1:], equal_nan=got.dtype.kind == "f")


def test_to_zarr_round_trip_with_datetimes_and_tensors(tmp_path):
    times = pd.date_range("1999-12-30", periods=40, freq="D").to_numpy()
    data = torch.from_numpy(_values(np.float32, (40, 6, 8), seed=3))
    f = port.Field(data, ("time", "lat", "lon"),
                   {"time": times, "lat": np.linspace(-10, 10, 6), "lon": np.arange(8.0)}, name="sst",
                   attrs={"units": "degC"})
    q = str(tmp_path / "t.zarr")
    zl.to_zarr(port.FieldSet({"sst": f}, attrs={"title": "x"}), q, chunks={"time": 16})
    back = zl.open_zarr(q, lazy=True)
    assert back.attrs == {"title": "x"}
    assert back["sst"].attrs == {"units": "degC"}
    assert back["sst"].data.chunks == (16, 6, 8)
    np.testing.assert_array_equal(back.coords["time"].values.astype("datetime64[ns]"), times.astype("datetime64[ns]"))
    assert np.array_equal(np.asarray(back["sst"].values), data.numpy(), equal_nan=True)


@pytest.mark.parametrize("chunks", [None, {"ID": 4}], ids=["default chunks", "chunked"])
def test_zero_size_arrays_round_trip(tmp_path, chunks):
    """A run with no event has (time, 0) tables: written with no chunk file
    along the empty dim and read back, eagerly and lazily."""
    empty = port.Field(np.zeros((5, 0), np.float32), ("time", "ID"), name="area")
    q = str(tmp_path / "e.zarr")
    zl.to_zarr(port.FieldSet({"area": empty, "ids": port.Field(np.arange(3), ("x",), name="ids")}), q, chunks=chunks)
    for lazy in (False, True):
        back = zl.open_zarr(q, lazy=lazy)
        assert back["area"].shape == (5, 0) and np.asarray(back["area"].values).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(back["ids"].values), np.arange(3))


def test_region_write_alignment_and_fancy_indexing(tmp_path):
    q = str(tmp_path / "align.zarr")
    zl.create_group(q)
    zl.create_array(q, "out", (10, 10), np.float32, ("y", "x"), (4, 10))
    with pytest.raises(port.DataValidationError):
        zl.write_region(q, "out", (3, 0), np.zeros((4, 10), np.float32))
    with pytest.raises(port.DataValidationError):  # a mid-chunk end that is not the array's edge
        zl.write_region(q, "out", (0, 0), np.zeros((3, 10), np.float32))
    zl.write_region(q, "out", (8, 0), np.ones((2, 10), np.float32))  # the edge block is fine
    lazy = zl.open_zarr(q, lazy=True)["out"].data
    np.testing.assert_array_equal(lazy[8:], np.ones((2, 10), np.float32))
    np.testing.assert_array_equal(lazy[:8], np.zeros((8, 10), np.float32))  # unwritten chunks read as zeros
    with pytest.raises(IndexError):
        lazy[[0, 2, 4]]
    with pytest.raises(IndexError):
        lazy[::2]


def test_region_writer_writes_in_the_background(tmp_path):
    q = str(tmp_path / "w.zarr")
    arr = _values(np.int32, (30, 4, 5))
    zl.create_group(q)
    zl.create_array(q, "v", arr.shape, np.int32, ("t", "y", "x"), (7, 4, 5))
    with zl.RegionWriter(workers=3, max_pending=2) as w:
        for t0 in range(0, 30, 7):
            w.write(q, "v", (t0, 0, 0), torch.from_numpy(arr[t0 : t0 + 7].copy()))
    np.testing.assert_array_equal(zl.open_zarr(q)["v"].values, arr)
    with pytest.raises(port.DataValidationError):
        with zl.RegionWriter() as w:
            w.write(q, "v", (3, 0, 0), arr[:7])
            w.flush()


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_stores_cross_between_packages_bit_for_bit(tmp_path, direction):
    times = pd.date_range("2001-01-01", periods=25, freq="D").to_numpy()
    coords = {"time": times, "lat": np.linspace(-30, 30, 9), "lon": np.linspace(0, 350, 12)}
    vals = {"sst": _values(np.float32, (25, 9, 12), 1), "ext": _values(bool, (25, 9, 12), 2),
            "ids": _values(np.int32, (25, 9, 12), 3)}
    ref_set = {k: RefField(v, ("time", "lat", "lon"), coords, name=k) for k, v in vals.items()}
    port_set = {k: port.Field(v, ("time", "lat", "lon"), coords, name=k) for k, v in vals.items()}
    from marex_tpu.core.field import FieldSet as RefFieldSet

    a, b = str(tmp_path / "ref.zarr"), str(tmp_path / "port.zarr")
    ref_zl.to_zarr(RefFieldSet(ref_set, attrs={"k": 2}), a, chunks={"time": 10, "lat": 4})
    zl.to_zarr(port.FieldSet(port_set, attrs={"k": 2}), b, chunks={"time": 10, "lat": 4})
    assert _files(a) == _files(b)  # the same bytes, file by file
    src, reader = (a, zl) if direction == "reference_to_port" else (b, ref_zl)
    back = reader.open_zarr(src, lazy=True)
    for k, v in vals.items():
        got = np.asarray(back[k].values)
        assert got.dtype == v.dtype and np.array_equal(got, v, equal_nan=v.dtype.kind == "f"), k
        assert np.array_equal(back[k].data[4:17, 2:7, 3], v[4:17, 2:7, 3], equal_nan=v.dtype.kind == "f"), k
    assert back.attrs == {"k": 2}
    # region stores too: metadata and chunk files alike
    for mod, path in ((ref_zl, str(tmp_path / "r2.zarr")), (zl, str(tmp_path / "p2.zarr"))):
        mod.create_group(path)
        mod.create_array(path, "v", (25, 9), np.float32, ("t", "c"), (10, 9), compressor=None)
        for t0 in range(0, 25, 10):
            mod.write_region(path, "v", (t0, 0), vals["sst"][t0 : t0 + 10, :, 0])
    assert _files(str(tmp_path / "r2.zarr")) == _files(str(tmp_path / "p2.zarr"))


LZ4_BLOCKS = [
    # literals only: token 0x50 then five literal bytes
    (bytes([0x50]) + b"hello", 5, b"hello"),
    # one literal 'a', then a match at offset 1 of length 4 + 15 + 3 = 22 (an overlapping copy)
    (bytes([0x1F]) + b"a" + bytes([1, 0, 3]), 23, b"a" * 23),
    # two literals, an overlapping match (offset 2, length 6), then literals only
    (bytes([0x22]) + b"ab" + bytes([2, 0]) + bytes([0x30]) + b"xyz", 11, b"abababab" + b"xyz"),
    # a long literal run (15 + 255 + 10 bytes)
    (bytes([0xF0, 255, 10]) + bytes(range(256)) + bytes(range(24)), 280, bytes(range(256)) + bytes(range(24))),
]


@pytest.mark.parametrize("block, size, want", LZ4_BLOCKS, ids=["literals", "run", "overlap", "long_literals"])
def test_lz4_native_matches_python(block, size, want):
    assert _native.has_native()  # the host library builds here (g++)
    assert _native.lz4_decompress(block, size) == want
    assert _native.lz4_decompress_plain(block, size) == want
    with pytest.raises(ValueError):  # an offset before the start of the output
        _native.lz4_decompress(bytes([0x14]) + b"a" + bytes([5, 0]), 16)
    with pytest.raises(ValueError):
        _native.lz4_decompress_plain(bytes([0x14]) + b"a" + bytes([5, 0]), 16)


def test_blosc_lz4_frame_decodes(tmp_path):
    """A hand-made blosc frame (byte shuffle, one lz4 stream a split) read
    through a store, as external zarr stores are."""
    import json
    import struct

    arr = np.arange(128, dtype=np.int32).reshape(8, 16)  # 128 elements: blosc splits the block by byte lane
    raw = arr.tobytes()
    shuffled = np.frombuffer(raw, np.uint8).reshape(-1, 4).T.tobytes()  # blosc's byte shuffle
    n = len(raw)
    streams = b""
    for k in range(4):  # one split a byte lane; each stream stores its 128 bytes as lz4 literals
        part = shuffled[k * 128 : (k + 1) * 128]
        lz = bytes([0xF0, 128 - 15]) + part
        streams += struct.pack("<i", len(lz)) + lz
    header = bytes([2, 1, 0x1 | (1 << 5), 4]) + struct.pack("<III", n, n, 16 + 4 + len(streams))
    frame = header + struct.pack("<I", 20) + streams
    q = str(tmp_path / "b.zarr")
    os.makedirs(os.path.join(q, "v"))
    with open(os.path.join(q, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    meta = {"zarr_format": 2, "shape": [8, 16], "chunks": [8, 16], "dtype": "<i4", "order": "C", "filters": None,
            "fill_value": None, "compressor": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}}
    with open(os.path.join(q, "v", ".zarray"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(q, "v", ".zattrs"), "w") as f:
        json.dump({"_ARRAY_DIMENSIONS": ["y", "x"]}, f)
    with open(os.path.join(q, "v", "0.0"), "wb") as f:
        f.write(frame)
    np.testing.assert_array_equal(zl.open_zarr(q)["v"].values, arr)
    np.testing.assert_array_equal(ref_zl.open_zarr(q).data_vars["v"].values, arr)


def test_lazy_payload_stays_lazy_and_concat(tmp_path):
    arr = _values(np.float32, (12, 3, 4), seed=5)
    q = str(tmp_path / "c.zarr")
    zl.to_zarr(port.Field(arr, ("time", "y", "x"), name="v"), q, chunks={"time": 5})
    f = zl.open_zarr(q, lazy=True)["v"]
    assert isinstance(f.data, zl.LazyZarrArray) and f.shape == (12, 3, 4) and f.dtype == np.float32
    assert isinstance(f.compute().data, np.ndarray)
    np.testing.assert_array_equal(f.compute().data, arr)
    parts = [port.Field(torch.from_numpy(arr[:5]), ("time", "y", "x"), name="v"),
             port.Field(torch.from_numpy(arr[5:]), ("time", "y", "x"), name="v")]
    joined = port.concat(parts, "time")
    assert isinstance(joined.data, torch.Tensor) and joined.dims == ("time", "y", "x")
    np.testing.assert_array_equal(joined.data.numpy(), arr)
    stacked = port.concat([f, port.Field(arr, ("time", "y", "x"), name="v")], "member")
    assert stacked.dims == ("member", "time", "y", "x") and stacked.shape == (2, 12, 3, 4)
    np.testing.assert_array_equal(stacked.values[0], arr)


def test_dependency_registry_probes_packages_and_nvcc(tmp_path, monkeypatch):
    from marex_tpu_torch import _dependencies as deps

    monkeypatch.setattr(deps, "_availability_cache", {})
    assert deps.has_dependency("torch") and deps.has_dependency("numpy")
    assert {"torch", "numpy", "pandas"} <= set(deps.REQUIRED_DEPENDENCIES)
    assert {"triton", "nvcc"} <= set(deps.get_dependency_status())
    # nvcc is a program: found under $CUDA_HOME/bin when it is not on PATH
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    assert not deps.has_dependency("nvcc")
    with pytest.raises(port.DependencyError, match="nvcc"):
        deps.require_dependencies(["nvcc"], "the CUDA kernels")
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    (tmp_path / "cuda" / "bin" / "nvcc").write_text("#!/bin/sh\n")
    (tmp_path / "cuda" / "bin" / "nvcc").chmod(0o755)
    monkeypatch.setattr(deps, "_availability_cache", {})
    assert deps.has_dependency("nvcc")
    assert deps.get_installation_profile() in deps.INSTALLATION_PROFILES
