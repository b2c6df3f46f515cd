"""Streamed tracking of the PyTorch port (``tracker.run_streamed``), after
``tests/test_streaming.py::TestStreamedTracking``: merge tracking of a field
read block by block from a lazy zarr store, through the per-step march over
a windowed label store.

On a grid and on a mesh, in at least four blocks, the streamed run equals
the port's own ``run()`` bit for bit: ids, the (time, ID) tables, areas and
centroids, the ledger, the times, every merge record and every attr. On the
grid it is also held against ``marex_tpu``'s tracker (per-step march) like
``tests/test_torch_merge.py``. A block edge inside a gap of ``T_fill`` days
is closed as in the whole field, a no-merge tracker is refused, and a block
of one slice and a block of the whole series give the same events.
"""

import pathlib

import numpy as np
import pandas as pd
import pytest

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu_torch.core.field import Coord, from_reference
from marex_tpu_torch.io import zarr_lite

from .conftest import make_unstructured_mesh
from .test_torch_merge import assert_equal_runs
from .torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRID_KW = dict(R_fill=2, T_fill=2, area_filter_quartile=0.5, allow_merging=True, nn_partitioning=True,
               overlap_threshold=0.3, quiet=True)
TABLES = ("ID_field", "global_ID", "presence", "merge_ledger", "time_start", "time_end", "area", "centroid")


def grid_field(T=50, NY=48, NX=180, n_pairs=4, seed=7):
    """``TestStreamedTracking._field``: disk pairs that converge, merge and
    part every 20 days."""
    data = np.zeros((T, NY, NX), bool)
    yy, xx = np.mgrid[0:NY, 0:NX]
    rng = np.random.default_rng(seed)
    centers = [(int(rng.integers(NY // 5, 4 * NY // 5)), int(rng.integers(0, NX))) for _ in range(n_pairs)]
    r = 5
    for t in range(T):
        phase = (t % 20) / 20.0
        sep = int((1.0 - min(phase * 2, 1.0)) * 3 * r) + r
        for cy, cx0 in centers:
            for s in (-sep, sep):
                cx = (cx0 + s) % NX
                dx = np.minimum(np.abs(xx - cx), NX - np.abs(xx - cx))
                data[t] |= (yy - cy) ** 2 + dx**2 <= r * r
    coords = {
        "time": pd.date_range("2021-01-01", periods=T, freq="D").to_numpy(),
        "lat": np.linspace(-40, 40, NY),
        "lon": np.linspace(0, 360, NX, endpoint=False),
    }
    return data, coords


def port_fields(data, coords):
    ev = port.Field(data, ("time", "lat", "lon"), coords, name="extreme_events")
    mask = port.Field(np.ones(data.shape[1:], bool), ("lat", "lon"), {"lat": coords["lat"], "lon": coords["lon"]},
                      name="mask")
    return ev, mask


def lazy_input(tmp_path, ev, chunk):
    """``ev`` written to a zarr store and opened lazily."""
    src = str(tmp_path / "extremes.zarr")
    zarr_lite.to_zarr(ev, src, chunks={"time": chunk})
    return zarr_lite.open_zarr(src, lazy=True)["extreme_events"]


def assert_same_run(mem, streamed, attrs_except=()):
    (m_ev, m_mg), (s_ev, s_mg) = mem, streamed
    for name in TABLES:
        a, b = np.asarray(m_ev[name].values), np.asarray(s_ev[name].values)
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, name
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), f"{name}: {int(np.sum(a != b))} values differ"
        assert m_ev[name].dims == s_ev[name].dims, name
    for name in m_mg.data_vars:
        assert np.array_equal(m_mg[name].values, s_mg[name].values), name
    got = {k: v for k, v in s_ev.attrs.items() if k not in attrs_except}
    assert got == m_ev.attrs


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    data, coords = grid_field()
    ev, mask = port_fields(data, coords)
    mem = port.tracker(ev, mask, device="cpu", **GRID_KW).run(return_merges=True)
    tr = port.tracker(lazy_input(tmp, ev, 10), mask, device="cpu", temp_dir=str(tmp / "work"), **GRID_KW)
    streamed = tr.run_streamed(str(tmp / "events.zarr"), block_T=13, return_merges=True)
    return data, coords, mem, streamed, tr


def test_grid_streamed_equals_in_memory(grid_runs):
    _, _, mem, streamed, tr = grid_runs
    assert tr.dispatch_counts["march_block"] == 4  # 50 days in blocks of 13
    assert streamed[0].attrs["total_merges"] == mem[0].attrs["total_merges"] > 0
    assert_same_run(mem, streamed)
    assert isinstance(streamed[0]["ID_field"].data, zarr_lite.LazyZarrArray)  # backed by the store
    assert isinstance(streamed[0]["global_ID"].data, zarr_lite.LazyZarrArray)
    assert not list(pathlib.Path(tr.temp_dir).glob("marex_trkstream_*"))  # the temporary stores are gone


def test_grid_streamed_matches_reference(grid_runs):
    data, coords, _, streamed, _ = grid_runs
    from marex_tpu.core.field import Field as RefField

    r_ev = RefField(data, ("time", "lat", "lon"), coords, name="extreme_events")
    r_mask = RefField(np.ones(data.shape[1:], bool), ("lat", "lon"), {"lat": coords["lat"], "lon": coords["lon"]},
                      name="mask")
    r_tr = ref.tracker(r_ev, r_mask, **GRID_KW)
    r_tr.use_scan_march = False
    assert_equal_runs(r_tr.run(return_merges=True), streamed)


@pytest.fixture(scope="module")
def short_grid():
    data, coords = grid_field(T=24)
    ev, mask = port_fields(data, coords)
    return ev, mask, port.tracker(ev, mask, device="cpu", **GRID_KW).run(return_merges=True)


@pytest.mark.parametrize("block_T", [1, 24])
def test_grid_streamed_block_lengths_agree(tmp_path, short_grid, block_T):
    """A block of one slice (the window at its narrowest: each step pages a
    block in and retires one) and one block of the whole series."""
    ev, mask, mem = short_grid
    assert mem[0].attrs["total_merges"] > 0
    tr = port.tracker(ev, mask, device="cpu", temp_dir=str(tmp_path), **GRID_KW)
    streamed = tr.run_streamed(str(tmp_path / "events.zarr"), block_T=block_T, return_merges=True)
    assert tr.dispatch_counts["march_block"] == -(-24 // block_T)
    assert_same_run(mem, streamed)


def test_block_edge_inside_a_time_gap(tmp_path):
    """A blob with a gap of T_fill days whose first gap day opens a block:
    the block's halo closes the gap exactly as the whole field does."""
    T, NY, NX = 24, 20, 40
    data = np.zeros((T, NY, NX), bool)
    yy, xx = np.mgrid[0:NY, 0:NX]
    blob = (yy - 10) ** 2 + (xx - 20) ** 2 <= 16
    other = (yy - 5) ** 2 + (xx - 5) ** 2 <= 9
    for t in list(range(0, 8)) + list(range(10, 24)):  # absent on days 8 and 9
        data[t] |= blob
    data[3:20] |= other
    coords = {"time": pd.date_range("2000-01-01", periods=T, freq="D").to_numpy(), "lat": np.linspace(-30, 30, NY),
              "lon": np.linspace(0, 360, NX, endpoint=False)}
    ev, mask = port_fields(data, coords)
    kw = dict(R_fill=1, T_fill=2, area_filter_absolute=4, allow_merging=True, overlap_threshold=0.3, quiet=True)
    mem = port.tracker(ev, mask, device="cpu", **kw).run(return_merges=True)
    ids = mem[0]["ID_field"].values
    assert (ids[8:10, 10, 20] > 0).all()  # the gap is closed: the blob's centre is labelled on days 8 and 9
    assert ids[7, 10, 20] == ids[8, 10, 20] == ids[10, 10, 20]
    for block_T in (8, 9):  # the edge on the gap's first day, then on its second
        tr = port.tracker(lazy_input(tmp_path, ev, 4), mask, device="cpu", temp_dir=str(tmp_path), **kw)
        streamed = tr.run_streamed(str(tmp_path / f"events{block_T}.zarr"), block_T=block_T, return_merges=True)
        assert tr.dispatch_counts["march_block"] >= 3
        assert_same_run(mem, streamed)


def test_streamed_rejects_no_merge(tmp_path):
    data, coords = grid_field(T=12)
    ev, mask = port_fields(data, coords)
    tr = port.tracker(ev, mask, R_fill=1, T_fill=0, area_filter_quartile=0.0, allow_merging=False, quiet=True,
                      device="cpu")
    with pytest.raises(port.ConfigurationError, match="allow_merging"):
        tr.run_streamed(str(tmp_path / "x.zarr"))


def test_mesh_streamed_equals_in_memory(tmp_path):
    """``TestStreamedTracking``'s mesh case: patch pairs on a Delaunay mesh
    of 28 x 28 points, cell areas as weights, blocks of 13 days."""
    lat_c, lon_c, nb, areas = make_unstructured_mesh(n_side=28, seed=5)
    C = len(lat_c)
    T = 40
    data = np.zeros((T, C), bool)
    for t in range(T):
        phase = (t % 20) / 20.0
        sep = (1.0 - min(phase * 2, 1.0)) * 24 + 8
        for band, lonc0 in ((20, 80), (-20, 250)):
            for s in (-sep, sep):
                d = np.abs(lon_c - (lonc0 + s))
                data[t] |= (np.abs(lat_c - band) < 14) & (d < 16)
    coords = {"time": pd.date_range("2019-01-01", periods=T, freq="D").to_numpy(),
              "lat": Coord("ncells", lat_c), "lon": Coord("ncells", lon_c)}
    ev = port.Field(data, ("time", "ncells"), coords, name="extreme_events")
    mask = port.Field(np.ones(C, bool), ("ncells",), {"lat": Coord("ncells", lat_c), "lon": Coord("ncells", lon_c)},
                      name="mask")
    kw = dict(R_fill=1, T_fill=2, area_filter_absolute=1, allow_merging=True, nn_partitioning=True,
              overlap_threshold=0.3, unstructured_grid=True, dimensions={"x": "ncells"},
              coordinates={"x": "lon", "y": "lat"}, coordinate_units="degrees", quiet=True, device="cpu",
              neighbours=port.Field(nb, ("nv", "ncells"), name="neighbours"),
              cell_areas=port.Field(areas, ("ncells",), name="cell_areas"))
    mem = port.tracker(ev, mask, **kw).run(return_merges=True)
    tr = port.tracker(lazy_input(tmp_path, ev, 10), mask, temp_dir=str(tmp_path), **kw)
    streamed = tr.run_streamed(str(tmp_path / "events.zarr"), block_T=13, return_merges=True)
    assert tr.dispatch_counts["march_block"] == 4
    assert streamed[0].attrs["total_merges"] == mem[0].attrs["total_merges"] > 0
    # the store's aux coordinates come back as the data's "coordinates" attr
    assert_same_run(mem, streamed, attrs_except=("coordinates",))


def test_streamed_input_stays_lazy_and_budget_sets_blocks(tmp_path, grid_runs):
    from marex_tpu_torch.track_stream import block_length

    data, coords, _, _, _ = grid_runs
    ev, mask = port_fields(data, coords)
    tr = port.tracker(lazy_input(tmp_path, ev, 10), mask, device="cpu", **GRID_KW)
    assert isinstance(tr.data_bin.data, zarr_lite.LazyZarrArray)  # the constructor read nothing
    cells = data.shape[1] * data.shape[2]
    assert block_length(50, cells, 4, 10) == min(50, 10 * 2**20 // (cells * 40) - 8, 10 * 2**20 // (cells * 56))
    assert block_length(50, cells, 4, 1) == 1 and block_length(50, cells, 4, 10**6) == 50
    assert block_length(36500, 720 * 1440, 8, 2048) < block_length(36500, 720 * 1440, 8, 4096) < 365
    events = tr.run_streamed(str(tmp_path / "events.zarr"), memory_budget_mb=10)
    assert tr.stream_block_T == block_length(50, cells, 4, 10) and tr.dispatch_counts["march_block"] == 3
    assert events.attrs["N_events_final"] > 0


def test_streamed_detect_then_streamed_tracking(tmp_path):
    """The out-of-core pipeline end to end: detect streamed into a store,
    its lazy outputs tracked in blocks, against ``preprocess_data`` and
    ``run()`` in memory."""
    from .conftest import make_gridded_sst

    sst = from_reference(make_gridded_sst(n_years=3, ny=24, nx=48, seed=4), "cpu")
    det = dict(method_anomaly="fixed_baseline", method_extreme="global_extreme")
    kw = dict(R_fill=2, T_fill=2, area_filter_absolute=8, allow_merging=True, overlap_threshold=0.25, quiet=True)
    ds = port.preprocess_data(sst, device="cpu", quiet=True, **det)
    mem = port.tracker(ds.extreme_events, ds.mask, device="cpu", **kw).run(return_merges=True)
    lazy = port.preprocess_data_streamed(sst, str(tmp_path / "detect.zarr"), row_block=10, device="cpu", **det)
    assert isinstance(lazy.extreme_events.data, zarr_lite.LazyZarrArray)
    tr = port.tracker(lazy.extreme_events, lazy.mask, device="cpu", temp_dir=str(tmp_path), **kw)
    streamed = tr.run_streamed(str(tmp_path / "events.zarr"), block_T=200, return_merges=True)
    assert tr.dispatch_counts["march_block"] == 6 and mem[0].attrs["N_events_final"] > 0
    assert_same_run(mem, streamed)
