"""The port's plot preparation (``marex_tpu_torch.plotX.prep``) against numpy
on the CPU: the NaN-ignoring maximum against ``np.nanmax``, the robust colour
limits against ``np.percentile`` bit for bit (``hypothesis`` over sizes, NaN
shares and percentiles), and what the plotters bring to the host from a
tensor-backed and a lazy payload: scalars for the maximum and the limits,
one slice a frame or a panel, numpy only in an animation frame's payload,
and a lazy payload read a chunk at a time."""

import matplotlib

matplotlib.use("Agg")

import pickle  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

import marex_tpu_torch.plotX as port_px  # noqa: E402
import marex_tpu_torch.plotX.base as port_base  # noqa: E402
from marex_tpu.plotX.base import PlotterBase as RefPlotterBase  # noqa: E402
from marex_tpu_torch.core.field import Field  # noqa: E402
from marex_tpu_torch.io import zarr_lite  # noqa: E402
from marex_tpu_torch.plotX import prep  # noqa: E402

T, H, W = 20, 6, 10


def _payload(arr, kind, tmp_path):
    """``arr`` as a numpy, CPU-tensor or lazy zarr payload (chunks of 3 slices)."""
    if kind == "tensor":
        return torch.from_numpy(arr.copy())
    if kind == "lazy":
        path = str(tmp_path / "p.zarr")
        zarr_lite.to_zarr(Field(arr, tuple(f"d{i}" for i in range(arr.ndim)), name="v"), path,
                          chunks={"d0": 3})
        return zarr_lite.open_zarr(path, lazy=True)["v"].data
    return arr.copy()


def _same(got, want):
    """Bit for bit, NaN equal to NaN, with numpy's type."""
    assert type(got) is type(want), (type(got), type(want))
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), (got, want)


ARRAYS = {
    "float32 with NaN": lambda rng: np.where(rng.random((T, H, W)) < 0.3, np.nan, rng.standard_normal((T, H, W))
                                             ).astype(np.float32),
    "float64 all NaN": lambda rng: np.full((T, H, W), np.nan),
    "float32 with inf": lambda rng: np.choose(rng.integers(0, 20, (T, H, W)) % 10,
                                              [np.full((T, H, W), -np.inf), np.full((T, H, W), np.inf)]
                                              + [rng.standard_normal((T, H, W))] * 8).astype(np.float32),
    "int32 ids": lambda rng: rng.integers(0, 40, (T, H, W)).astype(np.int32),
    "int64 negative": lambda rng: -rng.integers(1, 40, (T, H, W)),
    "float32 one slice": lambda rng: rng.standard_normal((1, H, W)).astype(np.float32),
}


def _warned(fn):
    """``fn()`` and the warnings it gave, as (category, message) pairs."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [(w.category, str(w.message)) for w in caught]


@pytest.mark.parametrize("kind", ["numpy", "tensor", "lazy"])
@pytest.mark.parametrize("positive", [False, True], ids=["all", "positive"])
@pytest.mark.parametrize("name", list(ARRAYS))
def test_nanmax_matches_numpy(name, positive, kind, tmp_path):
    """Of a payload and of its ``where(> 0)`` view; all NaN warns and gives NaN."""
    arr = ARRAYS[name](np.random.default_rng(3))
    payload = _payload(arr, kind, tmp_path)
    want, want_warnings = _warned(lambda: np.nanmax(np.where(arr > 0, arr, np.nan) if positive else arr))
    got, got_warnings = _warned(lambda: prep.nanmax(prep.PositiveOnly(payload) if positive else payload))
    _same(got, want)
    assert got_warnings == want_warnings


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_nanmax_of_an_empty_field_raises_as_numpy(dtype):
    empty = np.zeros((0, 4), dtype)
    with pytest.raises(ValueError) as want:
        np.nanmax(empty)
    for payload in (empty, torch.from_numpy(empty)):
        with pytest.raises(ValueError) as got:
            prep.nanmax(payload)
        assert str(got.value) == str(want.value)


PERCENTILES = st.one_of(
    st.just([4, 96]),
    st.lists(st.integers(0, 100), min_size=2, max_size=2),
    st.lists(st.floats(0, 100, allow_nan=False), min_size=2, max_size=2),
)


@settings(max_examples=150, deadline=None)
@given(
    n=st.integers(0, 3000),
    nan_share=st.sampled_from([0.0, 0.1, 0.5, 0.99, 1.0]),
    dtype=st.sampled_from([np.float32, np.float64, np.int32]),
    cperc=PERCENTILES,
    issym=st.booleans(),
    seed=st.integers(0, 2**16),
)
def test_robust_limits_equal_np_percentile(n, nan_share, dtype, cperc, issym, seed):
    """Against the reference's ``clim_robust`` (``np.percentile`` of the
    finite values), bit for bit and type for type."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4)
    if dtype is np.int32:
        vals = np.round(vals * 100).astype(np.int32)
    else:
        vals = np.where(rng.random(n) < nan_share, np.nan, vals).astype(dtype)
    want = RefPlotterBase.clim_robust(vals, issym, cperc)
    for payload in (vals, torch.from_numpy(vals.copy())):
        got = prep.robust_limits(payload, issym, cperc)
        assert len(got) == 2
        for g, w in zip(got, want):
            _same(g, w)
        assert port_px.PlotterBase.clim_robust(payload, issym, cperc) == got


@pytest.mark.parametrize("kind", ["numpy", "tensor", "lazy"])
@pytest.mark.parametrize("name", ["float32 with NaN", "int32 ids", "float32 with inf"])
def test_sampled_robust_limits_match_every_tenth_slice(name, kind, tmp_path):
    arr = ARRAYS[name](np.random.default_rng(5))
    sample = arr[::10]
    want = RefPlotterBase.clim_robust(sample, True, [4, 96]), RefPlotterBase.clim_robust(sample, False, [1, 75])
    payload = _payload(arr, kind, tmp_path)
    got = prep.robust_limits(payload, True, [4, 96], axis=0), prep.robust_limits(payload, False, [1, 75], axis=0)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _same(a, b)
    # along another axis: every tenth column
    _same(prep.robust_limits(payload, False, [4, 96], axis=2)[1],
          RefPlotterBase.clim_robust(arr[:, :, ::10], False, [4, 96])[1])
    # of the where(> 0) view (+inf left out, as non-finite)
    for g, w in zip(prep.robust_limits(prep.PositiveOnly(payload), False, [4, 96], axis=0),
                    RefPlotterBase.clim_robust(np.where(arr > 0, arr, np.nan)[::10], False, [4, 96])):
        _same(g, w)


def test_percentiles_out_of_range_raise_as_numpy():
    vals = np.arange(10.0)
    with pytest.raises(ValueError) as want:
        np.percentile(vals, [4, 101])
    with pytest.raises(ValueError) as got:
        prep.robust_limits(torch.from_numpy(vals), False, [4, 101])
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# what comes to the host
# ---------------------------------------------------------------------------


def _ids_field(payload):
    rng = np.random.default_rng(9)
    ids = np.where(rng.random((T, H, W)) < 0.4, rng.integers(1, 30, (T, H, W)), 0).astype(np.int32)
    coords = {"time": pd.date_range("2000-01-01", periods=T, freq="D").to_numpy(), "lat": np.linspace(-50, 50, H),
              "lon": np.linspace(0, 360, W, endpoint=False)}
    data = torch.from_numpy(ids) if payload == "tensor" else ids
    return Field(data, ("time", "lat", "lon"), coords, name="ID_field"), ids


@pytest.fixture
def pulled():
    prep.pull.bytes = 0
    yield lambda: prep.pull.bytes
    prep.pull.bytes = 0


def test_preparation_brings_back_scalars_and_one_slice(pulled):
    field, ids = _ids_field("tensor")
    slice_bytes = H * W * 4
    assert prep.nanmax(field.data) == ids.max() and pulled() == 4
    prep.pull.bytes = 0
    prep.robust_limits(field.data, True, [4, 96], axis=0)
    assert 0 < pulled() <= 4 * 4  # at most four order statistics
    prep.pull.bytes = 0
    frame = prep.host_frame(field, "time", 7)
    assert isinstance(frame.data, np.ndarray) and pulled() == slice_bytes
    np.testing.assert_array_equal(frame.data, ids[7])
    prep.pull.bytes = 0
    masked = prep.host_frame(field._replace(data=prep.PositiveOnly(field.data)), "time", 7)
    assert pulled() == slice_bytes
    _same(masked.data, np.where(ids[7] > 0, ids[7], np.nan))


def test_plotters_pull_no_whole_field(pulled, tmp_path, monkeypatch):
    field, ids = _ids_field("tensor")
    slice_bytes = H * W * 4
    fig, _, im = field.plotX().single_plot(port_px.PlotConfig(plot_IDs=True))
    assert pulled() == 4 + slice_bytes  # the ID max, then the slice drawn
    assert im.cmap.N == ids.max()
    prep.pull.bytes = 0
    field.isel(time=slice(0, 4)).plotX().multi_plot(port_px.PlotConfig(), col="time", col_wrap=2)
    assert 4 * slice_bytes < pulled() <= 4 * slice_bytes + 16  # the limits' order statistics, then 4 panels
    prep.pull.bytes = 0
    monkeypatch.setattr(port_base.shutil, "which", lambda name: None)
    monkeypatch.setattr(port_base.os, "cpu_count", lambda: 1)
    field.isel(time=slice(0, 3)).plotX().animate(port_px.PlotConfig(plot_IDs=True), plot_dir=tmp_path)
    assert pulled() == 4 + 3 * slice_bytes


def _tensors_in(obj, seen=None):
    """Every tensor reachable from ``obj`` through containers, Fields and attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float, type(None), type)):
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple, set)):
        items = list(obj)
    elif isinstance(obj, Field):
        items = [obj.data, obj.coords, obj.attrs]
    elif hasattr(obj, "values") and type(obj).__name__ == "Coord":
        items = [obj.values]
    elif hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    else:
        return []
    return [t for item in items for t in _tensors_in(item, seen)]


@pytest.mark.parametrize("plot_ids", [True, False], ids=["ids", "robust"])
def test_animation_payloads_hold_numpy_only(plot_ids, tmp_path, monkeypatch):
    field, ids = _ids_field("tensor")
    payloads = []
    render = port_base._render_frame_task
    monkeypatch.setattr(port_base, "_render_frame_task", lambda p: payloads.append(p) or render(p))
    monkeypatch.setattr(port_base.os, "cpu_count", lambda: 1)
    monkeypatch.setattr(port_base.shutil, "which", lambda name: None)
    field.isel(time=slice(0, 4)).plotX().animate(port_px.PlotConfig(plot_IDs=plot_ids, frame_batch_size=3),
                                                 plot_dir=tmp_path)
    assert len(payloads) == 4
    for t, p in enumerate(payloads):
        assert _tensors_in(p) == []
        da_np = p[1]
        assert isinstance(da_np.data, np.ndarray)
        want = np.where(ids[t] > 0, ids[t], np.nan) if plot_ids else ids[t]
        _same(da_np.data, want)
        pickle.dumps(p)


def test_lazy_payload_is_read_a_chunk_at_a_time(tmp_path, monkeypatch):
    field, ids = _ids_field("numpy")
    path = str(tmp_path / "ids.zarr")
    zarr_lite.to_zarr(field, path, chunks={"time": 3})
    lazy = zarr_lite.open_zarr(path, lazy=True)["ID_field"]
    reads = []
    real = zarr_lite._decompress
    monkeypatch.setattr(zarr_lite, "_decompress", lambda raw, comp: reads.append(1) or real(raw, comp))
    n_chunks = -(-T // 3)
    _same(prep.nanmax(lazy.data), ids.max())
    assert len(reads) == n_chunks  # each chunk once
    reads.clear()
    want = RefPlotterBase.clim_robust(ids[::10], False, [4, 96])
    assert prep.robust_limits(lazy.data, False, [4, 96], axis=0) == want
    assert len(reads) == len({t // 3 for t in range(0, T, 10)})  # only the chunks that hold a sampled slice
    reads.clear()
    _same(prep.nanmax(prep.PositiveOnly(lazy.data)), np.float64(ids.max()))
    frame = prep.host_frame(lazy._replace(data=prep.PositiveOnly(lazy.data)), "time", 13)
    assert len(reads) == n_chunks + 1
    _same(frame.data, np.where(ids[13] > 0, ids[13], np.nan))
