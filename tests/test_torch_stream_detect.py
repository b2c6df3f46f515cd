"""Streamed detect of the PyTorch port (``preprocess_data_streamed``),
mirroring ``tests/test_streaming.py::TestStreamedDetectEquality``: the
five-method matrix, the shifting baseline from a lazy store, a mesh,
``std_normalise``, an all-land tile and the time-major check.

Each case is held bit for bit against the port's own ``preprocess_data``
(the detrended methods within 1e-5: their fits are float64 matrix products,
whose order BLAS may choose by width), and against
``marex_tpu.preprocess_data_streamed`` within the tolerances of
``tests/test_torch_detect_methods.py``: anomalies within 1e-5 (fixed
baseline), 1e-4 (detrended) or 5e-4 (shifting baseline); thresholds from the
fixed baseline's anomalies within 1e-6 and its extremes bit for bit;
otherwise approximate thresholds at most one bin apart in at most 2 % of the
cells, exact ones within the anomaly tolerance, extremes differing in at
most 1e-4 of the cells, each near its threshold. Masks and attrs are equal.
"""

import numpy as np
import pytest

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu_torch.core.field import from_reference
from marex_tpu_torch.core.timeaxis import decompose_time
from marex_tpu_torch.io import zarr_lite

from .conftest import make_gridded_sst, make_unstructured_sst
from .torch_parity import assert_close, assert_extremes_near, assert_same, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ANOMALY_ATOL = {"fixed_baseline": 1e-5, "detrend_harmonic": 1e-4, "detrend_fixed_baseline": 1e-4,
                "shifting_baseline": 5e-4}
MATRIX = [
    ("fixed_baseline", "global_extreme", "approximate"),
    ("fixed_baseline", "global_extreme", "exact"),
    ("detrend_harmonic", "hobday_extreme", "approximate"),
    ("fixed_baseline", "hobday_extreme", "exact"),
    ("detrend_fixed_baseline", "global_extreme", "approximate"),
]
CORE = ("dat_anomaly", "extreme_events", "thresholds", "mask")


@pytest.fixture(scope="module")
def sst4():
    return make_gridded_sst(n_years=4, ny=20, nx=40)


def _values(ds, name) -> np.ndarray:
    return np.asarray(ds[name].values)


def assert_like_in_memory(mem, streamed, names, detrended: bool) -> None:
    """Streamed outputs against the port's in-memory ones: bit for bit, or
    for the detrended methods floats within 1e-5 and extremes near their
    thresholds."""
    for name in names:
        a, b = _values(mem, name), _values(streamed, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if not detrended:
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), f"{name} differs"
        elif a.dtype.kind == "f":
            assert_close(a, b, atol=1e-5, what=name)
        elif name == "mask":
            assert_same(a, b, name)
    if detrended:
        for ext, thr, anom in (("extreme_events", "thresholds", "dat_anomaly"),
                               ("extreme_events_stn", "thresholds_stn", "dat_stn")):
            if ext in names:
                doy = (decompose_time(mem.coords["time"].values).dayofyear - 1) if _values(mem, thr).ndim == 3 else None
                assert_extremes_near(_values(mem, anom), _values(mem, thr), _values(streamed, thr), _values(mem, ext),
                                     _values(streamed, ext), doy, near=1e-5, what=ext)


def assert_like_reference(r, p, method_anomaly: str, exact: bool, suffix: str = "", anom: str = "dat_anomaly") -> None:
    """The port's streamed outputs against the reference's streamed ones."""
    tol = ANOMALY_ATOL[method_anomaly]
    assert_same(_values(r, "mask"), _values(p, "mask"), "mask")
    assert_close(_values(r, anom), _values(p, anom), atol=tol, what=anom)
    r_thr, p_thr = _values(r, "thresholds" + suffix), _values(p, "thresholds" + suffix)
    r_ext, p_ext = _values(r, "extreme_events" + suffix), _values(p, "extreme_events" + suffix)
    if tol <= 1e-5:
        assert_close(r_thr, p_thr, atol=1e-6, what="thresholds" + suffix)
        assert_same(r_ext, p_ext, "extreme_events" + suffix)
        return
    np.testing.assert_array_equal(np.isnan(r_thr), np.isnan(p_thr))
    d = np.abs(r_thr.astype(np.float64) - p_thr)[np.isfinite(r_thr)]
    if exact:
        assert d.max() <= tol, d.max()
    else:
        assert d.max() <= 0.01 * (1 + 1e-4) and (d > 1e-6).mean() <= 0.02, (d.max(), (d > 1e-6).mean())
    doy = (decompose_time(r.coords["time"].values).dayofyear - 1) if r_thr.ndim == r_ext.ndim else None
    assert_extremes_near(_values(r, anom), r_thr, p_thr, r_ext, p_ext, doy, near=tol, what="extreme_events" + suffix)


@pytest.mark.parametrize("meth_a,meth_e,pct", MATRIX)
def test_streamed_matches_in_memory_and_reference(tmp_path, sst4, meth_a, meth_e, pct):
    kw = dict(method_anomaly=meth_a, method_extreme=meth_e, method_percentile=pct)
    p_in = from_reference(sst4, "cpu")
    mem = port.preprocess_data(p_in, device="cpu", quiet=True, **kw)
    s = port.preprocess_data_streamed(p_in, str(tmp_path / "p.zarr"), row_block=7, device="cpu", **kw)
    assert (s.attrs["streamed"], s.attrs["stream_row_block"], s.attrs["stream_n_tiles"]) == (1, 7, 3)
    assert_like_in_memory(mem, s, CORE, meth_a.startswith("detrend"))
    r = ref.preprocess_data_streamed(sst4, str(tmp_path / "r.zarr"), row_block=7, **kw)
    assert s.attrs == r.attrs
    assert_like_reference(r, s, meth_a, pct == "exact")


def test_streamed_shifting_baseline_from_lazy_store(tmp_path):
    """The reference's defaults (a 15-year shifting baseline, Hobday
    thresholds with the 5 x 5 window crossing the tile seams) read from a
    lazy store chunked in latitude."""
    da = make_gridded_sst(n_years=17, ny=12, nx=24)
    src = str(tmp_path / "in.zarr")
    zarr_lite.to_zarr(from_reference(da, "cpu"), src, chunks={"time": 800, "lat": 4})
    kw = dict(method_anomaly="shifting_baseline", method_extreme="hobday_extreme")
    mem = port.preprocess_data(from_reference(da, "cpu"), device="cpu", quiet=True, **kw)
    s = port.preprocess_data_streamed(src, str(tmp_path / "out.zarr"), row_block=5, device="cpu", **kw)
    assert_like_in_memory(mem, s, CORE, detrended=False)
    np.testing.assert_array_equal(mem.coords["time"].values, s.coords["time"].values)  # the baseline years dropped
    r = ref.preprocess_data_streamed(src, str(tmp_path / "r.zarr"), row_block=5, **kw)
    assert s.attrs == r.attrs
    assert_like_reference(r, s, "shifting_baseline", exact=False)


def test_streamed_unstructured(tmp_path):
    uda, nb, ca = make_unstructured_sst(n_years=3, n_side=12)
    kw = dict(method_anomaly="fixed_baseline", method_extreme="hobday_extreme",
              dimensions={"time": "time", "x": "ncells"}, coordinates={"time": "time", "x": "lon", "y": "lat"})
    p_nb, p_ca = from_reference(nb, "cpu"), from_reference(ca, "cpu")
    mem = port.preprocess_data(from_reference(uda, "cpu"), neighbours=p_nb, cell_areas=p_ca, device="cpu", quiet=True,
                               **kw)
    s = port.preprocess_data_streamed(from_reference(uda, "cpu"), str(tmp_path / "out.zarr"), row_block=57,
                                      neighbours=p_nb, cell_areas=p_ca, device="cpu", **kw)
    assert s.attrs["stream_n_tiles"] > 1
    assert_like_in_memory(mem, s, CORE + ("neighbours", "cell_areas"), detrended=False)
    r = ref.preprocess_data_streamed(uda, str(tmp_path / "r.zarr"), row_block=57, neighbours=nb, cell_areas=ca, **kw)
    assert_like_reference(r, s, "fixed_baseline", exact=False)


def test_streamed_std_normalise(tmp_path):
    da = make_gridded_sst(n_years=4, ny=12, nx=24)
    kw = dict(method_anomaly="detrend_harmonic", method_extreme="global_extreme", std_normalise=True)
    mem = port.preprocess_data(from_reference(da, "cpu"), device="cpu", quiet=True, **kw)
    s = port.preprocess_data_streamed(from_reference(da, "cpu"), str(tmp_path / "out.zarr"), row_block=5,
                                      device="cpu", **kw)
    names = CORE + ("dat_stn", "STD", "extreme_events_stn", "thresholds_stn")
    assert_like_in_memory(mem, s, names, detrended=True)
    r = ref.preprocess_data_streamed(da, str(tmp_path / "r.zarr"), row_block=5, **kw)
    assert_like_reference(r, s, "detrend_harmonic", exact=False)
    assert_like_reference(r, s, "detrend_harmonic", exact=False, suffix="_stn", anom="dat_stn")
    assert_close(_values(r, "STD"), _values(s, "STD"), atol=1e-4, what="STD")


def test_streamed_all_land_tile(tmp_path):
    """Rows 0-7 all land: the tiles that hold only land are written as the
    whole-field run gives them (NaN anomalies and thresholds, no extremes,
    no mask)."""
    da = make_gridded_sst(n_years=4, ny=20, nx=40, with_land=False)
    vals = np.asarray(da.values).copy()
    vals[:, 0:8, :] = np.nan
    f = port.Field(vals, da.dims, {k: c.values for k, c in da.coords.items()}, name="sst")
    kw = dict(method_anomaly="fixed_baseline", method_extreme="global_extreme")
    mem = port.preprocess_data(f, device="cpu", quiet=True, **kw)
    s = port.preprocess_data_streamed(f, str(tmp_path / "out.zarr"), row_block=4, device="cpu", **kw)
    assert_like_in_memory(mem, s, CORE, detrended=False)
    assert not _values(s, "mask")[:8].any() and np.isnan(_values(s, "thresholds")[:8]).all()


def test_streamed_requires_time_major(tmp_path):
    da = make_gridded_sst(n_years=2, ny=8, nx=12).transpose("lat", "time", "lon")
    with pytest.raises(port.DataValidationError, match="time-major"):
        port.preprocess_data_streamed(from_reference(da, "cpu"), str(tmp_path / "out.zarr"), device="cpu")
