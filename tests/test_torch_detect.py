"""Detect stage of the PyTorch port against ``marex_tpu``: fixed-baseline
anomalies, approximate global thresholds fed the reference's own anomalies,
the extremes, the range warnings and the validation errors."""

import warnings

import numpy as np
import pytest
import torch

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu_torch.core.field import from_reference

from .conftest import make_gridded_sst
from .torch_parity import DETECT_FIXED, assert_close, assert_same


@pytest.fixture(scope="module")
def sst():
    return make_gridded_sst(n_years=3, ny=24, nx=48, seed=5)


@pytest.mark.parametrize("reference_period", [None, (2000, 2001)])
def test_fixed_baseline_anomaly_matches(sst, reference_period):
    kw = dict(method_anomaly="fixed_baseline", reference_period=reference_period)
    r = ref.compute_normalised_anomaly(sst, **kw)
    p = port.compute_normalised_anomaly(from_reference(sst, "cpu"), device="cpu", **kw)
    assert_close(r["dat_anomaly"].values, p["dat_anomaly"].data, what="dat_anomaly")
    assert_same(r["mask"].values, p["mask"].data, "mask")
    assert p["dat_anomaly"].dims == r["dat_anomaly"].dims


def test_year_doy_scatter_and_gather_match(sst):
    from marex_tpu.core import timeaxis as ref_time
    from marex_tpu_torch.core import timeaxis as port_time

    tinfo = ref_time.decompose_time(sst.coords["time"].values)
    ptinfo = port_time.decompose_time(sst.coords["time"].values)
    vals = np.asarray(sst.values)
    r = ref_time.scatter_to_year_doy(vals, tinfo)
    p = port_time.scatter_to_year_doy(torch.from_numpy(vals), ptinfo)
    assert_close(r, p, atol=0, what="scatter_to_year_doy")
    assert_close(ref_time.gather_from_year_doy(r, tinfo), port_time.gather_from_year_doy(p, ptinfo), atol=0)


def test_global_thresholds_from_reference_anomalies(sst):
    anom = ref.compute_normalised_anomaly(sst, method_anomaly="fixed_baseline")["dat_anomaly"]
    r_ext, r_thr = ref.identify_extremes(anom, method_extreme="global_extreme", threshold_percentile=95)
    p_ext, p_thr = port.identify_extremes(
        from_reference(anom, "cpu"), method_extreme="global_extreme", threshold_percentile=95, device="cpu"
    )
    assert_close(r_thr.values, p_thr.data, atol=1e-6, what="thresholds")
    assert_same(r_ext.values, p_ext.data, "extreme_events")
    assert p_thr.dims == r_thr.dims and p_ext.dims == r_ext.dims


def _warnings_of(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn()
    return sorted(str(w.message) for w in rec if issubclass(w.category, UserWarning))


def test_threshold_range_warnings_match(sst):
    anom = ref.compute_normalised_anomaly(sst, method_anomaly="fixed_baseline")["dat_anomaly"]
    vals = np.array(anom.values)
    vals[:, 10:14, 20:30] = 4.996  # in the last bin: thresholds above bin_edges[-2]
    vals[:, 16:20, 0:8] = 0.0  # constant anomaly: thresholds below the lowest edge
    crafted = ref.Field(vals, anom.dims, anom.coords, name="dat_anomaly")
    kw = dict(method_extreme="global_extreme", threshold_percentile=95)
    r = _warnings_of(lambda: ref.identify_extremes(crafted, **kw))
    p = _warnings_of(lambda: port.identify_extremes(from_reference(crafted, "cpu"), device="cpu", **kw))
    assert len(r) == 2 and p == r


def test_preprocess_data_matches(sst):
    r = ref.preprocess_data(sst, quiet=True, **DETECT_FIXED)
    p = port.preprocess_data(from_reference(sst, "cpu"), device="cpu", quiet=True, **DETECT_FIXED)
    assert sorted(p.data_vars) == sorted(r.data_vars)
    assert_close(r["dat_anomaly"].values, p["dat_anomaly"].data, what="dat_anomaly")
    assert_close(r["thresholds"].values, p["thresholds"].data, what="thresholds")
    assert_same(r["extreme_events"].values, p["extreme_events"].data, "extreme_events")
    assert_same(r["mask"].values, p["mask"].data, "mask")
    assert p.attrs == r.attrs


def test_numpy_input_moves_to_device_and_tensor_keeps_its_own(sst):
    """A numpy payload is staged on ``device``; a tensor payload keeps its device."""
    coords = {k: (c.dims, c.values) for k, c in sst.coords.items()}
    numpy_in = port.Field(np.asarray(sst.values), sst.dims, coords)
    p = port.preprocess_data(numpy_in, device="cpu", quiet=True, **DETECT_FIXED)
    assert p["extreme_events"].data.device.type == "cpu"
    tensor_in = from_reference(sst, "cpu")
    p = port.preprocess_data(tensor_in, device="meta", quiet=True, **DETECT_FIXED)  # device= places only non-tensors
    assert p["extreme_events"].data.device.type == "cpu"
    if not torch.cuda.is_available():  # the default device is "cuda": without one, staging fails loudly
        with pytest.raises((RuntimeError, AssertionError)):
            port.preprocess_data(numpy_in, quiet=True, **DETECT_FIXED)


def test_validation_errors_match(sst):
    bad = np.array(sst.values)
    bad[100, 12, 30] = np.nan  # NaN at an ocean point after t=0
    da = ref.Field(bad, sst.dims, sst.coords)
    with pytest.raises(ref.DataValidationError) as r:
        ref.preprocess_data(da, quiet=True, **DETECT_FIXED)
    with pytest.raises(port.DataValidationError) as p:
        port.preprocess_data(from_reference(da, "cpu"), device="cpu", quiet=True, **DETECT_FIXED)
    assert p.value.message == r.value.message
    for kw in (dict(threshold_percentile=50), dict(method_percentile="bogus"), dict(threshold_percentile=101)):
        with pytest.raises(ref.ConfigurationError):
            ref.preprocess_data(sst, quiet=True, **{**DETECT_FIXED, **kw})
        with pytest.raises(port.ConfigurationError):
            port.preprocess_data(from_reference(sst, "cpu"), device="cpu", quiet=True, **{**DETECT_FIXED, **kw})


@pytest.mark.parametrize(
    "kw, item",
    [
        (dict(mesh=True), "item 11"),
        (dict(dimensions={"time": "time", "x": "cell"}, coordinates={"time": "time", "x": "lon", "y": "lat"}), None),
    ],
)
def test_unported_options_name_their_roadmap_item(sst, kw, item):
    if item is None:  # ported: (time, cell) data runs, and gives the reference's extremes
        T, H, W = sst.shape
        lat, lon = (np.asarray(sst.coords[k].values) for k in ("lat", "lon"))
        cells = {"lat": ("cell", np.repeat(lat, W)), "lon": ("cell", np.tile(lon, H))}
        flat = ref.Field(np.asarray(sst.values).reshape(T, H * W), ("time", "cell"),
                         {"time": sst.coords["time"].values, **cells}, name="sst")
        r = ref.preprocess_data(flat, quiet=True, **{**DETECT_FIXED, **kw})
        p = port.preprocess_data(from_reference(flat, "cpu"), device="cpu", quiet=True, **{**DETECT_FIXED, **kw})
        assert p["extreme_events"].dims == r["extreme_events"].dims == ("time", "cell")
        np.testing.assert_array_equal(p["extreme_events"].values, np.asarray(r["extreme_events"].values))
        assert bool(p["extreme_events"].values.any())
        return
    # item 11 (multi-device) is ported: mesh=True asks for a mesh of the run's
    # device, and without a card a CUDA run raises rather than running on the
    # CPU (the mesh runs are held in tests/test_torch_parallel*.py)
    with pytest.raises(port.DeviceError, match="CUDA"):
        port.preprocess_data(from_reference(sst, "cpu"), device="cuda", quiet=True, **{**DETECT_FIXED, **kw})
