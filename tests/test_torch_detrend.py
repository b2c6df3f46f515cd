"""Detrended anomalies and ``std_normalise`` of the PyTorch port against
``marex_tpu`` and a float64 numpy oracle: the design matrix, the fit and its
removal, the time-mean removal, the two detrended methods, the standardised
anomalies and their STD, and the validations.

Tolerances. The port fits in float64 and rounds once; the reference fits in
float32 (about 1.3e-5 from float64 at the verify size). Detrended
anomalies, ``dat_stn`` and ``STD`` are held within 1e-4 of the reference
and within 5e-5 of the float64 oracle, with the NaN pattern identical. The
extremes of the standardised anomalies follow the rule of
``tests/test_torch_climatology.py``: thresholds at most one bin apart in at
most 2 % of the cells, extremes differing in at most 1e-4 of the cells, each
near its threshold.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu.core.timeaxis import decompose_time as ref_decompose
from marex_tpu.ops import detrend as ref_detrend
from marex_tpu_torch.core.field import from_reference
from marex_tpu_torch.core.timeaxis import decompose_time
from marex_tpu_torch.ops import detrend as port_detrend
from marex_tpu_torch.ops import pipeline as port_pipe

from .torch_parity import assert_close, assert_extremes_near, assert_same, drive_sst, to_np

REF_ATOL = 1e-4
ORACLE_ATOL = 5e-5


@pytest.fixture(scope="module")
def sst():
    return drive_sst()


def oracle_detrended(sst_vals: np.ndarray, times, orders, harmonics: bool, zero_mean: bool = True) -> np.ndarray:
    """data - M.T @ (pinv(M).T @ data), minus its time mean, in float64."""
    model, pmodel = port_detrend.build_design_matrix(decompose_time(times), orders, harmonics)
    x = sst_vals.reshape(sst_vals.shape[0], -1).astype(np.float64)
    anom = x - model.T @ (pmodel.T @ x)
    if zero_mean:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            mean = np.nanmean(anom, axis=0)
        anom = anom - np.where(np.isnan(mean), 0.0, mean)
    return anom.reshape(sst_vals.shape)


def oracle_stn(anom: np.ndarray, times):
    """The 30-day wrapped rolling RMS of the day-of-year STD, and the anomalies over it, in float64."""
    ti = decompose_time(times)
    ymd = np.full((ti.n_years, 366) + anom.shape[1:], np.nan)
    ymd[ti.year_index, ti.dayofyear - 1] = anom
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        std = np.nanstd(ymd, axis=0)
    sq = np.concatenate([std[-16:], std, std[:16]]) ** 2
    rolled = np.full(sq.shape, np.nan)
    rolled[15 : 15 + sq.shape[0] - 29] = np.lib.stride_tricks.sliding_window_view(sq, 30, axis=0).mean(-1)
    std_rolling = np.sqrt(rolled[16 : 16 + 366])
    safe = np.where(std_rolling > 1e-10, std_rolling, np.nan)
    return anom / safe[ti.dayofyear - 1], std_rolling


def within(ref_vals, port_vals, oracle, what: str) -> None:
    assert_close(oracle, port_vals, atol=ORACLE_ATOL, what=f"{what} vs float64")
    assert_close(ref_vals, port_vals, atol=REF_ATOL, what=f"{what} vs marex_tpu")


@pytest.mark.parametrize("orders, harmonics", [([1], True), ([1, 2], True), ([2, 3], False), ([1], False)])
def test_design_matrix_matches(sst, orders, harmonics):
    times = sst.coords["time"].values
    r = ref_detrend.build_design_matrix(ref_decompose(times), orders, harmonics)
    p = port_detrend.build_design_matrix(decompose_time(times), orders, harmonics)
    for a, b in zip(r, p):
        assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b)


def test_fit_removal_and_time_mean_match(sst):
    x = np.array(sst.values.reshape(sst.shape[0], -1))
    model, pmodel = port_detrend.build_design_matrix(decompose_time(sst.coords["time"].values), [1, 2], True)
    r_fit = ref_detrend.detrend_subtract(jnp.asarray(x), jnp.asarray(model, jnp.float32), jnp.asarray(pmodel, jnp.float32))
    r = np.asarray(ref_detrend.remove_time_mean(r_fit))
    m64, pm64 = torch.from_numpy(model), torch.from_numpy(pmodel)
    p_fit = port_detrend.detrend_subtract(torch.from_numpy(x), m64, pm64)
    p = port_detrend.remove_time_mean(p_fit).to(torch.float32)
    oracle = oracle_detrended(x, sst.coords["time"].values, [1, 2], True)
    within(np.asarray(r_fit), p_fit.to(torch.float32), oracle_detrended(x, sst.coords["time"].values, [1, 2], True,
                                                                        zero_mean=False), "detrend_subtract")
    within(r, p, oracle, "remove_time_mean")


def test_detrended_anomaly_blocks_give_the_one_block_answer(sst, monkeypatch):
    """Blocks of 50 columns (the last ragged), in place: within one float32
    rounding of one block (the float64 products may sum in another order for
    another block width)."""
    x = torch.from_numpy(np.array(sst.values.reshape(sst.shape[0], -1)))
    model, pmodel = port_detrend.build_design_matrix(decompose_time(sst.coords["time"].values), [1], True)
    whole = port_pipe.detrended_anomaly(x, model, pmodel, True)
    monkeypatch.setattr(port_pipe, "_DETREND_CHUNK_ELEMS", x.shape[0] * 50)
    in_place = x.clone()
    port_pipe.detrended_anomaly(in_place, model, pmodel, True, out=in_place)
    assert_close(whole, in_place, atol=1e-6, what="detrended anomaly in blocks")
    assert int((torch.nan_to_num(in_place) != torch.nan_to_num(whole)).sum()) <= 1e-3 * whole.numel()


@pytest.mark.parametrize("method_anomaly", ["detrend_harmonic", "detrend_fixed_baseline"])
def test_detrended_anomalies_match(sst, method_anomaly):
    kw = dict(method_anomaly=method_anomaly, std_normalise=method_anomaly == "detrend_harmonic", detrend_orders=[1, 2])
    r = ref.compute_normalised_anomaly(sst, **kw)
    p = port.compute_normalised_anomaly(from_reference(sst, "cpu"), device="cpu", **kw)
    assert sorted(p.data_vars) == sorted(r.data_vars)
    assert_same(r["mask"].values, p["mask"].data, "mask")
    times = sst.coords["time"].values
    oracle = oracle_detrended(sst.values, times, [1, 2], method_anomaly == "detrend_harmonic")
    if method_anomaly == "detrend_fixed_baseline":
        doy = decompose_time(times).dayofyear - 1
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            clim = np.stack([np.nanmean(oracle[doy == d], axis=0) for d in range(366)])
        oracle = oracle - clim[doy]
    within(r["dat_anomaly"].values, p["dat_anomaly"].data, oracle, "dat_anomaly")
    if method_anomaly == "detrend_harmonic":
        stn64, std64 = oracle_stn(oracle, times)
        within(r["dat_stn"].values, p["dat_stn"].data, stn64, "dat_stn")
        within(r["STD"].values, p["STD"].data, std64, "STD")
        assert p["STD"].dims == r["STD"].dims == ("dayofyear", "lat", "lon")
        np.testing.assert_array_equal(p["STD"].coords["dayofyear"].values, r["STD"].coords["dayofyear"].values)
        assert p["dat_stn"].dims == r["dat_stn"].dims and p["dat_stn"].data.device.type == "cpu"


def test_std_normalise_extremes_match(sst):
    kw = dict(method_anomaly="detrend_harmonic", std_normalise=True, method_extreme="global_extreme", quiet=True)
    r = ref.preprocess_data(sst, **kw)
    p = port.preprocess_data(from_reference(sst, "cpu"), device="cpu", **kw)
    assert sorted(p.data_vars) == sorted(r.data_vars)
    assert p.attrs == r.attrs
    for stn in ("", "_stn"):
        r_thr, p_thr = r["thresholds" + stn].values, to_np(p["thresholds" + stn].data)
        np.testing.assert_array_equal(np.isnan(r_thr), np.isnan(p_thr))
        d = np.abs(r_thr.astype(np.float64) - p_thr)[np.isfinite(r_thr)]
        assert d.max() <= 0.01 * (1 + 1e-4) and (d > 1e-6).mean() <= 0.02, (stn, d.max())
        anom = r["dat_anomaly" if not stn else "dat_stn"].values
        assert_extremes_near(anom, r_thr, p_thr, r["extreme_events" + stn].values, p["extreme_events" + stn].data,
                             None, near=REF_ATOL, what="extreme_events" + stn)


@pytest.mark.parametrize(
    "kw",
    [
        dict(method_anomaly="detrend_harmonic", detrend_orders=[]),
        dict(method_anomaly="detrend_fixed_baseline", detrend_orders=[0, 1]),
        dict(method_anomaly="detrend_harmonic", reference_period=(2000, 2001)),
        dict(method_anomaly="shifting_baseline", reference_period=(2000, 2001)),
        dict(method_anomaly="detrend_fixed_baseline", reference_period=(2002, 2000)),
        dict(method_anomaly="bogus"),
    ],
)
def test_anomaly_validation_errors_match(sst, kw):
    with pytest.raises(ref.ConfigurationError) as r:
        ref.compute_normalised_anomaly(sst, **kw)
    with pytest.raises(port.ConfigurationError) as p:
        port.compute_normalised_anomaly(from_reference(sst, "cpu"), device="cpu", **kw)
    assert (p.value.message, p.value.details) == (r.value.message, r.value.details)


def test_higher_order_without_linear_term_warns_as_the_reference(sst):
    small = sst.isel(lat=slice(0, 4), lon=slice(0, 4))
    out = {}
    for name, pkg, arg, kw in (("ref", ref, small, {}), ("port", port, from_reference(small, "cpu"), {"device": "cpu"})):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            pkg.compute_normalised_anomaly(arg, method_anomaly="detrend_harmonic", detrend_orders=[2, 3], **kw)
        out[name] = [str(w.message) for w in rec if issubclass(w.category, UserWarning)]
    assert out["port"] == out["ref"] == ["Higher-order detrending without linear term may be unstable"]
