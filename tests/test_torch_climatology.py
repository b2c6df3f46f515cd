"""The shifting baseline of the PyTorch port against ``marex_tpu`` and a
float64 numpy oracle: the climatology steps, the shifting-baseline anomaly
and its space tiling, the public helpers, the trim of the baseline years,
and the reference-default slice (config 2: ``shifting_baseline`` +
``hobday_extreme``, then the no-merge tracker) as a whole.

Tolerances. The reference builds its windowed means from float32 prefix
sums over the whole series (1.2e-4 from float64 measured at 4 yr x 24 x 48);
the port adds each window directly, in a fixed order, so it is held within
1e-5 of the float64 oracle and within 5e-4 of the reference, with the NaN
pattern identical. Fed the reference's own anomalies the Hobday stage is
bit-identical (``tests/test_torch_hobday.py``); fed the port's own, the
whole slice lets thresholds differ by at most one bin (``precision``) in at
most 2 % of the cells, and ``extreme_events`` in at most 1e-4 of the cells,
each with the reference's anomaly within 5e-4 of its threshold or between
the two packages' thresholds.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu.ops import climatology as ref_clim
from marex_tpu_torch.core.field import from_reference
from marex_tpu_torch.core.timeaxis import decompose_time
from marex_tpu_torch.ops import climatology as port_clim
from marex_tpu_torch.ops import pipeline as port_pipe

from .torch_parity import TRACK_SMALL, assert_close, assert_extremes_near, assert_same, drive_sst, to_np

ORACLE_ATOL = 1e-5
REF_ATOL = 5e-4
SHIFT = dict(method_anomaly="shifting_baseline", window_year_baseline=2, smooth_days_baseline=21)
CONFIG2 = dict(SHIFT, method_extreme="hobday_extreme", method_percentile="approximate", threshold_percentile=95,
               window_days_hobday=11)


def oracle_centered_mean(x: np.ndarray, window: int) -> np.ndarray:
    """float64 centred rolling mean along axis 0; NaN unless the full window
    exists and is finite."""
    x = np.where(np.isfinite(x), x.astype(np.float64), np.nan)
    out = np.full(x.shape, np.nan)
    n = x.shape[0] - window + 1
    if n > 0:
        out[window // 2 : window // 2 + n] = np.lib.stride_tricks.sliding_window_view(x, window, axis=0).mean(-1)
    return out


def oracle_rolling_clim(ymd: np.ndarray, window_years: int) -> np.ndarray:
    """float64 nanmean over the strictly previous ``window_years`` years."""
    ymd = ymd.astype(np.float64)
    out = np.full(ymd.shape, np.nan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for y in range(window_years, ymd.shape[0]):
            out[y] = np.nanmean(ymd[y - window_years : y], axis=0)
    return out


def oracle_shifting_anomaly(sst: np.ndarray, times, window_years: int, smooth: int) -> np.ndarray:
    """The shifting-baseline anomaly in float64 numpy, (T, ...)."""
    ti = decompose_time(times)
    smoothed = oracle_centered_mean(sst, smooth)
    ymd = np.full((ti.n_years, 366) + sst.shape[1:], np.nan)
    ymd[ti.year_index, ti.dayofyear - 1] = smoothed
    clim = oracle_rolling_clim(ymd, window_years)
    return sst.astype(np.float64) - clim[ti.year_index, ti.dayofyear - 1]


def within(ref_vals, port_vals, oracle, what: str) -> None:
    """NaN pattern identical to the reference and the oracle; within
    ORACLE_ATOL of the oracle and REF_ATOL of the reference."""
    assert_close(oracle, port_vals, atol=ORACLE_ATOL, what=f"{what} vs float64")
    assert_close(ref_vals, port_vals, atol=REF_ATOL, what=f"{what} vs marex_tpu")


def _noisy(shape, seed: int, nan_share: float = 0.002) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (20 + rng.standard_normal(shape)).astype(np.float32)
    x[rng.random(shape) < nan_share] = np.nan
    return x


@pytest.fixture(scope="module")
def sst4():
    return drive_sst(n_years=4)


@pytest.fixture(scope="module")
def config2():
    """The reference-default slice through the reference, once for the file."""
    sst = drive_sst()
    r_ds = ref.preprocess_data(sst, quiet=True, **CONFIG2)
    r_ev = ref.tracker(r_ds["extreme_events"], r_ds["mask"], quiet=True, **TRACK_SMALL).run()
    p_ds = port.preprocess_data(from_reference(sst, "cpu"), device="cpu", quiet=True, **CONFIG2)
    return sst, r_ds, r_ev, p_ds


@pytest.mark.parametrize("window", [21, 30, 4, 11])
def test_centered_rolling_mean_matches(window):
    x = _noisy((400, 37), seed=window)
    x[50, 3] = np.inf
    r = np.asarray(ref_clim.centered_rolling_mean_time(jnp.asarray(x), window))
    p = port_clim.centered_rolling_mean_time(torch.from_numpy(x), window)
    within(r, p, oracle_centered_mean(x, window), f"centred mean w={window}")


@pytest.mark.parametrize("window_years", [1, 2, 3, 5])
def test_rolling_climatology_ymd_matches(window_years):
    ymd = _noisy((5, 366, 29), seed=window_years, nan_share=0.05)
    ymd[1:3, 10, 4] = np.nan  # a window with one missing year, and one with none
    r = np.asarray(ref_clim.rolling_climatology_ymd(jnp.asarray(ymd), window_years))
    p = port_clim.rolling_climatology_ymd(torch.from_numpy(ymd), window_years)
    within(r, p, oracle_rolling_clim(ymd, window_years), f"rolling climatology W={window_years}")


def test_year_statistics_match():
    """nanmean_over_years, dayofyear_std and the wrapped rolling RMS."""
    ymd = _noisy((4, 366, 31), seed=9, nan_share=0.1)
    ymd[:, 7, 2] = np.nan  # a (day, point) with no sample
    y64 = ymd.astype(np.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        mean64, std64 = np.nanmean(y64, 0), np.nanstd(y64, 0)
    r_mean = np.asarray(ref_clim.nanmean_over_years(jnp.array(ymd)))  # copies: no buffer shared between packages
    p_mean = port_clim.nanmean_over_years(torch.tensor(ymd))
    assert_close(mean64, p_mean, atol=ORACLE_ATOL, what="nanmean vs float64")
    assert_close(r_mean, p_mean, atol=ORACLE_ATOL, what="nanmean vs marex_tpu")
    r_std = np.asarray(ref_clim.dayofyear_std(jnp.array(ymd)))
    p_std = port_clim.dayofyear_std(torch.tensor(ymd))
    assert_close(std64, p_std, atol=ORACLE_ATOL, what="dayofyear_std vs float64")
    assert_close(r_std, p_std, atol=ORACLE_ATOL, what="dayofyear_std vs marex_tpu")
    std = np.abs(_noisy((366, 31), seed=4, nan_share=0.0)) / 10
    sq = np.concatenate([std[-16:], std, std[:16]]).astype(np.float64) ** 2
    rms64 = np.sqrt(oracle_centered_mean(sq, 30))[16:382]
    r_rms = np.asarray(ref_clim.wrapped_rolling_rms_doy(jnp.array(std), window=30, pad=16))
    p_rms = port_clim.wrapped_rolling_rms_doy(torch.tensor(std), window=30, pad=16)
    assert_close(rms64, p_rms, atol=ORACLE_ATOL, what="rolling rms vs float64")
    assert_close(r_rms, p_rms, atol=ORACLE_ATOL, what="rolling rms vs marex_tpu")


def test_shifting_baseline_anomaly_matches(sst4):
    r = ref.compute_normalised_anomaly(sst4, **SHIFT)
    p = port.compute_normalised_anomaly(from_reference(sst4, "cpu"), device="cpu", **SHIFT)
    oracle = oracle_shifting_anomaly(sst4.values, sst4.coords["time"].values, 2, 21)
    within(r["dat_anomaly"].values, p["dat_anomaly"].data, oracle, "shifting-baseline anomaly")
    assert_same(r["mask"].values, p["mask"].data, "mask")
    assert p["dat_anomaly"].dims == r["dat_anomaly"].dims
    assert int(np.isnan(to_np(p["dat_anomaly"].data)[:731]).sum()) == 731 * 24 * 48  # 2000 and 2001: no history


def test_shifting_baseline_space_tiles_give_the_untiled_answer(sst4, monkeypatch):
    """A budget of a few hundred columns a tile (last tile ragged) and of one
    column: bit-identical to one tile, and in place to a fresh output."""
    data = torch.from_numpy(np.ascontiguousarray(sst4.values.reshape(sst4.shape[0], -1)))
    tinfo = decompose_time(sst4.coords["time"].values)
    whole = port_pipe.shifting_baseline_anomaly(data, tinfo, 2, 21)
    assert int(whole.isnan().sum()) < whole.numel()
    for cells in (366 * 4 * 500, 366 * 4):
        monkeypatch.setattr(port_pipe, "_SHIFT_CHUNK_CELLS", cells)
        tiled = port_pipe.shifting_baseline_anomaly(data, tinfo, 2, 21)
        assert torch.equal(torch.nan_to_num(tiled, 7.0), torch.nan_to_num(whole, 7.0)), cells
    in_place = data.clone()
    port_pipe.shifting_baseline_anomaly(in_place, tinfo, 2, 21, out=in_place)
    assert torch.equal(torch.nan_to_num(in_place, 7.0), torch.nan_to_num(whole, 7.0))


@pytest.mark.parametrize("helper", ["rolling_climatology", "smoothed_rolling_climatology", "add_decimal_year"])
def test_public_helpers_match(sst4, helper):
    p_in = from_reference(sst4, "cpu")
    if helper == "add_decimal_year":
        r, p = ref.add_decimal_year(sst4), port.add_decimal_year(p_in)
        np.testing.assert_array_equal(p.coords["decimal_year"].values, r.coords["decimal_year"].values)
        assert p.coords["decimal_year"].dims == r.coords["decimal_year"].dims == ("time",)
        return
    kw = dict(window_year_baseline=2)
    if helper == "smoothed_rolling_climatology":
        kw["smooth_days_baseline"] = 21
    r = getattr(ref, helper)(sst4, **kw)
    p = getattr(port, helper)(p_in, device="cpu", **kw)
    ti = decompose_time(sst4.coords["time"].values)
    x = oracle_centered_mean(sst4.values, 21) if "smoothed" in helper else sst4.values.astype(np.float64)
    ymd = np.full((ti.n_years, 366) + x.shape[1:], np.nan)
    ymd[ti.year_index, ti.dayofyear - 1] = x
    oracle = oracle_rolling_clim(ymd, 2)[ti.year_index, ti.dayofyear - 1]
    within(r.values, p.data, oracle, helper)
    assert p.dims == r.dims and p.name == r.name


@pytest.mark.parametrize("window_year_baseline", [4, 3])
def test_baseline_trim_errors_match(window_year_baseline):
    """More baseline years than the data spans, and exactly as many (which
    would leave nothing): the same error from both packages."""
    sst = drive_sst(ny=6, nx=8)
    kw = dict(CONFIG2, window_year_baseline=window_year_baseline, method_extreme="global_extreme")
    with pytest.raises(ref.DataValidationError) as r:
        ref.preprocess_data(sst, quiet=True, **kw)
    with pytest.raises(port.DataValidationError) as p:
        port.preprocess_data(from_reference(sst, "cpu"), device="cpu", quiet=True, **kw)
    assert (p.value.message, p.value.details) == (r.value.message, r.value.details)


def test_config2_slice_anomalies_mask_and_attrs(config2):
    sst, r_ds, _, p_ds = config2
    assert sorted(p_ds.data_vars) == sorted(r_ds.data_vars)
    r_anom = r_ds["dat_anomaly"].values
    oracle = oracle_shifting_anomaly(sst.values, sst.coords["time"].values, 2, 21)[731:]  # the trim keeps 2002
    within(r_anom, p_ds["dat_anomaly"].data, oracle, "config 2 dat_anomaly")
    assert_same(r_ds["mask"].values, p_ds["mask"].data, "mask")
    assert p_ds.attrs == r_ds.attrs
    for name in ("dat_anomaly", "extreme_events", "thresholds"):
        assert p_ds[name].dims == r_ds[name].dims, name
    np.testing.assert_array_equal(p_ds.coords["time"].values, r_ds.coords["time"].values)
    np.testing.assert_array_equal(p_ds["thresholds"].coords["dayofyear"].values, np.arange(1, 367))


def test_config2_slice_thresholds_and_extremes(config2):
    _, r_ds, _, p_ds = config2
    r_thr, p_thr = r_ds["thresholds"].values, to_np(p_ds["thresholds"].data)
    np.testing.assert_array_equal(np.isnan(r_thr), np.isnan(p_thr))
    d = np.abs(r_thr.astype(np.float64) - p_thr)[np.isfinite(r_thr)]
    precision = r_ds.attrs["precision"]
    assert d.max() <= precision * (1 + 1e-4), d.max()  # at most one bin
    assert (d > 1e-6).mean() <= 0.02, (d > 1e-6).mean()
    doy = decompose_time(r_ds.coords["time"].values).dayofyear - 1
    assert_extremes_near(r_ds["dat_anomaly"].values, r_thr, p_thr, r_ds["extreme_events"].values,
                         p_ds["extreme_events"].data, doy, near=REF_ATOL)


def test_config2_tracker_on_the_reference_extremes(config2):
    """The tracker stage fed the reference's own extremes, and the port's
    own chain to the end."""
    _, r_ds, r_ev, p_ds = config2
    p_ev = port.tracker(from_reference(r_ds["extreme_events"], "cpu"), from_reference(r_ds["mask"], "cpu"),
                        device="cpu", quiet=True, **TRACK_SMALL).run()
    assert_same(r_ev["ID_field"].values, p_ev["ID_field"].data, "ID_field")
    assert p_ev.attrs == r_ev.attrs
    own = port.tracker(p_ds["extreme_events"], p_ds["mask"], device="cpu", quiet=True, **TRACK_SMALL).run()
    assert own.attrs["N_events_final"] > 0
    if np.array_equal(r_ds["extreme_events"].values, to_np(p_ds["extreme_events"].data)):
        assert_same(r_ev["ID_field"].values, own["ID_field"].data, "ID_field (own chain)")
