"""Day-of-year (Hobday) thresholds and the exact percentile of the PyTorch
port against ``marex_tpu``, each stage fed the reference's own input.

Tolerances: integer stages (``digitize(compact)``, the (dayofyear, bin)
histogram, the window sums with wrap and truncation) bit-identical;
thresholds within 1e-6 (0 is the target, and is what the port reaches: it
rounds where the reference's XLA code fuses a multiply-add), extremes
bit-identical; untiled, and with the histogram's tile budget forced small
enough that tiles cross the lon seam and both pole edges. Validation errors,
the range warnings and the "not enough samples" log line match the
reference's."""

import logging
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu.ops import quantile as ref_q
from marex_tpu_torch.core.field import from_reference
from marex_tpu_torch.ops import quantile as port_q

from .torch_parity import assert_close, assert_same, drive_sst

THR_ATOL = 1e-6
EDGES = ref_q.make_bin_edges(0.01, 5.0)
NBINS = len(EDGES) - 1
CENTERS = ref_q.make_bin_centers(EDGES)
CELL_BYTES = 366 * (NBINS + 1) * 4  # one cell's column of the port's tile histogram
GRID = (12, 16)


def _anomalies(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal(shape)).astype(np.float32)
    x[rng.random(shape) < 0.01] = np.nan
    x[rng.random(shape) < 0.002] = 6.0  # above max_anomaly: the sentinel bin
    return x


def _bins_ymd(n_years: int = 2, seed: int = 1) -> np.ndarray:
    """A (Y, 366, 12*16) compact bin stack with land columns (all sentinel)."""
    x = _anomalies((n_years, 366, GRID[0] * GRID[1]), seed)
    x[:, :, 20:26] = np.nan
    return np.array(ref_q.digitize_anomalies(jnp.asarray(x), 0.01, NBINS, compact=True))


@pytest.fixture(scope="module")
def anomalies():
    """The reference's fixed-baseline anomalies of the verify drive."""
    return ref.compute_normalised_anomaly(drive_sst(), method_anomaly="fixed_baseline")["dat_anomaly"]


@pytest.fixture(scope="module")
def ref_hobday(anomalies):
    return ref.identify_extremes(anomalies, method_extreme="hobday_extreme", quiet=True)


def test_digitize_compact_matches():
    x = _anomalies((50, 300), seed=3)
    x[0, :8] = [-0.01, -0.0100001, 0.0, 4.99, 5.0, 5.01, -7.0, np.nan]  # the edges
    r = np.asarray(ref_q.digitize_anomalies(jnp.asarray(x), 0.01, NBINS, compact=True))
    p = port_q.digitize_anomalies(torch.from_numpy(x), 0.01, NBINS)
    assert r.dtype == np.int16 and p.dtype == torch.int16
    assert_same(r, p, "digitize(compact)")


def test_histograms_match():
    """The (dayofyear, bin) histogram and the all-time one."""
    bins = _bins_ymd()
    r = np.asarray(ref_q.histogram_doy_bins(jnp.asarray(bins), NBINS))
    p = port_q.histogram_doy_bins(torch.from_numpy(bins), NBINS)
    assert_same(r, p, "histogram_doy_bins")
    ts = bins.reshape(-1, bins.shape[-1])
    assert_same(ref_q.histogram_bins_1d(jnp.asarray(ts), NBINS), port_q.histogram_bins_1d(torch.from_numpy(ts), NBINS),
                "histogram_bins_1d")


@pytest.mark.parametrize("window", [11, 5, 1])
def test_rolling_doy_window_sum_matches(window):
    hist = np.random.default_rng(window).integers(0, 4, (366, 7, 9)).astype(np.int32)
    r = np.asarray(ref_q.rolling_doy_window_sum(jnp.asarray(hist), window))
    assert_same(r, port_q.rolling_doy_window_sum(torch.from_numpy(hist), window), f"doy window {window}")


@pytest.mark.parametrize("axis, wrap, window", [(2, True, 5), (1, False, 5), (2, False, 3), (1, True, 3), (2, True, 9)])
def test_rolling_axis_sum_matches(axis, wrap, window):
    hist = np.random.default_rng(axis * 10 + window).integers(0, 4, (20, 6, 8, 11)).astype(np.int32)
    r = np.asarray(ref_q.rolling_axis_sum(jnp.asarray(hist), window, axis, wrap))
    assert_same(r, port_q.rolling_axis_sum(torch.from_numpy(hist), window, axis, wrap), f"axis {axis} wrap {wrap}")


def test_histogram_quantiles_match():
    """The count-space (Hobday) and CDF-space (global) quantiles of sparse
    histograms, empty ones included."""
    rng = np.random.default_rng(0)
    hist = (rng.integers(0, 3, (3000, NBINS)) * (rng.random((3000, NBINS)) < 0.05)).astype(np.int32)
    hist[:5] = 0
    hist[5:10, 0] = 7  # everything in the negative bucket
    for q in (0.95, 0.9, 0.6):
        r = np.asarray(ref_q.histogram_quantile_counts(jnp.asarray(hist), q, jnp.asarray(CENTERS)))
        p = port_q.histogram_quantile_counts(torch.from_numpy(hist), q, torch.from_numpy(CENTERS))
        assert_close(r, p, atol=THR_ATOL, what=f"histogram_quantile_counts q={q}")
        r = np.asarray(ref_q.histogram_quantile_cdf(jnp.asarray(hist[10:]), q, jnp.asarray(CENTERS)))
        p = port_q.histogram_quantile_cdf(torch.from_numpy(hist[10:]), q, torch.from_numpy(CENTERS))
        assert_close(r, p, atol=THR_ATOL, what=f"histogram_quantile_cdf q={q}")


@pytest.fixture(scope="module")
def hobday_ref_thresholds():
    """The reference's untiled thresholds of one bin stack, by (window_spatial, wrap_lon)."""
    bins = _bins_ymd()
    cache = {}

    def get(window_spatial, wrap_lon):
        if (window_spatial, wrap_lon) not in cache:
            cache[window_spatial, wrap_lon] = np.asarray(ref_q.hobday_thresholds_approx(
                jnp.asarray(bins), 0.95, 11, NBINS, jnp.asarray(CENTERS), window_spatial, GRID, wrap_lon))
        return cache[window_spatial, wrap_lon]

    return bins, get


@pytest.mark.parametrize(
    "window_spatial, wrap_lon, budget_cells",
    [
        (5, True, None),  # one tile
        (5, True, 120),  # full-width bands of 2 rows: both poles
        (5, True, 50),  # 3 x 3 squares: the lon seam and both poles, ragged last column
        (5, True, 26),  # one cell a tile
        (3, False, 40),  # truncated lon
        (None, True, 30),  # no spatial window
    ],
)
def test_hobday_thresholds_approx_matches_untiled_and_tiled(hobday_ref_thresholds, monkeypatch, window_spatial,
                                                           wrap_lon, budget_cells):
    bins, ref_thr = hobday_ref_thresholds
    args = (torch.from_numpy(bins), 0.95, 11, NBINS, torch.from_numpy(CENTERS), window_spatial, GRID, wrap_lon)
    whole = port_q.hobday_thresholds_approx(*args)
    if budget_cells is not None:
        monkeypatch.setitem(port_q._HIST_TILE_BYTES, "cpu", budget_cells * CELL_BYTES)
        tiles = list(port_q.hobday_tiles(args[0], NBINS, GRID, port_q._halo(window_spatial), wrap_lon,
                                         budget_cells * CELL_BYTES))
        assert len(tiles) > 1
        tiled = port_q.hobday_thresholds_approx(*args)
        assert torch.equal(torch.nan_to_num(tiled, 9.0), torch.nan_to_num(whole, 9.0))
    assert_close(ref_thr(window_spatial, wrap_lon), whole, atol=THR_ATOL, what="hobday thresholds")


def test_hobday_extremes_from_reference_anomalies(anomalies, ref_hobday):
    r_ext, r_thr = ref_hobday
    p_ext, p_thr = port.identify_extremes(from_reference(anomalies, "cpu"), method_extreme="hobday_extreme",
                                          device="cpu", quiet=True)
    assert_close(r_thr.values, p_thr.data, atol=THR_ATOL, what="thresholds")
    assert_same(r_ext.values, p_ext.data, "extreme_events")
    assert p_thr.dims == r_thr.dims == ("dayofyear", "lat", "lon")
    for name in ("dayofyear", "lat", "lon"):
        np.testing.assert_array_equal(p_thr.coords[name].values, r_thr.coords[name].values)


@pytest.mark.parametrize("method_extreme", ["hobday_extreme", "global_extreme"])
def test_exact_thresholds_from_reference_anomalies(anomalies, method_extreme):
    kw = dict(method_extreme=method_extreme, method_percentile="exact", quiet=True)
    r_ext, r_thr = ref.identify_extremes(anomalies, **kw)
    p_ext, p_thr = port.identify_extremes(from_reference(anomalies, "cpu"), device="cpu", **kw)
    assert_close(r_thr.values, p_thr.data, atol=THR_ATOL, what="exact thresholds")
    assert_same(r_ext.values, p_ext.data, "extreme_events")
    assert p_thr.dims == r_thr.dims


def test_exact_quantiles_in_blocks_match_one_block(monkeypatch):
    """A sort budget of a few points a block gives the one-block answer."""
    x = _anomalies((40, 366, 30), seed=8)
    x[:, :, 3] = np.nan
    ymd = torch.from_numpy(x[:3])
    whole_t = port_q.exact_quantile_time(torch.from_numpy(x), 0.9)
    whole_h = port_q.hobday_thresholds_exact(ymd, 0.9, 11)
    monkeypatch.setattr(port_q, "_SORT_BLOCK_ELEMS", 366 * 3 * 11 * 4)
    assert torch.equal(torch.nan_to_num(port_q.exact_quantile_time(torch.from_numpy(x), 0.9), 9.0),
                       torch.nan_to_num(whole_t, 9.0))
    assert torch.equal(torch.nan_to_num(port_q.hobday_thresholds_exact(ymd, 0.9, 11), 9.0),
                       torch.nan_to_num(whole_h, 9.0))
    assert_close(np.asarray(ref_q.hobday_thresholds_exact(jnp.asarray(x[:3]), 0.9, 11)), whole_h, atol=THR_ATOL)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_not_enough_samples_warning_matches(anomalies):
    """One year of data and a 95th percentile: 13.75 < 50 samples above it."""
    one_year = anomalies.isel(time=slice(0, 365))
    out = {}
    for name, pkg, arg, kw in (("ref", ref, one_year, {}),
                               ("port", port, from_reference(one_year, "cpu"), {"device": "cpu"})):
        handler = _Lines()
        logger = logging.getLogger(f"{pkg.__name__}.detect")
        logger.addHandler(handler)
        try:
            pkg.identify_extremes(arg, method_extreme="hobday_extreme", method_percentile="exact", quiet=True, **kw)
        finally:
            logger.removeHandler(handler)
        out[name] = [m for m in handler.lines if "Not enough samples" in m]
    assert out["port"] == out["ref"] and len(out["ref"]) == 1 and "13.75" in out["ref"][0]


def test_hobday_range_warnings_match(anomalies):
    vals = np.array(anomalies.values)
    vals[:, 10:14, 20:30] = 4.996  # in the last bin: thresholds above bin_edges[-2]
    vals[:, 14:22, 0:12] = 0.0  # constant anomaly wider than the 5 x 5 window: thresholds below the lowest edge
    crafted = ref.Field(vals, anomalies.dims, anomalies.coords, name="dat_anomaly")

    def caught(fn):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn()
        return sorted(str(w.message) for w in rec if issubclass(w.category, UserWarning))

    r = caught(lambda: ref.identify_extremes(crafted, method_extreme="hobday_extreme", quiet=True))
    p = caught(lambda: port.identify_extremes(from_reference(crafted, "cpu"), method_extreme="hobday_extreme",
                                              device="cpu", quiet=True))
    assert len(r) == 2 and p == r


@pytest.mark.parametrize(
    "kw",
    [
        dict(method_extreme="hobday_extreme", window_days_hobday=10),
        dict(method_extreme="hobday_extreme", window_spatial_hobday=4),
        dict(method_extreme="hobday_extreme", window_spatial_hobday=3, method_percentile="exact"),
        dict(method_extreme="global_extreme", window_spatial_hobday=3),
        dict(method_extreme="hobday_extreme", method_percentile="exact", precision=0.02),
        dict(method_extreme="global_extreme", method_percentile="exact", max_anomaly=4.0),
        dict(method_extreme="hobday_extreme", threshold_percentile=50),
        dict(method_extreme="bogus"),
    ],
)
def test_identify_extremes_validation_errors_match(anomalies, kw):
    with pytest.raises(ref.ConfigurationError) as r:
        ref.identify_extremes(anomalies, quiet=True, **kw)
    with pytest.raises(port.ConfigurationError) as p:
        port.identify_extremes(from_reference(anomalies, "cpu"), device="cpu", quiet=True, **kw)
    assert (p.value.message, p.value.details) == (r.value.message, r.value.details)
