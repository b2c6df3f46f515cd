"""
The detect programs.

The port of ``marex_tpu/ops/pipeline.py``: the four anomaly methods of
``anomaly_program`` (the fixed day-of-year climatology with
``_doy_nanmean_direct``, the space-tiled shifting baseline, and the two
detrended methods), the day-of-year thresholds of ``hobday_program`` and the
global thresholds of ``global_extreme_program``, each with its approximate
and its exact percentile.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.timeaxis import TimeIndexInfo, gather_from_year_doy, scatter_to_year_doy
from . import climatology as _clim
from . import detrend as _detrend
from . import quantile as _quant

# Cells of one (Y, 366, S_chunk) block of the space-tiled shifting baseline.
# About six such blocks and two (T, S_chunk) ones are live in a chunk: at
# 256M cells that is 7-8 GiB beside the input and the output, which keeps
# detect at full width (720 x 1440) far below half of an 80 GB H100.
_SHIFT_CHUNK_CELLS = 256 * 1024 * 1024

# (T, S_chunk) elements of one float64 block of the detrended anomaly.
_DETREND_CHUNK_ELEMS = 1 << 26


def _unique_doy_chunks(doy_idx: np.ndarray) -> List[Tuple[int, int]]:
    """Split the time axis into consecutive runs in which no day-of-year
    repeats (calendar years, for daily data)."""
    chunks, start, seen = [], 0, set()
    for t, d in enumerate(doy_idx.tolist()):
        if d in seen:
            chunks.append((start, t))
            start, seen = t, set()
        seen.add(d)
    chunks.append((start, len(doy_idx)))
    return chunks


def _doy_index(doy_idx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(doy_idx, dtype=np.int64)).to(device)


def _doy_nanmean_direct(data: torch.Tensor, doy_idx: np.ndarray, clim_time_mask: np.ndarray) -> torch.Tensor:
    """
    Per-day-of-year nanmean of a (T, *spatial) block: (366, *spatial) sums
    and counts, accumulated one run of distinct days (one year) at a time,
    in time order. Inside a run every index is unique, so the indexed add has
    no collisions: each (doy, point) sum is taken in the reference's order,
    deterministically on every device.
    """
    sp = tuple(data.shape[1:])
    sums = torch.zeros((366,) + sp, dtype=torch.float32, device=data.device)
    cnts = torch.zeros_like(sums)
    doy = _doy_index(doy_idx, data.device)
    tmask = torch.from_numpy(np.asarray(clim_time_mask, dtype=bool)).to(data.device)
    for a, b in _unique_doy_chunks(doy_idx):
        db = data[a:b]
        valid = torch.isfinite(db) & tmask[a:b].view((-1,) + (1,) * len(sp))
        sums.index_add_(0, doy[a:b], torch.where(valid, db, 0.0))
        cnts.index_add_(0, doy[a:b], valid.to(torch.float32))
    return torch.where(cnts > 0, sums / cnts, torch.nan)


def doy_op(op, data: torch.Tensor, per_doy: torch.Tensor, doy_idx: np.ndarray, out: torch.Tensor) -> torch.Tensor:
    """``out = op(data, per_doy[doy])`` for a binary torch op (``torch.sub``,
    ``torch.div``, ``torch.ge``), one year at a time so that the gathered
    (366, *spatial) table is at most a year long."""
    doy = _doy_index(doy_idx, data.device)
    for a, b in _unique_doy_chunks(doy_idx):
        op(data[a:b], per_doy.index_select(0, doy[a:b]), out=out[a:b])
    return out


def fixed_baseline_anomaly(
    data: torch.Tensor, doy_idx: np.ndarray, clim_time_mask: np.ndarray, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """
    Anomaly from a fixed daily climatology, ``data - clim[doy]`` (float32).
    ``out`` receives the result; passing ``data`` itself computes in place.
    """
    clim = _doy_nanmean_direct(data, doy_idx, clim_time_mask)
    return doy_op(torch.sub, data, clim, doy_idx, torch.empty_like(data) if out is None else out)


def shifting_baseline_anomaly(
    data: torch.Tensor,
    tinfo: TimeIndexInfo,
    window_year_baseline: int,
    smooth_days_baseline: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """
    Anomaly from the smoothed rolling climatology: the raw data minus the
    mean, over the previous ``window_year_baseline`` years, of the
    ``smooth_days_baseline``-day centred mean on the same day of year. NaN
    for the first ``window_year_baseline`` years. ``data`` is (T, S); every
    step is pointwise in space, so it runs a block of columns at a time
    (``_SHIFT_CHUNK_CELLS``). ``out`` may be ``data`` itself.
    """
    T, S = data.shape
    if out is None:
        out = torch.empty_like(data)
    sc = max(1, _SHIFT_CHUNK_CELLS // (366 * max(tinfo.n_years, 1)))
    for s0 in range(0, S, sc):
        d = data[:, s0 : s0 + sc]
        smoothed = _clim.centered_rolling_mean_time(d, smooth_days_baseline)
        ymd = scatter_to_year_doy(smoothed, tinfo)
        del smoothed
        clim = _clim.rolling_climatology_ymd(ymd, window_year_baseline)
        del ymd
        torch.sub(d, gather_from_year_doy(clim, tinfo), out=out[:, s0 : s0 + sc])
    return out


def detrended_anomaly(
    data: torch.Tensor,
    model: np.ndarray,
    pmodel: np.ndarray,
    force_zero_mean: bool,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """
    ``data`` (T, S) minus its least-squares fit to the design matrix, and
    with ``force_zero_mean`` minus its mean over time, computed in float64 a
    block of columns at a time and rounded once to float32 into ``out``
    (which may be ``data`` itself).
    """
    T, S = data.shape
    if out is None:
        out = torch.empty_like(data)
    m = torch.from_numpy(np.asarray(model, dtype=np.float64)).to(data.device)
    pm = torch.from_numpy(np.asarray(pmodel, dtype=np.float64)).to(data.device)
    step = max(1, _DETREND_CHUNK_ELEMS // max(T, 1))
    for s0 in range(0, S, step):
        anom = _detrend.detrend_subtract(data[:, s0 : s0 + step], m, pm)
        if force_zero_mean:
            anom = _detrend.remove_time_mean(anom)
        out[:, s0 : s0 + step] = anom
    return out


def _nan_range(thr: torch.Tensor) -> Tuple[float, float]:
    """(nanmin, nanmax) of the thresholds as floats; NaN when none is finite."""
    finite = thr[~torch.isnan(thr)]
    if not finite.numel():
        return float("nan"), float("nan")
    return float(finite.min()), float(finite.max())


def _clamp_below(thr: torch.Tensor, lower_bound: float) -> Tuple[torch.Tensor, float, float]:
    """The approximate paths' lower-bound clamp: ``(clamped thresholds,
    pre_min, pre_max)``, the range taken before the clamp."""
    pre_min, pre_max = _nan_range(thr)
    lb = torch.tensor(lower_bound, dtype=torch.float32, device=thr.device)
    return torch.where(thr < lb, lb, thr), pre_min, pre_max


def hobday_program(
    anomalies: torch.Tensor,
    tinfo: TimeIndexInfo,
    q: float,
    precision: float,
    bin_centers: torch.Tensor,
    lower_bound: float,
    nbins: int,
    window_days: int,
    window_spatial: Optional[int],
    grid_shape: Optional[Tuple[int, int]],
    wrap_lon: bool,
    exact: bool,
    halo_rows: Tuple[int, int] = (0, 0),
):
    """
    Day-of-year thresholds and the comparison. ``anomalies`` is (T, S);
    ``grid_shape`` is None on a mesh, which has no spatial window. With
    ``halo_rows = (lo, hi)`` the grid's first ``lo`` and last ``hi`` rows are
    a band's halo: they feed the spatial window of the rows between and are
    left out of every output.
    Returns ``(extremes (T, S) bool, thresholds (366, S) float32, pre_min,
    pre_max)``. The approximate path NaNs land (non-finite at the first
    step) and clamps at ``lower_bound``; ``pre_min``/``pre_max`` are the
    threshold range before the clamp, for the caller's warnings.
    """
    if exact:
        thr = _quant.hobday_thresholds_exact(scatter_to_year_doy(anomalies, tinfo), q, window_days)
        pre_min, pre_max = _nan_range(thr)
    else:
        # digitize then scatter: the sentinel fill is what a NaN bins to
        bins = scatter_to_year_doy(_quant.digitize_anomalies(anomalies, precision, nbins), tinfo, fill=nbins)
        thr = _quant.hobday_thresholds_approx(
            bins, q, window_days, nbins, bin_centers, window_spatial=window_spatial, grid_shape=grid_shape,
            wrap_lon=wrap_lon,
        )
        del bins
        lo, hi = halo_rows
        if lo or hi:
            H, W = grid_shape
            thr = thr.view(-1, H, W)[:, lo : H - hi].reshape(thr.shape[0], -1)
            anomalies = anomalies.view(-1, H, W)[:, lo : H - hi].reshape(anomalies.shape[0], -1)
        thr.masked_fill_(~torch.isfinite(anomalies[0]), torch.nan)
        thr, pre_min, pre_max = _clamp_below(thr, lower_bound)
    extremes = torch.empty(anomalies.shape, dtype=torch.bool, device=anomalies.device)
    doy_op(torch.ge, anomalies, thr, tinfo.dayofyear - 1, extremes)
    return extremes, thr, pre_min, pre_max


def global_extreme_program(
    anomalies: torch.Tensor,
    q: float,
    precision: float,
    bin_centers: torch.Tensor,
    lower_bound: float,
    nbins: int,
    exact: bool,
):
    """
    Global threshold and comparison. Returns ``(extremes, thresholds,
    pre_min, pre_max)``: extremes shaped like ``anomalies``, thresholds like
    one timestep, and the threshold range before the lower-bound clamp (NaN
    when no threshold is finite) for the caller's range warnings. The exact
    path neither masks nor clamps.
    """
    if exact:
        thr = _quant.exact_quantile_time(anomalies, q)
        pre_min, pre_max = _nan_range(thr)
        return anomalies >= thr, thr, pre_min, pre_max
    bins = _quant.digitize_anomalies(anomalies, precision, nbins)
    thr = _quant.global_thresholds_approx(bins, q, nbins, bin_centers)
    del bins
    thr = torch.where(torch.isnan(anomalies).any(dim=0), torch.nan, thr)
    thr, pre_min, pre_max = _clamp_below(thr, lower_bound)
    return anomalies >= thr, thr, pre_min, pre_max
