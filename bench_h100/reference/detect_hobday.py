"""
Reference detect with the upstream defaults: the shifting baseline (the SST
minus the mean, over the ``window_year_baseline`` previous years, of its
``smooth_days_baseline``-day centred mean on the same day of year; the first
years, which have no baseline, are dropped), then Hobday thresholds: per day
of year and point, the approximate ``threshold_percentile`` of every sample
within ``window_days_hobday`` days (wrapped around the year) and the
``window_spatial_hobday`` x ``window_spatial_hobday`` neighbourhood (5 by
default on a grid; wrapped in longitude, cut at the poles), interpolated in
count space; land NaN, clamped below at the third bin edge.

Writes the same keys as ``detect_fixed``.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import bins, calendar, digitize, f32, window_sum

# spatial points of one block of the shifting baseline
_POINTS = 1 << 18
# core rows of one band of the Hobday histogram
_ROWS = 4


def shifting_baseline(x: torch.Tensor, cal: dict, years: int, smooth: int) -> torch.Tensor:
    """Anomalies (T, S) of ``x`` (T, S) against the smoothed rolling climatology."""
    T, S = x.shape
    Y = cal["n_years"]
    yi = torch.from_numpy(cal["year_index"]).to(x.device)
    di = torch.from_numpy(cal["doy"]).to(x.device)
    out = torch.empty_like(x)
    left = smooth // 2
    for s0 in range(0, S, _POINTS):
        d = x[:, s0 : s0 + _POINTS]
        sm = torch.full_like(d, torch.nan)
        acc = window_sum(torch.where(torch.isfinite(d), d, torch.nan), smooth)
        sm[left : left + acc.shape[0]] = acc / f32(float(smooth), acc)
        del acc
        ymd = torch.full((Y, 366, d.shape[1]), torch.nan, dtype=x.dtype, device=x.device)
        ymd[yi, di] = sm
        del sm
        clim = torch.full_like(ymd, torch.nan)
        if Y > years >= 1:
            fin = torch.isfinite(ymd[:-1])
            wsum = window_sum(torch.where(fin, ymd[:-1], 0.0), years)
            wcnt = window_sum(fin.to(torch.int32), years)
            clim[years:] = torch.where(wcnt > 0, wsum / wcnt.to(x.dtype), torch.nan)
        out[:, s0 : s0 + _POINTS] = d - clim[yi, di]
    return out


def count_quantile(h: torch.Tensor, q: float, centres: torch.Tensor) -> torch.Tensor:
    """The Hobday threshold from (..., nbins) windowed counts: position
    ``q * total`` among the cumulative counts, the upper bin the number of
    bins whose count is at most that, and interpolation in count space
    between the centres (products and sums rounded once, from float64). NaN
    where there is no sample."""
    nb = h.shape[-1]
    cums = h.cumsum(dim=-1, dtype=torch.int32)
    total = cums[..., -1]
    q32 = f32(q, centres)
    pos = q32 * total.to(torch.float32)
    upper = (cums <= pos[..., None]).sum(dim=-1, dtype=torch.int32).clamp(0, nb - 1).long()
    lower = (upper - 1).clamp(min=0)
    c_lo = torch.gather(cums, -1, lower[..., None])[..., 0].to(torch.float32)
    c_up = torch.gather(cums, -1, upper[..., None])[..., 0].to(torch.float32)
    del cums
    b_lo, b_up = centres[lower], centres[upper]
    diff = c_up - c_lo
    wide = diff > f32(1e-10, centres)
    over = (q32.double() * total.double() - c_lo.double()).to(torch.float32)
    frac = torch.where(wide, over / torch.where(wide, diff, f32(1.0, diff)), f32(0.5, diff))
    thr = (b_lo.double() + frac.double() * (b_up - b_lo).double()).to(torch.float32)
    thr = torch.where(total > 0, thr, torch.nan)
    return torch.where((upper == 0) & (total > 0), centres[0], thr)


def hobday_thresholds(anom: torch.Tensor, cal: dict, grid: tuple, q: float, window_days: int, window_spatial: int,
                      precision: float, max_anomaly: float) -> torch.Tensor:
    """(366, H, W) thresholds of anomalies (T, H*W), a band of rows at a time."""
    edges, centres_np = bins(precision, max_anomaly)
    nbins = len(edges) - 1
    centres = torch.from_numpy(centres_np).to(anom.device)
    H, W = grid
    h = window_spatial // 2
    Y = cal["n_years"]
    dev = anom.device
    b = torch.full((Y, 366, H + 2 * h, W + 2 * h), nbins, dtype=torch.int16, device=dev)
    k = digitize(anom, precision, nbins).view(-1, H, W)
    yi = torch.from_numpy(cal["year_index"]).to(dev)
    di = torch.from_numpy(cal["doy"]).to(dev)
    core = b[:, :, h : h + H]
    core[yi, di, :, h : h + W] = k
    if h:  # longitude wraps; rows past the poles stay empty
        core[yi, di, :, :h] = k[:, :, W - h :]
        core[yi, di, :, W + h :] = k[:, :, :h]
    del k
    pad = window_days // 2
    out = torch.empty((366, H, W), dtype=torch.float32, device=dev)
    for r0 in range(0, H, _ROWS):
        r1 = min(H, r0 + _ROWS)
        tile = b[:, :, r0 : r1 + 2 * h].reshape(Y, 366, -1).long()
        n = tile.shape[-1]
        idx = torch.arange(366, device=dev)[:, None] * n + torch.arange(n, device=dev)[None, :]
        hist = torch.zeros(366 * n * (nbins + 1), dtype=torch.int32, device=dev)
        for y in range(Y):
            hist.index_add_(0, (idx * (nbins + 1) + tile[y]).view(-1), torch.ones(1, dtype=torch.int32, device=dev).expand(366 * n))
        hist = hist.view(366, r1 - r0 + 2 * h, W + 2 * h, nbins + 1)[..., :nbins]
        if h:
            hist = window_sum(window_sum(hist, 2 * h + 1, 2), 2 * h + 1, 1)
        if pad:
            hist = window_sum(torch.cat([hist[-pad:], hist, hist[:pad]]), 2 * pad + 1, 0)
        out[:, r0:r1] = count_quantile(hist, q, centres)
        del hist, tile
    return out


def run(state: dict) -> None:
    inp, mix, out = state["inputs"], state["mix"]["detect"], state["out"]
    sst = inp["sst"]
    T, sp = sst.shape[0], tuple(sst.shape[1:])
    times = np.asarray(inp["coords"]["time"])
    cal = calendar(times)
    years = mix["window_year_baseline"]
    anom = shifting_baseline(sst.reshape(T, -1).to(state["precision"]), cal, years, mix["smooth_days_baseline"])
    mask = torch.isfinite(sst[0])
    keep = np.nonzero(cal["year"] >= cal["year"].min() + years)[0]
    anom = anom[torch.from_numpy(keep).to(sst.device)]
    times = times[keep]
    cal = calendar(times)
    precision, max_anomaly = mix.get("precision", 0.01), mix.get("max_anomaly", 5.0)
    thr = hobday_thresholds(anom, cal, sp, mix["threshold_percentile"] / 100.0, mix["window_days_hobday"],
                            mix.get("window_spatial_hobday") or 5, precision, max_anomaly)
    thr = thr.view(366, -1)
    thr = torch.where(torch.isfinite(anom[0]), thr, torch.nan)
    lb = torch.tensor(float(bins(precision, max_anomaly)[0][3]), dtype=torch.float32, device=thr.device)
    thr = torch.where(thr < lb, lb, thr)
    doy = torch.from_numpy(cal["doy"]).to(sst.device)
    ext = anom >= thr[doy].to(anom.dtype)
    Tk = anom.shape[0]
    out.update(dat_anomaly=anom.view((Tk,) + sp).float(), mask=mask, thresholds=thr.view((366,) + sp),
               extreme_events=ext.view((Tk,) + sp))
    state.update(extremes=ext.view((Tk,) + sp), mask=mask, times=times)
