"""
Reference detect with a fixed baseline and one global threshold: the
anomaly from the day-of-year nanmean over the whole record, then per point
the approximate ``threshold_percentile`` over all days (a histogram of
0.01-wide bins, the threshold interpolated in CDF space), land NaN, clamped
below at the third bin edge; extremes where the anomaly reaches it.

Writes ``out["dat_anomaly"]``, ``out["mask"]``, ``out["thresholds"]``,
``out["extreme_events"]`` and ``state["extremes"]``, ``state["mask"]`` for
the tracking pieces.
"""

from __future__ import annotations

import torch

from .common import bins, calendar, digitize, quantile_cdf, year_runs

# points of one block of the per-point histograms
_POINTS = 1 << 17


def anomaly(x: torch.Tensor, doy: torch.Tensor, runs) -> torch.Tensor:
    """``x - clim[doy]`` of a (T, S) block, the climatology the per-day mean
    of the finite values, summed a year at a time in time order."""
    S = x.shape[1]
    sums = torch.zeros((366, S), dtype=x.dtype, device=x.device)
    cnts = torch.zeros_like(sums)
    for a, b in runs:
        valid = torch.isfinite(x[a:b])
        sums.index_add_(0, doy[a:b], torch.where(valid, x[a:b], 0.0))
        cnts.index_add_(0, doy[a:b], valid.to(x.dtype))
    clim = torch.where(cnts > 0, sums / cnts, torch.nan)
    out = torch.empty_like(x)
    for a, b in runs:
        torch.sub(x[a:b], clim[doy[a:b]], out=out[a:b])
    return out


def global_threshold(anom: torch.Tensor, q: float, precision: float, max_anomaly: float):
    """Per-point thresholds (S,) float32 and extremes (T, S) of anomalies (T, S)."""
    edges, centres_np = bins(precision, max_anomaly)
    nbins = len(edges) - 1
    centres = torch.from_numpy(centres_np).to(anom.device)
    T, S = anom.shape
    thr = torch.empty(S, dtype=torch.float32, device=anom.device)
    ext = torch.empty((T, S), dtype=torch.bool, device=anom.device)
    for s0 in range(0, S, _POINTS):
        a = anom[:, s0 : s0 + _POINTS]
        n = a.shape[1]
        k = digitize(a, precision, nbins).long() + torch.arange(n, device=a.device) * (nbins + 1)
        hist = torch.bincount(k.reshape(-1), minlength=n * (nbins + 1)).view(n, nbins + 1)[:, :nbins]
        t = quantile_cdf(hist.to(torch.int32), q, centres)
        t = torch.where(torch.isnan(a).any(dim=0), torch.nan, t)
        lb = torch.tensor(float(edges[3]), dtype=torch.float32, device=a.device)
        t = torch.where(t < lb, lb, t)
        thr[s0 : s0 + n] = t
        ext[:, s0 : s0 + n] = a >= t.to(a.dtype)
    return thr, ext


def run(state: dict) -> None:
    inp, mix, out = state["inputs"], state["mix"]["detect"], state["out"]
    sst = inp["sst"]
    T, sp = sst.shape[0], tuple(sst.shape[1:])
    cal = calendar(inp["coords"]["time"])
    doy = torch.from_numpy(cal["doy"]).to(sst.device)
    x = sst.reshape(T, -1).to(state["precision"])
    anom = anomaly(x, doy, year_runs(cal["doy"]))
    del x
    thr, ext = global_threshold(anom, mix["threshold_percentile"] / 100.0, mix.get("precision", 0.01),
                                mix.get("max_anomaly", 5.0))
    mask = torch.isfinite(sst[0])
    out.update(dat_anomaly=anom.view((T,) + sp).float(), mask=mask, thresholds=thr.view(sp),
               extreme_events=ext.view((T,) + sp))
    state.update(extremes=ext.view((T,) + sp), mask=mask, times=inp["coords"]["time"])
