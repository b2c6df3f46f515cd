"""
The detect programs of the fixed-baseline / global-extreme path.

The port of ``marex_tpu/ops/pipeline.py``: the fixed day-of-year
climatology anomaly (``_doy_nanmean_direct`` and the ``fixed_baseline``
branch of ``anomaly_program``) and the approximate ``global_extreme_program``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import quantile as _quant


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
    doy = torch.from_numpy(doy_idx.astype(np.int64)).to(data.device)
    tmask = torch.from_numpy(np.asarray(clim_time_mask, dtype=bool)).to(data.device)
    for a, b in _unique_doy_chunks(doy_idx):
        db = data[a:b]
        valid = torch.isfinite(db) & tmask[a:b].view((-1,) + (1,) * len(sp))
        sums.index_add_(0, doy[a:b], torch.where(valid, db, 0.0))
        cnts.index_add_(0, doy[a:b], valid.to(torch.float32))
    return torch.where(cnts > 0, sums / cnts, torch.nan)


def fixed_baseline_anomaly(
    data: torch.Tensor, doy_idx: np.ndarray, clim_time_mask: np.ndarray, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """
    Anomaly from a fixed daily climatology, ``data - clim[doy]`` (float32).
    ``out`` receives the result; passing ``data`` itself computes in place.
    """
    clim = _doy_nanmean_direct(data, doy_idx, clim_time_mask)
    if out is None:
        out = torch.empty_like(data)
    doy = torch.from_numpy(doy_idx.astype(np.int64)).to(data.device)
    for a, b in _unique_doy_chunks(doy_idx):  # bounds the gathered climatology to one year
        torch.sub(data[a:b], clim.index_select(0, doy[a:b]), out=out[a:b])
    return out


def global_extreme_program(
    anomalies: torch.Tensor, q: float, precision: float, bin_centers: torch.Tensor, lower_bound: float, nbins: int
):
    """
    Approximate global threshold and comparison. Returns ``(extremes,
    thresholds, pre_min, pre_max)``: extremes shaped like ``anomalies``,
    thresholds like one timestep, and the threshold range before the
    lower-bound clamp (NaN when no threshold is finite) for the caller's
    range warnings.
    """
    bins = _quant.digitize_anomalies(anomalies, precision, nbins)
    thr = _quant.global_thresholds_approx(bins, q, nbins, bin_centers)
    del bins
    thr = torch.where(torch.isnan(anomalies).any(dim=0), torch.nan, thr)
    finite = thr[~torch.isnan(thr)]
    pre_min = float(finite.min()) if finite.numel() else float("nan")
    pre_max = float(finite.max()) if finite.numel() else float("nan")
    lb = torch.tensor(lower_bound, dtype=torch.float32, device=thr.device)
    thr = torch.where(thr < lb, lb, thr)
    return anomalies >= thr, thr, pre_min, pre_max
