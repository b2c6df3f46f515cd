"""
Approximate global-in-time percentile thresholds.

The port of the global path of ``marex_tpu/ops/quantile.py``: the
asymmetric binning (one ``[-inf, -precision)`` bucket, then uniform
``precision`` bins up to ``max_anomaly``) and the count-space CDF search with
interpolation, the ``eps = 1e-10`` exact-match rule and the zero-denominator
rule. The CDF counts are exact integer sums; every float step is the
reference's float32 operation, one PyTorch op each (so no fused multiply-add
changes a rounding).
"""

from __future__ import annotations

import numpy as np
import torch


def make_bin_edges(precision: float = 0.01, max_anomaly: float = 5.0) -> np.ndarray:
    """Asymmetric bin edges: [-inf, -precision, 0, precision, ..., max_anomaly]."""
    return np.concatenate(
        [[-np.inf], np.arange(-precision, max_anomaly + precision, precision, dtype=np.float32)]
    ).astype(np.float32)


def make_bin_centers(bin_edges: np.ndarray) -> np.ndarray:
    """Bin centres with the negative bucket centred at 0."""
    centers = (bin_edges[1:] + bin_edges[:-1]) / 2
    centers[0] = 0.0
    return centers.astype(np.float32)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device: keeps scalar arithmetic
    in float32 on every device (a Python scalar divisor on CUDA turns a
    division into a multiplication by the reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def digitize_anomalies(data: torch.Tensor, precision: float, nbins: int) -> torch.Tensor:
    """
    ``np.digitize(data, bin_edges) - 1`` for the asymmetric edges above; NaN
    and out-of-range-high values map to the sentinel bin ``nbins``. Returns
    int16 when the bin count fits (it always does for the default edges).
    """
    p = _f32(precision, data)
    # in place where possible: at most one float32 and one int32 field-sized temporary
    k = torch.add(data, p).div_(p).floor_().clamp_(-1, nbins)  # clamp first: no float->int overflow
    k = k.to(torch.int32).add_(1)
    k.masked_fill_(data < -p, 0)
    k.masked_fill_(torch.isnan(data), nbins)
    k.clamp_(0, nbins)
    return k.to(torch.int16) if nbins + 1 <= np.iinfo(np.int16).max else k


def global_thresholds_approx(bins_ts: torch.Tensor, q: float, nbins: int, bin_centers: torch.Tensor) -> torch.Tensor:
    """
    Approximate global-in-time thresholds: (T, *spatial) bins -> (*spatial,)
    float32 thresholds. The CDF at a bin index is one compare+count pass over
    time; the searches are binary searches, as in the reference.
    """
    eps = _f32(1e-10, bin_centers)
    q32 = _f32(q, bin_centers)
    # the sentinel bin (NaN / overflow) is excluded: every probe below is
    # < nbins, so `bins <= k` already implies a valid bin. Counts accumulate
    # in int32: a bool sum first casts the whole field to its accumulator type
    total = (bins_ts < nbins).sum(dim=0, dtype=torch.int32).to(torch.float32) + eps

    def cdf_at(k: torch.Tensor) -> torch.Tensor:
        c = (bins_ts <= k.to(bins_ts.dtype)).sum(dim=0, dtype=torch.int32)
        return c.to(torch.float32) / total

    n_steps = max(1, int(np.ceil(np.log2(nbins))))

    def search_first(target: torch.Tensor, strict: bool) -> torch.Tensor:
        """Smallest k in [0, nbins-1] with cdf(k) > target (strict) or >= target;
        0 when no k satisfies."""
        lo = torch.zeros(target.shape, dtype=torch.int32, device=target.device)
        hi = torch.full_like(lo, nbins - 1)
        for _ in range(n_steps):
            mid = (lo + hi) // 2
            c = cdf_at(mid)
            ok = (c > target) if strict else (c >= target)
            lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
        c_final = cdf_at(lo)
        found = (c_final > target) if strict else (c_final >= target)
        return torch.where(found, lo, 0)

    idx_upper = search_first((q32 - eps).expand(total.shape), strict=False)
    idx_before = torch.where(idx_upper - 1 > 0, idx_upper - 1, 0)
    idx_lower = search_first(cdf_at(idx_before), strict=True)

    idx_lower = torch.clamp(idx_lower, 0, nbins - 2)
    idx_upper = torch.clamp(idx_upper, 1, nbins - 1)

    cdf_lower = cdf_at(idx_lower)
    cdf_upper = cdf_at(idx_upper)
    bin_lower = bin_centers[idx_lower.long()]
    bin_upper = bin_centers[idx_upper.long()]

    denom = cdf_upper - cdf_lower
    exact_match = torch.abs(cdf_lower - q32) < eps
    zero_denom = torch.abs(denom) <= eps
    frac = (q32 - cdf_lower) / torch.where(torch.abs(denom) > eps, denom, _f32(1.0, denom))
    thr = bin_lower + frac * (bin_upper - bin_lower)
    thr = torch.where(exact_match, bin_lower, thr)
    return torch.where(zero_denom & ~exact_match, (bin_lower + bin_upper) / _f32(2.0, thr), thr)
