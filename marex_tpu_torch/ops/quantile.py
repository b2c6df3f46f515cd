"""
Percentile thresholds: approximate (histograms) and exact.

The port of ``marex_tpu/ops/quantile.py``: the asymmetric binning (one
``[-inf, -precision)`` bucket, then uniform ``precision`` bins up to
``max_anomaly``); the global path's count-space CDF search with
interpolation, the ``eps = 1e-10`` exact-match rule and the zero-denominator
rule; the Hobday path's (dayofyear, point, bin) count histogram, its spatial
and day-of-year window sums and its count-space quantile; and the exact
nan-quantiles.

Every count is an exact integer sum, so its order does not matter; every
float step is the reference's float32 operation, one PyTorch op each (so no
fused multiply-add changes a rounding), or, where XLA on the CPU contracts
the reference's product and sum into one multiply-add, a float64 step
rounded once. The CPU and CUDA therefore give the same bits, and so does
any tiling of the Hobday histogram.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .climatology import _f32

# Bytes of one tile's (366, cells, nbins + 1) int32 histogram in the Hobday
# path, by device type. Up to four tile-sized buffers are live at once inside
# a tile's window sums, so on the H100 (80 GB) a 4 GiB tile keeps the Hobday
# step near 16 GiB; on the CPU a 1 GiB tile keeps it near 4 GiB. A tile of
# c x c cells computes (c + 2*halo)**2, so smaller tiles cost more.
_HIST_TILE_BYTES = {"cuda": 4 << 30, "cpu": 1 << 30}

# Elements of one (points, samples) block sorted at once by the exact paths
# (the sort also returns int64 indices: about 16 bytes an element in all).
_SORT_BLOCK_ELEMS = 1 << 27


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


def digitize_anomalies(data: torch.Tensor, precision: float, nbins: int) -> torch.Tensor:
    """
    ``np.digitize(data, bin_edges) - 1`` for the asymmetric edges above; NaN
    and out-of-range-high values map to the sentinel bin ``nbins``. Returns
    int16 when the bin count fits (it always does for the default edges):
    the reference's ``compact=True``.
    """
    p = _f32(precision, data)
    # in place where possible: at most one float32 and one int32 field-sized temporary
    k = torch.add(data, p).div_(p).floor_().clamp_(-1, nbins)  # clamp first: no float->int overflow
    k = k.to(torch.int32).add_(1)
    k.masked_fill_(data < -p, 0)
    k.masked_fill_(torch.isnan(data), nbins)
    k.clamp_(0, nbins)
    return k.to(torch.int16) if nbins + 1 <= np.iinfo(np.int16).max else k


# ----------------------------------------------------------------------------
# Global (all-time) thresholds
# ----------------------------------------------------------------------------


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
    return _cdf_interp(cdf_lower, cdf_upper, bin_centers[idx_lower.long()], bin_centers[idx_upper.long()], q32, eps)


def _cdf_interp(cdf_lower, cdf_upper, bin_lower, bin_upper, q32, eps) -> torch.Tensor:
    """CDF-space interpolation between two bin centres, with the exact-match
    and zero-denominator rules."""
    denom = cdf_upper - cdf_lower
    exact_match = torch.abs(cdf_lower - q32) < eps
    zero_denom = torch.abs(denom) <= eps
    frac = (q32 - cdf_lower) / torch.where(torch.abs(denom) > eps, denom, _f32(1.0, denom))
    thr = bin_lower + frac * (bin_upper - bin_lower)
    thr = torch.where(exact_match, bin_lower, thr)
    return torch.where(zero_denom & ~exact_match, (bin_lower + bin_upper) / _f32(2.0, thr), thr)


def histogram_bins_1d(bins_ts: torch.Tensor, nbins: int) -> torch.Tensor:
    """Per-point histogram over all time: (T, S) bins -> (S, nbins) int32
    counts (the sentinel ``nbins`` excluded)."""
    T, S = bins_ts.shape
    base = torch.arange(S, dtype=torch.int64, device=bins_ts.device) * (nbins + 1)
    hist = torch.zeros(S * (nbins + 1), dtype=torch.int32, device=bins_ts.device)
    ones = torch.ones(1, dtype=torch.int32, device=bins_ts.device).expand(S)
    for t in range(T):
        hist.index_add_(0, base + bins_ts[t], ones)
    return hist.view(S, nbins + 1)[:, :nbins]


def histogram_quantile_cdf(hist: torch.Tensor, q: float, bin_centers: torch.Tensor) -> torch.Tensor:
    """CDF-space quantile with the reference's tail rules, vectorised over
    the leading axes of a (..., nbins) count histogram (the dense form of
    :func:`global_thresholds_approx`)."""
    nbins = hist.shape[-1]
    eps = _f32(1e-10, bin_centers)
    q32 = _f32(q, bin_centers)
    total = hist.sum(dim=-1, keepdim=True, dtype=torch.int32).to(torch.float32) + eps
    cdf = hist.cumsum(dim=-1, dtype=torch.int32).to(torch.float32) / total

    def first_true(cond: torch.Tensor) -> torch.Tensor:  # argmax over bools: 0 when none
        return cond.to(torch.uint8).argmax(dim=-1)

    idx_upper = first_true(cdf >= (q32 - eps))
    idx_before = torch.where(idx_upper - 1 > 0, idx_upper - 1, 0)
    cdf_target = torch.gather(cdf, -1, idx_before[..., None])
    idx_lower = first_true(cdf > cdf_target)
    idx_lower = torch.clamp(idx_lower, 0, nbins - 2)
    idx_upper = torch.clamp(idx_upper, 1, nbins - 1)
    cdf_lower = torch.gather(cdf, -1, idx_lower[..., None])[..., 0]
    cdf_upper = torch.gather(cdf, -1, idx_upper[..., None])[..., 0]
    return _cdf_interp(cdf_lower, cdf_upper, bin_centers[idx_lower], bin_centers[idx_upper], q32, eps)


# ----------------------------------------------------------------------------
# Hobday (day-of-year) thresholds from histograms
# ----------------------------------------------------------------------------


def histogram_doy_bins(bins_ymd: torch.Tensor, nbins: int) -> torch.Tensor:
    """
    (dayofyear, bin) count histogram per point: (Y, D, S) bins -> (D, S,
    nbins) int32, the sentinel bin ``nbins`` dropped. One integer
    ``index_add_`` a year over a flat (D, S, nbins + 1) buffer.
    """
    Y, D, S = bins_ymd.shape
    n = D * S * (nbins + 1)
    dev = bins_ymd.device
    itype = torch.int32 if n < 2**31 else torch.int64
    base = (torch.arange(D * S, dtype=itype, device=dev) * (nbins + 1)).view(D, S)
    hist = torch.zeros(n, dtype=torch.int32, device=dev)
    ones = torch.ones(1, dtype=torch.int32, device=dev).expand(D * S)
    for y in range(Y):
        hist.index_add_(0, (base + bins_ymd[y]).view(-1), ones)
    return hist.view(D, S, nbins + 1)[..., :nbins]


def window_sum_int(x: torch.Tensor, window: int, dim: int) -> torch.Tensor:
    """``out[i] = x[i] + ... + x[i+window-1]`` along ``dim`` of an integer
    tensor, by one int32 prefix sum and one difference (exact, in any
    order); ``x.shape[dim] - window + 1`` entries."""
    c = x.cumsum(dim=dim, dtype=torch.int32)
    n = x.shape[dim] - window + 1
    out = torch.empty_like(c.narrow(dim, 0, n))
    out.narrow(dim, 0, 1).copy_(c.narrow(dim, window - 1, 1))
    torch.sub(c.narrow(dim, window, n - 1), c.narrow(dim, 0, n - 1), out=out.narrow(dim, 1, n - 1))
    return out


def rolling_doy_window_sum(hist: torch.Tensor, window: int) -> torch.Tensor:
    """Centred rolling sum over the day-of-year axis (dim 0), wrapped around
    the year: the windowed histogram."""
    pad = window // 2
    if pad == 0:
        return hist
    return window_sum_int(torch.cat([hist[-pad:], hist, hist[:pad]], dim=0), window, 0)


def rolling_axis_sum(hist: torch.Tensor, window: int, axis: int, wrap: bool) -> torch.Tensor:
    """Centred rolling sum along ``axis``: circular when ``wrap``, else
    truncated at the edges (only the cells that exist are summed). The
    untiled spatial window; the tiles of :func:`hobday_thresholds_approx`
    get the same sums from their halos (:func:`pool_tile_spatial`)."""
    half = window // 2
    if half == 0:
        return hist
    if wrap:
        padded = torch.cat([hist.narrow(axis, hist.shape[axis] - half, half), hist, hist.narrow(axis, 0, half)], axis)
    else:
        zeros = torch.zeros_like(hist.narrow(axis, 0, 1)).expand(
            *[half if d == axis % hist.ndim else s for d, s in enumerate(hist.shape)]
        )
        padded = torch.cat([zeros, hist, zeros], axis)
    return window_sum_int(padded, window, axis)


def histogram_quantile_counts(hist_windowed: torch.Tensor, q: float, bin_centers: torch.Tensor) -> torch.Tensor:
    """
    Count-space quantile of (..., nbins) windowed counts: cumulative counts,
    position ``q * total``, the upper bin by searchsorted-right, and linear
    interpolation between bin centres in count space. NaN where the total is
    0. Returns (...) float32.
    """
    nbins = hist_windowed.shape[-1]
    cums = hist_windowed.cumsum(dim=-1, dtype=torch.int32)
    total = cums[..., -1]
    pos = _f32(q, bin_centers) * total.to(torch.float32)
    # searchsorted(cums, pos, side="right") == count of entries <= pos; the
    # counts (< 2**24) compare as exact float32, as in the reference
    idx_upper = (cums <= pos[..., None]).sum(dim=-1, dtype=torch.int32).clamp_(0, nbins - 1)
    idx_lower = (idx_upper - 1).clamp_(min=0)
    count_lower = torch.gather(cums, -1, idx_lower.long()[..., None])[..., 0].to(torch.float32)
    count_upper = torch.gather(cums, -1, idx_upper.long()[..., None])[..., 0].to(torch.float32)
    del cums
    bin_lower = bin_centers[idx_lower.long()]
    bin_upper = bin_centers[idx_upper.long()]
    eps = _f32(1e-10, bin_centers)
    diff = count_upper - count_lower
    wide = diff > eps
    # XLA on the CPU contracts the reference's `q * total - count_lower` into
    # one fused multiply-add: round that difference once, from float64 (the
    # product of two float32 values is exact there) ...
    over = (_f32(q, bin_centers).double() * total.double() - count_lower.double()).to(torch.float32)
    frac = torch.where(wide, over / torch.where(wide, diff, _f32(1.0, diff)), _f32(0.5, diff))
    # ... and the interpolation into fma(frac, upper - lower, lower)
    thr = (bin_lower.double() + frac.double() * (bin_upper - bin_lower).double()).to(torch.float32)
    thr = torch.where(total > 0, thr, torch.nan)
    return torch.where((idx_upper == 0) & (total > 0), bin_centers[0], thr)


def hobday_tiles(
    bins_ymd: torch.Tensor, nbins: int, grid_shape: Tuple[int, int], halo: int, wrap_lon: bool, tile_bytes: int
) -> Iterator[Tuple[torch.Tensor, Tuple[slice, slice], Tuple[int, int]]]:
    """
    Space tiles of a (Y, D, ny*nx) bin stack for the Hobday histogram:
    yields ``(tile, (rows, cols), (nr, nc))``, a (Y, D, tr + 2*halo,
    tc + 2*halo) block whose core rows and columns land at ``rows, cols``
    of the (ny, nx) grid (the first ``nr`` x ``nc`` of the core are inside it).

    The halos are baked into one padded copy: wrapped columns across the
    lon seam when ``wrap_lon`` (else the sentinel), sentinel rows beyond the
    poles (zero counts: the truncated window at the edges). The tiles are
    full-width row bands when one halo'd row fits ``tile_bytes`` of
    histogram, else squares (wider where the grid has fewer rows than a
    square's side).
    """
    Y, D, _ = bins_ymd.shape
    ny, nx = grid_shape
    budget = max(1, tile_bytes // (D * (nbins + 1) * 4))
    if (1 + 2 * halo) * (nx + 2 * halo) <= budget:
        tc, tr = nx, min(ny, max(1, budget // (nx + 2 * halo) - 2 * halo))
    else:
        side = max(1, math.isqrt(budget) - 2 * halo)
        tr = min(ny, side)
        # a grid with fewer rows than a square's side (a mesh is one row) gets wider tiles
        tc = min(nx, side if tr == side else max(side, budget // (tr + 2 * halo) - 2 * halo))
    nty, ntx = -(-ny // tr), -(-nx // tc)

    b = bins_ymd.view(Y, D, ny, nx)
    sentinel = bins_ymd.new_full((Y, D, ny, halo), nbins)
    left, right = (b[..., nx - halo :], b[..., :halo]) if wrap_lon and halo else (sentinel, sentinel)
    b = torch.cat([left, b, right, bins_ymd.new_full((Y, D, ny, ntx * tc - nx), nbins)], dim=3)
    rows = bins_ymd.new_full((Y, D, halo, b.shape[3]), nbins)
    b = torch.cat([rows, b, rows, bins_ymd.new_full((Y, D, nty * tr - ny, b.shape[3]), nbins)], dim=2)
    for i in range(nty):
        for j in range(ntx):
            r0, c0 = i * tr, j * tc
            tile = b[:, :, r0 : r0 + tr + 2 * halo, c0 : c0 + tc + 2 * halo]
            yield tile, (slice(r0, r0 + tr), slice(c0, c0 + tc)), (min(tr, ny - r0), min(tc, nx - c0))


def pool_tile_spatial(hist: torch.Tensor, halo: int) -> torch.Tensor:
    """The spatial window sum of a halo'd tile's (D, th, tw, nbins) counts at
    its core cells: (D, th - 2*halo, tw - 2*halo, nbins). The halos hold the
    wrapped or sentinel neighbours, so plain window sums give the untiled
    wrapped-lon, truncated-lat window."""
    if halo == 0:
        return hist
    return window_sum_int(window_sum_int(hist, 2 * halo + 1, 2), 2 * halo + 1, 1)


def _hobday_tile(tile: torch.Tensor, q: float, window_days: int, nbins: int, bin_centers, halo: int) -> torch.Tensor:
    """Thresholds at one tile's core cells: histogram -> spatial window ->
    day-of-year window -> count-space quantile. (D, tr, tc) float32."""
    Y, D, th, tw = tile.shape
    hist = histogram_doy_bins(tile.reshape(Y, D, th * tw), nbins).view(D, th, tw, nbins)
    hist = pool_tile_spatial(hist, halo)
    hist = rolling_doy_window_sum(hist, window_days)
    return histogram_quantile_counts(hist, q, bin_centers)


def _halo(window_spatial: Optional[int]) -> int:
    return window_spatial // 2 if window_spatial is not None and window_spatial > 1 else 0


def hobday_thresholds_approx(
    bins_ymd: torch.Tensor,
    q: float,
    window_days: int,
    nbins: int,
    bin_centers: torch.Tensor,
    window_spatial: Optional[int] = None,
    grid_shape: Optional[Tuple[int, int]] = None,
    wrap_lon: bool = True,
) -> torch.Tensor:
    """
    Approximate Hobday thresholds from a (Y, 366, S) bin stack (sentinel
    ``nbins`` = no sample): per (dayofyear, point), the count-space quantile
    of all samples within ``window_days`` days (wrapped around the year) and,
    on a grid, the ``window_spatial`` x ``window_spatial`` neighbourhood
    (wrapped in lon when ``wrap_lon``, truncated in lat). Returns (366, S)
    float32; the caller masks land.

    The (366, S, nbins) histogram is built tile by tile
    (:func:`hobday_tiles`, ``_HIST_TILE_BYTES`` of the device type); each
    tile gives the untiled answer at its core cells.
    """
    Y, D, S = bins_ymd.shape
    grid = grid_shape if grid_shape is not None else (1, S)
    halo = _halo(window_spatial) if grid_shape is not None else 0
    tile_bytes = _HIST_TILE_BYTES.get(bins_ymd.device.type, _HIST_TILE_BYTES["cpu"])
    out = torch.empty((D,) + tuple(grid), dtype=torch.float32, device=bins_ymd.device)
    for tile, (rows, cols), (nr, nc) in hobday_tiles(bins_ymd, nbins, grid, halo, wrap_lon, tile_bytes):
        thr = _hobday_tile(tile, q, window_days, nbins, bin_centers, halo)
        out[:, rows.start : rows.start + nr, cols.start : cols.start + nc] = thr[:, :nr, :nc]
    return out.view(D, S)


# ----------------------------------------------------------------------------
# Exact quantiles
# ----------------------------------------------------------------------------


def _nanquantile_sorted(srt: torch.Tensor, q: float) -> torch.Tensor:
    """Linear nan-quantile along the last dim of ascending-sorted samples
    (NaN last), in the reference's float32 arithmetic: position ``q * (n-1)``
    over the ``n`` finite samples, ``low * (1 - w) + high * w``."""
    counts = (~torch.isnan(srt)).sum(dim=-1, dtype=torch.int32).to(torch.float32)
    pos = _f32(q, srt) * (counts - _f32(1.0, srt))
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = _f32(1.0, srt) - high_w
    last = counts - _f32(1.0, srt)
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, last)).long()
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, last)).long()
    low_v = torch.gather(srt, -1, low[..., None])[..., 0]
    high_v = torch.gather(srt, -1, high[..., None])[..., 0]
    # XLA on the CPU contracts the reference's sum into fma(high, w, low * (1 - w))
    return ((low_v * low_w).double() + high_v.double() * high_w.double()).to(torch.float32)


def exact_quantile_time(data: torch.Tensor, q: float) -> torch.Tensor:
    """Exact (linearly interpolated) nan-quantile along dim 0 (time) of a
    (T, *spatial) block; (*spatial,) float32. Sorted a block of points at a
    time."""
    T = data.shape[0]
    flat = data.reshape(T, -1)
    S = flat.shape[1]
    out = torch.empty(S, dtype=torch.float32, device=data.device)
    step = max(1, _SORT_BLOCK_ELEMS // max(T, 1))
    for s0 in range(0, S, step):
        srt = torch.sort(flat[:, s0 : s0 + step].t(), dim=-1).values
        out[s0 : s0 + step] = _nanquantile_sorted(srt, q)
    return out.view(data.shape[1:])


def hobday_thresholds_exact(data_ymd: torch.Tensor, q: float, window_days: int) -> torch.Tensor:
    """
    Exact day-of-year thresholds from a (Y, 366, S) block (NaN = no sample):
    for each day, the nan-quantile of all years' samples whose day of year
    lies within the wrapped ``window_days`` window. Returns (366, S) float32.
    Sorted a block of points at a time.
    """
    Y, D, S = data_ymd.shape
    half = window_days // 2
    W = 2 * half + 1
    dev = data_ymd.device
    doys = (torch.arange(D, device=dev)[:, None] + torch.arange(-half, half + 1, device=dev)[None]) % D  # (D, W)
    out = torch.empty((D, S), dtype=torch.float32, device=dev)
    step = max(1, _SORT_BLOCK_ELEMS // (D * Y * W))
    for s0 in range(0, S, step):
        blk = data_ymd[:, :, s0 : s0 + step]  # (Y, D, s)
        win = blk[:, doys.view(-1)].view(Y, D, W, -1)  # (Y, D, W, s)
        win = win.permute(1, 3, 0, 2).reshape(D, blk.shape[2], Y * W)
        out[:, s0 : s0 + step] = _nanquantile_sorted(torch.sort(win, dim=-1).values, q)
    return out
