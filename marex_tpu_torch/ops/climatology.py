"""
Climatology steps on the dense ``(year, dayofyear, space)`` layout.

The port of ``marex_tpu/ops/climatology.py``: the shifting-baseline rolling
climatology over previous years, the centred rolling mean along time, the
per-day-of-year mean and standard deviation over years, and the wrapped
rolling RMS of ``std_normalise``.

Every windowed or per-year sum is a fixed sequence of elementwise float32
adds of shifted slices, first term first: no ``cumsum``, whose order of
additions differs between devices (and from XLA's). Each output element is
the same chain of correctly rounded adds on the CPU and on CUDA, so the two
agree bit for bit. The reference builds the same windows from float32 prefix
sums over the whole series; a direct window sum is closer to a float64
oracle than those (``tests/test_torch_climatology.py`` states both
distances).
"""

from __future__ import annotations

import torch


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device: keeps scalar arithmetic
    in float32 on every device (a Python scalar divisor on CUDA turns a
    division into a multiplication by the reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def window_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """``out[i] = x[i] + x[i+1] + ... + x[i+window-1]`` along dim 0, added in
    that order; ``x.shape[0] - window + 1`` rows (``window >= 1``)."""
    n = x.shape[0] - window + 1
    acc = x[0:n].clone()
    for k in range(1, window):
        acc += x[k : k + n]
    return acc


def year_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 (years), in year order."""
    return window_sum(x, x.shape[0])[0]


def nanmean_over_years(ymd: torch.Tensor) -> torch.Tensor:
    """Fixed daily climatology: the nanmean of a (Y, 366, *spatial) block over
    years; NaN where a (day, point) has no finite sample."""
    finite = torch.isfinite(ymd)
    total = year_sum(torch.where(finite, ymd, 0.0))
    count = finite.sum(dim=0, dtype=torch.int32)
    return torch.where(count > 0, total / count.to(torch.float32), torch.nan)


def rolling_climatology_ymd(ymd: torch.Tensor, window_years: int) -> torch.Tensor:
    """
    Shifting-baseline climatology: for target year ``y`` and day ``d``,
    ``nanmean(ymd[y-W : y, d])`` over the strictly previous ``W`` years. The
    first ``W`` target years (too little history) are NaN, as is a (y, d)
    with no finite sample in its window. (Y, 366, *spatial) in and out.
    """
    Y = ymd.shape[0]
    out = torch.full_like(ymd, torch.nan)
    if window_years < 1 or Y <= window_years:
        return out
    finite = torch.isfinite(ymd[:-1])
    wsum = window_sum(torch.where(finite, ymd[:-1], 0.0), window_years)  # row i: years i .. i+W-1
    wcnt = window_sum(finite.to(torch.int32), window_years)
    del finite
    out[window_years:] = torch.where(wcnt > 0, wsum / wcnt.to(torch.float32), torch.nan)
    return out


def centered_rolling_mean_time(data: torch.Tensor, window: int) -> torch.Tensor:
    """
    Centred rolling mean along dim 0 (time) with a full window required:
    any non-finite value in the window, or a window that runs off either end,
    gives NaN (``DataArray.rolling(time=w, center=True).mean()``). For an
    even window the pandas split is used: output ``i`` covers
    ``[i - w//2, i + (w-1)//2]``.
    """
    T = data.shape[0]
    out = torch.full_like(data, torch.nan)
    n = T - window + 1
    if n <= 0:
        return out
    vals = torch.where(torch.isfinite(data), data, torch.nan)  # NaN propagates through the adds
    acc = window_sum(vals, window)
    del vals
    left = window // 2
    torch.div(acc, _f32(float(window), acc), out=out[left : left + n])
    return out


def dayofyear_std(ymd: torch.Tensor, ddof: int = 0) -> torch.Tensor:
    """Per-day-of-year standard deviation over years of a (Y, 366, *spatial)
    block; NaN where a (day, point) has ``ddof`` finite samples or fewer.
    Returns (366, *spatial)."""
    finite = torch.isfinite(ymd)
    n = finite.sum(dim=0, dtype=torch.int32)
    nf = n.to(torch.float32)
    mean = torch.where(n > 0, year_sum(torch.where(finite, ymd, 0.0)) / nf.clamp(min=1.0), torch.nan)
    dev = ymd - mean
    dev2 = torch.where(finite, dev * dev, 0.0)
    del dev, finite
    var = year_sum(dev2) / (nf - ddof).clamp(min=1.0)
    return torch.where(n > ddof, torch.sqrt(var), torch.nan)


def wrapped_rolling_rms_doy(std_doy: torch.Tensor, window: int = 30, pad: int = 16) -> torch.Tensor:
    """The ``window``-day rolling RMS of a (366, *spatial) day-of-year STD,
    wrapped around the year by ``pad`` days at each end:
    ``sqrt((std.pad(wrap)**2).rolling(window, center=True).mean())``."""
    sq = std_doy * std_doy
    padded = torch.cat([sq[-pad:], sq, sq[:pad]], dim=0)
    rolled = centered_rolling_mean_time(padded, window)
    return torch.sqrt(rolled[pad : pad + std_doy.shape[0]])
