"""
Calendar utilities and the dense (year, dayofyear) device layout.

The port of ``marex_tpu/core/timeaxis.py``: the calendar decomposition is
host numpy/pandas; the dense ``(n_years, 366, space)`` scatter and its
inverse gather are torch indexing on the payload's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd
import torch


@dataclass(frozen=True)
class TimeIndexInfo:
    """Host-side calendar decomposition of a time coordinate."""

    times: np.ndarray  # original datetime64 values, shape (T,)
    year: np.ndarray  # calendar year per step, int32 (T,)
    dayofyear: np.ndarray  # 1..366 per step, int32 (T,)
    year_index: np.ndarray  # 0-based index into unique_years (T,)
    unique_years: np.ndarray  # sorted unique years (Y,)
    decimal_year: np.ndarray  # fractional year per step, float64 (T,)

    @property
    def n_years(self) -> int:
        return int(len(self.unique_years))

    @property
    def n_time(self) -> int:
        return int(len(self.times))


def decompose_time(times: np.ndarray) -> TimeIndexInfo:
    """
    Decompose a datetime64 time coordinate into calendar components.

    ``dayofyear`` follows pandas semantics (1..365/366, leap-aware), matching
    the reference's ``time.dt.dayofyear`` groupby keys.
    """
    idx = pd.DatetimeIndex(np.asarray(times))
    year = idx.year.to_numpy().astype(np.int32)
    doy = idx.dayofyear.to_numpy().astype(np.int32)
    # Dense year axis (min..max inclusive) so that year-windowed operations are
    # windows over *year values*, exactly as the reference's target-year logic
    # (detect.py:1631), even when the series has gap years.
    unique_years = np.arange(year.min(), year.max() + 1, dtype=np.int32)
    year_index = (year - year.min()).astype(np.int32)

    # decimal year: year + elapsed_days / year_length (cf. detect.py:2031-2058)
    start = pd.to_datetime(idx.year.astype(str) + "-01-01")
    nxt = pd.to_datetime((idx.year + 1).astype(str) + "-01-01")
    elapsed = (idx - start).days.to_numpy()
    duration = (nxt - start).days.to_numpy()
    decimal_year = year.astype(np.float64) + elapsed / duration

    return TimeIndexInfo(
        times=np.asarray(times),
        year=year,
        dayofyear=doy,
        year_index=year_index,
        unique_years=unique_years,
        decimal_year=decimal_year,
    )


def scatter_to_year_doy(data: torch.Tensor, tinfo: TimeIndexInfo, fill=np.nan) -> torch.Tensor:
    """
    Scatter a (T, *spatial) tensor into a dense (Y, 366, *spatial) tensor on
    the same device.

    Each (year, dayofyear) cell receives at most one timestep for daily data;
    missing cells (e.g. day 366 in non-leap years, or series not spanning a
    full year) are ``fill``.
    """
    out = torch.full((tinfo.n_years, 366) + tuple(data.shape[1:]), fill, dtype=data.dtype, device=data.device)
    yi = torch.from_numpy(tinfo.year_index.astype(np.int64)).to(data.device)
    di = torch.from_numpy((tinfo.dayofyear - 1).astype(np.int64)).to(data.device)
    out[yi, di] = data
    return out


def gather_from_year_doy(ymd: torch.Tensor, tinfo: TimeIndexInfo) -> torch.Tensor:
    """Inverse of :func:`scatter_to_year_doy`: gather back to (T, *spatial)."""
    yi = torch.from_numpy(tinfo.year_index.astype(np.int64)).to(ymd.device)
    di = torch.from_numpy((tinfo.dayofyear - 1).astype(np.int64)).to(ymd.device)
    return ymd[yi, di]


def doy_window_indices(window_days: int) -> np.ndarray:
    """
    Wrapped day-of-year window gather table: (366, window_days) int32 of
    0-based day-of-year indices, day d's window ``d - window_days // 2`` ..
    ``d + window_days // 2`` modulo 366 (``marex_tpu.core.timeaxis``).
    """
    half = window_days // 2
    base = np.arange(366)[:, None]
    offsets = np.arange(-half, half + 1)[None, :]
    return ((base + offsets) % 366).astype(np.int32)


def add_decimal_year_coord(times: np.ndarray) -> np.ndarray:
    """The decimal year of each time (float64), as ``add_decimal_year``
    computes it, without a Field."""
    return decompose_time(times).decimal_year


def infer_time_resolution_days(times: np.ndarray) -> float:
    """The median spacing of the time axis in days (1.0 for fewer than two
    times)."""
    t = np.asarray(times).astype("datetime64[s]").astype("int64")
    if len(t) < 2:
        return 1.0
    return float(np.median(np.diff(t)) / 86400.0)
