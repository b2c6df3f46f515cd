"""
What the reference pieces share: the calendar of the time axis, the
approximate percentile's bins, and float32 scalars.

The reference is plain PyTorch and NumPy. It imports nothing of
``marex_tpu_torch`` and takes nothing the program made: only the generated
input (``state["inputs"]``: the SST, its coordinates, and on a mesh its
neighbour table and cell areas). Its float arithmetic follows the upstream
marEx recipes in the order the port documents (window sums as chains of
adds in time order, float32 scalars as tensors), so that a sound program
agrees with it bit for bit where the port says it does.

``state["precision"]`` is the dtype detect computes in: float32, the
configuration's, or a lower one for the control run.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import pandas as pd
import torch

BIG = 2**31 - 1  # the label of a background cell


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``like``'s dtype and device: scalar arithmetic stays in
    that precision, and a division stays a division on every device."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def calendar(times: np.ndarray) -> Dict[str, np.ndarray]:
    """Day of year (0-based), year and year index (over every year from the
    first to the last) of each time step."""
    idx = pd.DatetimeIndex(np.asarray(times))
    year = idx.year.to_numpy().astype(np.int64)
    return {"doy": idx.dayofyear.to_numpy().astype(np.int64) - 1, "year": year, "year_index": year - year.min(),
            "n_years": int(year.max() - year.min() + 1)}


def year_runs(doy: np.ndarray) -> List[Tuple[int, int]]:
    """Consecutive runs of time steps in which no day of year repeats."""
    runs, start, seen = [], 0, set()
    for t, d in enumerate(doy.tolist()):
        if d in seen:
            runs.append((start, t))
            start, seen = t, set()
        seen.add(d)
    runs.append((start, len(doy)))
    return runs


def bins(precision: float = 0.01, max_anomaly: float = 5.0) -> Tuple[np.ndarray, np.ndarray]:
    """The approximate percentile's bin edges ``[-inf, -p, 0, p, ...,
    max_anomaly]`` and centres (the negative bucket centred at 0)."""
    edges = np.concatenate([[-np.inf], np.arange(-precision, max_anomaly + precision, precision, dtype=np.float32)])
    edges = edges.astype(np.float32)
    centres = (edges[1:] + edges[:-1]) / 2
    centres[0] = 0.0
    return edges, centres.astype(np.float32)


def digitize(x: torch.Tensor, precision: float, nbins: int) -> torch.Tensor:
    """The bin of each value, ``np.digitize(x, edges) - 1``: values below
    ``-precision`` go to bin 0, NaN and values past the last edge to the
    sentinel ``nbins``. int16."""
    p = f32(precision, x)
    k = torch.floor((x + p) / p).clamp(-1, nbins).to(torch.int32) + 1
    k = torch.where(x < -p, 0, k)
    k = torch.where(torch.isnan(x), nbins, k)
    return k.clamp(0, nbins).to(torch.int16)


def quantile_cdf(hist: torch.Tensor, q: float, centres: torch.Tensor) -> torch.Tensor:
    """The global path's threshold from (..., nbins) counts: the first bin
    whose CDF reaches ``q`` (less 1e-10), the first bin past the CDF of the
    bin before it, and linear interpolation between their centres in CDF
    space, with the exact-match and zero-denominator rules. float32."""
    nb = hist.shape[-1]
    eps, q32 = f32(1e-10, centres), f32(q, centres)
    total = hist.sum(dim=-1, keepdim=True, dtype=torch.int32).to(centres.dtype) + eps
    cdf = hist.cumsum(dim=-1, dtype=torch.int32).to(centres.dtype) / total
    upper = (cdf >= (q32 - eps)).to(torch.uint8).argmax(dim=-1)
    before = torch.where(upper - 1 > 0, upper - 1, 0)
    lower = (cdf > torch.gather(cdf, -1, before[..., None])).to(torch.uint8).argmax(dim=-1)
    lower, upper = lower.clamp(0, nb - 2), upper.clamp(1, nb - 1)
    c_lo = torch.gather(cdf, -1, lower[..., None])[..., 0]
    c_up = torch.gather(cdf, -1, upper[..., None])[..., 0]
    b_lo, b_up = centres[lower], centres[upper]
    denom = c_up - c_lo
    exact = (c_lo - q32).abs() < eps
    flat = denom.abs() <= eps
    frac = (q32 - c_lo) / torch.where(denom.abs() > eps, denom, f32(1.0, denom))
    thr = b_lo + frac * (b_up - b_lo)
    thr = torch.where(exact, b_lo, thr)
    return torch.where(flat & ~exact, (b_lo + b_up) / f32(2.0, thr), thr)


def window_sum(x: torch.Tensor, window: int, dim: int = 0) -> torch.Tensor:
    """``out[i] = x[i] + x[i+1] + ... + x[i+window-1]`` along ``dim``, added
    in that order."""
    n = x.shape[dim] - window + 1
    acc = x.narrow(dim, 0, n).clone()
    for k in range(1, window):
        acc += x.narrow(dim, k, n)
    return acc
