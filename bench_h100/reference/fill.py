"""
Reference hole and gap filling of the extremes, as upstream marEx's tracker
does it:

- on a grid, a closing then an opening with a disk of radius ``R_fill``
  (``r^2 < R^2 + 1``), on the field padded by ``2 R`` in both spatial dims
  (periodic), erosion taking cells past the padded edge as False; then the
  land mask again;
- along time, a closing with a flat window of ``T_fill + 1`` steps (False
  past both ends), then the spatial fill again at ``R_fill // 2``;
- on a mesh, by graph distance over the neighbour table as given: dilate,
  erode twice with land set True before each erosion, dilate.

Writes ``state["raw_area"]`` (the active area of each slice before filling)
and ``state["filled"]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# time steps of one block of the spatial fill
_STEPS = 64


def _or_shift(out: torch.Tensor, x: torch.Tensor, s: int, dim: int, outside: bool) -> None:
    """``out |= x`` moved by ``s`` along ``dim``, ``outside`` where the move
    reads past the edge."""
    n = x.shape[dim]
    if s > 0:
        out.narrow(dim, s, n - s).logical_or_(x.narrow(dim, 0, n - s))
        if outside:
            out.narrow(dim, 0, s).fill_(True)
    elif s < 0:
        out.narrow(dim, 0, n + s).logical_or_(x.narrow(dim, -s, n + s))
        if outside:
            out.narrow(dim, n + s, -s).fill_(True)


def dilate_disk(x: torch.Tensor, radius: int, outside: bool = False) -> torch.Tensor:
    """Dilation of a (..., H, W) stack by the disk: each row offset ``dy``
    takes the x-dilation by its half-width ``isqrt(R^2 - dy^2)``."""
    half = [math.isqrt(radius * radius - dy * dy) for dy in range(radius + 1)]
    rows = {0: x}
    cur = x
    for h in range(1, max(half) + 1):
        nxt = cur.clone()
        _or_shift(nxt, x, h, -1, outside)
        _or_shift(nxt, x, -h, -1, outside)
        rows[h] = cur = nxt
    out = rows[half[0]].clone()
    for dy in range(1, radius + 1):
        _or_shift(out, rows[half[dy]], dy, -2, outside)
        _or_shift(out, rows[half[dy]], -dy, -2, outside)
    return out


def close_open_grid(data: torch.Tensor, radius: int, mask: torch.Tensor) -> torch.Tensor:
    """Closing then opening by the disk on the periodically padded field,
    then the mask."""
    if radius == 0:
        return data & mask
    d = 2 * radius
    T, H, W = data.shape
    rows = torch.arange(-d, H + d, device=data.device) % H
    cols = torch.arange(-d, W + d, device=data.device) % W
    out = torch.empty_like(data)
    for t0 in range(0, T, _STEPS):
        x = data[t0 : t0 + _STEPS][:, rows][:, :, cols]
        x = dilate_disk(x, radius)
        x = ~dilate_disk(~x, radius, outside=True)
        x = ~dilate_disk(~x, radius, outside=True)
        x = dilate_disk(x, radius)
        out[t0 : t0 + _STEPS] = x[:, d:-d, d:-d]
    return out & mask


def dilate_graph(x: torch.Tensor, nb: torch.Tensor, steps: int) -> torch.Tensor:
    """Every cell within ``steps`` hops of a True cell, along the (K, C)
    0-based table as given (-1 missing)."""
    for _ in range(steps):
        y = x.clone()
        for row in nb:
            y |= x[..., row.clamp_min(0).long()] & (row >= 0)
        x = y
    return x


def close_open_mesh(data: torch.Tensor, radius: int, nb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if radius == 0:
        return data
    land = ~mask
    out = torch.empty_like(data)
    for t0 in range(0, data.shape[0], _STEPS):
        x = dilate_graph(data[t0 : t0 + _STEPS], nb, radius)
        x = ~dilate_graph(~(x | land), nb, radius)
        x = ~dilate_graph(~(x | land), nb, radius)
        out[t0 : t0 + _STEPS] = dilate_graph(x, nb, radius)
    return out


def close_time(data: torch.Tensor, t_fill: int) -> torch.Tensor:
    """Closing along time with a flat window of ``t_fill + 1`` steps."""
    k = t_fill + 1
    lo, hi = k // 2, k - 1 - k // 2
    T = data.shape[0]
    pad = torch.zeros((k,) + tuple(data.shape[1:]), dtype=torch.bool, device=data.device)
    x = torch.cat([pad, data, pad])
    n = x.shape[0]
    grown = x.clone()
    for s in range(1, lo + 1):  # grown[t] = OR of x[t - lo .. t + hi]
        grown[s:] |= x[: n - s]
    for s in range(1, hi + 1):
        grown[: n - s] |= x[s:]
    shrunk = grown.clone()
    for s in range(1, lo + 1):  # the AND over the same window, True past the ends
        shrunk[s:] &= grown[: n - s]
    for s in range(1, hi + 1):
        shrunk[: n - s] &= grown[s:]
    return shrunk[k : k + T]


def active_area(data: torch.Tensor, cell_area) -> np.ndarray:
    """Each slice's active cells (a grid) or active area (a mesh: float64
    sums of the float32 cell areas, rounded to float32)."""
    if cell_area is None:
        return data.reshape(data.shape[0], -1).sum(dim=1, dtype=torch.int32).cpu().numpy()
    a = cell_area.double()
    return torch.cat([data[t0 : t0 + 128].double() @ a for t0 in range(0, data.shape[0], 128)]).float().cpu().numpy()


def run(state: dict) -> None:
    cfg = state["config"]
    kw = {**cfg["tracker"], **state["mix"]["tracker"]}
    data, mask = state.pop("extremes"), state["mask"]
    dev = data.device
    if kw.get("unstructured_grid"):
        nb = torch.from_numpy(np.asarray(state["inputs"]["neighbours"], dtype=np.int32) - 1).to(dev)
        state["cell_area"] = torch.from_numpy(np.asarray(state["inputs"]["cell_areas"], dtype=np.float32)).to(dev)

        def fill(x, r):
            return close_open_mesh(x, r, nb, mask)
    else:
        state["cell_area"] = None

        def fill(x, r):
            return close_open_grid(x, r, mask)
    state["raw_area"] = active_area(data, state["cell_area"])
    R = int(kw["R_fill"])
    filled = fill(data, R)
    del data
    if kw["T_fill"]:
        filled = fill(close_time(filled, int(kw["T_fill"])), R // 2)
    state["filled"] = filled
