"""
Binary morphology on gridded (T, H, W) and unstructured (T, C) bool fields.

The port of ``marex_tpu/ops/morphology.py``: disk closing+opening with the
reference's 2R pad (wrapped for a global grid, edge values repeated for a
regional one) and ``border_value=0`` erosion, the temporal closing along
time, and on a mesh the closing+opening by graph distance over the (3, C)
neighbour table (a gather and an OR a table row). Dilation is written as
shifted OR passes on bool tensors (the disk as a union of row runs), erosion
as its complement dual, exactly as the JAX code does, so the results are bit
for bit the reference's. A ``conv2d`` disk would be shorter, but cuDNN runs
float32 convolutions in TF32 by default.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# time slices per chunk of the spatial closing+opening: bounds the padded
# temporaries (~20 chunk-sized bool buffers) at production width
_TIME_CHUNK = 128


def disk_kernel(radius: int) -> np.ndarray:
    """Disk structuring element: r^2 < radius^2 + 1 (the reference's disk)."""
    y, x = np.ogrid[-radius : radius + 1, -radius : radius + 1]
    return (x**2 + y**2) < (radius**2 + 1)


def _or_shifted(x: torch.Tensor, s: int, dim: int, fill: bool) -> torch.Tensor:
    """``x | shift(x, +s) | shift(x, -s)`` along ``dim`` with ``fill`` shifted
    in at both edges (requires 0 < s < size)."""
    n = x.shape[dim]
    out = x.clone()
    out.narrow(dim, s, n - s).logical_or_(x.narrow(dim, 0, n - s))
    out.narrow(dim, 0, n - s).logical_or_(x.narrow(dim, s, n - s))
    if fill:
        out.narrow(dim, 0, s).fill_(True)
        out.narrow(dim, n - s, s).fill_(True)
    return out


def _dilate_1d(x: torch.Tensor, h: int, dim: int, fill: bool = False) -> torch.Tensor:
    """Dilation by the window [-h, h] along ``dim`` via a doubling chain of
    shifted ORs (O(log h) passes)."""
    r = 0
    while r < h:
        s = min(max(r, 1), h - r)
        x = _or_shifted(x, s, dim, fill)
        r += s
    return x


def _dilate_disk(x: torch.Tensor, radius: int, fill: bool = False) -> torch.Tensor:
    """Dilation of a (T, H, W) stack by ``disk_kernel(radius)``: OR over dy
    of the y-shifted x-dilations by the row half-width isqrt(R^2 - dy^2)."""
    hw = [math.isqrt(radius * radius - dy * dy) for dy in range(radius + 1)]
    dil_x = {}
    cur, reach = x, 0
    for h in sorted(set(hw)):
        cur = _dilate_1d(cur, h - reach, dim=-1, fill=fill)
        reach = h
        dil_x[h] = cur
    out = dil_x[hw[0]].clone()
    n = x.shape[-2]
    for dy in range(1, radius + 1):
        row = dil_x[hw[dy]]
        out.narrow(-2, dy, n - dy).logical_or_(row.narrow(-2, 0, n - dy))
        out.narrow(-2, 0, n - dy).logical_or_(row.narrow(-2, dy, n - dy))
        if fill:
            out.narrow(-2, 0, dy).fill_(True)
            out.narrow(-2, n - dy, dy).fill_(True)
    return out


def _erode_disk(x: torch.Tensor, radius: int, outside: bool = True) -> torch.Tensor:
    """Erosion as the complement dual of dilation; ``outside`` is the value
    assumed beyond the array edge (False = scipy's ``border_value=0``)."""
    return ~_dilate_disk(~x, radius, fill=not outside)


def _pad(x: torch.Tensor, d: int, mode: str) -> torch.Tensor:
    """Pad the two trailing dims by ``d``: periodic (numpy ``mode='wrap'``)
    or with the edge values repeated (``mode='edge'``)."""
    for dim in (-2, -1):
        n = x.shape[dim]
        idx = torch.arange(-d, n + d, device=x.device)
        x = x.index_select(dim, idx % n if mode == "wrap" else idx.clamp(0, n - 1))
    return x


def binary_close_open_grid(data: torch.Tensor, radius: int, mask: torch.Tensor, mode: str = "wrap") -> torch.Tensor:
    """
    Fill holes and gaps: closing (dilate, erode) then opening (erode,
    dilate) with a disk of ``radius``, on a field padded by 2R in both
    spatial dims (``mode='wrap'`` for a global grid, ``'edge'`` for a
    regional one) and eroded with ``border_value=0``; then trim and re-apply
    the land mask — the reference's geometry, quirks included.

    data : (T, H, W) bool; mask : (H, W) bool (True = valid ocean)
    """
    if mode not in ("wrap", "edge"):
        raise ValueError(f"mode must be 'wrap' or 'edge', got {mode!r}")
    if radius == 0:
        return data & mask
    d = 2 * radius
    out = torch.empty_like(data)
    for t0 in range(0, data.shape[0], _TIME_CHUNK):
        x = _pad(data[t0 : t0 + _TIME_CHUNK], d, mode)
        x = _dilate_disk(x, radius)  # closing
        x = _erode_disk(x, radius, outside=False)
        x = _erode_disk(x, radius, outside=False)  # opening
        x = _dilate_disk(x, radius)
        out[t0 : t0 + _TIME_CHUNK] = x[:, d:-d, d:-d]
    return out.logical_and_(mask)


def _pad_time(x: torch.Tensor, lo: int, hi: int, fill: bool) -> torch.Tensor:
    def block(n: int) -> torch.Tensor:
        return torch.full((n,) + tuple(x.shape[1:]), fill, dtype=torch.bool, device=x.device)

    return torch.cat([block(lo), x, block(hi)])


def _pool_time(x: torch.Tensor, lo: int, hi: int, fill: bool, op: str) -> torch.Tensor:
    """k-way OR (``op='or'``) or AND along time over the window [t - lo, t + hi],
    ``fill`` beyond the ends."""
    T = x.shape[0]
    xp = _pad_time(x, lo, hi, fill)
    out = xp[0:T].clone()
    for d in range(1, lo + hi + 1):
        if op == "or":
            out.logical_or_(xp[d : d + T])
        else:
            out.logical_and_(xp[d : d + T])
    return out


def binary_close_time(data: torch.Tensor, t_fill: int) -> torch.Tensor:
    """
    Temporal closing along axis 0 with a ones-kernel of length
    ``t_fill + 1``, False padded: fills gaps of up to ``t_fill`` steps.

    data : (T, ...) bool
    """
    if t_fill == 0:
        return data
    k = t_fill + 1
    lo, hi = k // 2, k - 1 - k // 2
    x = _pad_time(data, k, k, False)
    x = _pool_time(x, lo, hi, False, "or")
    x = _pool_time(x, lo, hi, True, "and")
    return x[k:-k]


def neighbour_dilate_step(vec: torch.Tensor, neighbours: torch.Tensor) -> torch.Tensor:
    """
    One graph-dilation step on an unstructured mesh: a cell becomes True if
    it is True or any of its neighbours is. ``neighbours`` is the (K, C)
    0-based adjacency with -1 for missing, used as given (a directed table
    dilates along its own edges only).

    vec : (..., C) bool
    """
    out = vec.clone()
    for row in neighbours:
        out.logical_or_(vec.index_select(-1, row.clamp_min(0).long()).logical_and_(row >= 0))
    return out


def neighbour_dilate(vec: torch.Tensor, neighbours: torch.Tensor, steps: int) -> torch.Tensor:
    """Iterated graph dilation: every cell within ``steps`` hops of a True cell."""
    for _ in range(steps):
        vec = neighbour_dilate_step(vec, neighbours)
    return vec


def binary_close_open_unstructured(
    data: torch.Tensor, neighbours: torch.Tensor, mask: torch.Tensor, radius: int
) -> torch.Tensor:
    """
    Closing then opening by graph distance ``radius`` on the mesh, with land
    set True before each erosion so that the shoreline is not eroded: dilate,
    OR land, erode, OR land, erode, dilate — the reference's order. Like the
    reference, land cells may come out True (labelling applies the mask
    again). Runs a block of time slices at a time.

    data : (T, C) bool; neighbours : (K, C) int32; mask : (C,) bool
    """
    if radius == 0:
        return data
    land = ~mask
    out = torch.empty_like(data)
    for t0 in range(0, data.shape[0], _TIME_CHUNK):
        x = neighbour_dilate(data[t0 : t0 + _TIME_CHUNK], neighbours, radius)
        for _ in range(2):  # two erosions, each after protecting the shore
            x = ~neighbour_dilate(~(x | land), neighbours, radius)
        out[t0 : t0 + _TIME_CHUNK] = neighbour_dilate(x, neighbours, radius)
    return out
