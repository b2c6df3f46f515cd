"""
The temporal overlap graph of merge tracking, and the inter-slice edges of
the two-level 3-D labelling.

The port of ``marex_tpu/ops/overlap.py`` and of the tracker's pair helpers
(``consecutive_pairs_tiled``, ``compact_pairs``, ``_pairs_dev``): for
consecutive time slices, every (id at t, id at t+1) pair of objects that
share cells, with the number of shared cells or, on a mesh, the summed area
of the shared cells (a float64 sum of float32 cell areas, rounded to float32:
the reference's float32 sum, without its dependence on the order). Pair keys
are int64 ``(t * K + a) * K + b`` on the device, sorted and counted by
``torch.unique``, so the lists come out in ascending (t, a, b) order, as the
reference's ascending keys do, and the reference's fall-back to host numpy
when ``key_stride**2 >= 2**31`` has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._native import union_find

# cells per chunk of the int64 keys
_CHUNK_CELLS = 64 * 1024 * 1024


def consecutive_pairs(
    labels: torch.Tensor, key_stride: int, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    Overlap triples between every consecutive slice pair of a label stack.

    labels : (T, ...) int32 object ids (0 = background), all < key_stride
    weights : optional (S,) per-cell weights (cell areas on a mesh)

    Returns (t, a, b, w) tensors on the labels' device, sorted by (t, a, b):
    object ``a`` at slice t shares ``w`` cells with object ``b`` at slice
    t + 1 (int64), or cells of summed weight ``w`` (float32) with ``weights``.
    """
    T = labels.shape[0]
    S = labels[0].numel() if T else 0
    K = int(key_stride)
    if max(T - 1, 1) * K * K >= 2**63:
        raise ValueError(f"pair keys overflow int64: T={T}, key_stride={K}")
    flat = labels.reshape(T, S)
    keys, counts = [], []
    tb = max(1, _CHUNK_CELLS // max(S, 1))
    for t0 in range(0, T - 1, tb):
        n = min(tb, T - 1 - t0)
        a, b = flat[t0 : t0 + n], flat[t0 + 1 : t0 + 1 + n]
        t_idx = torch.arange(t0, t0 + n, device=labels.device)[:, None]
        both = (a > 0) & (b > 0)
        key = ((t_idx * K + a) * K + b)[both]
        if weights is None:
            k, c = torch.unique(key, sorted=True, return_counts=True)
        else:
            k, inv = torch.unique(key, sorted=True, return_inverse=True)
            w = weights.to(torch.float64).expand(n, S)[both]
            c = torch.zeros(k.numel(), dtype=torch.float64, device=labels.device).index_add_(0, inv, w).float()
        # on CUDA both outputs are views into buffers as long as ``key``:
        # copies let those go (they held 14.3 GiB at full size)
        keys.append(k.clone())
        counts.append(c.clone())
    if not keys:
        z = torch.zeros(0, dtype=torch.int64, device=labels.device)
        return z, z, z, z if weights is None else z.float()
    key, w = torch.cat(keys), torch.cat(counts)
    ab = key % (K * K)
    return key // (K * K), ab // K, ab % K, w


def slice_pairs(
    a: torch.Tensor, b: torch.Tensor, key_stride: int, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(a, b, w) overlap triples between two label slices, sorted by (a, b)
    (the march's refresh of one slice pair)."""
    _, pa, pb, pw = consecutive_pairs(torch.stack([a, b]), key_stride, weights)
    return pa, pb, pw


def _shifted(a: torch.Tensor, dy: int, dx: int, wrap_x: bool) -> torch.Tensor:
    """``a`` (..., H, W) moved by (dy, dx): ``out[..., y, x] = a[..., y - dy,
    x - dx]``, 0 where ``y - dy`` leaves the grid, and where ``x - dx`` does
    unless ``wrap_x`` (periodic in x)."""
    if dx and wrap_x:
        a = torch.roll(a, dx, dims=-1)
    for d, dim in ((dx, -1), (dy, -2)):
        if not d or (dim == -1 and wrap_x):
            continue
        n = a.shape[dim]
        out = torch.zeros_like(a)
        if abs(d) < n:
            out.narrow(dim, max(d, 0), n - abs(d)).copy_(a.narrow(dim, max(-d, 0), n - abs(d)))
        a = out
    return a


def adjacency_edges(labels: torch.Tensor, key_stride: int, wrap_x: bool) -> torch.Tensor:
    """
    The inter-slice edges of 3x3x3 connectivity: every (a, b) with a cell of
    object a at slice t in the 3 x 3 neighbourhood of a cell of object b at
    slice t + 1 (periodic in x with ``wrap_x``), as the co-located pairs of
    slice t moved by each of the nine (dy, dx) and slice t + 1
    (``marex_tpu/ops/overlap.py:adjacency_pairs_shift``). Keys are int64
    ``a * key_stride + b``, over time chunks of about ``_CHUNK_CELLS``
    cells; only the first cell of each run of equal keys along x is kept
    before the sort, which leaves the set of keys as it is.

    labels : (T, H, W) int32 globally unique object ids (0 = background),
        all < key_stride
    Returns (E, 2) int64 edges on the labels' device, unique and ascending.
    """
    T, H, W = labels.shape
    K = int(key_stride)
    if K * K >= 2**63:
        raise ValueError(f"edge keys overflow int64: key_stride={K}")
    keys = []
    tb = max(1, _CHUNK_CELLS // max(H * W, 1))
    for t0 in range(0, T - 1, tb):
        n = min(tb, T - 1 - t0)
        a, b = labels[t0 : t0 + n], labels[t0 + 1 : t0 + 1 + n]
        b_on = b > 0
        b_key = b.long()
        chunk = []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                sa = _shifted(a, dy, dx, wrap_x)
                both = b_on & (sa > 0)
                key = torch.where(both, sa.long() * K + b_key, -1)
                both[..., 1:] &= key[..., 1:] != key[..., :-1]  # run starts along x
                chunk.append(key[both])
                del sa, key, both
        keys.append(torch.unique(torch.cat(chunk)))
    if not keys:
        return torch.zeros((0, 2), dtype=torch.int64, device=labels.device)
    key = torch.unique(torch.cat(keys))
    return torch.stack([key // K, key % K], dim=1)


def union_find_components(pairs: np.ndarray, node_ids: np.ndarray) -> np.ndarray:
    """
    Connected components of the overlap graph on the host (the C++
    union-find of ``csrc/marex_host.cpp``, numpy when it cannot be built).

    pairs : (N, 2) edges between node ids; node_ids : (M,) all node ids
    Returns (M,) int32 component index (0..K-1), numbered in order of each
    component's first node.
    """
    return union_find(np.asarray(pairs, dtype=np.int64).reshape(-1, 2), np.asarray(node_ids, dtype=np.int64))
