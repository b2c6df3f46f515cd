"""
Reference connected-component labelling, and the event labels of tracking
without merging.

Components are 8-connected in each time slice of a grid (periodic in
longitude), 26-connected in (time, lat, lon) for the events of tracking
without merging, and joined along the symmetrised neighbour table on a mesh.
A component's root is its smallest flat index (within its slice, or over
the whole block in 3-D), found by plain min-label propagation: each cell
takes the smallest label around it, a root that sees a smaller label is
hooked to it, and labels jump to their label's label until nothing changes.
Dense ids number the roots in ascending order.

As a piece, writes ``state["labels"]`` (per-slice dense ids) and
``state["counts"]`` for the merge march; without merging it writes the
events (``out["events.ID_field"]`` and the attributes) itself.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .common import BIG

# time slices of one block of the per-slice labelling
_STEPS = 64
_MAX_ITERS = 10000


def _box_min(lab: torch.Tensor, dim: int, wrap: bool) -> torch.Tensor:
    """The smallest of each cell and its two neighbours along ``dim``
    (periodic when ``wrap``, else BIG past the ends)."""
    if wrap:
        return torch.minimum(lab, torch.minimum(lab.roll(1, dim), lab.roll(-1, dim)))
    out = lab.clone()
    n = lab.shape[dim]
    torch.minimum(out.narrow(dim, 1, n - 1), lab.narrow(dim, 0, n - 1), out=out.narrow(dim, 1, n - 1))
    torch.minimum(out.narrow(dim, 0, n - 1), lab.narrow(dim, 1, n - 1), out=out.narrow(dim, 0, n - 1))
    return out


def grid_min(wrap: bool, depth3: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """The 3x3 (per slice) or 3x3x3 neighbourhood minimum of (T, H, W) labels."""

    def fn(lab: torch.Tensor) -> torch.Tensor:
        m = _box_min(_box_min(lab, 2, wrap), 1, False)
        return _box_min(m, 0, False) if depth3 else m

    return fn


def graph_min(table: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """The minimum over each cell and its neighbours in the (K, C) table (-1 missing)."""
    rows = [(r.clamp_min(0).long(), r < 0) for r in table]

    def fn(lab: torch.Tensor) -> torch.Tensor:
        m = lab.clone()
        for idx, missing in rows:
            torch.minimum(m, lab[..., idx].masked_fill(missing, BIG), out=m)
        return m

    return fn


def roots(active: torch.Tensor, neighbour_min, per_slice: bool) -> torch.Tensor:
    """Root labels of ``active`` (T, ...) bool: each cell holds its
    component's smallest flat index (per slice, or over the block), BIG off
    the components. int32, the shape of ``active``."""
    T = active.shape[0]
    size = active[0].numel() if per_slice else active.numel()
    idx = torch.arange(active.numel(), device=active.device)
    own = (idx % size).to(torch.int32).view(active.shape)
    base = (idx - idx % size).view(active.shape)  # the flat index of each cell's slice start
    lab = torch.where(active, own, BIG)
    for _ in range(_MAX_ITERS):
        m = torch.where(active, neighbour_min(lab), BIG)
        moved = active & (m < lab)
        if not bool(moved.any()):
            return lab
        flat = m.reshape(-1).clone()
        sel = moved.reshape(-1)
        flat.scatter_reduce_(0, (base.reshape(-1)[sel] + lab.reshape(-1)[sel].long()), m.reshape(-1)[sel], "amin")
        lab = flat.view(active.shape)
        while True:  # jump to the label's label until nothing changes
            hop = torch.where(active, flat[(base + lab.clamp_max(size - 1).long()).reshape(-1)].view(active.shape), BIG)
            if torch.equal(hop, lab):
                break
            lab = hop
            flat = lab.reshape(-1)
    raise RuntimeError("reference labelling did not converge")


def dense(root: torch.Tensor, per_slice: bool):
    """Dense ids 1..n of root labels, ascending by root (per slice, or over
    the block), 0 off the components; and the counts (per slice, or one)."""
    T = root.shape[0]
    size = root[0].numel() if per_slice else root.numel()
    flat = root.reshape(-1)
    idx = torch.arange(flat.numel(), device=root.device)
    is_root = flat == (idx % size)
    keys = idx[is_root]  # ascending
    key = (idx - idx % size) + flat.long().clamp_max(size - 1)
    rank = torch.searchsorted(keys, key)
    if per_slice:
        counts = torch.bincount(keys // size, minlength=T)
        start = torch.cumsum(counts, 0) - counts
        rank = rank - start[idx // size]
    else:
        counts = torch.tensor([keys.numel()], device=root.device)
    ids = torch.where(flat != BIG, rank + 1, 0).to(torch.int32)
    return ids.view(root.shape), counts


def label_slices(data: torch.Tensor, wrap: bool = True, table: Optional[torch.Tensor] = None):
    """Per-slice components of (T, ...) bool data: (root labels, dense ids,
    counts), a block of slices at a time."""
    fn = grid_min(wrap, False) if table is None else graph_min(table)
    root = torch.empty(data.shape, dtype=torch.int32, device=data.device)
    ids = torch.empty_like(root)
    counts = []
    for t0 in range(0, data.shape[0], _STEPS):
        r = roots(data[t0 : t0 + _STEPS], fn, True)
        root[t0 : t0 + _STEPS] = r
        d, c = dense(r, True)
        ids[t0 : t0 + _STEPS] = d
        counts.append(c)
    return root, ids, torch.cat(counts)


def symmetrised(nb: np.ndarray) -> np.ndarray:
    """The (K', C) table of the undirected graph of a (K, C) 0-based table
    (-1 missing): each cell's neighbours ascending, -1 padded."""
    K, C = nb.shape
    src = np.broadcast_to(np.arange(C), (K, C))[nb >= 0]
    dst = nb[nb >= 0].astype(np.int64)
    edges = np.unique(np.concatenate([src * C + dst, dst * C + src]))
    a, b = edges // C, edges % C
    deg = np.bincount(a, minlength=C)
    out = np.full((max(int(deg.max()) if edges.size else 1, 1), C), -1, np.int32)
    out[np.arange(edges.size) - np.repeat(np.cumsum(deg) - deg, deg), a] = b
    return out


def run(state: dict) -> None:
    cfg, mix, out = state["config"], state["mix"], state["out"]
    kw = {**cfg["tracker"], **mix["tracker"]}
    data = state.pop("filtered")
    if kw.get("unstructured_grid"):
        nb = np.asarray(state["inputs"]["neighbours"], dtype=np.int64) - 1
        table = torch.from_numpy(symmetrised(nb)).to(data.device)
        _, ids, counts = label_slices(data & state["mask"], table=table)
    elif kw.get("allow_merging", True):
        _, ids, counts = label_slices(data, wrap=True)
    else:
        ids, counts = dense(roots(data, grid_min(True, True), False), False)
        out["events.ID_field"] = ids
        out["attrs"] = {**state["attrs"], "N_events_final": int(counts[0])}
        return
    state["labels"], state["counts"] = ids, counts.cpu().numpy()
