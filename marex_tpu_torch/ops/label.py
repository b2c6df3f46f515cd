"""
Connected-component labelling (CCL) of binary fields, gridded and on an
unstructured mesh.

The port of the device entry points of ``marex_tpu/ops/label.py``:

* per-timestep 2-D labelling, 8-connected, periodic in x
  (:func:`label_slices_grid_roots`), with the per-slice root statistics of
  the area filter (:func:`slice_root_stats`);
* 3-D spatio-temporal labelling with full 3x3x3 connectivity
  (:func:`label_spacetime_roots`) and its dense relabel in root order
  (:func:`densify_spacetime_roots`);
* per-timestep labelling on an unstructured mesh, over its neighbour table
  (:func:`label_slices_unstructured`);
* for merge tracking: per-slice dense labels from the area filter's kept
  roots (:func:`densify_slice_roots`), globally unique ids by cumulative
  offsets (:func:`offset_labels`) and the full-field id remap
  (:func:`remap_labels`).

Every active cell starts labelled with its own flat index; each iteration
runs the fused step kernel (the min over the stencil, or over the mesh's
neighbour table, and the hook: each cell whose label fell lowers the label
of the cell its old label named) and one pointer jump, until the step's
flag says that nothing changes. Two label buffers ping-pong with no copy:
the step reads A and lowers B by ``atomicMin`` (B always holds a field the
next step's minimum can only lower, ``csrc/min_stencil.cu``), the jump
reads B and writes A. On a grid both kernels walk the whole field; on a
mesh both walk the list of active cells, made once a fixpoint
(``graph_step.active_cells``), and inactive cells stay BIG in both buffers
from the start. A
component's converged label is the minimum flat index of its cells, which
is unique, so any sound propagation schedule ends at the
reference's labels bit for bit. The hook takes the place of the reference's
segmented-min sweeps: without it an iteration moves a label one cell, and
the production field needed hundreds of iterations. A gather is cheap on the
card, so the jump runs every iteration (the reference ran it every 64-128
iterations because gathers are slow on a TPU). The fixpoints raise if they
hit their iteration cap: a labelling that has not converged is never
returned.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ..exceptions import TrackingError
from .graph_step import active_cells, graph_jump, graph_step
from .min_stencil import BIG, ccl_step, pointer_jump

MAX_ITERS_2D = 4096
MAX_ITERS_MESH = 4096
MAX_ITERS_3D = 8192
# cells per chunk of the int64 bookkeeping (root statistics, dense relabel)
_CHUNK_CELLS = 64 * 1024 * 1024


def _fixpoint(
    start: List[torch.Tensor],
    step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    jump: Callable[[torch.Tensor, torch.Tensor], object],
    max_iters: int,
    what: str,
) -> Tuple[torch.Tensor, int]:
    """Iterate the fused step ``step(labels, out) -> flag`` and the jump
    ``jump(out, labels)`` from the labels in the one-element list ``start``
    until the step's flag says that they stop changing; returns (labels,
    iterations). The list is emptied, so the caller holds no reference that
    would keep the initial field alive through the loop."""
    a = start.pop()
    b = torch.full_like(a, BIG)
    for it in range(1, max_iters + 1):
        if not step(a, b).item():
            return a, it
        jump(b, a)
    raise TrackingError(
        f"{what} did not converge in {max_iters} iterations",
        suggestions=["This indicates a labelling fault: the propagation must reach a fixpoint"],
        context={"max_iters": max_iters, "shape": tuple(a.shape)},
    )


def label_slices_grid_roots(data: torch.Tensor, wrap_x: bool = True) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """
    Per-timestep 2-D CCL (8-connectivity) returning raw root labels.

    data : (T, H, W) bool

    Returns
    -------
    root_flat : (T, H*W) int32, each component labelled by its minimum flat
        index within the slice; BIG = background
    counts : (T,) int64 number of components per slice
    iterations : fixpoint iterations run
    """
    T, H, W = data.shape
    S = H * W
    data = data.contiguous()
    start = [torch.arange(S, dtype=torch.int32, device=data.device).repeat(T).view(T, H, W).masked_fill_(~data, BIG)]
    lab, iters = _fixpoint(
        start,
        lambda a, b: ccl_step(a, data, b, depth3=False, wrap_x=wrap_x),
        lambda b, a: pointer_jump(b, S, out=a),
        MAX_ITERS_2D,
        "per-slice CCL",
    )
    root_flat = lab.view(T, S)
    # a slice's components are its roots, the cells labelled with their own
    # index; counted over time chunks (no whole-field nonzero)
    idx = torch.arange(S, dtype=torch.int32, device=data.device)
    tb = max(1, _CHUNK_CELLS // max(S, 1))
    counts = torch.cat([(root_flat[t0 : t0 + tb] == idx).sum(dim=1) for t0 in range(0, T, tb)])
    return root_flat, counts, iters


def label_slices_unstructured(data: torch.Tensor, neighbours: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """
    Per-timestep CCL on an unstructured mesh
    (``marex_tpu.ops.label.label_slices_unstructured``).

    data : (T, C) bool, already masked
    neighbours : (K, C) int32 0-based adjacency, -1 = missing; components
        follow the table as given, so the caller passes the symmetrised one

    Returns
    -------
    dense : (T, C) int32 per-slice labels 1..n_t in ascending order of each
        component's minimum cell index, 0 = background
    counts : (T,) int64 number of components per slice
    iterations : fixpoint iterations run
    """
    T, C = data.shape
    data = data.contiguous()
    neighbours = neighbours.contiguous()
    idx = torch.arange(C, dtype=torch.int32, device=data.device)
    start = [idx.repeat(T).view(T, C).masked_fill_(~data, BIG)]
    active = active_cells(data)
    lab, iters = _fixpoint(
        start,
        lambda a, b: graph_step(a, active, neighbours, b),
        lambda b, a: graph_jump(b, active, out=a),
        MAX_ITERS_MESH,
        "mesh CCL",
    )
    del active  # up to 8 B a cell: free it before the relabel
    # a component's id is the rank of its root (the cell labelled with its own
    # index) among its slice's roots; in place over the root labels
    counts = torch.empty(T, dtype=torch.int64, device=data.device)
    tb = max(1, _CHUNK_CELLS // max(C, 1))
    for t0 in range(0, T, tb):
        rows = lab[t0 : t0 + tb]
        rank = (rows == idx).cumsum(dim=1, dtype=torch.int32)
        counts[t0 : t0 + tb] = rank[:, -1]
        active = rows != BIG
        rows.copy_(torch.gather(rank, 1, torch.where(active, rows, 0).long()).masked_fill_(~active, 0))
    return lab, counts, iters


def slice_root_stats(root_flat: torch.Tensor, n_max: Optional[int] = None):
    """
    Per-slice object statistics of converged root labels, exact for any
    object count: what the reference's ``extract_root_areas`` and
    ``slice_root_stats_sorted`` give. Runs over time chunks of about
    ``_CHUNK_CELLS`` cells, which bounds its int64 temporaries.

    root_flat : (T, S) int32 root labels (BIG = background)
    n_max : object slots per slice (default: the largest per-slice count)

    Returns
    -------
    root_ids  : (T, n_max) int32 ascending per-slice root ids, BIG padded
    areas     : (T, n_max) float32 object pixel areas, 0 padded
    area_cell : (T, S) float32 per-cell component area (0 = background)
    counts    : (T,) int64 per-slice object counts
    """
    T, S = root_flat.shape
    dev = root_flat.device
    area_cell = torch.zeros((T, S), dtype=torch.float32, device=dev)
    roots_all, area_all = [], []
    tb = max(1, _CHUNK_CELLS // max(S, 1))
    for t0 in range(0, T, tb):
        flat = root_flat[t0 : t0 + tb].reshape(-1)
        pos = (flat != BIG).nonzero().squeeze(1)  # active cells, ascending
        key = pos - pos % S + flat[pos].long()  # flat index of each cell's root
        roots = pos[key == pos]  # ascending: by slice, then by root id
        which = torch.searchsorted(roots, key)  # object number of each active cell
        area = torch.bincount(which, minlength=roots.numel())  # exact pixel counts
        area_cell[t0 : t0 + tb].view(-1)[pos] = area[which].float()
        roots_all.append(roots + t0 * S)
        area_all.append(area)
    roots, area = torch.cat(roots_all), torch.cat(area_all)
    root_t = roots // S
    counts = torch.bincount(root_t, minlength=T)
    if n_max is None:
        n_max = int(counts.max()) if T else 0
    slot = torch.arange(roots.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[root_t]
    sel = slot < n_max
    root_ids = torch.full((T, n_max), BIG, dtype=torch.int32, device=dev)
    areas = torch.zeros((T, n_max), dtype=torch.float32, device=dev)
    root_ids[root_t[sel], slot[sel]] = (roots[sel] % S).int()
    areas[root_t[sel], slot[sel]] = area[sel].float()
    return root_ids, areas, area_cell, counts


def label_spacetime_roots(data: torch.Tensor, wrap_x: bool = True) -> Tuple[torch.Tensor, int]:
    """
    3-D spatio-temporal CCL (3x3x3 connectivity) returning raw root labels.

    data : (T, H, W) bool

    Returns
    -------
    labf : (T*H*W,) int32, each event labelled by its minimum flat index;
        BIG = background (:func:`densify_spacetime_roots` counts the events)
    iterations : fixpoint iterations run
    """
    T, H, W = data.shape
    N = T * H * W
    if N >= BIG:
        raise TrackingError(
            f"the fused 3-D labelling needs T*H*W < 2**31 - 1 (int32 flat indices), got {N}",
            suggestions=["Label in two levels (per-slice labels joined across time), as the tracker does at this size"],
            context={"shape": (T, H, W)},
        )
    # two label fields live at once (4.5 GB each at production size)
    data = data.contiguous()
    start = [torch.arange(N, dtype=torch.int32, device=data.device).view(T, H, W).masked_fill_(~data, BIG)]
    lab, iters = _fixpoint(
        start,
        lambda a, b: ccl_step(a, data, b, depth3=True, wrap_x=wrap_x),
        lambda b, a: pointer_jump(b, N, out=a),
        MAX_ITERS_3D,
        "3-D CCL",
    )
    return lab.view(N), iters


def densify_spacetime_roots(labf: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """
    Dense relabel of 3-D root labels in root order: an event's id is the
    number of roots <= its own root, 1..n (0 = background) — the ids of the
    reference's ``densify_spacetime_roots``/``densify_spacetime_sorted``.
    Runs over chunks of ``_CHUNK_CELLS`` cells, which bounds its int64
    temporaries.

    labf : (N,) int32 converged root labels (BIG = background)
    """
    N = labf.numel()
    idx = torch.arange(min(_CHUNK_CELLS, N), dtype=torch.int32, device=labf.device)
    roots = torch.cat(  # ascending positions of the cells labelled with their own index
        [
            (labf[a : a + _CHUNK_CELLS] == idx[: min(_CHUNK_CELLS, N - a)] + a).nonzero().squeeze(1) + a
            for a in range(0, N, _CHUNK_CELLS)
        ]
        or [torch.zeros(0, dtype=torch.int64, device=labf.device)]
    )
    dense = torch.zeros_like(labf)
    for a in range(0, N, _CHUNK_CELLS):
        lv = labf[a : a + _CHUNK_CELLS]
        rank = torch.searchsorted(roots, lv.long()).int() + 1
        dense[a : a + _CHUNK_CELLS] = torch.where(lv != BIG, rank, 0)
    return dense, int(roots.numel())


def densify_slice_roots(
    root_flat: torch.Tensor, root_ids: torch.Tensor, keep: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Per-slice dense labels from root labels: a cell whose root is the j-th
    kept root of its slice (ascending) gets j + 1, every other cell 0 — the
    ids of the reference's ``densify_slice_roots`` /
    ``densify_slices_sorted`` on ``where(kept, root_flat, BIG)``. Runs over
    time chunks of about ``_CHUNK_CELLS`` cells.

    root_flat : (T, S) int32 root labels (BIG = background)
    root_ids  : (T, n) int32 ascending per-slice root ids, BIG padded
        (:func:`slice_root_stats`)
    keep      : optional (T, n) bool, the roots to keep (default: all valid)

    Returns (dense (T, S) int32, counts (T,) int64 kept objects per slice).
    """
    T, S = root_flat.shape
    valid = root_ids != BIG
    keep = valid if keep is None else keep & valid
    t_of = torch.arange(T, device=root_flat.device)[:, None].expand_as(root_ids)
    kept_keys = t_of[keep] * S + root_ids[keep].long()  # ascending: by slice, then root
    counts = keep.sum(dim=1)
    start = torch.cumsum(counts, 0) - counts  # kept objects before each slice
    dense = torch.zeros((T, S), dtype=torch.int32, device=root_flat.device)
    if kept_keys.numel() == 0:
        return dense, counts
    tb = max(1, _CHUNK_CELLS // max(S, 1))
    for t0 in range(0, T, tb):
        rows = root_flat[t0 : t0 + tb]
        t_idx = torch.arange(t0, t0 + rows.shape[0], device=rows.device)[:, None]
        key = t_idx * S + rows.long()
        pos = torch.searchsorted(kept_keys, key.view(-1)).view(key.shape)
        hit = (rows != BIG) & (kept_keys[pos.clamp_max(kept_keys.numel() - 1)] == key)
        dense[t0 : t0 + tb] = torch.where(hit, pos - start[t_idx] + 1, 0).int()
    return dense, counts


def label_cell_counts(labels: torch.Tensor, n_labels: int) -> torch.Tensor:
    """(T, n_labels + 1) int64 cells per label and slice of (T, S) dense
    labels in [0, n_labels] (column 0 counts the background). Runs over time
    chunks of about ``_CHUNK_CELLS`` cells."""
    T, S = labels.shape
    nb = n_labels + 1
    out = torch.empty((T, nb), dtype=torch.int64, device=labels.device)
    tb = max(1, _CHUNK_CELLS // max(S, 1))
    for t0 in range(0, T, tb):
        rows = labels[t0 : t0 + tb]
        bins = rows + torch.arange(rows.shape[0], device=labels.device)[:, None] * nb
        out[t0 : t0 + tb] = torch.bincount(bins.view(-1), minlength=rows.shape[0] * nb).view(-1, nb)
    return out


def select_labels(labels: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``keep[t, labels[t, s]]``: the (T, S) bool field of the cells whose
    label is kept in its slice (``marex_tpu.ops.label.select_labels``).
    Runs over time chunks of about ``_CHUNK_CELLS`` cells.

    labels : (T, S) int32 dense labels; keep : (T, n_labels + 1) bool
    """
    T, S = labels.shape
    out = torch.empty((T, S), dtype=torch.bool, device=labels.device)
    tb = max(1, _CHUNK_CELLS // max(S, 1))
    for t0 in range(0, T, tb):
        out[t0 : t0 + tb] = torch.gather(keep[t0 : t0 + tb], 1, labels[t0 : t0 + tb].long())
    return out


def offset_labels(labels: torch.Tensor, counts: torch.Tensor, base: int = 0) -> torch.Tensor:
    """
    Make per-slice dense labels globally unique by cumulative offsets
    (``marex_tpu.ops.label.offset_labels_across_time``): slice t's labels
    shift by the number of objects in slices before it, plus ``base`` (the
    objects of the slices before these, on a mesh's other ranks). In place,
    over time chunks of about ``_CHUNK_CELLS`` cells; returns ``labels``.

    labels : (T, ...) int32 per-slice dense labels (0 = background)
    counts : (T,) per-slice object counts
    """
    T = labels.shape[0]
    offsets = (torch.cumsum(counts, 0) - counts + base).to(device=labels.device, dtype=torch.int32)
    shape = (T,) + (1,) * (labels.dim() - 1)
    tb = max(1, _CHUNK_CELLS // max(labels[0].numel(), 1))
    for t0 in range(0, T, tb):
        rows = labels[t0 : t0 + tb]
        rows.add_(torch.where(rows > 0, offsets[t0 : t0 + tb].view((-1,) + shape[1:]), 0))
    return labels


def remap_labels(lookup: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """
    Full-field ``lookup[labels]`` (``marex_tpu.ops.label.remap_labels_donated``),
    written over ``labels`` chunk by chunk: the old ids are dead after the
    remap, so no second full-size field is held. Returns ``labels``.

    lookup : (n,) int32 new id of each old id; labels : int32, values < n
    """
    flat = labels.view(-1)
    for a in range(0, flat.numel(), _CHUNK_CELLS):
        chunk = flat[a : a + _CHUNK_CELLS]
        chunk.copy_(torch.index_select(lookup, 0, chunk))
    return labels
