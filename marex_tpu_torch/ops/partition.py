"""
Child partitioning of split/merge tracking, on a regular grid and on an
unstructured mesh.

The port of ``marex_tpu/ops/partition.py``. On a grid, a child
object that overlaps several parents is cut into one piece per parent, each
cell going to the parent whose nearest cell is closest (an exact Euclidean
distance transform, capped at a maximum distance) or, beyond the cap or in
centroid mode, to the parent whose centroid is closest (periodic in x).
Batch dimensions are written out where the reference used ``vmap``: the
parents of a child along one axis and the children of a time step along the
one before it. Padded parent slots carry ``parent_valid = False`` and count
as infinitely far.

Squared distances are integers below 2**24, so every exact method gives the
reference's float32 values; ties in an argmin go to the lowest parent index,
as in ``jnp.argmin``. On the card the nearest-parent partition of a step's
children is the hand-written CUDA kernel ``csrc/partition.cu``
(``marex_partition_grid``: the row distance, then at each child cell the
exact column pass out to the cap, fused with the argmin, the fallback, the
piece ids and the pieces' sums);
:func:`partition_children_grid_plain` is the same function in plain
PyTorch, which the CPU runs and the kernel is held against.

On a mesh the nearest parent cell is found by hop distance (a breadth-first
search over the neighbour table from each parent's overlap with the child,
capped at a number of hops), and the fallback is the great-circle distance
to the parents' centroids. Hop counts are integers, so they are the
reference's. The great-circle order is taken from the haversine term
``(1 - u.v) / 2`` of the cells' and centroids' unit vectors, in float64
products and sums of numbers made on the host: the CPU and CUDA give the same
bits, and a cell goes to another parent than in the reference (float32
trigonometry) only where two centroids are equally far within float32
rounding.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .properties import (
    grid_mask_props,
    grid_sums_props,
    mesh_segment_sums,
    mesh_unit_vectors,
    spherical_centroids,
    unstructured_mask_props,
)

_INF = float("inf")
# bytes for the plain column pass's (masks, rows, source rows, W) float32 temporary
_EDT_BLOCK_BYTES = 1 << 30


def _argmin_parents(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, first index of the min) over the parent axis -3 of ``d``, as
    elementwise passes over the few parents (a strided ``torch.argmin`` over
    that axis is slow on the CPU). A strict ``<`` keeps the lowest index on
    ties, as ``jnp.argmin`` does."""
    best = d[..., 0, :, :]
    idx = torch.zeros(best.shape, dtype=torch.int64, device=d.device)
    for p in range(1, d.shape[-3]):
        closer = d[..., p, :, :] < best
        best = torch.where(closer, d[..., p, :, :], best)
        idx.masked_fill_(closer, p)
    return best, idx


def centroid_assign_grid(
    parent_centroids: torch.Tensor, parent_valid: torch.Tensor, shape: Tuple[int, int], wrap: bool = True
) -> torch.Tensor:
    """
    Index of the nearest parent centroid for every cell of an (H, W) grid,
    by Euclidean distance in pixels, with dx folded into [-W/2, W/2] when
    ``wrap``: ``dy*dy + dx*dx`` in float32, in that order.

    parent_centroids : (..., P, 2) float32 (cy, cx) pixel coordinates
    parent_valid : (..., P) bool
    Returns (..., H, W) int64 parent index.
    """
    H, W = shape
    dev = parent_centroids.device
    cy = parent_centroids[..., 0, None, None]
    cx = parent_centroids[..., 1, None, None]
    dy = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - cy  # (..., P, H, 1)
    dx = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - cx  # (..., P, 1, W)
    if wrap:
        half = W / 2.0
        dx = torch.where(dx > half, dx - W, dx)
        dx = torch.where(dx < -half, dx + W, dx)
    d2 = dy * dy + dx * dx
    d2 = torch.where(parent_valid[..., None, None], d2, _INF)
    return _argmin_parents(d2)[1]


def _row_distance_periodic(mask: torch.Tensor, wrap: bool) -> torch.Tensor:
    """
    Distance in cells to the nearest True along the last axis, periodic when
    ``wrap``: the last True at or before each cell and the next at or after
    it (a cummax / cummin of indices), with the row's last and first True
    standing in across the seam. mask : (..., W) bool -> float32 (inf where
    the row is empty).
    """
    W = mask.shape[-1]
    ar = torch.arange(W, device=mask.device)
    far = 4 * W  # any value >= 2 W stands for "none"
    last = torch.where(mask, ar, -1).cummax(dim=-1).values
    nxt = torch.where(mask, ar, W).flip(-1).cummin(dim=-1).values.flip(-1)
    fwd = torch.where(last >= 0, ar - last, far)
    bwd = torch.where(nxt < W, nxt - ar, far)
    if wrap:
        any_ = last[..., -1:] >= 0
        fwd = torch.where((last < 0) & any_, ar + W - last[..., -1:], fwd)
        bwd = torch.where((nxt >= W) & any_, nxt[..., :1] + W - ar, bwd)
    d = torch.minimum(fwd, bwd)
    return torch.where(d >= 2 * W, _INF, d.float())


def euclidean_distance_transform_grid(parent_masks: torch.Tensor, wrap: bool = True) -> torch.Tensor:
    """
    Exact squared Euclidean distance to the nearest True cell of each mask,
    periodic in x when ``wrap``: the row distance, then a column pass
    ``min over y of d_row(y)**2 + (y - y0)**2`` over every row that holds a
    cell of some mask, in blocks of at most ``_EDT_BLOCK_BYTES``.

    parent_masks : (..., H, W) bool
    Returns (..., H, W) float32 squared distances (inf where a mask is empty).
    """
    lead = parent_masks.shape[:-2]
    H, W = parent_masks.shape[-2:]
    d1 = _row_distance_periodic(parent_masks, wrap).reshape(-1, H, W)
    d1sq = d1 * d1
    B = d1sq.shape[0]
    # only rows holding a cell of some mask can be nearest: the others are
    # inf in every mask and drop out of the min
    src = torch.isfinite(d1sq).any(dim=2).any(dim=0).nonzero().squeeze(1)
    if src.numel() == 0:
        return torch.full_like(d1sq, _INF).view(*lead, H, W)
    d1src = d1sq[:, src]  # (B, n_src, W)
    yy = torch.arange(H, dtype=torch.float32, device=d1sq.device)
    dy2 = (src.float()[None, :] - yy[:, None]) ** 2  # (output row, source row)
    out = torch.empty_like(d1sq)
    rb = max(1, _EDT_BLOCK_BYTES // max(B * src.numel() * W * 4, 1))
    for y0 in range(0, H, rb):
        v = d1src[:, None] + dy2[y0 : y0 + rb, :, None]  # (B, rows, n_src, W)
        out[:, y0 : y0 + rb] = v.amin(dim=2)
        del v
    return out.view(*lead, H, W)


def partition_nn_grid(
    child_mask: torch.Tensor,
    parent_masks: torch.Tensor,
    parent_valid: torch.Tensor,
    parent_centroids: torch.Tensor,
    max_distance: torch.Tensor,
    wrap: bool = True,
) -> torch.Tensor:
    """
    Assign every cell to its nearest parent cell (exact EDT, capped at
    ``max_distance``), falling back to the nearest parent centroid for cells
    beyond the cap.

    child_mask : (..., H, W) bool (fixes the grid shape)
    parent_masks : (..., P, H, W) bool; parent_valid : (..., P) bool
    parent_centroids : (..., P, 2) float32; max_distance : (...) float32
    Returns (..., H, W) int64 parent index.
    """
    H, W = child_mask.shape[-2:]
    d = torch.sqrt(euclidean_distance_transform_grid(parent_masks, wrap))
    d = torch.where(parent_valid[..., None, None], d, _INF)
    d = torch.where(d <= max_distance[..., None, None, None], d, _INF)
    dmin, assign = _argmin_parents(d)
    reached = torch.isfinite(dmin)
    fallback = centroid_assign_grid(parent_centroids, parent_valid, (H, W), wrap)
    return torch.where(reached, assign, fallback)


def partition_children_grid_plain(
    prev_labels: torch.Tensor,
    cur_labels: torch.Tensor,
    child_ids: torch.Tensor,
    piece_ids: torch.Tensor,
    parent_ids: torch.Tensor,
    parent_valid: torch.Tensor,
    parent_cents: torch.Tensor,
    max_dist: torch.Tensor,
    nn: bool,
    wrap: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`partition_children_grid_batched` in plain PyTorch, on any
    device: the parents' masks and the exact EDT over whole slices."""
    H, W = cur_labels.shape
    K, P = parent_ids.shape
    child_mask = (cur_labels[None] == child_ids[:, None, None]) & (child_ids > 0)[:, None, None]
    if nn:
        pmasks = (prev_labels[None, None] == parent_ids[..., None, None]) & parent_valid[..., None, None]
        assign = partition_nn_grid(child_mask, pmasks, parent_valid, parent_cents, max_dist, wrap)
        del pmasks
    else:
        assign = centroid_assign_grid(parent_cents, parent_valid, (H, W), wrap)
    update = torch.where(child_mask, torch.gather(piece_ids, 1, assign.view(K, -1)).view(K, H, W), 0)
    pieces = child_mask[:, None] & (assign[:, None] == torch.arange(P, device=assign.device)[None, :, None, None])
    props = grid_mask_props(pieces, wrap)
    upd = update.amax(dim=0)  # children are disjoint
    return torch.where(upd > 0, upd, cur_labels), props


def partition_children_grid_batched(
    prev_labels: torch.Tensor,
    cur_labels: torch.Tensor,
    child_ids: torch.Tensor,
    piece_ids: torch.Tensor,
    parent_ids: torch.Tensor,
    parent_valid: torch.Tensor,
    parent_cents: torch.Tensor,
    max_dist: torch.Tensor,
    nn: bool,
    wrap: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Partition all merging children of one march iteration at once. Children
    are spatially disjoint and parents live in the unchanged previous slice,
    so the batch equals the reference's per-child loop.

    prev_labels, cur_labels : (H, W) int32 label slices at t-1 / t
    child_ids    : (K,) int32 merging child ids (0 = inactive slot; the
                   others distinct)
    piece_ids    : (K, P) int32 replacement id per parent slot
    parent_ids   : (K, P) int32 parent ids at t-1
    parent_valid : (K, P) bool
    parent_cents : (K, P, 2) float32 (y, x) pixel centroids
    max_dist     : (K,) float32 nearest-cell search cap per child

    Returns the updated (H, W) int32 current slice and the (K, P, 3) float32
    (area, cy, cx) of every piece. With ``nn`` a CUDA slice goes to the
    kernel ``marex_partition_grid`` (one call of it counts into
    ``partition_children_grid_batched.launch_count``), a slice elsewhere to
    :func:`partition_children_grid_plain`; without ``nn`` (centroids only)
    every slice takes the plain version.
    """
    if not nn or cur_labels.device.type != "cuda":
        return partition_children_grid_plain(
            prev_labels, cur_labels, child_ids, piece_ids, parent_ids, parent_valid, parent_cents, max_dist, nn, wrap
        )
    _check_partition_args(prev_labels, cur_labels, child_ids, piece_ids, parent_ids, parent_valid, parent_cents,
                          max_dist)
    from .._cuda_build import kernel_library

    H, W = cur_labels.shape
    K, P = parent_ids.shape
    dev = cur_labels.device
    out = cur_labels.clone()
    sums = torch.zeros((K, P, 6), dtype=torch.int64, device=dev)
    if K:
        rowd = torch.empty((K, P, H, W), dtype=torch.int32, device=dev)  # the row distances
        with torch.cuda.device(dev):
            code = kernel_library().marex_partition_grid(
                prev_labels.data_ptr(), cur_labels.data_ptr(), child_ids.data_ptr(), piece_ids.data_ptr(),
                parent_ids.data_ptr(), parent_valid.data_ptr(), parent_cents.data_ptr(), max_dist.data_ptr(),
                rowd.data_ptr(), out.data_ptr(), sums.data_ptr(), K, P, H, W, int(wrap),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        partition_children_grid_batched.launch_count += 1
        if code != 0:
            raise RuntimeError(f"marex_partition_grid launch failed with cudaError {code}")
    return out, grid_sums_props(sums, W, wrap)


partition_children_grid_batched.launch_count = 0


def _check_partition_args(prev, cur, child_ids, piece_ids, parent_ids, parent_valid, parent_cents, max_dist) -> None:
    """Raise on arguments the partition kernel does not take."""
    K = child_ids.shape[0] if child_ids.dim() == 1 else -1
    P = parent_ids.shape[1] if parent_ids.dim() == 2 else -1
    want = {
        "prev_labels": (prev, torch.int32, tuple(cur.shape)),
        "cur_labels": (cur, torch.int32, tuple(cur.shape)),
        "child_ids": (child_ids, torch.int32, (K,)),
        "piece_ids": (piece_ids, torch.int32, (K, P)),
        "parent_ids": (parent_ids, torch.int32, (K, P)),
        "parent_valid": (parent_valid, torch.bool, (K, P)),
        "parent_cents": (parent_cents, torch.float32, (K, P, 2)),
        "max_dist": (max_dist, torch.float32, (K,)),
    }
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got {x.dtype} of shape {tuple(x.shape)}")
        if x.device != cur.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {cur.device}, got {x.device}")
    H, W = cur.shape if cur.dim() == 2 else (0, 0)
    if cur.dim() != 2 or H < 1 or W < 1 or H * W > 2**31 - 1 or H > 8 * 65535:
        raise ValueError(f"the label slices must be (H, W) with 1 <= H * W < 2**31 and H <= 524280, "
                         f"got {tuple(cur.shape)}")
    if P < 1 or K > 65535:
        raise ValueError(f"the kernel takes at least 1 parent slot and at most 65535 children, got K={K}, P={P}")


def relabel_values_slice(labels: torch.Tensor, olds: Sequence[int], news: Sequence[int]) -> torch.Tensor:
    """Apply (old -> new) id renames to one label slice, each against the
    ORIGINAL values (callers resolve chains first); old ids of 0 are
    padding and skipped."""
    out = labels.clone()
    for old, new in zip(olds, news):
        if int(old) > 0:
            out.masked_fill_(labels == int(old), int(new))
    return out


def relabel_and_props_slice(
    labels: torch.Tensor, olds: Sequence[int], news: Sequence[int], targets: torch.Tensor, wrap: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Consolidation renames, then the (area, cy, cx) of each target id in
    the renamed slice (targets of 0 are padding and give zeros).
    Returns ((H, W) int32, (M, 3) float32)."""
    out = relabel_values_slice(labels, olds, news)
    masks = (out[None] == targets[:, None, None]) & (targets > 0)[:, None, None]
    return out, grid_mask_props(masks, wrap)


def hop_distance_unstructured(
    seed_masks: torch.Tensor, neighbours: torch.Tensor, max_distance: int, targets: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """
    Multi-source hop distance from each seed region by iterated graph
    dilation over the table as given (a breadth-first search).

    seed_masks : (..., C) bool; neighbours : (K, C) int32, -1 = missing
    targets : optional (..., C) bool broadcastable against the leading dims
        but the last (the parent axis): the search also stops once every
        target cell has been reached from some seed region of its group, as
        later arrivals are farther. Distances of first arrivals are exact.

    Returns (..., C) float32 hop counts, inf where unreached within
    ``max_distance`` (or when the search stopped first).
    """
    visited = seed_masks.clone()
    dist = torch.where(seed_masks, 0.0, _INF).to(torch.float32)
    rows = [(row.clamp_min(0).long(), row >= 0) for row in neighbours]
    for d in range(1, int(max_distance) + 1):
        grown = visited.clone()
        for idx, valid in rows:
            grown.logical_or_(visited.index_select(-1, idx).logical_and_(valid))
        newly = grown & ~visited
        dist.masked_fill_(newly, float(d))
        visited = grown
        done = ~newly.any()
        if targets is not None:
            done = done | (visited.any(dim=-2) | ~targets).all()
        if bool(done):
            break
    return dist


def _centroid_unit_vectors(parent_centroids: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) float64 unit vectors of (lat, lon) centroids in degrees,
    made on the host (a few values) and placed on the centroids' device."""
    cents = parent_centroids.detach().cpu().numpy()
    unit = mesh_unit_vectors(cents[..., 0], cents[..., 1])  # (3, ..., P)
    return torch.from_numpy(np.moveaxis(unit, 0, -1).copy()).to(parent_centroids.device)


def _haversine_term(cell_unit: torch.Tensor, parent_unit: torch.Tensor) -> torch.Tensor:
    """The haversine term ``a = (1 - u.v) / 2`` in [0, 1], float64, of cells'
    unit vectors (n, 3) against parents' (n, P, 3) or (P, 3): separate
    products and sums, so every device rounds alike. The great-circle
    distance ``2 atan2(sqrt(a), sqrt(1 - a))`` increases with it."""
    dot = cell_unit[..., None, 0] * parent_unit[..., 0]
    dot = dot + cell_unit[..., None, 1] * parent_unit[..., 1]
    dot = dot + cell_unit[..., None, 2] * parent_unit[..., 2]
    return ((1.0 - dot) * 0.5).clamp_(0.0, 1.0)


def haversine_to_centroids(cell_unit: torch.Tensor, parent_centroids: torch.Tensor) -> torch.Tensor:
    """
    Great-circle angular distance from every cell to each parent centroid.

    cell_unit : (3, C) float64 unit vectors (``properties.mesh_unit_vectors``)
    parent_centroids : (P, 2) degrees (lat, lon)
    Returns (P, C) float32 radians.
    """
    a = _haversine_term(cell_unit.t(), _centroid_unit_vectors(parent_centroids)).t()
    return (2.0 * torch.atan2(torch.sqrt(a), torch.sqrt(1.0 - a))).float()


def partition_centroid_unstructured(
    parent_centroids: torch.Tensor, parent_valid: torch.Tensor, cell_unit: torch.Tensor
) -> torch.Tensor:
    """Index of the closest valid parent centroid on the sphere for every
    cell; (C,) int64, the lowest index on ties."""
    a = _haversine_term(cell_unit.t(), _centroid_unit_vectors(parent_centroids))  # (C, P)
    return torch.where(parent_valid[None, :], a, _INF).argmin(dim=1)


def partition_nn_unstructured(
    child_mask: torch.Tensor,
    parent_masks: torch.Tensor,
    parent_valid: torch.Tensor,
    parent_centroids: torch.Tensor,
    neighbours: torch.Tensor,
    cell_unit: torch.Tensor,
    max_distance: int,
) -> torch.Tensor:
    """
    Nearest-parent partitioning on the mesh: hop distance from each parent's
    overlap with the child, the closest parent centroid for cells that no
    parent reaches within ``max_distance`` hops.

    child_mask : (C,) bool; parent_masks : (P, C) bool; parent_valid : (P,)
    Returns (C,) int64 parent index for every cell.
    """
    seeds = parent_masks & child_mask[None, :] & parent_valid[:, None]
    dist = hop_distance_unstructured(seeds, neighbours, max_distance)
    dist = torch.where(parent_valid[:, None], dist, _INF)
    dmin, assign = dist.min(dim=0)
    fallback = partition_centroid_unstructured(parent_centroids, parent_valid, cell_unit)
    return torch.where(torch.isfinite(dmin), assign, fallback)


def partition_children_unstructured_batched(
    prev_labels: torch.Tensor,
    cur_labels: torch.Tensor,
    child_ids: torch.Tensor,
    piece_ids: torch.Tensor,
    parent_ids: torch.Tensor,
    parent_valid: torch.Tensor,
    parent_cents: torch.Tensor,
    caps: torch.Tensor,
    neighbours: torch.Tensor,
    cell_unit: torch.Tensor,
    wall: torch.Tensor,
    nn: bool,
    hop_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Partition all merging children of one march iteration on the mesh, and
    give every piece's spherical properties. The search runs for the batch
    (to ``hop_cap`` hops, or until every child cell is reached); each child's
    own cap is enforced by masking ``dist <= cap``. After the search only the
    children's cells are touched.

    prev_labels, cur_labels : (C,) int32 label slices at t-1 / t
    child_ids : (K,) int32 (0 = inactive slot); piece_ids, parent_ids : (K, P)
    parent_valid : (K, P) bool; parent_cents : (K, P, 2) degrees (lat, lon)
    caps : (K,) float32 nearest-cell search cap per child, in hops
    neighbours : (3, C) int32 as given; cell_unit, wall : the mesh's unit
        vectors (3, C) and weights (4, C), float64

    Returns the updated (C,) int32 slice and (K, P, 3) float32 (area, clat,
    clon) of every piece.
    """
    K, P = parent_ids.shape
    child_mask = (cur_labels[None] == child_ids[:, None]) & (child_ids > 0)[:, None]
    k_idx, c_idx = child_mask.nonzero(as_tuple=True)  # the children's cells
    valid = parent_valid[k_idx]  # (n, P)
    a = _haversine_term(cell_unit[:, c_idx].t(), _centroid_unit_vectors(parent_cents)[k_idx])
    assign = torch.where(valid, a, _INF).argmin(dim=1)
    if nn:
        seeds = (prev_labels[None, None] == parent_ids[..., None]) & parent_valid[..., None] & child_mask[:, None]
        dist = hop_distance_unstructured(seeds, neighbours, hop_cap, targets=child_mask)[k_idx, :, c_idx]  # (n, P)
        del seeds
        dist = torch.where((dist <= caps[k_idx, None]) & valid, dist, _INF)
        dmin, nearest = dist.min(dim=1)
        assign = torch.where(torch.isfinite(dmin), nearest, assign)
    out = cur_labels.clone()
    out[c_idx] = piece_ids[k_idx, assign]
    sums = mesh_segment_sums(k_idx * P + assign, c_idx, wall, K * P)
    return out, torch.stack(spherical_centroids(sums), dim=-1).view(K, P, 3)


def relabel_and_props_unstructured(
    labels: torch.Tensor, olds: Sequence[int], news: Sequence[int], targets: torch.Tensor, wall: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Consolidation renames on a mesh slice, then the (area, clat, clon) of
    each target id in the renamed slice (targets of 0 are padding and give
    zeros). Returns ((C,) int32, (M, 3) float32)."""
    out = relabel_values_slice(labels, olds, news)
    masks = (out[None] == targets[:, None]) & (targets > 0)[:, None]
    return out, unstructured_mask_props(masks, wall)
