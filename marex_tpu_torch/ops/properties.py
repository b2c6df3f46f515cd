"""
Per-object properties on a regular grid and on an unstructured mesh: areas,
centroids and the (time, ID) table of original object ids.

The port of ``marex_tpu/ops/properties.py``. On a grid, the six
sums behind the periodic centroid (area, sum y, sum x, the count right of
W/2 and the two edge flags) are accumulated as int64 pixel counts, or in
float64 with cell weights, and then cast to float32 and divided exactly as
the reference does. Integer sums do not depend on the order of the atomics,
so CUDA equals the CPU; while a float32 sum stays below 2**24 the reference's
float32 sums are exact too, and the results are bit-identical. Above that
(large objects at 0.25 degree) the reference's float32 ``sum_x`` loses
digits and these sums do not.

On a mesh, the area-weighted spherical centroid needs four sums per object:
the cell areas and the areas times the cells' unit vectors. The per-cell
weights are made once on the host, in float64 from the float32 coordinates
(:func:`mesh_weights`), so the CPU and CUDA sum the same numbers; the sums
are float64 (exact for equal cell areas, and within 1e-15 of each other in
any order otherwise) and everything after them is float64 rounded once to
float32. The reference sums and divides in float32, in an order of XLA's
choosing: its areas are exact only while a sum fits 24 bits, and its
centroids agree with these to about 1e-4 degrees.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

EDGE_ZONE = 100  # cells from the x-boundary counting as "near the edge"
# cells per chunk of the int64 bookkeeping
_CHUNK_CELLS = 64 * 1024 * 1024


def _centroids(
    areas: torch.Tensor, sum_y: torch.Tensor, sum_x: torch.Tensor, cnt_right: torch.Tensor, wrapped: torch.Tensor, W: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's float32 centroid formula from float32 sums: x indices
    right of W/2 shift by -W when the object wraps, and the mean re-wraps."""
    safe = torch.clamp_min(areas, 1e-30)
    cy = sum_y / safe
    cx_plain = sum_x / safe
    cx_adj = (sum_x - W * cnt_right) / safe
    cx_adj = torch.where(cx_adj < 0, cx_adj + W, cx_adj)
    return areas, cy, torch.where(wrapped, cx_adj, cx_plain)


def grid_label_props(
    labels: torch.Tensor, n_labels: int, wrap: bool, cell_weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    Areas and (y, x) pixel centroids per label on a regular grid, with the
    reference's periodic recentring: when a label touches both x edge zones,
    x indices greater than W/2 shift by -W before averaging and the mean is
    re-wrapped positive.

    labels : (T, H, W) int32 dense in [0, n_labels]
    cell_weights : optional (H, W) weights (physical cell areas); when None,
        area = pixel count and centroids are unweighted.

    Returns areas, cy, cx: (T, n_labels + 1) float32 (0 and NaN where absent;
    column 0 is the background).
    """
    T, H, W = labels.shape
    S = H * W
    dev = labels.device
    nb = n_labels + 1
    y = torch.arange(H, device=dev).repeat_interleave(W)
    x = torch.arange(W, device=dev).repeat(H)
    if cell_weights is None:
        weights = {"y": y.double(), "x": x.double()}  # the area and the right-half count are plain counts
    else:
        w = cell_weights.reshape(S).to(device=dev, dtype=torch.float32)
        # per-cell products in float32, as the reference forms them
        weights = {"area": w.double(), "y": (w * y.float()).double(), "x": (w * x.float()).double(),
                   "right": (w * (x > W / 2).float()).double()}
    # integer sums (and float32 weights) add exactly in float64 up to 2**53
    sums = {k: torch.zeros(T * nb, dtype=torch.float64, device=dev) for k in ("area", "y", "x", "right", "l", "r")}
    tb = max(1, _CHUNK_CELLS // max(S, 1))
    for t0 in range(0, T, tb):
        rows = labels[t0 : t0 + tb]
        n = rows.shape[0]
        idx = torch.arange(n, device=dev)[:, None, None] * nb + rows  # (n, H, W) int64 bin of each cell
        zones = {"area": idx, "right": idx[:, :, W // 2 + 1 :], "l": idx[:, :, :EDGE_ZONE],
                 "r": idx[:, :, max(W - EDGE_ZONE, 0) :]}
        for k, s in sums.items():
            if k in weights:
                s[t0 * nb : (t0 + n) * nb] += torch.bincount(idx.reshape(-1), weights=weights[k].repeat(n),
                                                             minlength=n * nb)
            else:
                s[t0 * nb : (t0 + n) * nb] += torch.bincount(zones[k].reshape(-1), minlength=n * nb)
    areas, sum_y, sum_x, cnt_right = (sums[k].view(T, nb).float() for k in ("area", "y", "x", "right"))
    wrapped = (sums["l"].view(T, nb) > 0) & (sums["r"].view(T, nb) > 0) & wrap
    areas, cy, cx = _centroids(areas, sum_y, sum_x, cnt_right, wrapped, W)
    present = areas > 0
    nan = torch.tensor(float("nan"), device=dev)
    return torch.where(present, areas, 0.0), torch.where(present, cy, nan), torch.where(present, cx, nan)


def grid_mask_props(masks: torch.Tensor, wrap: bool) -> torch.Tensor:
    """
    (area, cy, cx) of each boolean (H, W) mask of a batch, with the
    EDGE_ZONE periodic recentring rule (``marex_tpu`` ``grid_mask_props``,
    vmapped over masks). An empty mask gives (0, 0, 0).

    masks : (..., H, W) bool -> (..., 3) float32
    """
    H, W = masks.shape[-2:]
    dev = masks.device
    rows = masks.sum(dim=-1, dtype=torch.int64)  # (..., H)
    cols = masks.sum(dim=-2, dtype=torch.int64)  # (..., W)
    sums = [
        rows.sum(dim=-1),
        (rows * torch.arange(H, device=dev)).sum(dim=-1),
        (cols * torch.arange(W, device=dev)).sum(dim=-1),
        cols[..., W // 2 + 1 :].sum(dim=-1),
        cols[..., :EDGE_ZONE].sum(dim=-1),
        cols[..., max(W - EDGE_ZONE, 0) :].sum(dim=-1),
    ]
    return grid_sums_props(torch.stack(sums, dim=-1), W, wrap)


def grid_sums_props(sums: torch.Tensor, W: int, wrap: bool) -> torch.Tensor:
    """
    (area, cy, cx) float32 of grid masks from their six integer sums
    ``(..., 6)`` int64: cells, sum of y, sum of x, cells with x > W/2, cells
    in the left and in the right EDGE_ZONE columns (the mask wraps when it
    has both). The sums are exact in any order, so whoever adds them up (the
    partition kernel with atomics, or :func:`grid_mask_props`) gets the same
    float32 props.
    """
    area, sum_y, sum_x, cnt_right, left, right = sums.unbind(dim=-1)
    wrapped = (left > 0) & (right > 0) & wrap
    area, cy, cx = _centroids(area.float(), sum_y.float(), sum_x.float(), cnt_right.float(), wrapped, W)
    return torch.stack([area, cy, cx], dim=-1)


def event_global_id_lookup(old: torch.Tensor, lookup: torch.Tensor, n_events: int) -> torch.Tensor:
    """
    (time, ID) table of the original object id each event carries at each
    time: the largest old id among the cells whose new id ``lookup[old]`` is
    the event (``marex_tpu`` ``event_global_id_lookup``, both of its
    branches). A max does not depend on order, so the ``scatter_reduce``
    amax is deterministic. Runs over time chunks of about ``_CHUNK_CELLS``.

    old : (T, ...) int32 original object ids (0 = background)
    lookup : (n,) int32 new event id of each old id
    Returns (T, n_events + 1) int32, column 0 unused (0).
    """
    T = old.shape[0]
    S = old[0].numel()
    nb = n_events + 2  # column n_events + 1 takes the background and is dropped
    out = torch.zeros((T, nb), dtype=torch.int32, device=old.device)
    tb = max(1, _CHUNK_CELLS // max(S, 1))
    for t0 in range(0, T, tb):
        rows = old[t0 : t0 + tb].reshape(-1, S)
        n = rows.shape[0]
        new = torch.index_select(lookup, 0, rows.reshape(-1)).view(n, S)
        cols = torch.where(new > 0, new, n_events + 1).long() + torch.arange(n, device=old.device)[:, None] * nb
        out[t0 : t0 + n].view(-1).scatter_reduce_(0, cols.view(-1), rows.reshape(-1), "amax", include_self=True)
    return out[:, : n_events + 1].contiguous()


def interp_coord(pix: torch.Tensor, coord_values: torch.Tensor) -> torch.Tensor:
    """Linear pixel-index -> coordinate interpolation with ``np.interp``
    semantics (clamped at the ends), by ``searchsorted``: the arithmetic of
    ``jnp.interp`` in float32, whose ``fp[i-1] + q * df`` XLA fuses into one
    multiply-add. Here the float32 product is exact in float64 and the sum is
    rounded to float32 from there."""
    fp = coord_values.to(device=pix.device, dtype=torch.float32)
    n = fp.shape[0]
    xp = torch.arange(n, dtype=torch.float32, device=pix.device)
    x = pix.to(torch.float32)
    i = torch.searchsorted(xp, x.reshape(-1), right=True).clamp(1, n - 1).view(x.shape)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    q = delta / torch.where(dx0, 1.0, dx)
    f = torch.where(dx0, fp[i - 1], (fp[i - 1].double() + q.double() * df.double()).float())
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def mesh_unit_vectors(lat_deg: np.ndarray, lon_deg: np.ndarray) -> np.ndarray:
    """(3, C) float64 unit vectors (x, y, z) of the cells, from coordinates in
    degrees rounded to float32 first (the reference's input precision)."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float32).astype(np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float32).astype(np.float64))
    return np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)])


def mesh_weights(lat_deg: np.ndarray, lon_deg: np.ndarray, cell_area: np.ndarray, device) -> torch.Tensor:
    """(4, C) float64 per-cell weights on ``device``: the float32 cell area
    ``a``, then ``a`` times the cell's unit vector — the addends of the
    spherical-centroid sums, made on the host so every device sums the same
    numbers."""
    a = np.asarray(cell_area, dtype=np.float32).astype(np.float64)
    return torch.from_numpy(np.concatenate([a[None], a[None] * mesh_unit_vectors(lat_deg, lon_deg)])).to(device)


def mesh_segment_sums(bins: torch.Tensor, cells: torch.Tensor, wall: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(n_bins, 4) float64: for each bin, the sums of ``wall`` over the cells
    listed for it (``bins`` and ``cells`` are parallel int64 lists)."""
    return torch.stack([torch.bincount(bins, weights=w[cells], minlength=n_bins) for w in wall], dim=1)


def spherical_centroids(sums: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(area, clat, clon) float32 from (..., 4) float64 sums ``[a, a x, a y,
    a z]``: the mean vector renormalised and turned back into degrees, lat in
    [-90, 90], lon folded into [-180, 180]; (0, 0) where the vector is zero."""
    wx, wy, wz = sums[..., 1], sums[..., 2], sums[..., 3]
    norm = torch.sqrt(wx * wx + wy * wy + wz * wz)
    norm = torch.where(norm > 0, norm, 1.0)
    clat = torch.rad2deg(torch.asin(torch.clamp(wz / norm, -1.0, 1.0)))
    clon = torch.rad2deg(torch.atan2(wy / norm, wx / norm))
    clon = torch.where(clon > 180.0, clon - 360.0, torch.where(clon < -180.0, clon + 360.0, clon))
    return sums[..., 0].float(), clat.float(), clon.float()


def _label_sums_mesh(labels: torch.Tensor, wall: torch.Tensor, n_labels: int) -> torch.Tensor:
    """(T, n_labels + 1, 4) float64 sums of ``wall`` by label; only the
    labelled cells are touched (column 0, the background, stays 0). Runs over
    time chunks of about ``_CHUNK_CELLS`` cells."""
    T, C = labels.shape
    nb = n_labels + 1
    out = torch.zeros((T, nb, 4), dtype=torch.float64, device=labels.device)
    tb = max(1, _CHUNK_CELLS // max(C, 1))
    for t0 in range(0, T, tb):
        rows = labels[t0 : t0 + tb]
        n = rows.shape[0]
        pos = rows.reshape(-1).nonzero().squeeze(1)
        bins = torch.div(pos, C, rounding_mode="floor") * nb + rows.reshape(-1)[pos]
        out[t0 : t0 + n] = mesh_segment_sums(bins, pos % C, wall, n * nb).view(n, nb, 4)
    return out


def unstructured_label_comps(labels: torch.Tensor, wall: torch.Tensor, n_labels: int) -> torch.Tensor:
    """
    The additive property components per label on a mesh
    (``marex_tpu`` ``unstructured_label_comps``): ``[area, sum a x, sum a y,
    sum a z]``.

    labels : (T, C) int32 dense in [0, n_labels]; wall : :func:`mesh_weights`
    Returns (T, n_labels + 1, 4) float32 (the background row is 0).
    """
    return _label_sums_mesh(labels, wall, n_labels).float()


def unstructured_label_props(
    labels: torch.Tensor, wall: torch.Tensor, n_labels: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    Areas and area-weighted spherical centroids per label on a mesh.

    labels : (T, C) int32 dense in [0, n_labels]; wall : :func:`mesh_weights`
    Returns areas, clat, clon: (T, n_labels + 1) float32, centroids in
    degrees and NaN where the label is absent; column 0 is the background.
    """
    areas, clat, clon = spherical_centroids(_label_sums_mesh(labels, wall, n_labels))
    present = areas > 0
    nan = torch.tensor(float("nan"), device=labels.device)
    return areas, torch.where(present, clat, nan), torch.where(present, clon, nan)


def unstructured_mask_props(masks: torch.Tensor, wall: torch.Tensor) -> torch.Tensor:
    """
    (area, clat, clon) of each boolean (C,) mask of a batch (``marex_tpu``
    ``unstructured_mask_props``, vmapped over masks). An empty mask gives
    (0, 0, 0).

    masks : (..., C) bool -> (..., 3) float32
    """
    lead, C = masks.shape[:-1], masks.shape[-1]
    m, c = masks.reshape(-1, C).nonzero(as_tuple=True)
    sums = mesh_segment_sums(m, c, wall, int(np.prod(lead, dtype=np.int64)))
    return torch.stack(spherical_centroids(sums), dim=-1).view(*lead, 3)
