"""
Reference split/merge march, upstream marEx's ``split_and_merge_objects``
in its per-step form.

Objects are the per-slice components, numbered through the record (slice t's
k-th object is ``counts[:t].sum() + k``). Two objects of consecutive slices
overlap where they share cells (on a mesh: by the summed area of the shared
cells), and a pair counts when its overlap is at least ``overlap_threshold``
of the smaller object's area. At each step t, in order:

1. consolidation of slice t-1: a parent at t-2 linked to several objects at
   t-1 renames them all to the first of them;
2. up to 10 rounds in which every object at t linked to several parents at
   t-1 is cut into one piece per parent: a cell goes to the parent whose
   nearest cell is closest (``nn_partitioning``: the exact Euclidean distance
   on a grid, periodic in longitude, or the hop count on a mesh, each capped),
   else to the parent whose centroid is closest; the first piece keeps the
   child's id, the others get new ids in order, and a merge record is kept.

After the last step slice T-1 is consolidated against T-2, and the overlap
pairs of the final labels that pass the threshold are the event graph.
Areas are cell counts on a grid and summed cell areas on a mesh; centroids
are pixel means on a grid (a periodic mean for objects touching both edge
zones) and area-weighted unit-vector means on a mesh.

Reads ``state["labels"]`` and ``state["counts"]``; writes
``state["march"]`` (final labels, object table, overlap list, merge records).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

INF = float("inf")
EDGE_ZONE = 100  # cells from a longitude edge that count as near it
MAX_PARENTS = 10
_STEPS = 64


# ---------------------------------------------------------------- properties


def centroids(area, sum_y, sum_x, cnt_right, wrapped, W: int):
    """(area, cy, cx) from float32 sums: with ``wrapped``, x indices right of
    W/2 count as x - W and the mean wraps back positive."""
    safe = torch.clamp_min(area, 1e-30)
    cy = sum_y / safe
    cx_plain = sum_x / safe
    cx_adj = (sum_x - W * cnt_right) / safe
    cx_adj = torch.where(cx_adj < 0, cx_adj + W, cx_adj)
    return area, cy, torch.where(wrapped, cx_adj, cx_plain)


def grid_label_props(labels: torch.Tensor, n: int, wrap: bool = True):
    """Pixel areas and (y, x) centroids of dense labels (T, H, W) in [0, n]:
    (T, n + 1) float32 each, 0 / NaN where absent."""
    T, H, W = labels.shape
    dev = labels.device
    nb = n + 1
    y = torch.arange(H, device=dev).repeat_interleave(W)
    x = torch.arange(W, device=dev).repeat(H)
    sums = {k: torch.zeros((T, nb), dtype=torch.int64, device=dev) for k in ("area", "y", "x", "right", "l", "r")}
    for t0 in range(0, T, _STEPS):
        rows = labels[t0 : t0 + _STEPS].reshape(-1, H * W).long()
        m = rows.shape[0]
        b = rows + torch.arange(m, device=dev)[:, None] * nb
        for k, w in (("area", None), ("y", y), ("x", x), ("right", x > W // 2), ("l", x < EDGE_ZONE),
                     ("r", x >= W - EDGE_ZONE)):
            if w is None:
                s = torch.bincount(b.reshape(-1), minlength=m * nb)
            elif w.dtype == torch.bool:
                s = torch.bincount(b[:, w].reshape(-1), minlength=m * nb)
            else:
                s = torch.bincount(b.reshape(-1), weights=w.double().repeat(m), minlength=m * nb).round().long()
            sums[k][t0 : t0 + m] = s.view(m, nb)
    wrapped = (sums["l"] > 0) & (sums["r"] > 0) & wrap
    area, cy, cx = centroids(*(sums[k].float() for k in ("area", "y", "x", "right")), wrapped, W)
    present = area > 0
    nan = torch.tensor(float("nan"), device=dev)
    return torch.where(present, area, 0.0), torch.where(present, cy, nan), torch.where(present, cx, nan)


def grid_mask_props(masks: torch.Tensor, wrap: bool = True) -> torch.Tensor:
    """(area, cy, cx) of each (H, W) mask of a batch; (..., 3) float32."""
    H, W = masks.shape[-2:]
    dev = masks.device
    rows = masks.sum(dim=-1, dtype=torch.int64)
    cols = masks.sum(dim=-2, dtype=torch.int64)
    area = rows.sum(dim=-1)
    sum_y = (rows * torch.arange(H, device=dev)).sum(dim=-1)
    sum_x = (cols * torch.arange(W, device=dev)).sum(dim=-1)
    right = cols[..., W // 2 + 1 :].sum(dim=-1)
    wrapped = (cols[..., :EDGE_ZONE].sum(dim=-1) > 0) & (cols[..., max(W - EDGE_ZONE, 0) :].sum(dim=-1) > 0) & wrap
    return torch.stack(centroids(area.float(), sum_y.float(), sum_x.float(), right.float(), wrapped, W), dim=-1)


def unit_vectors(lat_deg, lon_deg) -> np.ndarray:
    """(3, ...) float64 unit vectors of coordinates in degrees (rounded to float32 first)."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float32).astype(np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float32).astype(np.float64))
    return np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)])


def mesh_weights(lat, lon, cell_area, device) -> torch.Tensor:
    """(4, C) float64: each cell's area and its area times its unit vector."""
    a = np.asarray(cell_area, dtype=np.float32).astype(np.float64)
    return torch.from_numpy(np.concatenate([a[None], a[None] * unit_vectors(lat, lon)])).to(device)


def spherical(sums: torch.Tensor):
    """(area, lat, lon) float32 from (..., 4) float64 sums: the mean vector
    back in degrees, lon in [-180, 180]."""
    wx, wy, wz = sums[..., 1], sums[..., 2], sums[..., 3]
    norm = torch.sqrt(wx * wx + wy * wy + wz * wz)
    norm = torch.where(norm > 0, norm, 1.0)
    lat = torch.rad2deg(torch.asin(torch.clamp(wz / norm, -1.0, 1.0)))
    lon = torch.rad2deg(torch.atan2(wy / norm, wx / norm))
    lon = torch.where(lon > 180.0, lon - 360.0, torch.where(lon < -180.0, lon + 360.0, lon))
    return sums[..., 0].float(), lat.float(), lon.float()


def segment_sums(bins: torch.Tensor, cells: torch.Tensor, wall: torch.Tensor, n: int) -> torch.Tensor:
    return torch.stack([torch.bincount(bins, weights=w[cells], minlength=n) for w in wall], dim=1)


def mesh_label_props(labels: torch.Tensor, wall: torch.Tensor, n: int):
    """Areas and centroids of dense labels (T, C) in [0, n]: (T, n + 1)
    float32 each, NaN centroids where absent."""
    T, C = labels.shape
    nb = n + 1
    out = torch.zeros((T, nb, 4), dtype=torch.float64, device=labels.device)
    for t0 in range(0, T, _STEPS):
        rows = labels[t0 : t0 + _STEPS]
        pos = rows.reshape(-1).nonzero().squeeze(1)
        bins = torch.div(pos, C, rounding_mode="floor") * nb + rows.reshape(-1)[pos]
        out[t0 : t0 + rows.shape[0]] = segment_sums(bins, pos % C, wall, rows.shape[0] * nb).view(-1, nb, 4)
    area, lat, lon = spherical(out)
    nan = torch.tensor(float("nan"), device=labels.device)
    return area, torch.where(area > 0, lat, nan), torch.where(area > 0, lon, nan)


def mesh_mask_props(masks: torch.Tensor, wall: torch.Tensor) -> torch.Tensor:
    lead, C = masks.shape[:-1], masks.shape[-1]
    m, c = masks.reshape(-1, C).nonzero(as_tuple=True)
    sums = segment_sums(m, c, wall, int(np.prod(lead, dtype=np.int64)))
    return torch.stack(spherical(sums), dim=-1).view(*lead, 3)


# ---------------------------------------------------------------- overlaps


def slice_pairs(a: torch.Tensor, b: torch.Tensor, stride: int, weights) -> np.ndarray:
    """(a, b, overlap) rows of the objects of two slices that share cells,
    ascending by (a, b); float64 (a float32 area sum on a mesh)."""
    a, b = a.reshape(-1).long(), b.reshape(-1).long()
    both = (a > 0) & (b > 0)
    key = (a * stride + b)[both]
    if weights is None:
        k, c = torch.unique(key, return_counts=True)
        c = c.double()
    else:
        k, inv = torch.unique(key, return_inverse=True)
        c = torch.zeros(k.numel(), dtype=torch.float64, device=key.device).index_add_(0, inv, weights.double()[both])
        c = c.float().double()
    return torch.stack([(k // stride).double(), (k % stride).double(), c], dim=1).cpu().numpy()


def pair_lists(labels: torch.Tensor, weights) -> List[np.ndarray]:
    """:func:`slice_pairs` of every consecutive slice pair."""
    stride = int(labels.max()) + 2
    return [slice_pairs(labels[t], labels[t + 1], stride, weights) for t in range(labels.shape[0] - 1)]


# ---------------------------------------------------------------- partition


def row_distance(mask: torch.Tensor, wrap: bool) -> torch.Tensor:
    """Cells to the nearest True along the last axis (periodic with
    ``wrap``), inf where a row has none; float32."""
    W = mask.shape[-1]
    ar = torch.arange(W, device=mask.device)
    prev = torch.where(mask, ar, -W * 4).cummax(dim=-1).values
    nxt = torch.where(mask, ar, W * 5).flip(-1).cummin(dim=-1).values.flip(-1)
    if wrap:
        last, first = prev[..., -1:], nxt[..., :1]
        prev = torch.where(prev < 0, last - W, prev)
        nxt = torch.where(nxt >= W, first + W, nxt)
    d = torch.minimum(ar - prev, nxt - ar)
    return torch.where(d >= 2 * W, INF, d.float())


def distance_sq(masks: torch.Tensor, wrap: bool, reach: int) -> torch.Tensor:
    """Squared Euclidean distance to the nearest True of each (H, W) mask,
    exact wherever it is at most ``reach`` (larger or inf beyond): the
    squared row distance, then the minimum over rows of it plus the squared
    row offset, over the rows within ``reach`` or, when that is most of the
    grid, over the rows that hold a True at all."""
    H, W = masks.shape[-2:]
    d1 = row_distance(masks, wrap)
    d1 = (d1 * d1).reshape(-1, H, W)
    if 2 * reach + 1 < H:
        out = d1.clone()
        for dy in range(1, reach + 1):
            torch.minimum(out[:, dy:], d1[:, :-dy] + float(dy * dy), out=out[:, dy:])
            torch.minimum(out[:, :-dy], d1[:, dy:] + float(dy * dy), out=out[:, :-dy])
        return out.view(masks.shape)
    src = torch.isfinite(d1).any(dim=2).any(dim=0).nonzero().squeeze(1)
    out = torch.full_like(d1, INF)
    if src.numel():
        dy2 = (src.float()[None, :] - torch.arange(H, dtype=torch.float32, device=d1.device)[:, None]) ** 2
        rows = max(1, (1 << 30) // max(d1.shape[0] * src.numel() * W * 4, 1))
        for y0 in range(0, H, rows):
            out[:, y0 : y0 + rows] = (d1[:, src][:, None] + dy2[y0 : y0 + rows, :, None]).amin(dim=2)
    return out.view(masks.shape)


def first_min(d: torch.Tensor):
    """(min, lowest index of the min) over the parent axis -3."""
    best = d[..., 0, :, :]
    idx = torch.zeros(best.shape, dtype=torch.int64, device=d.device)
    for p in range(1, d.shape[-3]):
        closer = d[..., p, :, :] < best
        best = torch.where(closer, d[..., p, :, :], best)
        idx.masked_fill_(closer, p)
    return best, idx


def nearest_centroid_grid(cents: torch.Tensor, valid: torch.Tensor, H: int, W: int, wrap: bool) -> torch.Tensor:
    dev = cents.device
    dy = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - cents[..., 0, None, None]
    dx = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - cents[..., 1, None, None]
    if wrap:
        dx = torch.where(dx > W / 2.0, dx - W, dx)
        dx = torch.where(dx < -W / 2.0, dx + W, dx)
    d2 = dy * dy + dx * dx
    return first_min(torch.where(valid[..., None, None], d2, INF))[1]


def partition_grid(prev, cur, child, piece, pids, valid, cents, caps, nn: bool, wrap: bool = True):
    """Cut each child of ``cur`` (H, W) among its parents in ``prev``;
    returns the new slice and the (K, P, 3) properties of the pieces."""
    H, W = cur.shape
    K, P = pids.shape
    cmask = (cur[None] == child[:, None, None]) & (child > 0)[:, None, None]
    fallback = nearest_centroid_grid(cents, valid, H, W, wrap)
    if nn:
        pm = (prev[None, None] == pids[..., None, None]) & valid[..., None, None]
        d = torch.sqrt(distance_sq(pm, wrap, int(np.ceil(float(caps.max())))))
        del pm
        d = torch.where(valid[..., None, None], d, INF)
        d = torch.where(d <= caps[:, None, None, None], d, INF)
        dmin, near = first_min(d)
        assign = torch.where(torch.isfinite(dmin), near, fallback)
    else:
        assign = fallback
    new = torch.where(cmask, torch.gather(piece, 1, assign.view(K, -1)).view(K, H, W), 0).amax(dim=0)
    pieces = cmask[:, None] & (assign[:, None] == torch.arange(P, device=cur.device)[None, :, None, None])
    return torch.where(new > 0, new, cur), grid_mask_props(pieces, wrap)


def hops(seeds: torch.Tensor, nb: torch.Tensor, cap: int, targets: torch.Tensor) -> torch.Tensor:
    """Hop distance from each seed region (..., C) over the table as given,
    inf past ``cap``; stops once every target cell is reached from some
    region of its group (later arrivals are farther)."""
    seen = seeds.clone()
    dist = torch.where(seeds, 0.0, INF).to(torch.float32)
    rows = [(r.clamp_min(0).long(), r >= 0) for r in nb]
    for d in range(1, cap + 1):
        grown = seen.clone()
        for idx, ok in rows:
            grown |= seen[..., idx] & ok
        new = grown & ~seen
        dist.masked_fill_(new, float(d))
        seen = grown
        if not bool(new.any()) or bool((seen.any(dim=-2) | ~targets).all()):
            break
    return dist


def haversine_term(cell_unit: torch.Tensor, parent_unit: torch.Tensor) -> torch.Tensor:
    dot = cell_unit[..., None, 0] * parent_unit[..., 0]
    dot = dot + cell_unit[..., None, 1] * parent_unit[..., 1]
    dot = dot + cell_unit[..., None, 2] * parent_unit[..., 2]
    return ((1.0 - dot) * 0.5).clamp_(0.0, 1.0)


def partition_mesh(prev, cur, child, piece, pids, valid, cents, caps, nb, unit, wall, nn: bool, cap: int):
    K, P = pids.shape
    cmask = (cur[None] == child[:, None]) & (child > 0)[:, None]
    k_idx, c_idx = cmask.nonzero(as_tuple=True)
    ok = valid[k_idx]
    pu = torch.from_numpy(np.moveaxis(unit_vectors(cents[..., 0].cpu().numpy(), cents[..., 1].cpu().numpy()), 0, -1)
                          .copy()).to(cur.device)
    assign = torch.where(ok, haversine_term(unit[:, c_idx].t(), pu[k_idx]), INF).argmin(dim=1)
    if nn:
        seeds = (prev[None, None] == pids[..., None]) & valid[..., None] & cmask[:, None]
        dist = hops(seeds, nb, cap, cmask)[k_idx, :, c_idx]
        dist = torch.where((dist <= caps[k_idx, None]) & ok, dist, INF)
        dmin, near = dist.min(dim=1)
        assign = torch.where(torch.isfinite(dmin), near, assign)
    out = cur.clone()
    out[c_idx] = piece[k_idx, assign]
    sums = segment_sums(k_idx * P + assign, c_idx, wall, K * P)
    return out, torch.stack(spherical(sums), dim=-1).view(K, P, 3)


# ---------------------------------------------------------------- the march


class March:
    def __init__(self, state: dict):
        cfg, mix = state["config"], state["mix"]
        kw = {**cfg["tracker"], **mix["tracker"]}
        self.labels = state.pop("labels")
        self.counts = state.pop("counts")
        self.times = np.asarray(state["times"])
        self.threshold = float(kw.get("overlap_threshold", 0.5))
        self.nn = bool(kw.get("nn_partitioning", False))
        self.mesh = bool(kw.get("unstructured_grid", False))
        dev = self.labels.device
        self.table: Dict[int, Tuple[float, float, float]] = {}
        if self.mesh:
            coords = state["inputs"]["coords"]
            lat, lon = np.asarray(coords["lat"][1], np.float64), np.asarray(coords["lon"][1], np.float64)
            area = np.asarray(state["inputs"]["cell_areas"], dtype=np.float32)
            self.mean_area = float(np.mean(area))
            self.weights = torch.from_numpy(area).to(dev)
            self.wall = mesh_weights(lat, lon, area, dev)
            self.unit = torch.from_numpy(unit_vectors(lat, lon)).to(dev)
            self.nb = torch.from_numpy(np.asarray(state["inputs"]["neighbours"], dtype=np.int32) - 1).to(dev)
        else:
            self.weights = None
            g = state["config"]["grid"]
            self.H, self.W = g["ny"], g["nx"]
            self.labels = self.labels.view(-1, self.H, self.W)

    # -- the object table

    def enter_objects(self) -> None:
        counts = self.counts
        L = int(counts.max()) if counts.size else 0
        if self.mesh:
            props = mesh_label_props(self.labels, self.wall, L)
        else:
            props = grid_label_props(self.labels, L)
        area, c0, c1 = (p.cpu().numpy() for p in props)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        for t in range(self.labels.shape[0]):
            for k in range(1, int(counts[t]) + 1):
                self.table[int(offsets[t]) + k] = (float(area[t, k]), float(c0[t, k]), float(c1[t, k]))
        off = torch.from_numpy(offsets).to(self.labels.device).to(torch.int32)
        shape = (-1,) + (1,) * (self.labels.dim() - 1)
        self.labels += torch.where(self.labels > 0, off.view(shape), 0)

    def linked(self, pairs: np.ndarray) -> np.ndarray:
        """The pairs whose overlap is at least the threshold of the smaller object's area."""
        keep = []
        for a, b, w in pairs:
            ia, ib = int(a), int(b)
            if ia not in self.table or ib not in self.table:
                continue
            smaller = min(self.table[ia][0], self.table[ib][0])
            if smaller > 0 and (w / smaller) >= self.threshold:
                keep.append((a, b, w))
        return np.array(keep, dtype=np.float64).reshape(-1, 3)

    # -- the steps

    def consolidate(self, back: np.ndarray, t: int) -> bool:
        parents, n = np.unique(back[:, 0], return_counts=True)
        renames, to, targets = [], {}, []
        for p in parents[n > 1]:
            if int(p) not in self.table:
                continue
            children = back[back[:, 0] == p, 1].astype(np.int64)
            first = int(children[0])
            if first not in self.table:
                continue
            changed = False
            for c in children[1:]:
                c = int(c)
                if c not in self.table:
                    continue
                renames.append(c)
                to[c] = first
                self.table.pop(c, None)
                changed = True
            if changed:
                targets.append(first)
        if not renames:
            return False

        def resolve(x: int) -> int:
            seen = set()
            while x in to and x not in seen:
                seen.add(x)
                x = to[x]
            return x

        sl = self.labels[t]
        new = sl.clone()
        for old in renames:
            new.masked_fill_(sl == old, resolve(old))
        final = sorted({resolve(f) for f in targets})
        tg = torch.tensor(final, dtype=torch.int32, device=sl.device)
        if self.mesh:
            props = mesh_mask_props((new[None] == tg[:, None]) & (tg > 0)[:, None], self.wall)
        else:
            props = grid_mask_props((new[None] == tg[:, None, None]) & (tg > 0)[:, None, None])
        self.labels[t] = new
        for i, f in enumerate(final):
            a, c0, c1 = (float(v) for v in props[i].cpu().numpy())
            if a > 0:
                self.table[int(f)] = (a, c0, c1)
        return True

    def partition(self, batch, t: int) -> None:
        K = len(batch)
        P = max(len(par) for _, par, _ in batch)
        child = np.zeros(K, np.int32)
        piece = np.zeros((K, P), np.int32)
        pids = np.zeros((K, P), np.int32)
        valid = np.zeros((K, P), bool)
        cents = np.zeros((K, P, 2), np.float32)
        caps = np.zeros(K, np.float32)
        for i, (cid, par, cids) in enumerate(batch):
            n = len(par)
            child[i], piece[i, :n], pids[i, :n], valid[i, :n] = cid, cids, par, True
            cents[i, :n] = np.array([self.table[int(p)][1:] for p in par], np.float32)
            if self.nn:
                biggest = max(self.table[int(p)][0] for p in par)
                if self.mesh:
                    caps[i] = float(max(int(np.sqrt(biggest / self.mean_area) * 2.0), 20) * 2)
                else:
                    caps[i] = float(max(int(np.sqrt(biggest) * 3.0), 40))
        dev = self.labels.device
        args = [torch.from_numpy(x).to(dev) for x in (child, piece, pids, valid, cents, caps)]
        if self.mesh:
            new, props = partition_mesh(self.labels[t - 1], self.labels[t], *args, self.nb, self.unit, self.wall,
                                        self.nn, int(max(caps.max(), 1.0)))
        else:
            new, props = partition_grid(self.labels[t - 1], self.labels[t], *args, self.nn)
        self.labels[t] = new
        pp = props.cpu().numpy()
        for i, (_, _, cids) in enumerate(batch):
            for j, pid in enumerate(cids):
                a = float(pp[i, j, 0])
                if a > 0:
                    self.table[int(pid)] = (a, float(pp[i, j, 1]), float(pp[i, j, 2]))
                elif j == 0:
                    self.table.pop(int(pid), None)

    def run(self) -> dict:
        self.enter_objects()
        T = self.labels.shape[0]
        pairs: List = pair_lists(self.labels, self.weights) if T >= 2 else []
        next_id = max(self.table, default=0) + 1
        records = {"time": [], "children": [], "parents": [], "areas": []}

        def get(t: int) -> np.ndarray:
            if pairs[t] is None:
                pairs[t] = slice_pairs(self.labels[t], self.labels[t + 1], next_id + 1, self.weights)
            return pairs[t]

        def invalidate(t: int) -> None:
            if 0 <= t - 1 < T - 1:
                pairs[t - 1] = None
            if 0 <= t < T - 1:
                pairs[t] = None

        for t in range(T):
            if t > 1:
                back = self.linked(get(t - 2))
                if len(back) and self.consolidate(back, t - 1):
                    invalidate(t - 1)
            if t == 0:
                continue
            for _ in range(10):
                cur = self.linked(get(t - 1))
                if len(cur) == 0:
                    break
                kids, n = np.unique(cur[:, 1], return_counts=True)
                merging = kids[n > 1]
                if len(merging) == 0:
                    break
                batch = []
                for cid in merging:
                    cid = int(cid)
                    rows_idx = np.nonzero(cur[:, 1] == cid)[0]
                    rows = cur[rows_idx]
                    if len(rows) < 2:
                        continue
                    parents = rows[:, 0].astype(np.int64)
                    if len(parents) > MAX_PARENTS:
                        raise RuntimeError(f"child {cid} has {len(parents)} parents (limit {MAX_PARENTS})")
                    new_ids = np.arange(next_id, next_id + len(parents) - 1, dtype=np.int64)
                    next_id += len(parents) - 1
                    ids = np.concatenate([[cid], new_ids]).astype(np.int64)
                    cur[rows_idx[1:], 1] = new_ids
                    records["time"].append(self.times[t])
                    records["children"].append(ids)
                    records["parents"].append(parents)
                    records["areas"].append(rows[:, 2])
                    batch.append((cid, parents, ids))
                if batch:
                    self.partition(batch, t)
                invalidate(t)
        if T >= 2:
            back = self.linked(get(T - 2))
            if len(back):
                self.consolidate(back, T - 1)
        final = [x for x in pair_lists(self.labels, self.weights) if len(x)]
        if final:
            allp = np.concatenate(final)
            key = allp[:, 0].astype(np.int64) * np.int64(2**31) + allp[:, 1].astype(np.int64)
            uniq, inv = np.unique(key, return_inverse=True)
            sums = np.zeros(len(uniq))
            np.add.at(sums, inv, allp[:, 2])
            overlaps = self.linked(np.column_stack([uniq // 2**31, uniq % 2**31, sums]).astype(np.float64))
        else:
            overlaps = np.empty((0, 3))
        return {"labels": self.labels, "table": self.table, "records": records,
                "overlaps": overlaps[:, :2] if len(overlaps) else np.empty((0, 2))}


def run(state: dict) -> None:
    state["march"] = March(state).run()
