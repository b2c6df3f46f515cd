"""
Reference event clustering and event statistics, as upstream marEx's
``cluster_and_rename_objects`` and ``run_stats_attributes`` give them:

- the events are the connected components of the overlap graph over every
  object id (those in the field and those in the graph), numbered in order
  of each component's smallest object id;
- ``ID_field`` holds each cell's event; ``global_ID`` (time, ID) the largest
  object id of the event at that time; ``presence`` where that is set;
  ``time_start`` and ``time_end`` the first and last time present;
- ``area`` and ``centroid`` per (time, event): on a grid the physical cell
  areas from the grid resolution (the cell area times ``(sum y w,
  sum x w) / sum w``, periodic in longitude, turned into degrees by linear
  interpolation of the coordinates), on a mesh the summed cell areas and the
  spherical centroid; NaN where the event is absent, longitudes made
  positive when the input's run 0..360;
- ``merge_ledger`` (time, ID, sibling): each merging parent's own event id
  over its sibling slots at the time of the merge, -1 elsewhere;
- the merge records: parent and child ids, overlap areas (truncated to
  integers), time, and the parent and child counts.

Reads ``state["march"]``; writes the events, the merge records and the
attributes into ``state["out"]``.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from .march import EDGE_ZONE, MAX_PARENTS, centroids, mesh_label_props, mesh_weights

_STEPS = 64


def components(edges: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Component of each node (ascending ``nodes``) of the graph of
    ``edges``, numbered in order of each component's first node."""
    pos = np.searchsorted(nodes, edges.astype(np.int64)).reshape(-1, 2) if len(edges) else np.zeros((0, 2), np.int64)
    n = len(nodes)
    g = coo_matrix((np.ones(len(pos)), (pos[:, 0], pos[:, 1])), shape=(n, n))
    _, comp = connected_components(g, directed=False)
    # scipy numbers components in order of their first node too; make sure of it
    first = np.full(comp.max() + 1 if n else 0, n, np.int64)
    np.minimum.at(first, comp, np.arange(n))
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[comp]


def interp(pix: torch.Tensor, values: np.ndarray) -> torch.Tensor:
    """``np.interp(pix, arange(n), values)`` in float32, the product and sum
    rounded once (from float64)."""
    fp = torch.from_numpy(np.asarray(values, dtype=np.float32)).to(pix.device)
    n = fp.shape[0]
    xp = torch.arange(n, dtype=torch.float32, device=pix.device)
    x = pix.to(torch.float32)
    i = torch.searchsorted(xp, x.reshape(-1), right=True).clamp(1, n - 1).view(x.shape)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    tiny = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    q = delta / torch.where(tiny, 1.0, dx)
    f = torch.where(tiny, fp[i - 1], (fp[i - 1].double() + q.double() * df.double()).float())
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def grid_event_stats(ids: torch.Tensor, n: int, lat: np.ndarray, lon: np.ndarray, resolution: float):
    """(area, lat, lon) per (time, event) on a grid, weighted by the cell areas."""
    T, H, W = ids.shape
    dev = ids.device
    r = np.radians(lat)
    d = np.radians(resolution)
    cell = (6378.0**2 * np.abs(np.sin(r + d / 2) - np.sin(r - d / 2)) * d).astype(np.float32)
    w = torch.from_numpy(np.broadcast_to(cell[:, None], (H, W)).astype(np.float32).copy()).to(dev).reshape(-1)
    y = torch.arange(H, device=dev).repeat_interleave(W)
    x = torch.arange(W, device=dev).repeat(H)
    weights = {"area": w.double(), "y": (w * y.float()).double(), "x": (w * x.float()).double(),
               "right": (w * (x > W / 2).float()).double()}
    nb = n + 1
    sums = {k: torch.zeros((T, nb), dtype=torch.float64, device=dev) for k in weights}
    edge = {k: torch.zeros((T, nb), dtype=torch.int64, device=dev) for k in ("l", "r")}
    for t0 in range(0, T, _STEPS):
        rows = ids[t0 : t0 + _STEPS].reshape(-1, H * W).long()
        m = rows.shape[0]
        b = rows + torch.arange(m, device=dev)[:, None] * nb
        for k, wk in weights.items():
            sums[k][t0 : t0 + m] = torch.bincount(b.reshape(-1), weights=wk.repeat(m), minlength=m * nb).view(m, nb)
        edge["l"][t0 : t0 + m] = torch.bincount(b[:, x < EDGE_ZONE].reshape(-1), minlength=m * nb).view(m, nb)
        edge["r"][t0 : t0 + m] = torch.bincount(b[:, x >= W - EDGE_ZONE].reshape(-1), minlength=m * nb).view(m, nb)
    wrapped = (edge["l"] > 0) & (edge["r"] > 0)
    area, cy, cx = centroids(*(sums[k].float() for k in ("area", "y", "x", "right")), wrapped, W)
    present = area > 0
    nan = torch.tensor(float("nan"), device=dev)
    clat = torch.where(present, interp(torch.where(present, cy, nan), lat), nan)
    clon = torch.where(present, interp(torch.where(present, cx, nan), lon), nan)
    return torch.where(present, area, nan), clat, clon


def run(state: dict) -> None:
    m, out = state["march"], state["out"]
    cfg = state["config"]
    kw = {**cfg["tracker"], **state["mix"]["tracker"]}
    labels, table, overlaps, rec = m["labels"], m["table"], m["overlaps"], m["records"]
    times = np.asarray(state["times"])
    T = labels.shape[0]
    dev = labels.device

    field_ids = np.array(sorted(table), dtype=np.int64)
    if len(overlaps):
        ov = np.unique(overlaps.astype(np.int64))
        nodes = np.unique(np.concatenate([field_ids, ov[ov > 0]]))
    else:
        nodes = field_ids
    comp = components(overlaps, nodes)
    n = int(comp.max()) + 1 if len(comp) else 0
    max_id = max(int(labels.max()), int(nodes.max()) if len(nodes) else 0)
    lookup = np.zeros(max_id + 2, dtype=np.int32)
    lookup[nodes] = comp.astype(np.int32) + 1
    lk = torch.from_numpy(lookup).to(dev)

    flat = labels.reshape(T, -1)
    gid = torch.zeros((T, n + 2), dtype=torch.int32, device=dev)
    ids = torch.empty_like(flat)
    for t0 in range(0, T, _STEPS):
        rows = flat[t0 : t0 + _STEPS]
        new = lk[rows.long()]
        ids[t0 : t0 + _STEPS] = new
        col = torch.where(new > 0, new, n + 1).long() + torch.arange(rows.shape[0], device=dev)[:, None] * (n + 2)
        gid[t0 : t0 + _STEPS].view(-1).scatter_reduce_(0, col.view(-1), rows.reshape(-1), "amax", include_self=True)
    gid = gid[:, : n + 1]
    ids = ids.view(labels.shape)
    presence = gid > 0
    first = torch.argmax(presence.byte(), dim=0).cpu().numpy()
    last = T - 1 - torch.argmax(presence.flip(0).byte(), dim=0).cpu().numpy()

    coords = state["inputs"]["coords"]
    if kw.get("unstructured_grid"):
        lat, lon = np.asarray(coords["lat"][1], np.float64), np.asarray(coords["lon"][1], np.float64)
        wall = mesh_weights(lat, lon, np.asarray(state["inputs"]["cell_areas"], np.float32), dev)
        area, clat, clon = mesh_label_props(ids, wall, n)
        area = torch.where(area > 0, area, torch.tensor(float("nan"), device=dev))
    else:
        lat, lon = np.asarray(coords["lat"], np.float64), np.asarray(coords["lon"], np.float64)
        area, clat, clon = grid_event_stats(ids, n, lat, lon, float(kw["grid_resolution"]))
    if lon.min() >= 0 and lon.max() > 180:
        clon = torch.where(clon < 0, clon + 360, clon)

    n_merges = len(rec["parents"])
    width_p = max((len(p) for p in rec["parents"]), default=1)
    width_c = max((len(c) for c in rec["children"]), default=1)
    parents = np.full((n_merges, width_p), -1, np.int32)
    children = np.full((n_merges, width_c), -1, np.int32)
    areas = np.full((n_merges, width_p), -1, np.int64)
    for i in range(n_merges):
        parents[i, : len(rec["parents"][i])] = rec["parents"][i]
        children[i, : len(rec["children"][i])] = rec["children"][i]
        a = np.nan_to_num(np.asarray(rec["areas"][i], dtype=np.float64), nan=-1.0, posinf=-1.0, neginf=-1.0)
        areas[i, : len(a)] = a
    n_par = np.array([len(p) for p in rec["parents"]], np.int8)

    slots = width_p if n_merges else MAX_PARENTS
    ledger = np.full((T, n + 1, slots), -1, np.int32)
    t_index = {v: i for i, v in enumerate(times)}
    for i in range(n_merges):
        t = t_index.get(rec["time"][i])
        if t is None:
            continue
        old = parents[i][parents[i] > 0]
        new = lookup[np.clip(old, 0, max_id + 1)]
        for e in new[new > 0]:
            ledger[t, e, :] = e

    out.update({
        "events.ID_field": ids,
        "events.global_ID": gid[:, 1:],
        "events.area": area[:, 1:],
        "events.centroid": torch.stack([clat[:, 1:], clon[:, 1:]], dim=0),
        "events.presence": presence[:, 1:],
        "events.time_start": times[first][1:],
        "events.time_end": times[last][1:],
        "events.merge_ledger": ledger[:, 1:],
        "merges.parent_IDs": parents,
        "merges.child_IDs": children,
        "merges.overlap_areas": areas,
        "merges.merge_time": np.array(rec["time"]) if n_merges else np.array([], dtype="datetime64[ns]"),
        "merges.n_parents": n_par,
        "merges.n_children": np.array([len(c) for c in rec["children"]], np.int8),
    })
    out["attrs"] = {**state["attrs"], "N_events_final": n, "total_merges": n_merges,
                    "multi_parent_merges": int((n_par > 2).sum()) if n_merges else 0}
