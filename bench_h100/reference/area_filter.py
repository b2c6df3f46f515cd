"""
Reference area filter, with upstream marEx's rules:

- on a grid, the objects are the 8-connected components of each slice
  (periodic in longitude), in slice order and by smallest flat index within
  a slice; an object is kept when its cell count reaches the threshold
  (``area_filter_absolute``, or the ``area_filter_quartile`` percentile of
  all object areas), and the first object of the record is always dropped
  (upstream marks ``object_ids_keep[0] = -1`` to skip the background, which
  is not in that list, so its first real object goes);
- on a mesh, the objects are the components of (extremes and ocean) along
  the symmetrised neighbour table, objects of 50 cells or fewer (5 with an
  absolute threshold) are left out of the percentile and the statistics, and
  an object is kept when its count is above the threshold.

Writes ``state["filtered"]`` and the tracker's statistics in
``state["attrs"]``.
"""

from __future__ import annotations

import numpy as np
import torch

from .fill import active_area
from .label import label_slices, symmetrised

# time steps of one block of the per-label bookkeeping
_STEPS = 64


def cells_per_label(ids: torch.Tensor, L: int) -> torch.Tensor:
    """(T, L + 1) int64 cells of each per-slice id (column 0: the background)."""
    T = ids.shape[0]
    out = torch.empty((T, L + 1), dtype=torch.int64, device=ids.device)
    for t0 in range(0, T, _STEPS):
        rows = ids[t0 : t0 + _STEPS].reshape(min(_STEPS, T - t0), -1).long()
        rows = rows + torch.arange(rows.shape[0], device=ids.device)[:, None] * (L + 1)
        out[t0 : t0 + _STEPS] = torch.bincount(rows.reshape(-1), minlength=rows.shape[0] * (L + 1)).view(-1, L + 1)
    return out


def per_cell(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[t, ids[t, ...]]`` for every cell, a block of slices at a time."""
    T = ids.shape[0]
    out = torch.empty(ids.shape, dtype=table.dtype, device=ids.device)
    for t0 in range(0, T, _STEPS):
        rows = ids[t0 : t0 + _STEPS].reshape(min(_STEPS, T - t0), -1).long()
        out[t0 : t0 + _STEPS] = torch.gather(table[t0 : t0 + _STEPS], 1, rows).view(out[t0 : t0 + _STEPS].shape)
    return out


def run(state: dict) -> None:
    kw = {**state["config"]["tracker"], **state["mix"]["tracker"]}
    data = state.pop("filled")
    quartile = kw.get("area_filter_quartile")
    absolute = kw.get("area_filter_absolute")
    if quartile is None and absolute is None:
        quartile = 0.5
    T = data.shape[0]
    if kw.get("unstructured_grid"):
        nb = np.asarray(state["inputs"]["neighbours"], dtype=np.int64) - 1
        table = torch.from_numpy(symmetrised(nb)).to(data.device)
        _, ids, counts = label_slices(data & state["mask"], table=table)
        counts = counts.cpu().numpy()
        L = int(counts.max())
        areas_tl = cells_per_label(ids, L).float().cpu().numpy()
        objects = areas_tl[:, 1:][np.arange(L)[None, :] < counts[:, None]]
        objects = objects[objects > (5 if absolute is not None else 50)]
        thr = float(absolute) if absolute is not None else float(np.percentile(objects, quartile * 100))
        keep = torch.from_numpy(areas_tl > thr).to(data.device)
        keep[:, 0] = False
        filtered = per_cell(keep, ids)
        n_pre, n_post = int(objects.size), int(np.sum(objects > thr))
    else:
        _, ids, counts = label_slices(data, wrap=True)
        counts = counts.cpu().numpy()
        L = int(counts.max())
        cells = cells_per_label(ids, L).float()
        areas_tl = cells[:, 1:].cpu().numpy()
        objects = areas_tl[np.arange(L)[None, :] < counts[:, None]]  # slice order, then by root
        thr = float(absolute) if absolute is not None else float(np.percentile(objects, quartile * 100))
        n_pre = int(objects.size)
        n_post = int(np.sum(objects >= thr)) - int(objects[0] >= thr)
        keep = cells >= torch.tensor(thr, dtype=torch.float32, device=data.device)
        keep[:, 0] = False
        filtered = per_cell(keep, ids)
        t_first = int(np.argmax(counts > 0))
        filtered[t_first] &= ids[t_first] != 1
    state["filtered"] = filtered.view(data.shape)
    processed = active_area(state["filtered"], state["cell_area"])
    total = float(objects.sum())
    accepted = float(objects[objects > thr].sum())
    raw, proc = float(state.pop("raw_area").sum()), float(processed.sum())
    state["attrs"] = {"N_objects_prefiltered": n_pre, "N_objects_filtered": n_post, "area_threshold (cells)": thr,
                      "accepted_area_fraction": accepted / total if total else 0.0,
                      "preprocessed_area_fraction": raw / proc if proc else 0.0}
