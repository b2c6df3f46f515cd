"""
The comparison that decides ``correct``: the outputs of the window's last
path against the plain reference's, as numbers, each held against its limit
from the cell's file (``cells/<cell>.json``, ``limits``; an exact comparison
has the limit 0).

- ``*.cells``: how many elements differ (bit for bit; NaN equals NaN);
- ``*.max_abs`` / ``*.max_rel`` / ``*.max_gap``: the largest absolute gap,
  gap relative to the reference, or gap over ``max(|reference|, 1)``, where
  both are finite; ``inf`` where the NaN patterns or the shapes differ;
- ``*.diff``: the gap between two counts;
- ``attrs.differ``: how many of the tracker's statistics differ.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

_CHUNK = 1 << 26
INF = float("inf")

# the tracker's statistics compared exactly (``N_events_final`` and
# ``total_merges`` have numbers of their own)
ATTRS = ("N_objects_prefiltered", "N_objects_filtered", "area_threshold (cells)", "accepted_area_fraction",
         "preprocessed_area_fraction", "multi_parent_merges")


def _as_tensor(x: Any, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.dtype.kind == "M":
        a = a.astype("datetime64[ns]").view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def cells_differ(a: Any, b: Any, device) -> float:
    """Elements that differ (NaN equals NaN); every element when the shapes differ."""
    a, b = _as_tensor(a, device), _as_tensor(b, device)
    if a.shape != b.shape:
        return float(max(a.numel(), b.numel(), 1))
    fa, fb = a.reshape(-1), b.reshape(-1)
    n = 0
    for i in range(0, fa.numel(), _CHUNK):
        x, y = fa[i : i + _CHUNK], fb[i : i + _CHUNK]
        ne = x != y
        if x.dtype.is_floating_point:
            ne &= ~(torch.isnan(x) & torch.isnan(y))
        n += int(ne.sum())
    return float(n)


def max_gap(a: Any, b: Any, device, scale_floor: float = 0.0) -> float:
    """The largest gap where both are finite, over ``max(|b|, scale_floor)``
    when ``scale_floor`` is given (absolute when it is 0); inf where the
    shapes or the NaN patterns differ."""
    a, b = _as_tensor(a, device), _as_tensor(b, device)
    if a.shape != b.shape:
        return INF
    fa, fb = a.reshape(-1), b.reshape(-1)
    worst = 0.0
    for i in range(0, fa.numel(), _CHUNK):
        x, y = fa[i : i + _CHUNK].double(), fb[i : i + _CHUNK].double()
        if bool((torch.isnan(x) != torch.isnan(y)).any()):
            return INF
        fin = torch.isfinite(x) & torch.isfinite(y)
        if bool(((x != y) & ~fin & ~torch.isnan(x)).any()):
            return INF  # an infinity on one side only
        d = (x - y).abs()[fin]
        if scale_floor:
            d = d / y.abs()[fin].clamp_min(scale_floor)
        if d.numel():
            worst = max(worst, float(d.max()))
    return worst


def numbers(got: Dict[str, Any], want: Dict[str, Any], device) -> Dict[str, float]:
    """Every number the cell compares, from the program's outputs ``got``
    (:func:`bench_h100.job.outputs`) and the reference's ``want`` (the same
    keys). Keys present on one side only count as wholly different."""
    out: Dict[str, float] = {}
    for k in sorted(set(got) | set(want)):
        if k == "attrs":
            continue
        name = k.replace("events.", "")
        if k not in got or k not in want:
            out[f"{name}.cells"] = INF
        elif k in ("dat_anomaly", "thresholds"):
            out[f"{name}.max_abs"] = max_gap(got[k], want[k], device)
        elif k == "events.centroid":  # degrees: absolute below 1, relative above
            out[f"{name}.max_gap"] = max_gap(got[k], want[k], device, scale_floor=1.0)
        elif k == "events.area":
            out[f"{name}.max_rel"] = max_gap(got[k], want[k], device, scale_floor=1e-30)
        else:
            out[f"{name}.cells"] = cells_differ(got[k], want[k], device)
    ga, wa = got.get("attrs", {}), want.get("attrs", {})
    for k in ("N_events_final", "total_merges"):
        if k in ga or k in wa:
            out[f"{k}.diff"] = abs(float(ga.get(k, INF)) - float(wa.get(k, -INF)))
    out["attrs.differ"] = float(sum(ga.get(k) != wa.get(k) for k in ATTRS if k in ga or k in wa))
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, Optional[float]]]:
    """Each number beside its limit (0 where the cell states none)."""
    return {k: {"value": v, "limit": float(limits.get(k, 0.0))} for k, v in nums.items()}


def passed(checks: Dict[str, Dict[str, Optional[float]]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
