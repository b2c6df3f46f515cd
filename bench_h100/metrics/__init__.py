"""
Per-layer metrics, one reader a file: ``metrics/<name>.py`` holds
``read(run) -> float | None``, where ``run`` is what a ``--trace 1`` run
gathered:

- ``run["paths"]``: one dict a whole path of the window that ran without
  the profiler (every path but the first), with ``detect_s`` and
  ``track_s`` (host clock around work that ends in a synchronise),
  ``stage_walls`` (the tracker's own ``stage_walls``) and
  ``labelled_cells`` (time steps times cells of the tracked field);
- ``run["traced_path"]``: the same dict for the window's first path, the one
  the profiler traced, or None;
- ``run["trace"]``: that path's profiler trace (``bench_h100.trace.Trace``),
  or None;
- ``run["hbm_bytes_per_s"]``: the card's published memory bandwidth from
  ``peaks.json``, or None for a card that is not in it.

A reader that finds nothing to read returns None, and the metric is left
out of the result.
"""

from __future__ import annotations

from typing import Optional, Sequence


def stage_mean(run: dict, stages: Sequence[str]) -> Optional[float]:
    """Seconds per path in the tracker stages ``stages`` (summed), or None
    when no path ran any of them."""
    paths = run["paths"]
    if not paths or not any(s in p["stage_walls"] for p in paths for s in stages):
        return None
    return sum(p["stage_walls"].get(s, 0.0) for p in paths for s in stages) / len(paths)
