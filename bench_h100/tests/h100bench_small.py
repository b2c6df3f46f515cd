"""Small versions of the benchmark's cells, for the CPU tests: the same
configurations and mixes on a coarser grid (the tracker's radius and area
floor and the noise's smoothing scaled with it) or a smaller mesh. A cell
file that ``BENCHMARK.json`` does not list yet (``PARKED``) is read from its
files alone."""

from __future__ import annotations

import copy
import json

from bench_h100 import catalog

# cells with files of their own that BENCHMARK.json does not list (PERF.md says why)
PARKED = ["mesh-merge"]


def _spec(cell: str) -> dict:
    if cell not in PARKED:
        return catalog.cell(cell)
    data = json.loads((catalog.HERE / "cells" / f"{cell}.json").read_text())
    return {"name": cell, "config": data["config"], "traffic": data["traffic"], "chips": 1,
            "limits": data.get("limits", {}), "config_data": catalog.config(data["config"]),
            "traffic_data": catalog.traffic(data["traffic"])}


def small_spec(cell: str, ny: int = 24, nx: int = 48, n_cells: int = 4096) -> dict:
    spec = _spec(cell)
    cfg = copy.deepcopy(spec["config_data"])
    if "grid" in cfg:
        cfg["grid"].update(ny=ny, nx=nx)
        s = ny / 720
        cfg["tracker"].update(R_fill=max(round(12 * s), 2), area_filter_absolute=max(round(600 * s * s), 8),
                              grid_resolution=round(180 / ny, 4))
        if cfg.get("noise_smooth"):
            cfg["noise_smooth"] = max(round(cfg["noise_smooth"] * s), 1)
    else:
        cfg["mesh"]["n_cells"] = n_cells
    spec["config_data"] = cfg
    return spec
