"""
Everything the harness runs, found by name.

``BENCHMARK.json`` (at the repository's root) names the cells, configurations,
traffic mixes and metrics; each lives in files of its own under this folder:

- ``cells/<cell>.json``: the configuration and mix of a cell, and the limit of
  each number its correctness check compares;
- ``configs/<config>.json``: a deployment (grid or mesh, block length, the
  tracker's settings) and the generator that makes its input;
- ``traffic/<mix>.json``: the user's job (detect method, tracking mode) and
  the reference pieces that check it;
- ``data/<generator>.py``: ``generate(config, seed, device)``;
- ``metrics/<metric>.py``: ``read(run) -> float | None``;
- ``reference/<piece>.py``: ``run(state)``, one stage of the plain reference.

A later cell, configuration, mix, metric or reference piece is added as new
files and entries, without editing any of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    """The workload ``name`` of ``BENCHMARK.json`` with its cell file, its
    configuration and its mix loaded. Raises ``KeyError`` for an unknown cell
    and ``ValueError`` when the cell file and ``BENCHMARK.json`` disagree."""
    entries = {w["name"]: w for w in benchmark()["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    spec = _json(HERE / "cells" / f"{name}.json")
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"cells/{name}.json has {key} {spec[key]!r}, BENCHMARK.json {entry[key]!r}")
    return {**entry, "limits": spec.get("limits", {}), "config_data": config(entry["config"]),
            "traffic_data": traffic(entry["traffic"])}


def generator(name: str) -> ModuleType:
    return importlib.import_module(f"bench_h100.data.{name}")


def reference_piece(name: str) -> ModuleType:
    return importlib.import_module(f"bench_h100.reference.{name}")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py`` (metric names hold dots,
    so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def peaks() -> dict:
    return _json(HERE / "peaks.json")
