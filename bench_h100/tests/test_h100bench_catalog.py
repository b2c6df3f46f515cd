"""BENCHMARK.json holds to the benchmark's contract, and everything it names
resolves by name to files under ``bench_h100/``."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from bench_h100 import catalog

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"] and BENCH["command"] == ["python3", "bench_h100/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = catalog.cell(cell)
    assert spec["chips"] == 1 and len(spec["why"]) <= 200
    catalog.generator(spec["config_data"]["generator"])
    for piece in spec["traffic_data"]["reference"]:
        assert callable(catalog.reference_piece(piece).run)
    assert all(v >= 0 for v in spec["limits"].values())


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = ROOT / config["file"]
    assert path.is_file() and path.parts[len(ROOT.parts)] == "bench_h100"
    data = json.loads(path.read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    assert set(config["reduced"]) <= set(data["assumed"]) and data["dtype"] == "float32"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_resolve(metric):
    read = catalog.metric_reader(metric)
    assert read({"paths": [], "traced_path": None, "trace": None, "hbm_bytes_per_s": None}) is None
