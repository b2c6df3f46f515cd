"""The per-layer metric that reads the port's tracing,
``track.ccl_iterations`` (the tracker's view of its iteration counters), on
hand-made inputs and in a traced CPU run of each listed cell, and a traced
run on the card reporting every per-layer metric a listed cell names."""

from __future__ import annotations

import json

import pytest
import torch

from bench_h100 import catalog
from bench_h100.run import prepare_program, run_cell
from h100bench_small import small_spec

LISTED = [w["name"] for w in catalog.benchmark()["workloads"]]


def _listed_metrics(cell: str) -> set:
    return {m["name"] for m in catalog.benchmark()["per_layer"] if cell in m.get("workloads", [cell])}


def test_ccl_iterations_reader_sums_each_path():
    read = catalog.metric_reader("track.ccl_iterations")
    run = {"paths": [{"ccl_iterations": {"filter/ccl_fixpoint": 12, "ccl": 0}},
                     {"ccl_iterations": {"filter/ccl_fixpoint": 10, "ccl3d": 4}}], "trace": None}
    assert read(run) == pytest.approx(13.0)
    assert read({"paths": [{"ccl_iterations": {}}], "trace": None}) is None


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", LISTED)
def test_traced_cpu_run_reports_the_tracing_metrics(cell, few_threads):
    result, lines = run_cell(small_spec(cell), 2**33 + 5, 0.0, True, device="cpu")
    assert result["correct"] is True, result["checks"]
    m = result["metrics"]
    iters = [json.loads(line.split("iterations ", 1)[1].split(", dispatches")[0].replace("'", '"'))
             for line in lines if line.startswith("path ") and "iterations" in line]
    assert m["track.ccl_iterations"]["value"] == pytest.approx(sum(sum(i.values()) for i in iters[1:]) / (len(iters) - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", LISTED)
def test_traced_run_on_card_reports_every_listed_metric(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prepare_program("cuda")
    result, _ = run_cell(small_spec(cell, ny=180, nx=360), 17, 1.0, True, device="cuda")
    assert result["correct"] is True, result["checks"]
    assert _listed_metrics(cell) <= set(result["metrics"]), sorted(_listed_metrics(cell) - set(result["metrics"]))
