"""On the card, at a size a test run holds: each mix's reference agrees with
the port's CUDA path, and the control (the reference in bfloat16 in the
program's place) fails the check."""

from __future__ import annotations

import pytest
import torch

from bench_h100 import catalog, compare, control
from bench_h100.run import prepare_program, run_cell
from h100bench_small import PARKED, small_spec

# the cells BENCHMARK.json lists report per-layer metrics; a parked cell lists none yet
LISTED = [w["name"] for w in catalog.benchmark()["workloads"]]
CELLS = LISTED + PARKED


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prepare_program("cuda")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_card(card, cell):
    spec = small_spec(cell, ny=180, nx=360, n_cells=32768)
    r = control.readings(spec, 2**33 + 1, card)
    assert all(v == 0 for v in r["program"].values()), r["program"]
    assert not compare.passed(compare.judge(r["control"], spec["limits"]))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", LISTED)
def test_traced_run_on_card(card, cell):
    result, _ = run_cell(small_spec(cell, ny=180, nx=360, n_cells=32768), 17, 1.0, True, device=card)
    assert result["correct"] is True, result["checks"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert "device.idle_pct" in result["metrics"] and "kernel.label_roofline_pct" in result["metrics"]
    assert "detect.wall_s" in result["metrics"] and "track.preprocess_s" in result["metrics"]  # from the untraced path
    assert result["metrics"]["kernel.label_roofline_pct"]["value"] <= 105
