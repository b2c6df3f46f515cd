"""The correctness check on the CPU at a small size: each mix's plain
reference agrees with ``marex_tpu_torch``, and the check fails for the
control (the reference computed in bfloat16 in the program's place) and for
a run with the timed path broken underneath."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_h100 import catalog, compare, control, faults
from bench_h100.run import run_cell, run_reference
from h100bench_small import PARKED, small_spec

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]] + PARKED
SEED = 2**34 + 11


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_program_equals_reference_and_control_fails(cell):
    r = control.readings(small_spec(cell), SEED, "cpu")
    assert all(v == 0 for v in r["program"].values()), r["program"]
    limits = small_spec(cell)["limits"]
    assert not compare.passed(compare.judge(r["control"], limits))
    assert r["control"]["extreme_events.cells"] > 0 and r["control"]["ID_field.cells"] > 0


def test_mesh_reference_covers_merges():
    """A mesh large enough for merges: the march and the merge records agree too."""
    spec = small_spec("mesh-merge", n_cells=32768)
    r = control.readings(spec, 5, "cpu", control=False)
    assert all(v == 0 for v in r["program"].values()), r["program"]
    assert "merges.parent_IDs.cells" in r["program"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault):
    from marex_tpu_torch.exceptions import MarExError

    with faults.FAULTS[fault]():
        try:
            result, _ = run_cell(small_spec(cell), SEED, 0.0, False, device="cpu")
        except MarExError:  # the broken program stops in set-up: the run exits without a result
            return
    assert result["correct"] is False and result["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_labelling_has_components_to_join(cell):
    """The field each cell tracks breaks into many events, so that a
    labelling that joins two of its components shows in the comparison."""
    spec = small_spec(cell)
    cfg = spec["config_data"]
    want = run_reference(spec, catalog.generator(cfg["generator"]).generate(cfg, SEED, "cpu"), "cpu")
    assert want["attrs"]["N_events_final"] >= 10
    r = control.readings(spec, SEED, "cpu", control=False, faults=["join_two"])
    assert all(v == 0 for v in r["program"].values())
    assert not compare.passed(compare.judge(r["fault:join_two"], spec["limits"]))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, lines = run_cell(small_spec(cell), SEED, 0.0, False, device="cpu")
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks" and result["failed"] == 0
    assert set(result["metrics"]) == {"mcell_days_per_s", "peak_mem_gib", "setup_s"}


def test_traced_window_runs_an_untraced_path():
    """A traced window runs past its first path however short it is, so the
    walls have a path the profiler did not slow."""
    result, lines = run_cell(small_spec("grid-hobday"), SEED, 0.0, True, device="cpu")
    assert result["correct"] is True and result["attempted"] == 2
    assert "detect.wall_s" in result["metrics"] and "track.preprocess_s" in result["metrics"]
