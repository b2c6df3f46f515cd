"""The trace reader and the trace-based metrics on a small synthetic
``torch.profiler`` Chrome trace (times in microseconds)."""

from __future__ import annotations

import json

import pytest

from bench_h100 import catalog
from bench_h100.label_bytes import labelling_bytes
from bench_h100.trace import Trace


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def trace(tmp_path):
    events = [
        _x("user_annotation", "bench/path", 0, 1000),
        _x("user_annotation", "march", 100, 400),
        _x("user_annotation", "ccl", 600, 200),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 5, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 610, 5, 2),
        _x("cuda_driver", "cuLaunchKernel", 620, 5, 3),
        _x("kernel", "edt", 120, 200, 1),  # busy 120-320, launched in march
        _x("kernel", "step", 650, 50, 2),  # busy 650-700, launched in ccl
        _x("gpu_memset", "Memset", 690, 30, 3),  # busy 690-720, launched in ccl
        _x("kernel", "outside", 1500, 100, 9),  # after the window
        _x("cpu_op", "aten::add", 10, 1),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(str(path))


def test_busy_and_window(trace):
    assert trace.window_s() == pytest.approx(1000e-6)
    assert trace.busy_s() == pytest.approx(270e-6)


def test_device_time_by_launching_range(trace):
    got = trace.range_device_s(["ccl", "march", "ccl3d"])
    assert got["ccl"] == [pytest.approx(80e-6)] and got["march"] == [pytest.approx(200e-6)] and got["ccl3d"] == []


def test_idle_gaps_by_host_range(trace):
    gaps = dict(trace.idle_gaps())
    # idle: 0-100 (path), 100-120 and 320-500 (march), 500-600 (path), 600-650 and 720-800 (ccl), 800-1000 (path)
    assert gaps["bench/path"] == pytest.approx(400e-6)
    assert gaps["march"] == pytest.approx(200e-6)
    assert gaps["ccl"] == pytest.approx(130e-6)
    assert trace.top_device_ops()[0] == ["edt", pytest.approx(200e-6)]


def test_trace_metrics(trace):
    run = {"paths": [], "traced_path": {"labelled_cells": 1000, "stage_walls": {}}, "trace": trace,
           "hbm_bytes_per_s": 1e9}
    idle = catalog.metric_reader("device.idle_pct")(run)
    assert idle == pytest.approx(73.0)
    roof = catalog.metric_reader("kernel.label_roofline_pct")(run)
    assert roof == pytest.approx(100.0 * labelling_bytes(1000) / 1e9 / 80e-6)
    assert catalog.metric_reader("kernel.label_roofline_pct")({**run, "hbm_bytes_per_s": None}) is None


def test_stage_walls_per_path():
    run = {"paths": [{"stage_walls": {"march": 2.0, "march/partition": 1.0}, "detect_s": 0.5},
                     {"stage_walls": {"march": 4.0}, "detect_s": 1.5}], "trace": None, "hbm_bytes_per_s": None}
    assert catalog.metric_reader("track.march_s")(run) == pytest.approx(3.0)
    assert catalog.metric_reader("track.partition_s")(run) == pytest.approx(0.5)
    assert catalog.metric_reader("detect.wall_s")(run) == pytest.approx(1.0)
    assert catalog.metric_reader("track.rename_s")(run) is None


def test_walls_leave_out_the_traced_path():
    """The profiler slows the path it traces: the walls come from the others."""
    from bench_h100.run import per_layer

    records = [{"stage_walls": {"march": 9.0}, "detect_s": 9.0, "labelled_cells": 10},
               {"stage_walls": {"march": 2.0}, "detect_s": 1.0, "labelled_cells": 10},
               {"stage_walls": {"march": 4.0}, "detect_s": 3.0, "labelled_cells": 10}]
    metrics, _ = per_layer(catalog.cell("grid-merge"), catalog.benchmark(), records, None, "cpu")
    assert metrics["track.march_s"]["value"] == pytest.approx(3.0)
    assert metrics["detect.wall_s"]["value"] == pytest.approx(2.0)
