"""The port's tracer (``marex_tpu_torch.tracing``) on the CPU: spans nest and
keep their self time, counters count in both modes, tracing off leaves no
range, synchronise or allocator call behind and an empty ``stage_walls``,
outside ``collect()`` only the tracker's stages record (for the benchmark's
runner), own peaks fold into their parents (on a fake allocator), and a small
merge-tracking path gives the same outputs bit for bit with tracing on and
off."""

from __future__ import annotations

import json
import logging
import time

import numpy as np
import pandas as pd
import pytest
import torch

import marex_tpu_torch as port
from marex_tpu_torch import logging_config, tracing

PROGRAM_SPANS = {"detect", "detect/anomaly", "detect/threshold", "detect/compare", "track", "march", "ccl"}
#: spans that record only inside collect(): no tracker stage view holds them
COLLECT_ONLY = {"detect", "detect/anomaly", "detect/threshold", "detect/compare", "track", "track/preprocess",
                "march/threshold", "march/batch"}


@pytest.fixture
def tracing_off(monkeypatch):
    """Tracing off as it is once the tracker's stages record only inside
    ``collect()`` too."""
    monkeypatch.setattr(tracing, "_VIEWS", False)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sst(seed: int = 0, n_years: int = 3, ny: int = 24, nx: int = 48) -> port.Field:
    """Daily AR(1) SST with drifting warm blobs that meet: merges to track."""
    rng = np.random.default_rng(seed)
    T = 365 * n_years
    times = pd.date_range("2000-01-01", periods=T, freq="D").to_numpy()
    lat = np.linspace(-60, 60, ny)
    lon = np.linspace(0, 360, nx, endpoint=False)
    sst = 15 + rng.standard_normal((T, ny, nx)).astype(np.float32)
    for k in range(1, T):
        sst[k] = 0.7 * sst[k - 1] + 0.4 * sst[k]
    yy, xx = np.mgrid[0:ny, 0:nx]
    for k in range(T - 365, T):
        for c0 in (10, 30):
            cx = c0 + 8 * np.sin(2 * np.pi * k / 40.0)
            sst[k] += 4.0 * np.exp(-((yy - ny / 2) ** 2 + (xx - cx) ** 2) / 18.0)
    coords = {"time": times, "lat": lat, "lon": lon}
    return port.Field(sst, ("time", "lat", "lon"), coords, name="sst")


def _path(sst: port.Field):
    """The merge cell's job at a small size: a fixed baseline, a global
    threshold, then merge tracking with nearest-cell partitioning."""
    ds = port.preprocess_data(sst, method_anomaly="fixed_baseline", method_extreme="global_extreme",
                              threshold_percentile=90, device="cpu", quiet=True)
    tr = port.tracker(ds.extreme_events, ds.mask, R_fill=2, T_fill=2, area_filter_absolute=8,
                      allow_merging=True, nn_partitioning=True, overlap_threshold=0.25, device="cpu", quiet=True)
    events, merges = tr.run(return_merges=True)
    return ds, events, merges, tr


@pytest.fixture(scope="module")
def sst():
    return _sst()


@pytest.fixture(scope="module")
def sst_short():
    """Two years: a path short enough to profile op by op on the CPU."""
    return _sst(n_years=2)


def test_spans_nest_and_keep_their_self_time():
    with tracing.collect() as rec:
        with tracing.span("outer"):
            time.sleep(0.02)
            for _ in range(2):
                with tracing.span("outer/inner"):
                    time.sleep(0.01)
        with tracing.span("other"):
            pass
    outer, inner = rec.spans["outer"], rec.spans["outer/inner"]
    assert (outer.parent, inner.parent, rec.spans["other"].parent) == (None, "outer", None)
    assert (outer.calls, inner.calls) == (1, 2)
    assert inner.wall_ns >= 2 * 10_000_000 and outer.self_ns >= 20_000_000
    assert outer.self_ns == outer.wall_ns - inner.wall_ns
    assert inner.self_ns == inner.wall_ns
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    summary = rec.summary()
    json.dumps(summary)
    assert summary["spans"]["outer/inner"]["calls"] == 2 and summary["peak_bytes"] is None  # no allocator on the CPU
    assert "host_syncs" not in rec.counters


def test_a_block_inside_a_span_leaves_its_spans_to_the_span():
    with tracing.span("outer", walls={}) as outer:  # a tracker stage: it records outside a block
        with tracing.collect() as rec:
            with tracing.span("inner"):
                time.sleep(0.005)
        assert outer.child_ns == rec.spans["inner"].wall_ns
    assert rec.spans["inner"].parent is None


def test_counters_count_in_both_modes(sst, tracing_off):
    assert not tracing.enabled()
    with tracing.collect() as rec:
        tracing.count("x", 3)
        tracing.count("x")
    tracing.count("x", 5)  # no record open: nowhere to go
    assert rec.counters["x"] == 4
    *_, tr = _path(sst)
    assert tr.stage_walls == {} and tr.stage_peak_bytes == {}
    assert tr.dispatch_counts["partition"] > 0 and "filter/ccl_fixpoint" in tr.ccl_iterations
    with tracing.collect() as rec:
        *_, tr = _path(sst)
    assert not tracing.enabled()  # the block's switch is undone
    for kind, n in tr.dispatch_counts.items():
        assert rec.counters[f"march/dispatch/{kind}"] == n
    for stage, n in tr.ccl_iterations.items():
        assert rec.counters[f"ccl/iterations/{stage}"] == n
    assert {"march", "march/partition"} <= set(tr.stage_walls)
    assert {"march/threshold", "march/batch"} <= set(rec.spans)


def test_tracing_off_makes_no_range_synchronise_or_allocator_call(sst_short, tracing_off, monkeypatch):
    calls = []
    for name in ("synchronize", "max_memory_allocated", "reset_peak_memory_stats", "memory_stats_as_nested_dict"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _n=name, **k: calls.append(_n))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)  # as if the path ran beside a card
    real_range = torch.profiler.record_function
    program_ranges = []

    def spy_range(name, *a, **k):
        program_ranges.append(name)
        return real_range(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy_range)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        *_, tr = _path(sst_short)
    assert calls == [] and program_ranges == [] and tr.stage_walls == {}
    assert not PROGRAM_SPANS & {e.name for e in prof.events()}


def test_tracing_on_puts_the_spans_in_a_profile(sst_short):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.collect():
            *_, tr = _path(sst_short)
    assert PROGRAM_SPANS <= {e.name for e in prof.events()}
    assert {"ccl", "march", "march/partition", "rename"} <= set(tr.stage_walls)


def test_outside_collect_only_the_tracker_stages_record(sst_short, monkeypatch):
    calls = []
    for name in ("max_memory_allocated", "reset_peak_memory_stats", "memory_stats_as_nested_dict",
                 "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _n=name, **k: calls.append(_n))
    assert not tracing.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        *_, tr = _path(sst_short)
    names = {e.name for e in prof.events()}
    assert {"ccl", "march", "march/partition"} <= names and not COLLECT_ONLY & names
    assert {"ccl", "march", "march/partition", "rename"} <= set(tr.stage_walls)
    assert calls == [] and tr.stage_peak_bytes == {}


class _FakeAllocator:
    """Allocated bytes and a resettable peak, as the CUDA caching allocator
    keeps them."""

    def __init__(self, peak: int):
        self.current, self.peak = 0, peak

    def alloc(self, n: int) -> None:
        self.current += n
        self.peak = max(self.peak, self.current)

    def free(self, n: int) -> None:
        self.current -= n

    def reset(self, *a, **k) -> None:
        self.peak = self.current

    def stats(self, *a, **k):
        return {"allocated_bytes": {"all": {"peak": self.peak, "current": self.current}}}


@pytest.fixture
def fake_card(monkeypatch):
    mem = _FakeAllocator(peak=1000)  # the process's peak before the block
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", mem.stats)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: mem.peak)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", mem.reset)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    return mem


def test_own_peaks_fold_into_their_parents(fake_card):
    mem, peaks = fake_card, {}
    with tracing.collect() as rec:
        mem.alloc(100)
        with tracing.span("a", peaks=peaks):
            mem.alloc(50)  # 150
            with tracing.span("a/b", peaks=peaks):
                mem.alloc(200)  # 350: the block's peak
                mem.free(200)
            mem.free(50)
            with tracing.span("a/c", peaks=peaks):
                mem.alloc(20)  # 120
                mem.free(20)
        with tracing.span("d", peaks=peaks):
            mem.alloc(10)  # 110
            mem.free(10)
    own = {n: s.peak_bytes for n, s in rec.spans.items()}
    assert own == {"a": 350, "a/b": 350, "a/c": 120, "d": 110} == peaks
    assert rec.peak_bytes == 350  # the block's, not the 1000 before it


def test_own_peak_of_a_stage_is_not_the_peak_so_far(fake_card):
    mem = fake_card
    with tracing.collect() as rec:
        with tracing.span("first"):
            mem.alloc(500)
            mem.free(500)
        with tracing.span("second"):
            mem.alloc(10)
            mem.free(10)
    assert rec.spans["first"].peak_bytes == 500 and rec.spans["second"].peak_bytes == 10
    assert rec.peak_bytes == 500


def test_outputs_equal_with_tracing_on_and_off(sst):
    with tracing.collect() as rec:
        on = _path(sst)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracing, "_VIEWS", False)
        off = _path(sst)
    assert {"detect", "detect/anomaly", "detect/anomaly/climatology", "detect/threshold",
            "detect/threshold/digitize", "detect/threshold/quantile", "detect/compare", "track"} <= set(rec.spans)
    assert rec.spans["detect/threshold/quantile"].parent == "detect/threshold"
    assert rec.spans["march/batch"].parent == "march" and rec.spans["march/threshold"].calls > 0
    assert on[1].attrs["total_merges"] > 0
    for a, b in ((on[0], off[0]), (on[1], off[1]), (on[2], off[2])):
        assert set(a.data_vars) == set(b.data_vars)
        for k in a.data_vars:
            x, y = np.asarray(a[k].values), np.asarray(b[k].values)
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), k
    assert on[1].attrs == off[1].attrs and on[0].attrs == off[0].attrs


def test_log_timing_says_when_its_time_is_the_hosts(caplog, tracing_off):
    logger = logging.getLogger("tracing_test")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=logger.name):
            with logging_config.log_timing(logger, "off stage"):
                pass
            with tracing.collect() as rec:
                with logging_config.log_timing(logger, "on stage", span="stage/on"):
                    pass
    finally:
        logger.removeHandler(caplog.handler)
    lines = [r.getMessage() for r in caplog.records]
    assert any("off stage" in m and "host time" in m for m in lines)
    assert any("on stage" in m and "host time" not in m for m in lines)
    assert rec.spans["stage/on"].calls == 1


def test_profile_trace_carries_the_spans(tmp_path, sst):
    with logging_config.profile_trace(str(tmp_path)) as rec:
        port.preprocess_data(sst, method_anomaly="fixed_baseline", method_extreme="global_extreme",
                             threshold_percentile=90, device="cpu", quiet=True)
    assert "detect/threshold" in rec.spans
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert "detect/threshold" in names
