"""
Reading a ``torch.profiler`` trace of the window: the device's busy time, the
idle gaps and the host range each fell in, the device operations that took
the most time, and the device time of the work launched inside named host
ranges (the tracker's stages are ``torch.profiler`` ranges of their names).

The trace is the profiler's Chrome-trace export: host ranges are
``user_annotation`` events, device work is ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events, and a launch (``cuda_runtime`` or ``cuda_driver``)
shares its ``correlation`` id with the device work it started.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PATH_RANGE = "bench/path"
_TOP = 10


def _merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _innermost_timeline(ranges: Sequence[Tuple[float, float, str]]) -> Tuple[List[float], List[str]]:
    """Segments (starts, names) of the innermost open host range over time
    ("" where none is open); ranges of one thread nest."""
    bounds = []
    for a, b, name in ranges:
        bounds.append((a, 1, -(b - a), name))
        bounds.append((b, 0, 0.0, name))
    bounds.sort()
    starts, names, stack = [], [], []
    for t, is_open, _, name in bounds:
        if is_open:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
        starts.append(t)
        names.append(stack[-1] if stack else "")
    return starts, names


class Trace:
    """The parts of an exported trace the metrics read."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.device: List[Tuple[float, float, str, int]] = []  # start, end (us), name, correlation
        self.launches: List[Tuple[float, int]] = []  # host time of a launch, correlation
        self.ranges: List[Tuple[float, float, str]] = []  # host ranges: start, end, name
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation", -1)
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", ""), corr))
            elif cat in LAUNCH_CATS:
                self.launches.append((ts, corr))
            elif cat == "user_annotation":
                self.ranges.append((ts, ts + dur, e.get("name", "")))
        self.launches.sort()
        self.device.sort()
        paths = [(a, b) for a, b, n in self.ranges if n == PATH_RANGE]
        self.window = (min(a for a, _ in paths), max(b for _, b in paths)) if paths else None

    def _in_window(self) -> List[Tuple[float, float, str, int]]:
        a, b = self.window
        return [(max(s, a), min(e, b), n, c) for s, e, n, c in self.device if e > a and s < b]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(b - a for a, b in _merge((s, e) for s, e, _, _ in self._in_window())) / 1e6

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def top_device_ops(self) -> List[List]:
        """The device operations that took the most time in the window, as
        [name, seconds]."""
        by_name: Dict[str, float] = defaultdict(float)
        for s, e, n, _ in self._in_window():
            by_name[n[:160]] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]]

    def idle_gaps(self) -> List[List]:
        """Idle device time in the window, split over the innermost host
        range open at each moment, as [range, seconds], longest first."""
        busy = _merge((s, e) for s, e, _, _ in self._in_window())
        a, b = self.window
        edges = [a] + [x for iv in busy for x in iv] + [b]
        starts, names = _innermost_timeline(self.ranges)
        starts.append(float("inf"))
        by_name: Dict[str, float] = defaultdict(float)
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            i = max(bisect.bisect_right(starts, g0) - 1, 0)
            while g0 < g1:
                end = min(g1, starts[i + 1])
                by_name[names[i] or "(outside every range)"] += (end - g0) / 1e6
                g0, i = end, i + 1
        return [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]]

    def range_device_s(self, names: Sequence[str]) -> Dict[str, List[float]]:
        """For each host range of these names, each instance's device seconds:
        the work its launches started, wherever it ran."""
        per_corr: Dict[int, float] = defaultdict(float)
        for s, e, _, c in self.device:
            per_corr[c] += (e - s) / 1e6
        times = [t for t, _ in self.launches]
        out: Dict[str, List[float]] = {n: [] for n in names}
        for a, b, n in self.ranges:
            if n not in out:
                continue
            i, j = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
            out[n].append(sum(per_corr.get(c, 0.0) for _, c in self.launches[i:j]))
        return out
