"""
The port's tracer: spans, counters and one switch.

- :func:`span` ``(name)`` marks a step of the work. Spans nest (on each
  thread). Inside :func:`collect` (tracing on) a span is a
  ``torch.profiler`` range of its name (so a profile puts every device gap
  under the innermost program span), ends in a synchronise on CUDA (so its
  wall holds its own device work), adds its wall to the ``walls`` mapping it
  is given (the tracker's ``stage_walls``), and records its self time (its
  wall less its child spans'), its calls, its own peak of device memory and
  the device-to-host synchronisations made in it. Outside any
  :func:`collect` (tracing off) a span checks one flag and does nothing
  else: no range, no synchronise, no allocator call, no clock read.
- :func:`count` ``(name, n)`` counts workload size (labelling iterations, the
  march's device calls) into every open :func:`collect` record, whether
  tracing is on or off.
- :func:`collect` turns tracing on for its block and yields a
  :class:`Record` of every span and counter closed inside it.

One exception holds until the benchmark's runner (``bench_h100/run.py``)
opens :func:`collect` around its paths: a span given a ``walls`` view (the
tracker's stages) is, outside :func:`collect` too, a range that ends in a
synchronise and adds its wall to the view, as the tracker's stages always
were, because that runner reads ``stage_walls`` and the stages' ranges
without opening :func:`collect`. ``_VIEWS`` is that exception; the tests set
it False to see tracing off as it will then be.

A span's own peak: at its entry the allocator's peak so far is folded into
the enclosing span's running maximum and the peak counter is reset; at its
exit its own peak is the larger of its children's and the counter's, folded
into the enclosing span. The outermost frame, :func:`collect`'s, so still
holds the process's peak over the block (:attr:`Record.peak_bytes`). The
allocator's own counter (``torch.cuda.max_memory_allocated``) is left
counting only from the block's last span entry: a caller that wants the
process's peak over a run in which :func:`collect` blocks ran takes the
largest of its own reading before the first block, each block's
:attr:`Record.peak_bytes` and the counter after the last. Own peaks and
``host_syncs`` are read inside :func:`collect` only, and on CUDA only
(``torch.cuda`` initialised when the block opens). ``host_syncs`` counts the
synchronisations that ``torch.cuda.set_sync_debug_mode("warn")`` reports
(``.item()``, ``.cpu()``, ``.tolist()``, ``nonzero``, blocking copies);
the tracer's own synchronise at a span's end is not counted.
"""

from __future__ import annotations

import threading
import time
import warnings
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch

#: the message of the warning ``torch.cuda.set_sync_debug_mode("warn")`` gives
SYNC_WARNING = "called a synchronizing CUDA operation"

_NULL = nullcontext()


#: spans with a ``walls`` view record outside collect() too (see the module's docstring)
_VIEWS = True
#: the open collect() records: tracing is on while there is one
_records: List["Record"] = []
_peaks = False  # own peaks read (a collect() open on CUDA)
_own_sync = False  # inside the tracer's own synchronise
_local = threading.local()


@dataclass
class SpanStats:
    """One span name's totals in a :class:`Record`: ``parent`` is the
    enclosing span's name (None at the top), times are host nanoseconds
    (``time.perf_counter_ns``), ``peak_bytes`` the largest own peak of its
    calls (None off CUDA), ``host_syncs`` the synchronisations made in it
    and not in a child span."""

    parent: Optional[str]
    start_ns: int
    end_ns: int
    calls: int = 0
    wall_ns: int = 0
    self_ns: int = 0
    peak_bytes: Optional[int] = None
    host_syncs: int = 0


@dataclass
class Record:
    """What :func:`collect` gathered: spans by name, counters by name, and
    the block's peak of allocated device memory (None off CUDA)."""

    spans: Dict[str, SpanStats] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    peak_bytes: Optional[int] = None

    def summary(self) -> Dict[str, Any]:
        """The record as plain JSON types: ``spans`` (name -> ``wall_s``,
        ``self_s``, ``calls``, ``peak_bytes``, ``host_syncs``, ``parent``),
        ``counters`` and ``peak_bytes``."""
        spans = {
            n: {"wall_s": s.wall_ns / 1e9, "self_s": s.self_ns / 1e9, "calls": s.calls, "peak_bytes": s.peak_bytes,
                "host_syncs": s.host_syncs, "parent": s.parent}
            for n, s in self.spans.items()
        }
        return {"spans": spans, "counters": dict(self.counters), "peak_bytes": self.peak_bytes}

    def _add(self, frame: "_Frame", t1: int, wall: int, peak: Optional[int]) -> None:
        s = self.spans.get(frame.name)
        if s is None:
            parent = frame.parent.name if frame.parent is not None else None
            s = self.spans[frame.name] = SpanStats(parent, frame.t0, t1)
        s.end_ns = t1
        s.calls += 1
        s.wall_ns += wall
        s.self_ns += wall - frame.child_ns
        s.host_syncs += frame.syncs
        if peak is not None:
            s.peak_bytes = peak if s.peak_bytes is None else max(s.peak_bytes, peak)


def enabled() -> bool:
    """Whether tracing is on (a :func:`collect` block is open)."""
    return bool(_records)


def _stack() -> List["_Frame"]:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _peak_now() -> int:
    """The allocator's peak of allocated bytes since its last reset (the
    nested statistics: ``max_memory_allocated`` flattens them all first)."""
    return torch.cuda.memory_stats_as_nested_dict()["allocated_bytes"]["all"]["peak"]


class _Frame:
    """An open span (``name`` None: a :func:`collect` block)."""

    __slots__ = ("name", "device", "walls", "peaks", "parent", "t0", "child_ns", "peak", "syncs", "range")

    def __init__(self, name: Optional[str], device: Any = None, walls: Optional[Dict[str, float]] = None,
                 peaks: Optional[Dict[str, int]] = None):
        self.name, self.device, self.walls, self.peaks = name, device, walls, peaks
        self.child_ns = self.peak = self.syncs = 0
        self.range = None

    def _open(self) -> None:
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if _peaks:
            if self.parent is not None:
                self.parent.peak = max(self.parent.peak, _peak_now())
            torch.cuda.reset_peak_memory_stats()
        stack.append(self)
        self.t0 = time.perf_counter_ns()

    def _close(self) -> int:
        """Pop the frame; returns its wall in nanoseconds."""
        t1 = time.perf_counter_ns()
        _stack().pop()
        wall = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += wall
        peak = None
        if _peaks:
            peak = self.peak = max(self.peak, _peak_now())
            if parent is not None:
                parent.peak = max(parent.peak, peak)
        if self.walls is not None:
            self.walls[self.name] = self.walls.get(self.name, 0.0) + wall / 1e9
        if self.peaks is not None and peak is not None:
            self.peaks[self.name] = max(self.peaks.get(self.name, 0), peak)
        if self.name is not None:
            for r in _records:
                r._add(self, t1, wall, peak)
        return wall

    def _sync(self) -> None:
        global _own_sync
        dev = self.device
        if dev is None:
            if not torch.cuda.is_initialized():
                return
        elif (dev.type if isinstance(dev, torch.device) else torch.device(dev).type) != "cuda":
            return
        _own_sync = True
        try:
            torch.cuda.synchronize(dev)
        finally:
            _own_sync = False

    def __enter__(self) -> "_Frame":
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self._open()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if exc_type is None:
                self._sync()
        finally:
            self._close()
            self.range.__exit__(exc_type, exc, tb)
        return False


def span(name: str, device: Any = None, walls: Optional[Dict[str, float]] = None,
         peaks: Optional[Dict[str, int]] = None):
    """A context manager around one step of the work (see the module's
    docstring). ``device``: the device whose work the span's synchronise
    waits for (None: the current CUDA device, when CUDA is initialised; a
    CPU device: none). ``walls`` / ``peaks``: mappings that receive the
    span's wall in seconds (added up over calls) and its own peak in bytes
    (the largest; inside :func:`collect` on CUDA only). A span with
    ``walls`` records outside :func:`collect` too (see the module's
    docstring)."""
    if _records or (walls is not None and _VIEWS):
        return _Frame(name, device, walls, peaks)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of every open :func:`collect` record."""
    for r in _records:
        r.counters[name] = r.counters.get(name, 0) + n


def _note_sync() -> None:
    stack = _stack()
    if stack:
        stack[-1].syncs += 1
    count("host_syncs")


@contextmanager
def _counting_syncs() -> Iterator[None]:
    """``host_syncs`` through the sync debug mode's warnings, each added to
    the innermost open span of the thread that synchronised."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        shown = warnings.showwarning

        def hook(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                if not _own_sync:
                    _note_sync()
                return
            shown(message, category, filename, lineno, file, line)

        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)


@contextmanager
def collect() -> Iterator[Record]:
    """Tracing on for the block; yields the :class:`Record` that every span
    closed and every counter counted inside it fills (see the module's
    docstring for the own peaks and ``host_syncs``). On CUDA the block
    resets the allocator's peak counter (``max_memory_allocated``) at each
    span's entry: after the block, the counter holds the peak since the
    last entry, and the block's peak is :attr:`Record.peak_bytes`."""
    global _peaks
    record = Record()
    outermost = not _records
    prev_peaks = _peaks
    if outermost:
        _peaks = torch.cuda.is_initialized()
    _records.append(record)
    root = _Frame(None)
    try:
        with (_counting_syncs() if outermost and _peaks else _NULL):
            root._open()
            try:
                yield record
            finally:
                wall = root._close()
                # the block is no span: its enclosing span counts the block's spans as its children
                if root.parent is not None:
                    root.parent.child_ns += root.child_ns - wall
                if _peaks:
                    record.peak_bytes = root.peak
    finally:
        _records.remove(record)
        _peaks = prev_peaks
