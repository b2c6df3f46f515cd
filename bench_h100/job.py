"""
The user's job, run through the port's entry points: ``preprocess_data`` on
the generated SST, then ``tracker(ds.extreme_events, ds.mask, ...)`` and
``.run(return_merges=True)`` when the mix merges, else ``.run()``. Each part
ends in a synchronise, so its wall holds its own device work.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

# elements of one chunk of a digest's int64 temporaries
_DIGEST_CHUNK = 1 << 26


class Job:
    """One cell's job on its generated input (``inputs``: the generator's
    dict), run on ``device`` with the port ``mx``."""

    def __init__(self, mx, config: dict, mix: dict, inputs: dict, device: str):
        self.mx = mx
        self.mix = mix
        self.device = device
        self.inputs = inputs
        self.field = mx.Field(inputs["sst"], tuple(config["dims"]), inputs["coords"], name="sst")
        self.detect_kw = {**config.get("detect", {}), **mix["detect"]}
        self.track_kw = {**config["tracker"], **mix["tracker"]}
        if "neighbours" in inputs:
            self.detect_kw["neighbours"] = mx.Field(inputs["neighbours"], ("nv", config["dims"][1]), name="neighbours")
            self.detect_kw["cell_areas"] = mx.Field(inputs["cell_areas"], (config["dims"][1],), name="cell_areas")

    @property
    def input_cells(self) -> int:
        """Cells times days handed to ``preprocess_data``."""
        return int(self.inputs["sst"].numel())

    def _sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def run_path(self) -> Dict[str, Any]:
        """One whole path; returns its outputs, walls and the tracker."""
        mx = self.mx
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench/detect"):
            ds = mx.preprocess_data(self.field, device=self.device, quiet=True, **self.detect_kw)
            self._sync()
        t1 = time.perf_counter()
        kw = dict(self.track_kw)
        if "neighbours" in ds.data_vars:
            kw.update(neighbours=ds.neighbours, cell_areas=ds.cell_areas)
        # tracker.run prints its statistics; they are the program's, not the benchmark's lines
        with torch.profiler.record_function("bench/track"), contextlib.redirect_stdout(io.StringIO()):
            tr = mx.tracker(ds.extreme_events, ds.mask, device=self.device, quiet=True, **kw)
            if self.mix["return_merges"]:
                events, merges = tr.run(return_merges=True)
            else:
                events, merges = tr.run(), None
            self._sync()
        t2 = time.perf_counter()
        return {"ds": ds, "events": events, "merges": merges, "tracker": tr, "detect_s": t1 - t0, "track_s": t2 - t1}


def outputs(path: Dict[str, Any]) -> Dict[str, Any]:
    """The outputs a path is judged by: detect's fields, the events' fields
    and attrs, and the merge records (tensors stay where they are)."""
    ds, events, merges = path["ds"], path["events"], path["merges"]
    out: Dict[str, Any] = {k: ds[k].data for k in ("dat_anomaly", "mask", "extreme_events", "thresholds")}
    out.update({f"events.{k}": events[k].data for k in events.data_vars})
    out["attrs"] = {k: v for k, v in events.attrs.items() if isinstance(v, (int, float, np.integer, np.floating))}
    if merges is not None:
        out.update({f"merges.{k}": merges[k].data for k in merges.data_vars})
    return out


def _tensor_digest(x: torch.Tensor) -> str:
    """Two int64 sums over the raw bits of ``x`` (plain and position
    weighted), over chunks so that the temporaries stay small."""
    flat = x.detach().reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.view(torch.uint8)
    elif flat.dtype.is_floating_point:
        flat = flat.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[flat.element_size()])
    s1 = torch.zeros((), dtype=torch.int64, device=flat.device)
    s2 = torch.zeros((), dtype=torch.int64, device=flat.device)
    for a in range(0, flat.numel(), _DIGEST_CHUNK):
        c = flat[a : a + _DIGEST_CHUNK].long()
        w = torch.arange(a, a + c.numel(), device=c.device) % 65521 + 1
        s1 += c.sum()
        s2 += (c * w).sum()
    return f"{tuple(x.shape)}:{x.dtype}:{int(s1)}:{int(s2)}"


def digest(outs: Dict[str, Any]) -> Dict[str, str]:
    """A digest of every output, bit for bit: equal digests mean equal
    outputs (but for collisions)."""
    d = {}
    for k, v in sorted(outs.items()):
        if isinstance(v, torch.Tensor):
            d[k] = _tensor_digest(v)
        elif isinstance(v, np.ndarray):
            a = np.ascontiguousarray(v)
            d[k] = f"{a.shape}:{a.dtype}:" + hashlib.sha1(a.view(np.uint8).reshape(-1).tobytes() if a.size else b"").hexdigest()
        else:
            d[k] = repr(v)
    return d


def labelled_cells(outs: Dict[str, Any]) -> int:
    """Cells of the field the tracker labels (its time steps times its
    spatial cells)."""
    ids: Optional[torch.Tensor] = outs.get("events.ID_field")
    return int(ids.numel()) if ids is not None else 0
