#!/usr/bin/env python3
"""
The benchmark of ``marex_tpu_torch`` on one NVIDIA GPU.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix (``catalog.py``). The run:

1. makes the input on the card from ``--seed`` (``data/<generator>.py``),
   loads (on a checkout's first run, builds) the port's kernels, and runs one
   whole path to warm every shape: that is set-up, ``setup_s``;
2. runs the user's job, ``preprocess_data`` then ``tracker(...).run(...)``
   (``job.py``), path after path, for ``--seconds``; the path running when
   they have passed finishes, and the window ends with it. With ``--trace 1``
   the window's first path runs under ``torch.profiler``, and the per-layer
   walls come from the paths after it;
3. after the window, frees the program's state and runs the plain reference
   (``reference/``, the pieces the mix names) on the same input, and compares
   the last path's outputs with it (``compare.py``); every path's outputs
   must equal the last's bit for bit;
4. prints descriptors on earlier lines, each compared number beside its
   limit as the last lines on standard error, and as the last line on
   standard output one JSON object: ``correct``, ``attempted`` and
   ``failed`` (in paths), ``metrics`` (the cell's end-to-end metrics, or with
   ``--trace 1`` its per-layer ones), ``device``, ``breakdown`` (traced
   runs) and ``checks``.

It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or
``marex_tpu`` is loaded once the window has closed. Its files go to the
checkout (the kernels' build, ``marex_tpu_torch/_build/``) and ``TMPDIR``
(the traced run's profile, deleted once read).
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_h100 import catalog, compare, job as job_mod  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "marex_tpu")
GIB = float(1 << 30)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them ("" when it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def prepare_program(device: str):
    """Import the port and load its native libraries (built on a checkout's
    first run). Returns (module, seconds spent building)."""
    import marex_tpu_torch as mx
    from marex_tpu_torch import _cuda_build, _native

    if torch.device(device).type == "cuda":
        _cuda_build.kernel_library()
    t0 = time.perf_counter()
    _native.get_lib()
    host_build = time.perf_counter() - t0
    return mx, _cuda_build.last_build_seconds + host_build


def run_reference(spec: dict, inputs: dict, device: str, precision: torch.dtype = torch.float32,
                  walls: Optional[dict] = None) -> dict:
    """The plain reference's outputs for the cell's input: each piece the mix
    names, in order, on one state dict (each piece's seconds into ``walls``)."""
    state = {"config": spec["config_data"], "mix": spec["traffic_data"], "inputs": inputs, "device": device,
             "precision": precision, "out": {}}
    for piece in spec["traffic_data"]["reference"]:
        t0 = time.perf_counter()
        catalog.reference_piece(piece).run(state)
        if walls is not None:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            walls[piece] = round(time.perf_counter() - t0, 3)
    return state["out"]


def window(job, seconds: float, trace: bool):
    """Whole paths for ``seconds`` (the last one finishes; with ``trace`` two
    at the least); returns (records,
    last path's outputs, digests of every path, window seconds, exception or
    None, the profile's path or None). With ``trace`` the window's first path
    runs under ``torch.profiler`` (every path is the same job, and a mesh
    path's trace alone is some 700 MB)."""
    records, digests, last, outs, error = [], [], None, None, None
    prof = profile_path = None
    t0 = time.perf_counter()
    try:
        while True:
            last = outs = None  # the previous path's outputs go before the next path runs
            if trace and not records:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            with torch.profiler.record_function("bench/path"):
                path = job.run_path()
            if prof is not None and len(records) == 0:
                prof.__exit__(None, None, None)
            outs = job_mod.outputs(path)
            records.append({"detect_s": path["detect_s"], "track_s": path["track_s"],
                            "stage_walls": dict(path["tracker"].stage_walls),
                            "labelled_cells": job_mod.labelled_cells(outs),
                            "ccl_iterations": dict(path["tracker"].ccl_iterations),
                            "dispatch_counts": dict(path["tracker"].dispatch_counts)})
            del path
            digests.append(job_mod.digest(outs))
            last = outs
            # a traced window runs on past its first path, whose walls the profiler slowed
            if time.perf_counter() - t0 >= seconds and (not trace or len(records) > 1):
                break
    except Exception as e:  # a path that fails is counted, and the run is not correct
        error = e
    elapsed = time.perf_counter() - t0
    if prof is not None:
        if not records:
            prof.__exit__(None, None, None)
        fd, profile_path = tempfile.mkstemp(suffix=".json", prefix="bench_h100_trace_")
        os.close(fd)
        prof.export_chrome_trace(profile_path)
        del prof
    return records, last, digests, elapsed, error, profile_path


def per_layer(spec: dict, bench: dict, records: list, profile_path, device_name: str):
    """The cell's per-layer metrics and the breakdown from the traced window:
    walls from the paths the profiler did not slow (all but the first), the
    trace's metrics from the first."""
    from bench_h100.trace import Trace

    tr = Trace(profile_path) if profile_path else None
    peak = catalog.peaks().get(device_name, {})
    run = {"paths": records[1:], "traced_path": records[0] if records else None, "trace": tr,
           "hbm_bytes_per_s": peak.get("hbm_bytes_per_s")}
    metrics = {}
    for m in bench["per_layer"]:
        if spec["name"] not in m.get("workloads", [spec["name"]]):
            continue
        value = catalog.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    extra = {}
    if tr is not None and tr.window is not None:
        extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s(),
                 "breakdown": {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}}
    return metrics, extra


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda"):
    """A whole run of the cell; returns (result dict, descriptor lines)."""
    bench = catalog.benchmark()
    cfg, mix = spec["config_data"], spec["traffic_data"]
    cuda = torch.device(device).type == "cuda"
    mx, build_s = prepare_program(device)
    inputs = catalog.generator(cfg["generator"]).generate(cfg, seed, device)
    job = job_mod.Job(mx, cfg, mix, inputs, device)
    cells_per_path = job.input_cells
    warm = job.run_path()
    del warm
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - _T_START

    records, last, digests, window_s, error, profile_path = window(job, seconds, trace)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted = len(digests) + (error is not None)
    lines = [f"setup: {setup_s:.3f} s (kernel and host library builds {build_s:.3f} s)",
             f"window: {len(records)} whole paths in {window_s:.3f} s, peak {peak} B"]
    for i, r in enumerate(records):
        lines.append(f"path {i}: detect {r['detect_s']:.4f} s, track {r['track_s']:.4f} s, "
                     f"iterations {r['ccl_iterations']}, dispatches {r['dispatch_counts']}")
        lines.append(f"path {i} stages: {json.dumps(r['stage_walls'], sort_keys=True)}")

    # the program's state is freed; the last path's outputs stay for the comparison
    del job
    if cuda:
        torch.cuda.empty_cache()
    checks, correct = {}, error is None and last is not None
    if last is not None:
        lines.append("events: " + json.dumps({k: v for k, v in last["attrs"].items()}, default=float))
        same = sum(d == digests[-1] for d in digests)
        checks["paths.differ"] = {"value": float(len(digests) - same), "limit": 0.0}
        t0, walls = time.perf_counter(), {}
        want = run_reference(spec, inputs, device, walls=walls)
        t1 = time.perf_counter()
        checks.update(compare.judge(compare.numbers(last, want, device), spec["limits"]))
        correct = correct and compare.passed(checks)
        lines.append(f"reference: {t1 - t0:.3f} s {json.dumps(walls)}, comparison {time.perf_counter() - t1:.3f} s")
    if error is not None:
        lines.append(f"a path failed: {type(error).__name__}: {error}")

    work = cells_per_path * len(records)
    if trace:
        dev_name = torch.cuda.get_device_name() if cuda else "cpu"
        t0 = time.perf_counter()
        size = os.path.getsize(profile_path) if profile_path else 0
        metrics, extra = per_layer(spec, bench, records, profile_path, dev_name)
        if profile_path:
            os.unlink(profile_path)
        lines.append(f"trace: {size} bytes read in {time.perf_counter() - t0:.3f} s")
    else:
        metrics = {"mcell_days_per_s": {"value": work / window_s / 1e6, "unit": "Mcell-days/s"},
                   "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        extra = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": spec["chips"], "memory_peak_bytes": int(peak)}
    if cuda:
        device_info["power"] = power_limit()
    if trace and "busy_s" in extra:
        device_info["busy_s"], device_info["window_s"] = extra["busy_s"], extra["window_s"]
    result = {"correct": bool(correct), "attempted": attempted, "failed": attempted - len(records),
              "metrics": metrics, "device": device_info}
    if "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]} for k, c in checks.items()}
    return result, lines


def finite(x: float) -> float:
    """A compared number as JSON holds it: an infinite gap (shapes or NaN
    patterns that differ) reads as 1e300."""
    return x if math.isfinite(x) else 1e300


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = catalog.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"bench_h100: the cell needs {spec['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, lines = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"bench_h100: modules loaded that must not be: {found}", file=sys.stderr)
        return 4
    for line in lines:
        print(line)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
