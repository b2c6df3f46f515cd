"""
Smoke run of the PyTorch port (``marex_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (and so exits nonzero) on failure:

1. device: the card's name and its power limit from ``nvidia-smi``;
2. build: the CUDA kernels, compiled from ``marex_tpu_torch/csrc`` by ``nvcc``;
3. kernels against their plain PyTorch versions on the card: bit-identical
   (tolerance 0) over masked/plain modes, ``wrap_x`` on and off, per-slice
   and whole-block slice sizes, random masks, ragged shapes and the main
   path's own shape 1095 x 720 x 1440; then both timed at (64, 720, 1440);
4. both paths at 3 yr x 180 x 360, on CUDA and on the CPU (plain
   versions): config 1 (no merging) with boolean and integer outputs
   bit-identical and floats within 1e-5; then config 4 (merging, nearest-cell
   partitioning) with ``ID_field``, ``global_ID``, ``presence``,
   ``merge_ledger`` and every merge record bit-identical, ``area`` and
   ``centroid`` within 1e-5, and merges and partitions that really happened;
5. both paths at full size, 3 yr x 720 x 1440 daily (0.25 degree global),
   generated on the card from ``--seed``: ``preprocess_data`` (fixed
   baseline, global 95th percentile) then ``tracker(R_fill=12, T_fill=4,
   area_filter_absolute=600, grid_resolution=0.25, ...)``, first with
   ``allow_merging=False`` (config 1), then with ``allow_merging=True,
   nn_partitioning=True, overlap_threshold=0.25`` and
   ``run(return_merges=True)`` (config 4, the main path). Each path is run
   with the kernels' launch counts set to 0 just before it and read just
   after.

The line before the last is a JSON object with each kernel's launches on the
merge path of phase 5, its largest difference from the plain version and
both times; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import torch

DETECT_FIXED = dict(
    method_anomaly="fixed_baseline",
    method_extreme="global_extreme",
    method_percentile="approximate",
    threshold_percentile=95,
)
BIG = 2**31 - 1


def make_sst(n_years: int, ny: int, nx: int, seed: int, device: str):
    """Synthetic daily SST (T, ny, nx) float32, generated on ``device``: AR(1)
    noise, a seasonal cycle, drifting warm blobs (days 60-140), converging
    blob pairs (days 150-270) and a NaN land block — the recipe of
    ``bench._make_data_impl``, with torch's generator in place of numpy's."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    times = pd.date_range("2000-01-01", periods=int(n_years * 365.25), freq="D").to_numpy()
    T = len(times)
    lat = np.linspace(-89.5, 89.5, ny)
    lon = np.linspace(0.0, 360.0, nx, endpoint=False)
    idx = pd.DatetimeIndex(times)
    doy, years = idx.dayofyear.to_numpy(), idx.year.to_numpy()
    coslat = torch.cos(torch.deg2rad(torch.tensor(lat, dtype=torch.float32, device=device)))
    base = (15.0 + 10.0 * coslat)[:, None]
    seas = torch.tensor(3.0 * np.cos(2 * np.pi * (doy - 30) / 365.25), dtype=torch.float32, device=device)
    yrow = torch.arange(ny, device=device)
    xcol = torch.arange(nx, device=device)

    sst = torch.empty((T, ny, nx), dtype=torch.float32, device=device)
    noise = torch.randn((ny, nx), generator=g, device=device)
    for t in range(T):
        if t:
            noise = 0.8 * noise + 0.6 * torch.randn((ny, nx), generator=g, device=device)
        sst[t] = noise + base + seas[t] * coslat[:, None]

    def stamp(t: int, cy: int, cx: int, rad: int, amp: float) -> None:
        r0, r1 = max(cy - rad, 0), min(cy + rad + 1, ny)
        if r0 >= r1:
            return
        dxc = torch.minimum((xcol - cx).abs(), nx - (xcol - cx).abs())
        blob = (yrow[r0:r1, None] - cy) ** 2 + dxc[None, :] ** 2 <= rad * rad
        sst[t, r0:r1] += amp * blob

    y0 = years.min()
    r = max(min(ny, nx) // 8, 12)
    rp = max(16, min(ny, nx) // 45)
    n_pairs = max(6, ny // 36)
    pairs = [(int(ny * (0.25 + 0.5 * i / max(n_pairs - 1, 1))), int((i * 997) % nx)) for i in range(n_pairs)]
    for t in range(T):
        d, yr = int(doy[t]), int(years[t] - y0)
        if 60 <= d <= 140:
            stamp(t, ny // 2 + ((yr % 3) - 1) * (ny // 6), (nx // 4 + yr * (nx // 5) + (d - 60)) % nx, r, 4.0)
        if 150 <= d <= 270:
            phase = ((d - 150) % 40) / 40.0
            sep = int((1.0 - min(phase * 2, 1.0)) * 3 * rp) + rp
            for cy, cx0 in pairs:
                cx0y = (cx0 + yr * (nx // 3 + 7)) % nx
                for s in (-sep, sep):
                    stamp(t, cy, (cx0y + s) % nx, rp, 5.0)
    sst[:, ny // 4 : ny // 4 + ny // 8, nx // 8 : nx // 4] = float("nan")
    return sst, {"time": times, "lat": lat, "lon": lon}


def track_kwargs(ny: int, merge: bool = False) -> dict:
    """Production tracking parameters at 0.25 degree (ny = 720), with R_fill
    and the area floor scaled with resolution on coarser grids (as bench.py);
    ``merge`` gives config 4's split/merge settings, else config 1's."""
    s = min(ny / 720.0, 1.0)
    kw = dict(
        R_fill=max(int(round(12 * s)), 2),
        T_fill=4,
        area_filter_absolute=max(int(round(600 * s * s)), 8),
        grid_resolution=round(180.0 / ny, 4),
        allow_merging=merge,
    )
    if merge:
        kw.update(nn_partitioning=True, overlap_threshold=0.25)
    return kw


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call, by CUDA events around ``reps`` calls after a warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(a: torch.Tensor, b: torch.Tensor, chunk: int = 1 << 26) -> int:
    """Largest |a - b| of two int32 tensors, in int64 and in chunks, so that a
    full-size comparison needs no full-size int64 temporaries."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    a, b = a.reshape(-1), b.reshape(-1)
    return max(
        (int((a[i : i + chunk].long() - b[i : i + chunk].long()).abs().max()) for i in range(0, a.numel(), chunk)),
        default=0,
    )


def run_slice(mx, sst, coords, device: str, ny: int, merge: bool = False):
    """detect + track through the entry points; returns (ds, events, merges
    (None without merging), tracker, detect wall, track wall, detect peak)."""
    t0 = time.perf_counter()
    ds = mx.preprocess_data(mx.Field(sst, ("time", "lat", "lon"), coords, name="sst"), device=device, quiet=True,
                            **DETECT_FIXED)
    detect_peak = 0
    if device == "cuda":
        torch.cuda.synchronize()
        detect_peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    tr = mx.tracker(ds.extreme_events, ds.mask, device=device, quiet=True, **track_kwargs(ny, merge))
    events, merges = tr.run(return_merges=True) if merge else (tr.run(), None)
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return ds, events, merges, tr, t1 - t0, t2 - t1, detect_peak


def compare_merge_runs(ev_g, mg_g, tr_g, ev_c, mg_c) -> dict:
    """Config 4 on CUDA against the CPU: integer and boolean outputs and the
    merge records bit-identical, area and centroid within 1e-5 (relative, or
    absolute near 0: areas are km^2); raises on any difference. Returns the
    largest float differences."""
    for key in ("ID_field", "global_ID", "presence", "merge_ledger", "time_start", "time_end"):
        if not np.array_equal(ev_g[key].values, ev_c[key].values):
            raise AssertionError(f"merge slice: {key} differs between CUDA and CPU")
    for key in ("parent_IDs", "child_IDs", "overlap_areas", "merge_time", "n_parents", "n_children"):
        if not np.array_equal(mg_g[key].values, mg_c[key].values):
            raise AssertionError(f"merge slice: merges {key} differs between CUDA and CPU")
    diff = {}
    for key in ("area", "centroid"):
        a, b = ev_g[key].values.astype(np.float64), ev_c[key].values.astype(np.float64)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"merge slice: {key} NaN pattern")
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f"merge slice: {key}")
        fin = np.isfinite(a)
        d = np.abs(a[fin] - b[fin])
        diff[key] = (float(d.max()) if d.size else 0.0, float((d / np.maximum(np.abs(b[fin]), 1e-30)).max()) if d.size else 0.0)
    for key in ("N_events_final", "total_merges"):
        if ev_g.attrs[key] != ev_c.attrs[key]:
            raise AssertionError(f"merge slice: {key} {ev_g.attrs[key]} (CUDA) vs {ev_c.attrs[key]} (CPU)")
    if ev_g.attrs["total_merges"] <= 0 or tr_g.dispatch_counts.get("partition", 0) <= 0:
        raise AssertionError(f"merge slice: no merge or no partition ran: {ev_g.attrs}, {tr_g.dispatch_counts}")
    return diff


def check_merge_outputs(events, merges, T: int, ny: int, nx: int) -> int:
    """The merge path's outputs are whole: ids 0..N over the field, a (time,
    ID) table that marks exactly the present events, finite positive areas
    and in-range centroids where an event is present. Returns N."""
    n = int(events.attrs["N_events_final"])
    ids = events["ID_field"].data
    if tuple(ids.shape) != (T, ny, nx) or ids.dtype != torch.int32:
        raise AssertionError(f"ID_field has shape {tuple(ids.shape)} and dtype {ids.dtype}")
    if n <= 0 or int(ids.max()) != n or int(ids.min()) != 0:
        raise AssertionError(f"ID_field range [{int(ids.min())}, {int(ids.max())}] vs N_events_final {n}")
    pres = events["presence"].data
    gid = events["global_ID"].data
    if tuple(pres.shape) != (T, n) or not torch.equal(pres, gid > 0) or not bool(pres.any(0).all()):
        raise AssertionError("presence does not match global_ID, or an event is never present")
    area = events["area"].data
    cent = events["centroid"].data
    if not bool(torch.isfinite(area[pres]).all()) or not bool((area[pres] > 0).all()):
        raise AssertionError("non-finite or non-positive event area where present")
    lat, lon = cent[0][pres], cent[1][pres]
    if not bool(((lat >= -90) & (lat <= 90) & (lon >= 0) & (lon < 360)).all()):
        raise AssertionError("event centroid out of range where present")
    if int(events.attrs["total_merges"]) != merges["n_parents"].shape[0]:
        raise AssertionError("total_merges differs from the merge records")
    return n


def slices_against_cpu(mx, ny: int, nx: int, seed: int, device: str) -> None:
    """Phase 4: config 1 and config 4 at 3 yr x ny x nx on ``device`` and on
    the CPU; raises on any difference beyond the stated tolerances."""
    sst, coords = make_sst(3, ny, nx, seed, device)
    sst_cpu = sst.cpu()
    ds_g, ev_g, _, tr_g, det_g, trk_g, _ = run_slice(mx, sst, coords, device, ny)
    ds_c, ev_c, _, tr_c, det_c, trk_c, _ = run_slice(mx, sst_cpu, coords, "cpu", ny)
    for key in ("extreme_events", "mask"):
        if not np.array_equal(ds_g[key].values, ds_c[key].values):
            raise AssertionError(f"mid-size slice: {key} differs between CUDA and CPU")
    if not np.array_equal(ev_g["ID_field"].values, ev_c["ID_field"].values):
        raise AssertionError("mid-size slice: ID_field differs between CUDA and CPU")
    float_diff = {}
    for key in ("dat_anomaly", "thresholds"):
        a, b = ds_g[key].values, ds_c[key].values
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"mid-size slice: {key} NaN pattern differs")
        float_diff[key] = float(np.nanmax(np.abs(a - b))) if np.isfinite(a).any() else 0.0
        if float_diff[key] > 1e-5:
            raise AssertionError(f"mid-size slice: {key} differs by {float_diff[key]} > 1e-5")
    n_attrs = {k: v for k, v in ev_g.attrs.items() if k.startswith("N_")}
    if n_attrs != {k: v for k, v in ev_c.attrs.items() if k.startswith("N_")}:
        raise AssertionError(f"mid-size slice: N_* attrs differ: {n_attrs} vs {ev_c.attrs}")
    print(
        f"slice 3yr x {ny} x {nx}: CUDA == CPU (extreme_events, mask, ID_field bit-identical; "
        f"max |diff| dat_anomaly {float_diff['dat_anomaly']}, thresholds {float_diff['thresholds']}); "
        f"{n_attrs}; cuda detect {det_g:.3f} s track {trk_g:.3f} s; cpu detect {det_c:.3f} s track {trk_c:.3f} s; "
        f"ccl iterations cuda {tr_g.ccl_iterations} cpu {tr_c.ccl_iterations}"
    )
    del ds_g, ev_g, tr_g, ds_c, ev_c, tr_c

    _, ev_g, mg_g, tr_g, det_g, trk_g, _ = run_slice(mx, sst, coords, device, ny, merge=True)
    _, ev_c, mg_c, tr_c, det_c, trk_c, _ = run_slice(mx, sst_cpu, coords, "cpu", ny, merge=True)
    diff = compare_merge_runs(ev_g, mg_g, tr_g, ev_c, mg_c)
    m_attrs = {k: ev_g.attrs[k] for k in ("N_objects_filtered", "N_events_final", "total_merges", "multi_parent_merges")}
    print(
        f"merge slice 3yr x {ny} x {nx}: CUDA == CPU (ID_field, global_ID, presence, merge_ledger and merge "
        f"records bit-identical; max |diff| (abs, rel) area {diff['area']}, centroid {diff['centroid']}); "
        f"{m_attrs}; dispatches cuda {tr_g.dispatch_counts} cpu {tr_c.dispatch_counts}; "
        f"cuda detect {det_g:.3f} s track {trk_g:.3f} s; cpu detect {det_c:.3f} s track {trk_c:.3f} s"
    )
    print(f"merge slice stage_walls cuda: {json.dumps(tr_g.stage_walls)}")
    print(f"merge slice stage_walls cpu: {json.dumps(tr_c.stage_walls)}")


def main_paths(mx, ny: int, nx: int, seed: int, kernels: dict, device: str) -> dict:
    """Phase 5: config 1, then the merge path (config 4), at 3 yr x ny x nx
    generated on ``device``, each with the kernels' launch counts set to 0
    just before it and read just after. Prints each path's walls, counts and
    memory; returns {path: launch counts}."""
    t0 = time.perf_counter()
    sst, coords = make_sst(3, ny, nx, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"data: {tuple(sst.shape)} generated on the card in {time.perf_counter() - t0:.1f} s")
    T = sst.shape[0]
    launches = {}
    for merge in (False, True):
        path = "merge path (config 4)" if merge else "config 1"
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launch_count = 0
        ds, events, merges, tr, t_det, t_trk, detect_peak = run_slice(mx, sst, coords, device, ny, merge=merge)
        launches[path] = {k: fn.launch_count for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        thr, mask = ds["thresholds"].data, ds["mask"].data
        if not bool(torch.isfinite(thr[mask]).all()):
            raise AssertionError("non-finite thresholds over the ocean")
        if merge:
            n_events = check_merge_outputs(events, merges, T, ny, nx)
        else:
            n_events = int(events.attrs["N_events_final"])
            ids = events["ID_field"].data
            if tuple(ids.shape) != (T, ny, nx) or ids.dtype != torch.int32:
                raise AssertionError(f"ID_field has shape {tuple(ids.shape)} and dtype {ids.dtype}")
            if n_events <= 0 or int(ids.max()) != n_events or int(ids.min()) != 0:
                raise AssertionError(f"ID_field range [{int(ids.min())}, {int(ids.max())}] vs N_events_final {n_events}")
            del ids
        print(
            f"{path} {T} x {ny} x {nx}: detect {t_det:.3f} s, track {t_trk:.3f} s, "
            f"{T * ny * nx / (t_det + t_trk):.4g} gridpoint-days/s"
        )
        print(f"  stage_walls: {json.dumps(tr.stage_walls)}")
        print(f"  N_events_final: {n_events}; attrs: "
              f"{json.dumps({k: v for k, v in events.attrs.items() if k.startswith('N_') or 'merge' in k})}")
        if merge:
            print(f"  dispatch_counts: {json.dumps(tr.dispatch_counts)}")
        print(f"  ccl iterations: {json.dumps(tr.ccl_iterations)}")
        print(f"  launch counts: {json.dumps(launches[path])}")
        print(f"  max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB); after detect {detect_peak / 2**30:.2f} GiB")
        print(f"  stage_peak_bytes (running max): {json.dumps(tr.stage_peak_bytes)}")
        del ds, events, merges, tr, thr, mask
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)

    import marex_tpu_torch as mx
    from marex_tpu_torch import _cuda_build, _native
    from marex_tpu_torch.ops.min_stencil import (
        hook,
        hook_plain,
        min_stencil,
        min_stencil_plain,
        pointer_jump,
        pointer_jump_plain,
    )

    # ---- 2. build ---------------------------------------------------------
    _cuda_build.kernel_library()
    print(f"build: {_cuda_build.last_build_seconds:.1f} s")
    for line in _cuda_build.last_build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    # the merge path's host union-find (csrc/marex_host.cpp, built by g++)
    if not _native.has_native():
        raise AssertionError("the host union-find library (csrc/marex_host.cpp) did not build")
    print(f"native: {_native.get_lib()._name}")

    # ---- 3. kernels against their plain versions --------------------------
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    err = {"min_stencil": 0, "hook": 0, "pointer_jump": 0}
    n_checks = 0

    def check(k: str, kernel, plain, what: str) -> None:
        nonlocal n_checks
        got = kernel()
        want = plain()
        diff = max_abs_diff(got, want)
        del got, want
        if diff:
            raise AssertionError(f"{k} {what}: max diff {diff}")
        err[k] = max(err[k], diff)
        n_checks += 1

    # ragged shapes, then the main path's own shape (3 yr x 720 x 1440), at
    # which its CCLs call every kernel: per slice (slice_size H*W) and over
    # the whole block (T*H*W)
    cases = [(s, (0.1, 0.6)) for s in [(5, 7, 13), (3, 720, 1440), (1, 1, 5), (2, 3, 1), (9, 33, 64)]]
    cases.append(((int(3 * 365.25), 720, 1440), (0.6,)))
    for shape, densities in cases:
        T, H, W = shape
        for density in densities:
            data = torch.rand(shape, generator=g, device="cuda") < density
            for slice_size in (H * W, T * H * W):
                lab = torch.randint(0, slice_size, shape, generator=g, device="cuda", dtype=torch.int32)
                lab.masked_fill_(~data & (torch.rand(shape, generator=g, device="cuda") < 0.5), BIG)
                what = f"{shape} density={density}"
                if slice_size == H * W:
                    for masked in (True, False):
                        for wrap_x in (True, False):
                            d = data if masked else None
                            check(
                                "min_stencil",
                                lambda: min_stencil(lab, d, masked=masked, wrap_x=wrap_x),
                                lambda: min_stencil_plain(lab, d, masked=masked, wrap_x=wrap_x),
                                f"{what} masked={masked} wrap_x={wrap_x}",
                            )
                what = f"{what} slice_size={slice_size}"
                check("pointer_jump", lambda: pointer_jump(lab, slice_size),
                      lambda: pointer_jump_plain(lab, slice_size), what)
                lab_new = torch.where(lab == BIG, BIG, torch.minimum(lab, lab.flip(-1)))
                check("hook", lambda: hook(lab, lab_new, slice_size), lambda: hook_plain(lab, lab_new, slice_size),
                      what)
                del lab, lab_new
            del data
    torch.cuda.empty_cache()
    print(f"kernels: {n_checks} checks bit-identical to the plain versions (tolerance 0), "
          f"up to the main path's shape {cases[-1][0]}")

    shape = (64, 720, 1440)
    lab = torch.randint(0, 720 * 1440, shape, generator=g, device="cuda", dtype=torch.int32)
    data = torch.rand(shape, generator=g, device="cuda") < 0.3
    lab_new = torch.minimum(lab, lab.flip(-1))
    times = {
        "min_stencil": (
            cuda_ms(lambda: min_stencil(lab, data, masked=True)),
            cuda_ms(lambda: min_stencil_plain(lab, data, masked=True)),
        ),
        "min_stencil_plain_mode": (
            cuda_ms(lambda: min_stencil(lab, masked=False)),
            cuda_ms(lambda: min_stencil_plain(lab, masked=False)),
        ),
        "hook": (
            cuda_ms(lambda: hook(lab, lab_new, 720 * 1440)),
            cuda_ms(lambda: hook_plain(lab, lab_new, 720 * 1440)),
        ),
        "pointer_jump": (
            cuda_ms(lambda: pointer_jump(lab, 720 * 1440)),
            cuda_ms(lambda: pointer_jump_plain(lab, 720 * 1440)),
        ),
    }
    for k, (t_kernel, t_plain) in times.items():
        print(f"time {k} at {shape}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms")
    del lab, data, lab_new

    # ---- 4. both paths, CUDA against CPU, at 3 yr x 180 x 360 --------------
    slices_against_cpu(mx, 180, 360, args.seed, "cuda")
    torch.cuda.empty_cache()

    # ---- 5. both paths at full size ---------------------------------------
    kernels = {"min_stencil": min_stencil, "hook": hook, "pointer_jump": pointer_jump}
    launches = main_paths(mx, 720, 1440, args.seed, kernels, "cuda")
    for path, counts in launches.items():
        if min(counts.values()) <= 0:
            raise AssertionError(f"a kernel of the {path} was never launched: {counts}")

    replaces = {
        "min_stencil": "marex_tpu/ops/pallas_kernels.py:60",
        "hook": "marex_tpu/ops/label.py:84",
        "pointer_jump": "marex_tpu/ops/label.py:130",
    }
    print(json.dumps({"kernels": [
        {
            "name": k,
            "route": "cuda",
            "source": "marex_tpu_torch/csrc/min_stencil.cu",
            "replaces": replaces[k],
            "launches": launches["merge path (config 4)"][k],
            "max_abs_err": err[k],
            "ms": times[k][0],
            "plain_ms": times[k][1],
        }
        for k in kernels
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
