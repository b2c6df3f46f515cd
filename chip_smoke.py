"""
Smoke run of the PyTorch port (``marex_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (and so exits nonzero) on failure:

1. device: the card's name and its power limit from ``nvidia-smi``;
2. build: the CUDA kernels, compiled from ``marex_tpu_torch/csrc`` by ``nvcc``;
3. kernels against their plain PyTorch versions on the card: bit-identical
   (tolerance 0) over the stencil's modes (masked, plain), the fused CCL
   step in both depths (per slice, and 3x3x3 over the block) with ``out``
   BIG-filled and stale, its convergence flag, ``wrap_x`` on and off, the
   jump per slice and over the block, random masks, ragged widths and the
   main path's own shape 1095 x 720 x 1440; then each timed at
   (64, 720, 1440) on random labels, beside its plain version and the
   nearest single PyTorch call. The mesh kernels over the list of active
   cells likewise, ``graph_step`` against its plain version and the dense
   step, ``graph_jump`` against its plain version and the whole-field jump:
   on the triangle-pair mesh's table (as given and symmetrised, up to config
   5's own shape, 730 x 1,048,352 cells) and on random directed tables after
   symmetrising (more than 3 rows, ``-1`` entries, ragged cell counts),
   ``out`` BIG-filled and stale, the flag, and the whole mesh fixpoint
   against the CPU's; then both timed at (64, 1048352) beside
   ``index_select`` and ``torch.take``. The grid partition kernel
   (``marex_partition_grid``) against its plain version on random batches of
   blocky parents and children (the updated slice and the pieces' props bit
   for bit) at 720 x 1440, 719 x 1441 and ragged small shapes, with (K, P) of
   (1, 2), (4, 3) and (2, 10), ``wrap`` on and off and caps 0, 40 and 600;
4. the paths at small sizes, on CUDA and on the CPU (plain versions). At
   3 yr x 180 x 360: config 1 (no merging) with boolean and integer outputs
   bit-identical and floats within 1e-5, then again with the two-level event
   labelling forced (``track.TWO_LEVEL_CELLS`` lowered), its ``ID_field``
   bit-identical to the fused route's and the CPU's, and ``Field``
   reductions and operators on its CUDA payloads against CPU copies
   (integers and bools bit-identical, floats within 1e-5 relative); config 4 (merging, nearest-cell
   partitioning) with ``ID_field``, ``global_ID``, ``presence``,
   ``merge_ledger`` and every merge record bit-identical, ``area`` and
   ``centroid`` within 1e-5, and merges and partitions that really happened;
   config 2 (the reference's defaults: shifting baseline, approximate Hobday
   thresholds; at 3 yr x 90 x 360) with ``dat_anomaly``, ``thresholds``, ``extreme_events``,
   ``mask`` and ``ID_field`` bit-identical; the exact percentile (Hobday
   and global) with thresholds and extremes bit-identical; and
   ``detrend_harmonic`` with ``std_normalise`` with floats within 1e-5 and
   each differing extreme within 1e-5 of its threshold. Config 5 (an
   unstructured mesh, merging) at 2 yr x 32768 cells, held like config 4,
   with merges on the mesh; config 3 (a regional domain, no merging) at
   3 yr x 90 x 180 with ``extreme_events``, ``mask``, ``ID_field`` and attrs
   bit-identical, and its first 400 days with merging on, held like config 4.
   Streamed tracking (``tracker.run_streamed`` from a lazy zarr store, in at
   least 4 time blocks) of config 4's slice and of config 5's, each held like
   config 4 against its in-memory run on the card and against the CPU's; the
   tracker's mid-level API (``identify_objects`` per slice and with time
   connectivity by both routes, ``calculate_object_properties``,
   ``find_overlapping_objects``, ``check_overlap_slice``, ``mask_values``)
   with config 4's settings on the first 120 days of config 4's slice, bit
   for bit against the CPU;
5. the paths at full size, generated on the card from ``--seed``. At
   3 yr x 720 x 1440 daily (0.25 degree global): ``preprocess_data`` then
   ``tracker(R_fill=12, T_fill=4, area_filter_absolute=600,
   grid_resolution=0.25, ...)``: config 1 (fixed baseline, global 95th
   percentile, ``allow_merging=False``), config 2 (``DETECT_CONFIG2``, the
   same tracker on the last calendar year), then config 4 (config 1's
   detect, ``allow_merging=True, nn_partitioning=True,
   overlap_threshold=0.25`` and ``run(return_merges=True)``: the main path).
   Config 2's detect wall is then split by entry point, and its Hobday step
   by sub-step (CUDA events). Then config 5: 2 yr x 1,048,352 cells of a
   triangular mesh, config 1's detect on (time, cell) data and
   ``tracker(unstructured_grid=True, **TRACK_CONFIG5)``; and config 3:
   3 yr x 360 x 720 over lat 30..70, lon -30..40, config 1's detect and
   ``regional_tracker(..., **TRACK_CONFIG3)``. Then the out-of-core path:
   config 7 (config 2's detect streamed by ``preprocess_data_streamed`` from
   the SST in pinned host memory, ``memory_budget_mb=2048``, raw chunks, into
   a temporary store) held bit for bit against config 2's in-memory detect,
   and config 8 (config 4's extremes in a zarr store with 64-day chunks,
   tracked by ``run_streamed(memory_budget_mb=2048)``) held against config
   4's in-memory run like the phase-4 slices, its peak device memory within
   twice the budget. Config 1's run is repeated with the two-level event
   labelling forced, its ``ID_field`` bit-identical to the fused route's.
   Then config 6, bench's merge-dense stress (``config6_field``: 24 disk
   pairs that converge, merge and separate every 50 days, made on the card
   from bench's numpy centres, on a mask of ones) at bench's own shape, 200 x
   180 x 360, and at 200 x 720 x 1440: ``tracker(R_fill=2, T_fill=0,
   area_filter_quartile=0.0, nn_partitioning=True, overlap_threshold=0.3)``
   without and with merging, each after a warm run, with bench's keys (the
   two walls, the overhead, merges, dispatch counts, both stage walls) and
   the peaks; at bench's shape both runs are held bit for bit against the
   CPU's. Last, config 1 at six years, 2190 x 720 x 1440 (2,270,592,000 cells, past
   the fused 3-D labelling's int32 flat indices): detect, then everything
   but the extremes and the mask freed, then the tracker, which must take
   the two-level route (``ccl3d/edges``, ``ccl3d/union``, ``ccl3d/remap``)
   and give dense ids; its walls, stages, launches and the peaks after
   detect and over the track are printed. Each path is run with the
   kernels' launch counts set to 0 just before it and read just after, and
   must have launched the kernels it labels on and none of the others
   (config 5 the mesh kernels, the gridded paths ``ccl_step`` and
   ``pointer_jump``, and those that merge on the grid, configs 4, 6 and 8,
   also ``partition``; config 7, detect alone, labels nothing); config 4's
   partition launches must equal its ``partition`` dispatches, and every
   40th of its batches is kept (on the host) for phase 6;
6. the kernels on the paths' own labels: config 4's kept partition
   batches, each held against the plain version and timed (the kernels'
   own launches, the whole call, the plain version, and the column pass
   the port ran before the kernel, row-windowed as the tracker chose)
   beside the byte bound of the two label slices read and one written;
   the area filter's fixpoint on config 4's field, run by hand with each launch timed, and at its
   iterations 1, 6 and 12 the fused step and the jump timed beside the
   nearest single PyTorch calls and beside the unfused iteration as far as
   this tree still has it (the stencil alone, a clone, the jump and a full
   comparison: the iteration before the fusion without its hook kernel),
   which the fused iteration must beat; then config 1's 3-D fixpoint on its
   own input, its step timed at iterations 1, 6 and 12, and at 6 beside its
   plain version and ``max_pool3d``; then the mesh fixpoint on config 5's
   field, as numbered and with its cells renumbered by a random permutation
   from ``--seed`` (the same component counts): the list of active cells,
   each launch and the fixpoint's wall beside its bound, and at iterations
   1, 4 and 8 ``graph_step`` and ``graph_jump`` held against their plain
   versions on those labels (bit-identical) and timed beside their bounds,
   at 4 beside their plain versions, ``index_select`` of the table's rows,
   ``torch.take`` of the listed cells' neighbours and of the jump's targets
   and the hook's ``scatter_reduce_``; then a (2100, 1,048,352) field past
   2**31 cells, empty but for slices 2040-2099, which hold config 5's first
   60: labelled as those slices alone, bit for bit, and by hand with both
   mesh kernels held against their plain versions at every iteration; then
   the six-year field's filter fixpoint by
   hand, at iteration 6 its fused step and jump held against their plain
   versions (bit-identical) on the slices that hold cells past 2**31, where
   slice bases and hook targets need 64-bit offsets, then timed beside their
   byte bounds and ``max_pool2d`` on the same labels;
7. plotX on the paths' outputs, each held against its host copy bit for bit:
   config 4's ``ID_field`` and ``dat_anomaly`` (1095 x 720 x 1440) and config
   5's ``ID_field`` (730 x 1,048,352), each copied back to the card from the
   host copy phase 5 kept, and config 8's ``ID_field`` read lazily from its
   output store. The NaN-ignoring max (on the card also of an ID field's
   ``where(> 0)`` view) against ``np.nanmax``, the robust limits of every tenth slice
   against ``np.percentile`` with ``issym`` on and off, frames 0, T/2 and
   T-1 as drawn (an ID field masked), and on config 5 the wall of their
   1-degree kd-tree regrid; each step's wall and the bytes it brought to the
   host (of config 8, the chunk bytes it read from disk) beside what the
   reference's pattern pulls, and the phase's peak device memory, under 40 GB. With matplotlib,
   ``single_plot(plot_IDs=True)``, a 3-panel ``multi_plot`` and a 5-frame
   ``animate`` drawn from the card's payloads must equal those drawn from the
   host copies; without it, ``plotX()`` must raise ``DependencyError`` naming
   matplotlib;
8. the multi-device layer: a child process started with ``torchrun``'s
   variables for a world of one rank (``RANK=0 WORLD_SIZE=1 LOCAL_RANK=0``, a
   free port) joins it through ``start_distributed_cluster()`` (NCCL) and
   runs, each with ``mesh=True`` through the entry points: config 2's detect
   at 3 yr x 90 x 360 and config 5 at 2 yr x 32768 cells (each also without
   a mesh, in the child), then config 4 (the main path) and config 1 at 1095
   x 720 x 1440. Every output (digests of each array, computed on the card,
   and the attrs) must equal the run without a mesh: phase 5's for configs 4
   and 1. The split outputs must be DTensors, and each path must have
   launched the kernels it labels on and no other; each run's walls, peak
   and launches are printed. Then ``marex_tpu_torch.entry.dryrun_multichip(1)``
   joins the same world and runs its four drives (a grid run with merges,
   the shifting baseline with Hobday thresholds, an unstructured mesh, the
   streamed tracker): its counts must be the CPU's (``DRYRUN_PORT``: the
   reference's ``DRYRUN_REFERENCE`` but for the grid drive's detrend fit),
   and it must have launched both the grid and the mesh kernels;
9. the entry module (``marex_tpu_torch.entry``): ``entry()`` on the card
   against ``entry(device="cpu")``, labels and event count bit for bit,
   anomalies within 1e-5; then its fused detect+track step on config 1's
   SST at 1095 x 720 x 1440 (``year_idx = t // 365``, ``doy_idx = t %
   365``): its wall, launches and peak.

The line before the last is a JSON object with each kernel's launches on the
path that runs it (config 4; config 5 for the mesh kernels) and on every path
(``launches_by_path``: phase 8's mesh runs and dry run, config 6 and the
entry step included), its largest
difference from the plain version, and its time, its plain version's, its
bound and the nearest PyTorch call's on that path's own labels (phase 6);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
import torch

DETECT_FIXED = dict(
    method_anomaly="fixed_baseline",
    method_extreme="global_extreme",
    method_percentile="approximate",
    threshold_percentile=95,
)
# config 2, the reference's defaults at a 3-year block (bench.py:717-725): the
# shifting baseline over the 2 previous years, then Hobday thresholds with the
# default 5 x 5 spatial window; the trim keeps the last calendar year
DETECT_CONFIG2 = dict(
    method_anomaly="shifting_baseline",
    method_extreme="hobday_extreme",
    method_percentile="approximate",
    threshold_percentile=95,
    window_year_baseline=2,
    smooth_days_baseline=21,
    window_days_hobday=11,
)
# config 3, a regional domain (bench.py:746-778): config 1's detect over lat
# 30..70, lon -30..40, then the regional tracker without merging
REGION = dict(lat_range=(30.0, 70.0), lon_range=(-30.0, 40.0))
TRACK_CONFIG3 = dict(R_fill=8, T_fill=2, area_filter_absolute=50, allow_merging=False)
# config 5, an unstructured triangular mesh (bench.py:810-857): config 1's
# detect on (time, cell) data, then merge tracking over the neighbour table
MESH_DIMS = {"time": "time", "x": "ncells"}
MESH_COORDS = {"time": "time", "x": "lon", "y": "lat"}
TRACK_CONFIG5 = dict(
    R_fill=2,
    T_fill=2,
    area_filter_quartile=0.5,
    allow_merging=True,
    nn_partitioning=True,
    overlap_threshold=0.25,
    unstructured_grid=True,
    dimensions={"x": "ncells"},
    coordinates={"x": "lon", "y": "lat"},
    coordinate_units="degrees",
)
MESH_CELLS = 1048576  # an ICON-like cell count; the mesh below has 1,048,352 of them
MESH_DAYS = 730  # config 5's two years
BIG = 2**31 - 1
# config 6, the merge-dense stress (bench.py:860-923): disk pairs that converge,
# merge and separate every 50 days on a mask of ones, tracked with and without merging
CONFIG6_TRACK = dict(R_fill=2, T_fill=0, area_filter_quartile=0.0, nn_partitioning=True, overlap_threshold=0.3)
# the kernels each path labels on
GRID_KERNELS = ("ccl_step", "pointer_jump")
MESH_KERNELS = ("active_cells", "graph_step", "graph_jump")
# the paths that merge on a grid with nearest-cell partitioning, which also launch the partition kernel
GRID_MERGE_PATHS = ("merge path (config 4)", "config 6", "config 8")
# the counts that ``__graft_entry__.dryrun_multichip(n)`` prints, the same for n = 1, 2 and 4:
#   JAX_PLATFORMS=cpu python -c "import __graft_entry__ as g; g.dryrun_multichip(2)"
DRYRUN_REFERENCE = {"n_events": 34, "total_merges": 18, "shifting+hobday extremes": 4802,
                    "unstructured n_events": 2, "streamed n_events": 34}
# the port's (``marex_tpu_torch.entry.dryrun_multichip(2, device="cpu")``): its grid drive's
# detrended anomalies come from a float64 fit, the reference's from a float32 fit that strays
# 1.1e-2 on this 64-day series, so 130 of the 32768 cells flag otherwise there; the other
# drives' counts are the reference's
DRYRUN_PORT = {**DRYRUN_REFERENCE, "n_events": 37, "total_merges": 17, "streamed n_events": 37}


def make_sst(n_years: int, ny: int, nx: int, seed: int, device: str, lat_range=(-89.5, 89.5), lon_range=(0.0, 360.0),
             n_days: int = 0):
    """Synthetic daily SST (T, ny, nx) float32, generated on ``device``: AR(1)
    noise, a seasonal cycle, drifting warm blobs (days 60-140), converging
    blob pairs (days 150-270) and a NaN land block — the recipe of
    ``bench._make_data_impl``, with torch's generator in place of numpy's. A
    longitude range other than the full circle includes its end point (a
    regional grid). T is ``n_days`` when given, else ``n_years`` of days."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    times = pd.date_range("2000-01-01", periods=n_days or int(n_years * 365.25), freq="D").to_numpy()
    T = len(times)
    lat = np.linspace(lat_range[0], lat_range[1], ny)
    lon = np.linspace(lon_range[0], lon_range[1], nx, endpoint=lon_range != (0.0, 360.0))
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


def tri_mesh(n_cells: int):
    """Triangle-pair mesh on a lat/lon lattice, periodic in both directions:
    (neighbours (3, C) 1-based int32, lat (C,), lon (C,)) with
    C = 2 * gy * gx <= n_cells — the recipe of ``bench._tri_mesh``."""
    gx = int(np.sqrt(n_cells / 2))
    gy = max(n_cells // (2 * gx), 2)
    C = 2 * gy * gx
    jj, ii = np.mgrid[0:gy, 0:gx]
    lo = 2 * (jj * gx + ii)
    up = lo + 1

    def tid(j, i, upper):
        return (2 * ((j % gy) * gx + (i % gx)) + upper).astype(np.int32)

    nb = np.empty((3, C), dtype=np.int32)
    nb[0].reshape(gy, 2 * gx)[:, 0::2] = up
    nb[1].reshape(-1)[lo.ravel()] = tid(jj, ii - 1, 1).ravel()
    nb[2].reshape(-1)[lo.ravel()] = tid(jj - 1, ii, 1).ravel()
    nb[0].reshape(-1)[up.ravel()] = lo.ravel()
    nb[1].reshape(-1)[up.ravel()] = tid(jj, ii + 1, 0).ravel()
    nb[2].reshape(-1)[up.ravel()] = tid(jj + 1, ii, 0).ravel()

    lat_g = np.linspace(-60, 60, gy)
    lon_g = np.linspace(0, 360, gx, endpoint=False)
    lat_c = np.empty(C, np.float64)
    lon_c = np.empty(C, np.float64)
    lat_c[lo.ravel()] = np.broadcast_to(lat_g[:, None], (gy, gx)).ravel() - 0.2
    lat_c[up.ravel()] = np.broadcast_to(lat_g[:, None], (gy, gx)).ravel() + 0.2
    lon_c[lo.ravel()] = np.broadcast_to(lon_g[None, :], (gy, gx)).ravel()
    lon_c[up.ravel()] = np.broadcast_to(lon_g[None, :], (gy, gx)).ravel() + 0.2
    return nb + 1, lat_c, lon_c


@functools.lru_cache(maxsize=None)
def symmetrised(n_cells: int) -> np.ndarray:
    """The symmetrised 0-based (K', C) table of ``tri_mesh(n_cells)``, which
    the tracker labels on (made once a size)."""
    from marex_tpu_torch.track import _symmetrize_neighbours

    return _symmetrize_neighbours(tri_mesh(n_cells)[0] - 1)


def make_mesh_sst(n_years: int, n_cells: int, seed: int, device: str):
    """Synthetic daily SST (T, C) float32 on the triangle-pair mesh, generated
    on ``device``: AR(1) noise, a seasonal cycle, in two latitude bands a pair
    of warm patches that converge and join each season (days 60-140), and 40
    blinking blobs of log-spaced sizes — the recipe of
    ``bench._make_unstructured_impl``, with torch's generator for the noise.
    Returns (sst, coords, neighbours (3, C) 1-based int32, cell areas (C,))."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    nb, lat_c, lon_c = tri_mesh(n_cells)
    C = nb.shape[1]
    times = pd.date_range("2000-01-01", periods=int(n_years * 365.25), freq="D").to_numpy()
    T = len(times)
    idx = pd.DatetimeIndex(times)
    doy, years = idx.dayofyear.to_numpy(), idx.year.to_numpy()
    lat = torch.tensor(lat_c, dtype=torch.float32, device=device)
    lon = torch.tensor(lon_c, dtype=torch.float32, device=device)
    coslat = torch.cos(torch.deg2rad(lat))
    seas = torch.tensor(3.0 * np.cos(2 * np.pi * (doy - 30) / 365.25), dtype=torch.float32, device=device)

    sst = torch.empty((T, C), dtype=torch.float32, device=device)
    noise = torch.randn(C, generator=g, device=device)
    for t in range(T):
        if t:
            noise = 0.8 * noise + 0.6 * torch.randn(C, generator=g, device=device)
        sst[t] = noise + 15.0 + seas[t] * coslat

    def within(lat0: float, lon0: float, dlat: float, dlon: float) -> torch.Tensor:
        d = (lon - lon0).abs()
        return ((lat - lat0).abs() < dlat) & (torch.minimum(d, 360.0 - d) < dlon)

    for t in range(T):
        d, yr = int(doy[t]), int(years[t] - years.min())
        if 60 <= d <= 140:
            for lat0, lon0 in ((15.0, 40.0), (-15.0, 200.0)):
                for sgn in (-1, 1):
                    clon = ((lon0 + yr * 137.0) % 360.0 + sgn * max(60 - (d - 60) * 1.6, 8.0)) % 360.0
                    sst[t] += 5.0 * within(lat0, clon, 12.0, 18.0)
    rng = np.random.default_rng(seed + 1000)
    n_blobs = 40
    b_lat, b_lon = rng.uniform(-55, 55, n_blobs), rng.uniform(0, 360, n_blobs)
    b_rad = np.geomspace(1.5, 10.0, n_blobs)  # degrees
    on = rng.random((T, n_blobs)) < 0.25
    for i in range(n_blobs):
        cells = within(float(b_lat[i]), float(b_lon[i]), float(b_rad[i]), float(b_rad[i])).nonzero().squeeze(1)
        days = torch.from_numpy(np.nonzero(on[:, i])[0]).to(device)
        if cells.numel() and days.numel():
            sst[days[:, None], cells[None, :]] += 5.0
    coords = {"time": times, "lat": ("ncells", lat_c), "lon": ("ncells", lon_c)}
    return sst, coords, nb, np.full(C, 1.0e7, np.float32)


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


def cuda_ms_fresh(fn, reset, reps: int = 5) -> float:
    """Mean milliseconds of ``fn`` by CUDA events around each call alone,
    with ``reset`` (untimed) before each: for a kernel that updates its
    output in place. One untimed warm-up."""
    total = 0.0
    for rep in range(reps + 1):
        reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if rep:
            total += start.elapsed_time(end)
    return total / reps


# the H100 SXM data sheet's 3.35 TB/s, in bytes per millisecond
HBM_BYTES_PER_MS = 3.35e9


def bound_ms(n_bytes: float) -> float:
    """Least time to move ``n_bytes`` through device memory once."""
    return n_bytes / HBM_BYTES_PER_MS


class Split:
    """CUDA-event milliseconds of launches by name: each launch's, and their sums."""

    def __init__(self):
        self.pending, self.ms, self.each = [], {}, {}

    def time(self, name: str, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        self.pending.append((name, start, end))
        return out

    def settle(self) -> None:
        torch.cuda.synchronize()
        for name, start, end in self.pending:
            self.ms[name] = self.ms.get(name, 0.0) + start.elapsed_time(end)
            self.each.setdefault(name, []).append(round(start.elapsed_time(end), 4))
        self.pending.clear()


def fused_fixpoint(data: torch.Tensor, depth3: bool, split: Split, keep=(), neighbours=None):
    """A CCL fixpoint of ``ops/label.py`` run by hand, each launch timed
    into ``split``: on a (T, H, W) grid (``ccl_step``, ``pointer_jump``), or
    with ``neighbours`` (the symmetrised (K, C) table) on a (T, C) mesh (the
    list of active cells, ``active_cells``, then ``graph_step`` and
    ``graph_jump`` over it); returns (iterations, {k: (labels, out) before
    step k} for k in ``keep``)."""
    from marex_tpu_torch.ops.graph_step import active_cells, graph_jump, graph_step
    from marex_tpu_torch.ops.min_stencil import ccl_step, pointer_jump

    T = data.shape[0]
    S = data.numel() if depth3 else data[0].numel()
    if neighbours is None:
        name, step = "ccl_step", lambda: ccl_step(a, data, b, depth3=depth3)
        jump_name, jump = "pointer_jump", lambda: pointer_jump(b, S, out=a)
    else:
        active = split.time("active_cells", lambda: active_cells(data))
        name, step = "graph_step", lambda: graph_step(a, active, neighbours, b)
        jump_name, jump = "graph_jump", lambda: graph_jump(b, active, out=a)
    idx = torch.arange(S, dtype=torch.int32, device=data.device)
    a = (idx if depth3 else idx.repeat(T)).view(data.shape).masked_fill_(~data, BIG)
    b = torch.full_like(a, BIG)
    del idx
    snaps = {}
    for it in range(1, 200):
        if it in keep:
            snaps[it] = (a.clone(), b.clone())
        flag = split.time(name, step)
        changed = bool(flag.item())
        split.settle()
        if not changed:
            return it, snaps
        split.time(jump_name, jump)
    raise AssertionError("CCL fixpoint did not converge in 199 iterations")


def filter_input(mx, seed: int):
    """The area filter's input on the main path at 3 yr x 720 x 1440 (the
    field after fill_spatial and fill_time, the same on config 1 and config
    4), through the entry points; returns (field, config 1's tracker)."""
    sst, coords = make_sst(3, 720, 1440, seed, "cuda")
    ds = mx.preprocess_data(mx.Field(sst, ("time", "lat", "lon"), coords, name="sst"), device="cuda", quiet=True,
                            **DETECT_FIXED)
    del sst
    tr = mx.tracker(ds.extreme_events, ds.mask, device="cuda", quiet=True, **track_kwargs(720))
    del ds
    filled = tr.fill_time_gaps(tr.fill_holes(tr.data_bin.data)).contiguous()
    torch.cuda.synchronize()
    return filled, tr


def neg_padded(lab: torch.Tensor, wrap_x: bool = True, depth3: bool = False) -> torch.Tensor:
    """-lab as float32 (exact below 2**24; BIG becomes -2**31), padded by one
    ring of -inf (x wrapped when ``wrap_x``): the input on which one
    max-pool call gives -(3x3-min), or with ``depth3`` -(3x3x3-min)."""
    x = -lab.float()
    if wrap_x:
        x = torch.cat([x[..., -1:], x, x[..., :1]], dim=-1)
    else:
        x = torch.nn.functional.pad(x, (1, 1), value=float("-inf"))
    x = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1) if depth3 else (0, 0, 1, 1), value=float("-inf"))
    return x[None, None] if depth3 else x[:, None]


def hook_scatter_inputs(lab: torch.Tensor, m: torch.Tensor, slice_size: int):
    """(index, source) of the hook's scatter, as ``hook_plain`` forms them."""
    lab_f, m_f = lab.reshape(-1), m.reshape(-1)
    pos = ((lab_f != BIG) & (m_f < lab_f)).nonzero().squeeze(1)
    return pos - pos % slice_size + lab_f[pos].long(), m_f[pos]


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


def run_path(device: str, detect, make_tracker, merge: bool):
    """``detect()`` then ``make_tracker(ds).run(...)``, each ending in a
    synchronise; returns (ds, events, merges (None without merging), tracker,
    detect wall, track wall, detect peak)."""
    t0 = time.perf_counter()
    ds = detect()
    detect_peak = 0
    if device == "cuda":
        torch.cuda.synchronize()
        detect_peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    tr = make_tracker(ds)
    events, merges = tr.run(return_merges=True) if merge else (tr.run(), None)
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return ds, events, merges, tr, t1 - t0, t2 - t1, detect_peak


def run_slice(mx, sst, coords, device: str, ny: int, merge: bool = False, detect: dict = DETECT_FIXED):
    """detect + track on a global grid through the entry points."""
    field = mx.Field(sst, ("time", "lat", "lon"), coords, name="sst")
    return run_path(
        device,
        lambda: mx.preprocess_data(field, device=device, quiet=True, **detect),
        lambda ds: mx.tracker(ds.extreme_events, ds.mask, device=device, quiet=True, **track_kwargs(ny, merge)),
        merge,
    )


def run_mesh(mx, sst, coords, nb, areas, device: str):
    """Config 5 through the entry points: detect on (time, cell) data with
    the mesh's table and areas passed through, then the mesh tracker with
    merging."""
    field = mx.Field(sst, ("time", "ncells"), coords, name="sst")
    return run_path(
        device,
        lambda: mx.preprocess_data(
            field, dimensions=MESH_DIMS, coordinates=MESH_COORDS, neighbours=mx.Field(nb, ("nv", "ncells"), name="neighbours"),
            cell_areas=mx.Field(areas, ("ncells",), name="cell_areas"), device=device, quiet=True, **DETECT_FIXED,
        ),
        lambda ds: mx.tracker(ds.extreme_events, ds.mask, neighbours=ds.neighbours, cell_areas=ds.cell_areas,
                              device=device, quiet=True, **TRACK_CONFIG5),
        True,
    )


def run_regional(mx, sst, coords, device: str, track_kw: dict, days=None):
    """Config 3 through the entry points: config 1's detect, then
    ``regional_tracker`` (on the first ``days`` days when given)."""
    field = mx.Field(sst, ("time", "lat", "lon"), coords, name="sst")

    def make_tracker(ds):
        extremes = ds.extreme_events if days is None else ds.extreme_events.isel(time=np.arange(days))
        return mx.regional_tracker(extremes, ds.mask, "degrees", device=device, quiet=True, **track_kw)

    return run_path(device, lambda: mx.preprocess_data(field, device=device, quiet=True, **DETECT_FIXED), make_tracker,
                    track_kw["allow_merging"])


def compare_merge_runs(ev_g, mg_g, tr_g, ev_c, mg_c, what: str = "merge slice") -> dict:
    """A merge path on CUDA against the CPU: integer and boolean outputs and
    the merge records bit-identical, area and centroid within 1e-5 (relative,
    or absolute near 0: areas are km^2, on a mesh m^2); raises on any
    difference, and when no merge or no partition happened. Returns the
    largest float differences."""
    for key in ("ID_field", "global_ID", "presence", "merge_ledger", "time_start", "time_end"):
        if not np.array_equal(ev_g[key].values, ev_c[key].values):
            raise AssertionError(f"{what}: {key} differs between CUDA and CPU")
    for key in ("parent_IDs", "child_IDs", "overlap_areas", "merge_time", "n_parents", "n_children"):
        if not np.array_equal(mg_g[key].values, mg_c[key].values):
            raise AssertionError(f"{what}: merges {key} differs between CUDA and CPU")
    diff = {}
    for key in ("area", "centroid"):
        a, b = ev_g[key].values.astype(np.float64), ev_c[key].values.astype(np.float64)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{what}: {key} NaN pattern")
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f"{what}: {key}")
        fin = np.isfinite(a)
        d = np.abs(a[fin] - b[fin])
        diff[key] = (float(d.max()) if d.size else 0.0, float((d / np.maximum(np.abs(b[fin]), 1e-30)).max()) if d.size else 0.0)
    for key in ("N_events_final", "total_merges"):
        if ev_g.attrs[key] != ev_c.attrs[key]:
            raise AssertionError(f"{what}: {key} {ev_g.attrs[key]} (CUDA) vs {ev_c.attrs[key]} (CPU)")
    if ev_g.attrs["total_merges"] <= 0 or tr_g.dispatch_counts.get("partition", 0) <= 0:
        raise AssertionError(f"{what}: no merge or no partition ran: {ev_g.attrs}, {tr_g.dispatch_counts}")
    return diff


def check_event_ids(events, shape: tuple) -> int:
    """``ID_field`` is int32 of ``shape`` and holds the ids 0..N_events_final,
    with at least one event. Returns N."""
    n = int(events.attrs["N_events_final"])
    ids = events["ID_field"].data
    if tuple(ids.shape) != tuple(shape) or ids.dtype != torch.int32:
        raise AssertionError(f"ID_field has shape {tuple(ids.shape)} and dtype {ids.dtype}")
    if n <= 0 or int(ids.max()) != n or int(ids.min()) != 0:
        raise AssertionError(f"ID_field range [{int(ids.min())}, {int(ids.max())}] vs N_events_final {n}")
    return n


def check_merge_outputs(events, merges, shape: tuple) -> int:
    """A merge path's outputs are whole: ids 0..N over the field of ``shape``,
    a (time, ID) table that marks exactly the present events, finite positive
    areas and in-range centroids where an event is present. Returns N."""
    n = check_event_ids(events, shape)
    T = shape[0]
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
    two_level_against_fused(mx, ds_g, ev_g, ev_c, ny, device)
    field_ops_against_cpu(mx, ds_g["dat_anomaly"], ds_c["dat_anomaly"], ds_g["extreme_events"])
    del ds_g, ev_g, tr_g, ds_c, ev_c, tr_c

    ds_g, ev_g, mg_g, tr_g, det_g, trk_g, _ = run_slice(mx, sst, coords, device, ny, merge=True)
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
    streamed_slice(mx, ds_g, ev_g, mg_g, ev_c, mg_c, 256, f"config 4 slice 3yr x {ny} x {nx}",
                   lambda ev: mx.tracker(ev, ds_g.mask, device=device, quiet=True, **track_kwargs(ny, True)))
    midlevel_against_cpu(mx, ds_g, ny, device)
    del ds_g, ev_g, mg_g, tr_g, ev_c, mg_c, tr_c
    detect_methods_against_cpu(mx, sst, sst_cpu, coords, ny, nx, seed, device)


@contextlib.contextmanager
def forced_two_level(mx):
    """A context in which the tracker labels events in two levels at any
    size (``track.TWO_LEVEL_CELLS`` lowered to 1)."""
    saved = mx.track.TWO_LEVEL_CELLS
    mx.track.TWO_LEVEL_CELLS = 1
    try:
        yield
    finally:
        mx.track.TWO_LEVEL_CELLS = saved


def two_level_against_fused(mx, ds, ev_fused, ev_cpu, ny: int, device: str) -> None:
    """Phase 4: config 1's tracker on the slice's extremes with the two-level
    route forced, on the card: ``ID_field`` and attrs bit-identical to the
    fused route's on the card and to the CPU's."""
    with forced_two_level(mx):
        tr = mx.tracker(ds.extreme_events, ds.mask, device=device, quiet=True, **track_kwargs(ny))
        ev = tr.run()
    if "ccl3d/edges" not in tr.stage_walls:
        raise AssertionError(f"two-level slice: the two-level route was not taken: {tr.stage_walls}")
    for what, other in (("fused on the card", ev_fused), ("CPU", ev_cpu)):
        if not np.array_equal(ev["ID_field"].values, other["ID_field"].values) or ev.attrs != other.attrs:
            raise AssertionError(f"two-level slice: ID_field or attrs differ from the {what}")
    print(f"two-level slice {tuple(ds.extreme_events.shape)}: forced two-level ID_field == fused on the card == CPU "
          f"(bit-identical), N_events_final {ev.attrs['N_events_final']}; ccl3d stages "
          f"{json.dumps({k: v for k, v in tr.stage_walls.items() if k.startswith('ccl3d')})}")


def field_ops_against_cpu(mx, anom_g, anom_c, ext_g) -> None:
    """Phase 4: ``Field`` reductions and operators on CUDA payloads against
    the same on CPU copies: integer and bool results bit-identical, float
    results within 1e-5 relative (reduction order differs), every result on
    the payload's device."""
    ext_c = mx.Field(ext_g.data.cpu(), ext_g.dims, ext_g.coords, ext_g.name, ext_g.attrs)
    # sums and means of a positive field: the anomalies' own sum over time is
    # about 0, where float32 reductions in another order differ in every digit
    cases = {
        "sum time": lambda a, e: (a + 20.0).sum("time", skipna=True),
        "mean": lambda a, e: (a + 20.0).mean(("lat", "lon")),
        "std time": lambda a, e: a.std("time"),
        "max": lambda a, e: a.max("time"),
        "min": lambda a, e: a.min(),
        "quantile": lambda a, e: a.quantile(0.9, "time"),
        "count": lambda a, e: a.count("time"),
        "argmax": lambda a, e: a.argmax("time"),
        "where": lambda a, e: a.where(e, -1.0),
        "add, mul": lambda a, e: (a * 2.0 + 1.0),
        "gt": lambda a, e: a > 0.5,
        "and": lambda a, e: e & (a > 0.0),
        "extremes sum": lambda a, e: e.sum(("lat", "lon")),
        "extremes any": lambda a, e: e.any("time"),
    }
    worst = 0.0
    for name, fn in cases.items():
        g, c = fn(anom_g, ext_g), fn(anom_c, ext_c)
        if not isinstance(g.data, torch.Tensor) or g.data.device.type != "cuda" or g.dims != c.dims:
            raise AssertionError(f"Field {name}: result not on the card, or dims {g.dims} vs {c.dims}")
        a, b = g.values, c.values
        if a.dtype != b.dtype:
            raise AssertionError(f"Field {name}: dtype {a.dtype} (CUDA) vs {b.dtype} (CPU)")
        if a.dtype.kind != "f":
            if not np.array_equal(a, b):
                raise AssertionError(f"Field {name}: CUDA differs from the CPU")
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"Field {name}: NaN pattern")
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=f"Field {name}")
        fin = np.isfinite(b) & (b != 0)
        worst = max(worst, float(np.max(np.abs(a[fin] - b[fin]) / np.abs(b[fin]))) if fin.any() else 0.0)
    print(f"Field operations on CUDA payloads ({len(cases)} cases on {tuple(anom_g.shape)}): == CPU (integers and bools "
          f"bit-identical, floats within 1e-5 relative; largest {worst:.3g})")


def midlevel_against_cpu(mx, ds, ny: int, device: str, days: int = 120) -> None:
    """Phase 4: the tracker's mid-level API with config 4's settings on the
    first ``days`` days of config 4's slice, on the card and on the CPU:
    ``identify_objects`` (per slice, and with time connectivity by both
    routes), ``calculate_object_properties``, ``find_overlapping_objects``,
    ``check_overlap_slice`` and ``mask_values``, bit for bit."""
    ext = ds.extreme_events.isel(time=np.arange(days))
    out = {}
    for d in (device, "cpu"):
        tr = mx.tracker(ext if d == device else ext.to("cpu"), ds.mask if d == device else ds.mask.to("cpu"),
                        device=d, quiet=True, **track_kwargs(ny, True))
        lab, _, n = tr.identify_objects(ext)
        lab3, _, n3 = tr.identify_objects(ext, time_connectivity=True)
        with forced_two_level(mx):
            lab3_two, _, n3_two = tr.identify_objects(ext, time_connectivity=True)
        if n3_two != n3 or not torch.equal(lab3_two.data, lab3.data):
            raise AssertionError(f"identify_objects on {d}: the two-level route differs from the fused one")
        props = tr.calculate_object_properties(lab)
        t = int(torch.argmax((lab.data.flatten(1) > 0).sum(1)))
        out[d] = dict(
            labels=lab.values, n=n, events=lab3.values, n_events=n3, area=props["area"].values,
            centroid=props["centroid"].values, ids=props["area"].coords["ID"].values,
            overlaps=tr.find_overlapping_objects(lab), slice_pair=tr.check_overlap_slice(lab.data[t], lab.data[t + 1]),
            mask=tr.mask_values,
        )
    for key, val in out[device].items():
        other = out["cpu"][key]
        if not (val == other if np.isscalar(val) else same_bits(np.asarray(val), np.asarray(other))):
            raise AssertionError(f"mid-level API: {key} differs between CUDA and CPU")
    if out[device]["n"] <= 0 or len(out[device]["overlaps"]) == 0:
        raise AssertionError("mid-level API: no objects or no overlaps on the slice")
    print(f"mid-level API on config 4's slice, {days} days: CUDA == CPU (bit-identical: {', '.join(out[device])}); "
          f"{out[device]['n']} objects, {out[device]['n_events']} events, {len(out[device]['overlaps'])} overlap pairs; "
          f"time-connected ids equal by both routes")


def streamed_slice(mx, ds, ev_mem, mg_mem, ev_cpu, mg_cpu, block_T: int, what: str, make_tracker) -> None:
    """Phase 4, streamed tracking of a slice's extremes on the card: the
    field written to a zarr store with ``block_T``-day chunks, opened lazily
    and tracked by ``run_streamed`` in at least 4 blocks of ``block_T``;
    held like ``compare_merge_runs`` against the in-memory run on the card
    and against the CPU's."""
    from marex_tpu_torch.io import zarr_lite

    work = tempfile.mkdtemp(prefix="marex_smoke_")
    try:
        src = os.path.join(work, "extremes.zarr")
        zarr_lite.to_zarr(ds.extreme_events, src, chunks={"time": block_T})
        tr = make_tracker(zarr_lite.open_zarr(src, lazy=True)["extreme_events"])
        t0 = time.perf_counter()
        ev, mg = tr.run_streamed(os.path.join(work, "events.zarr"), block_T=block_T, return_merges=True)
        wall = time.perf_counter() - t0
        if tr.dispatch_counts.get("march_block", 0) < 4:
            raise AssertionError(f"{what}: streamed in fewer than 4 blocks: {tr.dispatch_counts}")
        d_mem = compare_merge_runs(ev, mg, tr, ev_mem, mg_mem, f"{what} streamed vs in-memory")
        d_cpu = compare_merge_runs(ev, mg, tr, ev_cpu, mg_cpu, f"{what} streamed vs CPU")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"{what} streamed in {tr.dispatch_counts['march_block']} blocks of {block_T} days: == in-memory on the card "
          f"and == CPU (ID_field, global_ID, presence, merge_ledger, time_start/end and merge records bit-identical; "
          f"max |diff| (abs, rel) vs in-memory area {d_mem['area']}, centroid {d_mem['centroid']}; vs CPU area "
          f"{d_cpu['area']}, centroid {d_cpu['centroid']}); N_events_final {ev.attrs['N_events_final']}, total_merges "
          f"{ev.attrs['total_merges']}; wall {wall:.3f} s; stage_walls {json.dumps(tr.stage_walls)}")


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal dtype and values, NaN where NaN."""
    return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def detect_methods_against_cpu(mx, sst, sst_cpu, coords, ny: int, nx: int, seed: int, device: str) -> None:
    """Phase 4, the other detect methods on ``device`` and on the CPU: config
    2 (shifting baseline + approximate Hobday thresholds, then the no-merge
    tracker) on a field of its own with half the rows and the full width
    (the CPU's dense Hobday histogram takes minutes at 180 x 360; at 90 x 360
    the CPU still cuts it into square tiles whose halos cross the lon seam,
    the card into full-width row bands) with ``dat_anomaly``, ``thresholds``,
    ``extreme_events``, ``mask`` and ``ID_field`` bit-identical; the exact
    percentile (Hobday and global, on the fixed baseline) with thresholds and extremes
    bit-identical; ``detrend_harmonic`` with ``std_normalise`` with floats
    within 1e-5 and each differing extreme within 1e-5 of its threshold."""
    half, half_coords = make_sst(3, ny // 2, nx, seed, device)
    ds_g, ev_g, _, _, det_g, trk_g, _ = run_slice(mx, half, half_coords, device, ny // 2, detect=DETECT_CONFIG2)
    ds_c, ev_c, _, _, det_c, trk_c, _ = run_slice(mx, half.cpu(), half_coords, "cpu", ny // 2, detect=DETECT_CONFIG2)
    del half
    for key in ("dat_anomaly", "thresholds", "extreme_events", "mask"):
        if not same_bits(ds_g[key].values, ds_c[key].values):
            raise AssertionError(f"config 2 slice: {key} differs between CUDA and CPU")
    if not np.array_equal(ev_g["ID_field"].values, ev_c["ID_field"].values) or ev_g.attrs != ev_c.attrs:
        raise AssertionError("config 2 slice: ID_field or attrs differ between CUDA and CPU")
    n_ext = int(ds_g["extreme_events"].data.sum())
    print(f"config 2 slice {tuple(ds_g['dat_anomaly'].shape)}: CUDA == CPU (dat_anomaly, thresholds, extreme_events, "
          f"mask, ID_field bit-identical); {n_ext} extreme cells, N_events_final {ev_g.attrs['N_events_final']}; "
          f"cuda detect {det_g:.3f} s track {trk_g:.3f} s; cpu detect {det_c:.3f} s track {trk_c:.3f} s")
    del ds_g, ev_g, ds_c, ev_c

    field = {d: mx.Field(x, ("time", "lat", "lon"), coords, name="sst") for d, x in ((device, sst), ("cpu", sst_cpu))}
    for method_extreme in ("hobday_extreme", "global_extreme"):
        kw = dict(method_anomaly="fixed_baseline", method_extreme=method_extreme, method_percentile="exact")
        walls, out = {}, {}
        for d in (device, "cpu"):
            t0 = time.perf_counter()
            out[d] = mx.preprocess_data(field[d], device=d, quiet=True, **kw)
            if d == "cuda":
                torch.cuda.synchronize()
            walls[d] = time.perf_counter() - t0
        for key in ("thresholds", "extreme_events"):
            if not same_bits(out[device][key].values, out["cpu"][key].values):
                raise AssertionError(f"exact {method_extreme}: {key} differs between CUDA and CPU")
        print(f"exact percentile, {method_extreme}: CUDA == CPU (thresholds, extreme_events bit-identical); "
              f"detect cuda {walls[device]:.3f} s, cpu {walls['cpu']:.3f} s")
        del out

    kw = dict(method_anomaly="detrend_harmonic", std_normalise=True, method_extreme="global_extreme",
              method_percentile="approximate")
    out = {d: mx.preprocess_data(field[d], device=d, quiet=True, **kw) for d in (device, "cpu")}
    g, c = out[device], out["cpu"]
    diffs = {}
    for key in ("dat_anomaly", "dat_stn", "STD", "thresholds", "thresholds_stn"):
        a, b = g[key].values, c[key].values
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"detrend + std_normalise: {key} NaN pattern differs")
        diffs[key] = float(np.nanmax(np.abs(a.astype(np.float64) - b))) if np.isfinite(a).any() else 0.0
        if diffs[key] > 1e-5:
            raise AssertionError(f"detrend + std_normalise: {key} differs by {diffs[key]} > 1e-5")
    n_diff = {}
    for anom, ext, thr in (("dat_anomaly", "extreme_events", "thresholds"),
                           ("dat_stn", "extreme_events_stn", "thresholds_stn")):
        diff = g[ext].values != c[ext].values
        n_diff[ext] = int(diff.sum())
        gap = np.abs(c[anom].values - np.broadcast_to(c[thr].values, diff.shape))[diff]
        if gap.size and gap.max() > 1e-5:
            raise AssertionError(f"detrend + std_normalise: an {ext} cell {gap.max()} from its threshold differs")
    print(f"detrend_harmonic + std_normalise: CUDA vs CPU max |diff| {json.dumps(diffs)}; differing extreme cells "
          f"{json.dumps(n_diff)} (each within 1e-5 of its threshold)")


def hobday_split(mx, ds, tinfo) -> dict:
    """Config 2's Hobday step on the main run's own anomalies, run by hand
    with CUDA events around each sub-step, summed over the histogram's
    tiles: the binning (digitize, then the (Y, 366, S) scatter), and per
    tile the (dayofyear, bin) histogram, the spatial window, the day-of-year
    window and the count-space quantile; then the comparison of the
    anomalies with the main run's thresholds of their day. Returns
    {sub-step: ms}, the tile count and shape, and the bins' bytes."""
    from marex_tpu_torch.core.timeaxis import scatter_to_year_doy
    from marex_tpu_torch.ops import pipeline as p
    from marex_tpu_torch.ops import quantile as q

    anom = ds["dat_anomaly"].data
    T, ny, nx = anom.shape
    edges = q.make_bin_edges(0.01, 5.0)
    nbins = len(edges) - 1
    centers = torch.from_numpy(q.make_bin_centers(edges)).cuda()
    split = Split()
    bins = split.time("binning", lambda: scatter_to_year_doy(q.digitize_anomalies(anom.view(T, -1), 0.01, nbins),
                                                            tinfo, fill=nbins))
    n_tiles = 0
    for tile, _, _ in q.hobday_tiles(bins, nbins, (ny, nx), 2, True, q._HIST_TILE_BYTES["cuda"]):
        Y, D, th, tw = tile.shape
        hist = split.time("histogram", lambda: q.histogram_doy_bins(tile.reshape(Y, D, th * tw), nbins))
        hist = split.time("spatial window", lambda: q.pool_tile_spatial(hist.view(D, th, tw, nbins), 2))
        hist = split.time("doy window", lambda: q.rolling_doy_window_sum(hist, 11))
        split.time("quantile", lambda: q.histogram_quantile_counts(hist, 0.95, centers))
        del hist
        split.settle()
        n_tiles += 1
    thr = ds["thresholds"].data.view(366, -1)
    extremes = torch.empty(anom.shape, dtype=torch.bool, device=anom.device).view(T, -1)
    split.time("compare", lambda: p.doy_op(torch.ge, anom.view(T, -1), thr, tinfo.dayofyear - 1, extremes))
    split.settle()
    if not torch.equal(extremes.view(anom.shape), ds["extreme_events"].data):
        raise AssertionError("config 2: the comparison by hand differs from the main run's extremes")
    return {"ms": {k: round(v, 3) for k, v in split.ms.items()}, "tiles": n_tiles, "tile_shape": [th, tw],
            "bins_bytes": bins.numel() * bins.element_size()}


def main_paths(mx, ny: int, nx: int, seed: int, kernels: dict, device: str):
    """Phase 5: config 1, config 2, then the merge path (config 4), at
    3 yr x ny x nx generated on ``device``, each with the kernels' launch
    counts set to 0 just before it and read just after. Prints each path's
    walls, counts and memory, and config 2's detect split; returns ({path:
    launch counts}, host copies of the SST (pinned), config 2's detect
    outputs and config 4's extremes, mask and outputs, for the streamed
    paths; config 4's ``ID_field`` and ``dat_anomaly`` for phase 7)."""
    from marex_tpu_torch.core.timeaxis import decompose_time

    t0 = time.perf_counter()
    sst, coords = make_sst(3, ny, nx, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"data: {tuple(sst.shape)} generated on the card in {time.perf_counter() - t0:.1f} s")
    launches = {}
    refs = {"coords": coords, "digests": {}}
    paths = (("config 1", DETECT_FIXED, False), ("config 2", DETECT_CONFIG2, False),
             ("merge path (config 4)", DETECT_FIXED, True))
    for path, detect, merge in paths:
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launch_count = 0
        with kept_partitions(40, refs.setdefault("partition batches", [])) if merge else contextlib.nullcontext():
            ds, events, merges, tr, t_det, t_trk, detect_peak = run_slice(mx, sst, coords, device, ny, merge, detect)
        launches[path] = {k: fn.launch_count for k, fn in kernels.items()}
        if launches[path]["partition"] != tr.dispatch_counts.get("partition", 0):
            raise AssertionError(f"{path}: {launches[path]['partition']} partition launches for "
                                 f"{tr.dispatch_counts.get('partition', 0)} partition dispatches")
        thr, mask = ds["thresholds"].data, ds["mask"].data
        if not bool(torch.isfinite(thr[..., mask]).all()):
            raise AssertionError("non-finite thresholds over the ocean")
        T = ds["extreme_events"].shape[0]
        if merge:
            check_merge_outputs(events, merges, (T, ny, nx))
        else:
            check_event_ids(events, (T, ny, nx))
        report_path(f"{path} {sst.shape[0]} x {ny} x {nx} (tracked {T} days)", sst.numel(), events, tr, t_det, t_trk,
                    detect_peak, launches[path])
        if detect is DETECT_FIXED:  # phase 8's mesh runs of configs 1 and 4 must give these bits
            refs["digests"][path] = digests(ds, events, merges)
        if path == "config 1":
            two_level_full_size(mx, ds, events, ny)
        if detect is DETECT_CONFIG2:
            refs["config 2"] = {k: ds[k].values for k in ("dat_anomaly", "extreme_events", "thresholds", "mask")}
        if merge:
            refs["config 4"] = dict(
                extremes=ds["extreme_events"].values, mask=ds["mask"].values, peak=torch.cuda.max_memory_allocated(),
                wall=t_trk, events={k: events[k].values for k in events.data_vars}, attrs=dict(events.attrs),
                merges={k: merges[k].values for k in merges.data_vars},
            )
            # phase 7's payloads, kept on the host: held on the card through the six-year
            # path they would lift its peak over the 40 GB limit
            refs["plot"] = {"config 4": dict(ID_field=refs["config 4"]["events"]["ID_field"],
                                             dat_anomaly=ds["dat_anomaly"].values, coords=coords)}
        del events, merges, tr, thr, mask
        if detect is DETECT_CONFIG2:
            config2_detect_split(mx, sst, coords, ds, decompose_time(ds.coords["time"].values))
        del ds
    refs["sst"] = torch.empty(sst.shape, dtype=sst.dtype, pin_memory=True).copy_(sst)
    return launches, refs


def two_level_full_size(mx, ds, events, ny: int) -> None:
    """Phase 5: config 1's tracker again on its own extremes at full size,
    with the two-level route forced: ``ID_field`` and attrs bit-identical to
    the fused route's run just before."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with forced_two_level(mx):
        tr = mx.tracker(ds.extreme_events, ds.mask, device="cuda", quiet=True, **track_kwargs(ny))
        ev = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if "ccl3d/edges" not in tr.stage_walls:
        raise AssertionError(f"config 1, forced two-level: the two-level route was not taken: {tr.stage_walls}")
    if not torch.equal(ev["ID_field"].data, events["ID_field"].data) or ev.attrs != events.attrs:
        raise AssertionError("config 1, forced two-level: ID_field or attrs differ from the fused route's")
    print(f"  forced two-level at {tuple(ds.extreme_events.shape)}: ID_field == the fused route's (bit-identical); "
          f"track {wall:.3f} s; ccl3d stages {json.dumps({k: v for k, v in tr.stage_walls.items() if 'ccl3d' in k})}")


# config 1 at six years of days: 2,270,592,000 cells at 720 x 1440, past the
# fused 3-D labelling's int32 flat indices, so its events are labelled in two levels
LONG_DAYS = 2190


def long_nomerge_path(mx, seed: int, kernels: dict):
    """Phase 5, config 1 at 2190 x 720 x 1440 through ``preprocess_data`` and
    ``tracker(...).run()``, with the kernels' launch counts set to 0 just
    before it and read just after: everything but the extremes and the mask
    is freed before tracking; the run must take the two-level route and give
    dense ids. Prints the walls, every stage, the peaks after detect and over
    the track; returns (launch counts, the tracker, for phase 6)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sst, coords = make_sst(0, 720, 1440, seed, "cuda", n_days=LONG_DAYS)
    torch.cuda.synchronize()
    n_in = sst.numel()
    print(f"config 1 at {LONG_DAYS} days: data {tuple(sst.shape)} ({n_in} cells) generated on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launch_count = 0
    t0 = time.perf_counter()
    ds = mx.preprocess_data(mx.Field(sst, ("time", "lat", "lon"), coords, name="sst"), device="cuda", quiet=True,
                            **DETECT_FIXED)
    torch.cuda.synchronize()
    t_det = time.perf_counter() - t0
    detect_peak = torch.cuda.max_memory_allocated()
    thr, ocean = ds["thresholds"].data, ds["mask"].data
    if not bool(torch.isfinite(thr[..., ocean]).all()):
        raise AssertionError(f"config 1 at {LONG_DAYS} days: non-finite thresholds over the ocean")
    extremes, mask = ds.extreme_events, ds.mask
    del sst, ds, thr, ocean
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    tr = mx.tracker(extremes, mask, device="cuda", quiet=True, **track_kwargs(720))
    events = tr.run()
    torch.cuda.synchronize()
    t_trk = time.perf_counter() - t1
    counts = {k: fn.launch_count for k, fn in kernels.items()}
    if "ccl3d/edges" not in tr.stage_walls:
        raise AssertionError(f"config 1 at {LONG_DAYS} days: the two-level route was not taken: {tr.stage_walls}")
    check_event_ids(events, (LONG_DAYS, 720, 1440))
    report_path(f"config 1 at {LONG_DAYS} x 720 x 1440 (two-level ccl3d)", n_in, events, tr, t_det, t_trk, detect_peak,
                counts)
    print(f"  peak over the track (max_memory_allocated from the tracker's start, the extremes and mask held: "
          f"{held / 2**30:.2f} GiB) {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; ccl3d sub-stages "
          f"{json.dumps({k: v for k, v in tr.stage_walls.items() if 'ccl3d' in k})}")
    del events
    return counts, tr


def long_path_labels(tr) -> dict:
    """Phase 6, the 2190-day path's own labels: the area filter's fixpoint
    on its field (refilled from the tracker's extremes), run by hand with
    each launch timed; at iteration 6 both kernels held against their plain
    versions (tolerance 0) on the slices that hold cells past 2**31 (whose
    slice bases and hook targets need 64-bit offsets), the fused step and
    the jump timed beside their byte bounds, and ``max_pool2d`` on the same
    labels (in batches of slices under 2**31 elements, summed). Returns
    {kernel: max abs difference}."""
    from marex_tpu_torch.ops.min_stencil import ccl_step, ccl_step_plain, pointer_jump, pointer_jump_plain

    torch.cuda.empty_cache()
    data = tr.fill_time_gaps(tr.fill_holes(tr.data_bin.data)).contiguous()
    T, H, W = data.shape
    S, N = H * W, data.numel()
    split = Split()
    iters, snaps = fused_fixpoint(data, False, split, keep=(6,))
    print(f"filter fixpoint on the {T}-day field ({int(data.sum())} active cells of {N}): {iters} iterations; summed "
          f"launch ms {json.dumps(split.ms)}")
    a, b = snaps.pop(6)
    out = torch.empty_like(a)
    t_step = cuda_ms_fresh(lambda: ccl_step(a, data, out), lambda: out.copy_(b), reps=3)
    hooked = b.clone()
    flag = int(ccl_step(a, data, hooked))
    # the plain versions on the slices from the first that holds cell 2**31 on
    far = 2**31 // S
    jumped = pointer_jump(hooked, S, out=out)[far:].clone()
    want = b[far:].clone()
    flag_far = int(ccl_step_plain(a[far:], data[far:], want))
    n_lowered = int((want != b[far:]).sum())
    err = {"ccl_step": max(max_abs_diff(hooked[far:], want), int(flag_far and not flag)),
           "pointer_jump": max_abs_diff(jumped, pointer_jump_plain(hooked[far:], S))}
    del want, jumped
    if any(err.values()) or not n_lowered:
        raise AssertionError(f"{T}-day iteration 6, slices {far}..{T - 1}: kernels against their plain versions "
                             f"{err}, {n_lowered} cells lowered by the step")
    print(f"{T}-day iteration 6: ccl_step and pointer_jump bit-identical to their plain versions (tolerance 0) on "
          f"slices {far}..{T - 1} (bases {far * S}..{(T - 1) * S}; {n_lowered} cells lowered by the step there)")
    t_jump = cuda_ms(lambda: pointer_jump(hooked, S, out=out), reps=3)
    del hooked, out, b
    torch.cuda.empty_cache()
    t_pool = 0.0
    step = (2**31 - 1) // ((H + 2) * (W + 2))
    for t0 in range(0, T, step):
        xp = neg_padded(a[t0 : t0 + step])
        t_pool += cuda_ms(lambda: torch.nn.functional.max_pool2d(xp, 3, stride=1), reps=3)
        del xp
    print(f"{T}-day iteration 6: ccl_step {t_step:.4f} ms (bound {bound_ms(9 * N):.4f} ms, 9 B a cell), pointer_jump "
          f"{t_jump:.4f} ms (bound {bound_ms(8 * N):.4f} ms); max_pool2d on the same labels {t_pool:.4f} ms "
          f"(in batches of {step} slices)")
    del a, data
    torch.cuda.empty_cache()
    return err


def config2_detect_split(mx, sst, coords, ds, tinfo) -> None:
    """Config 2's detect wall split by entry point (the anomaly, then the
    trim and the extremes), and its Hobday step by sub-step (``hobday_split``)
    beside the least time the card could take to read its bins and write
    its thresholds, and the bytes of one pass over the dense histogram."""
    torch.cuda.empty_cache()
    field = mx.Field(sst, ("time", "lat", "lon"), coords, name="sst")
    shift = {k: DETECT_CONFIG2[k] for k in ("method_anomaly", "window_year_baseline", "smooth_days_baseline")}
    hobday = {k: v for k, v in DETECT_CONFIG2.items() if k not in shift}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    anom = mx.compute_normalised_anomaly(field, device="cuda", **shift)["dat_anomaly"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    keep = np.nonzero(pd.DatetimeIndex(coords["time"]).year >= pd.DatetimeIndex(coords["time"]).year.min() + 2)[0]
    mx.identify_extremes(anom.isel(time=keep), device="cuda", quiet=True, **hobday)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del anom
    sub = hobday_split(mx, ds, tinfo)
    T, ny, nx = ds["dat_anomaly"].shape
    S = ny * nx
    out_bytes = 366 * S * 4
    print(f"  config 2 detect split: anomaly (compute_normalised_anomaly) {t1 - t0:.3f} s; trim + extremes "
          f"(identify_extremes) {t2 - t1:.3f} s")
    print(f"  config 2 Hobday step by hand (CUDA events, summed over {sub['tiles']} tiles of {sub['tile_shape']} "
          f"cells with halos): {json.dumps(sub['ms'])} ms; total {sum(sub['ms'].values()):.3f} ms; bound "
          f"{bound_ms(sub['bins_bytes'] + out_bytes):.4f} ms (bins read once, thresholds written once, bytes); one "
          f"pass over the dense (366, S, nbins + 1) int32 histogram {366 * S * 503 * 4 / 1e9:.1f} GB = "
          f"{bound_ms(366 * S * 503 * 4):.1f} ms")


def main_path_labels(mx, seed: int) -> dict:
    """Phase 6: the area filter's fixpoint on the main path's field, run by
    hand with each launch timed; at its iterations 1, 6 and 12 the fused
    step and the jump timed beside the nearest single PyTorch calls (never
    called by the port) and beside the unfused iteration as far as this
    tree has it (stencil alone, clone, jump, full comparison: the iteration
    before the fusion without its hook kernel), which the fused one must
    beat. Returns the JSON fields of both kernels at iteration 6."""
    from marex_tpu_torch.ops.min_stencil import ccl_step, ccl_step_plain, min_stencil, pointer_jump, pointer_jump_plain

    data, tr = filter_input(mx, seed)
    T, H, W = data.shape
    S, N = H * W, data.numel()
    split = Split()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters, snaps = fused_fixpoint(data, False, split, keep=(1, 6, 12))
    wall = time.perf_counter() - t0
    print(f"filter fixpoint on the main path's field ({int(data.sum())} active cells): {iters} iterations, "
          f"wall {wall:.4f} s; summed launch ms {json.dumps(split.ms)}")
    print(f"  each launch (ms): {json.dumps(split.each)}")
    result = {}
    out = torch.empty_like(data, dtype=torch.int32)
    for k in sorted(snaps):
        a, b = snaps.pop(k)
        hooked = b.clone()
        ccl_step(a, data, hooked)  # the step's result: the jump's input
        t_step = cuda_ms_fresh(lambda: ccl_step(a, data, out), lambda: out.copy_(b))
        t_jump = cuda_ms(lambda: pointer_jump(hooked, S, out=out), reps=5)

        def unfused():
            new = pointer_jump(min_stencil(a, data).clone(), S)
            return torch.equal(new, a)

        t_unfused = cuda_ms(unfused, reps=5)
        t_alone = cuda_ms(lambda: min_stencil(a, data), reps=5)  # the same kernel with plain stores, no hook
        xp = neg_padded(a)
        t_pool = cuda_ms(lambda: torch.nn.functional.max_pool2d(xp, 3, stride=1), reps=5)
        del xp
        flat = hooked.view(T, S)
        gidx = torch.where(flat != BIG, flat, 0).long()
        t_gather = cuda_ms(lambda: torch.gather(flat, 1, gidx), reps=5)
        del gidx
        m = min_stencil(a, data)
        sidx, src = hook_scatter_inputs(a, m, S)
        buf = m.clone().view(-1)
        t_scatter = cuda_ms_fresh(lambda: buf.scatter_reduce_(0, sidx, src, "amin"), lambda: buf.copy_(m.view(-1)))
        n_hooks = sidx.numel()
        del m, sidx, src, buf
        print(f"iteration {k}: ccl_step {t_step:.4f} ms + pointer_jump {t_jump:.4f} ms = {t_step + t_jump:.4f} ms; "
              f"unfused without its hook kernel {t_unfused:.4f} ms; stencil alone {t_alone:.4f} ms; yardsticks "
              f"max_pool2d {t_pool:.4f} ms, gather {t_gather:.4f} ms, hook scatter_reduce amin {t_scatter:.4f} ms; "
              f"{n_hooks} cells with m < lab; bounds: step {bound_ms(9 * N):.4f} ms, jump {bound_ms(8 * N):.4f} ms")
        if t_step + t_jump >= t_unfused:
            raise AssertionError(f"iteration {k}: the fused iteration is not faster than the unfused one")
        if k == 6:
            torch.cuda.empty_cache()
            result = {
                "ccl_step": dict(
                    ms=t_step, plain_ms=cuda_ms_fresh(lambda: ccl_step_plain(a, data, out), lambda: out.copy_(b), reps=1),
                    bound_ms=bound_ms(9 * N), bound_by="bytes", library_ms=t_pool,
                ),
                "pointer_jump": dict(
                    ms=t_jump, plain_ms=cuda_ms(lambda: pointer_jump_plain(hooked, S), reps=2),
                    bound_ms=bound_ms(8 * N), bound_by="bytes", library_ms=t_gather,
                ),
            }
        del a, b, hooked
        torch.cuda.empty_cache()
    del out
    result["ccl_step 3-D"] = spacetime_labels(tr.filter_small_objects(data)[0].contiguous())
    return result


def spacetime_labels(data: torch.Tensor) -> dict:
    """Phase 6, config 1's 3-D fixpoint (``ccl3d``) on its own input (the
    area filter's output of phase 5's field), run by hand with each launch
    timed; at its iterations 1, 6 and 12 the fused 3-D step timed from a
    fresh copy of its output, and at iteration 6 beside its plain version
    and ``max_pool3d`` on the negated, padded labels. Returns those times."""
    from marex_tpu_torch.ops.min_stencil import ccl_step, ccl_step_plain

    torch.cuda.empty_cache()
    N = data.numel()
    result = {}
    split = Split()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters, snaps = fused_fixpoint(data, True, split, keep=(1, 6, 12))
    print(f"3-D fixpoint on config 1's own input ({int(data.sum())} active cells): {iters} iterations, wall "
          f"{time.perf_counter() - t0:.4f} s; summed launch ms {json.dumps(split.ms)}")
    print(f"  each launch (ms): {json.dumps(split.each)}")
    out = torch.empty_like(data, dtype=torch.int32)
    times = {}
    for k in sorted(snaps):
        a, b = snaps.pop(k)
        times[k] = cuda_ms_fresh(lambda: ccl_step(a, data, out, depth3=True), lambda: out.copy_(b))
        line = f"3-D iteration {k}: ccl_step {times[k]:.4f} ms, bound {bound_ms(9 * N):.4f} ms"
        if k == 6:
            t_plain = cuda_ms_fresh(lambda: ccl_step_plain(a, data, out, depth3=True), lambda: out.copy_(b), reps=1)
            xp = neg_padded(a, depth3=True)
            t_pool = cuda_ms(lambda: torch.nn.functional.max_pool3d(xp, 3, stride=1), reps=3)
            del xp
            line += f"; plain {t_plain:.4f} ms; max_pool3d {t_pool:.4f} ms"
            result = dict(ms=times[6], plain_ms=t_plain, bound_ms=bound_ms(9 * N), library_ms=t_pool)
        print(line)
        del a, b
        torch.cuda.empty_cache()
    print(f"3-D ccl_step at iterations 1 / 6 / 12: {json.dumps(times)} ms")
    return result


def regional_kwargs(ny: int, merge: bool = False) -> dict:
    """Config 3's tracking parameters at 360 x 720, with R_fill and the area
    floor scaled with resolution on coarser grids (as ``track_kwargs``);
    ``merge`` turns the split/merge march on, with nearest-cell partitioning."""
    s = min(ny / 360.0, 1.0)
    kw = dict(TRACK_CONFIG3, R_fill=max(int(round(TRACK_CONFIG3["R_fill"] * s)), 2),
              area_filter_absolute=max(int(round(TRACK_CONFIG3["area_filter_absolute"] * s * s)), 4))
    if merge:
        kw.update(allow_merging=True, nn_partitioning=True, overlap_threshold=0.25)
    return kw


def partition_batch(g: torch.Generator, H: int, W: int, K: int, P: int, cap: float) -> list:
    """A random batch for the grid partition, made on the card: parents as
    8 x 8 blocks of ids 1..K*P (and ids no slot names) in the previous
    slice, children as 16 x 16 blocks of ids 1001..1000+K, so that every
    piece is ragged and every parent scattered; piece ids 2000 + k*P + p (the
    first the child's), random centroids, every cap ``cap``; with K >= 4
    slot 2 is inactive (id 0) and slot (0, P - 1) invalid."""
    def blocks(n: int, b: int) -> torch.Tensor:
        c = torch.randint(0, n, (-(-H // b), -(-W // b)), generator=g, device="cuda", dtype=torch.int32)
        return c.repeat_interleave(b, 0).repeat_interleave(b, 1)[:H, :W].contiguous()

    prev = blocks(K * P + 4, 8)
    cur = blocks(K + 1, 16)
    cur = torch.where(cur > 0, cur + 1000, 0).to(torch.int32)
    child = torch.arange(1001, 1001 + K, dtype=torch.int32, device="cuda")
    piece = torch.arange(2000, 2000 + K * P, dtype=torch.int32, device="cuda").view(K, P).contiguous()
    piece[:, 0] = child
    pids = torch.arange(1, K * P + 1, dtype=torch.int32, device="cuda").view(K, P).contiguous()
    valid = torch.ones((K, P), dtype=torch.bool, device="cuda")
    if K >= 4:
        child[2] = 0
        valid[0, P - 1] = False
    cents = torch.rand((K, P, 2), generator=g, device="cuda") * torch.tensor([H - 1.0, W - 1.0], device="cuda")
    mdist = torch.full((K,), cap, dtype=torch.float32, device="cuda")
    return [prev, cur, child, piece, pids, valid, cents, mdist]


def partition_against_plain(g: torch.Generator) -> int:
    """Phase 3: the partition kernel against its plain version on random
    batches, bit for bit on the updated slice and the props; returns the
    number of checks."""
    from marex_tpu_torch.ops.partition import partition_children_grid_batched, partition_children_grid_plain

    n = 0
    for H, W in ((720, 1440), (719, 1441), (33, 70), (1, 5), (6, 1)):
        for K, P in ((1, 2), (4, 3), (2, 10)):
            for wrap in (True, False):
                for cap in (0.0, 40.0, 600.0):
                    args = partition_batch(g, H, W, K, P, cap)
                    got = partition_children_grid_batched(*args, True, wrap)
                    want = partition_children_grid_plain(*args, True, wrap)
                    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                        raise AssertionError(f"partition ({H}, {W}) K={K} P={P} wrap={wrap} cap={cap}: "
                                             f"{int((got[0] != want[0]).sum())} cells differ, props "
                                             f"{float((got[1] - want[1]).abs().max())} apart")
                    n += 1
    return n


@contextlib.contextmanager
def kept_partitions(every: int, keep: list):
    """Keep every ``every``-th grid partition call's arguments, copied to the
    host, while the block runs: the tracker's module sees a copy of the
    partition module whose batched partition keeps them (the function itself
    stays, with its launch count)."""
    import types

    from marex_tpu_torch import track

    part = track._part
    fn = part.partition_children_grid_batched
    calls = [0]

    def keeping(*args):
        if calls[0] % every == 0:
            keep.append([a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
        calls[0] += 1
        return fn(*args)

    track._part = types.SimpleNamespace(**{**vars(part), "partition_children_grid_batched": keeping})
    try:
        yield
    finally:
        track._part = part


def parent_column_pass(prev, parent_ids, parent_valid, max_cap: float, wrap: bool) -> torch.Tensor:
    """The parents' masks and the squared EDT as the port ran them before the
    partition kernel (the yardstick): the cap rounded up to a power of two
    ``win``, then ``2 win`` full-slice minimum passes over rows, or, where
    ``2 win + 1 >= H``, the exact column min in blocks."""
    from marex_tpu_torch.ops.partition import _row_distance_periodic, euclidean_distance_transform_grid

    H = prev.shape[0]
    pmasks = (prev[None, None] == parent_ids[..., None, None]) & parent_valid[..., None, None]
    win = 1 << max(0, int(np.ceil(np.log2(max(max_cap, 1.0)))))
    if 2 * win + 1 >= H:
        return euclidean_distance_transform_grid(pmasks, wrap)
    d1 = _row_distance_periodic(pmasks, wrap)
    d1sq = d1 * d1
    out = d1sq.clone()
    for dy in range(1, win + 1):
        torch.minimum(out[..., dy:, :], d1sq[..., :-dy, :] + float(dy * dy), out=out[..., dy:, :])
        torch.minimum(out[..., :-dy, :], d1sq[..., dy:, :] + float(dy * dy), out=out[..., :-dy, :])
    return out


def partition_labels(batches: list) -> dict:
    """Phase 6: the partition kernel on config 4's kept batches: each held
    against the plain version (bit for bit), then timed: the two launches
    alone on scratch made once, the whole call (the output's copy, the sums'
    zeros, the props), the plain version and the column pass the port ran
    before; the means over the batches, and the byte bound (two int32 label
    slices read once, one written). Returns the JSON fields."""
    from marex_tpu_torch._cuda_build import kernel_library
    from marex_tpu_torch.ops.partition import partition_children_grid_batched, partition_children_grid_plain

    lib = kernel_library()
    sums = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    shapes = []
    for kept in batches:
        args = [a.cuda() for a in kept[:8]]
        wrap = bool(kept[9])
        prev, cur, child, piece, pids, valid, cents, mdist = args
        H, W = cur.shape
        K, P = pids.shape
        got = partition_children_grid_batched(*args, True, wrap)
        want = partition_children_grid_plain(*args, True, wrap)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"partition on config 4's batch K={K} P={P}: differs from the plain version")
        out = cur.clone()
        acc = torch.zeros((K, P, 6), dtype=torch.int64, device="cuda")
        rowd = torch.empty((K, P, H, W), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() for a in args] + [rowd.data_ptr(), out.data_ptr(), acc.data_ptr()]
        sums["ms"] += cuda_ms(lambda: lib.marex_partition_grid(*ptrs, K, P, H, W, int(wrap), stream), reps=50)
        sums["call_ms"] += cuda_ms(lambda: partition_children_grid_batched(*args, True, wrap), reps=50)
        sums["plain_ms"] += cuda_ms(lambda: partition_children_grid_plain(*args, True, wrap), reps=2)
        sums["library_ms"] += cuda_ms(lambda: parent_column_pass(prev, pids, valid, float(mdist.max()), wrap), reps=2)
        shapes.append((K, P, int((cur[None] == child[:, None, None]).sum())))
        del args, got, want, out, acc, rowd
    n = max(len(batches), 1)
    res = {k: v / n for k, v in sums.items()}
    H, W = batches[0][1].shape
    res.update(bound_ms=bound_ms(12 * H * W), bound_by="bytes", batches=len(batches))
    print(f"partition on {len(batches)} of config 4's batches (K, P, child cells: {shapes}): kernels "
          f"{res['ms']:.4f} ms, whole call {res['call_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, the column pass "
          f"before {res['library_ms']:.4f} ms (means); bound {res['bound_ms']:.4f} ms "
          f"({100 * res['bound_ms'] / res['ms']:.1f} % of the kernels' time)")
    return {"partition": res}


def graph_step_against_plain(g: torch.Generator, seed: int):
    """Phase 3, the mesh kernels against their plain versions, bit-identical:
    the step over the list of active cells in ``out`` and the flag, against
    its plain version and the dense step; the jump over the list against its
    plain version and the whole-field jump, on labels whose unlisted cells
    hold BIG, and leaving a stale output's unlisted cells untouched. On the
    triangle-pair mesh's table (as given and symmetrised, small and at
    config 5's 1,048,352 cells) and on random directed tables after
    symmetrising (K' > 3, ``-1`` entries, ragged C), with ``out`` BIG-filled
    and stale, at 1,048,352 cells up to config 5's own 730 slices; and the
    whole fixpoint's labels, counts and iterations against the CPU's. The
    list of active cells of every mask (and of masks that start off a 16-byte
    boundary or end inside a tile) against its plain version. Returns (number
    of checks, {kernel: largest difference})."""
    from marex_tpu_torch.ops.graph_step import (
        active_cells,
        active_cells_plain,
        graph_jump,
        graph_jump_plain,
        neighbour_min_plain,
    )
    from marex_tpu_torch.ops.label import label_slices_unstructured
    from marex_tpu_torch.ops.min_stencil import pointer_jump_plain
    from marex_tpu_torch.track import _symmetrize_neighbours

    rng = np.random.default_rng(seed)

    def random_table(C: int, K: int, missing: float) -> np.ndarray:
        nb = rng.integers(0, C, (K, C)).astype(np.int32)
        nb[rng.random((K, C)) < missing] = -1
        return nb

    tables = [
        ("tri_mesh(4096) as given", tri_mesh(4096)[0] - 1, (1, 5, 19)),
        ("tri_mesh(4096) symmetrised", symmetrised(4096), (1, 19)),
        ("random K=3 C=30011 symmetrised", _symmetrize_neighbours(random_table(30011, 3, 0.3)), (1, 8, 19)),
        ("random K=2 C=777 sparse symmetrised", _symmetrize_neighbours(random_table(777, 2, 0.6)), (3,)),
        ("one cell", np.full((3, 1), -1, np.int32), (2,)),
        (f"tri_mesh({MESH_CELLS}) symmetrised", symmetrised(MESH_CELLS), (11, 67, MESH_DAYS)),
    ]
    n_checks = 0
    worst = {"active_cells": 0, "graph_step": 0, "graph_jump": 0}
    for name, table, slice_counts in tables:
        nb = torch.from_numpy(table).cuda()
        C = nb.shape[1]
        for T in slice_counts:
            for density in (0.1, 0.6):
                data = torch.rand((T, C), generator=g, device="cuda") < density
                active = active_cells(data)
                flat = data.view(-1)
                diff = max(max_abs_diff(active, active_cells_plain(data)),  # off a 16-byte boundary, and ragged
                           max_abs_diff(active_cells(flat[1:]), active_cells_plain(flat[1:])),
                           max_abs_diff(active_cells(flat[: max(flat.numel() - 4099, 0)]),
                                        active_cells_plain(flat[: max(flat.numel() - 4099, 0)])))
                worst["active_cells"] = max(worst["active_cells"], diff)
                if diff:
                    raise AssertionError(f"active_cells {name} T={T} density={density}: max diff {diff}")
                n_checks += 1
                lab = torch.randint(0, C, (T, C), generator=g, device="cuda", dtype=torch.int32)
                lab.masked_fill_(~data & (torch.rand((T, C), generator=g, device="cuda") < 0.5), BIG)
                m = neighbour_min_plain(lab, data, nb)
                up = torch.randint(0, 3, (T, C), generator=g, device="cuda", dtype=torch.int32)
                for what, out0 in (("BIG", torch.full_like(lab, BIG)), ("stale", torch.where(m >= BIG - 2, m, m + up))):
                    diff = graph_step_diff(lab, active, nb, out0, data)
                    worst["graph_step"] = max(worst["graph_step"], diff)
                    if diff:
                        raise AssertionError(f"graph_step {name} T={T} density={density} out={what}: max diff {diff}")
                    n_checks += 1
                del m, up, out0
                # the jump on the fixpoint's invariant: unlisted cells BIG in both buffers
                b = lab.masked_fill_(~data, BIG)
                got = graph_jump(b, active, torch.full_like(b, BIG))
                diff = max(max_abs_diff(got, pointer_jump_plain(b, C)),
                           max_abs_diff(got, graph_jump_plain(b, active, torch.full_like(b, BIG))))
                stale = torch.randint(0, C, (T, C), generator=g, device="cuda", dtype=torch.int32)
                kept = stale.masked_select(~data)
                graph_jump(b, active, out=stale)
                diff = max(diff, max_abs_diff(stale.masked_select(~data), kept),
                           max_abs_diff(stale.masked_select(data), got.masked_select(data)))
                worst["graph_jump"] = max(worst["graph_jump"], diff)
                if diff:
                    raise AssertionError(f"graph_jump {name} T={T} density={density}: max diff {diff}")
                n_checks += 1
                del b, lab, got, stale, kept, active
            # the whole fixpoint: the card's labels, counts and iterations equal the CPU's
            if C <= 30011:
                lab_g, counts_g, it_g = label_slices_unstructured(data, nb)
                lab_c, counts_c, it_c = label_slices_unstructured(data.cpu(), nb.cpu())
                if not torch.equal(lab_g.cpu(), lab_c) or not torch.equal(counts_g.cpu(), counts_c) or it_g != it_c:
                    raise AssertionError(f"mesh CCL {name} T={T}: CUDA differs from the CPU ({it_g} vs {it_c} iterations)")
                n_checks += 1
            del data
        del nb
        torch.cuda.empty_cache()
    return n_checks, worst


def mesh_step_bound_ms(n_active: int, K: int, C: int) -> float:
    """The least time for one mesh step on a field with ``n_active`` active
    cells: each one's label read and ``out`` written (8 B; an inactive cell
    is touched only as a neighbour), and the (K, C) table read once, over
    the card's memory rate. The jump's is ``bound_ms(8 * n_active)``."""
    return bound_ms(8 * n_active + 4 * K * C)


def graph_step_diff(lab: torch.Tensor, active: torch.Tensor, table: torch.Tensor, out0: torch.Tensor,
                    data=None) -> int:
    """``graph_step`` against ``graph_step_active_plain`` from copies of
    ``out0``, and with ``data`` (the mask the list was made from) also
    against the dense ``graph_step_plain``: the largest difference in
    ``out`` and in the flag."""
    from marex_tpu_torch.ops.graph_step import graph_step, graph_step_active_plain, graph_step_plain

    out_k, out_p = out0.clone(), out0.clone()
    flag_k = int(graph_step(lab, active, table, out_k))
    diff = max(abs(flag_k - int(graph_step_active_plain(lab, active, table, out_p))), max_abs_diff(out_k, out_p))
    if data is not None:
        out_p.copy_(out0)
        diff = max(diff, abs(flag_k - int(graph_step_plain(lab, data, table, out_p))), max_abs_diff(out_k, out_p))
    return diff


def graph_jump_diff(b: torch.Tensor, active: torch.Tensor, out0: torch.Tensor) -> int:
    """``graph_jump`` against ``graph_jump_plain`` from copies of ``out0``:
    the largest difference."""
    from marex_tpu_torch.ops.graph_step import graph_jump, graph_jump_plain

    return max_abs_diff(graph_jump(b, active, out=out0.clone()), graph_jump_plain(b, active, out0.clone()))


def mesh_yardsticks(lab: torch.Tensor, active: torch.Tensor, table: torch.Tensor, out0: torch.Tensor,
                    hooked: torch.Tensor, reps: int) -> dict:
    """The mesh kernels' plain versions (the step from a fresh copy of
    ``out0``, the jump of ``hooked``) and the nearest single PyTorch calls
    (never called by the port): the dense gather of every table row
    (``index_select``), the gather of the listed cells' neighbours and of
    the jump's targets (``torch.take``), the listed cells' labels moved
    from ``hooked`` into a copy of ``out0`` (``take`` then ``index_put_``),
    and the hook's ``scatter_reduce_`` amin; milliseconds, and the cells the
    hook scatters."""
    from marex_tpu_torch.ops.graph_step import graph_jump_plain, graph_step_active_plain, split_flat

    C = lab.shape[1]
    out = torch.empty_like(out0)
    t = dict(step_plain=cuda_ms_fresh(lambda: graph_step_active_plain(lab, active, table, out),
                                      lambda: out.copy_(out0), reps=reps))
    t["jump_plain"] = cuda_ms(lambda: graph_jump_plain(hooked, active, out), reps=reps)
    flat = table.clamp_min(0).view(-1).long()
    t["index_select"] = cuda_ms(lambda: torch.index_select(lab, 1, flat), reps=3)
    del flat
    base, c = split_flat(active, C)
    nbr = table[:, c].long()  # (K, n): the listed cells' neighbours
    del c
    idx = (base + nbr.clamp_min(0)).view(-1)
    t["take_step"] = cuda_ms(lambda: torch.take(lab, idx), reps=3)
    v = hooked.view(-1)[active]
    hop = base + torch.where(v != BIG, v, 0)
    t["take_jump"] = cuda_ms(lambda: torch.take(hooked, hop), reps=3)
    del v, hop
    # the listed cells' labels moved from one buffer to the other and nothing
    # else: what any launch over the list pays for their scatter in the field
    moved = out0.clone()
    t["move"] = cuda_ms(lambda: moved.view(-1).index_put_((active,), hooked.view(-1).take(active)), reps=3)
    del moved
    r = lab.view(-1)[active]
    m = torch.take(lab, idx).view(nbr.shape).masked_fill_(nbr < 0, BIG).amin(dim=0).minimum(r)
    del idx, nbr
    hook = (m < r) & (r != BIG)
    sidx, src = base[hook] + r[hook].long(), m[hook]
    buf = out0.clone().view(-1)
    t["scatter"] = cuda_ms_fresh(lambda: buf.scatter_reduce_(0, sidx, src, "amin"), lambda: buf.copy_(out0.view(-1)))
    t["hooked"] = int(sidx.numel())
    return t


def graph_step_random_times(g: torch.Generator) -> None:
    """Phase 3, the mesh kernels timed at (64, 1048352), 30 % of the cells
    active, on random labels: the step from a fresh copy of its output, the
    jump, each beside its plain version, its bound and the nearest single
    PyTorch calls (``mesh_yardsticks``)."""
    from marex_tpu_torch.ops.graph_step import active_cells, graph_jump, graph_step

    nb = torch.from_numpy(symmetrised(MESH_CELLS)).cuda()
    K, C = nb.shape
    T = 64
    data = torch.rand((T, C), generator=g, device="cuda") < 0.3
    active = active_cells(data)
    lab = torch.randint(0, C, (T, C), generator=g, device="cuda", dtype=torch.int32).masked_fill_(~data, BIG)
    big = torch.full_like(lab, BIG)
    out = torch.empty_like(lab)
    t_step = cuda_ms_fresh(lambda: graph_step(lab, active, nb, out), lambda: out.copy_(big))
    hooked = big.clone()
    graph_step(lab, active, nb, hooked)
    t_jump = cuda_ms(lambda: graph_jump(hooked, active, out=out))
    y = mesh_yardsticks(lab, active, nb, big, hooked, reps=2)
    n = active.numel()
    b_step, b_jump = mesh_step_bound_ms(n, K, C), bound_ms(8 * n)
    print(f"time graph_step at ({T}, {C}), K={K}, {n} active cells, random labels: kernel {t_step:.4f} ms, plain "
          f"{y['step_plain']:.4f} ms, library index_select {y['index_select']:.4f} ms, take of the neighbours "
          f"{y['take_step']:.4f} ms, hook scatter_reduce amin {y['scatter']:.4f} ms, bound {b_step:.4f} ms "
          f"({100 * b_step / t_step:.0f} % of it)")
    print(f"time graph_jump at ({T}, {C}), random labels: kernel {t_jump:.4f} ms, plain {y['jump_plain']:.4f} ms, "
          f"library take of the targets {y['take_jump']:.4f} ms, bound {b_jump:.4f} ms ({100 * b_jump / t_jump:.0f} % "
          f"of it)")


def mesh_against_cpu(mx, seed: int, device: str) -> None:
    """Phase 4, config 5 at 2 yr x 32768 cells on ``device`` and on the CPU:
    detect's booleans, every integer output and the merge records
    bit-identical, floats within 1e-5, the same fixpoint iterations, and
    merges and partitions that really happened."""
    sst, coords, nb, areas = make_mesh_sst(2, 32768, seed, device)
    ds_g, ev_g, mg_g, tr_g, det_g, trk_g, _ = run_mesh(mx, sst, coords, nb, areas, device)
    ds_c, ev_c, mg_c, tr_c, det_c, trk_c, _ = run_mesh(mx, sst.cpu(), coords, nb, areas, "cpu")
    for key in ("extreme_events", "mask", "neighbours", "cell_areas"):
        if not np.array_equal(ds_g[key].values, ds_c[key].values):
            raise AssertionError(f"mesh slice: {key} differs between CUDA and CPU")
    float_diff = {}
    for key in ("dat_anomaly", "thresholds"):
        float_diff[key] = float(np.nanmax(np.abs(ds_g[key].values - ds_c[key].values)))
        if not float_diff[key] <= 1e-5:
            raise AssertionError(f"mesh slice: {key} differs by {float_diff[key]} > 1e-5")
    diff = compare_merge_runs(ev_g, mg_g, tr_g, ev_c, mg_c, "mesh slice")
    if tr_g.ccl_iterations != tr_c.ccl_iterations:
        raise AssertionError(f"mesh slice: fixpoint iterations {tr_g.ccl_iterations} (CUDA) vs {tr_c.ccl_iterations} (CPU)")
    check_merge_outputs(ev_g, mg_g, tuple(sst.shape))
    streamed_slice(mx, ds_g, ev_g, mg_g, ev_c, mg_c, 128, f"config 5 slice {tuple(sst.shape)}",
                   lambda ev: mx.tracker(ev, ds_g.mask, neighbours=ds_g.neighbours, cell_areas=ds_g.cell_areas,
                                         device=device, quiet=True, **TRACK_CONFIG5))
    attrs = {k: ev_g.attrs[k] for k in ("N_objects_prefiltered", "N_objects_filtered", "N_events_final", "total_merges")}
    print(
        f"mesh slice (config 5) {tuple(sst.shape)}: CUDA == CPU (extreme_events, mask, ID_field, global_ID, presence, "
        f"merge_ledger and merge records bit-identical; max |diff| dat_anomaly {float_diff['dat_anomaly']}, thresholds "
        f"{float_diff['thresholds']}, (abs, rel) area {diff['area']}, centroid {diff['centroid']}); {attrs}; dispatches "
        f"{tr_g.dispatch_counts}; ccl iterations {tr_g.ccl_iterations}; cuda detect {det_g:.3f} s track {trk_g:.3f} s; "
        f"cpu detect {det_c:.3f} s track {trk_c:.3f} s"
    )


def regional_against_cpu(mx, seed: int, device: str) -> None:
    """Phase 4, config 3 at 3 yr x 90 x 180 on ``device`` and on the CPU:
    ``extreme_events``, ``mask``, ``ID_field`` and attrs bit-identical; then
    the same domain's first 400 days with merging on (nearest-cell
    partitioning with no seam), held like config 4."""
    ny, nx = 90, 180
    sst, coords = make_sst(3, ny, nx, seed, device, **REGION)
    sst_cpu = sst.cpu()
    ds_g, ev_g, _, tr_g, det_g, trk_g, _ = run_regional(mx, sst, coords, device, regional_kwargs(ny))
    ds_c, ev_c, _, tr_c, det_c, trk_c, _ = run_regional(mx, sst_cpu, coords, "cpu", regional_kwargs(ny))
    for key in ("extreme_events", "mask"):
        if not np.array_equal(ds_g[key].values, ds_c[key].values):
            raise AssertionError(f"regional slice: {key} differs between CUDA and CPU")
    if not np.array_equal(ev_g["ID_field"].values, ev_c["ID_field"].values) or ev_g.attrs != ev_c.attrs:
        raise AssertionError("regional slice: ID_field or attrs differ between CUDA and CPU")
    if ev_g.attrs["N_events_final"] <= 0 or tr_g.ccl_iterations != tr_c.ccl_iterations:
        raise AssertionError(f"regional slice: no event, or iterations differ: {ev_g.attrs}, {tr_g.ccl_iterations}")
    print(
        f"regional slice (config 3) 3yr x {ny} x {nx}: CUDA == CPU (extreme_events, mask, ID_field, attrs "
        f"bit-identical); N_events_final {ev_g.attrs['N_events_final']}; ccl iterations {tr_g.ccl_iterations}; "
        f"cuda detect {det_g:.3f} s track {trk_g:.3f} s; cpu detect {det_c:.3f} s track {trk_c:.3f} s"
    )
    del ds_g, ev_g, tr_g, ds_c, ev_c, tr_c
    days = 400  # the first year's converging pairs (days 150-270) are enough merges
    _, ev_g, mg_g, tr_g, _, trk_g, _ = run_regional(mx, sst, coords, device, regional_kwargs(ny, merge=True), days)
    _, ev_c, mg_c, tr_c, _, trk_c, _ = run_regional(mx, sst_cpu, coords, "cpu", regional_kwargs(ny, merge=True), days)
    diff = compare_merge_runs(ev_g, mg_g, tr_g, ev_c, mg_c, "regional merge slice")
    print(
        f"regional merge slice {days} d x {ny} x {nx}: CUDA == CPU (integer outputs and merge records bit-identical; max "
        f"|diff| (abs, rel) area {diff['area']}, centroid {diff['centroid']}); N_events_final "
        f"{ev_g.attrs['N_events_final']}, total_merges {ev_g.attrs['total_merges']}; dispatches {tr_g.dispatch_counts}; "
        f"cuda track {trk_g:.3f} s; cpu track {trk_c:.3f} s"
    )


def report_path(path: str, n_in: int, events, tr, t_det: float, t_trk: float, detect_peak: int, counts: dict) -> None:
    """Print one full-size path's walls, counts and memory."""
    peak = torch.cuda.max_memory_allocated()
    print(f"{path}: detect {t_det:.3f} s, track {t_trk:.3f} s, {n_in / (t_det + t_trk):.4g} gridpoint-days/s")
    print(f"  stage_walls: {json.dumps(tr.stage_walls)}")
    print(f"  attrs: {json.dumps({k: v for k, v in events.attrs.items() if k.startswith('N_') or 'merge' in k or 'area' in k})}")
    if tr.dispatch_counts:
        print(f"  dispatch_counts: {json.dumps(tr.dispatch_counts)}")
    print(f"  ccl iterations: {json.dumps(tr.ccl_iterations)}")
    print(f"  launch counts: {json.dumps(counts)}")
    print(f"  max_memory_allocated: {peak} bytes ({peak / 2**30:.2f} GiB); after detect {detect_peak / 2**30:.2f} GiB")


def mesh_and_regional_paths(mx, seed: int, kernels: dict, plot_inputs: dict) -> dict:
    """Phase 5, this slice's paths at full size, generated on the card: config
    5 (2 yr x 1,048,352 cells, merge tracking on the mesh) and config 3
    (3 yr x 360 x 720 over lat 30..70, lon -30..40, the regional tracker
    without merging), each with the kernels' launch counts set to 0 just
    before it and read just after; returns {path: launch counts}. Config
    5's ``ID_field`` and its cells' lon/lat go to ``plot_inputs`` (phase 7)."""
    launches = {}

    def start():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launch_count = 0

    t0 = time.perf_counter()
    sst, coords, nb, areas = make_mesh_sst(2, MESH_CELLS, seed, "cuda")
    torch.cuda.synchronize()
    print(f"mesh data: {tuple(sst.shape)} generated on the card in {time.perf_counter() - t0:.1f} s")
    start()
    ds, events, merges, tr, t_det, t_trk, detect_peak = run_mesh(mx, sst, coords, nb, areas, "cuda")
    launches["config 5"] = {k: fn.launch_count for k, fn in kernels.items()}
    if not bool(torch.isfinite(ds["thresholds"].data).all()):
        raise AssertionError("config 5: non-finite thresholds")
    check_merge_outputs(events, merges, tuple(sst.shape))
    if int(events.attrs["total_merges"]) <= 0:
        raise AssertionError(f"config 5: no merge on the mesh: {events.attrs}")
    report_path(f"config 5 {tuple(sst.shape)}", sst.numel(), events, tr, t_det, t_trk, detect_peak, launches["config 5"])
    plot_inputs["config 5"] = dict(ID_field=events["ID_field"].values, lon=coords["lon"][1], lat=coords["lat"][1])
    del sst, ds, events, merges, tr

    ny, nx = 360, 720
    sst, coords = make_sst(3, ny, nx, seed, "cuda", **REGION)
    start()
    ds, events, _, tr, t_det, t_trk, detect_peak = run_regional(mx, sst, coords, "cuda", regional_kwargs(ny))
    launches["config 3"] = {k: fn.launch_count for k, fn in kernels.items()}
    thr, mask = ds["thresholds"].data, ds["mask"].data
    if not bool(torch.isfinite(thr[..., mask]).all()):
        raise AssertionError("config 3: non-finite thresholds over the ocean")
    check_event_ids(events, tuple(sst.shape))
    report_path(f"config 3 {tuple(sst.shape)}", sst.numel(), events, tr, t_det, t_trk, detect_peak, launches["config 3"])
    return launches


def store_bytes(path: str) -> int:
    """Bytes of every file under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def equal_blocks(lazy, want: np.ndarray) -> bool:
    """A lazy zarr array equals ``want`` bit for bit, read a chunk of its
    leading axis at a time in threads (zlib and the reads release the GIL)."""
    step = lazy.chunks[0]

    def same(s0: int) -> bool:
        return np.array_equal(lazy[s0 : s0 + step], want[s0 : s0 + step])

    with ThreadPoolExecutor(max_workers=8) as pool:
        return all(pool.map(same, range(0, lazy.shape[0], step)))


def streamed_paths(mx, refs: dict, kernels: dict, plot_inputs: dict, keep_dir: str) -> dict:
    """Phase 5, the out-of-core path at full size, into a temporary directory:
    config 7 (config 2's detect through ``preprocess_data_streamed`` from the
    SST in pinned host memory, ``memory_budget_mb=2048``, raw chunks) against
    config 2's in-memory outputs, bit for bit; config 8 (config 4's extremes
    in a zarr store with 64-day chunks, tracked by ``run_streamed`` at
    ``memory_budget_mb=2048``) against config 4's in-memory run like the
    phase-4 slices, its peak within twice the budget. Each with the kernels'
    launch counts set to 0 just before it and read just after; returns
    {path: launch counts}. Config 8's output store is moved to ``keep_dir``
    and named in ``plot_inputs`` (phase 7)."""
    from marex_tpu_torch.io import zarr_lite

    launches = {}
    budget_mb = 2048

    def start():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launch_count = 0

    work = tempfile.mkdtemp(prefix="marex_smoke_")
    try:
        # ---- config 7: streamed detect -------------------------------------
        sst = refs.pop("sst")
        coords = refs["coords"]
        T, ny, nx = sst.shape
        field = mx.Field(sst.numpy(), ("time", "lat", "lon"), coords, name="sst")
        out_path = os.path.join(work, "detect.zarr")
        start()
        timings = {}
        t0 = time.perf_counter()
        out = mx.preprocess_data_streamed(field, out_path, memory_budget_mb=budget_mb, compressor=None, device="cuda",
                                          timings=timings, **DETECT_CONFIG2)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches["config 7"] = {k: fn.launch_count for k, fn in kernels.items()}
        want = refs.pop("config 2")
        for key in ("dat_anomaly", "extreme_events", "thresholds", "mask"):
            got = np.asarray(out[key].values)
            if not same_bits(got, want[key]):
                raise AssertionError(f"config 7: {key} differs from config 2's in-memory detect")
        del field, out, want, got
        print(f"config 7 (streamed config 2 detect) {T} x {ny} x {nx}: == config 2's in-memory detect (dat_anomaly, "
              f"extreme_events, thresholds, mask bit-identical); wall {wall:.3f} s, {sst.numel() / wall:.4g} "
              f"gridpoint-days/s; row_block {zarr_lite.open_zarr(out_path).attrs['stream_row_block']}, n_tiles "
              f"{zarr_lite.open_zarr(out_path).attrs['stream_n_tiles']}; {store_bytes(out_path) / 1e9:.3f} GB written; "
              f"peak {peak} bytes ({peak / 2**30:.2f} GiB); wall split (s): {json.dumps({k: round(v, 3) for k, v in timings.items()})}")
        del sst
        shutil.rmtree(out_path, ignore_errors=True)

        # ---- config 8: streamed tracking ------------------------------------
        c4 = refs.pop("config 4")
        src = os.path.join(work, "extremes.zarr")
        t0 = time.perf_counter()
        zarr_lite.to_zarr(mx.Field(c4.pop("extremes"), ("time", "lat", "lon"), coords, name="extreme_events"), src,
                          chunks={"time": 64})
        t_store = time.perf_counter() - t0
        mask = mx.Field(c4["mask"], ("lat", "lon"), {"lat": coords["lat"], "lon": coords["lon"]}, name="mask")
        start()
        t0 = time.perf_counter()
        tr = mx.tracker(zarr_lite.open_zarr(src, lazy=True)["extreme_events"], mask, device="cuda", quiet=True,
                        **track_kwargs(ny, merge=True))
        events, merges = tr.run_streamed(os.path.join(work, "events.zarr"), memory_budget_mb=budget_mb,
                                         return_merges=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches["config 8"] = {k: fn.launch_count for k, fn in kernels.items()}
        t0 = time.perf_counter()
        ev_want, mg_want = c4["events"], c4["merges"]
        if not equal_blocks(events["ID_field"].data, ev_want["ID_field"]):
            raise AssertionError("config 8: ID_field differs from config 4's in-memory run")
        for key in ("global_ID", "presence", "merge_ledger", "time_start", "time_end"):
            if not np.array_equal(np.asarray(events[key].values), ev_want[key]):
                raise AssertionError(f"config 8: {key} differs from config 4's in-memory run")
        for key, want in mg_want.items():
            if not np.array_equal(merges[key].values, want):
                raise AssertionError(f"config 8: merges {key} differ from config 4's in-memory run")
        diff = {}
        for key in ("area", "centroid"):
            a, b = np.asarray(events[key].values, np.float64), ev_want[key].astype(np.float64)
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"config 8: {key} NaN pattern")
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f"config 8: {key}")
            diff[key] = float(np.nanmax(np.abs(a - b))) if np.isfinite(a).any() else 0.0
        for key in ("N_events_final", "total_merges", "N_objects_prefiltered", "N_objects_filtered"):
            if events.attrs[key] != c4["attrs"][key]:
                raise AssertionError(f"config 8: {key} {events.attrs[key]} vs {c4['attrs'][key]} in memory")
        t_check = time.perf_counter() - t0
        if peak > 2 * budget_mb * 2**20:
            raise AssertionError(f"config 8: peak {peak} bytes is over twice memory_budget_mb={budget_mb}")
        walls = {k: tr.stage_walls[k] for k in ("preprocess", "march", "rename")}
        print(f"config 8 (streamed config 4 track) {T} x {ny} x {nx}: == config 4's in-memory run (ID_field, global_ID, "
              f"presence, merge_ledger, time_start/end, merge records, N_* and total_merges bit-identical; max |diff| area "
              f"{diff['area']}, centroid {diff['centroid']}); N_events_final {events.attrs['N_events_final']}, "
              f"total_merges {events.attrs['total_merges']}; track wall {wall:.3f} s (in memory {c4['wall']:.3f} s), "
              f"{T * ny * nx / wall:.4g} gridpoint-days/s; pass walls (s) {json.dumps(walls)}; "
              f"{tr.dispatch_counts['march_block']} blocks of {tr.stream_block_T} days; peak {peak} bytes "
              f"({peak / 2**30:.2f} GiB, budget {budget_mb} MiB; in memory {c4['peak'] / 2**30:.2f} GiB); input store "
              f"written in {t_store:.1f} s, outputs checked in {t_check:.1f} s")
        print(f"  stage_walls: {json.dumps(tr.stage_walls)}")
        print(f"  dispatch_counts: {json.dumps(tr.dispatch_counts)}; ccl iterations {json.dumps(tr.ccl_iterations)}; "
              f"launch counts {json.dumps(launches['config 8'])}")
        del events, merges
        plot_inputs["config 8"] = shutil.move(os.path.join(work, "events.zarr"), os.path.join(keep_dir, "events.zarr"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def kernels_of(path: str) -> tuple:
    """The kernels a path labels on: none for detect alone (config 7, a
    detect run), the mesh's on config 5, both sets in the dry run (its grid
    and mesh drives), the grid's on every other path, and the partition
    kernel too where the path merges on a grid."""
    if path == "config 7" or "detect" in path:
        return ()
    if path.startswith("config 5"):
        return MESH_KERNELS
    if path.startswith("dryrun"):
        return GRID_KERNELS + MESH_KERNELS + ("partition",)
    if path.startswith(GRID_MERGE_PATHS):
        return GRID_KERNELS + ("partition",)
    return GRID_KERNELS


def check_launches(path: str, counts: dict) -> None:
    """A path launched each kernel it labels on, and no other."""
    runs = kernels_of(path)
    for k, n in counts.items():
        if (k in runs) != (n > 0):
            raise AssertionError(f"{path}: {k} launched {n} times, and it {'is' if k in runs else 'is not'} "
                                 f"a kernel of the path: {counts}")


def config6_field(ny: int, nx: int, device: str, T: int = 200, n_pairs: int = 24) -> torch.Tensor:
    """Bench's config 6 field (``bench.py:config6_merge_dense``'s recipe, bit
    for bit), (T, ny, nx) bool made on ``device``: ``n_pairs`` pairs of disks
    of radius ``max(min(ny, nx) // 30, 5)``, periodic in x, at centres drawn
    with numpy from ``default_rng(9)``, which converge, merge and separate
    every 50 steps."""
    rng = np.random.default_rng(9)
    centers = [(int(rng.integers(ny // 6, 5 * ny // 6)), int(rng.integers(0, nx))) for _ in range(n_pairs)]
    r = max(min(ny, nx) // 30, 5)
    yy = torch.arange(ny, device=device)[:, None]
    xx = torch.arange(nx, device=device)[None, :]
    # a slice depends on t only through t % 50: each of those is made once
    period = torch.zeros((min(T, 50), ny, nx), dtype=torch.bool, device=device)
    for p in range(period.shape[0]):
        sep = int((1.0 - min((p / 50.0) * 2, 1.0)) * 3 * r) + r
        for cy, cx0 in centers:
            for s in (-sep, sep):
                cx = (cx0 + s) % nx
                dx = torch.minimum((xx - cx).abs(), nx - (xx - cx).abs())
                period[p] |= (yy - cy) ** 2 + dx**2 <= r * r
    return period[torch.arange(T, device=device) % 50]


def config6_fields(mx, data: torch.Tensor):
    """``(extreme_events, mask)`` Fields of a config 6 field: bench's
    coordinates (daily from 2015, lat -60..60, lon 0..360) and a mask of ones."""
    T, ny, nx = data.shape
    coords = {"time": pd.date_range("2015-01-01", periods=T, freq="D").to_numpy(), "lat": np.linspace(-60, 60, ny),
              "lon": np.linspace(0, 360, nx, endpoint=False)}
    ev = mx.Field(data, ("time", "lat", "lon"), coords, name="extreme_events")
    mask = mx.Field(torch.ones((ny, nx), dtype=torch.bool, device=data.device), ("lat", "lon"),
                    {"lat": coords["lat"], "lon": coords["lon"]}, name="mask")
    return ev, mask


def run_config6(mx, ev, mask, merging: bool, device: str):
    """Bench's timed unit: the tracker built and run, ending in a synchronise;
    returns (events, merges or None, tracker, wall)."""
    t0 = time.perf_counter()
    tr = mx.tracker(ev, mask, allow_merging=merging, device=device, quiet=True, **CONFIG6_TRACK)
    events, merges = tr.run(return_merges=True) if merging else (tr.run(), None)
    if device == "cuda":
        torch.cuda.synchronize()
    return events, merges, tr, time.perf_counter() - t0


def config6_paths(mx, kernels: dict, smi: str) -> dict:
    """Phase 5, config 6 (the merge-dense stress) on the card at bench's own
    shape, 200 x 180 x 360, and on the grid of the other paths, 200 x 720 x
    1440, 24 pairs each: the tracker without and with merging, each after a
    warm run, the launch counts set to 0 just before the two timed runs and
    read just after. Prints bench's keys (less its TPU-link ones) and each
    run's peak. At bench's shape both runs are held against the CPU's bit
    for bit (``ID_field``, the merge records, the attrs; area and centroid
    within 1e-5). Returns {path: launch counts}."""
    launches = {}
    for path, ny, nx in (("config 6", 180, 360), ("config 6 (720 x 1440)", 720, 1440)):
        t0 = time.perf_counter()
        data = config6_field(ny, nx, "cuda")
        torch.cuda.synchronize()
        print(f"config 6 data: {tuple(data.shape)} made on the card in {time.perf_counter() - t0:.2f} s")
        ev, mask = config6_fields(mx, data)
        for merging in (False, True):  # the warm runs
            run_config6(mx, ev, mask, merging, "cuda")
        torch.cuda.empty_cache()
        for fn in kernels.values():
            fn.launch_count = 0
        peaks, runs = [], []
        for merging in (False, True):
            torch.cuda.reset_peak_memory_stats()
            runs.append(run_config6(mx, ev, mask, merging, "cuda"))
            peaks.append(torch.cuda.max_memory_allocated())
        launches[path] = {k: fn.launch_count for k, fn in kernels.items()}
        (ev_p, _, tr_p, w_plain), (ev_m, mg_m, tr_m, w_merge) = runs
        check_event_ids(ev_p, tuple(data.shape))
        check_merge_outputs(ev_m, mg_m, tuple(data.shape))
        if int(ev_m.attrs["total_merges"]) <= 0 or tr_m.dispatch_counts.get("partition", 0) <= 0:
            raise AssertionError(f"{path}: no merge or no partition: {ev_m.attrs}, {tr_m.dispatch_counts}")
        print(f"{path} {tuple(data.shape)}, {len(mg_m['n_parents'].values)} merge records ({smi}): " + json.dumps({
            "no_merge_wall_s": w_plain, "merge_wall_s": w_merge, "merge_overhead_x": w_merge / w_plain,
            "total_merges": int(ev_m.attrs["total_merges"]), "n_events_no_merge": int(ev_p.attrs["N_events_final"]),
            "n_events_merge": int(ev_m.attrs["N_events_final"]), "dispatch_counts": tr_m.dispatch_counts,
            "stage_walls_no_merge": tr_p.stage_walls, "stage_walls_merge": tr_m.stage_walls,
            "peak_bytes_no_merge": peaks[0], "peak_bytes_merge": peaks[1], "launches": launches[path]}))
        if ny == 180:
            t0 = time.perf_counter()
            ev_c, mask_c = config6_fields(mx, data.cpu())
            cpu_p = run_config6(mx, ev_c, mask_c, False, "cpu")
            cpu_m = run_config6(mx, ev_c, mask_c, True, "cpu")
            if not np.array_equal(ev_p["ID_field"].values, cpu_p[0]["ID_field"].values):
                raise AssertionError(f"{path}: the no-merge ID_field differs between CUDA and CPU")
            diff = compare_merge_runs(ev_m, mg_m, tr_m, cpu_m[0], cpu_m[1], path)
            for (g, c), what in (((ev_p, cpu_p[0]), "no-merge"), ((ev_m, cpu_m[0]), "merge")):
                if dict(g.attrs) != dict(c.attrs):
                    raise AssertionError(f"{path}: the {what} attrs differ between CUDA and CPU: {g.attrs} vs {c.attrs}")
            print(f"{path}: bit-identical to the CPU with and without merging (area, centroid max abs/rel "
                  f"{json.dumps(diff)}); the CPU's runs {cpu_p[3]:.1f} + {cpu_m[3]:.1f} s, "
                  f"{time.perf_counter() - t0:.1f} s with the copy")
            del ev_c, mask_c, cpu_p, cpu_m
        del data, ev, mask, runs, ev_p, ev_m, mg_m, tr_p, tr_m
        torch.cuda.empty_cache()
    return launches


# ---- phase 9: the entry module ----------------------------------------------------


def entry_phase(mx, seed: int, kernels: dict, smi: str) -> dict:
    """Phase 9, ``marex_tpu_torch.entry``: ``entry()`` on the card against
    ``entry(device="cpu")`` (labels and the event count bit for bit, the
    anomalies within 1e-5), then its step on config 1's SST at 1095 x 720 x
    1440 (``year_idx = t // 365``, ``doy_idx = t % 365``, a mask of ones),
    its launch counts set to 0 just before and read just after (the grid
    kernels and no other): its wall, launches and peak. Returns {"entry
    step": launch counts}."""
    from marex_tpu_torch.entry import _detect_track_step, entry

    fn, args = entry()
    anom_g, lab_g, n_g = fn(*args)
    fn_c, args_c = entry(device="cpu")
    anom_c, lab_c, n_c = fn_c(*args_c)
    if args[0].device.type != "cuda" or not torch.equal(lab_g.cpu(), lab_c) or n_g != n_c or n_g <= 0:
        raise AssertionError(f"entry(): the card's labels ({n_g} events) differ from the CPU's ({n_c})")
    err = float((anom_g.cpu() - anom_c).abs().max())
    if err > 1e-5:
        raise AssertionError(f"entry(): the card's anomalies are {err} from the CPU's")
    print(f"entry(): {tuple(lab_g.shape)}, {n_g} events, labels bit-identical to the CPU's, anomalies within {err}")

    sst, _ = make_sst(3, 720, 1440, seed, "cuda")
    T = sst.shape[0]
    t = torch.arange(T, device="cuda", dtype=torch.int32)
    mask = torch.ones(sst.shape[1:], dtype=torch.bool, device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    anom, labels, n = _detect_track_step(sst, t // 365, t % 365, mask)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: f.launch_count for k, f in kernels.items()}
    check_launches("entry step", counts)
    peak = torch.cuda.max_memory_allocated()
    if labels.dtype != torch.int32 or tuple(labels.shape) != tuple(sst.shape) or n <= 0 or int(labels.max()) != n:
        raise AssertionError(f"entry step: labels {labels.dtype} {tuple(labels.shape)}, max {int(labels.max())}, n {n}")
    if not bool((torch.isfinite(anom) == torch.isfinite(sst)).all()):
        raise AssertionError("entry step: non-finite anomalies where the SST is finite")
    print(f"entry step {tuple(sst.shape)}: {wall:.3f} s, {n} events, {sst.numel() / wall:.4g} gridpoint-days/s; "
          f"launches {json.dumps(counts)}; peak {peak} bytes ({peak / 2**30:.2f} GiB) ({smi})")
    return {"entry step": counts}


def mesh_filter_input(mx, seed: int):
    """The area filter's input on config 5 at 2 yr x 1,048,352 cells (the
    masked field after fill_spatial and fill_time), through the entry
    points, and the symmetrised table it is labelled on, both on the card."""
    sst, coords, nb, areas = make_mesh_sst(2, MESH_CELLS, seed, "cuda")
    ds = mx.preprocess_data(
        mx.Field(sst, ("time", "ncells"), coords, name="sst"), dimensions=MESH_DIMS, coordinates=MESH_COORDS,
        device="cuda", quiet=True, **DETECT_FIXED,
    )
    del sst
    tr = mx.tracker(ds.extreme_events, ds.mask, neighbours=mx.Field(nb, ("nv", "ncells")),
                    cell_areas=mx.Field(areas, ("ncells",)), device="cuda", quiet=True, **TRACK_CONFIG5)
    del ds
    data = (tr.fill_time_gaps(tr.fill_holes(tr.data_bin.data)) & tr.mask_dev).contiguous()
    return data, torch.from_numpy(tr.neighbours_sym).cuda()


def renumbered(data: torch.Tensor, table: torch.Tensor, seed: int):
    """A mesh's field and symmetrised table with its cells renumbered by a
    random permutation from ``seed`` (new cell j is old cell perm[j]): the
    same components, numbered unlike a lattice."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    perm = torch.randperm(table.shape[1], generator=g).to(table.device)
    inv = torch.argsort(perm).int()
    cols = table[:, perm]
    return data[:, perm].contiguous(), torch.where(cols >= 0, inv[cols.clamp_min(0).long()], -1).contiguous()


def mesh_fixpoint_labels(data: torch.Tensor, table: torch.Tensor, what: str) -> dict:
    """Phase 6, the mesh fixpoint on one field, run by hand with each launch
    timed: the list of active cells (``active_cells``), every ``graph_step``
    and ``graph_jump``, the fixpoint's wall and its bound (the mask read
    once, 8 B an active cell a step and a jump, the table once). At its
    iterations 1, 4 and 8 (as far as it gets) both kernels held against
    their plain versions on those labels (bit-identical; the jump also
    against the whole-field jump) and timed beside their bounds; at the
    middle one also beside their plain versions and the nearest single
    PyTorch calls (``mesh_yardsticks``). The list of active cells against
    its plain version and timed beside it, ``torch.nonzero`` and its bound
    (the mask read once, 8 B an entry written). Returns the kernels' JSON
    fields and the largest differences."""
    from marex_tpu_torch.ops.graph_step import active_cells, active_cells_plain, graph_jump, graph_step
    from marex_tpu_torch.ops.min_stencil import pointer_jump_plain

    T, C = data.shape
    K = table.shape[0]
    split = Split()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters, snaps = fused_fixpoint(data, False, split, keep=(1, 4, 8), neighbours=table)
    wall = time.perf_counter() - t0
    active = active_cells(data)
    n = active.numel()
    err = {"active_cells": max_abs_diff(active, active_cells_plain(data)), "graph_step": 0, "graph_jump": 0}
    t_list = cuda_ms(lambda: active_cells(data), reps=5)
    t_list_plain = cuda_ms(lambda: active_cells_plain(data), reps=3)
    t_nonzero = cuda_ms(lambda: data.view(-1).nonzero(), reps=3)
    b_list = bound_ms(T * C + 8 * n)
    # the 32-byte sectors of a (T, C) int32 field that hold active cells: what
    # a launch touches of each label buffer, where the bound counts 4 B a cell
    sectors = torch.unique_consecutive(active >> 3).numel()
    tiles = torch.unique_consecutive(active >> 12).numel()  # the compaction's 4096-cell tiles that it reads again
    print(f"active_cells {what}: == plain version (nonzero); {t_list:.4f} ms, plain {t_list_plain:.4f} ms, "
          f"torch.nonzero {t_nonzero:.4f} ms, bound {b_list:.4f} ms ({100 * b_list / t_list:.0f} % of it), "
          f"{tiles} of {-(-T * C // 4096)} tiles active; the "
          f"{n} active cells lie in {sectors} 32-byte sectors of a label field ({32 * sectors / (4 * n):.2f} bytes "
          f"moved a byte used): a launch that reads one label buffer and writes the other at them, and reads the "
          f"list, moves {bound_ms(8 * n + 64 * sectors):.4f} ms of bytes")
    t_bound = bound_ms(T * C + 8 * n * (2 * iters - 1) + 4 * K * C)
    launched = sum(split.ms.values())
    print(f"mesh fixpoint on config 5's field {what} ({n} active cells of {data.numel()}, K={K}): {iters} iterations, "
          f"wall {wall:.4f} s; summed launch ms {json.dumps(split.ms)}, {launched:.4f} ms in all against the "
          f"fixpoint's bound {t_bound:.4f} ms ({100 * t_bound / launched:.0f} % of it)")
    print(f"  each launch (ms): {json.dumps(split.each)}")
    out = torch.empty_like(data, dtype=torch.int32)
    b_step, b_jump = mesh_step_bound_ms(n, K, C), bound_ms(8 * n)
    middle = sorted(snaps)[len(snaps) // 2]
    result = {"active_cells": dict(ms=t_list, plain_ms=t_list_plain, bound_ms=b_list, bound_by="bytes",
                                   library_ms=t_nonzero)}
    for k in sorted(snaps):
        a, b = snaps.pop(k)
        err["graph_step"] = max(err["graph_step"], graph_step_diff(a, active, table, b))
        hooked = b.clone()
        graph_step(a, active, table, hooked)  # the jump's input
        jumped = graph_jump(hooked, active, out=a.clone())
        err["graph_jump"] = max(err["graph_jump"], graph_jump_diff(hooked, active, a),
                                max_abs_diff(jumped, pointer_jump_plain(hooked, C)))
        del jumped
        if any(err.values()):
            raise AssertionError(f"config 5's labels {what} at iteration {k}: kernels against their plain versions {err}")
        t_step = cuda_ms_fresh(lambda: graph_step(a, active, table, out), lambda: out.copy_(b))
        t_jump = cuda_ms(lambda: graph_jump(hooked, active, out=out), reps=5)
        line = (f"mesh iteration {k} {what}: graph_step and graph_jump == plain versions at {tuple(a.shape)}; "
                f"graph_step {t_step:.4f} ms, bound {b_step:.4f} ms ({100 * b_step / t_step:.0f} % of it); "
                f"graph_jump {t_jump:.4f} ms, bound {b_jump:.4f} ms ({100 * b_jump / t_jump:.0f} % of it)")
        if k == middle:
            y = mesh_yardsticks(a, active, table, b, hooked, reps=1)
            line += (f"; plain step {y['step_plain']:.4f} ms, plain jump {y['jump_plain']:.4f} ms; library "
                     f"index_select of the {K} table rows {y['index_select']:.4f} ms, take of the listed cells' "
                     f"neighbours {y['take_step']:.4f} ms, take of the jump's targets {y['take_jump']:.4f} ms; the "
                     f"listed cells' labels moved between the buffers (take, index_put_) {y['move']:.4f} ms; hook "
                     f"scatter_reduce amin {y['scatter']:.4f} ms ({y['hooked']} cells with m < lab)")
            result["graph_step"] = dict(ms=t_step, plain_ms=y["step_plain"], bound_ms=b_step, bound_by="bytes",
                                        library_ms=y["take_step"])
            result["graph_jump"] = dict(ms=t_jump, plain_ms=y["jump_plain"], bound_ms=b_jump, bound_by="bytes",
                                        library_ms=y["take_jump"])
        print(line)
        del a, b, hooked
        torch.cuda.empty_cache()
    return result, err


def mesh_past_2_31(data: torch.Tensor, table: torch.Tensor, T_long: int = 2100, first: int = 2040) -> dict:
    """Phase 6 past 2**31 cells: a (``T_long``, C) field, empty but for
    slices ``first``.. (slice 2048 holds cell 2**31 - 1), which hold the
    first ``T_long - first`` slices of ``data``. ``label_slices_unstructured``
    must give them the labels, counts and iterations, bit for bit, that it
    gives those slices alone; then the fixpoint by hand, each step and jump
    held against its plain version on those slices, whose list entries,
    slice bases and hook targets need 64 bits, and the list against its
    plain version. Returns the largest differences."""
    from marex_tpu_torch.ops.graph_step import (
        active_cells,
        active_cells_plain,
        graph_jump,
        graph_jump_plain,
        graph_step,
        graph_step_active_plain,
    )
    from marex_tpu_torch.ops.label import label_slices_unstructured

    n_sl = T_long - first
    C = data.shape[1]
    part = data[:n_sl].contiguous()
    want_lab, want_counts, want_it = label_slices_unstructured(part, table)
    field = torch.zeros((T_long, C), dtype=torch.bool, device=data.device)
    field[first:] = part
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lab, counts, iters = label_slices_unstructured(field, table)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = (torch.equal(lab[first:], want_lab) and torch.equal(counts[first:], want_counts) and iters == want_it
            and not bool(lab[:first].any()) and not bool(counts[:first].any()))
    if not same:
        raise AssertionError(f"mesh CCL past 2**31 cells: slices {first}.. differ from the {n_sl} slices alone "
                             f"({iters} vs {want_it} iterations)")
    print(f"mesh CCL on ({T_long}, {C}) ({field.numel()} cells; slices {first}..{T_long - 1} hold config 5's first "
          f"{n_sl}, {int(part.sum())} active cells): labels, counts and {iters} iterations == the {n_sl} slices alone; "
          f"wall {wall:.4f} s")
    del lab, counts, want_lab, want_counts
    torch.cuda.empty_cache()
    # by hand: both kernels on the whole field against their plain versions on slices first.. alone
    active = active_cells(field)
    err = {"active_cells": max_abs_diff(active, active_cells_plain(field)), "graph_step": 0, "graph_jump": 0}
    local = active - first * C
    a = torch.arange(C, dtype=torch.int32, device=data.device).repeat(T_long).view(T_long, C).masked_fill_(~field, BIG)
    b = torch.full_like(a, BIG)
    lowered = 0
    for it in range(1, want_it + 1):
        before = b[first:].clone()
        want_b = before.clone()
        flag_p = int(graph_step_active_plain(a[first:], local, table, want_b))
        flag = int(graph_step(a, active, table, b))
        lowered += int((want_b != before).sum())
        err["graph_step"] = max(err["graph_step"], abs(flag - flag_p), max_abs_diff(b[first:], want_b))
        del before, want_b
        if not flag:
            break
        want_a = graph_jump_plain(b[first:], local, a[first:].clone())
        graph_jump(b, active, out=a)
        err["graph_jump"] = max(err["graph_jump"], max_abs_diff(a[first:], want_a))
        del want_a
    if any(err.values()) or flag or it != want_it or not lowered:
        raise AssertionError(f"mesh kernels past 2**31 cells against their plain versions: {err}, {it} iterations "
                             f"(want {want_it}), {lowered} cells lowered")
    print(f"mesh fixpoint by hand on ({T_long}, {C}): active_cells, graph_step and graph_jump bit-identical to their "
          f"plain versions (tolerance 0) on slices {first}..{T_long - 1} at each of {it} iterations (list entries "
          f"{int(active[0])}..{int(active[-1])}; slice 2048 holds cell 2**31 - 1)")
    del field, a, b, active, local
    torch.cuda.empty_cache()
    return err


def mesh_labels(mx, seed: int):
    """Phase 6, the mesh fixpoint on config 5's own field (the area filter's
    input at 2 yr x 1,048,352 cells, through the entry points) as numbered
    and with its cells renumbered by a random permutation from ``seed``
    (``mesh_fixpoint_labels``; both numberings give the same component
    counts), then past 2**31 cells (``mesh_past_2_31``). Returns the
    kernels' JSON fields (as numbered) and the largest differences."""
    from marex_tpu_torch.ops.label import label_slices_unstructured

    data, table = mesh_filter_input(mx, seed)
    result, err = mesh_fixpoint_labels(data, table, "as numbered")
    counts = label_slices_unstructured(data, table)[1]
    data_p, table_p = renumbered(data, table, seed)
    _, err_p = mesh_fixpoint_labels(data_p, table_p, "renumbered")
    counts_p = label_slices_unstructured(data_p, table_p)[1]
    if not torch.equal(counts, counts_p):
        raise AssertionError("config 5's field renumbered: per-slice component counts differ from the field as numbered")
    del data_p, table_p
    torch.cuda.empty_cache()
    err_long = mesh_past_2_31(data, table)
    return result, {k: max(err[k], err_p[k], err_long[k]) for k in err}


# ---- phase 7: plotX's preparation on the paths' outputs ----------------------

PLOT_PERCENTILES = [4, 96]  # PlotConfig's default cperc


def limits_host(sample: np.ndarray) -> dict:
    """The reference's robust colour limits (``clim_robust`` of
    ``marex_tpu/plotX/base.py``: ``np.percentile`` of the finite values) of a
    host sample, with ``issym`` on (True) and off (False): phase 7's oracle."""
    vals = sample[np.isfinite(sample)]
    if vals.size == 0:
        return {True: (0.0, 1.0), False: (0.0, 1.0)}
    lo, hi = np.percentile(vals, PLOT_PERCENTILES)
    m = max(abs(lo), abs(hi))
    return {True: (-m, m), False: (float(lo), float(hi))}


def same_scalar(got, want) -> bool:
    """Equal to the bit, with numpy's type."""
    return type(got) is type(want) and np.asarray(got).tobytes() == np.asarray(want).tobytes()


def prep_against_host(mx, what: str, payload, host: np.ndarray, dims: tuple, ids: bool, device: str,
                      lonlat=None) -> dict:
    """Phase 7 on one payload (a tensor on ``device``, or a lazy zarr array)
    against its host copy: the NaN-ignoring max against ``np.nanmax`` (for an
    ID field on the device, of its ``where(> 0)`` view too); the robust limits of every tenth
    slice against ``np.percentile`` with ``issym`` on and off; frames 0, T/2
    and T-1 as drawn (masked for an ID field). Bit for bit; prints each
    step's wall and the bytes it brought to the host beside what the
    reference's pattern pulls (a lazy payload's are read from disk), and on a
    mesh the wall of the 1-degree kd-tree regrid of each frame (its equality
    with the reference's regrid is ``tests/test_torch_plotx.py``'s). Returns
    {step: (wall, bytes)}."""
    from marex_tpu_torch.io import zarr_lite
    from marex_tpu_torch.plotX import prep
    from marex_tpu_torch.plotX.unstructured import kdtree_regrid

    out = {}
    lazy = isinstance(payload, zarr_lite.LazyZarrArray)
    decompressed = []  # a lazy payload's chunk bytes, counted where each chunk is decompressed
    decompress = zarr_lite._decompress

    def counted(raw, comp):
        chunk = decompress(raw, comp)
        decompressed.append(len(chunk))
        return chunk

    def step(name: str, fn, reference: str):
        prep.pull.bytes = 0
        decompressed.clear()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if lazy:
            zarr_lite._decompress = counted
        try:
            got = fn()
        finally:
            zarr_lite._decompress = decompress
        if device == "cuda":
            torch.cuda.synchronize()
        moved = sum(decompressed) if lazy else prep.pull.bytes
        out[name] = (time.perf_counter() - t0, moved)
        where = "read from disk (chunk bytes decompressed)" if lazy else "to the host"
        print(f"  {what} {name}: {out[name][0]:.4f} s, {moved} bytes {where} (the reference's pattern: {reference})")
        return got

    T = host.shape[0]
    slice_bytes = host[0].nbytes
    got = step("nanmax", lambda: prep.nanmax(payload), f"{host.nbytes} bytes, the whole field")
    want = np.nanmax(host)
    if not same_scalar(got, want):
        raise AssertionError(f"{what}: nanmax {got!r} != np.nanmax {want!r}")
    if ids and isinstance(payload, torch.Tensor):
        # the view's max is the largest ID above 0, as float64 (IDs are >= 0)
        got = step("nanmax of where(> 0)", lambda: prep.nanmax(prep.PositiveOnly(payload)),
                   f"{host.nbytes} bytes, and a float64 copy of {8 * host.size} bytes")
        if not (want > 0 and same_scalar(got, np.float64(want))):
            raise AssertionError(f"{what}: nanmax of the view {got!r}, the field's max {want!r}")
    sample = host[::10]
    want = limits_host(sample)
    for issym in (True, False):
        got = step(f"robust limits issym={issym}",
                   lambda: prep.robust_limits(payload, issym, PLOT_PERCENTILES, axis=0),
                   f"{sample.nbytes} bytes, every tenth slice")
        if len(got) != 2 or not all(same_scalar(g, w) for g, w in zip(got, want[issym])):
            raise AssertionError(f"{what}: robust limits issym={issym} {got!r} != np.percentile's {want[issym]!r}")
    field = mx.Field(prep.PositiveOnly(payload) if ids else payload, dims, name=what)
    for t in (0, T // 2, T - 1):
        # the reference masks an ID field whole, once: it pulls the field and makes a float64 copy
        frame = step(f"frame {t}", lambda: prep.host_frame(field, "time", t).data,
                     f"{slice_bytes} bytes" + (", after the whole field masked once" if ids else ""))
        want = np.where(host[t] > 0, host[t], np.nan) if ids else host[t]
        if not (isinstance(frame, np.ndarray) and same_bits(frame, want)):
            raise AssertionError(f"{what}: frame {t} differs from the host copy's")
        if lonlat is not None:
            t0 = time.perf_counter()
            raster = kdtree_regrid(*lonlat, np.asarray(frame, dtype=float), 1.0)[2]
            print(f"  {what} frame {t} regridded to 1 degree {raster.shape}: {time.perf_counter() - t0:.4f} s on "
                  f"the host" + (" (the tree built and cached)" if t == 0 else ""))
    return out


def figure_arrays(fig) -> list:
    """What a figure shows: each axes' title, colourbar extend, and each
    artist's array and mask, colour limits and norm boundaries."""
    out = []
    for ax in fig.axes:
        cb = getattr(ax, "_colorbar", None)
        out.append((ax.get_title(), None if cb is None else cb.extend, [
            (type(c).__name__, np.ma.getdata(c.get_array()), np.ma.getmaskarray(c.get_array()), c.get_clim(),
             getattr(c.norm, "boundaries", None)) for c in ax.collections if c.get_array() is not None]))
    return out


def same_figures(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(same_figures(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.shape == b.shape and same_bits(a, b)
    return a == b or (a != a and b != b)


def render_against_host(mx, ids_card, ids_host, anom_card, anom_host, workdir: str) -> None:
    """Phase 7 with matplotlib: ``single_plot(plot_IDs=True)`` of the ID field,
    a 3-panel ``multi_plot`` of the anomalies and a 5-frame ``animate`` of the
    ID field, each drawn from the card's payload and from the host copy; the
    artists' arrays, limits, norms, titles and colourbars, and the animation's
    file, must be the same."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t0 = time.perf_counter()
    figs = [f.plotX().single_plot(mx.PlotConfig(plot_IDs=True, title="events"))[0] for f in (ids_card, ids_host)]
    if not same_figures(*[figure_arrays(f) for f in figs]):
        raise AssertionError("single_plot(plot_IDs=True): the card's figure differs from the host copy's")
    plt.close("all")
    figs = [f.isel(time=slice(0, 3)).plotX().multi_plot(mx.PlotConfig(issym=True), col="time", col_wrap=3)[0]
            for f in (anom_card, anom_host)]
    if not same_figures(*[figure_arrays(f) for f in figs]):
        raise AssertionError("multi_plot: the card's figure differs from the host copy's")
    plt.close("all")
    files = [f.isel(time=slice(0, 5)).plotX().animate(mx.PlotConfig(plot_IDs=True), plot_dir=os.path.join(workdir, k),
                                                        file_name="events")
             for k, f in (("card", ids_card), ("host", ids_host))]
    if files[0].endswith(".gif"):
        from PIL import Image, ImageSequence

        frames = []
        for path in files:
            with Image.open(path) as img:
                frames.append([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(img)])
        same = len(frames[0]) == len(frames[1]) == 5 and all(np.array_equal(a, b) for a, b in zip(*frames))
    else:
        with open(files[0], "rb") as a, open(files[1], "rb") as b:
            same = a.read() == b.read()
    if not same:
        raise AssertionError(f"animate: {files[0]} differs from {files[1]}")
    print(f"  plotX drew single_plot(plot_IDs=True), a 3-panel multi_plot and a 5-frame animate from the card's "
          f"payloads == from the host copies ({time.perf_counter() - t0:.1f} s)")


def plot_phase(mx, inputs: dict, device: str, workdir: str) -> dict:
    """Phase 7, plotX on the paths' outputs: config 4's ``ID_field`` and
    ``dat_anomaly``, config 5's ``ID_field`` with its mesh's lon/lat and
    config 8's lazy ``ID_field``, each prepared for plotting (on the card,
    or a chunk at a time from the store) and held against its host copy
    (:func:`prep_against_host`); then either drawn both ways
    (:func:`render_against_host`) or, without matplotlib, ``plotX()`` must
    raise the port's ``DependencyError`` naming it. ``inputs`` holds the host
    copies; each is copied to ``device`` in turn. Returns {payload: steps}."""
    from marex_tpu_torch.io import zarr_lite

    steps = {}
    c4 = inputs["config 4"]
    grid = ("time", "lat", "lon")
    for key, ids in (("ID_field", True), ("dat_anomaly", False)):
        t0 = time.perf_counter()
        card = torch.from_numpy(c4[key]).to(device)
        print(f"  config 4 {key} {tuple(card.shape)} {card.dtype} on {device} ({time.perf_counter() - t0:.2f} s "
              f"to copy back from the host)")
        steps[f"config 4 {key}"] = prep_against_host(mx, f"config 4 {key}", card, c4[key], grid, ids, device)
        del card
    c5 = inputs["config 5"]
    card = torch.from_numpy(c5["ID_field"]).to(device)
    steps["config 5 ID_field"] = prep_against_host(mx, "config 5 ID_field", card, c5["ID_field"], ("time", "ncells"),
                                                   True, device, lonlat=(c5["lon"], c5["lat"]))
    del card
    lazy = zarr_lite.open_zarr(inputs["config 8"], lazy=True)["ID_field"]
    print(f"  config 8 ID_field: lazy, {lazy.data.shape} in chunks of {lazy.data.chunks}")
    steps["config 8 ID_field"] = prep_against_host(mx, "config 8 ID_field", lazy.data, c4["ID_field"], grid, True,
                                                   "cpu")

    coords = c4["coords"]
    ids_card = mx.Field(torch.from_numpy(c4["ID_field"]).to(device), grid, coords, name="ID_field")
    if mx.has_dependency("matplotlib"):
        anom_card = mx.Field(torch.from_numpy(c4["dat_anomaly"]).to(device), grid, coords, name="dat_anomaly")
        render_against_host(mx, ids_card, mx.Field(c4["ID_field"], grid, coords, name="ID_field"), anom_card,
                            mx.Field(c4["dat_anomaly"], grid, coords, name="dat_anomaly"), workdir)
        del anom_card
    else:
        try:
            ids_card.plotX()
        except mx.DependencyError as e:
            if "matplotlib" not in str(e):
                raise AssertionError(f"plotX() without matplotlib raised a DependencyError not naming it: {e}")
            print("  matplotlib is absent: events.ID_field.plotX() raised DependencyError naming matplotlib")
        else:
            raise AssertionError("plotX() made a plotter without matplotlib")
    del ids_card
    return steps


# ---- phase 8: the multi-device layer in a world of one NCCL rank ---------------

# the paths phase 8 runs on a mesh: the two full-size ones whose outputs phase
# 5 digested, by phase 5's names
MESH_FULL_PATHS = (("merge path (config 4)", True), ("config 1", False))


def digest(x) -> str:
    """A content digest of an array or tensor (a DTensor gathered), computed on
    its own device: its dtype, its shape and two position-weighted int64 sums
    of its elements' bits (wrapping), over chunks of 2**26 elements. Equal
    for the same bits whatever the device or the kind of array."""
    from marex_tpu_torch.core.field import gathered

    x = gathered(x)
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(x)
        x = torch.from_numpy(a.view(np.int64) if a.dtype.kind in "mM" else a)
    flat = x.reshape(-1)
    if flat.dtype in (torch.float32, torch.float64):
        flat = flat.view(torch.int32 if flat.dtype == torch.float32 else torch.int64)
    sums = [0, 0]
    for a in range(0, flat.numel(), 1 << 26):
        v = flat[a : a + (1 << 26)].to(torch.int64)
        idx = torch.arange(a, a + v.numel(), dtype=torch.int64, device=v.device)
        for i, mult in enumerate((0x9E3779B97F4A7C1, 0x632BE59BD9B4E01)):
            sums[i] = (sums[i] + int(((idx * mult + 1) * (v + 0x5851F42D)).sum())) & (2**64 - 1)
    return f"{str(x.dtype).removeprefix('torch.')}{tuple(x.shape)}:{sums[0]:016x}{sums[1]:016x}"


def dryrun_counts(line: str) -> dict:
    """The counts of a ``dryrun_multichip OK: ...`` line, by name."""
    return {k: int(v) for k, v in re.findall(r", ([a-z_+ ]+)=(\d+)", line)}


def digests(ds, events, merges) -> dict:
    """Digests of a path's detect outputs, events and merge records, and its
    attrs (JSON)."""
    out = {f"detect/{k}": digest(ds[k].data) for k in ("dat_anomaly", "extreme_events", "thresholds", "mask")}
    out.update({f"events/{k}": digest(events[k].data) for k in events.data_vars})
    if merges is not None:
        out.update({f"merges/{k}": digest(merges[k].data) for k in merges.data_vars})
    out["attrs"] = json.dumps(dict(events.attrs), sort_keys=True, default=str)
    return out


def mesh_child(seed: int) -> int:
    """Phase 8's process, one rank of a ``torch.distributed`` world started
    from ``torchrun``'s variables: ``start_distributed_cluster()`` (NCCL), then
    every path below through the entry points with ``mesh=True``. Prints, as
    its last line, each path's digests, walls, peak memory and launches."""
    import torch.distributed as dist

    import marex_tpu_torch as mx
    from marex_tpu_torch.ops.graph_step import active_cells, graph_jump, graph_step
    from marex_tpu_torch.ops.min_stencil import ccl_step, pointer_jump
    from marex_tpu_torch.ops.partition import partition_children_grid_batched

    info = mx.start_distributed_cluster()
    print(f"rank {info.process_index} of {info.n_processes} ({info.extra}) on cuda:{torch.cuda.current_device()}")
    kernels = {"ccl_step": ccl_step, "pointer_jump": pointer_jump, "active_cells": active_cells,
               "graph_step": graph_step, "graph_jump": graph_jump, "partition": partition_children_grid_batched}
    out = {}

    def counted(name: str, fn, mesh):
        """``fn()`` with the launch counts set to 0 just before and read just
        after; a mesh run's outputs must be DTensors."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launch_count = 0
        res = fn()
        out[name]["launches"] = {k: f.launch_count for k, f in kernels.items()}
        out[name]["peak"] = torch.cuda.max_memory_allocated()
        split = [type(res[0]["extreme_events"].data).__name__] + [type(r["ID_field"].data).__name__ for r in res[1:]]
        if mesh and set(split) != {"DTensor"}:
            raise AssertionError(f"phase 8, {name}: the outputs are not DTensors: {split}")

    def path(name: str, detect, make_tracker, merge: bool, mesh):
        def fn():
            ds, events, merges, tr, t_det, t_trk, det_peak = run_path("cuda", detect, make_tracker, merge)
            out[name] = dict(detect_s=t_det, track_s=t_trk, detect_peak=det_peak, stage_walls=tr.stage_walls,
                             digests=digests(ds, events, merges))
            return ds, events
        counted(name, fn, mesh)

    def detect_only(name: str, detect, mesh):
        def fn():
            t0 = time.perf_counter()
            ds = detect()
            torch.cuda.synchronize()
            out[name] = dict(detect_s=time.perf_counter() - t0, track_s=0.0,
                             digests={f"detect/{k}": digest(ds[k].data) for k in ds.data_vars})
            return (ds,)
        counted(name, fn, mesh)

    # the small paths first (they also warm the kernels and NCCL), each also run
    # without a mesh here, on the same input
    half, half_coords = make_sst(3, 90, 360, seed, "cuda")
    hfield = mx.Field(half, ("time", "lat", "lon"), half_coords, name="sst")
    for key, mesh in (("config 2 detect", None), ("config 2 detect (mesh)", True)):
        detect_only(key, lambda: mx.preprocess_data(hfield, device="cuda", quiet=True, mesh=mesh, **DETECT_CONFIG2), mesh)
    del half, hfield
    msst, mcoords, nb, areas = make_mesh_sst(2, 32768, seed, "cuda")
    mfield = mx.Field(msst, ("time", "ncells"), mcoords, name="sst")
    for key, mesh in (("config 5", None), ("config 5 (mesh)", True)):
        path(key,
             lambda: mx.preprocess_data(mfield, dimensions=MESH_DIMS, coordinates=MESH_COORDS,
                                        neighbours=mx.Field(nb, ("nv", "ncells"), name="neighbours"),
                                        cell_areas=mx.Field(areas, ("ncells",), name="cell_areas"), device="cuda",
                                        quiet=True, mesh=mesh, **DETECT_FIXED),
             lambda ds: mx.tracker(ds.extreme_events, ds.mask, neighbours=ds.neighbours, cell_areas=ds.cell_areas,
                                   device="cuda", quiet=True, mesh=mesh, **TRACK_CONFIG5),
             True, mesh)
    del msst, mfield

    # configs 4 and 1 at full width; phase 5 ran them without a mesh
    sst, coords = make_sst(3, 720, 1440, seed, "cuda")
    field = mx.Field(sst, ("time", "lat", "lon"), coords, name="sst")
    for name, merge in MESH_FULL_PATHS:
        path(f"{name} (mesh)", lambda: mx.preprocess_data(field, device="cuda", quiet=True, mesh=True, **DETECT_FIXED),
             lambda ds: mx.tracker(ds.extreme_events, ds.mask, device="cuda", quiet=True, mesh=True,
                                   **track_kwargs(720, merge)), merge, True)
    del sst, field

    # the entry module's dry run, joining this world: its four drives on a mesh of one rank
    from marex_tpu_torch.entry import dryrun_multichip

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launch_count = 0
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        dryrun_multichip(1)
    torch.cuda.synchronize()
    line = [ln for ln in printed.getvalue().splitlines() if ln.startswith("dryrun_multichip OK")][-1]
    out["dryrun (1 rank)"] = dict(line=line, counts=dryrun_counts(line), wall=time.perf_counter() - t0,
                                  peak=torch.cuda.max_memory_allocated(),
                                  launches={k: f.launch_count for k, f in kernels.items()})

    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def mesh_world(seed: int, phase5: dict, smi: str) -> dict:
    """Phase 8: ``chip_smoke.py --mesh-child`` in a child process with
    ``torchrun``'s variables for a world of one rank (``RANK=0
    WORLD_SIZE=1 LOCAL_RANK=0``, a free port). Each of its mesh runs must
    equal the run without a mesh bit for bit: configs 4 and 1 at full width
    against phase 5's digests, config 2's detect and config 5 at phase 4's
    sizes against the child's own runs without a mesh; each must have
    launched the kernels it labels on and no other. Returns the mesh runs'
    launch counts, by path."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--mesh-child", "--seed", str(seed)],
                           env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"phase 8: the one-rank world failed ({child.returncode}):\n"
                             f"{child.stdout[-3000:]}\n{child.stderr[-6000:]}")
    lines = child.stdout.strip().splitlines()
    print(f"  child: {lines[0]}")
    runs = json.loads(lines[-1])
    want = {f"{path} (mesh)": phase5[path] for path, _ in MESH_FULL_PATHS}
    want.update({"config 2 detect (mesh)": runs["config 2 detect"]["digests"],
                 "config 5 (mesh)": runs["config 5"]["digests"]})
    launches = {}
    for name, expected in want.items():
        got = runs[name]
        bad = sorted(k for k in expected if got["digests"].get(k) != expected[k])
        if bad or set(got["digests"]) != set(expected):
            raise AssertionError(f"phase 8, {name}: differs from the run without a mesh in {bad}")
        counts = got["launches"]
        check_launches(name, counts)
        launches[f"phase 8 {name}"] = counts
        print(f"phase 8, {name}: bit-identical to the run without a mesh ({len(expected)} digests); "
              f"detect {got['detect_s']:.3f} s, track {got['track_s']:.3f} s; peak {got['peak']} bytes "
              f"({got['peak'] / 2**30:.2f} GiB); launches {json.dumps(counts)}")
        if got.get("stage_walls"):
            print(f"  stage_walls: {json.dumps(got['stage_walls'])}")
    for name in ("config 2 detect", "config 5"):
        got = runs[name]
        print(f"phase 8, {name} without a mesh, in the child: detect {got['detect_s']:.3f} s, "
              f"track {got['track_s']:.3f} s; peak {got['peak']} bytes ({got['peak'] / 2**30:.2f} GiB)")
    dry = runs["dryrun (1 rank)"]
    if dry["counts"] != DRYRUN_PORT:
        raise AssertionError(f"phase 8, dryrun_multichip(1): {dry['counts']}, where the CPU's are {DRYRUN_PORT}")
    check_launches("dryrun (1 rank)", dry["launches"])
    launches["dryrun (1 rank)"] = dry["launches"]
    print(f"phase 8, dryrun_multichip(1) in the one-rank world: {dry['wall']:.3f} s, peak {dry['peak']} bytes "
          f"({dry['peak'] / 2**30:.2f} GiB); launches {json.dumps(dry['launches'])}; counts as on the CPU, the "
          f"reference's but for the grid drive's detrend fit ({json.dumps(DRYRUN_REFERENCE)}):\n  {dry['line']}")
    print(f"phase 8: a world of one NCCL rank, {len(want)} mesh runs equal to the runs without a mesh, {wall:.1f} s "
          f"in all, the first mesh run (config 2's detect) with the world's setup ({smi})")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-child", action="store_true", help=argparse.SUPPRESS)  # phase 8's world of one rank
    args = ap.parse_args()
    if args.mesh_child:
        return mesh_child(args.seed)

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
    from marex_tpu_torch.ops.graph_step import active_cells, graph_jump, graph_step
    from marex_tpu_torch.ops.min_stencil import (
        ccl_step,
        ccl_step_plain,
        min_stencil,
        min_stencil_plain,
        pointer_jump,
        pointer_jump_plain,
        spacetime_min_plain,
    )
    from marex_tpu_torch.ops.partition import partition_children_grid_batched

    # ---- 2. build ---------------------------------------------------------
    _cuda_build.kernel_library()
    print(f"build: {_cuda_build.last_build_seconds:.1f} s")
    for line in _cuda_build.last_build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    # the merge path's host union-find (marex_tpu_torch/csrc/marex_host.cpp, built by g++)
    if not _native.has_native():
        raise AssertionError("the host union-find library (marex_tpu_torch/csrc/marex_host.cpp) did not build")
    print(f"native: {_native.get_lib()._name}")

    # ---- 3. kernels against their plain versions --------------------------
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    err = {"ccl_step": 0, "pointer_jump": 0, "partition": 0}
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

    def check_step(lab, data, depth3: bool, wrap_x: bool, out0: torch.Tensor, what: str) -> None:
        """The fused step against its plain version from copies of out0:
        output and flag."""
        nonlocal n_checks
        out_k, out_p = out0.clone(), out0.clone()
        flag_k = ccl_step(lab, data, out_k, depth3=depth3, wrap_x=wrap_x)
        flag_p = ccl_step_plain(lab, data, out_p, depth3=depth3, wrap_x=wrap_x)
        diff = max(max_abs_diff(out_k, out_p), abs(int(flag_k) - int(flag_p)))
        del out_k, out_p
        if diff:
            raise AssertionError(f"ccl_step {what}: max diff {diff}")
        n_checks += 1

    # ragged widths (13, 5, 1, 70), partial strips (W = 132) and the main
    # path's own shape (3 yr x 720 x 1440), at which its CCLs call every
    # kernel: per slice (hook slice H*W) and over the whole block (T*H*W)
    cases = [(s, (0.1, 0.6)) for s in [(5, 7, 13), (3, 720, 1440), (1, 1, 5), (2, 3, 1), (9, 33, 64), (3, 17, 70),
                                       (2, 9, 132)]]
    cases.append(((int(3 * 365.25), 720, 1440), (0.6,)))
    for shape, densities in cases:
        T, H, W = shape
        for density in densities:
            data = torch.rand(shape, generator=g, device="cuda") < density
            for depth3 in (False, True):
                slice_size = T * H * W if depth3 else H * W
                lab = torch.randint(0, slice_size, shape, generator=g, device="cuda", dtype=torch.int32)
                lab.masked_fill_(~data & (torch.rand(shape, generator=g, device="cuda") < 0.5), BIG)
                what = f"{shape} density={density}"
                if not depth3:
                    for masked in (True, False):
                        for wrap_x in (True, False):
                            d = data if masked else None
                            check(
                                "ccl_step",
                                lambda: min_stencil(lab, d, masked=masked, wrap_x=wrap_x),
                                lambda: min_stencil_plain(lab, d, masked=masked, wrap_x=wrap_x),
                                f"{what} min_stencil masked={masked} wrap_x={wrap_x}",
                            )
                for wrap_x in (True, False):
                    out0 = torch.full_like(lab, BIG)
                    check_step(lab, data, depth3, wrap_x, out0, f"{what} depth3={depth3} wrap_x={wrap_x} out=BIG")
                    # a stale field >= m, as the previous iteration's hooked field is
                    out0 = spacetime_min_plain(lab, data, wrap_x) if depth3 else min_stencil_plain(lab, data, True, wrap_x)
                    up = torch.randint(0, 3, shape, generator=g, device="cuda", dtype=torch.int32)
                    out0 = torch.where(out0 >= BIG - 2, out0, out0 + up)
                    del up
                    check_step(lab, data, depth3, wrap_x, out0, f"{what} depth3={depth3} wrap_x={wrap_x} out=stale")
                    del out0
                check("pointer_jump", lambda: pointer_jump(lab, slice_size),
                      lambda: pointer_jump_plain(lab, slice_size), f"{what} slice_size={slice_size}")
                del lab
            del data
            torch.cuda.empty_cache()
    print(f"kernels: {n_checks} checks bit-identical to the plain versions (tolerance 0), "
          f"up to the main path's shape {cases[-1][0]}")

    # each kernel at (64, 720, 1440) on random labels, beside its plain
    # version and the nearest single PyTorch call (never called by the port)
    shape = (64, 720, 1440)
    N = 64 * 720 * 1440
    lab = torch.randint(0, 720 * 1440, shape, generator=g, device="cuda", dtype=torch.int32)
    data = torch.rand(shape, generator=g, device="cuda") < 0.3
    lab3 = torch.randint(0, N, shape, generator=g, device="cuda", dtype=torch.int32)
    out = torch.empty_like(lab)
    big = torch.full_like(lab, BIG)
    xp, xp3 = neg_padded(lab), neg_padded(lab3, depth3=True)
    flat = lab.view(64, -1)
    gidx = flat.long()
    random_times = {
        "ccl_step 2-D": (
            cuda_ms_fresh(lambda: ccl_step(lab, data, out), lambda: out.copy_(big)),
            cuda_ms_fresh(lambda: ccl_step_plain(lab, data, out), lambda: out.copy_(big), reps=2),
            cuda_ms(lambda: torch.nn.functional.max_pool2d(xp, 3, stride=1)), bound_ms(9 * N),
        ),
        "ccl_step 3-D": (
            cuda_ms_fresh(lambda: ccl_step(lab3, data, out, depth3=True), lambda: out.copy_(big)),
            cuda_ms_fresh(lambda: ccl_step_plain(lab3, data, out, depth3=True), lambda: out.copy_(big), reps=2),
            cuda_ms(lambda: torch.nn.functional.max_pool3d(xp3, 3, stride=1)), bound_ms(9 * N),
        ),
        "min_stencil masked": (
            cuda_ms(lambda: min_stencil(lab, data, masked=True)),
            cuda_ms(lambda: min_stencil_plain(lab, data, masked=True)),
            cuda_ms(lambda: torch.nn.functional.max_pool2d(xp, 3, stride=1)), bound_ms(9 * N),
        ),
        "min_stencil plain": (
            cuda_ms(lambda: min_stencil(lab, masked=False)),
            cuda_ms(lambda: min_stencil_plain(lab, masked=False)),
            cuda_ms(lambda: torch.nn.functional.max_pool2d(xp, 3, stride=1)), bound_ms(8 * N),
        ),
        "pointer_jump": (
            cuda_ms(lambda: pointer_jump(lab, 720 * 1440)),
            cuda_ms(lambda: pointer_jump_plain(lab, 720 * 1440)),
            cuda_ms(lambda: torch.gather(flat, 1, gidx)), bound_ms(8 * N),
        ),
    }
    for k, (t_kernel, t_plain, t_lib, t_bound) in random_times.items():
        print(f"time {k} at {shape}, random labels: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, "
              f"library {t_lib:.4f} ms, bound {t_bound:.4f} ms ({100 * t_bound / t_kernel:.0f} % of it)")
    del lab, data, lab3, out, big, xp, xp3, flat, gidx
    torch.cuda.empty_cache()

    # the mesh kernels: against their plain versions, then timed at (64, 1048352)
    n_graph, mesh_err = graph_step_against_plain(g, args.seed)
    err.update(mesh_err)
    print(f"active_cells, graph_step, graph_jump: {n_graph} checks bit-identical to the plain versions (tolerance 0), up to config "
          f"5's own shape ({MESH_DAYS} slices of the mesh of {MESH_CELLS} cells asked for)")
    graph_step_random_times(g)
    torch.cuda.empty_cache()
    n_part = partition_against_plain(g)
    print(f"partition: {n_part} checks bit-identical to the plain version (tolerance 0), at 720 x 1440, 719 x 1441 "
          f"and ragged small shapes")
    torch.cuda.empty_cache()

    # ---- 4. the paths, CUDA against CPU, at small sizes ---------------------
    slices_against_cpu(mx, 180, 360, args.seed, "cuda")
    torch.cuda.empty_cache()
    mesh_against_cpu(mx, args.seed, "cuda")
    regional_against_cpu(mx, args.seed, "cuda")
    torch.cuda.empty_cache()

    # ---- 5. the paths at full size -----------------------------------------
    kernels = {"ccl_step": ccl_step, "pointer_jump": pointer_jump, "active_cells": active_cells,
               "graph_step": graph_step, "graph_jump": graph_jump, "partition": partition_children_grid_batched}
    launches, refs = main_paths(mx, 720, 1440, args.seed, kernels, "cuda")
    plot_inputs, phase5_digests = refs.pop("plot"), refs.pop("digests")
    partition_batches = refs.pop("partition batches")
    plot_dir = tempfile.mkdtemp(prefix="marex_smoke_plot_")  # config 8's output store, for phase 7
    atexit.register(shutil.rmtree, plot_dir, True)
    launches.update(mesh_and_regional_paths(mx, args.seed, kernels, plot_inputs))
    launches.update(streamed_paths(mx, refs, kernels, plot_inputs, plot_dir))
    del refs
    torch.cuda.empty_cache()
    launches.update(config6_paths(mx, kernels, smi))
    launches[f"config 1 at {LONG_DAYS} days"], long_tr = long_nomerge_path(mx, args.seed, kernels)
    for path, counts in launches.items():
        check_launches(path, counts)
    torch.cuda.empty_cache()

    # ---- 6. the kernels on the paths' own labels -----------------------------
    label_times = partition_labels(partition_batches)
    del partition_batches
    torch.cuda.empty_cache()
    label_times.update(main_path_labels(mx, args.seed))
    torch.cuda.empty_cache()
    mesh_times, mesh_err = mesh_labels(mx, args.seed)
    label_times.update(mesh_times)
    for k, diff in mesh_err.items():
        err[k] = max(err[k], diff)
    torch.cuda.empty_cache()
    for k, diff in long_path_labels(long_tr).items():
        err[k] = max(err[k], diff)
    del long_tr
    torch.cuda.empty_cache()

    # ---- 7. plotX on the paths' outputs ----------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plot_phase(mx, plot_inputs, "cuda", plot_dir)
    del plot_inputs
    peak = torch.cuda.max_memory_allocated()
    print(f"plotX on configs 4, 5 and 8: {time.perf_counter() - t0:.1f} s, bit-identical to the host copies; peak "
          f"{peak} bytes ({peak / 2**30:.2f} GiB) ({smi})")
    if peak > 40e9:
        raise AssertionError(f"phase 7's peak {peak} bytes is over the 40 GB limit")

    # ---- 8. the multi-device layer: a world of one NCCL rank --------------------
    torch.cuda.empty_cache()
    launches.update(mesh_world(args.seed, phase5_digests, smi))

    # ---- 9. the entry module --------------------------------------------------------
    torch.cuda.empty_cache()
    launches.update(entry_phase(mx, args.seed, kernels, smi))

    # each kernel's launches on the path that runs it: the merge path, and for the mesh kernels config 5
    source = {"ccl_step": "min_stencil.cu", "pointer_jump": "min_stencil.cu", "active_cells": "graph_step.cu",
              "graph_step": "graph_step.cu", "graph_jump": "graph_step.cu", "partition": "partition.cu"}
    # the list takes the place of the mask that _unstr_block's step applies to every cell; the partition
    # replaces no Pallas kernel, but the XLA distance transform of partition_nn_grid
    replaces = {"ccl_step": "marex_tpu/ops/pallas_kernels.py:60", "pointer_jump": "marex_tpu/ops/label.py:130",
                "active_cells": "marex_tpu/ops/label.py:307", "graph_step": "marex_tpu/ops/label.py:307",
                "graph_jump": "marex_tpu/ops/label.py:130", "partition": "marex_tpu/ops/partition.py:151"}
    print(json.dumps({"kernels": [
        {
            "name": k,
            "route": "cuda",
            "source": f"marex_tpu_torch/csrc/{source[k]}",
            "replaces": replaces[k],
            "launches": launches["config 5" if k in MESH_KERNELS else "merge path (config 4)"][k],
            "launches_by_path": {path: counts[k] for path, counts in launches.items()},
            "max_abs_err": err[k],
            **label_times[k],
        }
        for k in kernels
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
