"""
Entry points of the port: a one-step program and a multi-device dry
run, the counterparts of the repository's ``__graft_entry__.py``.

``entry(device=None)`` -> ``(fn, args)``: the fused one-step detect+track
    program :func:`_detect_track_step` and its example inputs, (32, 16, 32)
    from seed 0, on the card (``device="cpu"`` for the CPU).
``dryrun_multichip(n_devices, device=None)``: the public pipeline
    (``preprocess_data`` -> ``tracker``) on an ``n_devices``-rank ("time",
    "space") mesh through four drives: a grid run with real merges, the
    shifting baseline with Hobday thresholds, an unstructured mesh, and the
    streamed tracker. On the card it joins the ``torch.distributed`` world
    that is up (``torchrun``, NCCL), or starts a world of this process alone
    for one device; with ``device="cpu"`` and no world it spawns
    ``n_devices`` ``gloo`` ranks itself. The first rank prints one
    ``dryrun_multichip OK: ...`` line with the drives' counts.

    python -m marex_tpu_torch.entry                           # entry() on one card
    torchrun --nproc_per_node=N -m marex_tpu_torch.entry      # also dryrun_multichip(N)
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import time
from collections import OrderedDict
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .exceptions import DeviceError
from .ops import climatology as _clim
from .ops import label as _label
from .ops import morphology as _morph
from .ops import quantile as _quant

# the dry run's year axis: Y is fixed for the example shapes, as in the reference
_N_YEARS = 4


def _detect_track_step(
    data: torch.Tensor, year_idx: torch.Tensor, doy_idx: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """
    One fused detect+track step on a (T, H, W) block: fixed-baseline
    anomaly -> global approximate 95th-percentile thresholds -> extreme mask
    -> disk closing and opening (R=2, periodic in x) -> time closing
    (T_fill=2) -> spatio-temporal labelling (3x3x3, periodic in x).

    data : (T, H, W) float32; year_idx, doy_idx : (T,) int, the year (below
    4) and 0-based day of year of each slice, no pair twice; mask : (H, W)
    bool.

    Returns ``(anomalies (T, H, W) float32, labels (T, H, W) int32, n)``:
    the labels dense 1..n in the order of each event's smallest flat index
    (0 = background). The labelling runs to its fixpoint (the reference caps
    it at 64 iterations).
    """
    T, H, W = data.shape
    S = H * W
    flat = data.reshape(T, S)
    years, days = year_idx.long(), doy_idx.long()

    ymd = torch.full((_N_YEARS, 366, S), float("nan"), dtype=flat.dtype, device=flat.device)
    ymd.index_put_((years, days), flat)
    climatology = _clim.nanmean_over_years(ymd)  # (366, S)
    del ymd
    anomalies = flat - climatology[days]

    bin_edges = _quant.make_bin_edges(0.01, 5.0)
    nbins = len(bin_edges) - 1
    centers = torch.from_numpy(_quant.make_bin_centers(bin_edges)).to(flat.device)
    bins = _quant.digitize_anomalies(anomalies, 0.01, nbins)
    thresholds = _quant.global_thresholds_approx(bins, 0.95, nbins, centers)
    del bins
    extremes = (anomalies >= thresholds[None, :]).reshape(T, H, W)

    filled = _morph.binary_close_open_grid(extremes, 2, mask, mode="wrap")
    closed = _morph.binary_close_time(filled, 2)
    del extremes, filled
    roots, _ = _label.label_spacetime_roots(closed, wrap_x=True)
    labels, n_events = _label.densify_spacetime_roots(roots)
    return anomalies.reshape(T, H, W), labels.view(T, H, W), n_events


def _device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``device`` (the card by default); the card must be there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(
            "The entry runs on a CUDA device by default, and there is none",
            details="torch.cuda.is_available() is False",
            suggestions=["Run on a machine with a GPU", "Pass device='cpu' to run on the CPU"],
        )
    return dev


def entry(device: Optional[Union[str, torch.device]] = None):
    """Return ``(fn, args)``: :func:`_detect_track_step` and its example
    inputs (seed 0, (32, 16, 32), two years of 16 days, a mask of ones) on
    ``device`` (the card by default)."""
    dev = _device(device)
    T, H, W = 32, 16, 32
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((T, H, W)).astype(np.float32)).to(dev)
    year_idx = torch.from_numpy((np.arange(T) // 16).astype(np.int32)).to(dev)
    doy_idx = torch.from_numpy((np.arange(T) % 16).astype(np.int32)).to(dev)
    mask = torch.ones((H, W), dtype=torch.bool, device=dev)
    return _detect_track_step, (data, year_idx, doy_idx, mask)


# ----------------------------------------------------------------------------
# dryrun_multichip
# ----------------------------------------------------------------------------


def dryrun_multichip(n_devices: int, device: Optional[Union[str, torch.device]] = None) -> None:
    """
    Run the full public pipeline on an ``n_devices``-rank ("time", "space")
    mesh: detect split over space and tracking over time, on synthetic
    fields with coherent warm blobs so that every drive labels real events
    (asserted): a grid run with real merges, the shifting baseline with
    Hobday thresholds, an unstructured mesh and the streamed tracker (which
    runs on the mesh's first rank, ``tracker.run_streamed``).

    On the card (the default) every rank of the ``torch.distributed`` world
    calls this; a world of fewer ranks than ``n_devices`` raises. With one
    device and no world, a world of this process alone is started. With
    ``device="cpu"`` and no world, ``n_devices`` ``gloo`` ranks are spawned
    here. Nothing falls back from the card to the CPU.
    """
    dev = _device(device)
    env_world = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if dev.type == "cpu" and not dist.is_initialized() and not env_world:
        _spawn_cpu_world(n_devices)
        return
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))
    if world < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} devices but the torch.distributed world exposes "
            f"{world}; launch with torchrun --nproc_per_node={n_devices}, or pass device='cpu' for "
            f"{n_devices} gloo ranks."
        )
    from .parallel import make_mesh

    _dryrun(make_mesh(n_time=n_devices, n_space=1, device_type=dev.type), dev.type)


def _spawn_cpu_world(n: int) -> None:
    """``dryrun_multichip(n, device="cpu")`` on ``n`` spawned ``gloo`` ranks;
    raises when one fails (the others are stopped then)."""
    from .parallel.mesh import _free_port

    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_cpu_rank, args=(r, n, port), name=f"dryrun-rank{r}") for r in range(n)]
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            # a rank that failed leaves the others waiting in a collective
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n}, device='cpu'): ranks failed (rank, exit code): {failed}")


def _cpu_rank(rank: int, n: int, port: int) -> None:
    """One spawned ``gloo`` rank of :func:`_spawn_cpu_world` (its CPU share
    of threads)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n, rank=rank)
    try:
        dryrun_multichip(n, device="cpu")
    finally:
        dist.destroy_process_group()


def _dryrun(mesh, device_type: str) -> None:
    """The four drives of ``__graft_entry__.dryrun_multichip`` on ``mesh``,
    from the same seeded numpy inputs and with the same arguments."""
    import pandas as pd

    import marex_tpu_torch as marEx
    from marex_tpu_torch import Field
    from marex_tpu_torch.io import zarr_lite
    from marex_tpu_torch.parallel.comm import ShardComm

    comm = ShardComm(mesh)
    n_devices = comm.size
    q = dict(quiet=True, mesh=mesh, device=device_type)

    # time divides the mesh for tracking and H*W for detect
    T, H, W = max(8 * n_devices, 64), 16, 32
    rng = np.random.default_rng(0)
    sst = 15.0 + 0.5 * rng.standard_normal((T, H, W)).astype(np.float32)
    # two warm blobs converging over 16 steps: real merges
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(T // 3, T // 3 + 16):
        k = t - T // 3
        for cx0, sgn in ((6, +1), (26, -1)):
            cx = (cx0 + sgn * k) % W
            dx = np.minimum(np.abs(xx - cx), W - np.abs(xx - cx))
            blob = (yy - H // 2) ** 2 + dx**2 <= 4**2
            sst[t][blob] += 8.0

    coords = {
        "time": pd.date_range("2000-01-01", periods=T, freq="D").to_numpy(),
        "lat": np.linspace(-40, 40, H),
        "lon": np.linspace(0, 360, W, endpoint=False),
    }
    da = Field(sst, ("time", "lat", "lon"), coords, name="sst")
    ds = marEx.preprocess_data(
        da, method_anomaly="detrend_harmonic", method_extreme="global_extreme", threshold_percentile=90, **q
    )
    tr = marEx.tracker(
        ds["extreme_events"], ds["mask"], R_fill=2, T_fill=2, area_filter_quartile=0.25, allow_merging=True,
        nn_partitioning=True, overlap_threshold=0.25, **q,
    )
    events = tr.run()
    n_events = int(events.attrs["N_events_final"])
    n_merges = int(events.attrs["total_merges"])
    assert n_events > 0, "sharded pipeline labeled no events (seeded blob lost)"
    assert n_merges > 0, "sharded split/merge march recorded no merges (converging blobs lost)"
    ids = np.asarray(events["ID_field"].values)  # a DTensor: every rank gathers
    assert ids.shape == (T, H, W)
    assert ids.max() == n_events

    # the reference's default detect methods under the same mesh, on a 3-year daily block
    Ty = 3 * 365
    doy = pd.DatetimeIndex(pd.date_range("2000-01-01", periods=Ty, freq="D")).dayofyear.to_numpy()
    sst2 = (
        15.0
        + 2.0 * np.cos(2 * np.pi * (doy[:, None, None] - 30) / 365.25)
        + 0.5 * rng.standard_normal((Ty, 8, 16))
    ).astype(np.float32)
    da2 = Field(
        sst2,
        ("time", "lat", "lon"),
        {
            "time": pd.date_range("2000-01-01", periods=Ty, freq="D").to_numpy(),
            "lat": np.linspace(-30, 30, 8),
            "lon": np.linspace(0, 360, 16, endpoint=False),
        },
        name="sst",
    )
    ds2 = marEx.preprocess_data(
        da2, method_anomaly="shifting_baseline", method_extreme="hobday_extreme", window_year_baseline=2,
        smooth_days_baseline=5, window_days_hobday=11, threshold_percentile=90, **q,
    )
    n_ex = int(np.asarray(ds2["extreme_events"].values).sum())
    assert n_ex > 0, "sharded shifting_baseline+hobday detect flagged no extremes"
    assert ds2["thresholds"].shape[0] == 366

    # the stores of the last two drives, in one directory of the first rank's
    tmp = comm.broadcast(tempfile.mkdtemp(prefix="marex_dryrun_stream_") if comm.index == 0 else None, 0)
    try:
        # an unstructured triangle-pair mesh (1-based (3, C) neighbour table)
        # with a warm patch drifting in longitude, sized so that the patch
        # keeps more than 50 cells a slice (the mesh filter's pre-drop)
        gy, gx = 16, 32
        C = 2 * gy * gx
        jj, ii = np.mgrid[0:gy, 0:gx]
        lo, up = 2 * (jj * gx + ii), 2 * (jj * gx + ii) + 1

        def _tid(j, i, upper):
            return (2 * ((j % gy) * gx + (i % gx)) + upper).astype(np.int32)

        nb = np.empty((3, C), np.int32)
        nb[0].reshape(-1)[lo.ravel()] = up.ravel()
        nb[1].reshape(-1)[lo.ravel()] = _tid(jj, ii - 1, 1).ravel()
        nb[2].reshape(-1)[lo.ravel()] = _tid(jj - 1, ii, 1).ravel()
        nb[0].reshape(-1)[up.ravel()] = lo.ravel()
        nb[1].reshape(-1)[up.ravel()] = _tid(jj, ii + 1, 0).ravel()
        nb[2].reshape(-1)[up.ravel()] = _tid(jj + 1, ii, 0).ravel()
        lat_c = np.repeat(np.linspace(-50, 50, gy), 2 * gx)
        lon_c = np.tile(np.repeat(np.linspace(0, 360, gx, endpoint=False), 2), gy)
        Tu = max(4 * n_devices, 32)
        sstu = 15.0 + 0.5 * rng.standard_normal((Tu, C)).astype(np.float32)
        for t in range(Tu // 4, Tu // 4 + 12):
            k = t - Tu // 4
            clon = (30.0 + 10.0 * k) % 360.0
            dlon = np.minimum(np.abs(lon_c - clon), 360.0 - np.abs(lon_c - clon))
            sstu[t][(np.abs(lat_c) < 30.0) & (dlon < 40.0)] += 8.0
        coords_u = {
            "time": pd.date_range("2000-01-01", periods=Tu, freq="D").to_numpy(),
            "lat": ("ncells", lat_c),
            "lon": ("ncells", lon_c),
        }
        dau = Field(sstu, ("time", "ncells"), coords_u, name="sst")
        nbf = Field(nb + 1, ("nv", "ncells"), {"lat": ("ncells", lat_c), "lon": ("ncells", lon_c)},
                    name="neighbours")
        areas = Field(np.full(C, 1.0e7, np.float32), ("ncells",), name="cell_areas")
        dsu = marEx.preprocess_data(
            dau, dimensions={"time": "time", "x": "ncells"}, coordinates={"time": "time", "x": "lon", "y": "lat"},
            neighbours=nbf, cell_areas=areas, method_anomaly="detrend_harmonic", method_extreme="global_extreme",
            threshold_percentile=90, **q,
        )
        tru = marEx.tracker(
            dsu["extreme_events"], dsu["mask"], R_fill=1, T_fill=2, area_filter_quartile=0.25, allow_merging=True,
            nn_partitioning=True, overlap_threshold=0.25, unstructured_grid=True, dimensions={"x": "ncells"},
            coordinates={"x": "lon", "y": "lat"}, coordinate_units="degrees", temp_dir=tmp,
            neighbours=dsu["neighbours"], cell_areas=dsu["cell_areas"], **q,
        )
        events_u = tru.run()
        n_events_u = int(events_u.attrs["N_events_final"])
        assert n_events_u > 0, "sharded unstructured pipeline labeled no events"
        assert np.asarray(events_u["ID_field"].values).shape == (Tu, C)

        # the streamed tracker under the same mesh: extremes -> chunked zarr
        # store -> lazy reads -> blockwise march -> region-written ID_field
        ev = ds["extreme_events"]
        ev_host = Field(np.asarray(ev.values), ev.dims, dict(ev.coords), name="extreme_events")
        src, outp = f"{tmp}/src.zarr", f"{tmp}/out.zarr"
        if comm.index == 0:
            zarr_lite.to_zarr(ev_host, src, chunks={"time": max(T // 4, 8)})
        comm.agree()
        lazy = zarr_lite.open_zarr(src, lazy=True)
        trs = marEx.tracker(
            lazy["extreme_events"], ds["mask"], R_fill=2, T_fill=2, area_filter_quartile=0.25, allow_merging=True,
            nn_partitioning=True, overlap_threshold=0.25, **q,
        )
        events_s = trs.run_streamed(outp, memory_budget_mb=256)
        n_events_s = int(events_s.attrs["N_events_final"])
        assert n_events_s > 0, "sharded streamed tracker labeled no events"
        ids_s = np.asarray(zarr_lite.open_zarr(outp)["ID_field"].values)
        assert ids_s.shape == (T, H, W)
        comm.agree()  # every rank has read the stores
    finally:
        if comm.index == 0:
            shutil.rmtree(tmp, ignore_errors=True)

    if comm.index == 0:
        shape = OrderedDict(zip(mesh.mesh_dim_names, mesh.shape))
        print(
            f"dryrun_multichip OK: mesh={shape}, preprocess_data+tracker.run "
            f"on {sst.shape}, n_events={n_events}, total_merges={n_merges}, "
            f"shifting+hobday extremes={n_ex}, unstructured n_events={n_events_u}, "
            f"streamed n_events={n_events_s}",
            flush=True,
        )


def main() -> int:
    """``entry()`` on the card, then, under ``torchrun`` with more than one
    rank, ``dryrun_multichip(world size)``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    if int(os.environ.get("RANK", "0")) == 0:
        print("entry OK:", [tuple(o.shape) if isinstance(o, torch.Tensor) else o for o in out], flush=True)
    if world > 1:
        dryrun_multichip(world)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
