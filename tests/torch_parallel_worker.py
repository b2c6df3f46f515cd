"""One rank of a ``torch.distributed`` world on the CPU (``gloo``) that runs
the port's multi-device scenarios, for ``tests/test_torch_parallel*.py``.

    python torch_parallel_worker.py RANK WORLD PORT N_SPACE INPUTS OUTDIR SCENARIO[,SCENARIO...]

The rank joins the world through ``start_distributed_cluster`` (as a user's
script under ``torchrun`` would), builds a (WORLD / N_SPACE, N_SPACE) mesh and
runs each scenario twice on the inputs of ``INPUTS`` (an ``.npz`` the test
made): in one process (``mesh=None``) and on the mesh. It writes
``OUTDIR/<scenario>.<rank>.npz``: every output gathered on this rank
(``mesh/<name>``), the one-process outputs (``single/<name>``) and both runs'
attrs as JSON. It imports only ``marex_tpu_torch`` (no JAX, nothing of
``marex_tpu``), on one torch thread.
"""

from __future__ import annotations

import json
import os
import sys
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRID_KW = dict(quiet=True, device="cpu")
TRACK_MERGE = dict(R_fill=2, T_fill=2, area_filter_quartile=0.5, allow_merging=True, overlap_threshold=0.25)
TRACK_REALMERGE = dict(R_fill=2, T_fill=0, area_filter_quartile=0.0, allow_merging=True, nn_partitioning=True,
                       overlap_threshold=0.3)
TRACK_NOMERGE = dict(R_fill=2, T_fill=0, area_filter_quartile=0.5, allow_merging=False)
TRACK_GAP = dict(R_fill=1, T_fill=4, area_filter_absolute=4, allow_merging=False)
DETECT_GLOBAL = dict(method_anomaly="detrend_harmonic", method_extreme="global_extreme", threshold_percentile=95)
DETECT_HOBDAY = dict(method_anomaly="shifting_baseline", method_extreme="hobday_extreme", window_year_baseline=2,
                     smooth_days_baseline=5, window_days_hobday=11, threshold_percentile=90)
DETECT_MESH = dict(method_anomaly="fixed_baseline", method_extreme="global_extreme", threshold_percentile=92,
                   dimensions={"time": "time", "x": "ncells"}, coordinates={"time": "time", "x": "lon", "y": "lat"})
TRACK_MESH = dict(R_fill=1, T_fill=2, area_filter_absolute=5, allow_merging=True, overlap_threshold=0.5,
                  unstructured_grid=True, dimensions={"x": "ncells"}, coordinates={"x": "lon", "y": "lat"},
                  coordinate_units="degrees")


# ----------------------------------------------------------------------------
# Inputs (numpy only: the test makes them and hands them to both packages)
# ----------------------------------------------------------------------------


def grid_coords(T: int, H: int, W: int, start: str = "2000-01-01", lat=(-40, 40)):
    import pandas as pd

    return {"time": pd.date_range(start, periods=T, freq="D").to_numpy(), "lat": np.linspace(lat[0], lat[1], H),
            "lon": np.linspace(0, 360, W, endpoint=False)}


def blob_sst(T: int = 64, H: int = 16, W: int = 32, seed: int = 0) -> np.ndarray:
    """``tests/test_multidevice_pipeline.py``'s SST: noise and a drifting warm disk."""
    rng = np.random.default_rng(seed)
    sst = 15.0 + 0.5 * rng.standard_normal((T, H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(T // 3, 2 * T // 3):
        cx = (4 + t) % W
        dx = np.minimum(np.abs(xx - cx), W - np.abs(xx - cx))
        sst[t][(yy - H // 2) ** 2 + dx**2 <= 4**2] += 5.0
    return sst


def hobday_sst(T: int = 3 * 365, H: int = 8, W: int = 16, seed: int = 5) -> np.ndarray:
    """Three years of seasonal SST with noise (the shifting + Hobday drive)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    doy = pd.DatetimeIndex(pd.date_range("2000-01-01", periods=T, freq="D")).dayofyear.to_numpy()
    return (15.0 + 2.0 * np.cos(2 * np.pi * (doy[:, None, None] - 30) / 365.25)
            + 0.5 * rng.standard_normal((T, H, W))).astype(np.float32)


def merging_disks(T: int = 24, H: int = 24, W: int = 48) -> np.ndarray:
    """Two disks that close in, merge and part again (real merges)."""
    data = np.zeros((T, H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(T):
        data[t] = ((yy - 12) ** 2 + (xx - 8 - t) ** 2 <= 9) | ((yy - 12) ** 2 + (xx - 40 + t) ** 2 <= 9)
    return data


def gap_disks(T: int = 24, H: int = 16, W: int = 32) -> np.ndarray:
    """Disks with gaps of up to four slices, one of them across each
    boundary between two or four slabs of time (slices 12, 6 and 18)."""
    data = np.zeros((T, H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(T):
        if t not in (5, 6, 11, 12, 13, 18):
            data[t] |= (yy - 8) ** 2 + (xx - 10 - t // 3) ** 2 <= 9
        if t % 5 != 0:
            data[t] |= (yy - 4) ** 2 + (xx - 26) ** 2 <= 4
    return data


def many_parents(T: int = 24, H: int = 24, W: int = 48, t_merge: int = 15) -> np.ndarray:
    """Twelve small disks at slice ``t_merge - 1`` that one large disk covers
    at ``t_merge``: a child of more parents than the march allows (eleven
    after the area filter drops the first object)."""
    data = np.zeros((T, H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W]
    data[t_merge] = (yy - 12) ** 2 + (xx - 24) ** 2 <= 10**2
    for k in range(12):
        ang = 2 * np.pi * k / 12
        data[t_merge - 1] |= (yy - 12 - 8 * np.sin(ang)) ** 2 + (xx - 24 - 8 * np.cos(ang)) ** 2 <= 1
    return data


# ----------------------------------------------------------------------------
# Scenarios (the port's side)
# ----------------------------------------------------------------------------


def _grid_field(marEx, values, name, start="2000-01-01", lat=(-40, 40)):
    T, H, W = values.shape
    return marEx.Field(values, ("time", "lat", "lon"), grid_coords(T, H, W, start, lat), name=name)


def _mask(marEx, H, W, lat=(-40, 40)):
    c = grid_coords(1, H, W, lat=lat)
    return marEx.Field(np.ones((H, W), bool), ("lat", "lon"), {"lat": c["lat"], "lon": c["lon"]}, name="mask")


def _mesh_fields(marEx, inp, prefix):
    sc = {"lat": ("ncells", inp[f"{prefix}_lat"]), "lon": ("ncells", inp[f"{prefix}_lon"])}
    nb = marEx.Field(inp[f"{prefix}_neighbours"], ("nv", "ncells"), name="neighbours")
    ca = marEx.Field(inp[f"{prefix}_areas"], ("ncells",), sc, name="cell_areas")
    return sc, nb, ca


def run_scenario(marEx, name: str, inp, mesh, outdir: str):
    """``{"single": (FieldSet, ...), "mesh": (FieldSet, ...)}`` of one scenario."""
    from marex_tpu_torch.parallel import use_mesh

    out = {}
    for key, m in (("single", None), ("mesh", mesh)):
        if name == "detect_global":
            res = (marEx.preprocess_data(_grid_field(marEx, inp["blob64"], "sst"), mesh=m, **DETECT_GLOBAL, **GRID_KW),)
        elif name in ("detect_hobday", "detect_hobday_w3"):
            kw = dict(window_spatial_hobday=3) if name.endswith("w3") else {}
            da = _grid_field(marEx, inp["hobday"], "sst", lat=(-30, 30))
            res = (marEx.preprocess_data(da, mesh=m, **DETECT_HOBDAY, **kw, **GRID_KW),)
        elif name == "use_mesh":
            with use_mesh(m):
                res = (marEx.preprocess_data(_grid_field(marEx, inp["blob32"], "sst"), **DETECT_GLOBAL, **GRID_KW),)
        elif name == "mesh_true":
            flag = None if m is None else True
            ds = marEx.preprocess_data(_grid_field(marEx, inp["blob32"], "sst"), mesh=flag, **DETECT_GLOBAL, **GRID_KW)
            tr = marEx.tracker(ds["extreme_events"], ds["mask"], mesh=flag, **TRACK_NOMERGE, **GRID_KW)
            res = (ds, tr.run())
        elif name in ("track_merge", "track_realmerge", "track_replicated", "nomerge_gap"):
            src, kw = {"track_merge": ("blob64_events", TRACK_MERGE), "track_realmerge": ("disks", TRACK_REALMERGE),
                       "track_replicated": ("blob63_events", TRACK_NOMERGE),
                       "nomerge_gap": ("gap", TRACK_GAP)}[name]
            ev = _grid_field(marEx, inp[src], "extreme_events", start="2010-01-01")
            tr = marEx.tracker(ev, _mask(marEx, *inp[src].shape[1:]), mesh=m, **kw, **GRID_KW)
            res = tr.run(return_merges=True) if kw["allow_merging"] else (tr.run(),)
        elif name in ("unstructured", "unstructured_split"):
            prefix = "umesh" if name == "unstructured" else "tmesh"
            sc, nb, ca = _mesh_fields(marEx, inp, prefix)
            times = inp[f"{prefix}_time"]
            da = marEx.Field(inp[f"{prefix}_sst"], ("time", "ncells"), {"time": times, **sc}, name="sst")
            ds = marEx.preprocess_data(da, neighbours=nb, cell_areas=ca, mesh=m, **DETECT_MESH, **GRID_KW)
            events = inp[f"{prefix}_events"]
            ev = marEx.Field(events, ("time", "ncells"), {"time": times[: len(events)], **sc}, name="extreme_events")
            mk = marEx.Field(inp[f"{prefix}_mask"], ("ncells",), sc, name="mask")
            tr = marEx.tracker(ev, mk, neighbours=nb, cell_areas=ca, mesh=m, **TRACK_MESH, **GRID_KW)
            res = (ds.drop_vars(["neighbours", "cell_areas"]),) + tr.run(return_merges=True)
        elif name in ("streamed", "streamed_dtensor"):
            res = _streamed(marEx, inp, m, outdir, dtensor=name.endswith("dtensor"))
        else:
            raise ValueError(f"unknown scenario {name}")
        out[key] = res
    return out


#: store writes (``RegionWriter.write`` calls) this rank made, by run
STREAM_WRITES: dict = {}


def _streamed(marEx, inp, mesh, outdir: str, dtensor: bool):
    """``run_streamed`` of the merging disks (in blocks of 5 slices) into a
    store of the run's own: from a lazy store that the first rank writes, or
    (``dtensor``) from memory, on the mesh a DTensor split over time; counts
    this rank's store writes in ``STREAM_WRITES``."""
    import torch.distributed as dist

    from marex_tpu_torch.io import zarr_lite
    from marex_tpu_torch.parallel import shard_put, track_sharding

    data = inp["disks"]
    key = "single" if mesh is None else "mesh"
    name = f"{'streamed_dtensor' if dtensor else 'streamed'}_{key}"
    ev = _grid_field(marEx, data, "extreme_events")
    if dtensor:
        if mesh is not None:
            ev = ev._replace(data=shard_put(data, track_sharding(mesh)))
    else:
        src = os.path.join(outdir, f"{name}_src.zarr")
        if dist.get_rank() == 0:
            zarr_lite.to_zarr(ev, src, chunks={"time": 6})
        dist.barrier()
        ev = zarr_lite.open_zarr(src, lazy=True)["extreme_events"]
    out = os.path.join(outdir, f"{name}.{dist.get_rank()}.zarr" if mesh is None else f"{name}.zarr")
    write = zarr_lite.RegionWriter.write
    STREAM_WRITES[name] = 0

    def counted(self, *args, **kwargs):
        STREAM_WRITES[name] += 1
        return write(self, *args, **kwargs)

    zarr_lite.RegionWriter.write = counted
    try:
        tr = marEx.tracker(ev, _mask(marEx, *data.shape[1:]), mesh=mesh, **TRACK_REALMERGE, **GRID_KW)
        return tr.run_streamed(out, block_T=5, return_merges=True)
    finally:
        zarr_lite.RegionWriter.write = write


def _errors(marEx, mesh, outdir: str):
    """Each error scenario's (class, message) in one process and on the mesh."""
    out = {}
    for name, data, kw in (
        ("no_objects", np.zeros((24, 16, 32), bool), dict(R_fill=1, T_fill=0, area_filter_quartile=0.5)),
        ("too_many_parents", many_parents(), dict(R_fill=0, T_fill=0, area_filter_absolute=1, allow_merging=True,
                                                  overlap_threshold=0.1)),
    ):
        for key, m in (("single", None), ("mesh", mesh)):
            ev = _grid_field(marEx, data, "extreme_events")
            try:
                marEx.tracker(ev, _mask(marEx, *data.shape[1:]), mesh=m, **kw, **GRID_KW).run()
                out[f"{name}/{key}"] = None
            except Exception as e:  # recorded for the test to compare
                out[f"{name}/{key}"] = [type(e).__name__, str(e).splitlines()[0]]
    # met on the first rank alone: the streamed tracker runs there
    data = merging_disks()
    for key, m in (("single", None), ("mesh", mesh)):
        ev = _grid_field(marEx, data, "extreme_events")
        tr = marEx.tracker(ev, _mask(marEx, *data.shape[1:]), mesh=m, **{**TRACK_REALMERGE, "allow_merging": False},
                           **GRID_KW)
        try:
            tr.run_streamed(os.path.join(outdir, f"never_{key}.zarr"))
            out[f"streamed_nomerge/{key}"] = None
        except Exception as e:  # recorded for the test to compare
            out[f"streamed_nomerge/{key}"] = [type(e).__name__, str(e).splitlines()[0]]
    return out


def main(argv):
    rank, world, port, n_space = (int(a) for a in argv[1:5])
    inputs, outdir, scenarios = argv[5], argv[6], argv[7].split(",")
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import marex_tpu_torch as marEx
    from marex_tpu_torch.helper import start_distributed_cluster
    from marex_tpu_torch.parallel import make_mesh

    info = start_distributed_cluster(coordinator_address=f"127.0.0.1:{port}", num_processes=world, process_id=rank,
                                     backend="gloo")
    total = torch.tensor([rank + 1.0])
    dist.all_reduce(total)
    record = {"process_index": info.process_index, "n_processes": info.n_processes, "total": float(total)}
    mesh = make_mesh(n_time=world // n_space, n_space=n_space, device_type="cpu")
    inp = dict(np.load(inputs, allow_pickle=False))
    for name in scenarios:
        if name == "errors":
            record["errors"] = _errors(marEx, mesh, outdir)
            continue
        runs = run_scenario(marEx, name, inp, mesh, outdir)
        arrays, attrs = {}, {}
        for key, res in runs.items():
            if key == "single" and rank != 0:
                continue
            for i, fs in enumerate(res):
                for v in fs.data_vars:
                    arrays[f"{key}/{i}/{v}"] = fs[v].values  # a DTensor is gathered: every rank calls this
                attrs[f"{key}/{i}"] = fs.attrs
            attrs[f"{key}/types"] = [type(fs[v].data).__name__ for fs in res for v in fs.data_vars]
        np.savez(os.path.join(outdir, f"{name}.{rank}.npz"), **arrays)
        with open(os.path.join(outdir, f"{name}.{rank}.json"), "w") as f:
            json.dump(attrs, f, default=str)
    record["stream_writes"] = STREAM_WRITES
    with open(os.path.join(outdir, f"runtime.{rank}.json"), "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
