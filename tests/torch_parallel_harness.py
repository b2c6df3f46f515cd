"""The test side of the port's multi-device tests: the scenarios' inputs,
worlds of ``gloo`` ranks spawned on ``tests/torch_parallel_worker.py`` (one
process a rank, with a timeout), their outputs, and ``marex_tpu``'s own mesh
runs of the same scenarios with the parity suite's comparisons. Imports JAX
only where the reference runs."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from . import torch_parallel_worker as W

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
WORLD_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_inputs(path: str) -> None:
    """Every scenario's input, made with numpy from seeds (the tracking
    inputs from the port's own one-process detect, so that both packages
    track the same field)."""
    import marex_tpu_torch as port

    from .conftest import make_unstructured_sst
    from .torch_parity import mesh_merge_field, tri_mesh

    def extremes(values, **kw):
        da = port.Field(values, ("time", "lat", "lon"), W.grid_coords(*values.shape), name="sst")
        return port.preprocess_data(da, **W.DETECT_GLOBAL, **W.GRID_KW, **kw)["extreme_events"].values

    inp = {"blob64": W.blob_sst(), "blob32": W.blob_sst(T=32), "hobday": W.hobday_sst(),
           "disks": W.merging_disks(), "gap": W.gap_disks()}
    inp["blob64_events"] = extremes(inp["blob64"])
    inp["blob63_events"] = extremes(W.blob_sst(T=63))
    # the reference test's mesh (269 cells: detect runs replicated, tracking on 730 days splits)
    uda, nb, ca = make_unstructured_sst(n_years=2, n_side=12)
    # a periodic triangle-pair mesh with an even cell count: both stages split
    tnb, tlat, tlon = tri_mesh(512)
    rng = np.random.default_rng(11)
    T = 730
    tsst = (15.0 + 0.8 * rng.standard_normal((T, len(tlat)))).astype(np.float32)
    for name, sst, lat, lon, nbv, area, events in (
        ("umesh", np.asarray(uda.values), np.asarray(uda.coords["lat"].values), np.asarray(uda.coords["lon"].values),
         np.asarray(nb.values), np.asarray(ca.values), None),
        ("tmesh", tsst, tlat, tlon, tnb, np.full(len(tlat), 1e7, np.float32), mesh_merge_field(tlat, tlon, T=30)),
    ):
        sc = {"lat": ("ncells", lat), "lon": ("ncells", lon)}
        times = np.asarray(uda.coords["time"].values)[:T]
        da = port.Field(sst[:T], ("time", "ncells"), {"time": times, **sc}, name="sst")
        ds = port.preprocess_data(da, **W.DETECT_MESH, **W.GRID_KW)
        inp.update({f"{name}_sst": sst[:T], f"{name}_lat": lat, f"{name}_lon": lon, f"{name}_neighbours": nbv,
                    f"{name}_areas": area, f"{name}_time": times, f"{name}_mask": ds["mask"].values,
                    f"{name}_events": ds["extreme_events"].values if events is None else events})
    np.savez(path, **inp)


def start_world(tmp_path, world: int, n_space: int, scenarios):
    """Start a world of ``world`` ranks on the scenarios (inputs made first);
    :func:`finish_world` waits for it."""
    inputs = str(tmp_path / "inputs.npz")
    if not os.path.exists(inputs):
        make_inputs(inputs)
    outdir = tmp_path / f"world{world}"
    outdir.mkdir()
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), str(port), str(n_space), inputs,
                               str(outdir), ",".join(scenarios)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env)
             for r in range(world)]
    return procs, str(outdir), world


def finish_world(started) -> str:
    """Wait for a world (killed, and the test failed, past
    ``WORLD_TIMEOUT_S``); every rank must end with 0. Returns its output dir."""
    procs, outdir, world = started
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORLD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a world of {world} ranks hung (no end within {WORLD_TIMEOUT_S} s)")
        outs.append(out.decode(errors="replace"))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{out[-4000:]}"
    return outdir


def spawn_world(tmp_path, world: int, n_space: int, scenarios) -> str:
    """Run the scenarios on a world of ``world`` ranks; returns the output dir."""
    return finish_world(start_world(tmp_path, world, n_space, scenarios))


class World:
    """A world started in the background; ``outdir`` waits for it."""

    def __init__(self, tmp_path, world: int, n_space: int, scenarios):
        self._started = start_world(tmp_path, world, n_space, scenarios)
        self._outdir = None
        self.inputs = dict(np.load(tmp_path / "inputs.npz"))

    @property
    def outdir(self) -> str:
        if self._outdir is None:
            self._outdir = finish_world(self._started)
        return self._outdir


def load_run(outdir: str, name: str, rank: int):
    with open(os.path.join(outdir, f"{name}.{rank}.json")) as f:
        attrs = json.load(f)
    return dict(np.load(os.path.join(outdir, f"{name}.{rank}.npz"))), attrs


def assert_mesh_equals_single(outdir: str, name: str, world: int) -> None:
    single, s_attrs = load_run(outdir, name, 0)
    single = {k[len("single/"):]: v for k, v in single.items() if k.startswith("single/")}
    assert single
    for rank in range(world):
        arrays, attrs = load_run(outdir, name, rank)
        mesh = {k[len("mesh/"):]: v for k, v in arrays.items() if k.startswith("mesh/")}
        assert set(mesh) == set(single), (rank, sorted(set(mesh) ^ set(single)))
        for k, v in single.items():
            assert mesh[k].dtype == v.dtype, (rank, k)
            assert np.array_equal(mesh[k], v, equal_nan=v.dtype.kind in "fc"), f"{name} rank {rank}: {k} differs"
        for i in range(len({k.split("/")[0] for k in single})):
            assert attrs[f"mesh/{i}"] == s_attrs[f"single/{i}"], (rank, i)




# ----------------------------------------------------------------------------
# marex_tpu's mesh runs of the same scenarios (JAX, the 8 virtual CPU devices)
# ----------------------------------------------------------------------------

# each detect scenario's method: the parity suite's anomaly tolerance against marex_tpu
ANOMALY_ATOL = {"detrend_harmonic": 1e-4, "shifting_baseline": 5e-4, "fixed_baseline": 1e-5}


def reference_runs(name: str, inp, port_arrays):
    """``marex_tpu``'s run of a scenario under ``parallel.make_mesh()``: the
    FieldSets in the order the worker saves the port's. Tracking takes the
    port's input field (the one the worker tracked; ``port_arrays()`` gives
    the port's outputs where that is one of them)."""
    import marex_tpu as ref
    from marex_tpu.parallel import make_mesh, use_mesh

    mesh = make_mesh()
    q = dict(quiet=True)

    def grid(values, name_, start="2000-01-01", lat=(-40, 40)):
        return ref.Field(values, ("time", "lat", "lon"), W.grid_coords(*values.shape, start, lat), name=name_)

    def mask(H, W_):
        c = W.grid_coords(1, H, W_)
        return ref.Field(np.ones((H, W_), bool), ("lat", "lon"), {"lat": c["lat"], "lon": c["lon"]}, name="mask")

    def track(ev, mk, mesh_arg, merges, **kw):
        tr = ref.tracker(ev, mk, mesh=mesh_arg, **kw, **q)
        tr.use_scan_march = False  # the per-step march, which the port follows
        return tr.run(return_merges=True) if merges else (tr.run(),)

    if name == "detect_global":
        return (ref.preprocess_data(grid(inp["blob64"], "sst"), mesh=mesh, **W.DETECT_GLOBAL, **q),)
    if name in ("detect_hobday", "detect_hobday_w3"):
        kw = dict(window_spatial_hobday=3) if name.endswith("w3") else {}
        return (ref.preprocess_data(grid(inp["hobday"], "sst", lat=(-30, 30)), mesh=mesh, **W.DETECT_HOBDAY, **kw,
                                    **q),)
    if name == "use_mesh":
        with use_mesh(mesh):
            return (ref.preprocess_data(grid(inp["blob32"], "sst"), **W.DETECT_GLOBAL, **q),)
    if name == "mesh_true":
        ds = ref.preprocess_data(grid(inp["blob32"], "sst"), mesh=True, **W.DETECT_GLOBAL, **q)
        ev = grid(port_arrays()["mesh/0/extreme_events"], "extreme_events")
        return (ds,) + track(ev, ds["mask"], True, False, **W.TRACK_NOMERGE)
    if name in ("track_merge", "track_realmerge", "track_replicated", "nomerge_gap"):
        src, kw = {"track_merge": ("blob64_events", W.TRACK_MERGE), "track_realmerge": ("disks", W.TRACK_REALMERGE),
                   "track_replicated": ("blob63_events", W.TRACK_NOMERGE), "nomerge_gap": ("gap", W.TRACK_GAP)}[name]
        ev = grid(inp[src], "extreme_events", start="2010-01-01")
        return track(ev, mask(*inp[src].shape[1:]), mesh, kw["allow_merging"], **kw)
    if name in ("unstructured", "unstructured_split"):
        p = "umesh" if name == "unstructured" else "tmesh"
        sc = {"lat": ("ncells", inp[f"{p}_lat"]), "lon": ("ncells", inp[f"{p}_lon"])}
        nb = ref.Field(inp[f"{p}_neighbours"], ("nv", "ncells"), name="neighbours")
        ca = ref.Field(inp[f"{p}_areas"], ("ncells",), sc, name="cell_areas")
        times, events = inp[f"{p}_time"], inp[f"{p}_events"]
        da = ref.Field(inp[f"{p}_sst"], ("time", "ncells"), {"time": times, **sc}, name="sst")
        ds = ref.preprocess_data(da, neighbours=nb, cell_areas=ca, mesh=mesh, **W.DETECT_MESH, **q)
        ev = ref.Field(events, ("time", "ncells"), {"time": times[: len(events)], **sc}, name="extreme_events")
        mk = ref.Field(inp[f"{p}_mask"], ("ncells",), sc, name="mask")
        return (ds,) + track(ev, mk, mesh, True, neighbours=nb, cell_areas=ca, **W.TRACK_MESH)
    raise ValueError(f"unknown scenario {name}")


def _method(name: str) -> str:
    return {"detect_hobday": "shifting_baseline", "detect_hobday_w3": "shifting_baseline",
            "unstructured": "fixed_baseline", "unstructured_split": "fixed_baseline"}.get(name, "detrend_harmonic")


def assert_detect_near(r_ds, port: dict, prefix: str, method: str) -> None:
    """The parity suite's detect rules: the mask bit for bit, anomalies within
    the method's tolerance, thresholds at most one bin apart in at most 2 %
    of cells, extremes differing only next to a threshold (the detrended
    method of the short drives: see below)."""
    from .torch_parity import assert_close, assert_extremes_near, assert_same

    atol = ANOMALY_ATOL[method]
    r_anom, p_anom = np.asarray(r_ds["dat_anomaly"].values), port[prefix + "dat_anomaly"]
    assert_same(np.asarray(r_ds["mask"].values), port[prefix + "mask"], "mask")
    r_thr, p_thr = np.asarray(r_ds["thresholds"].values), port[prefix + "thresholds"]
    if method == "detrend_harmonic":
        # on a series of 32 or 64 days the reference's float32 fit strays from
        # the float64 one by up to 1e-2: the port's anomalies are held to
        # float64, and its extremes and thresholds to the reference's fed the
        # port's anomalies, on the reference's mesh, bit for bit
        assert_close(_oracle_detrended(p_anom.shape, r_ds), p_anom, atol=5e-5, what="dat_anomaly vs float64")
        import marex_tpu as ref
        from marex_tpu.parallel import make_mesh, use_mesh

        da = ref.Field(p_anom, r_ds["dat_anomaly"].dims, r_ds["dat_anomaly"].coords, name="dat_anomaly")
        with use_mesh(make_mesh()):
            r_ext, r_thr = ref.identify_extremes(da, "global_extreme", 95, quiet=True)
        assert_same(np.asarray(r_ext.values), port[prefix + "extreme_events"], "extreme_events")
        assert_close(np.asarray(r_thr.values), p_thr, atol=0, what="thresholds")
        return
    assert_close(r_anom, p_anom, atol=atol, what="dat_anomaly")
    np.testing.assert_array_equal(np.isnan(r_thr), np.isnan(p_thr))
    d = np.abs(np.nan_to_num(r_thr) - np.nan_to_num(p_thr))
    assert d.max() <= 0.01 * (1 + 1e-4) and (d > 1e-6).mean() <= 0.02, d.max()
    doy = None
    if r_thr.shape[0] == 366:
        import pandas as pd

        doy = pd.DatetimeIndex(np.asarray(r_ds["dat_anomaly"].coords["time"].values)).dayofyear.to_numpy() - 1
    assert_extremes_near(r_anom, r_thr, p_thr, np.asarray(r_ds["extreme_events"].values),
                         port[prefix + "extreme_events"], doy, near=atol)


def _oracle_detrended(shape, r_ds) -> np.ndarray:
    """The float64 detrended anomaly (linear trend and harmonics, zero mean)
    of the scenario's input."""
    from marex_tpu_torch.core.timeaxis import decompose_time
    from marex_tpu_torch.ops.detrend import build_design_matrix

    times = np.asarray(r_ds["dat_anomaly"].coords["time"].values)
    sst = W.blob_sst(T=shape[0], H=shape[1], W=shape[2])
    model, pmodel = build_design_matrix(decompose_time(times), [1], True)
    x = sst.reshape(shape[0], -1).astype(np.float64)
    anom = x - model.T @ (pmodel.T @ x)
    return (anom - anom.mean(axis=0)).reshape(shape)


def assert_track_same(r_ev, r_mg, port: dict, p_attrs: dict, prefix: str, mg_prefix: str, on_mesh: bool) -> None:
    """The parity suite's tracking rules: integers, booleans, times and merge
    records bit for bit; areas and centroids within 1e-5 (2e-4 degrees on a
    mesh); attrs equal (the two area fractions within 1e-5 on a mesh)."""
    from .torch_parity import assert_same

    for name in ("ID_field", "global_ID", "presence", "merge_ledger", "time_start", "time_end"):
        if prefix + name in port:
            assert_same(np.asarray(r_ev[name].values), port[prefix + name], name)
    for name in ("area", "centroid"):
        if prefix + name in port:
            a, b = np.asarray(r_ev[name].values, np.float64), np.asarray(port[prefix + name], np.float64)
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
            atol = 2e-4 if on_mesh and name == "centroid" else 1e-5
            np.testing.assert_allclose(np.nan_to_num(b, nan=-999.0), np.nan_to_num(a, nan=-999.0), rtol=1e-5,
                                       atol=atol, err_msg=name)
    if r_mg is not None:
        for name in ("parent_IDs", "child_IDs", "merge_time", "n_parents", "n_children"):
            assert_same(np.asarray(r_mg[name].values), port[mg_prefix + name], name)
        np.testing.assert_allclose(port[mg_prefix + "overlap_areas"], np.asarray(r_mg["overlap_areas"].values),
                                   rtol=1e-5 if on_mesh else 0, atol=1 if on_mesh else 0)
    r_attrs = json.loads(json.dumps(dict(r_ev.attrs), default=str))
    fractions = ("accepted_area_fraction", "preprocessed_area_fraction") if on_mesh else ()
    assert {k: v for k, v in p_attrs.items() if k not in fractions} == \
        {k: v for k, v in r_attrs.items() if k not in fractions}
    for k in fractions:
        assert p_attrs[k] == pytest.approx(r_attrs[k], rel=1e-5)


def assert_near_reference(name: str, world: World) -> None:
    """A scenario's mesh outputs (rank 0's, which every rank's equal) against
    ``marex_tpu``'s mesh run, made while the world runs."""
    runs = reference_runs(name, world.inputs, lambda: load_run(world.outdir, name, 0)[0])
    arrays, attrs = load_run(world.outdir, name, 0)
    i = 0
    if name.startswith("detect") or name in ("use_mesh", "mesh_true", "unstructured", "unstructured_split"):
        assert_detect_near(runs[0], arrays, "mesh/0/", _method(name))
        i = 1
    if i < len(runs):
        r_mg = runs[i + 1] if i + 1 < len(runs) else None
        assert_track_same(runs[i], r_mg, arrays, attrs[f"mesh/{i}"], f"mesh/{i}/", f"mesh/{i + 1}/",
                          name.startswith("unstructured"))
