"""The port's plotX (``marex_tpu_torch.plotX``) held against
``marex_tpu.plotX`` on the CPU, with tolerance 0: the same numpy inputs, made
from a seed, drawn by both packages with the Agg backend. The port's payload
is numpy, a CPU tensor or a lazy zarr array; the reference's is numpy.

Compared: every artist's array and mask, colour limits, norm (the
``BoundaryNorm`` boundaries of ``plot_IDs``), colour table (the seeded-42 ID
colours), the mesh's coordinates or triangles, titles, colourbars and their
``extend``, the animated GIF's frames; and the errors, by class and message.
Grids: global (the seam wrap), renamed dims and coords, and a mesh drawn by
Delaunay, by the kd-tree regrid, from a tgrid store and from a ckdtree store
(both stores written by the port's ``zarr_lite`` and read by each package).
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image, ImageSequence  # noqa: E402
from scipy.spatial import Delaunay  # noqa: E402

import marex_tpu.plotX as ref_px  # noqa: E402
import marex_tpu.plotX.base as ref_base  # noqa: E402
import marex_tpu.plotX.unstructured as ref_unstr  # noqa: E402
import marex_tpu_torch.plotX as port_px  # noqa: E402
import marex_tpu_torch.plotX.base as port_base  # noqa: E402
import marex_tpu_torch.plotX.unstructured as port_unstr  # noqa: E402
from marex_tpu import _dependencies as ref_deps  # noqa: E402
from marex_tpu.core.field import Coord as RCoord, Field as RField  # noqa: E402
from marex_tpu_torch import _dependencies as port_deps  # noqa: E402
from marex_tpu_torch.core.field import Coord as PCoord, Field as PField, FieldSet as PFieldSet  # noqa: E402
from marex_tpu_torch.io import zarr_lite  # noqa: E402

T, H, W = 5, 12, 24
GRID_DIMS = {"time": "time", "y": "lat", "x": "lon"}
RENAMED_DIMS = {"time": "t", "y": "yy", "x": "xx"}
RENAMED_COORDS = {"time": "t", "y": "latitude", "x": "longitude"}
MESH_DIMS = {"time": "time", "x": "ncells"}
KINDS = ["gridded", "renamed", "delaunay", "kdtree", "tgrid", "ckdtree"]
PAYLOADS = ["numpy", "tensor", "lazy"]


def _mesh():
    """A jittered lattice of 225 points over the globe, Delaunay-triangulated:
    (points, triangles, cell-centre lon, cell-centre lat), about 400 cells."""
    rng = np.random.default_rng(11)
    gx, gy = np.meshgrid(np.linspace(0, 355, 15), np.linspace(-70, 70, 15))
    pts = np.column_stack([gx.ravel(), gy.ravel()]) + rng.uniform(-2, 2, (225, 2))
    tri = Delaunay(pts)
    centres = pts[tri.simplices].mean(axis=1)
    return pts, tri.simplices, centres[:, 0], centres[:, 1]


def _values(shape, seed):
    """Anomalies with a NaN block and the ID field drawn from them."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(shape).astype(np.float32)
    ids = np.where(data > 0.6, rng.integers(1, 9, shape), 0).astype(np.int32)
    data.reshape(shape[0], -1)[:, 5:11] = np.nan
    return data, ids


def _spec(kind):
    """(dims, coords, plotX dimensions, plotX coordinates) of a grid kind;
    an aux coordinate is given as (dim, values)."""
    times = pd.date_range("2021-03-01", periods=T, freq="D").to_numpy()
    if kind == "gridded":
        coords = {"time": times, "lat": np.linspace(-60, 60, H), "lon": np.linspace(0, 360, W, endpoint=False)}
        return ("time", "lat", "lon"), coords, GRID_DIMS, GRID_DIMS
    if kind == "renamed":
        coords = {"t": times, "latitude": ("yy", np.linspace(-60, 60, H)),
                  "longitude": ("xx", np.linspace(0, 360, W, endpoint=False))}
        return ("t", "yy", "xx"), coords, RENAMED_DIMS, RENAMED_COORDS
    _, _, lon, lat = _mesh()
    coords = {"time": times, "lat": ("ncells", lat), "lon": ("ncells", lon)}
    return ("time", "ncells"), coords, MESH_DIMS, None


def _fields(kind, payload, tmp_path, ids=False):
    """The same field for both packages: (reference Field, port Field)."""
    dims, coords, _, _ = _spec(kind)
    shape = (T, H, W) if len(dims) == 3 else (T, len(coords["lat"][1]))
    data = _values(shape, seed=KINDS.index(kind))[1 if ids else 0]
    name = "ID_field" if ids else "anoms"
    ref = RField(data.copy(), dims, {k: RCoord(*v) if isinstance(v, tuple) else v for k, v in coords.items()}, name=name)
    port = PField(data.copy(), dims, {k: PCoord(*v) if isinstance(v, tuple) else v for k, v in coords.items()}, name=name)
    if payload == "tensor":
        port = port._replace(data=torch.from_numpy(data.copy()))
    elif payload == "lazy":
        path = str(tmp_path / f"{kind}_{name}.zarr")
        zarr_lite.to_zarr(port, path, chunks={dims[0]: 2})
        lazy = zarr_lite.open_zarr(path, lazy=True)[name]
        assert isinstance(lazy.data, zarr_lite.LazyZarrArray)
        port = PField(lazy.data, lazy.dims, {k: lazy.coords[k] for k in coords}, name=name)
    return ref, port


def _grid_files(kind, tmp_path):
    """The grid a plotter is told of for ``kind``: (fpath_tgrid, fpath_ckdtree)."""
    if kind == "kdtree":
        return None, "unused-key"  # any path that is no directory: the cKDTree regrid
    pts, simplices, lon, _ = _mesh()
    if kind == "tgrid":
        path = tmp_path / "tgrid.zarr"
        if not path.exists():
            zarr_lite.to_zarr(PFieldSet({
                "clon": PField(np.deg2rad(pts[:, 0]), ("vertex",), name="clon"),
                "clat": PField(np.deg2rad(pts[:, 1]), ("vertex",), name="clat"),
                "vertex_of_cell": PField((simplices.T + 1).astype(np.int32), ("nv", "cell"), name="vertex_of_cell"),
            }), str(path))
        return str(path), None
    if kind == "ckdtree":
        root = tmp_path / "ckdtree"
        if not root.exists():
            rng = np.random.default_rng(5)
            zarr_lite.to_zarr(PFieldSet({
                "ickdtree_c": PField(rng.integers(0, len(lon), (9, 18)).astype(np.int64), ("lat", "lon"), name="ickdtree_c"),
                "lon": PField(np.linspace(-180, 180, 18, endpoint=False), ("lon",), name="lon"),
                "lat": PField(np.linspace(-80, 80, 9), ("lat",), name="lat"),
            }), str(root / "res1.00.zarr"))
        return None, str(root)
    return None, None


def _plotters(kind, payload, tmp_path, ids=False):
    """A fresh plotter of each package on the same field: (reference, port)."""
    ref_f, port_f = _fields(kind, payload, tmp_path, ids)
    _, _, dims, coords = _spec(kind)
    tgrid, ckdtree = _grid_files(kind, tmp_path)
    out = []
    for f in (ref_f, port_f):
        p = f.plotX(dimensions=dims, coordinates=coords)
        if tgrid or ckdtree:
            p.specify_grid(fpath_tgrid=tgrid, fpath_ckdtree=ckdtree)
        out.append(p)
    return out


@pytest.fixture(autouse=True)
def _fresh_state():
    ref_px.clear_cache()
    port_px.clear_cache()
    yield
    plt.close("all")
    ref_px.specify_grid()
    port_px.specify_grid()


# ---------------------------------------------------------------------------
# what a figure shows
# ---------------------------------------------------------------------------


def _norm(n):
    if n is None:
        return None
    return (type(n).__name__, n.vmin, n.vmax, getattr(n, "boundaries", None), getattr(n, "Ncmap", None))


def _cmap(cm):
    return (cm.name, cm.N, cm(np.arange(cm.N)))


def _artist(c):
    arr = c.get_array()
    out = {
        "type": type(c).__name__,
        "array": None if arr is None else (np.ma.getdata(arr), np.ma.getmaskarray(arr)),
        "clim": c.get_clim(),
        "norm": _norm(c.norm),
        "cmap": _cmap(c.cmap),
    }
    if hasattr(c, "get_coordinates"):  # QuadMesh
        out["coordinates"] = c.get_coordinates()
    else:  # tripcolor's triangles (masked ones left out)
        out["paths"] = [p.vertices for p in c.get_paths()]
    if c.colorbar is not None:
        out["colorbar"] = c.colorbar.extend
    return out


def _snapshot(fig):
    axes = []
    for ax in fig.axes:
        cb = getattr(ax, "_colorbar", None)
        axes.append({
            "title": ax.get_title(),
            "limits": (ax.get_xlim(), ax.get_ylim()),
            "colorbar": None if cb is None else (cb.extend, _norm(cb.norm), _cmap(cb.cmap), ax.get_ylabel()),
            "artists": [_artist(c) for c in ax.collections],
        })
    return axes


def _same(a, b, where="figure"):
    """Equal to the bit (NaN equal to NaN), dtypes included."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), f"{where}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} != {b!r}"


# ---------------------------------------------------------------------------
# the three ways to draw
# ---------------------------------------------------------------------------

CONFIGS = {
    "robust": dict(title="anomalies", var_units="degC", extend="max"),
    "symmetric": dict(issym=True, cperc=[10, 90]),
    "ids": dict(plot_IDs=True, title="events"),
}


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_single_plot_matches_reference(kind, payload, config, tmp_path):
    ref_p, port_p = _plotters(kind, payload, tmp_path, ids=config == "ids")
    ref_fig, _, ref_im = ref_p.single_plot(ref_px.PlotConfig(**CONFIGS[config]))
    port_fig, _, port_im = port_p.single_plot(port_px.PlotConfig(**CONFIGS[config]))
    _same(_snapshot(ref_fig), _snapshot(port_fig))
    if config == "ids":  # the seeded-42 colours, one a positive ID, and the background masked as drawn
        assert port_im.cmap.N == int(np.nanmax(np.asarray(ref_p.da.values)))
        np.testing.assert_array_equal(port_im.cmap.colors, np.random.default_rng(42).random((port_im.cmap.N, 3)))
        tdim = port_p.dimensions["time"]
        _same(np.asarray(ref_p.da.isel({tdim: 1}).values), port_p.da.isel({tdim: 1}).values)
    else:
        assert port_im.get_clim() == ref_im.get_clim() and port_im.colorbar is not None


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("kind", KINDS)
def test_multi_plot_matches_reference(kind, payload, tmp_path):
    ids = kind in ("gridded", "delaunay")
    cfg = CONFIGS["ids"] if ids else CONFIGS["symmetric"]
    ref_p, port_p = _plotters(kind, payload, tmp_path, ids=ids)
    ref_fig, ref_axes = ref_p.multi_plot(ref_px.PlotConfig(**cfg), col="time", col_wrap=2)
    port_fig, port_axes = port_p.multi_plot(port_px.PlotConfig(**cfg), col="time", col_wrap=2)
    assert len(port_axes) == len(ref_axes) == 6
    snap = _snapshot(port_fig)
    _same(_snapshot(ref_fig), snap)
    assert len([a for a in snap if a["title"]]) == T
    assert (snap[-1]["colorbar"] is None) == ids


def _gif_frames(path):
    with Image.open(path) as img:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(img)]


@pytest.mark.parametrize("kind, payload", [("gridded", p) for p in PAYLOADS] + [("delaunay", "tensor"),
                                                                                ("ckdtree", "lazy")])
def test_animate_matches_reference(kind, payload, tmp_path, monkeypatch):
    for mod in (ref_base, port_base):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)  # the GIF path
        # the pool of forked workers for the gridded tensor payload, frames drawn inline for the others
        monkeypatch.setattr(mod.os, "cpu_count", lambda: 2 if (kind, payload) == ("gridded", "tensor") else 1)
    ids = kind != "ckdtree"
    cfg = dict(CONFIGS["ids"] if ids else CONFIGS["robust"], framerate=5, frame_batch_size=2)
    ref_p, port_p = _plotters(kind, payload, tmp_path, ids=ids)
    centroids = None
    if kind == "gridded":
        cents = np.stack([np.linspace(-20, 20, T), np.linspace(30, 300, T)], 1).astype(np.float32)
        centroids = (RField(cents, ("time", "component"), name="centroid"),
                     PField(torch.from_numpy(cents), ("time", "component"), name="centroid"))
    ref_out = ref_p.animate(ref_px.PlotConfig(**cfg), plot_dir=tmp_path / "ref", file_name="anim",
                            centroids=centroids and centroids[0])
    port_out = port_p.animate(port_px.PlotConfig(**cfg), plot_dir=tmp_path / "port", file_name="anim",
                              centroids=centroids and centroids[1])
    assert port_out.endswith("anim.gif") and ref_out.endswith("anim.gif")
    ref_frames, port_frames = _gif_frames(ref_out), _gif_frames(port_out)
    assert len(port_frames) == len(ref_frames) == T
    for i, (a, b) in enumerate(zip(ref_frames, port_frames)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")


def test_animate_default_name_from_field(tmp_path, monkeypatch):
    monkeypatch.setattr(port_base.shutil, "which", lambda name: None)
    monkeypatch.setattr(port_base.os, "cpu_count", lambda: 1)
    _, port_p = _plotters("gridded", "tensor", tmp_path)
    out = port_p.animate(port_px.PlotConfig(show_colorbar=False), plot_dir=tmp_path)
    assert out == str(tmp_path / "anoms.gif")


# ---------------------------------------------------------------------------
# the plotters' parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("payload", PAYLOADS)
def test_triangulation_and_regrid_match_reference(payload, tmp_path):
    ref_f, port_f = _fields("delaunay", payload, tmp_path)
    lon = np.asarray(ref_f.coords["lon"].values, float)
    lat = np.asarray(ref_f.coords["lat"].values, float)
    ref_p, port_p = ref_px.UnstructuredPlotter(ref_f), port_px.UnstructuredPlotter(port_f)
    # two cells near the pole, either side of the seam: the hull's edge between them spans it
    seam_lon, seam_lat = np.r_[lon, 1.0, 358.0], np.r_[lat, 85.0, 85.0]
    rt, pt = ref_p._triangulation(seam_lon, seam_lat), port_p._triangulation(seam_lon, seam_lat)
    np.testing.assert_array_equal(pt.triangles, rt.triangles)
    np.testing.assert_array_equal(pt.mask, rt.mask)
    assert pt.mask.any()
    vals = np.asarray(port_f.isel(time=2).values, float)
    for got, want in zip(port_unstr.kdtree_regrid(lon, lat, vals, 10.0), ref_p._kdtree_regrid(lon, lat, vals, 10.0)):
        _same(want, got)
    ref_t = ref_unstr._load_triangulation(_grid_files("tgrid", tmp_path)[0])
    port_t = port_unstr._load_triangulation(_grid_files("tgrid", tmp_path)[0])
    for key in ("x", "y", "triangles"):
        _same(getattr(ref_t, key), getattr(port_t, key))


def test_wrap_lon_and_titles_match_reference(tmp_path):
    for kind in ("gridded", "renamed"):
        ref_p, port_p = _plotters(kind, "tensor", tmp_path)
        vals = np.asarray(port_p.da.isel({_spec(kind)[2]["time"]: 0}).values)
        lon = np.linspace(0, 360, W, endpoint=False)
        _same(ref_p.wrap_lon(vals, lon), port_p.wrap_lon(vals, lon))
        tdim = _spec(kind)[2]["time"]
        assert [port_p._get_title(i, tdim) for i in range(T)] == [ref_p._get_title(i, tdim) for i in range(T)]


def test_plot_config_matches_reference():
    for kw in ({}, dict(plot_IDs=True, show_colorbar=True), dict(cperc=[2, 98], clim=(-3.0, 3.0), framerate=24)):
        assert vars(port_px.PlotConfig(**kw)) == vars(ref_px.PlotConfig(**kw))


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("kind", ["gridded", "renamed", "delaunay"])
def test_grid_detection_and_override_match_reference(kind, payload, tmp_path):
    ref_f, port_f = _fields(kind, payload, tmp_path)
    _, _, dims, coords = _spec(kind)
    for d in (None, dims):
        assert port_px._detect_grid_type(port_f, d) == ref_px._detect_grid_type(ref_f, d)
    want = "unstructured" if kind != "delaunay" else "gridded"
    ref_px.specify_grid(grid_type=want)
    port_px.specify_grid(grid_type=want)
    with pytest.warns(UserWarning) as ref_w:
        ref_cls = type(ref_f.plotX(dimensions=dims, coordinates=coords)).__name__
    with pytest.warns(UserWarning) as port_w:
        port_cls = type(port_f.plotX(dimensions=dims, coordinates=coords)).__name__
    assert port_cls == ref_cls
    assert [str(w.message) for w in port_w] == [str(w.message) for w in ref_w]


# ---------------------------------------------------------------------------
# errors: class and message
# ---------------------------------------------------------------------------


def _raised(fn):
    with pytest.raises(Exception) as ei:
        fn()
    e = ei.value
    return type(e).__name__, str(e), getattr(e, "details", None), getattr(e, "suggestions", None), \
        getattr(e, "context", None)


def _both(make):
    """The error each package raises for ``make(package)``: equal by class
    name, message, details, suggestions and context."""
    ref, port = _raised(lambda: make("ref")), _raised(lambda: make("port"))
    assert port == ref
    return port


ERRORS = {
    "missing dims": ("VisualisationError", lambda pkg, f: f.plotX(dimensions={"time": "time", "y": "row", "x": "col"})),
    "missing coords": ("VisualisationError", lambda pkg, f: f.drop_vars("lon").plotX()),
    "no time dim": ("VisualisationError", lambda pkg, f: f.isel(time=0).plotX().animate(
        (ref_px if pkg == "ref" else port_px).PlotConfig())),
}


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("case", ["missing dims", "missing coords", "no time dim"])
def test_visualisation_errors_match_reference(case, payload, tmp_path):
    ref_f, port_f = _fields("gridded", payload, tmp_path)
    cls, make = ERRORS[case]
    assert _both(lambda pkg: make(pkg, ref_f if pkg == "ref" else port_f))[0] == cls


def test_cell_data_error_matches_reference(tmp_path):
    ref_f, port_f = _fields("delaunay", "tensor", tmp_path)

    def make(pkg):
        f, cls, coord = (ref_f, ref_px, RCoord) if pkg == "ref" else (port_f, port_px, PCoord)
        p = f.plotX(dimensions=MESH_DIMS)
        lon, lat = f.coords["lon"].values, f.coords["lat"].values
        p.da = type(f)(np.zeros((T, 7), np.float32), ("time", "ncells"),
                       coords={"lon": coord("cells_orig", lon), "lat": coord("cells_orig", lat)}, name="bad")
        fig, ax = plt.subplots()
        p.plot(ax, "viridis")

    assert _both(make)[0] == "VisualisationError"


@pytest.mark.parametrize("store", ["tgrid without vertex_of_cell", "no ckdtree store"])
def test_store_errors_match_reference(store, tmp_path):
    bad = tmp_path / "bad.zarr"
    zarr_lite.to_zarr(PFieldSet({"clon": PField(np.zeros(4), ("vertex",), name="clon")}), str(bad))

    def make(pkg):
        mod = ref_unstr if pkg == "ref" else port_unstr
        mod.clear_cache()
        if store == "no ckdtree store":
            return mod._load_ckdtree(tmp_path, 1.0)
        return mod._load_triangulation(bad)

    assert _both(make)[0] == "DataValidationError"


def test_configuration_error_matches_reference():
    assert _both(lambda pkg: (ref_px if pkg == "ref" else port_px).specify_grid(grid_type="hexagonal"))[0] == \
        "ConfigurationError"


def test_dependency_error_matches_reference(tmp_path, monkeypatch):
    for deps in (ref_deps, port_deps):
        real = deps.has_dependency
        monkeypatch.setattr(deps, "has_dependency", lambda name, real=real: False if name == "matplotlib" else real(name))
    ref_f, port_f = _fields("gridded", "tensor", tmp_path)
    name, message, *_ = _both(lambda pkg: (ref_f if pkg == "ref" else port_f).plotX())
    assert name == "DependencyError" and "matplotlib" in message


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 7, at a small size on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drawn", [True, False], ids=["matplotlib", "no matplotlib"])
def test_chip_smoke_plot_phase_on_the_cpu(drawn, tmp_path, monkeypatch, capsys):
    """The card's phase 7 (``chip_smoke.plot_phase``) run on CPU tensors: the
    preparation held against the host copies, then the figures drawn both
    ways, or without matplotlib the ``DependencyError``."""
    import os
    import sys

    import marex_tpu_torch as port

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    if not drawn:
        fake = (lambda real: lambda name: False if name == "matplotlib" else real(name))(port_deps.has_dependency)
        monkeypatch.setattr(port_deps, "has_dependency", fake)
        monkeypatch.setattr(port, "has_dependency", fake)
    monkeypatch.setattr(port_base.os, "cpu_count", lambda: 1)
    dims, coords, _, _ = _spec("gridded")
    anom, ids = _values((25, H, W), seed=4)
    coords = dict(coords, time=pd.date_range("2021-03-01", periods=25, freq="D").to_numpy())
    _, _, lon, lat = _mesh()
    store = str(tmp_path / "events.zarr")
    zarr_lite.to_zarr(PField(ids, dims, coords, name="ID_field"), store, chunks={"time": 4})
    inputs = {
        "config 4": dict(ID_field=ids, dat_anomaly=anom, coords=coords),
        "config 5": dict(ID_field=_values((25, len(lon)), seed=5)[1], lon=lon, lat=lat),
        "config 8": store,
    }
    steps = chip_smoke.plot_phase(port, inputs, "cpu", str(tmp_path))
    assert set(steps) == {"config 4 ID_field", "config 4 dat_anomaly", "config 5 ID_field", "config 8 ID_field"}
    for what, by_step in steps.items():
        slice_bytes = (ids if what != "config 5 ID_field" else inputs["config 5"]["ID_field"])[0].nbytes
        if what.startswith("config 8"):
            # chunk bytes read from disk: all 7 chunks of 4 slices for the max, the 3 that hold
            # slices 0, 10 and 20 for the limits, one a frame
            chunk = 4 * slice_bytes
            assert {s: b for s, (_, b) in by_step.items()} == {
                "nanmax": 7 * chunk, "robust limits issym=True": 3 * chunk, "robust limits issym=False": 3 * chunk,
                "frame 0": chunk, "frame 12": chunk, "frame 24": chunk}
            continue
        # scalars for the maxima and the limits, one slice a frame
        assert all(b <= 16 for s, (_, b) in by_step.items() if not s.startswith("frame")), what
        assert all(b == slice_bytes for s, (_, b) in by_step.items() if s.startswith("frame")), what
    out = capsys.readouterr().out
    assert ("from the card's payloads == from the host copies" in out) == drawn
    assert ("raised DependencyError naming matplotlib" in out) != drawn
