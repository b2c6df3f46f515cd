"""The tracker's mid-level API of the PyTorch port against ``marex_tpu`` on
the CPU: ``mask_values``, ``identify_objects`` (per slice, and with time
connectivity), ``calculate_object_properties``, ``check_overlap_slice`` and
``find_overlapping_objects``, on the verify drive's extremes (3 yr x 24 x 48),
the merge blob recipe and a regional field; on a mesh,
``identify_objects``, ``check_overlap_slice`` and
``calculate_object_properties``.

Tolerances: ids and pairs bit-identical; areas within 1e-5 relative;
centroids within 1e-4 pixels on a grid and 2e-4 degrees on a mesh (longitudes
on the circle), the tolerances of the repo's other parity tests."""

import numpy as np
import pandas as pd
import pytest

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu.core.field import Field as RefField
from marex_tpu_torch.core.field import from_reference

from .torch_parity import (
    DETECT_FIXED,
    MESH_KW,
    blob_field,
    bool_fields,
    drive_sst,
    merge_dense_field,
    mesh_fields,
    mesh_merge_field,
    one_torch_thread,  # noqa: F401 (fixture)
    to_np,
    tri_mesh,
)

GRID_CENTROID_ATOL = 1e-4  # pixels
MESH_CENTROID_ATOL = 2e-4  # degrees
AREA_RTOL = 1e-5


def _regional_inputs():
    data = blob_field(6, 40, 24, 36, 50, 4)
    T, ny, nx = data.shape
    coords = {
        "time": pd.date_range("2000-01-01", periods=T, freq="D").to_numpy(),
        "lat": np.linspace(30.0, 70.0, ny),
        "lon": np.linspace(-30.0, 40.0, nx),
    }
    mask = np.ones((ny, nx), bool)
    mask[2:5, 3:9] = False
    ev = RefField(data, ("time", "lat", "lon"), coords, name="extreme_events")
    return ev, RefField(mask, ("lat", "lon"), {"lat": coords["lat"], "lon": coords["lon"]}, name="mask")


def _inputs(name):
    """(reference tracker, port tracker, extremes Field) of one input."""
    if name == "drive":
        ds = ref.preprocess_data(drive_sst(), quiet=True, **DETECT_FIXED)
        ev, mask = ds.extreme_events, ds.mask
        kw = dict(R_fill=2, T_fill=2, area_filter_quartile=0.5, allow_merging=True, overlap_threshold=0.25)
    elif name == "merge_blobs":
        data = merge_dense_field(T=40)
        ev, mask = bool_fields(data, np.ones(data.shape[1:], bool))
        kw = dict(R_fill=2, T_fill=0, area_filter_quartile=0.0, allow_merging=True, overlap_threshold=0.3)
    else:
        ev, mask = _regional_inputs()
        kw = dict(R_fill=2, T_fill=2, area_filter_absolute=8, allow_merging=False, coordinate_units="degrees",
                  regional_mode=True)
    r_tr = ref.tracker(ev, mask, quiet=True, **kw)
    p_tr = port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), device="cpu", quiet=True, **kw)
    return r_tr, p_tr, ev


def _api_outputs(tr, ev, t):
    """Every mid-level output of one tracker on ``ev`` (slice pair t, t+1)."""
    lab, none, n = tr.identify_objects(ev)
    lab3, _, n3 = tr.identify_objects(ev, time_connectivity=True)
    ids = to_np(lab.data)
    return {
        "mask_values": tr.mask_values,
        "identify_objects": (lab, none, n),
        "identify_objects_time": (lab3, None, n3),
        "properties": tr.calculate_object_properties(lab),
        "properties_time": tr.calculate_object_properties(lab3),
        "overlaps": tr.find_overlapping_objects(lab),
        "overlap_slice": tr.check_overlap_slice(ids[t], ids[t + 1]),
    }


GRID_INPUTS = ["drive", "merge_blobs", "regional"]
ITEMS = ["mask_values", "identify_objects", "identify_objects_time", "properties", "properties_time", "overlaps",
         "overlap_slice"]


@pytest.fixture(scope="module")
def grid_runs(one_torch_thread):  # noqa: F811
    out = {}
    for name in GRID_INPUTS:
        r_tr, p_tr, ev = _inputs(name)
        lab, _, _ = r_tr.identify_objects(ev)
        t = int(np.argmax((to_np(lab.data).reshape(lab.shape[0], -1) > 0).sum(1)[:-1]))
        out[name] = (_api_outputs(r_tr, ev, t), _api_outputs(p_tr, from_reference(ev, "cpu"), t), (r_tr, p_tr, ev))
    return out


def assert_id_fields(r, p, what):
    (r_lab, r_none, r_n), (p_lab, p_none, p_n) = r, p
    assert p_none is None and r_none is None
    assert p_n == r_n > 0, what
    assert p_lab.dims == r_lab.dims and p_lab.name == r_lab.name, what
    a, b = to_np(r_lab.data), to_np(p_lab.data)
    assert a.dtype == b.dtype and np.array_equal(a, b), f"{what}: {int(np.sum(a != b))} ids differ"
    for k in r_lab.coords:
        np.testing.assert_array_equal(p_lab.coords[k].values, r_lab.coords[k].values)


def assert_props(r, p, atol, what, on_circle=False):
    np.testing.assert_array_equal(p["area"].coords["ID"].values, r["area"].coords["ID"].values, err_msg=what)
    assert p["area"].dims == r["area"].dims and p["centroid"].dims == r["centroid"].dims
    np.testing.assert_allclose(p["area"].values, r["area"].values, rtol=AREA_RTOL, atol=0, err_msg=f"{what} area")
    rc, pc = r["centroid"].values.astype(np.float64), p["centroid"].values.astype(np.float64)
    assert rc.shape == pc.shape, what
    np.testing.assert_allclose(pc[0], rc[0], rtol=0, atol=atol, err_msg=f"{what} centroid 0")
    d1 = pc[1] - rc[1]
    if on_circle:  # longitudes: the difference on the circle, shrunk toward the poles
        d1 = ((d1 + 180.0) % 360.0 - 180.0) * np.cos(np.deg2rad(rc[0]))
    assert np.all(np.abs(d1) <= atol), f"{what} centroid 1: {np.abs(d1).max()}"


def assert_pairs(r, p, what, weight_rtol=0.0):
    r, p = np.asarray(r), np.asarray(p)
    assert r.shape == p.shape and r.shape[1:] == (3,), f"{what}: {r.shape} vs {p.shape}"
    np.testing.assert_array_equal(p[:, :2], r[:, :2], err_msg=f"{what} pairs")
    np.testing.assert_allclose(p[:, 2], r[:, 2], rtol=weight_rtol, atol=0, err_msg=f"{what} weights")


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("name", GRID_INPUTS)
def test_grid_midlevel_matches(grid_runs, name, item):
    r, p = (x[item] for x in grid_runs[name][:2])
    what = f"{name} {item}"
    if item == "mask_values":
        assert p.dtype == r.dtype == bool and np.array_equal(p, r)
    elif item.startswith("identify"):
        assert_id_fields(r, p, what)
    elif item.startswith("properties"):
        assert_props(r, p, GRID_CENTROID_ATOL, what)
    else:
        assert len(r) > 0, f"{what}: the input has no overlaps"
        assert_pairs(r, p, what)


def test_time_connected_ids_by_both_routes(grid_runs, monkeypatch):
    """``identify_objects(time_connectivity=True)`` takes the tracker's
    ``ccl3d`` route: with the two-level cutover lowered it gives the fused
    route's ids."""
    import marex_tpu_torch.track as ptrack

    _, p_tr, ev = grid_runs["drive"][2]
    fused = p_tr.identify_objects(from_reference(ev, "cpu"), time_connectivity=True)
    monkeypatch.setattr(ptrack, "TWO_LEVEL_CELLS", 1)
    two = p_tr.identify_objects(from_reference(ev, "cpu"), time_connectivity=True)
    assert two[2] == fused[2] > 0
    np.testing.assert_array_equal(to_np(two[0].data), to_np(fused[0].data))


def test_properties_of_an_empty_field(grid_runs):
    r_tr, p_tr, ev = grid_runs["merge_blobs"][2]
    zeros = np.zeros(ev.shape, np.int32)
    r, p = r_tr.calculate_object_properties(zeros), p_tr.calculate_object_properties(zeros)
    for k in ("area", "centroid"):
        assert p[k].dims == r[k].dims and p[k].shape == r[k].shape


def test_time_connectivity_refused_on_a_mesh():
    nb, lat, lon = tri_mesh(512)
    data = mesh_merge_field(lat, lon, T=4)
    ev, mask, nbf, areas = mesh_fields(data, lat, lon, nb, np.full(len(lat), 1.0e7, np.float32))
    p_tr = port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), neighbours=from_reference(nbf, "cpu"),
                        cell_areas=from_reference(areas, "cpu"), device="cpu", R_fill=1, T_fill=2,
                        area_filter_quartile=0.5, **MESH_KW)
    with pytest.raises(port.ConfigurationError):
        p_tr.identify_objects(from_reference(ev, "cpu"), time_connectivity=True)


@pytest.fixture(scope="module")
def mesh_runs(one_torch_thread):  # noqa: F811
    nb, lat, lon = tri_mesh(2048)
    data = mesh_merge_field(lat, lon, T=12)
    areas = np.random.default_rng(3).uniform(0.5e7, 1.5e7, len(lat)).astype(np.float32)  # unequal: float sums matter
    ev, mask, nbf, ca = mesh_fields(data, lat, lon, nb, areas)
    kw = dict(R_fill=1, T_fill=2, area_filter_quartile=0.5, allow_merging=True, overlap_threshold=0.25, **MESH_KW)
    r_tr = ref.tracker(ev, mask, neighbours=nbf, cell_areas=ca, **kw)
    p_tr = port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), neighbours=from_reference(nbf, "cpu"),
                        cell_areas=from_reference(ca, "cpu"), device="cpu", **kw)
    out = {}
    for key, tr, e in (("ref", r_tr, ev), ("port", p_tr, from_reference(ev, "cpu"))):
        lab, none, n = tr.identify_objects(e)
        ids = to_np(lab.data)
        out[key] = {
            "identify_objects": (lab, none, n),
            "properties": tr.calculate_object_properties(lab),
            "overlap_slice": tr.check_overlap_slice(ids[5], ids[6]),
            "overlaps": tr.find_overlapping_objects(lab),
        }
    return out


@pytest.mark.parametrize("item", ["identify_objects", "properties", "overlap_slice", "overlaps"])
def test_mesh_midlevel_matches(mesh_runs, item):
    r, p = mesh_runs["ref"][item], mesh_runs["port"][item]
    what = f"mesh {item}"
    if item == "identify_objects":
        assert_id_fields(r, p, what)
    elif item == "properties":
        assert_props(r, p, MESH_CENTROID_ATOL, what, on_circle=True)
    else:
        assert len(r) > 0, f"{what}: no overlaps"
        assert_pairs(r, p, what, weight_rtol=AREA_RTOL)
