"""Regional mode of the PyTorch port against ``marex_tpu`` on the CPU: the
edge-padded morphology, labelling and properties with no seam in longitude,
``regional_tracker`` end to end without merging (3x3x3 events, the
drop-first-object quirk included) and with it (nearest-cell and centroid
partitioning), and the mode's validation.

Tolerances: booleans, labels, ids, the ledger and merge records
bit-identical; ``area`` and ``centroid`` within 1e-5; attrs equal."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu.core.field import Field as RefField
from marex_tpu.ops import label as ref_label
from marex_tpu.ops import morphology as ref_morph
from marex_tpu.ops import properties as ref_props
from marex_tpu_torch import tracing
from marex_tpu_torch.core.field import from_reference
from marex_tpu_torch.ops import label as port_label
from marex_tpu_torch.ops import morphology as port_morph
from marex_tpu_torch.ops import properties as port_props

from .test_torch_merge import assert_equal_runs
from .torch_parity import assert_close, assert_same, blob_field, merge_dense_field

H, W = 24, 48
t = torch.from_numpy


def regional_fields(data: np.ndarray, land: bool = True):
    """``(extreme_events, mask)`` reference Fields over lat 30..70, lon
    -30..40 (both ends included: no seam), with a land block."""
    T, ny, nx = data.shape
    coords = {
        "time": pd.date_range("2000-01-01", periods=T, freq="D").to_numpy(),
        "lat": np.linspace(30.0, 70.0, ny),
        "lon": np.linspace(-30.0, 40.0, nx),
    }
    mask = np.ones((ny, nx), bool)
    if land:
        mask[2:5, 3:9] = False
    ev = RefField(data, ("time", "lat", "lon"), coords, name="extreme_events")
    return ev, RefField(mask, ("lat", "lon"), {"lat": coords["lat"], "lon": coords["lon"]}, name="mask")


def both_trackers(ev, mask, monkeypatch, **kw):
    monkeypatch.setenv("MAREX_HOST_CCL", "0")  # the reference's device path, not its host C++ shortcut
    kw = dict(kw, quiet=True)
    r_tr = ref.regional_tracker(ev, mask, "degrees", **kw)
    r_tr.use_scan_march = False
    p_tr = port.regional_tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), "degrees", device="cpu", **kw)
    return r_tr, p_tr


# -- the ops without a seam --------------------------------------------------


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_close_open_grid_edge_matches(radius):
    data = blob_field(4, 6, 20, 36, 40, 4)
    data |= np.random.default_rng(0).random(data.shape) < 0.15  # speckle: holes and specks to fill and open
    mask = np.ones(data.shape[1:], bool)
    mask[3:7, 5:12] = False
    r = ref_morph.binary_close_open_grid(jnp.asarray(data), radius, jnp.asarray(mask), mode="edge")
    p = port_morph.binary_close_open_grid(t(data), radius, t(mask), mode="edge")
    assert_same(r, p, f"edge close/open R={radius}")
    if radius > 1:  # the pad decides near the borders
        assert not torch.equal(p, port_morph.binary_close_open_grid(t(data), radius, t(mask), mode="wrap"))


def test_close_open_grid_refuses_an_unknown_pad():
    with pytest.raises(ValueError, match="mode"):
        port_morph.binary_close_open_grid(torch.ones((1, 4, 4), dtype=torch.bool), 1, torch.ones((4, 4), dtype=torch.bool),
                                          mode="reflect")


def test_labels_stop_at_the_longitude_edges():
    """A block that touches both longitude edges is one object on a global
    grid and two on a regional one, per slice and in 3-D."""
    data = blob_field(1, 10, H, W, 30, 4)  # holds a seam-crossing block
    r_roots, r_counts = ref_label.label_slices_grid_roots(jnp.asarray(data), wrap_x=False)
    p_roots, p_counts, _ = port_label.label_slices_grid_roots(t(data), wrap_x=False)
    assert_same(r_roots, p_roots, "per-slice roots")
    assert_same(r_counts, p_counts, "per-slice counts")
    assert int(p_counts.sum()) > int(port_label.label_slices_grid_roots(t(data), wrap_x=True)[1].sum())
    r_labf, r_n = ref_label.label_spacetime_roots(jnp.asarray(data), wrap_x=False)
    p_labf, _ = port_label.label_spacetime_roots(t(data), wrap_x=False)
    assert_same(r_labf, p_labf, "3-D roots")
    assert port_label.densify_spacetime_roots(p_labf)[1] == int(r_n)


def test_label_props_without_wrap_match():
    labels = np.zeros((3, H, W), np.int32)
    labels[:, 4:9, :3] = 1  # both halves of what a global grid would join
    labels[:, 4:9, W - 3 :] = 1
    labels[1:, 12:20, 10:30] = 2
    r = ref_props.grid_label_props(jnp.asarray(labels), 3, False)
    p = port_props.grid_label_props(t(labels), 3, wrap=False)
    for name, a, b in zip(("area", "cy", "cx"), r, p):
        assert_close(a, b, what=name)
    cx = float(p[2][0, 1])
    assert abs(cx - (W - 1) / 2) < 1e-4  # the plain mean, not the seam


# -- regional_tracker end to end ----------------------------------------------


@pytest.mark.parametrize("area", [dict(area_filter_absolute=6), dict(area_filter_quartile=0.4)], ids=["abs", "quartile"])
def test_regional_tracking_without_merging_matches(area, monkeypatch):
    data = blob_field(3, 30, H, W, 80, 5)
    ev, mask = regional_fields(data)
    r_tr, p_tr = both_trackers(ev, mask, monkeypatch, R_fill=2, T_fill=2, allow_merging=False, **area)
    r = r_tr.run()
    with tracing.collect():
        p = p_tr.run()
    assert_same(r["ID_field"].values, p["ID_field"].values, "ID_field")
    assert p["ID_field"].dims == r["ID_field"].dims
    assert p.attrs == r.attrs and p.attrs["N_events_final"] > 0
    for name in ("time", "lat", "lon"):
        np.testing.assert_array_equal(p.coords[name].values, r.coords[name].values)
    assert "ccl3d" in p_tr.stage_walls
    # a global tracker joins the block across the seam: other events
    g = port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), R_fill=2, T_fill=2, allow_merging=False,
                     coordinate_units="degrees", device="cpu", quiet=True, **area).run()
    assert not np.array_equal(g["ID_field"].values, p["ID_field"].values)


def test_regional_area_filter_drops_the_first_object(monkeypatch):
    """The gridded roots path keeps its quirk in regional mode."""
    data = blob_field(5, 8, H, W, 40, 4)
    ev, mask = regional_fields(data, land=False)
    r_tr, p_tr = both_trackers(ev, mask, monkeypatch, R_fill=1, T_fill=0, area_filter_absolute=1, allow_merging=False)
    r_out, r_thr, r_areas, r_pre, r_post = r_tr.filter_small_objects(jnp.asarray(data))
    p_out, p_thr, p_areas, p_pre, p_post = p_tr.filter_small_objects(t(data))
    assert_same(r_out, p_out, "filtered field")
    assert_same(r_areas, p_areas, "object areas")
    assert (p_thr, p_pre, p_post) == (r_thr, r_pre, r_post)
    roots, counts, _ = port_label.label_slices_grid_roots(t(data), wrap_x=False)
    first_t = int(torch.argmax((counts > 0).int()))
    first = roots[first_t] == roots[first_t].min()
    assert not bool(p_out.reshape(data.shape[0], -1)[first_t][first].any())


@pytest.mark.parametrize("nn", [True, False], ids=["nn", "centroid"])
def test_regional_merge_tracking_matches(nn, monkeypatch):
    data = merge_dense_field(T=40, n_pairs=3, seed=2, ny=H, nx=W)
    ev, mask = regional_fields(data)
    r_tr, p_tr = both_trackers(ev, mask, monkeypatch, R_fill=1, T_fill=2, area_filter_absolute=6, allow_merging=True,
                               nn_partitioning=nn, overlap_threshold=0.25)
    r, p = r_tr.run(return_merges=True), p_tr.run(return_merges=True)
    assert_equal_runs(r, p)
    assert p[0].attrs["total_merges"] > 0 and p_tr.dispatch_counts["partition"] > 0
    lon = p[0]["centroid"].values[1]
    assert np.nanmin(lon) >= -30.0 and np.nanmax(lon) <= 40.0  # no centroid wrapped around


# -- validation ----------------------------------------------------------------


def test_regional_mode_needs_coordinate_units():
    ev, mask = regional_fields(blob_field(3, 6, H, W, 20, 4))
    kw = dict(R_fill=1, area_filter_absolute=4, regional_mode=True, quiet=True)
    with pytest.raises(ref.CoordinateError) as r:
        ref.tracker(ev, mask, **kw)
    with pytest.raises(port.CoordinateError) as p:
        port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), device="cpu", **kw)
    assert str(p.value) == str(r.value)
    with pytest.raises(TypeError):  # the constructor takes the units as a required argument
        port.regional_tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), R_fill=1, device="cpu")


def test_regional_coordinates_in_radians_are_read_as_such(monkeypatch):
    """Radians are converted for the cell areas and the tracking in both
    packages, and the output carries the same coordinates."""
    data = blob_field(3, 12, H, W, 40, 5)
    ev, mask = regional_fields(data)
    rad = {k: (np.deg2rad(v.values) if k in ("lat", "lon") else v.values) for k, v in ev.coords.items()}

    def inputs():  # fresh Fields for each package: the reference converts the coordinates it is given in place
        return (RefField(data, ev.dims, dict(rad), name="extreme_events"),
                RefField(mask.values, mask.dims, {k: rad[k] for k in ("lat", "lon")}, name="mask"))

    monkeypatch.setenv("MAREX_HOST_CCL", "0")
    kw = dict(R_fill=1, T_fill=0, area_filter_absolute=4, allow_merging=False, quiet=True)
    p_tr = port.regional_tracker(*(from_reference(f, "cpu") for f in inputs()), "radians", device="cpu", **kw)
    r_tr = ref.regional_tracker(*inputs(), "radians", **kw)
    np.testing.assert_allclose(p_tr.lat, r_tr.lat, rtol=1e-12)
    np.testing.assert_allclose(p_tr.cell_area, r_tr.cell_area, rtol=1e-6)
    r, p = r_tr.run(), p_tr.run()
    assert_same(r["ID_field"].values, p["ID_field"].values, "ID_field")
    for name in ("lat", "lon"):
        np.testing.assert_array_equal(p.coords[name].values, r.coords[name].values)
    assert p_tr.lat.max() == pytest.approx(70.0)  # the tracker works in degrees
