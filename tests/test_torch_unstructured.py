"""Unstructured-mesh detect and track of the PyTorch port against ``marex_tpu``
on the CPU: each mesh op alone (morphology, properties, partition, weighted
overlaps, the area filter's bookkeeping), the mesh tracker end to end with
merges (the per-step march, ``use_scan_march=False``), mesh detect for each
method, and every error of the mesh tracker's validation.

Tolerances: booleans, labels, ids and merge records bit-identical. Areas
within 1e-5 relative (the reference sums cell areas in float32, the port in
float64). Centroids within 2e-4 degrees (float32 trigonometry and sums in the
reference, float64 in the port), longitudes compared on the circle and wider
near the poles, where a longitude is ill-conditioned."""

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
from marex_tpu.ops import overlap as ref_overlap
from marex_tpu.ops import partition as ref_part
from marex_tpu.ops import properties as ref_props
from marex_tpu.track import _symmetrize_neighbours as ref_symmetrize
from marex_tpu_torch import tracing
from marex_tpu_torch.core.field import from_reference
from marex_tpu_torch.ops import label as port_label
from marex_tpu_torch.ops import morphology as port_morph
from marex_tpu_torch.ops import overlap as port_overlap
from marex_tpu_torch.ops import partition as port_part
from marex_tpu_torch.ops import properties as port_props

from .conftest import make_unstructured_mesh
from .torch_parity import DETECT_FIXED, MESH_KW, assert_close, assert_same, mesh_fields, mesh_merge_field, to_np, tri_mesh

AREA_RTOL = 1e-5
CENTROID_ATOL = 2e-4  # degrees
t = torch.from_numpy


class Mesh:
    """A Delaunay test mesh with its tables and the port's per-cell weights."""

    def __init__(self, n_side=16, seed=7):
        self.lat, self.lon, self.nb1, self.areas = make_unstructured_mesh(n_side=n_side, seed=seed)
        self.nb0 = self.nb1.astype(np.int32) - 1
        self.C = len(self.lat)
        self.unit = t(port_props.mesh_unit_vectors(self.lat, self.lon))
        self.wall = port_props.mesh_weights(self.lat, self.lon, self.areas, "cpu")

    def ref_geo(self):
        return jnp.asarray(self.lat), jnp.asarray(self.lon), jnp.asarray(self.areas)


@pytest.fixture(scope="module")
def mesh():
    return Mesh()


def assert_props_close(ref_apl, port_apl, what=""):
    """(area, clat, clon) triples, arrays of any equal shape."""
    (ra, rlat, rlon), (pa, plat, plon) = ([to_np(x).astype(np.float64) for x in trip] for trip in (ref_apl, port_apl))
    np.testing.assert_allclose(pa, ra, rtol=AREA_RTOL, atol=0, err_msg=f"{what} area")
    np.testing.assert_array_equal(np.isnan(plat), np.isnan(rlat), err_msg=f"{what} NaN pattern")
    ok = ~np.isnan(rlat)
    np.testing.assert_allclose(plat[ok], rlat[ok], rtol=0, atol=CENTROID_ATOL, err_msg=f"{what} clat")
    dlon = np.abs((plon[ok] - rlon[ok] + 180.0) % 360.0 - 180.0) * np.cos(np.deg2rad(rlat[ok]))  # on the circle
    assert (dlon <= CENTROID_ATOL).all(), f"{what} clon: {dlon.max()}"


# -- morphology -----------------------------------------------------------


@pytest.mark.parametrize("asymmetric", [False, True], ids=["mesh_table", "asymmetric_table"])
def test_neighbour_dilation_matches(mesh, asymmetric):
    nb0 = mesh.nb0.copy()
    if asymmetric:
        nb0[np.random.default_rng(0).random(nb0.shape) < 0.2] = -1
    vec = np.random.default_rng(1).random((4, mesh.C)) < 0.05
    assert_same(ref_morph.neighbour_dilate_step(jnp.asarray(vec), jnp.asarray(nb0)),
                port_morph.neighbour_dilate_step(t(vec), t(nb0)), "dilate step")
    assert_same(ref_morph.neighbour_dilate(jnp.asarray(vec), jnp.asarray(nb0), 3),
                port_morph.neighbour_dilate(t(vec), t(nb0), 3), "dilate 3")


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_close_open_unstructured_matches(mesh, radius, monkeypatch):
    rng = np.random.default_rng(radius)
    data = rng.random((9, mesh.C)) < 0.45
    mask = rng.random(mesh.C) < 0.85
    monkeypatch.setattr(port_morph, "_TIME_CHUNK", 4)  # several time chunks
    r = ref_morph.binary_close_open_unstructured(jnp.asarray(data), jnp.asarray(mesh.nb0), jnp.asarray(mask), radius)
    p = port_morph.binary_close_open_unstructured(t(data), t(mesh.nb0), t(mask), radius)
    assert_same(r, p, f"close/open R={radius}")
    if radius:
        assert bool(p[:, ~mask].any())  # land may come out True, as in the reference


# -- properties -----------------------------------------------------------


def test_label_props_and_comps_match(mesh, monkeypatch):
    labels = np.random.default_rng(2).integers(0, 7, (5, mesh.C)).astype(np.int32)
    labels[labels == 5] = 0  # label 5 absent: NaN centroids
    monkeypatch.setattr(port_props, "_CHUNK_CELLS", 2 * mesh.C)  # several time chunks
    r = ref_props.unstructured_label_props(jnp.asarray(labels), *mesh.ref_geo(), 6)
    p = port_props.unstructured_label_props(t(labels), mesh.wall, 6)
    assert_props_close([x[:, 1:] for x in r], [x[:, 1:] for x in p], "label props")
    assert bool(torch.isnan(p[1][:, 5]).all()) and bool((p[0][:, 5] == 0).all())
    rc = to_np(ref_props.unstructured_label_comps(jnp.asarray(labels), *mesh.ref_geo(), 6))[:, 1:]
    pc = port_props.unstructured_label_comps(t(labels), mesh.wall, 6).numpy()[:, 1:]
    np.testing.assert_allclose(pc, rc, rtol=AREA_RTOL, atol=1e-2)  # |sum a x| can cancel: absolute, in area units


def test_mask_props_match(mesh):
    masks = np.random.default_rng(3).random((2, 3, mesh.C)) < 0.2
    masks[1, 2] = False  # an empty mask gives (0, 0, 0)
    p = port_props.unstructured_mask_props(t(masks), mesh.wall)
    for i in range(2):
        for j in range(3):
            r = to_np(ref_props.unstructured_mask_props(jnp.asarray(masks[i, j]), *mesh.ref_geo()))
            assert_props_close(r, p[i, j].numpy(), f"mask ({i}, {j})")
    assert p[1, 2].tolist() == [0.0, 0.0, 0.0]


def test_wrapped_centroid_on_seam():
    """An object straddling lon 0/360 has its centroid on the seam."""
    lon = np.array([356.0, 358.0, 2.0, 4.0], np.float32)
    lat = np.full(4, 5.0, np.float32)
    labels = np.array([[1, 1, 1, 1]], np.int32)
    r = ref_props.unstructured_label_props(jnp.asarray(labels), jnp.asarray(lat), jnp.asarray(lon), jnp.ones(4), 1)
    p = port_props.unstructured_label_props(t(labels), port_props.mesh_weights(lat, lon, np.ones(4), "cpu"), 1)
    assert_props_close([x[:, 1:] for x in r], [x[:, 1:] for x in p], "seam")
    c = float(p[2][0, 1]) % 360.0
    assert min(c, 360.0 - c) < 1e-3 and abs(float(p[1][0, 1]) - 5.0) < 0.5 and float(p[0][0, 1]) == 4.0


# -- partition ------------------------------------------------------------

CENTS = np.array([[10.0, 20.0], [-30.0, 200.0], [5.0, 359.0]], np.float32)
VALID = np.array([True, True, False])


def test_hop_distance_matches(mesh):
    seeds = np.zeros((3, mesh.C), bool)
    seeds[0, 10] = seeds[1, 200] = seeds[1, 201] = True  # the third region is empty
    for cap in (1, 5, 64):
        r = ref_part.hop_distance_unstructured(jnp.asarray(seeds), jnp.asarray(mesh.nb0), cap)
        assert_same(r, port_part.hop_distance_unstructured(t(seeds), t(mesh.nb0), cap), f"hops <= {cap}")


def test_haversine_matches(mesh):
    r = ref_part.haversine_to_centroids(jnp.asarray(mesh.lat), jnp.asarray(mesh.lon), jnp.asarray(CENTS))
    p = port_part.haversine_to_centroids(mesh.unit, t(CENTS))
    assert p.shape == (3, mesh.C) and p.dtype == torch.float32
    assert_close(r, p, atol=5e-6, what="haversine (radians; float32 trigonometry in the reference)")


def test_partition_centroid_and_nn_match(mesh):
    r = ref_part.partition_centroid_unstructured(jnp.asarray(CENTS), jnp.asarray(VALID), jnp.asarray(mesh.lat),
                                                 jnp.asarray(mesh.lon))
    assert_same(r, port_part.partition_centroid_unstructured(t(CENTS), t(VALID), mesh.unit), "centroid assign")
    child = np.random.default_rng(4).random(mesh.C) < 0.5
    pmasks = np.zeros((3, mesh.C), bool)
    pmasks[0] = (mesh.lon < 120) & child
    pmasks[1] = (mesh.lon > 250) & child
    for cap in (2, 6):
        r = ref_part.partition_nn_unstructured(jnp.asarray(child), jnp.asarray(pmasks), jnp.asarray(VALID),
                                               jnp.asarray(CENTS), jnp.asarray(mesh.nb0), jnp.asarray(mesh.lat),
                                               jnp.asarray(mesh.lon), cap)
        p = port_part.partition_nn_unstructured(t(child), t(pmasks), t(VALID), t(CENTS), t(mesh.nb0), mesh.unit, cap)
        assert_same(r, p, f"nn assign, cap {cap}")


@pytest.mark.parametrize("caps", [(3, 2, 0), (40, 40, 0)], ids=["short_caps", "long_caps"])
@pytest.mark.parametrize("nn", [True, False], ids=["nn", "centroid"])
def test_partition_children_batched_matches(mesh, nn, caps):
    lat, lon, C = mesh.lat, mesh.lon, mesh.C
    prev = np.zeros(C, np.int32)
    prev[lon < 150], prev[lon > 200], prev[lat > 40] = 3, 4, 5
    cur = np.zeros(C, np.int32)
    cur[(lat < 30) & (lat > -30)], cur[lat < -40] = 7, 8
    child_ids = np.array([7, 8, 0], np.int32)  # the third slot is padding
    pids = np.array([[3, 4, 0], [4, 3, 5], [0, 0, 0]], np.int32)
    piece = np.array([[7, 20, 0], [8, 21, 22], [0, 0, 0]], np.int32)
    pvalid = pids > 0
    cents = np.array([[[0, 60], [0, 280], [0, 0]], [[-50, 300], [-45, 50], [50, 180]], [[0, 0]] * 3], np.float32)
    caps = np.array(caps, np.float32)
    r_new, r_props = ref_part.partition_children_unstructured_batched(
        *(jnp.asarray(x) for x in (prev, cur, child_ids, piece, pids, pvalid, cents, caps, mesh.nb0)),
        *mesh.ref_geo(), nn, 64)
    p_new, p_props = port_part.partition_children_unstructured_batched(
        *(t(x) for x in (prev, cur, child_ids, piece, pids, pvalid, cents, caps, mesh.nb0)), mesh.unit, mesh.wall, nn,
        int(caps.max()))
    assert_same(r_new, p_new, "partitioned slice")
    assert len(np.unique(p_new.numpy())) > 3  # pieces were cut
    assert_props_close(np.moveaxis(to_np(r_props), -1, 0), np.moveaxis(p_props.numpy(), -1, 0), "piece props")


def test_relabel_and_props_unstructured_matches(mesh):
    cur = np.zeros(mesh.C, np.int32)
    cur[mesh.lat > 20], cur[mesh.lat < -20], cur[np.abs(mesh.lat) < 5] = 7, 8, 9
    olds, news, targets = np.array([8, 0], np.int32), np.array([7, 0], np.int32), np.array([7, 0], np.int32)
    r_out, r_props = ref_part.relabel_and_props_unstructured(*(jnp.asarray(x) for x in (cur, olds, news, targets)),
                                                             *mesh.ref_geo())
    p_out, p_props = port_part.relabel_and_props_unstructured(t(cur), olds.tolist(), news.tolist(), t(targets), mesh.wall)
    assert_same(r_out, p_out, "renamed slice")
    assert_props_close(to_np(r_props).T, p_props.numpy().T, "target props")
    assert p_props[1].tolist() == [0.0, 0.0, 0.0]


# -- overlaps and the area filter's bookkeeping ---------------------------


def test_weighted_overlap_pairs_match(mesh):
    # a patch of cells is on or off as a whole: a few objects a slice
    patch = (np.floor(mesh.lat / 30.0) * 12 + np.floor(mesh.lon / 30.0)).astype(np.int64)
    patch -= patch.min()
    data = (np.random.default_rng(5).random((6, int(patch.max()) + 1)) < 0.4)[:, patch]
    sym = ref_symmetrize(mesh.nb0)
    labels, counts = ref_label.label_slices_unstructured(jnp.asarray(data), jnp.asarray(sym))
    labels = np.array(ref_label.offset_labels_across_time(labels, counts))
    stride = int(labels.max()) + 2
    pa, pb, pw = ref_overlap.consecutive_pairs_tiled(jnp.asarray(labels), jnp.asarray(mesh.areas), 64, stride)
    assert (np.asarray(pa)[:, -1] < 0).all()  # no slot overflow
    valid = np.asarray(pa) >= 0
    tt, a, b, w = port_overlap.consecutive_pairs(t(labels), stride, t(mesh.areas))
    np.testing.assert_array_equal(tt.numpy(), np.nonzero(valid)[0])
    np.testing.assert_array_equal(a.numpy(), np.asarray(pa)[valid])
    np.testing.assert_array_equal(b.numpy(), np.asarray(pb)[valid])
    assert w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.asarray(pw)[valid], rtol=AREA_RTOL)
    sa, sb, sw = port_overlap.slice_pairs(t(labels[2]), t(labels[3]), stride, t(mesh.areas))
    np.testing.assert_array_equal(np.stack([sa, sb], 1), np.stack([a, b], 1)[tt.numpy() == 2])
    np.testing.assert_array_equal(sw.numpy(), w.numpy()[tt.numpy() == 2])


def test_label_counts_and_selection_match(mesh, monkeypatch):
    labels = np.random.default_rng(6).integers(0, 9, (7, mesh.C)).astype(np.int32)
    keep = np.random.default_rng(7).random((7, 9)) < 0.5
    keep[:, 0] = False  # the background is never kept
    monkeypatch.setattr(port_label, "_CHUNK_CELLS", 2 * mesh.C)  # several time chunks
    counts = port_label.label_cell_counts(t(labels), 8)
    assert_same(np.asarray(ref_props.label_sums(jnp.asarray(labels), jnp.ones(mesh.C), 8)).astype(np.int64), counts,
                "cells per label")
    assert_same(ref_label.select_labels(jnp.asarray(labels), jnp.asarray(keep), 8),
                port_label.select_labels(t(labels), t(keep)), "selected cells")


# -- the tracker end to end ------------------------------------------------


def run_both(fields, merges=True, **kw):
    """The reference's per-step march and the port (CPU) on one mesh input."""
    ev, mask, nb, ca = fields
    kw = dict(MESH_KW, **kw)
    r_tr = ref.tracker(ev, mask, neighbours=nb, cell_areas=ca, temp_dir="/tmp", **kw)
    r_tr.use_scan_march = False
    p_tr = port.tracker(*(from_reference(f, "cpu") for f in (ev, mask)), neighbours=from_reference(nb, "cpu"),
                        cell_areas=from_reference(ca, "cpu"), device="cpu", **kw)
    r = r_tr.run(return_merges=merges)
    with tracing.collect():
        return r, p_tr.run(return_merges=merges), p_tr


def assert_equal_mesh_runs(r, p):
    """Integer and boolean outputs, the ledger, the times and the merge
    records bit-identical (the overlap areas, truncated float32 sums of cell
    areas in the reference, within 1e-5); area and centroid within the
    module's tolerances; attrs equal, but for the two area fractions (float32
    sums in the reference) within 1e-5."""
    (r_ev, r_mg), (p_ev, p_mg) = (x if isinstance(x, tuple) else (x, None) for x in (r, p))
    for name in ("ID_field", "global_ID", "presence", "merge_ledger", "time_start", "time_end"):
        assert_same(r_ev[name].values, p_ev[name].values, name)
        assert p_ev[name].dims == r_ev[name].dims, name
    assert p_ev["ID_field"].dims == ("time", "ncells")
    r_cent, p_cent = r_ev["centroid"].values, p_ev["centroid"].values
    assert_props_close((r_ev["area"].values, r_cent[0], r_cent[1]), (p_ev["area"].values, p_cent[0], p_cent[1]), "events")
    if r_mg is not None:
        for name in ("parent_IDs", "child_IDs", "merge_time", "n_parents", "n_children"):
            assert_same(r_mg[name].values, p_mg[name].values, name)
        np.testing.assert_allclose(p_mg["overlap_areas"].values, r_mg["overlap_areas"].values, rtol=AREA_RTOL, atol=1)
    fractions = ("accepted_area_fraction", "preprocessed_area_fraction")
    assert {k: v for k, v in p_ev.attrs.items() if k not in fractions} == \
        {k: v for k, v in r_ev.attrs.items() if k not in fractions}
    for k in fractions:
        assert p_ev.attrs[k] == pytest.approx(r_ev.attrs[k], rel=1e-5)
    for name in ("time", "lat", "lon", "ID"):
        np.testing.assert_array_equal(p_ev.coords[name].values, r_ev.coords[name].values)


@pytest.fixture(scope="module")
def merge_mesh():
    """The periodic triangle-pair mesh (4050 cells) with uneven cell areas, a
    land patch, and a field whose patch pairs merge and split."""
    nb, lat, lon = tri_mesh(4096)
    areas = (1e3 * np.cos(np.deg2rad(lat)) * np.random.default_rng(0).uniform(0.8, 1.2, len(lat))).astype(np.float32)
    mask = ~((np.abs(lat - 40) < 6) & (np.abs(lon - 200) < 30))
    return mesh_fields(mesh_merge_field(lat, lon), lat, lon, nb, areas, mask)


@pytest.mark.parametrize("nn", [True, False], ids=["nn", "centroid"])
def test_mesh_merge_tracking_matches(merge_mesh, nn):
    r, p, p_tr = run_both(merge_mesh, R_fill=1, T_fill=2, area_filter_quartile=0.1, allow_merging=True,
                          nn_partitioning=nn, overlap_threshold=0.25)
    assert_equal_mesh_runs(r, p)
    assert p[0].attrs["total_merges"] > 0 and p_tr.dispatch_counts["partition"] > 0
    assert p[0].attrs["N_objects_filtered"] < p[0].attrs["N_objects_prefiltered"]  # the strict, cell-count filter cut
    assert {"filter/ccl_fixpoint", "ccl"} <= set(p_tr.ccl_iterations)
    assert not bool(p[0]["ID_field"].data[:, ~merge_mesh[1].values].any())  # nothing on land


def test_mesh_without_merging_still_takes_the_march(merge_mesh):
    """``allow_merging=False`` on a mesh runs the march all the same (the
    reference's rule) and returns the events alone."""
    r, p, p_tr = run_both(merge_mesh, merges=False, R_fill=1, T_fill=2, area_filter_absolute=60, allow_merging=False)
    assert not isinstance(p, tuple)
    assert_equal_mesh_runs(r, p)
    assert "march" in p_tr.stage_walls and "ccl3d" not in p_tr.stage_walls and "total_merges" not in p.attrs


def hop_ball(nb0, C, center, radius):
    dist = np.full(C, 255, np.int16)
    dist[center] = 0
    frontier = [center]
    for d in range(1, radius + 1):
        nxt = []
        for c in frontier:
            for n in nb0[:, c]:
                if n >= 0 and dist[n] == 255:
                    dist[n] = d
                    nxt.append(n)
        frontier = nxt
    return dist <= radius


def test_growing_hop_balls_match(mesh):
    """Two hop-balls that grow until they touch (``tests/test_unstructured.py``),
    physical areas and geographic centroids included."""
    order = np.argsort(mesh.lon)
    left, right = order[len(order) // 4], order[3 * len(order) // 4]
    data = np.stack([hop_ball(mesh.nb0, mesh.C, left, 3 + k // 2) | hop_ball(mesh.nb0, mesh.C, right, 3 + k // 2)
                     for k in range(12)])
    fields = mesh_fields(data, mesh.lat, mesh.lon, mesh.nb1, mesh.areas)
    r, p, _ = run_both(fields, R_fill=0, T_fill=0, area_filter_absolute=2, nn_partitioning=True)
    assert_equal_mesh_runs(r, p)
    area, pres = p[0]["area"].values, p[0]["presence"].values
    assert np.nanmean(area[pres]) > 2 * float(mesh.areas.mean())  # sums of cell areas, not cell counts
    assert np.nanmax(np.abs(p[0]["centroid"].values[0])) <= 90.0


@pytest.fixture(scope="module")
def blinking():
    """A patch on a 32 x 32 Delaunay mesh that is absent on days 5 and 6."""
    lat, lon, nb, areas = make_unstructured_mesh(n_side=32, seed=3)
    d = np.minimum(np.abs(lon - 120), 360 - np.abs(lon - 120))
    data = np.tile((np.abs(lat - 10) < 14) & (d < 20), (12, 1))
    data[5:7] = False
    return mesh_fields(data, lat, lon, nb, areas)


@pytest.mark.parametrize("t_fill, n_events", [(0, 2), (2, 1)])
def test_temporal_gap_filling_matches(blinking, t_fill, n_events):
    r, p, _ = run_both(blinking, merges=False, R_fill=1, T_fill=t_fill, area_filter_absolute=6, allow_merging=False)
    assert_equal_mesh_runs(r, p)
    assert p.attrs["N_events_final"] == n_events
    assert bool((p["ID_field"].data[5:7] > 0).any()) == (t_fill == 2)


def test_filter_beyond_every_object_leaves_no_event(blinking):
    cells = int(blinking[0].values[0].sum())
    r, p, _ = run_both(blinking, merges=False, R_fill=1, T_fill=0, area_filter_absolute=cells * 10, allow_merging=False)
    assert_equal_mesh_runs(r, p)
    assert p.attrs["N_events_final"] == 0 and not bool(p["ID_field"].data.any())


@pytest.mark.parametrize(
    "area, min_cells",
    [(dict(area_filter_quartile=0.5), 50), (dict(area_filter_quartile=0.0), 50), (dict(area_filter_absolute=20), 5)],
    ids=["quartile", "quartile_0", "absolute"],
)
def test_mesh_area_filter_rules_match(merge_mesh, area, min_cells):
    """Cell counts, the > 50 (or > 5) pre-filter, the strict ``>``, and no
    dropped first object."""
    ev, mask, nb, ca = merge_mesh
    kw = dict(MESH_KW, R_fill=0, T_fill=0, **area)
    r_tr = ref.tracker(ev, mask, neighbours=nb, cell_areas=ca, temp_dir="/tmp", **kw)
    p_tr = port.tracker(*(from_reference(f, "cpu") for f in (ev, mask)), neighbours=from_reference(nb, "cpu"),
                        cell_areas=from_reference(ca, "cpu"), device="cpu", **kw)
    data = ev.values & mask.values
    r_out, r_thr, r_areas, r_pre, r_post = r_tr.filter_small_objects(jnp.asarray(data))
    p_out, p_thr, p_areas, p_pre, p_post = p_tr.filter_small_objects(t(data))
    assert_same(r_out, p_out, "filtered field")
    assert_same(r_areas, p_areas, "object areas")
    assert (p_thr, p_pre, p_post) == (r_thr, r_pre, r_post)
    assert p_areas.min() > min_cells and p_areas.min() == int(p_areas.min())  # cell counts above the pre-filter
    labels, counts, _ = port_label.label_slices_unstructured(t(data), p_tr._nb_sym_dev)
    sizes = port_label.label_cell_counts(labels, int(counts.max()))
    kept = torch.gather(sizes, 1, labels.long())[p_out]
    assert bool((kept > p_thr).all())  # strict
    assert bool(p_out[0].any())  # the first slice keeps its objects: no drop-first quirk


# -- detect on a mesh ------------------------------------------------------

MESH_DIMS = {"time": "time", "x": "ncells"}
MESH_COORDS = {"time": "time", "x": "lon", "y": "lat"}


@pytest.fixture(scope="module")
def mesh_sst():
    """3 years of daily AR(1) SST on 512 cells of the triangle-pair mesh,
    with a land block."""
    nb, lat, lon = tri_mesh(512)
    rng = np.random.default_rng(0)
    times = pd.date_range("2000-01-01", periods=3 * 365, freq="D").to_numpy()
    sst = 15 + rng.standard_normal((len(times), len(lat))).astype(np.float32)
    for k in range(1, len(times)):
        sst[k] = 0.7 * sst[k - 1] + 0.4 * sst[k]
    sst[:, 5:9] = np.nan
    sc = {"lat": ("ncells", lat), "lon": ("ncells", lon)}
    da = RefField(sst, ("time", "ncells"), {"time": times, **sc}, name="sst")
    return da, RefField(nb, ("nv", "ncells"), name="neighbours"), RefField(np.ones(len(lat), np.float32), ("ncells",),
                                                                          name="cell_areas")


@pytest.mark.parametrize(
    "kw, atol",
    [
        (DETECT_FIXED, 0.0),
        (dict(method_anomaly="fixed_baseline", method_extreme="hobday_extreme"), 0.0),
        (dict(method_anomaly="fixed_baseline", method_extreme="hobday_extreme", method_percentile="exact"), 0.0),
        (dict(method_anomaly="shifting_baseline", window_year_baseline=2, method_extreme="global_extreme"), 5e-4),
        (dict(method_anomaly="detrend_harmonic", std_normalise=True, method_extreme="global_extreme",
              method_percentile="exact"), 1e-4),
        (dict(method_anomaly="detrend_fixed_baseline", method_extreme="global_extreme"), 1e-4),
    ],
    ids=["fixed_global", "fixed_hobday", "fixed_hobday_exact", "shifting_global", "detrend_stn_exact", "detrend_fixed"],
)
def test_mesh_detect_matches(mesh_sst, kw, atol):
    """Every detect method on (time, cell) data: bit-identical where the
    gridded path is (fixed baseline), else within the gridded tolerances."""
    da, nb, ca = mesh_sst
    args = dict(dimensions=MESH_DIMS, coordinates=MESH_COORDS, quiet=True, **kw)
    r = ref.preprocess_data(da, neighbours=nb, cell_areas=ca, **args)
    p = port.preprocess_data(from_reference(da, "cpu"), neighbours=from_reference(nb, "cpu"),
                             cell_areas=from_reference(ca, "cpu"), device="cpu", **args)
    assert set(p.data_vars) == set(r.data_vars) and {"neighbours", "cell_areas"} <= set(p.data_vars)
    assert p.attrs == r.attrs
    for name in r.data_vars:
        assert p[name].dims == r[name].dims, name
        if to_np(r[name].values).dtype.kind == "f":
            assert_close(r[name].values, p[name].values, atol=atol, what=name)
        elif atol == 0.0 or not name.startswith("extreme_events"):
            assert_same(r[name].values, p[name].values, name)
        else:  # extremes from anomalies that agree within atol: a few cells at their threshold
            assert (to_np(r[name].values) != to_np(p[name].values)).mean() < 1e-3, name
    assert p["dat_anomaly"].dims == ("time", "ncells")
    assert p["neighbours"].values.dtype == np.int32 and p["cell_areas"].values.dtype == np.float32


def test_mesh_detect_errors_match(mesh_sst):
    da = mesh_sst[0]
    pda = from_reference(da, "cpu")
    with pytest.raises(ref.DataValidationError) as r:  # a mesh needs explicit coordinates
        ref.preprocess_data(da, method_anomaly="fixed_baseline", dimensions=MESH_DIMS, quiet=True)
    with pytest.raises(port.DataValidationError) as p:
        port.preprocess_data(pda, method_anomaly="fixed_baseline", dimensions=MESH_DIMS, device="cpu", quiet=True)
    assert p.value.message == r.value.message
    kw = dict(method_anomaly="fixed_baseline", method_extreme="hobday_extreme", window_spatial_hobday=5,
              dimensions=MESH_DIMS, coordinates=MESH_COORDS, quiet=True)
    with pytest.raises(ref.ConfigurationError) as r:  # no spatial Hobday window on a mesh
        ref.preprocess_data(da, **kw)
    with pytest.raises(port.ConfigurationError) as p:
        port.preprocess_data(pda, device="cpu", **kw)
    assert p.value.message == r.value.message


def test_hobday_tiles_of_a_mesh_fill_the_budget():
    """One row of cells is cut into tiles as wide as the budget, not into
    squares' sides; any tiling gives the same thresholds."""
    from marex_tpu_torch.ops import quantile as q

    bins = torch.randint(0, 6, (2, 366, 300), dtype=torch.int16)
    widths = [nc for _, _, (_, nc) in q.hobday_tiles(bins, 5, (1, 300), 0, True, 366 * 6 * 4 * 100)]
    assert widths == [100, 100, 100]


# -- validation -------------------------------------------------------------


@pytest.mark.parametrize(
    "change, error",
    [
        (dict(neighbours=None), "DataValidationError"),
        (dict(cell_areas=None), "DataValidationError"),
        (dict(neighbours="two_rows"), "DataValidationError"),
        (dict(neighbours="bad_dims"), "DataValidationError"),
        (dict(grid_resolution=0.25), "DataValidationError"),
        (dict(data="three_d"), "DataValidationError"),
        (dict(data="float"), "DataValidationError"),
        (dict(coordinates={"x": "nolon", "y": "lat"}), "DataValidationError"),
        (dict(coordinate_units=None), "CoordinateError"),
        (dict(T_fill=3), "ConfigurationError"),
        (dict(regional_mode=True), "NotImplementedError"),
    ],
    ids=["no_neighbours", "no_cell_areas", "two_rows", "bad_dims", "grid_resolution", "three_d", "not_bool",
         "missing_coord", "units_not_detectable", "odd_T_fill", "regional"],
)
def test_mesh_tracker_validation_errors_match(mesh, change, error):
    data = np.zeros((4, mesh.C), bool)
    data[:, :40] = True
    ev, mask, nb, ca = mesh_fields(data, mesh.lat, mesh.lon, mesh.nb1, mesh.areas)
    kw = dict(MESH_KW, R_fill=1, neighbours=nb, cell_areas=ca)
    kw.update(change)
    if kw["neighbours"] == "two_rows":
        kw["neighbours"] = RefField(mesh.nb1[:2], ("nv", "ncells"))
    elif kw["neighbours"] == "bad_dims":
        kw["neighbours"] = RefField(mesh.nb1, ("vertex", "ncells"))
    which = kw.pop("data", None)
    if which == "three_d":
        ev = RefField(data[:, None], ("time", "lat2", "ncells"), {"time": ev.coords["time"].values, **{
            k: ("ncells", ev.coords[k].values) for k in ("lat", "lon")}})
    elif which == "float":
        ev = RefField(data.astype(np.float32), ev.dims, ev.coords)
    p_kw = {k: from_reference(v, "cpu") if isinstance(v, RefField) else v for k, v in kw.items()}
    r_err = NotImplementedError if error == "NotImplementedError" else getattr(ref, error)
    p_err = NotImplementedError if error == "NotImplementedError" else getattr(port, error)
    with pytest.raises(r_err) as r:
        ref.tracker(ev, mask, temp_dir="/tmp", **kw)
    with pytest.raises(p_err) as p:
        port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), device="cpu", **p_kw)
    assert str(p.value) == str(r.value)


def test_raw_arrays_take_the_canonical_dims(mesh):
    """Raw neighbour and cell-area arrays (numpy or tensors) are read as
    ('nv', cells) and (cells,)."""
    data = np.zeros((3, mesh.C), bool)
    data[:, :80] = True
    ev, mask, nb, ca = mesh_fields(data, mesh.lat, mesh.lon, mesh.nb1, mesh.areas)
    kw = dict(MESH_KW, R_fill=0, T_fill=0, area_filter_absolute=6)
    want = port.tracker(*(from_reference(f, "cpu") for f in (ev, mask)), neighbours=from_reference(nb, "cpu"),
                        cell_areas=from_reference(ca, "cpu"), device="cpu", **kw).run()
    for conv in (np.asarray, torch.from_numpy):
        got = port.tracker(*(from_reference(f, "cpu") for f in (ev, mask)), neighbours=conv(mesh.nb1),
                           cell_areas=conv(mesh.areas), device="cpu", **kw).run()
        assert_same(want["ID_field"].values, got["ID_field"].values, "ID_field")
