"""Merge tracking of the PyTorch port against ``marex_tpu``'s per-step march
(``use_scan_march=False``): end to end on the merge-dense field (nearest-cell
and centroid partitioning, both ledger modes), the parent-count limit, and
the verify drive through ``preprocess_data``; then the march's building
blocks — the host union-find, the per-slice dense labels, id offsets and
remaps, and the overlap pairs."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu import _native as ref_native
from marex_tpu.ops import label as ref_label
from marex_tpu.ops import overlap as ref_overlap
from marex_tpu_torch import _native as port_native
from marex_tpu_torch.core.field import from_reference
from marex_tpu_torch.ops import label as port_label
from marex_tpu_torch.ops import overlap as port_overlap

from .torch_parity import DETECT_FIXED, assert_same, blob_field, bool_fields, drive_sst, merge_dense_field

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERGE = dict(R_fill=2, T_fill=0, area_filter_quartile=0.0, allow_merging=True, overlap_threshold=0.3, quiet=True)


def _run_both(ev, mask, **kw):
    """The reference's per-step march and the port (CPU) on one input."""
    r_tr = ref.tracker(ev, mask, **kw)
    r_tr.use_scan_march = False
    r = r_tr.run(return_merges=True)
    p_tr = port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), device="cpu", **kw)
    p = p_tr.run(return_merges=True)
    return r, p, p_tr


def assert_equal_runs(r, p):
    """Integer and boolean outputs, the ledger, the times and every merge
    record bit-identical; area and centroid within 1e-5; attrs equal."""
    (r_ev, r_mg), (p_ev, p_mg) = r, p
    for name in ("ID_field", "global_ID", "presence", "merge_ledger", "time_start", "time_end"):
        assert_same(r_ev[name].values, p_ev[name].values, name)
        assert p_ev[name].dims == r_ev[name].dims, name
    for name in ("area", "centroid"):
        a, b = (np.asarray(x[name].values, dtype=np.float64) for x in (r_ev, p_ev))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        np.testing.assert_allclose(np.nan_to_num(a, nan=-999.0), np.nan_to_num(b, nan=-999.0), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    for name in ("parent_IDs", "child_IDs", "overlap_areas", "merge_time", "n_parents", "n_children"):
        assert_same(r_mg[name].values, p_mg[name].values, name)
    assert p_ev.attrs == r_ev.attrs
    for name in ("time", "lat", "lon", "ID"):
        np.testing.assert_array_equal(p_ev.coords[name].values, r_ev.coords[name].values)


@pytest.fixture(scope="module")
def dense_fields():
    data = merge_dense_field()
    return bool_fields(data, np.ones(data.shape[1:], bool))


@pytest.mark.parametrize("nn", [True, False], ids=["nn", "centroid"])
def test_merge_dense_matches(dense_fields, nn):
    r, p, p_tr = _run_both(*dense_fields, nn_partitioning=nn, **MERGE)
    assert_equal_runs(r, p)
    assert p[0].attrs["total_merges"] > 0
    assert p_tr.dispatch_counts["partition"] > 0
    assert {"ccl", "march", "rename", "rename/gid", "rename/remap", "rename/stats"} <= set(p_tr.stage_walls)


def test_siblings_ledger_matches(dense_fields):
    r, p, _ = _run_both(*dense_fields, nn_partitioning=True, merge_ledger_mode="siblings", **MERGE)
    assert_equal_runs(r, p)
    ledger = p[0]["merge_ledger"].values
    assert (ledger >= 0).any() and (ledger.max(axis=2) != ledger.min(axis=2)).any()  # partners differ


def test_run_tracking_labels_a_field_of_its_own(dense_fields):
    """A field that did not come from the area filter is labelled afresh
    (no reuse of the filter's roots) and gives the reference's events."""
    ev, mask = dense_fields
    kw = dict(MERGE, nn_partitioning=True)
    r_tr = ref.tracker(ev, mask, **kw)
    r_tr.use_scan_march = False
    r_ds, r_mg, r_n = r_tr.run_tracking(jnp.asarray(ev.values))
    p_tr = port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), device="cpu", **kw)
    p_ds, p_mg, p_n = p_tr.run_tracking(torch.from_numpy(np.array(ev.values)))
    assert p_n == r_n > 0
    assert "ccl" in p_tr.ccl_iterations
    for name in ("ID_field", "global_ID", "merge_ledger"):
        assert_same(r_ds[name].values, p_ds[name].values, name)
    assert_same(r_mg["parent_IDs"].values, p_mg["parent_IDs"].values, "parent_IDs")


def test_too_many_parents_raises_in_both():
    """Twelve small objects at t=0 inside one object at t=1: after the first
    object is dropped (the reference's quirk), the child has 11 parents."""
    T, H, W = 3, 16, 120
    data = np.zeros((T, H, W), bool)
    for i in range(12):
        data[0, 6:9, 4 + 9 * i : 8 + 9 * i] = True
    data[1:, 4:11, 2:114] = True
    ev, mask = bool_fields(data, np.ones((H, W), bool))
    kw = dict(R_fill=0, T_fill=0, area_filter_absolute=1, allow_merging=True, overlap_threshold=0.1, quiet=True)
    r_tr = ref.tracker(ev, mask, **kw)
    r_tr.use_scan_march = False
    with pytest.raises(ref.TrackingError) as r_err:
        r_tr.run()
    with pytest.raises(port.TrackingError) as p_err:
        port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), device="cpu", **kw).run()
    assert p_err.value.message == r_err.value.message
    assert "11 parents" in str(p_err.value)


def test_verify_drive_merge_matches():
    """The verify skill's standard drive, merging on, through both packages."""
    sst = drive_sst()
    kw = dict(R_fill=2, T_fill=2, area_filter_quartile=0.5, allow_merging=True, overlap_threshold=0.25, quiet=True)
    r_ds = ref.preprocess_data(sst, quiet=True, **DETECT_FIXED)
    r_tr = ref.tracker(r_ds["extreme_events"], r_ds["mask"], **kw)
    r_tr.use_scan_march = False
    r = r_tr.run(return_merges=True)
    p_ds = port.preprocess_data(from_reference(sst, "cpu"), device="cpu", quiet=True, **DETECT_FIXED)
    p = port.tracker(p_ds["extreme_events"], p_ds["mask"], device="cpu", **kw).run(return_merges=True)
    assert_equal_runs(r, p)
    assert p[0].attrs["N_events_final"] > 0


# -- building blocks ------------------------------------------------------


def test_union_find_native_and_plain_number_alike():
    rng = np.random.default_rng(0)
    nodes = np.unique(rng.integers(1, 5000, 800))
    edges = rng.choice(nodes, (600, 2))
    edges = np.concatenate([edges, [[1, 999999]]])  # an edge to an unknown node is ignored
    plain = port_native.union_find_plain(edges, nodes)
    assert port_native.has_native()
    np.testing.assert_array_equal(port_native.union_find(edges, nodes), plain)
    np.testing.assert_array_equal(ref_native.union_find(edges, nodes), plain)
    assert plain.max() + 1 < len(nodes)  # some components joined


def test_slice_labels_offsets_and_remap_match():
    data = blob_field(9, 8, 24, 64, 60, 5)
    r_roots, r_counts = ref_label.label_slices_grid_roots(jnp.asarray(data))
    L = int(np.asarray(r_counts).max())
    r_ids, r_areas = ref_label.extract_root_areas(r_roots, L)
    keep = (np.asarray(r_areas) >= 6) & (np.asarray(r_ids) != ref_label._BIG)
    r_kept = ref_label.apply_root_keep(r_roots, r_ids, jnp.asarray(keep))
    r_roots_f = jnp.where(r_kept, r_roots, ref_label._BIG)
    r_dense = ref_label.densify_slice_roots(r_roots_f, ref_label.extract_root_areas(r_roots_f, L)[0])
    p_roots = torch.from_numpy(np.array(r_roots))
    p_dense, p_counts = port_label.densify_slice_roots(p_roots, torch.from_numpy(np.array(r_ids)),
                                                       torch.from_numpy(keep))
    assert_same(r_dense, p_dense, "dense per-slice labels")
    np.testing.assert_array_equal(p_counts.numpy(), keep.sum(axis=1))
    assert_same(ref_label.densify_slices_sorted(r_roots_f)[0], p_dense, "dense vs the sorted branch")

    r_off = ref_label.offset_labels_across_time(r_dense, jnp.asarray(keep.sum(axis=1).astype(np.int32)))
    p_off = port_label.offset_labels(p_dense.clone(), p_counts)
    assert_same(r_off, p_off, "offset labels")
    lookup = np.random.default_rng(1).integers(0, 50, int(p_off.max()) + 1).astype(np.int32)
    assert_same(ref_label.remap_labels_donated(jnp.asarray(lookup), jnp.asarray(r_off)),
                port_label.remap_labels(torch.from_numpy(lookup), p_off.clone()), "remap")


def test_overlap_pairs_match():
    data = blob_field(10, 7, 24, 64, 80, 6)
    labels, counts = ref_label.label_slices_grid(jnp.asarray(data))
    labels = np.array(ref_label.offset_labels_across_time(labels, counts)).reshape(7, -1)
    stride = int(labels.max()) + 2
    pa, pb, pw = ref_overlap.consecutive_pairs_tiled(jnp.asarray(labels), jnp.ones(labels.shape[1]), 16, stride)
    assert (np.asarray(pa)[:, -1] < 0).all()  # no slot overflow
    valid = np.asarray(pa) >= 0
    t, a, b, w = port_overlap.consecutive_pairs(torch.from_numpy(labels), stride)
    np.testing.assert_array_equal(t.numpy(), np.nonzero(valid)[0])
    np.testing.assert_array_equal(a.numpy(), np.asarray(pa)[valid])
    np.testing.assert_array_equal(b.numpy(), np.asarray(pb)[valid])
    np.testing.assert_array_equal(w.numpy(), np.asarray(pw)[valid])
    sa, sb, sw = port_overlap.slice_pairs(torch.from_numpy(labels[3]), torch.from_numpy(labels[4]), stride)
    np.testing.assert_array_equal(np.stack([sa, sb, sw], 1), np.stack([a, b, w], 1)[t.numpy() == 3])


def test_merge_modules_leave_jax_out():
    code = ("import sys, marex_tpu_torch._native, marex_tpu_torch.ops.overlap, marex_tpu_torch.ops.partition, "
            "marex_tpu_torch.ops.properties; assert 'jax' not in sys.modules, 'jax imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
