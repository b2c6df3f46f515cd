"""Tracking stages of the PyTorch port against ``marex_tpu``, each stage fed
the reference's own input: morphology, per-slice CCL roots and statistics,
the area filter (both reference branches: <= 64 and > 64 objects per slice),
and the 3-D event ids (both reference branches: the fused fixpoint and the
two-level labelling)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu.ops import label as ref_label
from marex_tpu.ops import morphology as ref_morph
from marex_tpu_torch.core.field import from_reference
from marex_tpu_torch.ops import label as port_label
from marex_tpu_torch.ops import morphology as port_morph
from marex_tpu_torch.ops.min_stencil import BIG, hook_plain, min_stencil_plain, pointer_jump_plain, spacetime_min_plain

from .torch_parity import MESH_KW, assert_same, blob_field, bool_fields, mesh_fields, tri_mesh

# (T, H, W, n_blobs, r_max): at most 64 objects per slice, and more than 64
FEW = (10, 32, 48, 60, 5)
MANY = (6, 64, 128, 400, 1)


def _field(case, seed=1):
    return blob_field(seed, *case)


def _max_objects_per_slice(data):
    _, counts = ref_label.label_slices_grid_roots(jnp.asarray(data))
    return int(np.asarray(counts).max())


def test_cases_cover_both_reference_branches():
    assert _max_objects_per_slice(_field(FEW)) <= 64 < _max_objects_per_slice(_field(MANY))


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_close_open_grid_matches(radius):
    data = blob_field(4, 6, 20, 36, 40, 4)
    data |= np.random.default_rng(0).random(data.shape) < 0.15  # speckle: holes and specks to fill/open
    mask = np.ones(data.shape[1:], bool)
    mask[3:7, 5:12] = False
    r = ref_morph.binary_close_open_grid(jnp.asarray(data), radius, jnp.asarray(mask))
    p = port_morph.binary_close_open_grid(torch.from_numpy(data), radius, torch.from_numpy(mask))
    assert_same(r, p, f"close/open R={radius}")


@pytest.mark.parametrize("t_fill", [0, 2, 4])
def test_close_time_matches(t_fill):
    data = np.random.default_rng(t_fill).random((30, 5, 7)) < 0.4
    r = ref_morph.binary_close_time(jnp.asarray(data), t_fill)
    assert_same(r, port_morph.binary_close_time(torch.from_numpy(data), t_fill), f"close time {t_fill}")


@pytest.mark.parametrize("case", [FEW, MANY], ids=["le64", "gt64"])
def test_slice_roots_and_stats_match(case):
    data = _field(case)
    r_roots, r_counts = ref_label.label_slices_grid_roots(jnp.asarray(data))
    p_roots, p_counts, _ = port_label.label_slices_grid_roots(torch.from_numpy(data))
    assert_same(r_roots, p_roots, "roots")
    assert_same(r_counts, p_counts, "counts")
    L = int(np.asarray(r_counts).max())
    ids, areas, area_cell, counts = port_label.slice_root_stats(p_roots, L)
    e_ids, e_areas = ref_label.extract_root_areas(r_roots, L)
    assert_same(e_ids, ids, "root ids vs extract_root_areas")
    assert_same(e_areas, areas, "areas vs extract_root_areas")
    n_max = max(64, 1 << max(L - 1, 1).bit_length())
    s_ids, s_areas, s_cell, s_counts = ref_label.slice_root_stats_sorted(r_roots, n_max)
    ids, areas, area_cell, counts = port_label.slice_root_stats(p_roots, n_max)
    for name, a, b in [("ids", s_ids, ids), ("areas", s_areas, areas), ("area_cell", s_cell, area_cell),
                       ("counts", s_counts, counts)]:
        assert_same(a, b, f"{name} vs slice_root_stats_sorted")


def _trackers(data, monkeypatch, **kw):
    monkeypatch.setenv("MAREX_HOST_CCL", "0")  # the reference's device path, not its host C++ shortcut
    ev, mask = bool_fields(data, np.ones(data.shape[1:], bool))
    kw = dict(R_fill=1, T_fill=2, allow_merging=False, quiet=True, **kw)
    return ref.tracker(ev, mask, **kw), port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"),
                                                     device="cpu", **kw)


@pytest.mark.parametrize("case", [FEW, MANY], ids=["le64", "gt64"])
@pytest.mark.parametrize("area", [dict(area_filter_absolute=12), dict(area_filter_quartile=0.5)], ids=["abs", "quartile"])
def test_area_filter_with_drop_first_matches(case, area, monkeypatch):
    data = _field(case)
    r_tr, p_tr = _trackers(data, monkeypatch, **area)
    r_out, r_thr, r_areas, r_pre, r_post = r_tr.filter_small_objects(jnp.asarray(data))
    p_out, p_thr, p_areas, p_pre, p_post = p_tr.filter_small_objects(torch.from_numpy(data))
    assert_same(r_out, p_out, "filtered field")
    assert_same(r_areas, p_areas, "object areas")
    assert (p_thr, p_pre, p_post) == (r_thr, r_pre, r_post)
    # the drop-first quirk: every cell of the first object (smallest root of
    # the first non-empty slice) is cleared, whatever its area
    roots, counts, _ = port_label.label_slices_grid_roots(torch.from_numpy(data))
    first_t = int(torch.argmax((counts > 0).int()))
    first = roots[first_t] == roots[first_t].min()
    assert not bool(p_out.reshape(data.shape[0], -1)[first_t][first].any())


@pytest.mark.parametrize("two_level", [False, True], ids=["fused", "two_level"])
@pytest.mark.parametrize("case", [FEW, MANY], ids=["le64", "gt64"])
def test_event_ids_match(case, two_level, monkeypatch):
    data = _field(case, seed=2)
    if two_level:
        monkeypatch.setenv("MAREX_TWO_LEVEL_CCL", "1")
    r_tr, p_tr = _trackers(data, monkeypatch, area_filter_absolute=1)
    r_ds, _, r_n = r_tr.run_tracking(jnp.asarray(data))
    p_ds, _, p_n = p_tr.run_tracking(torch.from_numpy(data))
    assert p_n == r_n > 0
    assert_same(r_ds["ID_field"].values, p_ds["ID_field"].data, "ID_field")
    assert p_ds["ID_field"].dims == r_ds["ID_field"].dims


def test_spacetime_roots_match_reference():
    data = _field(FEW, seed=3)
    r_labf, r_n = ref_label.label_spacetime_roots(jnp.asarray(data))
    p_labf, iters = port_label.label_spacetime_roots(torch.from_numpy(data))
    assert_same(r_labf, p_labf, "3-D roots")
    assert iters >= 1
    dense, n = port_label.densify_spacetime_roots(p_labf)
    assert_same(ref_label.densify_spacetime_sorted(r_labf)[0], dense, "dense ids")
    assert n == int(r_n)


def test_chunked_bookkeeping_matches_one_chunk(monkeypatch):
    """Root statistics and the dense relabel give the same result when their
    int64 bookkeeping runs over many small chunks."""
    data = torch.from_numpy(_field(MANY, seed=4))
    roots, _, _ = port_label.label_slices_grid_roots(data)
    labf, _ = port_label.label_spacetime_roots(data)
    whole = port_label.slice_root_stats(roots), port_label.densify_spacetime_roots(labf)
    monkeypatch.setattr(port_label, "_CHUNK_CELLS", 1000)  # one slice per chunk; relabel chunks cut slices
    chunked = port_label.slice_root_stats(roots), port_label.densify_spacetime_roots(labf)
    for a, b in zip(whole[0] + whole[1][:1], chunked[0] + chunked[1][:1]):
        assert_same(a, b, "chunked")
    assert whole[1][1] == chunked[1][1]


def _unfused_iterations(data: torch.Tensor, depth3: bool) -> int:
    """The iteration count of the unfused fixpoint (stencil, hook, jump,
    then a full comparison of old and new labels), in plain PyTorch."""
    T, H, W = data.shape
    S = T * H * W if depth3 else H * W
    idx = torch.arange(S, dtype=torch.int32)
    lab = (idx if depth3 else idx.repeat(T)).view(T, H, W).masked_fill_(~data, BIG)
    for it in range(1, 100):
        m = spacetime_min_plain(lab, data) if depth3 else min_stencil_plain(lab, data)
        new = pointer_jump_plain(hook_plain(lab, m, S), S)
        if torch.equal(new, lab):
            return it
        lab = new
    raise AssertionError("no fixpoint")


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("case", [FEW, MANY], ids=["le64", "gt64"])
def test_fixpoint_iterations_equal_the_unfused_fixpoint(case, seed):
    """The flag ends the fused fixpoints at the unfused loop's iteration."""
    data = torch.from_numpy(_field(case, seed))
    assert port_label.label_slices_grid_roots(data)[2] == _unfused_iterations(data, False)
    assert port_label.label_spacetime_roots(data)[1] == _unfused_iterations(data, True)


def test_fixpoint_raises_when_it_does_not_converge(monkeypatch):
    monkeypatch.setattr(port_label, "MAX_ITERS_2D", 1)
    with pytest.raises(port.TrackingError, match="did not converge"):
        port_label.label_slices_grid_roots(torch.from_numpy(_field(FEW)))


@pytest.mark.parametrize(
    "kw, item",
    [
        (dict(merge_ledger_mode="bogus"), None),
        (dict(unstructured_grid=True), "runs"),
        (dict(regional_mode=True), "runs"),
        (dict(mesh=True), "item 11"),
        (dict(checkpoint="save"), "item 3"),
    ],
)
def test_unported_tracker_options_name_their_roadmap_item(kw, item, tmp_path):
    ev, mask = bool_fields(_field(FEW), np.ones(FEW[1:3], bool))
    args = dict(R_fill=1, area_filter_absolute=4, allow_merging=False, device="cpu")
    if item == "item 3":  # checkpoints are ported: a saving run gives the reference's events and its files
        r = ref.tracker(ev, mask, R_fill=1, area_filter_absolute=4, allow_merging=False, quiet=True).run()
        tr = port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), temp_dir=str(tmp_path), quiet=True,
                          **{**args, **kw})
        p = tr.run()
        assert_same(r["ID_field"].values, p["ID_field"].values, "ID_field")
        assert all(os.path.exists(path) for path in tr._checkpoint_paths())
        return
    if item is None:  # merging is ported: a bad ledger mode fails alike in both packages
        with pytest.raises(ref.ConfigurationError) as r:
            ref.tracker(ev, mask, R_fill=1, area_filter_absolute=4, **kw)
        with pytest.raises(port.ConfigurationError) as p:
            port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), **{**args, **kw})
        assert p.value.message == r.value.message
        return
    if item == "runs":  # ported: a mesh and a regional grid run, and give the reference's events
        extra = {}
        if "unstructured_grid" in kw:
            nb, lat, lon = tri_mesh(FEW[1] * FEW[2])
            ev, mask, nbf, ca = mesh_fields(_field(FEW).reshape(FEW[0], -1)[:, : len(lat)], lat, lon, nb,
                                            np.ones(len(lat), np.float32))
            kw = dict(MESH_KW, neighbours=nbf, cell_areas=ca)
            extra = dict(neighbours=from_reference(nbf, "cpu"), cell_areas=from_reference(ca, "cpu"))
        kw = dict(kw, coordinate_units="degrees", quiet=True)
        r = ref.tracker(ev, mask, R_fill=1, area_filter_absolute=4, allow_merging=False, **kw).run()
        p = port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), **{**args, **kw, **extra}).run()
        assert p.attrs["N_events_final"] == r.attrs["N_events_final"] > 0
        assert_same(r["ID_field"].values, p["ID_field"].values, "ID_field")
        return
    # item 11 (multi-device) is ported: mesh=True asks for a mesh of the run's
    # device, and without a card a CUDA run raises rather than running on the
    # CPU (the mesh runs are held in tests/test_torch_parallel*.py)
    with pytest.raises(port.DeviceError, match="CUDA"):
        port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), **{**args, **kw, "device": "cuda"})


def test_tracker_validation_errors_match():
    ev, mask = bool_fields(_field(FEW), np.ones(FEW[1:3], bool))
    pev, pmask = from_reference(ev, "cpu"), from_reference(mask, "cpu")
    for kw, err in [
        (dict(T_fill=3), "ConfigurationError"),
        (dict(area_filter_absolute=5, area_filter_quartile=0.5), "ConfigurationError"),
        (dict(area_filter_quartile=1.5), "ConfigurationError"),
        (dict(grid_resolution=-1.0), "DataValidationError"),
    ]:
        kw = dict(dict(R_fill=1, allow_merging=False, quiet=True), **kw)
        with pytest.raises(getattr(ref, err)) as r:
            ref.tracker(ev, mask, **kw)
        with pytest.raises(getattr(port, err)) as p:
            port.tracker(pev, pmask, device="cpu", **kw)
        assert p.value.message == r.value.message
