"""The port's CUDA kernels, its config-1 slice, its merge tracking, its mesh
tracking, its regional mode and its streamed paths on the card: each kernel
against its plain PyTorch version, each path on CUDA against the same path
on the CPU, streamed detect and tracking against their in-memory runs (and
on a one-rank NCCL mesh), and the entry module against the CPU.
Every test needs a CUDA device (and ``nvcc`` to build the kernels) and skips
without one.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; ``--noconftest`` keeps out ``tests/conftest.py``,
which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import marex_tpu_torch as port
from marex_tpu_torch import tracing
from marex_tpu_torch.ops import label as port_label
from marex_tpu_torch.ops.min_stencil import (
    BIG,
    ccl_step,
    ccl_step_plain,
    min_stencil,
    min_stencil_plain,
    pointer_jump,
    pointer_jump_plain,
    spacetime_min_plain,
)

from marex_tpu_torch.ops.graph_step import (
    active_cells,
    active_cells_plain,
    graph_jump,
    graph_jump_plain,
    graph_step,
    graph_step_active_plain,
    graph_step_plain,
    neighbour_min_plain,
)
from marex_tpu_torch.track import _symmetrize_neighbours

from .torch_parity import blob_field, merge_dense_field, mesh_merge_field, tri_mesh

DETECT_FIXED = dict(method_anomaly="fixed_baseline", method_extreme="global_extreme", threshold_percentile=95)
TRACK_SMALL = dict(R_fill=2, T_fill=2, area_filter_absolute=8, allow_merging=False)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the kernels")


def _drive_sst(seed=0, T=3 * 365, ny=24, nx=48):
    """The verify drive (daily AR(1) SST with a land block) as a port Field."""
    rng = np.random.default_rng(seed)
    sst = 15 + rng.standard_normal((T, ny, nx)).astype(np.float32)
    for k in range(1, T):
        sst[k] = 0.7 * sst[k - 1] + 0.4 * sst[k]
    sst[:, 3:6, 10:15] = np.nan
    coords = {
        "time": np.datetime64("2000-01-01", "ns") + np.arange(T) * np.timedelta64(1, "D"),
        "lat": np.linspace(-60, 60, ny),
        "lon": np.linspace(0, 360, nx, endpoint=False),
    }
    return port.Field(sst, ("time", "lat", "lon"), coords, name="sst")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 7, 13), (1, 1, 5), (2, 3, 1), (3, 720, 1440), (10, 1, 1), (1095, 720, 1440)])
def test_cuda_kernels_match_plain_versions(shape):
    """Bit for bit, over the stencil's modes, the fused step in both depths
    with ``wrap_x`` on and off and ``out`` BIG-filled or holding a stale
    field ``>= m`` (its flag too), and the jump per slice and over the block.
    (1095, 720, 1440) is the main path's shape (3 yr of daily 0.25 degree
    data)."""
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    T, H, W = shape
    data_d = torch.rand(shape, generator=g, device="cuda") < 0.5
    for depth3 in (False, True):
        S = T * H * W if depth3 else H * W
        lab_d = torch.randint(0, S, shape, generator=g, device="cuda", dtype=torch.int32)
        lab_d.masked_fill_(torch.rand(shape, generator=g, device="cuda") < 0.3, BIG)
        if not depth3:
            for masked in (True, False):
                for wrap_x in (True, False):
                    d = data_d if masked else None
                    got = min_stencil(lab_d, d, masked=masked, wrap_x=wrap_x)
                    assert torch.equal(got, min_stencil_plain(lab_d, d, masked=masked, wrap_x=wrap_x)), (masked, wrap_x)
                    del got
        for wrap_x in (True, False):
            for stale in (False, True):
                out = torch.full_like(lab_d, BIG)
                if stale:  # a field >= m, as the previous iteration's hooked field is
                    m = (spacetime_min_plain(lab_d, data_d, wrap_x) if depth3
                         else min_stencil_plain(lab_d, data_d, wrap_x=wrap_x))
                    up = torch.randint(0, 3, shape, generator=g, device="cuda", dtype=torch.int32)
                    out = torch.where(m >= BIG - 2, m, m + up)
                    del m, up
                want = out.clone()
                flag_want = ccl_step_plain(lab_d, data_d, want, depth3=depth3, wrap_x=wrap_x)
                flag = ccl_step(lab_d, data_d, out, depth3=depth3, wrap_x=wrap_x)
                assert torch.equal(out, want), (depth3, wrap_x, stale)
                assert bool(flag) == bool(flag_want), (depth3, wrap_x, stale)
                del out, want
        assert torch.equal(pointer_jump(lab_d, S), pointer_jump_plain(lab_d, S)), S
        del lab_d
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("depth3", [False, True])
def test_cuda_step_on_unaligned_tensors_matches_plain_version(depth3):
    """Tensors that start 4 bytes past a 16-byte boundary take the kernels'
    4-byte path even where W % 4 == 0."""
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    shape = (3, 9, 132)
    n = 3 * 9 * 132
    S = n if depth3 else 9 * 132

    def unaligned(t):
        spare = torch.empty(n + 1, dtype=t.dtype, device="cuda")
        return spare[1:].view(shape).copy_(t)

    data = unaligned(torch.rand(shape, generator=g, device="cuda") < 0.6)
    lab = unaligned(torch.randint(0, S, shape, generator=g, device="cuda", dtype=torch.int32))
    for wrap_x in (True, False):
        out, want = unaligned(torch.full(shape, BIG, dtype=torch.int32, device="cuda")), torch.full_like(lab, BIG)
        flag = ccl_step(lab, data, out, depth3=depth3, wrap_x=wrap_x)
        flag_want = ccl_step_plain(lab, data, want, depth3=depth3, wrap_x=wrap_x)
        assert torch.equal(out, want) and bool(flag) == bool(flag_want), wrap_x
        if not depth3:
            assert torch.equal(min_stencil(lab, data, wrap_x=wrap_x), min_stencil_plain(lab, data, wrap_x=wrap_x))


@pytest.mark.cuda
def test_ccl_fixpoints_on_cuda_match_cpu():
    """Both whole CCLs at 3 yr x 180 x 360, at the 8-connected percolation
    density: labels and iteration counts equal to the CPU's, and each
    step's flag equal to a full comparison of the labels."""
    _need_cuda()
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.random((3 * 365, 180, 360)) < 0.42)
    gpu = data.cuda()
    roots_c, counts_c, it2_c = port_label.label_slices_grid_roots(data)
    roots_g, counts_g, it2_g = port_label.label_slices_grid_roots(gpu)
    assert torch.equal(roots_g.cpu(), roots_c) and torch.equal(counts_g.cpu(), counts_c) and it2_g == it2_c
    labf_c, it3_c = port_label.label_spacetime_roots(data)
    labf_g, it3_g = port_label.label_spacetime_roots(gpu)
    assert torch.equal(labf_g.cpu(), labf_c) and it3_g == it3_c
    for depth3 in (False, True):
        T, H, W = gpu.shape
        S = T * H * W if depth3 else H * W
        idx = torch.arange(S, dtype=torch.int32, device="cuda")
        a = (idx if depth3 else idx.repeat(T)).view(T, H, W).masked_fill_(~gpu, BIG)
        b = torch.full_like(a, BIG)
        while True:
            changed = bool(ccl_step(a, gpu, b, depth3=depth3))
            new = pointer_jump(b, S)
            assert changed == (not torch.equal(new, a)), depth3
            if not changed:
                break
            a.copy_(new)


@pytest.mark.cuda
def test_slice_on_cuda_matches_cpu():
    _need_cuda()
    sst = _drive_sst()
    out = {}
    for device in ("cpu", "cuda"):
        ds = port.preprocess_data(sst, device=device, quiet=True, **DETECT_FIXED)
        ev = port.tracker(ds["extreme_events"], ds["mask"], device=device, quiet=True, **TRACK_SMALL).run()
        out[device] = ds, ev
    (c_ds, c_ev), (g_ds, g_ev) = out["cpu"], out["cuda"]
    for key in ("extreme_events", "mask"):
        assert np.array_equal(c_ds[key].values, g_ds[key].values), key
    assert np.array_equal(c_ev["ID_field"].values, g_ev["ID_field"].values)
    np.testing.assert_allclose(c_ds["dat_anomaly"].values, g_ds["dat_anomaly"].values, rtol=0, atol=1e-5)
    np.testing.assert_allclose(c_ds["thresholds"].values, g_ds["thresholds"].values, rtol=0, atol=1e-5)
    assert g_ev.attrs == c_ev.attrs and g_ev.attrs["N_events_final"] > 0


def _detect_on_both(sst, **kw):
    return {device: port.preprocess_data(sst, device=device, quiet=True, **kw) for device in ("cpu", "cuda")}


def _same(c, g, key):
    a, b = c[key].values, g[key].values
    assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), key


@pytest.mark.cuda
def test_config2_on_cuda_matches_cpu():
    """The reference default (shifting baseline, approximate Hobday
    thresholds with the 5 x 5 window), then the no-merge tracker:
    bit-identical on the card and the CPU."""
    _need_cuda()
    out = _detect_on_both(_drive_sst(), method_anomaly="shifting_baseline", window_year_baseline=2,
                          method_extreme="hobday_extreme")
    c, g = out["cpu"], out["cuda"]
    for key in ("dat_anomaly", "thresholds", "extreme_events", "mask"):
        _same(c, g, key)
    ev = {d: port.tracker(ds["extreme_events"], ds["mask"], device=d, quiet=True, **TRACK_SMALL).run()
          for d, ds in out.items()}
    assert np.array_equal(ev["cpu"]["ID_field"].values, ev["cuda"]["ID_field"].values)
    assert g.attrs == c.attrs and ev["cuda"].attrs == ev["cpu"].attrs and ev["cuda"].attrs["N_events_final"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("method_extreme", ["hobday_extreme", "global_extreme"])
def test_exact_percentile_on_cuda_matches_cpu(method_extreme):
    _need_cuda()
    out = _detect_on_both(_drive_sst(), method_anomaly="fixed_baseline", method_extreme=method_extreme,
                          method_percentile="exact")
    for key in ("thresholds", "extreme_events"):
        _same(out["cpu"], out["cuda"], key)


@pytest.mark.cuda
def test_detrend_std_normalise_on_cuda_matches_cpu():
    """Floats within 1e-5; the extremes may differ only where an anomaly lies
    within 1e-5 of its threshold (the float64 fit sums in another order)."""
    _need_cuda()
    out = _detect_on_both(_drive_sst(), method_anomaly="detrend_harmonic", std_normalise=True,
                          method_extreme="global_extreme")
    c, g = out["cpu"], out["cuda"]
    for key in ("dat_anomaly", "dat_stn", "STD", "thresholds", "thresholds_stn"):
        np.testing.assert_allclose(c[key].values, g[key].values, rtol=0, atol=1e-5, err_msg=key)
    for anom, ext, thr in (("dat_anomaly", "extreme_events", "thresholds"),
                           ("dat_stn", "extreme_events_stn", "thresholds_stn")):
        diff = c[ext].values != g[ext].values
        near = np.abs(c[anom].values - np.broadcast_to(c[thr].values, diff.shape))[diff]
        assert (near <= 1e-5).all(), (ext, int(diff.sum()))


@pytest.mark.cuda
def test_merge_on_cuda_matches_cpu():
    """Merge tracking (nearest-cell partitioning) on the merge-dense field:
    integer outputs and merge records bit-identical, area and centroid
    within 1e-5."""
    _need_cuda()
    data = merge_dense_field()
    T, H, W = data.shape
    coords = {
        "time": np.datetime64("2000-01-01", "ns") + np.arange(T) * np.timedelta64(1, "D"),
        "lat": np.linspace(-60, 60, H),
        "lon": np.linspace(0, 360, W, endpoint=False),
    }
    out = {}
    for device in ("cpu", "cuda"):
        ev = port.Field(torch.from_numpy(data).to(device), ("time", "lat", "lon"), coords, name="extreme_events")
        mask = port.Field(torch.ones((H, W), dtype=torch.bool, device=device), ("lat", "lon"),
                          {"lat": coords["lat"], "lon": coords["lon"]}, name="mask")
        tr = port.tracker(ev, mask, R_fill=2, T_fill=0, area_filter_quartile=0.0, allow_merging=True,
                          nn_partitioning=True, overlap_threshold=0.3, device=device, quiet=True)
        out[device] = tr.run(return_merges=True), tr
    (c_ev, c_mg), _ = out["cpu"]
    (g_ev, g_mg), g_tr = out["cuda"]
    for name in ("ID_field", "global_ID", "presence", "merge_ledger", "time_start", "time_end"):
        assert np.array_equal(c_ev[name].values, g_ev[name].values), name
    for name in ("area", "centroid"):
        np.testing.assert_allclose(c_ev[name].values, g_ev[name].values, rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("parent_IDs", "child_IDs", "overlap_areas", "merge_time", "n_parents", "n_children"):
        assert np.array_equal(c_mg[name].values, g_mg[name].values), name
    assert g_ev.attrs == c_ev.attrs and g_ev.attrs["total_merges"] > 0
    assert g_ev["ID_field"].data.is_cuda and g_tr.dispatch_counts["partition"] > 0


def _renumbered(table: np.ndarray, seed: int) -> np.ndarray:
    """``table`` with its cells renumbered by a seeded permutation (new
    cell j is old cell perm[j]): a mesh numbered unlike a lattice."""
    perm = np.random.default_rng(seed).permutation(table.shape[1])
    inv = np.argsort(perm)
    cols = table[:, perm]
    return np.ascontiguousarray(np.where(cols >= 0, inv[np.maximum(cols, 0)], -1), dtype=np.int32)


def _mesh_tables():
    rng = np.random.default_rng(1)
    directed = rng.integers(0, 30011, (3, 30011)).astype(np.int32)
    directed[rng.random(directed.shape) < 0.3] = -1
    icon = _symmetrize_neighbours(tri_mesh(1048576)[0] - 1)
    return {
        "tri_mesh": _symmetrize_neighbours(tri_mesh(4096)[0] - 1),
        "tri_mesh_as_given": tri_mesh(4096)[0] - 1,
        "random_directed_symmetrised": _symmetrize_neighbours(directed),
        "icon_like_1m": icon,
        "icon_like_1m_permuted": _renumbered(icon, 3),
    }


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name", ["tri_mesh", "tri_mesh_as_given", "random_directed_symmetrised", "icon_like_1m", "icon_like_1m_permuted"]
)
def test_cuda_graph_step_matches_plain_version(name):
    """Bit for bit: the list of active cells against ``nonzero``, the step
    over the list against its plain version and the dense step (``out`` and the flag, from a BIG-filled and
    a stale ``out >= m``), the jump over the list against its plain version
    and the whole-field jump; slice counts 1 and 11, and 67 on the 1M-cell
    tables (as numbered and renumbered); on the smaller tables the whole
    fixpoint equals the CPU's."""
    _need_cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    nb = torch.from_numpy(_mesh_tables()[name]).cuda()
    C = nb.shape[1]
    for T in (1, 11, 67) if C > 100000 else (1, 11):
        data = torch.rand((T, C), generator=g, device="cuda") < 0.5
        active = active_cells(data)
        flat = data.view(-1)
        for mask in (data, flat[1:], flat[: max(flat.numel() - 4099, 0)]):  # off 16-byte alignment, ragged tiles
            assert torch.equal(active_cells(mask), active_cells_plain(mask)), (name, T)
        lab = torch.randint(0, C, (T, C), generator=g, device="cuda", dtype=torch.int32)
        lab.masked_fill_(~data & (torch.rand((T, C), generator=g, device="cuda") < 0.5), BIG)
        m = neighbour_min_plain(lab, data, nb)
        up = torch.randint(0, 3, (T, C), generator=g, device="cuda", dtype=torch.int32)
        for out in (torch.full_like(lab, BIG), torch.where(m >= BIG - 2, m, m + up)):
            want, plain = out.clone(), out.clone()
            flag_want = graph_step_plain(lab, data, nb, want)
            flag_plain = graph_step_active_plain(lab, active, nb, plain)
            flag = graph_step(lab, active, nb, out)
            assert torch.equal(out, want) and bool(flag) == bool(flag_want), (name, T)
            assert torch.equal(out, plain) and bool(flag) == bool(flag_plain), (name, T)
        b = lab.masked_fill(~data, BIG)
        jumped = graph_jump(b, active, torch.full_like(b, BIG))
        assert torch.equal(jumped, pointer_jump_plain(b, C)), (name, T)
        assert torch.equal(jumped, graph_jump_plain(b, active, torch.full_like(b, BIG))), (name, T)
        if C < 100000:
            lab_g, counts_g, it_g = port_label.label_slices_unstructured(data, nb)
            lab_c, counts_c, it_c = port_label.label_slices_unstructured(data.cpu(), nb.cpu())
            assert torch.equal(lab_g.cpu(), lab_c) and torch.equal(counts_g.cpu(), counts_c) and it_g == it_c


@pytest.mark.cuda
def test_mesh_tracking_on_cuda_matches_cpu():
    """Merge tracking on the triangle-pair mesh with uneven cell areas:
    integer outputs and merge records bit-identical, area, centroid and the
    merges' overlap areas within 1e-5 (float64 sums in another order)."""
    _need_cuda()
    nb, lat, lon = tri_mesh(4096)
    areas = (1e3 * np.cos(np.deg2rad(lat)) * np.random.default_rng(0).uniform(0.8, 1.2, len(lat))).astype(np.float32)
    data = mesh_merge_field(lat, lon)
    sc = {"lat": ("ncells", lat), "lon": ("ncells", lon)}
    times = np.datetime64("2001-03-01", "ns") + np.arange(len(data)) * np.timedelta64(1, "D")
    out = {}
    for device in ("cpu", "cuda"):
        ev = port.Field(torch.from_numpy(data).to(device), ("time", "ncells"), {"time": times, **sc}, name="extreme_events")
        mask = port.Field(torch.ones(len(lat), dtype=torch.bool, device=device), ("ncells",), sc, name="mask")
        tr = port.tracker(ev, mask, R_fill=1, T_fill=2, area_filter_quartile=0.1, allow_merging=True, nn_partitioning=True,
                          overlap_threshold=0.25, unstructured_grid=True, coordinate_units="degrees",
                          dimensions={"x": "ncells"}, coordinates={"x": "lon", "y": "lat"}, neighbours=nb,
                          cell_areas=areas, device=device, quiet=True)
        out[device] = tr.run(return_merges=True), tr
    (c_ev, c_mg), c_tr = out["cpu"]
    (g_ev, g_mg), g_tr = out["cuda"]
    for name in ("ID_field", "global_ID", "presence", "merge_ledger", "time_start", "time_end"):
        assert np.array_equal(c_ev[name].values, g_ev[name].values), name
    for name in ("area", "centroid"):
        np.testing.assert_allclose(c_ev[name].values, g_ev[name].values, rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("parent_IDs", "child_IDs", "merge_time", "n_parents", "n_children"):
        assert np.array_equal(c_mg[name].values, g_mg[name].values), name
    np.testing.assert_allclose(c_mg["overlap_areas"].values, g_mg["overlap_areas"].values, rtol=1e-5)
    assert g_ev.attrs["total_merges"] == c_ev.attrs["total_merges"] > 0
    assert g_tr.ccl_iterations == c_tr.ccl_iterations and g_tr.dispatch_counts["partition"] > 0
    assert g_ev["ID_field"].data.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("merge", [False, True], ids=["no_merge", "merge"])
def test_regional_tracking_on_cuda_matches_cpu(merge):
    """``regional_tracker`` (no seam in longitude: the kernels' ``wrap_x=0``
    branch on a real path) on the card and on the CPU."""
    _need_cuda()
    data = merge_dense_field(T=40, n_pairs=3, seed=2, ny=24, nx=48) if merge else blob_field(3, 30, 24, 48, 80, 5)
    T, H, W = data.shape
    coords = {
        "time": np.datetime64("2000-01-01", "ns") + np.arange(T) * np.timedelta64(1, "D"),
        "lat": np.linspace(30.0, 70.0, H),
        "lon": np.linspace(-30.0, 40.0, W),
    }
    kw = dict(R_fill=1, T_fill=2, area_filter_absolute=6, allow_merging=merge, quiet=True)
    if merge:
        kw.update(nn_partitioning=True, overlap_threshold=0.25)
    out = {}
    for device in ("cpu", "cuda"):
        ev = port.Field(torch.from_numpy(data).to(device), ("time", "lat", "lon"), coords, name="extreme_events")
        mask = port.Field(torch.ones((H, W), dtype=torch.bool, device=device), ("lat", "lon"),
                          {"lat": coords["lat"], "lon": coords["lon"]}, name="mask")
        out[device] = port.regional_tracker(ev, mask, "degrees", device=device, **kw).run()
    c, g = out["cpu"], out["cuda"]
    names = ("ID_field", "global_ID", "presence", "merge_ledger") if merge else ("ID_field",)
    for name in names:
        assert np.array_equal(c[name].values, g[name].values), name
    assert g.attrs == c.attrs and g.attrs["N_events_final"] > 0
    if merge:
        assert g.attrs["total_merges"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["grid", "mesh"])
def test_streamed_tracking_on_cuda_matches_in_memory(tmp_path, grid):
    """``run_streamed`` on the card, from a lazy zarr store in blocks of 13
    days, against ``run()`` on the card and against the CPU's streamed run:
    integer outputs and merge records bit-identical, area and centroid within
    1e-5."""
    _need_cuda()
    from marex_tpu_torch.io import zarr_lite

    if grid == "grid":
        data = merge_dense_field()
        T, H, W = data.shape
        dims, sshape = ("time", "lat", "lon"), (H, W)
        sc = {"lat": np.linspace(-60, 60, H), "lon": np.linspace(0, 360, W, endpoint=False)}
        kw = dict(R_fill=2, T_fill=2, area_filter_quartile=0.0, allow_merging=True, nn_partitioning=True,
                  overlap_threshold=0.3)
    else:
        nb, lat, lon = tri_mesh(4096)
        data = mesh_merge_field(lat, lon, T=40)
        T = len(data)
        dims, sshape = ("time", "ncells"), (len(lat),)
        sc = {"lat": ("ncells", lat), "lon": ("ncells", lon)}
        kw = dict(R_fill=1, T_fill=2, area_filter_quartile=0.1, allow_merging=True, nn_partitioning=True,
                  overlap_threshold=0.25, unstructured_grid=True, coordinate_units="degrees", dimensions={"x": "ncells"},
                  coordinates={"x": "lon", "y": "lat"}, neighbours=nb, cell_areas=np.full(len(lat), 1e3, np.float32))
    times = np.datetime64("2000-01-01", "ns") + np.arange(T) * np.timedelta64(1, "D")
    ev = port.Field(data, dims, {"time": times, **sc}, name="extreme_events")
    mask = port.Field(np.ones(sshape, bool), dims[1:], sc, name="mask")
    src = str(tmp_path / "extremes.zarr")
    zarr_lite.to_zarr(ev, src, chunks={"time": 10})
    runs = {"memory": port.tracker(ev, mask, device="cuda", quiet=True, **kw).run(return_merges=True)}
    for device in ("cuda", "cpu"):
        tr = port.tracker(zarr_lite.open_zarr(src, lazy=True)["extreme_events"], mask, device=device,
                          temp_dir=str(tmp_path / device), quiet=True, **kw)
        runs[device] = tr.run_streamed(str(tmp_path / f"events_{device}.zarr"), block_T=13, return_merges=True)
        assert tr.dispatch_counts["march_block"] >= 3 and tr.device.type == device
    (m_ev, m_mg) = runs["memory"]
    for other in ("cuda", "cpu"):
        s_ev, s_mg = runs[other]
        for name in ("ID_field", "global_ID", "presence", "merge_ledger", "time_start", "time_end"):
            assert np.array_equal(m_ev[name].values, np.asarray(s_ev[name].values)), (other, name)
        for name in ("area", "centroid"):
            np.testing.assert_allclose(m_ev[name].values, np.asarray(s_ev[name].values), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{other} {name}")
        for name in ("parent_IDs", "child_IDs", "merge_time", "n_parents", "n_children"):
            assert np.array_equal(m_mg[name].values, s_mg[name].values), (other, name)
        assert s_ev.attrs["total_merges"] == m_ev.attrs["total_merges"] > 0
        assert s_ev.attrs["N_events_final"] == m_ev.attrs["N_events_final"]


@pytest.mark.cuda
def test_streamed_detect_on_cuda_matches_in_memory(tmp_path):
    """``preprocess_data_streamed`` on the card (tiles uploaded from pinned
    buffers on a copy stream) against ``preprocess_data`` on the card, bit
    for bit: config 1's detect and config 2's (shifting baseline, Hobday
    thresholds with the spatial window across the tile seams)."""
    _need_cuda()
    sst = _drive_sst()
    config2 = dict(method_anomaly="shifting_baseline", method_extreme="hobday_extreme", window_year_baseline=2)
    for i, kw in enumerate((DETECT_FIXED, config2)):
        mem = port.preprocess_data(sst, device="cuda", quiet=True, **kw)
        s = port.preprocess_data_streamed(sst, str(tmp_path / f"out{i}.zarr"), row_block=7, device="cuda", **kw)
        assert s.attrs["stream_n_tiles"] == 4
        for name in ("dat_anomaly", "extreme_events", "thresholds", "mask"):
            a, b = mem[name].values, np.asarray(s[name].values)
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (i, name)


@pytest.mark.cuda
@pytest.mark.parametrize("regional", [False, True], ids=["global", "regional"])
def test_two_level_labelling_on_cuda_matches_fused(monkeypatch, regional):
    """No-merge tracking with the two-level route forced (the cutover
    lowered) equals the fused route on the card, and the CPU's."""
    import marex_tpu_torch.track as ptrack

    _need_cuda()
    data = blob_field(3, 60, 40, 72, 120, 5)
    lon = np.linspace(-30.0, 40.0, 72) if regional else np.linspace(0, 360, 72, endpoint=False)
    coords = {"time": np.datetime64("2000-01-01", "ns") + np.arange(60) * np.timedelta64(1, "D"),
              "lat": np.linspace(-60, 60, 40), "lon": lon}
    ev = port.Field(data, ("time", "lat", "lon"), coords, name="extreme_events")
    mask = port.Field(np.ones((40, 72), bool), ("lat", "lon"), {"lat": coords["lat"], "lon": lon}, name="mask")
    kw = dict(TRACK_SMALL, regional_mode=regional, coordinate_units="degrees" if regional else None, quiet=True)
    fused = port.tracker(ev, mask, device="cuda", **kw).run()
    monkeypatch.setattr(ptrack, "TWO_LEVEL_CELLS", 1)
    runs = {d: port.tracker(ev, mask, device=d, **kw) for d in ("cuda", "cpu")}
    with tracing.collect():
        out = {d: tr.run() for d, tr in runs.items()}
    assert "ccl3d/edges" in runs["cuda"].stage_walls
    assert fused.attrs["N_events_final"] > 1
    for d in ("cuda", "cpu"):
        assert np.array_equal(out[d]["ID_field"].values, fused["ID_field"].values), d
        assert out[d].attrs == fused.attrs, d


@pytest.mark.cuda
def test_field_reductions_on_cuda_match_cpu():
    """``Field`` reductions and operators on a CUDA payload stay on the card
    and equal the CPU's: integers and bools exactly, floats within 1e-5."""
    _need_cuda()
    sst = _drive_sst(T=400)
    g = sst.to("cuda")
    c = sst.to("cpu")
    cases = [lambda f: f.sum("time", skipna=True), lambda f: f.mean(("lat", "lon")), lambda f: f.std("time"),
             lambda f: f.max(), lambda f: f.quantile(0.95, "time"), lambda f: f.count("time"),
             lambda f: (f > 15.0).sum(), lambda f: f.where(f > 15.0, 0.0) * 2.0, lambda f: f.argmax("time")]
    for i, fn in enumerate(cases):
        a, b = fn(g), fn(c)
        assert a.data.device.type == "cuda" and a.dims == b.dims, i
        x, y = a.values, b.values
        assert x.dtype == y.dtype, i
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6, equal_nan=True, err_msg=str(i))
        else:
            assert np.array_equal(x, y), i


@pytest.mark.cuda
def test_check_device_health_on_the_card():
    _need_cuda()
    report = port.check_device_health()
    assert report["ok"] and len(report["devices"]) == torch.cuda.device_count() >= 1
    assert all(d["ok"] for d in report["devices"])


@pytest.mark.cuda
def test_plot_preparation_on_cuda_matches_cpu():
    """plotX's preparation on CUDA payloads: the NaN-ignoring maximum (of the
    field and of its ``where(> 0)`` view), the robust limits of every tenth
    slice and the frames' host arrays, bit for bit against the same on the
    CPU copies and against numpy; only scalars and one slice come back."""
    _need_cuda()
    from marex_tpu_torch.plotX import prep

    rng = np.random.default_rng(4)
    shape = (45, 30, 50)
    anom = rng.standard_normal(shape).astype(np.float32)
    anom[:, 3:7, 5:9] = np.nan
    ids = np.where(rng.random(shape) < 0.3, rng.integers(1, 100, shape), 0).astype(np.int32)
    for host in (anom, ids):
        dev = torch.from_numpy(host).cuda()
        cpu = torch.from_numpy(host.copy())
        for view in (lambda x: x, prep.PositiveOnly):
            got, want = prep.nanmax(view(dev)), prep.nanmax(view(cpu))
            assert type(got) is type(want) and got.tobytes() == want.tobytes()
        assert prep.nanmax(dev) == np.nanmax(host)
        sample = host[::10]
        for issym in (True, False):
            prep.pull.bytes = 0
            got = prep.robust_limits(dev, issym, [4, 96], axis=0)
            assert prep.pull.bytes <= 16
            assert got == prep.robust_limits(cpu, issym, [4, 96], axis=0)
            lo, hi = np.percentile(sample[np.isfinite(sample)], [4, 96])
            m = max(abs(lo), abs(hi))
            assert np.asarray(got).tobytes() == np.asarray((-m, m) if issym else (float(lo), float(hi))).tobytes()
        field = port.Field(dev, ("time", "lat", "lon"), name="f")
        for t in (0, 22, 44):
            prep.pull.bytes = 0
            frame = prep.host_frame(field._replace(data=prep.PositiveOnly(dev)), "time", t)
            assert prep.pull.bytes == host[t].nbytes and isinstance(frame.data, np.ndarray)
            assert np.array_equal(frame.data, np.where(host[t] > 0, host[t], np.nan), equal_nan=True)
            assert np.array_equal(prep.host_frame(field, "time", t).data, host[t], equal_nan=True)


NCCL_CHILD = r"""
import os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import marex_tpu_torch as port
from tests.test_torch_cuda import _drive_sst

port.start_distributed_cluster()  # torchrun's variables: a world of one NCCL rank
sst = _drive_sst()
detect = dict(method_anomaly="fixed_baseline", method_extreme="global_extreme", threshold_percentile=95)
track = dict(R_fill=2, T_fill=2, area_filter_absolute=8, allow_merging=True, nn_partitioning=True,
             overlap_threshold=0.25, quiet=True)
runs = []
for mesh in (None, True):
    ds = port.preprocess_data(sst, mesh=mesh, quiet=True, **detect)
    ev, mg = port.tracker(ds["extreme_events"], ds["mask"], mesh=mesh, **track).run(return_merges=True)
    runs.append((ds, ev, mg))
(ds1, ev1, mg1), (dsm, evm, mgm) = runs
assert type(dsm["extreme_events"].data).__name__ == "DTensor" and type(evm["ID_field"].data).__name__ == "DTensor"
for a, b in ((ds1, dsm), (ev1, evm), (mg1, mgm)):
    for v in a.data_vars:
        x, y = a[v].values, b[v].values
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), v
assert ev1.attrs == evm.attrs and ev1.attrs["N_events_final"] > 0
print("NCCL WORLD OK", ev1.attrs["N_events_final"], ev1.attrs["total_merges"])
"""


@pytest.mark.cuda
def test_one_rank_nccl_world_matches_one_process(tmp_path):
    """Config 4 at the drive's size on a mesh of one NCCL rank (started with
    ``torchrun``'s variables, in a child process) against the same run without
    a mesh: every output bit for bit, the split ones DTensors."""
    _need_cuda()
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port_no)}
    child = subprocess.Popen([sys.executable, "-c", NCCL_CHILD, repo], cwd=repo, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
    try:
        out, _ = child.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        child.kill()
        pytest.fail("the one-rank NCCL world hung")
    out = out.decode(errors="replace")
    assert child.returncode == 0 and "NCCL WORLD OK" in out, out[-4000:]


@pytest.mark.cuda
def test_entry_on_cuda_matches_cpu():
    """``marex_tpu_torch.entry``: ``entry()``'s tensors on the card, and its
    step's labels and event count bit for bit the CPU's, the anomalies within
    1e-5."""
    _need_cuda()
    from marex_tpu_torch.entry import entry

    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    anom, lab, n = fn(*args)
    fn_c, args_c = entry(device="cpu")
    anom_c, lab_c, n_c = fn_c(*args_c)
    assert n == n_c > 0 and torch.equal(lab.cpu(), lab_c)
    assert float((anom.cpu() - anom_c).abs().max()) <= 1e-5


STREAMED_NCCL_CHILD = r"""
import os, sys, tempfile
import numpy as np
sys.path.insert(0, sys.argv[1])
import marex_tpu_torch as port
from marex_tpu_torch.io import zarr_lite
from tests.torch_parity import merge_dense_field

port.start_distributed_cluster()  # torchrun's variables: a world of one NCCL rank
data = merge_dense_field()
T, H, W = data.shape
coords = {"time": np.arange(T).astype("datetime64[D]").astype("datetime64[ns]"), "lat": np.linspace(-60, 60, H),
          "lon": np.linspace(0, 360, W, endpoint=False)}
mask = port.Field(np.ones((H, W), bool), ("lat", "lon"), {"lat": coords["lat"], "lon": coords["lon"]}, name="mask")
work = tempfile.mkdtemp()
zarr_lite.to_zarr(port.Field(data, ("time", "lat", "lon"), coords, name="extreme_events"), f"{work}/src.zarr",
                  chunks={"time": 10})
track = dict(R_fill=2, T_fill=0, area_filter_quartile=0.0, allow_merging=True, overlap_threshold=0.3, quiet=True)
runs = []
for mesh in (None, True):
    lazy = zarr_lite.open_zarr(f"{work}/src.zarr", lazy=True)["extreme_events"]
    runs.append(port.tracker(lazy, mask, mesh=mesh, **track).run_streamed(f"{work}/out{mesh}.zarr", block_T=13,
                                                                          return_merges=True))
for a, b in zip(*runs):
    for v in a.data_vars:
        x, y = np.asarray(a[v].values), np.asarray(b[v].values)
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), v
assert runs[0][0].attrs == runs[1][0].attrs and runs[0][0].attrs["total_merges"] > 0
print("STREAMED MESH OK", runs[0][0].attrs["N_events_final"], runs[0][0].attrs["total_merges"])
"""


@pytest.mark.cuda
def test_streamed_tracking_on_a_one_rank_nccl_mesh(tmp_path):
    """``run_streamed`` on a mesh of one NCCL rank (in a child process started
    with ``torchrun``'s variables) against the same run without a mesh: every
    output and attr bit for bit."""
    _need_cuda()
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port_no), "TMPDIR": str(tmp_path)}
    child = subprocess.Popen([sys.executable, "-c", STREAMED_NCCL_CHILD, repo], cwd=repo, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        out, _ = child.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        child.kill()
        pytest.fail("the one-rank NCCL world hung")
    out = out.decode(errors="replace")
    assert child.returncode == 0 and "STREAMED MESH OK" in out, out[-4000:]


@pytest.mark.cuda
def test_tracer_counts_each_host_sync_on_cuda():
    """A span that makes N ``.item()`` calls counts N ``host_syncs``; the
    tracer's own synchronise at a span's end counts none."""
    _need_cuda()
    x = torch.arange(16, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    with tracing.collect() as rec:
        with tracing.span("items"):
            got = [x[i].item() for i in range(7)]
        with tracing.span("no_sync"):
            y = x * 2
    assert got == list(range(7)) and y.shape == x.shape
    assert rec.spans["items"].host_syncs == 7 and rec.spans["no_sync"].host_syncs == 0
    assert rec.counters["host_syncs"] == 7
    assert torch.cuda.get_sync_debug_mode() == 0  # the block's debug mode is undone


@pytest.mark.cuda
def test_tracer_own_peaks_on_cuda():
    """Own peaks of nested spans on a hand-made allocation pattern: a child's
    peak shows in its parent, a later sibling's does not carry the earlier
    one's, and the block's peak is the largest."""
    _need_cuda()
    torch.cuda.synchronize()
    mib = 1 << 20
    base = torch.cuda.memory_allocated()
    with tracing.collect() as rec:
        keep = torch.empty(64 * mib, dtype=torch.uint8, device="cuda")
        with tracing.span("a"):
            with tracing.span("a/b"):
                t = torch.empty(256 * mib, dtype=torch.uint8, device="cuda")
                del t
            with tracing.span("a/c"):
                t = torch.empty(32 * mib, dtype=torch.uint8, device="cuda")
                del t
        with tracing.span("d"):
            pass
        del keep
    own = {n: s.peak_bytes for n, s in rec.spans.items()}
    assert own == {"a": base + 320 * mib, "a/b": base + 320 * mib, "a/c": base + 96 * mib, "d": base + 64 * mib}
    assert rec.peak_bytes == base + 320 * mib
