"""The port's CUDA kernels, its config-1 slice and its merge tracking on the
card: each kernel against its plain PyTorch version, and each path on CUDA
against the same path on the CPU. Every test needs a CUDA device (and
``nvcc`` to build the kernels) and skips without one.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; ``--noconftest`` keeps out ``tests/conftest.py``,
which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import marex_tpu_torch as port
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

from .torch_parity import merge_dense_field

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
