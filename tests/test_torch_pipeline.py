"""The whole config-1 slice through both packages on one input:
``preprocess_data(fixed_baseline, global_extreme)`` then
``tracker(allow_merging=False).run()``. Plus the import boundary: the port
never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu_torch import tracing
from marex_tpu_torch.core.field import from_reference

from .torch_parity import DETECT_FIXED, TRACK_SMALL, assert_close, assert_same, drive_sst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_port(sst, device):
    with tracing.collect():
        ds = port.preprocess_data(from_reference(sst, device), device=device, quiet=True, **DETECT_FIXED)
        tr = port.tracker(ds["extreme_events"], ds["mask"], device=device, quiet=True, **TRACK_SMALL)
        return ds, tr.run(), tr


@pytest.fixture(scope="module")
def both():
    sst = drive_sst()
    r_ds = ref.preprocess_data(sst, quiet=True, **DETECT_FIXED)
    r_ev = ref.tracker(r_ds["extreme_events"], r_ds["mask"], quiet=True, **TRACK_SMALL).run()
    p_ds, p_ev, p_tr = _run_port(sst, "cpu")
    return r_ds, r_ev, p_ds, p_ev, p_tr


def test_slice_outputs_match(both):
    r_ds, r_ev, p_ds, p_ev, _ = both
    assert_same(r_ds["extreme_events"].values, p_ds["extreme_events"].data, "extreme_events")
    assert_same(r_ds["mask"].values, p_ds["mask"].data, "mask")
    assert_close(r_ds["dat_anomaly"].values, p_ds["dat_anomaly"].data, what="dat_anomaly")
    assert_close(r_ds["thresholds"].values, p_ds["thresholds"].data, what="thresholds")
    assert_same(r_ev["ID_field"].values, p_ev["ID_field"].data, "ID_field")
    assert p_ev["ID_field"].dims == r_ev["ID_field"].dims


def test_slice_attrs_and_coords_match(both):
    r_ds, r_ev, p_ds, p_ev, _ = both
    assert p_ds.attrs == r_ds.attrs
    assert p_ev.attrs == r_ev.attrs
    assert p_ev.attrs["N_events_final"] > 0
    for name in ("time", "lat", "lon"):
        np.testing.assert_array_equal(p_ev.coords[name].values, r_ev.coords[name].values)


def test_stage_walls_and_iteration_counts_are_recorded(both):
    *_, p_tr = both
    assert set(p_tr.stage_walls) == {
        "fill_spatial", "fill_time", "filter_small", "filter/ccl_fixpoint", "filter/root_stats", "filter/apply", "ccl3d",
    }
    assert set(p_tr.ccl_iterations) == {"filter/ccl_fixpoint", "ccl3d"}
    assert min(p_tr.ccl_iterations.values()) >= 1


def test_import_leaves_jax_out():
    code = "import sys, marex_tpu_torch, marex_tpu_torch.ops.label; assert 'jax' not in sys.modules, 'jax imported'"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

