"""Preprocessing checkpoints of the port's tracker, and the attributes it
keeps: 'save' then 'load' equals the direct run (on a new tracker and on
the same one, whose filter-root cache must not carry over), 'auto' computes
and saves once and loads after, configurations get distinct paths, a
missing checkpoint raises ``TrackingError``, and a checkpoint written by
``marex_tpu`` loads in the port (the file names and the stores are the
same)."""

import inspect
import os

import numpy as np
import pytest
import torch

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu_torch.core.field import from_reference

from .torch_parity import assert_same, bool_fields, merge_dense_field, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(R_fill=2, T_fill=2, area_filter_quartile=0.5, allow_merging=True, nn_partitioning=True,
          overlap_threshold=0.3, quiet=True)


@pytest.fixture(scope="module")
def fields():
    ev, mask = bool_fields(merge_dense_field(T=30, n_pairs=3, ny=32, nx=96), np.ones((32, 96), bool))
    return from_reference(ev, "cpu"), from_reference(mask, "cpu"), ev, mask


@pytest.fixture(scope="module")
def direct(fields):
    ev, mask, _, _ = fields
    return port.tracker(ev, mask, device="cpu", **KW).run(return_merges=True)


def _assert_same_run(a, b):
    (ea, ma), (eb, mb) = a, b
    for name in ("ID_field", "global_ID", "presence", "merge_ledger", "time_start", "time_end", "area", "centroid"):
        va, vb = np.asarray(ea[name].values), np.asarray(eb[name].values)
        assert va.dtype == vb.dtype and np.array_equal(va, vb, equal_nan=va.dtype.kind == "f"), name
    for name in ma.data_vars:
        assert_same(ma[name].values, mb[name].values, name)
    assert ea.attrs == eb.attrs


def test_save_then_load_equals_the_direct_run(tmp_path, fields, direct):
    ev, mask, _, _ = fields
    d = str(tmp_path)
    saved = port.tracker(ev, mask, device="cpu", temp_dir=d, checkpoint="save", **KW).run(return_merges=True)
    _assert_same_run(saved, direct)
    bin_path, stats_path = port.tracker(ev, mask, device="cpu", temp_dir=d, **KW)._checkpoint_paths()
    assert os.path.isdir(bin_path) and os.path.isfile(stats_path)
    loader = port.tracker(ev, mask, device="cpu", temp_dir=d, checkpoint="load", **KW)
    data, stats = loader.run_preprocess()
    assert isinstance(data, torch.Tensor) and data.dtype == torch.bool and data.device == loader.device
    assert [type(x) for x in stats] == [float, int, int, float, float, float]
    _assert_same_run(loader.run(return_merges=True), direct)


def test_load_on_the_same_tracker_labels_afresh(tmp_path, fields, direct):
    """run(checkpoint='save') leaves the area filter's roots cached for the
    field it made; the loaded field is another tensor, so the march labels it
    afresh, and the result is the direct run's."""
    ev, mask, _, _ = fields
    tr = port.tracker(ev, mask, device="cpu", temp_dir=str(tmp_path), **KW)
    _assert_same_run(tr.run(return_merges=True, checkpoint="save"), direct)
    filtered, _ = tr.run_preprocess(checkpoint="save")
    assert tr._label_reuse is not None and tr._label_reuse[0]() is filtered
    _assert_same_run(tr.run(return_merges=True, checkpoint="load"), direct)


def test_auto_computes_once_then_resumes(tmp_path, fields, direct, monkeypatch):
    ev, mask, _, _ = fields
    tr = port.tracker(ev, mask, device="cpu", temp_dir=str(tmp_path), checkpoint="auto", **KW)
    assert not any(os.path.exists(p) for p in tr._checkpoint_paths())
    _assert_same_run(tr.run(return_merges=True), direct)
    assert all(os.path.exists(p) for p in tr._checkpoint_paths())

    def no_fill(*a, **k):
        raise AssertionError("auto recomputed instead of loading its checkpoint")

    resumed = port.tracker(ev, mask, device="cpu", temp_dir=str(tmp_path), checkpoint="auto", **KW)
    monkeypatch.setattr(resumed, "fill_holes", no_fill)
    _assert_same_run(resumed.run(return_merges=True), direct)


def test_configurations_get_distinct_paths_and_missing_raises(tmp_path, fields):
    ev, mask, _, _ = fields
    d = str(tmp_path)
    paths = {
        port.tracker(ev, mask, device="cpu", temp_dir=d, **dict(KW, **kw))._checkpoint_paths()
        for kw in ({}, {"R_fill": 3}, {"T_fill": 4}, {"area_filter_quartile": 0.25})
    }
    assert len(paths) == 4
    # a store with another time length is another configuration too
    short = port.tracker(ev.isel(time=np.arange(20)), mask, device="cpu", temp_dir=d, **KW)
    assert short._checkpoint_paths() not in paths
    with pytest.raises(port.TrackingError, match="No preprocessing checkpoint"):
        port.tracker(ev, mask, device="cpu", temp_dir=d, checkpoint="load", **KW).run()


def test_reference_checkpoint_loads_in_the_port(tmp_path, fields, direct):
    _, _, r_ev, r_mask = fields
    d = str(tmp_path)
    r_tr = ref.tracker(r_ev, r_mask, temp_dir=d, checkpoint="save", **KW)
    r_tr.use_scan_march = False
    r_tr.run()
    p_tr = port.tracker(from_reference(r_ev, "cpu"), from_reference(r_mask, "cpu"), device="cpu", temp_dir=d,
                        checkpoint="load", **KW)
    assert p_tr._checkpoint_paths() == r_tr._checkpoint_paths()
    _assert_same_run(p_tr.run(return_merges=True), direct)


def test_tracker_keeps_its_arguments(tmp_path, fields):
    ev, mask, _, _ = fields
    tr = port.tracker(ev, mask, device="cpu", temp_dir=str(tmp_path), max_iteration=7, debug=2, checkpoint="auto",
                      **KW)
    assert (tr.temp_dir, tr.max_iteration, tr.debug, tr.checkpoint, tr.mesh) == (str(tmp_path), 7, 2, "auto", None)
    default = port.tracker(ev, mask, device="cpu", **KW)
    assert (default.temp_dir, default.max_iteration, default.debug, default.checkpoint) == (None, 40, 0, None)
    with pytest.raises(port.DeviceError, match="CUDA"):  # a mesh of the run's device, never the CPU in its place
        port.tracker(ev, mask, device="cuda", mesh=True, **KW)
    assert list(inspect.signature(port.tracker._validate_inputs).parameters) == list(
        inspect.signature(ref.tracker._validate_inputs).parameters
    )
