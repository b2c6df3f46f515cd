"""``tracker.run_streamed`` under a mesh, and the port's own host library
source.

The streamed tracker runs in one process whatever the mesh, as
``marex_tpu``'s does: the mesh's first rank runs it and alone writes the
store, the others wait, and every rank returns the same events. Worlds of one
and two ``gloo`` ranks (``tests/torch_parallel_worker.py``) run it from a lazy
store and, on the mesh, from a DTensor split over time; each is held bit for
bit against the run without a mesh, and against ``marex_tpu``'s tracker. An
error met on the first rank is raised on every rank.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import pytest

import marex_tpu as ref

from . import torch_parallel_worker as W
from .torch_parallel_harness import assert_mesh_equals_single, assert_track_same, finish_world, load_run, start_world

SCENARIOS = ["streamed", "streamed_dtensor"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Worlds of one and two ranks, run side by side on the merging disks."""
    tmp = tmp_path_factory.mktemp("stream_mesh")
    np.savez(tmp / "inputs.npz", disks=W.merging_disks())
    started = {n: start_world(tmp, n, 1, SCENARIOS + ["errors"]) for n in (1, 2)}
    return {n: finish_world(s) for n, s in started.items()}


def runtime(outdir: str, rank: int) -> dict:
    with open(os.path.join(outdir, f"runtime.{rank}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("name", SCENARIOS)
def test_streamed_on_a_mesh_equals_one_process(worlds, world, name):
    outdir = worlds[world]
    assert_mesh_equals_single(outdir, name, world)
    _, attrs = load_run(outdir, name, 0)
    assert attrs["mesh/0"]["total_merges"] > 0
    # every rank's events are backed by the one store the first rank wrote
    assert "LazyZarrArray" in attrs["mesh/types"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_only_the_first_rank_writes(worlds, name):
    outdir = worlds[2]
    first, other = (runtime(outdir, r)["stream_writes"] for r in (0, 1))
    assert first[f"{name}_mesh"] > 0 and other[f"{name}_mesh"] == 0
    # without a mesh each rank runs and writes its own store
    assert first[f"{name}_single"] == other[f"{name}_single"] == first[f"{name}_mesh"]
    assert (pathlib.Path(outdir) / f"{name}_mesh.zarr" / "ID_field").is_dir()


def test_streamed_on_a_mesh_matches_reference(worlds):
    """The two-rank world's events against ``marex_tpu``'s tracker (the
    per-step march) on the same field."""
    arrays, attrs = load_run(worlds[2], "streamed", 1)
    data = W.merging_disks()
    ev = W._grid_field(ref, data, "extreme_events")
    tr = ref.tracker(ev, W._mask(ref, *data.shape[1:]), **W.TRACK_REALMERGE, quiet=True)
    tr.use_scan_march = False
    r_ev, r_mg = tr.run(return_merges=True)
    assert_track_same(r_ev, r_mg, arrays, attrs["mesh/0"], "mesh/0/", "mesh/1/", on_mesh=False)


@pytest.mark.parametrize("world", [1, 2])
def test_an_error_on_the_first_rank_reaches_every_rank(worlds, world):
    """A no-merge tracker is refused by the streamed tracker, which runs on
    the first rank only: every rank raises it, as one process does."""
    for rank in range(world):
        errors = runtime(worlds[world], rank)["errors"]
        assert errors["streamed_nomerge/single"][0] == "ConfigurationError"
        assert errors["streamed_nomerge/mesh"] == errors["streamed_nomerge/single"], rank


def test_native_source_is_the_packages_own():
    """The host library builds from ``marex_tpu_torch/csrc``, which an
    installed port carries (package data), and binds both entry points."""
    import marex_tpu_torch
    from marex_tpu_torch import _native

    pkg = pathlib.Path(marex_tpu_torch.__file__).resolve().parent
    assert _native._SOURCE.resolve().parent == pkg / "csrc"
    assert _native._SOURCE.is_file()
    lib = _native.get_lib()
    assert lib is not None and pathlib.Path(lib._name).resolve().parent == pkg / "_build"
    comp = _native.union_find(np.array([[3, 1], [4, 5]], np.int64), np.array([1, 3, 4, 5, 9], np.int64))
    np.testing.assert_array_equal(comp, _native.union_find_plain(np.array([[3, 1], [4, 5]], np.int64),
                                                                 np.array([1, 3, 4, 5, 9], np.int64)))
