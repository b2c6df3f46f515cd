"""The port's multi-device layer (``marex_tpu_torch.parallel``) on the CPU:
worlds of 2 and 4 ``gloo`` processes against the single-process run.

Each world is spawned once a module (``tests/torch_parallel_worker.py``,
one process a rank, one torch thread each, with a timeout): every rank
joins through ``helper.start_distributed_cluster``, runs every scenario in
one process and on a mesh, and writes what it gathered. The scenarios are
the counterparts of ``tests/test_multidevice_pipeline.py`` at its shapes
(detect with a global threshold, shifting baseline + Hobday, merge tracking,
real merges, an unstructured mesh, ``use_mesh``, ``mesh=True``), plus the
Hobday window's halo rows (``window_spatial_hobday=3``), a time length that
does not divide (the replicated route), gaps that ``T_fill`` closes across
the boundaries between slabs, a mesh run with real merges split in both
detect and track, and errors that one rank (or all) meets. Every output of
every rank is held bit for bit, with the attrs, against one process's run;
``tests/test_torch_parallel_reference.py`` holds the same runs against
``marex_tpu``'s mesh runs. The counterparts of
``tests/test_distributed_runtime.py`` close the file.
"""

from __future__ import annotations

import json
import os

import pytest
import torch.distributed as dist

from .torch_parallel_harness import assert_mesh_equals_single, load_run, spawn_world

SCENARIOS_2 = ["detect_global", "detect_hobday", "detect_hobday_w3", "use_mesh", "mesh_true", "track_merge",
               "track_realmerge", "track_replicated", "nomerge_gap", "unstructured", "unstructured_split"]
SCENARIOS_4 = ["detect_hobday", "track_realmerge"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn_world(tmp_path_factory.mktemp("parallel"), 2, 1, SCENARIOS_2 + ["errors"])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn_world(tmp_path_factory.mktemp("parallel4"), 4, 2, SCENARIOS_4)


@pytest.mark.parametrize("name", SCENARIOS_2)
def test_two_ranks_equal_one_process(world2, name):
    assert_mesh_equals_single(world2, name, 2)
    _, attrs = load_run(world2, name, 0)
    if name in ("track_replicated", "unstructured"):  # the replicated routes (63 days; 269 cells in detect)
        return
    # the split runs' outputs are DTensors, the (time, ID) tables whole tensors
    assert "DTensor" in attrs["mesh/types"] and "DTensor" not in attrs["single/types"]


def test_scenarios_exercise_what_they_name(world2):
    arrays, attrs = load_run(world2, "track_realmerge", 0)
    assert attrs["mesh/0"]["total_merges"] > 0
    arrays, attrs = load_run(world2, "unstructured_split", 0)
    assert attrs["mesh/1"]["total_merges"] > 0 and attrs["mesh/1"]["N_events_final"] > 0
    # the gaps across the slabs' boundary close: fewer events than with T_fill=0
    arrays, attrs = load_run(world2, "nomerge_gap", 0)
    assert 0 < attrs["mesh/0"]["N_events_final"] < 6
    arrays, _ = load_run(world2, "detect_hobday_w3", 0)
    assert arrays["mesh/0/extreme_events"].any()


@pytest.mark.parametrize("name", SCENARIOS_4)
def test_four_ranks_on_a_2x2_mesh_equal_one_process(world4, name):
    assert_mesh_equals_single(world4, name, 4)


def test_errors_reach_every_rank(world2):
    """The area filter's "no objects" (on every rank) and the march's "too
    many parents" (met on the rank that holds slice 15 only) are raised on
    every rank, as in one process, and no rank waits for another."""
    for rank in range(2):
        with open(os.path.join(world2, f"runtime.{rank}.json")) as f:
            errors = json.load(f)["errors"]
        for name, message in (("no_objects", "No objects found"), ("too_many_parents", "Too many parent objects")):
            assert errors[f"{name}/mesh"] is not None, (rank, name)
            assert errors[f"{name}/mesh"][0] == "TrackingError" and message in errors[f"{name}/mesh"][1]
            if rank == 0:
                assert errors[f"{name}/mesh"] == errors[f"{name}/single"]


def test_two_process_cluster(world2):
    """Two ranks join through ``start_distributed_cluster(..., backend="gloo")``
    and all-reduce rank + 1 to 3."""
    for rank in range(2):
        with open(os.path.join(world2, f"runtime.{rank}.json")) as f:
            rec = json.load(f)
        assert (rec["process_index"], rec["n_processes"], rec["total"]) == (rank, 2, 3.0)


def test_single_process_noop(monkeypatch):
    """Without arguments or environment nothing is initialised: one process."""
    from marex_tpu_torch.helper import start_distributed_cluster

    for var in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    was = dist.is_initialized()
    info = start_distributed_cluster()
    assert info.n_processes == 1 and info.process_index == 0
    assert dist.is_initialized() == was
