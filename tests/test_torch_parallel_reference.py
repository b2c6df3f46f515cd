"""The port's multi-device detect scenarios (and the tracking ones that need
no merge march) against ``marex_tpu``'s mesh runs: a world of 2 ``gloo``
ranks (``tests/torch_parallel_worker.py``, running in the background while
the reference runs) against ``marex_tpu`` under ``parallel.make_mesh()`` on
the 8 virtual CPU devices of ``tests/conftest.py``, with the parity suite's
rules (``tests/torch_parallel_harness.py``). The port's mesh runs equal its
one-process runs bit for bit (``tests/test_torch_parallel.py``); the merge
scenarios are in ``tests/test_torch_parallel_reference_track.py``."""

import pytest

from .torch_parallel_harness import World, assert_near_reference

SCENARIOS = ["detect_global", "detect_hobday", "detect_hobday_w3", "use_mesh", "nomerge_gap", "track_replicated",
             "mesh_true"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("parallel_ref"), 2, 1, SCENARIOS)


@pytest.mark.parametrize("name", SCENARIOS)
def test_mesh_run_near_marex_tpu(world, name):
    assert_near_reference(name, world)
