"""The port's multi-device merge-tracking scenarios (on a grid and on
unstructured meshes, detect included there) against ``marex_tpu``'s mesh
runs, as ``tests/test_torch_parallel_reference.py`` does for detect: integer
outputs and merge records bit for bit, areas and centroids within the parity
suite's tolerances."""

import pytest

from .torch_parallel_harness import World, assert_near_reference

SCENARIOS = ["track_merge", "track_realmerge", "unstructured", "unstructured_split"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("parallel_ref_track"), 2, 1, SCENARIOS)


@pytest.mark.parametrize("name", SCENARIOS)
def test_mesh_run_near_marex_tpu(world, name):
    assert_near_reference(name, world)
