"""The port's examples (``examples/torch/``) end to end on the CPU: each
script runs as its own process with ``--device cpu --small`` in a temporary
working directory, must exit 0, print its last line and leave its outputs
there. Without matplotlib the visualise step must say that it was skipped."""

import glob
import os
import subprocess
import sys

import pytest

from marex_tpu_torch import has_dependency

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch")

# script -> (the stores it writes, the figure it draws, the start of its last line)
SCRIPTS = {
    "gridded_pipeline.py": (["extremes_gridded.zarr", "events_gridded.zarr"], "events_final.png", "wrote"),
    "regional_pipeline.py": (["events_regional.zarr"], "regional_events.png", "wrote"),
    "unstructured_pipeline.py": (["events_mesh.zarr"], "events_mesh.png", "wrote"),
    "streamed_century.py": (["sst_small.zarr", "century_out/extremes.zarr", "century_out/events.zarr"],
                            "century_out/events_last_day.png", "wrote"),
    "batch_jobs/submit_gpu.sh": (["sst_small.zarr", "extremes.zarr", "events.zarr", "merges.zarr"], None,
                                 "track complete:"),
}


def test_every_example_is_run():
    found = {os.path.relpath(p, EXAMPLES) for p in glob.glob(os.path.join(EXAMPLES, "**", "*.py"), recursive=True)}
    run = set(SCRIPTS) | {"batch_jobs/run_detect.py", "batch_jobs/run_track.py"}  # the batch jobs run from submit_gpu.sh
    assert found <= run, sorted(found - run)


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_example_runs_on_the_cpu(script, tmp_path):
    stores, figure, last = SCRIPTS[script]
    path = os.path.join(EXAMPLES, script)
    cmd = (["bash", path] if script.endswith(".sh") else [sys.executable, path]) + ["--device", "cpu", "--small"]
    env = dict(os.environ, PYTHONPATH=REPO, MPLBACKEND="Agg")
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert lines and lines[-1].startswith(last if figure is None or has_dependency("matplotlib") else "visualise:"), \
        lines[-3:]
    for store in stores:
        assert (tmp_path / store / ".zgroup").is_file(), store
    if figure is not None:
        if has_dependency("matplotlib"):
            assert (tmp_path / figure).stat().st_size > 0
        else:
            assert lines[-1].startswith("visualise: skipped, matplotlib is not installed")
