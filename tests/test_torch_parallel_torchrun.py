"""The batch recipe on several processes: ``examples/torch/batch_jobs/
submit_gpu.sh`` with ``MAREX_GPUS=2`` runs detect and track each under
``torchrun --standalone --nproc_per_node=2`` (``--mesh``: every process joins
through ``start_distributed_cluster``, here a ``gloo`` world on the CPU),
and the stores it writes must equal one process's run of the same jobs."""

import os
import subprocess

import numpy as np

import marex_tpu_torch as port
from marex_tpu_torch.io import open_zarr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBMIT = os.path.join(REPO, "examples", "torch", "batch_jobs", "submit_gpu.sh")


def test_submit_gpu_under_torchrun_equals_one_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, MAREX_GPUS="2", OMP_NUM_THREADS="1")
    out = subprocess.run(["bash", SUBMIT, "--device", "cpu", "--small"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.count("track complete:") == 2  # one line a process

    # the same jobs in one process, on the store the run wrote (run_detect's and run_track's settings)
    sst = open_zarr(str(tmp_path / "sst_small.zarr"))["sst"]
    ds = port.preprocess_data(sst, method_anomaly="shifting_baseline", method_extreme="hobday_extreme",
                              threshold_percentile=95, method_percentile="approximate", window_year_baseline=2,
                              device="cpu", quiet=True)
    events, merges = port.tracker(ds.extreme_events, ds.mask, R_fill=2, T_fill=2, area_filter_absolute=8,
                                  overlap_threshold=0.25, grid_resolution=7.5, allow_merging=True,
                                  nn_partitioning=True, device="cpu", quiet=True).run(return_merges=True)
    stored = {name: open_zarr(str(tmp_path / f"{name}.zarr")) for name in ("extremes", "events", "merges")}
    for want, got in ((ds, stored["extremes"]), (events, stored["events"]), (merges, stored["merges"])):
        assert set(want.data_vars) == set(got.data_vars)
        for v in want.data_vars:
            a, b = want[v].values, got[v].values
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), v
    assert stored["events"].attrs["N_events_final"] == events.attrs["N_events_final"] > 0
