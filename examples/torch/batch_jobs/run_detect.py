"""Batch detect job on one GPU (the port's counterpart of
``examples/batch_jobs/run_detect.py``).

Environment knobs, as the reference's SLURM scripts have them:
  MAREX_INPUT    zarr store with the raw variable      (required without --small)
  MAREX_VAR      variable name                         (default "sst")
  MAREX_OUTPUT   output zarr store                     (default extremes.zarr)
  MAREX_PCTL     threshold percentile                  (default 95)
  MAREX_ANOMALY  anomaly method                        (default shifting_baseline)
  MAREX_EXTREME  extreme method                        (default hobday_extreme)
  MAREX_VERBOSE  verbose logging when set

    python examples/torch/batch_jobs/run_detect.py [--device cuda] [--small]
    torchrun --standalone --nproc_per_node=4 examples/torch/batch_jobs/run_detect.py --mesh

``--small`` writes a synthetic 3-year SST store on 24 x 48 to MAREX_INPUT
(default ``sst_small.zarr``) when there is none, and uses a 2-year baseline.
``--mesh`` (under ``torchrun``, one process a card) splits the grid's rows
over the processes; the first writes the output store.
"""

import argparse
import os

import numpy as np
import pandas as pd

import marex_tpu_torch as marEx
from marex_tpu_torch.io import open_zarr, to_zarr

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
ap.add_argument("--small", action="store_true", help="a synthetic 3-year store on 24 x 48 when MAREX_INPUT is absent")
ap.add_argument("--mesh", action="store_true", help="under torchrun: one process a card, the rows split over them")
args = ap.parse_args()

marEx.configure_logging(verbose=bool(os.environ.get("MAREX_VERBOSE")))
if args.mesh:  # join torchrun's world (gloo for a run on the CPU)
    first = marEx.start_distributed_cluster(backend="gloo" if args.device == "cpu" else None).process_index == 0
else:
    first = marEx.helper.start_local_cluster() is not None

store = os.environ.get("MAREX_INPUT", "sst_small.zarr" if args.small else None)
if store is None:
    ap.error("MAREX_INPUT (a zarr store) is required without --small")
if args.small and first and not os.path.isdir(store):
    rng = np.random.default_rng(2)
    T, ny, nx = 3 * 365, 24, 48
    times = pd.date_range("2000-01-01", periods=T, freq="D").to_numpy()
    doy = pd.DatetimeIndex(times).dayofyear.to_numpy()
    sst = (15 + 3 * np.cos(2 * np.pi * (doy - 30) / 365.25)[:, None, None] + np.zeros((1, ny, nx))).astype(np.float32)
    noise = rng.standard_normal(sst.shape).astype(np.float32)
    for k in range(1, T):
        noise[k] = 0.8 * noise[k - 1] + 0.6 * noise[k]
    coords = {"time": times, "lat": np.linspace(-80, 80, ny), "lon": np.linspace(0, 360, nx, endpoint=False)}
    to_zarr(marEx.Field(sst + noise, ("time", "lat", "lon"), coords, name=os.environ.get("MAREX_VAR", "sst")), store)
if args.mesh:
    import torch.distributed as dist

    dist.barrier()  # the store is written before any process reads it

da = open_zarr(store)[os.environ.get("MAREX_VAR", "sst")]

extremes = marEx.preprocess_data(
    da,
    method_anomaly=os.environ.get("MAREX_ANOMALY", "shifting_baseline"),
    method_extreme=os.environ.get("MAREX_EXTREME", "hobday_extreme"),
    threshold_percentile=float(os.environ.get("MAREX_PCTL", "95")),
    method_percentile="approximate",
    window_year_baseline=2 if args.small else 15,
    device=args.device,
    mesh=True if args.mesh else None,
)

to_zarr(extremes, os.environ.get("MAREX_OUTPUT", "extremes.zarr"))  # on a mesh: gathered, the first process writes
print("detect complete:", dict(extremes.sizes))
