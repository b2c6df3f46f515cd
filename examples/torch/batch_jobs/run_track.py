"""Batch track job on one GPU (the port's counterpart of
``examples/batch_jobs/run_track.py``).

The production parameters are the reference's submit_track.sh defaults:
R_fill=12, T_fill=4, area_filter_absolute=600, overlap=0.25, 0.25-degree
areas; each can be set from the environment (MAREX_R_FILL, MAREX_T_FILL,
MAREX_AREA_FILTER, MAREX_OVERLAP, MAREX_GRID_RES). MAREX_INPUT is the
extremes store (default extremes.zarr), MAREX_OUTPUT and MAREX_MERGES the
output stores (default events.zarr, merges.zarr).

    python examples/torch/batch_jobs/run_track.py [--device cuda] [--small]
    torchrun --standalone --nproc_per_node=4 examples/torch/batch_jobs/run_track.py --mesh

``--small`` changes the defaults to R_fill=2, T_fill=2, 8 cells and 7.5-degree
areas, the sizes of run_detect's small store. ``--mesh`` (under ``torchrun``,
one process a card) splits the days over the processes; the first writes the
output stores.
"""

import argparse
import os

import marex_tpu_torch as marEx
from marex_tpu_torch.io import open_zarr, to_zarr

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
ap.add_argument("--small", action="store_true", help="defaults sized for run_detect's small store")
ap.add_argument("--mesh", action="store_true", help="under torchrun: one process a card, the days split over them")
args = ap.parse_args()

if args.mesh:  # join torchrun's world (gloo for a run on the CPU)
    first = marEx.start_distributed_cluster(backend="gloo" if args.device == "cpu" else None).process_index == 0
else:
    first = marEx.helper.start_local_cluster() is not None
defaults = dict(R_fill="2", T_fill="2", area="8", res="7.5") if args.small else \
    dict(R_fill="12", T_fill="4", area="600", res="0.25")

extremes = open_zarr(os.environ.get("MAREX_INPUT", "extremes.zarr"))

tr = marEx.tracker(
    extremes.extreme_events,
    extremes.mask,
    R_fill=int(os.environ.get("MAREX_R_FILL", defaults["R_fill"])),
    T_fill=int(os.environ.get("MAREX_T_FILL", defaults["T_fill"])),
    area_filter_absolute=int(os.environ.get("MAREX_AREA_FILTER", defaults["area"])),
    overlap_threshold=float(os.environ.get("MAREX_OVERLAP", "0.25")),
    grid_resolution=float(os.environ.get("MAREX_GRID_RES", defaults["res"])),
    allow_merging=True,
    nn_partitioning=True,
    quiet=bool(os.environ.get("MAREX_QUIET")),
    device=args.device,
    mesh=True if args.mesh else None,
)
events, merges = tr.run(return_merges=True)

to_zarr(events, os.environ.get("MAREX_OUTPUT", "events.zarr"))  # on a mesh: gathered, the first process writes
if first:  # the merge records are whole on every process
    to_zarr(merges, os.environ.get("MAREX_MERGES", "merges.zarr"))
print("track complete:", events.attrs["N_events_final"], "events")
