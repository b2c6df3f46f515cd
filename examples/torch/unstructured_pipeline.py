"""Unstructured (triangular mesh) pipeline on the GPU: ICON/FESOM-style data.

The PyTorch port's counterpart of ``examples/unstructured_pipeline.py``.
Builds a small Delaunay mesh so the script is self-contained; with real model
output, load ``(time, ncells)`` data plus the grid's ``(nv=3, ncells)``
neighbour table and cell areas instead.

    python examples/torch/unstructured_pipeline.py [--device cuda] [--small]

``--small`` runs 3 years on a mesh of about 240 cells in place of 12 years
on about 1000. Outputs go to the working directory: the events store and
``events_mesh.png`` on the native triangulation (needs matplotlib).
"""

import argparse

import numpy as np
import pandas as pd
from scipy.spatial import Delaunay

import marex_tpu_torch as marEx
from marex_tpu_torch import Field, PlotConfig
from marex_tpu_torch.core.field import Coord
from marex_tpu_torch.io import to_zarr

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="torch device for detect and track (default: cuda)")
ap.add_argument("--small", action="store_true", help="3 years on about 240 cells in place of 12 on about 1000")
args = ap.parse_args()

# ----------------------------------------------------------------------------
# 0. A small triangular mesh + synthetic daily data
# ----------------------------------------------------------------------------
n_side = 12 if args.small else 24
rng = np.random.default_rng(0)
gx, gy = np.meshgrid(np.linspace(0, 355, n_side), np.linspace(-60, 60, n_side))
pts = np.column_stack([gx.ravel(), gy.ravel()]) + rng.uniform(-2, 2, (n_side * n_side, 2))
tri = Delaunay(pts)
cells = pts[tri.simplices].mean(axis=1)
lon_c, lat_c = cells[:, 0].astype(np.float32), cells[:, 1].astype(np.float32)
neighbours = (tri.neighbors.T + 1).astype(np.int32)  # 1-based, 0 = none
p = pts[tri.simplices]
cell_areas = (
    0.5
    * np.abs(
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1])
    ).astype(np.float32)
)

n_years = 3 if args.small else 12
times = pd.date_range("2000-01-01", periods=int(n_years * 365.25), freq="D").to_numpy()
doy = pd.DatetimeIndex(times).dayofyear.to_numpy()
sst = (
    15
    + 3 * np.cos(2 * np.pi * (doy[:, None] - 30) / 365.25) * np.cos(np.deg2rad(lat_c))[None, :]
).astype(np.float32)
noise = rng.standard_normal(sst.shape).astype(np.float32)
for k in range(1, len(times)):
    noise[k] = 0.8 * noise[k - 1] + 0.6 * noise[k]
sst += noise

da = Field(
    sst,
    ("time", "ncells"),
    coords={"time": times, "lat": Coord("ncells", lat_c), "lon": Coord("ncells", lon_c)},
    name="to",
)

# ----------------------------------------------------------------------------
# 1. DETECT (note explicit dims/coords for the mesh)
# ----------------------------------------------------------------------------
extremes = marEx.preprocess_data(
    da,
    method_anomaly="shifting_baseline",
    method_extreme="hobday_extreme",
    window_year_baseline=2 if args.small else 8,
    threshold_percentile=95,
    dimensions={"x": "ncells"},
    coordinates={"x": "lon", "y": "lat"},
    neighbours=Field(neighbours, ("nv", "ncells")),
    cell_areas=Field(cell_areas, ("ncells",)),
    device=args.device,
)

# ----------------------------------------------------------------------------
# 2. TRACK with neighbour-graph morphology + hop-distance partitioning
# ----------------------------------------------------------------------------
tr = marEx.tracker(
    extremes.extreme_events,
    extremes.mask,
    R_fill=2,
    T_fill=2,
    area_filter_absolute=8,  # cells; a percentile counts only objects of more than 50
    unstructured_grid=True,
    nn_partitioning=True,
    coordinate_units="degrees",
    dimensions={"x": "ncells"},
    coordinates={"x": "lon", "y": "lat"},
    neighbours=extremes.neighbours,
    cell_areas=extremes.cell_areas,
    device=args.device,
)
events, merges = tr.run(return_merges=True)
to_zarr(events, "events_mesh.zarr")
print(f"{events.attrs['N_events_final']} events, {events.attrs['total_merges']} merges")

# ----------------------------------------------------------------------------
# 3. VISUALISE on the native triangulation (a Delaunay triangulation of the
#    cell centres; pass a tgrid store to specify_grid for the model's own)
# ----------------------------------------------------------------------------
if marEx.has_dependency("matplotlib"):
    snapshot = events.ID_field.isel(time=-1)
    fig, ax, im = snapshot.plotX(dimensions={"time": "time", "x": "ncells"}).single_plot(
        PlotConfig(plot_IDs=True, title="tracked mesh events")
    )
    fig.savefig("events_mesh.png", dpi=120)
    print("wrote events_mesh.png")
else:
    print("visualise: skipped, matplotlib is not installed (plotX needs it to draw)")
