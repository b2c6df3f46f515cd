"""Full gridded pipeline on the GPU: synthetic SST -> extremes -> tracked
events -> a map of the last day's events.

The PyTorch port's counterpart of ``examples/gridded_pipeline.py`` (the
gridded example notebooks' three stages: preprocess extremes, identify and
track events, visualise), through ``import marex_tpu_torch as marEx`` alone.

    python examples/torch/gridded_pipeline.py [--device cuda] [--small]

``--small`` runs 3 years on a 24 x 48 grid (seconds on a CPU) in place of 15
years on 90 x 180. Outputs go to the working directory: the extremes and
events stores and ``events_final.png``, the day with the most event cells
(the last step needs matplotlib).
"""

import argparse

import numpy as np
import pandas as pd

import marex_tpu_torch as marEx
from marex_tpu_torch import Field, PlotConfig
from marex_tpu_torch.io import to_zarr

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="torch device for detect and track (default: cuda)")
ap.add_argument("--small", action="store_true", help="3 years on 24 x 48 in place of 15 years on 90 x 180")
args = ap.parse_args()

# ----------------------------------------------------------------------------
# 0. Synthetic demo data (replace with your own ingest)
# ----------------------------------------------------------------------------
n_years, ny, nx = (3, 24, 48) if args.small else (15, 90, 180)
rng = np.random.default_rng(0)
times = pd.date_range("2000-01-01", periods=int(n_years * 365.25), freq="D").to_numpy()
lat = np.linspace(-89, 89, ny)
lon = np.linspace(0, 360, nx, endpoint=False)
doy = pd.DatetimeIndex(times).dayofyear.to_numpy()

sst = np.broadcast_to(
    15
    + 10 * np.cos(np.deg2rad(lat))[None, :, None]
    + 1.5 * np.sin(np.deg2rad(lon))[None, None, :]
    + 3 * np.cos(2 * np.pi * (doy[:, None, None] - 30) / 365.25) * np.cos(np.deg2rad(lat))[None, :, None]
    + 0.02 * (np.arange(len(times)) / 365.25)[:, None, None],
    (len(times), ny, nx),
).astype(np.float32)
noise = rng.standard_normal(sst.shape).astype(np.float32)
for k in range(1, len(times)):
    noise[k] = 0.8 * noise[k - 1] + 0.6 * noise[k]
sst += noise
sst[:, ny // 3 : ny // 2, nx // 9 : nx // 4] = np.nan  # a continent

da = Field(sst, ("time", "lat", "lon"), coords={"time": times, "lat": lat, "lon": lon}, name="sst")

# ----------------------------------------------------------------------------
# 1. DETECT (the outputs stay on the device as tensors)
# ----------------------------------------------------------------------------
extremes = marEx.preprocess_data(
    da,
    method_anomaly="shifting_baseline",
    method_extreme="hobday_extreme",
    threshold_percentile=95,
    window_year_baseline=2 if args.small else 10,
    device=args.device,
)
print(extremes)
to_zarr(extremes, "extremes_gridded.zarr")

# ----------------------------------------------------------------------------
# 2. TRACK
# ----------------------------------------------------------------------------
tr = marEx.tracker(
    extremes.extreme_events,
    extremes.mask,
    R_fill=2 if args.small else 8,
    T_fill=2,
    area_filter_quartile=0.5,
    allow_merging=True,
    nn_partitioning=True,
    grid_resolution=360 / nx,  # physical km^2 areas
    device=args.device,
)
events, merges = tr.run(return_merges=True)
to_zarr(events, "events_gridded.zarr")

print(f"{events.attrs['N_events_final']} events, {events.attrs['total_merges']} merges")

# ----------------------------------------------------------------------------
# 3. VISUALISE: only the slice drawn comes to the host
# ----------------------------------------------------------------------------
if marEx.has_dependency("matplotlib"):
    busiest = int((events.ID_field > 0).sum(("lat", "lon")).argmax("time").item())  # reduced on the device
    snapshot = events.ID_field.isel(time=busiest)
    fig, ax, im = snapshot.plotX().single_plot(PlotConfig(plot_IDs=True, title="tracked events"))
    fig.savefig("events_final.png", dpi=120)
    print("wrote events_final.png")
else:
    print("visualise: skipped, matplotlib is not installed (plotX needs it to draw)")
