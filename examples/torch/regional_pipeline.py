"""Regional (open-boundary) pipeline on the GPU: a EURO-CORDEX-style domain.

The PyTorch port's counterpart of ``examples/regional_pipeline.py``: a
limited-area grid with non-periodic longitudes, explicit coordinate units,
and absolute area filtering through ``regional_tracker``. Against the global
pipeline: morphology pads with ``edge`` instead of ``wrap``, labelling does
not connect across the x boundary, centroids are not wrapped, and
``coordinate_units`` is required (no auto-detection on a partial domain).

    python examples/torch/regional_pipeline.py [--device cuda] [--small]

``--small`` runs 3 years on 20 x 30 in place of 8 years on 90 x 134. Outputs
go to the working directory: the events store and ``regional_events.png``
(the last step needs matplotlib).
"""

import argparse

import numpy as np
import pandas as pd
from scipy.ndimage import uniform_filter

import marex_tpu_torch as marEx
from marex_tpu_torch import Field, PlotConfig
from marex_tpu_torch.io import to_zarr

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="torch device for detect and track (default: cuda)")
ap.add_argument("--small", action="store_true", help="3 years on 20 x 30 in place of 8 years on 90 x 134")
args = ap.parse_args()

# ----------------------------------------------------------------------------
# 0. Synthetic regional demo data (EURO-CORDEX-like domain: 27N-72N, 22W-45E)
# ----------------------------------------------------------------------------
n_years, ny, nx = (3, 20, 30) if args.small else (8, 90, 134)
rng = np.random.default_rng(7)
times = pd.date_range("2010-01-01", periods=int(n_years * 365.25), freq="D").to_numpy()
lat = np.linspace(27.0, 72.0, ny)
lon = np.linspace(-22.0, 45.0, nx)
doy = pd.DatetimeIndex(times).dayofyear.to_numpy()

sst = np.broadcast_to(
    12.0
    + 8.0 * np.cos(np.deg2rad(lat - 27.0))[None, :, None]
    + 1.0 * np.cos(np.deg2rad(lon))[None, None, :]
    + 4.0 * np.cos(2 * np.pi * (doy[:, None, None] - 45) / 365.25),
    (len(times), ny, nx),
).astype(np.float32)
noise = rng.standard_normal(sst.shape).astype(np.float32)
# spatially coherent anomalies (3 x 3 cell means): uncorrelated speckle, once
# closed, gives children of more parents than the march splits (10)
noise = uniform_filter(noise, size=(1, 3, 3), mode="nearest")
noise /= noise.std()
for k in range(1, len(times)):
    noise[k] = 0.8 * noise[k - 1] + 0.6 * noise[k]
sst += noise

# a Mediterranean-ish land mask block
sst[:, : ny // 6, nx // 2 :] = np.nan

da = Field(sst, ("time", "lat", "lon"), coords={"time": times, "lat": lat, "lon": lon}, name="sst")

# ----------------------------------------------------------------------------
# 1. Detect: anomalies + extreme events (same API as the global pipeline)
# ----------------------------------------------------------------------------
extremes_ds = marEx.preprocess_data(
    da,
    method_anomaly="detrend_harmonic",
    method_extreme="hobday_extreme",
    method_percentile="approximate",
    threshold_percentile=95,
    window_days_hobday=11,
    device=args.device,
)
print(f"extreme frequency: {float(extremes_ds.extreme_events.mean().item()):.4f}")

# ----------------------------------------------------------------------------
# 2. Track with the regional convenience wrapper: open boundaries, absolute
#    area filter (in cells), explicit units
# ----------------------------------------------------------------------------
tracker = marEx.regional_tracker(
    extremes_ds.extreme_events,
    extremes_ds.mask,
    R_fill=2 if args.small else 4,
    T_fill=2,
    area_filter_absolute=4 if args.small else 30,
    allow_merging=True,
    overlap_threshold=0.4,
    coordinate_units="degrees",
    device=args.device,
)
events_ds, merges_ds = tracker.run(return_merges=True)
to_zarr(events_ds, "events_regional.zarr")

print(f"tracked events: {events_ds.attrs['N_events_final']}")
print(f"recorded merges: {events_ds.attrs['total_merges']}")

# centroids stay inside the regional domain (no wrap into [0, 360))
clat = events_ds.centroid.values[0]
clon = events_ds.centroid.values[1]
present = events_ds.presence.values
assert np.nanmin(clon[present]) >= lon.min() and np.nanmax(clon[present]) <= lon.max()
assert np.nanmin(clat[present]) >= lat.min() and np.nanmax(clat[present]) <= lat.max()
print("centroids confined to the regional domain - OK")

# ----------------------------------------------------------------------------
# 3. Visualise (needs matplotlib; cartopy adds a map projection)
# ----------------------------------------------------------------------------
if marEx.has_dependency("matplotlib"):
    config = PlotConfig(plot_IDs=True, title="Regional extreme events")
    fig, ax, _ = events_ds.ID_field.isel(time=-1).plotX.single_plot(config)
    fig.savefig("regional_events.png", dpi=110)
    print("wrote regional_events.png")
else:
    print("visualise: skipped, matplotlib is not installed (plotX needs it to draw)")
