"""
Century-scale, larger-than-memory pipeline on one GPU: zarr -> streamed
detect -> streamed tracking -> zarr -> a map read back from the store.

The PyTorch port's counterpart of ``examples/streamed_century.py``. Neither
stage holds the whole dataset: the detect streams latitude-row tiles through
the card, the tracker streams time blocks, each sized to
``memory_budget_mb``; the results equal the in-memory runs bit for bit. A
100-year 0.25-degree store (about 150 GB of float32) runs on one 80 GB H100;
the length of the record only changes the wall time.

    python examples/torch/streamed_century.py SST_STORE OUT_DIR [--device cuda]
    python examples/torch/streamed_century.py --small [--device cpu]

With ``--small`` and no store, a synthetic 3-year store on 24 x 48 is written
to ``sst_small.zarr`` in the working directory and the outputs go to
``century_out/`` there. The map of the events (``events_last_day.png``) is
drawn from the lazy output store, one slice read (needs matplotlib).
"""

import argparse
import os

import numpy as np
import pandas as pd

import marex_tpu_torch as marEx
from marex_tpu_torch.io import zarr_lite


def small_store(path: str) -> None:
    """A synthetic 3-year daily SST store on 24 x 48 (AR(1) noise, a seasonal
    cycle, a land block), chunked a year of days at a time."""
    rng = np.random.default_rng(1)
    T, ny, nx = 3 * 365, 24, 48
    times = pd.date_range("2000-01-01", periods=T, freq="D").to_numpy()
    lat, lon = np.linspace(-80, 80, ny), np.linspace(0, 360, nx, endpoint=False)
    doy = pd.DatetimeIndex(times).dayofyear.to_numpy()
    sst = (15 + 3 * np.cos(2 * np.pi * (doy - 30) / 365.25)[:, None, None]
           + np.zeros((1, ny, nx))).astype(np.float32)
    noise = rng.standard_normal(sst.shape).astype(np.float32)
    for k in range(1, T):
        noise[k] = 0.8 * noise[k - 1] + 0.6 * noise[k]
    sst += noise
    sst[:, 5:9, 10:16] = np.nan
    field = marEx.Field(sst, ("time", "lat", "lon"), {"time": times, "lat": lat, "lon": lon}, name="sst")
    zarr_lite.to_zarr(field, path, chunks={"time": 365})


def main(sst_store: str, out_dir: str, device: str, small: bool) -> None:
    os.makedirs(out_dir, exist_ok=True)
    extremes_store = os.path.join(out_dir, "extremes.zarr")
    events_store = os.path.join(out_dir, "events.zarr")
    budget_mb = 64 if small else 4096

    # ---- stage 1: streamed detect ---------------------------------------
    # Latitude-row tiles stream through the card (read ahead on the host,
    # copied on a side stream); outputs are region-written into the
    # extremes store. Bit for bit the in-memory detect.
    ds = marEx.preprocess_data_streamed(
        sst_store,
        extremes_store,
        method_anomaly="shifting_baseline",
        method_extreme="hobday_extreme",
        threshold_percentile=95,
        window_year_baseline=2 if small else 15,
        smooth_days_baseline=21,
        window_days_hobday=11,
        memory_budget_mb=budget_mb,
        device=device,
    )

    # ---- stage 2: streamed tracking --------------------------------------
    # A lazy zarr-backed Field feeds the tracker; run_streamed() streams
    # morphology, area filtering, the split/merge march and the event
    # clustering over time blocks, region-writing ID_field into the events
    # store (production parameters: R_fill=12, T_fill=4, 600 cells).
    lazy = zarr_lite.open_zarr(extremes_store, lazy=True)
    tracker = marEx.tracker(
        lazy["extreme_events"],
        ds.mask,
        R_fill=2 if small else 12,
        T_fill=2 if small else 4,
        area_filter_absolute=8 if small else 600,
        allow_merging=True,
        nn_partitioning=True,
        overlap_threshold=0.25,
        grid_resolution=7.5 if small else 0.25,
        device=device,
    )
    events, merges = tracker.run_streamed(events_store, memory_budget_mb=budget_mb, return_merges=True)

    print(
        f"events: {events.attrs['N_events_final']}, "
        f"merges: {events.attrs['total_merges']}, "
        f"ID_field -> {events_store}"
    )

    # ---- stage 3: visualise from the store -------------------------------
    # events.ID_field is lazy: the ID maximum is read a chunk at a time, and
    # only the slice drawn is read whole.
    if marEx.has_dependency("matplotlib"):
        fig, _, _ = events.ID_field.plotX().single_plot(marEx.PlotConfig(plot_IDs=True, title="last day"))
        fig.savefig(os.path.join(out_dir, "events_last_day.png"), dpi=110)
        print(f"wrote {os.path.join(out_dir, 'events_last_day.png')}")
    else:
        print("visualise: skipped, matplotlib is not installed (plotX needs it to draw)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.strip().split("\n\n")[0])
    ap.add_argument("sst_store", nargs="?", help="zarr store of daily SST (time, lat, lon)")
    ap.add_argument("out_dir", nargs="?", help="directory for the extremes and events stores")
    ap.add_argument("--device", default="cuda", help="torch device for detect and track (default: cuda)")
    ap.add_argument("--small", action="store_true", help="a synthetic 3-year store on 24 x 48 when none is given")
    args = ap.parse_args()
    if args.sst_store is None and args.small:
        args.sst_store, args.out_dir = "sst_small.zarr", args.out_dir or "century_out"
        small_store(args.sst_store)
    if args.sst_store is None or args.out_dir is None:
        ap.error("SST_STORE and OUT_DIR are required without --small")
    main(args.sst_store, args.out_dir, args.device, args.small)
