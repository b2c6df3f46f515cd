"""
The gridded SST generator: daily SST (T, ny, nx) float32 made on the card
from a seed, with AR(1) noise, a seasonal cycle, drifting warm blobs
(days 60-140), converging blob pairs (days 150-270) and a NaN land block;
optionally with the noise smoothed in space, so that anomalies are coherent
over hundreds of kilometres as real SST anomalies are.

A frozen copy of ``chip_smoke.make_sst`` (``bench._make_data_impl``'s recipe
with torch's generator), kept here so that the benchmark's traffic does not
move when the smoke script does; ``tests/test_h100bench_generators.py``
holds the two equal bit for bit (without the smoothing, which is this
file's own).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch


def smooth_noise(x: torch.Tensor, half: int) -> torch.Tensor:
    """White noise ``x`` (ny, nx) made spatially coherent: a box of width
    ``2 * half + 1`` run twice along each axis (a triangle, periodic in
    longitude, edge values held in latitude), scaled back to unit variance."""
    n = 2 * half + 1
    for _ in range(2):
        xp = torch.cat([x[:, -half:], x, x[:, :half]], 1)
        x = torch.nn.functional.avg_pool1d(xp[:, None], n, 1)[:, 0]
        xp = torch.cat([x[:1].expand(half, -1), x, x[-1:].expand(half, -1)], 0)
        x = torch.nn.functional.avg_pool1d(xp.T.contiguous()[:, None], n, 1)[:, 0].T
    k = np.arange(1 - n, n)
    gain = float((((n - np.abs(k)) / n**2) ** 2).sum())  # the triangle's sum of squares, per axis
    return (x / gain).contiguous()


def make_sst(n_years: int, ny: int, nx: int, seed: int, device: str, lat_range=(-89.5, 89.5), lon_range=(0.0, 360.0),
             n_days: int = 0, smooth: int = 0):
    """Synthetic daily SST (T, ny, nx) float32, generated on ``device``: AR(1)
    noise, a seasonal cycle, drifting warm blobs (days 60-140), converging
    blob pairs (days 150-270) and a NaN land block — the recipe of
    ``bench._make_data_impl``, with torch's generator in place of numpy's. A
    longitude range other than the full circle includes its end point (a
    regional grid). T is ``n_days`` when given, else ``n_years`` of days.
    With ``smooth`` > 0 every draw of the noise goes through
    :func:`smooth_noise` (anomalies coherent over some ``3 * smooth`` cells);
    0 is the smoke script's recipe."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    times = pd.date_range("2000-01-01", periods=n_days or int(n_years * 365.25), freq="D").to_numpy()
    T = len(times)
    lat = np.linspace(lat_range[0], lat_range[1], ny)
    lon = np.linspace(lon_range[0], lon_range[1], nx, endpoint=lon_range != (0.0, 360.0))
    idx = pd.DatetimeIndex(times)
    doy, years = idx.dayofyear.to_numpy(), idx.year.to_numpy()
    coslat = torch.cos(torch.deg2rad(torch.tensor(lat, dtype=torch.float32, device=device)))
    base = (15.0 + 10.0 * coslat)[:, None]
    seas = torch.tensor(3.0 * np.cos(2 * np.pi * (doy - 30) / 365.25), dtype=torch.float32, device=device)
    yrow = torch.arange(ny, device=device)
    xcol = torch.arange(nx, device=device)

    sst = torch.empty((T, ny, nx), dtype=torch.float32, device=device)
    def draw() -> torch.Tensor:
        x = torch.randn((ny, nx), generator=g, device=device)
        return smooth_noise(x, smooth) if smooth else x

    noise = draw()
    for t in range(T):
        if t:
            noise = 0.8 * noise + 0.6 * draw()
        sst[t] = noise + base + seas[t] * coslat[:, None]

    def stamp(t: int, cy: int, cx: int, rad: int, amp: float) -> None:
        r0, r1 = max(cy - rad, 0), min(cy + rad + 1, ny)
        if r0 >= r1:
            return
        dxc = torch.minimum((xcol - cx).abs(), nx - (xcol - cx).abs())
        blob = (yrow[r0:r1, None] - cy) ** 2 + dxc[None, :] ** 2 <= rad * rad
        sst[t, r0:r1] += amp * blob

    y0 = years.min()
    r = max(min(ny, nx) // 8, 12)
    rp = max(16, min(ny, nx) // 45)
    n_pairs = max(6, ny // 36)
    pairs = [(int(ny * (0.25 + 0.5 * i / max(n_pairs - 1, 1))), int((i * 997) % nx)) for i in range(n_pairs)]
    for t in range(T):
        d, yr = int(doy[t]), int(years[t] - y0)
        if 60 <= d <= 140:
            stamp(t, ny // 2 + ((yr % 3) - 1) * (ny // 6), (nx // 4 + yr * (nx // 5) + (d - 60)) % nx, r, 4.0)
        if 150 <= d <= 270:
            phase = ((d - 150) % 40) / 40.0
            sep = int((1.0 - min(phase * 2, 1.0)) * 3 * rp) + rp
            for cy, cx0 in pairs:
                cx0y = (cx0 + yr * (nx // 3 + 7)) % nx
                for s in (-sep, sep):
                    stamp(t, cy, (cx0y + s) % nx, rp, 5.0)
    sst[:, ny // 4 : ny // 4 + ny // 8, nx // 8 : nx // 4] = float("nan")
    return sst, {"time": times, "lat": lat, "lon": lon}


def generate(config: dict, seed: int, device: str) -> dict:
    """The cell's input from ``config["grid"]``: the SST and its coordinates.

    The field is the recipe's at the configuration's fixed ``base_seed``
    (its noise smoothed over ``config["noise_smooth"]`` cells, 0 when absent),
    rolled in longitude by ``seed`` cells (mod the grid's width): every seed
    gets the same field, and so the same amount of work, in another order
    (other ids, another first object, other objects across the seam)."""
    g = config["grid"]
    sst, coords = make_sst(0, g["ny"], g["nx"], config["base_seed"], device, tuple(g["lat_range"]),
                           tuple(g["lon_range"]), n_days=config["n_days"], smooth=config.get("noise_smooth", 0))
    return {"sst": torch.roll(sst, seed % g["nx"], dims=2), "coords": coords}
