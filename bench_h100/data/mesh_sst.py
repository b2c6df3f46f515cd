"""
The unstructured-mesh SST generator: a periodic triangle-pair mesh on a
lat/lon lattice and daily SST (T, C) float32 on it, made on the card from a
seed, with AR(1) noise, a seasonal cycle, two pairs of warm patches that
converge each season and 40 blinking blobs of log-spaced sizes.

Frozen copies of ``chip_smoke.tri_mesh`` and ``chip_smoke.make_mesh_sst``
(``bench._tri_mesh`` and ``bench._make_unstructured_impl``'s recipes), kept
here so that the benchmark's traffic does not move when the smoke script
does; ``tests/test_h100bench_generators.py`` holds them equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch


def tri_mesh(n_cells: int):
    """Triangle-pair mesh on a lat/lon lattice, periodic in both directions:
    (neighbours (3, C) 1-based int32, lat (C,), lon (C,)) with
    C = 2 * gy * gx <= n_cells — the recipe of ``bench._tri_mesh``."""
    gx = int(np.sqrt(n_cells / 2))
    gy = max(n_cells // (2 * gx), 2)
    C = 2 * gy * gx
    jj, ii = np.mgrid[0:gy, 0:gx]
    lo = 2 * (jj * gx + ii)
    up = lo + 1

    def tid(j, i, upper):
        return (2 * ((j % gy) * gx + (i % gx)) + upper).astype(np.int32)

    nb = np.empty((3, C), dtype=np.int32)
    nb[0].reshape(gy, 2 * gx)[:, 0::2] = up
    nb[1].reshape(-1)[lo.ravel()] = tid(jj, ii - 1, 1).ravel()
    nb[2].reshape(-1)[lo.ravel()] = tid(jj - 1, ii, 1).ravel()
    nb[0].reshape(-1)[up.ravel()] = lo.ravel()
    nb[1].reshape(-1)[up.ravel()] = tid(jj, ii + 1, 0).ravel()
    nb[2].reshape(-1)[up.ravel()] = tid(jj + 1, ii, 0).ravel()

    lat_g = np.linspace(-60, 60, gy)
    lon_g = np.linspace(0, 360, gx, endpoint=False)
    lat_c = np.empty(C, np.float64)
    lon_c = np.empty(C, np.float64)
    lat_c[lo.ravel()] = np.broadcast_to(lat_g[:, None], (gy, gx)).ravel() - 0.2
    lat_c[up.ravel()] = np.broadcast_to(lat_g[:, None], (gy, gx)).ravel() + 0.2
    lon_c[lo.ravel()] = np.broadcast_to(lon_g[None, :], (gy, gx)).ravel()
    lon_c[up.ravel()] = np.broadcast_to(lon_g[None, :], (gy, gx)).ravel() + 0.2
    return nb + 1, lat_c, lon_c


def make_mesh_sst(n_years: int, n_cells: int, seed: int, device: str):
    """Synthetic daily SST (T, C) float32 on the triangle-pair mesh, generated
    on ``device``: AR(1) noise, a seasonal cycle, in two latitude bands a pair
    of warm patches that converge and join each season (days 60-140), and 40
    blinking blobs of log-spaced sizes — the recipe of
    ``bench._make_unstructured_impl``, with torch's generator for the noise.
    Returns (sst, coords, neighbours (3, C) 1-based int32, cell areas (C,))."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    nb, lat_c, lon_c = tri_mesh(n_cells)
    C = nb.shape[1]
    times = pd.date_range("2000-01-01", periods=int(n_years * 365.25), freq="D").to_numpy()
    T = len(times)
    idx = pd.DatetimeIndex(times)
    doy, years = idx.dayofyear.to_numpy(), idx.year.to_numpy()
    lat = torch.tensor(lat_c, dtype=torch.float32, device=device)
    lon = torch.tensor(lon_c, dtype=torch.float32, device=device)
    coslat = torch.cos(torch.deg2rad(lat))
    seas = torch.tensor(3.0 * np.cos(2 * np.pi * (doy - 30) / 365.25), dtype=torch.float32, device=device)

    sst = torch.empty((T, C), dtype=torch.float32, device=device)
    noise = torch.randn(C, generator=g, device=device)
    for t in range(T):
        if t:
            noise = 0.8 * noise + 0.6 * torch.randn(C, generator=g, device=device)
        sst[t] = noise + 15.0 + seas[t] * coslat

    def within(lat0: float, lon0: float, dlat: float, dlon: float) -> torch.Tensor:
        d = (lon - lon0).abs()
        return ((lat - lat0).abs() < dlat) & (torch.minimum(d, 360.0 - d) < dlon)

    for t in range(T):
        d, yr = int(doy[t]), int(years[t] - years.min())
        if 60 <= d <= 140:
            for lat0, lon0 in ((15.0, 40.0), (-15.0, 200.0)):
                for sgn in (-1, 1):
                    clon = ((lon0 + yr * 137.0) % 360.0 + sgn * max(60 - (d - 60) * 1.6, 8.0)) % 360.0
                    sst[t] += 5.0 * within(lat0, clon, 12.0, 18.0)
    rng = np.random.default_rng(seed + 1000)
    n_blobs = 40
    b_lat, b_lon = rng.uniform(-55, 55, n_blobs), rng.uniform(0, 360, n_blobs)
    b_rad = np.geomspace(1.5, 10.0, n_blobs)  # degrees
    on = rng.random((T, n_blobs)) < 0.25
    for i in range(n_blobs):
        cells = within(float(b_lat[i]), float(b_lon[i]), float(b_rad[i]), float(b_rad[i])).nonzero().squeeze(1)
        days = torch.from_numpy(np.nonzero(on[:, i])[0]).to(device)
        if cells.numel() and days.numel():
            sst[days[:, None], cells[None, :]] += 5.0
    coords = {"time": times, "lat": ("ncells", lat_c), "lon": ("ncells", lon_c)}
    return sst, coords, nb, np.full(C, 1.0e7, np.float32)


def generate(config: dict, seed: int, device: str) -> dict:
    """The cell's input from ``config["mesh"]``: the SST, its coordinates,
    the (3, C) 1-based neighbour table and the cell areas.

    The field is the recipe's at the configuration's fixed ``base_seed``,
    moved by ``seed`` lattice columns (mod their number) around the periodic
    mesh, whose table and coordinates do not change: every seed gets the
    same field, and so the same amount of work, in another order."""
    m = config["mesh"]
    sst, coords, nb, areas = make_mesh_sst(m["n_years"], m["n_cells"], config["base_seed"], device)
    gx = int(np.sqrt(m["n_cells"] / 2))
    gy = nb.shape[1] // (2 * gx)
    sst = torch.roll(sst.view(sst.shape[0], gy, gx, 2), seed % gx, dims=2).reshape(sst.shape[0], -1)
    return {"sst": sst, "coords": coords, "neighbours": nb, "cell_areas": areas}
