"""The frozen generators make the smoke script's traffic bit for bit."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke  # noqa: E402

from bench_h100.data import grid_sst, mesh_sst  # noqa: E402


def test_grid_sst_equals_smoke():
    a, ca = grid_sst.make_sst(0, 36, 72, 2**33 + 5, "cpu", n_days=400)
    b, cb = chip_smoke.make_sst(0, 36, 72, 2**33 + 5, "cpu", n_days=400)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert all(np.array_equal(ca[k], cb[k]) for k in ("time", "lat", "lon"))


def test_mesh_equals_smoke():
    for x, y in zip(mesh_sst.tri_mesh(5000), chip_smoke.tri_mesh(5000)):
        assert np.array_equal(x, y)
    a = mesh_sst.make_mesh_sst(1, 3000, 17, "cpu")
    b = chip_smoke.make_mesh_sst(1, 3000, 17, "cpu")
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert all(np.array_equal(a[1][k][-1] if k != "time" else a[1][k], b[1][k][-1] if k != "time" else b[1][k])
               for k in ("time", "lat", "lon"))
    assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])


def test_seeds_share_the_field_in_another_order():
    """Every seed gets the base field, rolled: the same work, other ids."""
    cfg = {"grid": {"ny": 12, "nx": 24, "lat_range": [-89.5, 89.5], "lon_range": [0.0, 360.0]}, "n_days": 50,
           "base_seed": 4}
    a, b = (grid_sst.generate(cfg, s, "cpu")["sst"] for s in (0, 2**33 + 7))
    assert a.shape == (50, 12, 24) and a.dtype == torch.float32
    shift = (2**33 + 7) % 24
    assert torch.equal(torch.roll(a, shift, 2).nan_to_num(-1.0), b.nan_to_num(-1.0)) and shift
    mc = {"mesh": {"n_cells": 2048, "n_years": 1}, "base_seed": 4}
    x, y = (mesh_sst.generate(mc, s, "cpu") for s in (0, 5))
    assert torch.equal(x["sst"].sort(1).values, y["sst"].sort(1).values) and not torch.equal(x["sst"], y["sst"])
    assert np.array_equal(x["neighbours"], y["neighbours"])


def test_smoothed_noise_is_coherent_with_unit_variance():
    g = torch.Generator().manual_seed(3)
    x = grid_sst.smooth_noise(torch.randn((360, 720), generator=g), 8)
    assert abs(float(x[40:-40].std()) - 1.0) < 0.1
    lag = float((x[:, 1:] * x[:, :-1]).mean() / (x * x).mean())
    assert lag > 0.9  # neighbours nearly equal; white noise reads about 0
    cfg = {"grid": {"ny": 12, "nx": 24, "lat_range": [-89.5, 89.5], "lon_range": [0.0, 360.0]}, "n_days": 20,
           "base_seed": 4, "noise_smooth": 2}
    a, b = (grid_sst.generate(cfg, 5, "cpu")["sst"] for _ in range(2))
    plain = grid_sst.generate({**cfg, "noise_smooth": 0}, 5, "cpu")["sst"]
    assert torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0)) and not torch.equal(a.nan_to_num(-1.0), plain.nan_to_num(-1.0))
