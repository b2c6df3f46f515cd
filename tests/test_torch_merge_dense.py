"""Bench's config 6, the merge-dense stress (``bench.py:config6_merge_dense``),
through ``marex_tpu`` and the port.

``chip_smoke.config6_field`` makes the field on the card from bench's numpy
centres; here it runs on CPU tensors and must equal bench's numpy recipe
(copied below) bit for bit, at bench's own shape (200 x 180 x 360, 24 pairs)
and at the tests' 50 x 60 x 120 with 6 pairs. At that size both packages
track it with bench's tracker, with and without merging: ``ID_field``, the
(time, ID) tables, every merge record and the attrs bit-identical (area and
centroid within 1e-5), and real merges.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu_torch.core.field import from_reference

from .test_torch_merge import assert_equal_runs
from .torch_parity import assert_same

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # chip_smoke.py

import chip_smoke  # noqa: E402


def bench_field(ny: int, nx: int, T: int = 200, n_pairs: int = 24) -> np.ndarray:
    """``bench.py:config6_merge_dense``'s field, as bench makes it."""
    data = np.zeros((T, ny, nx), bool)
    yy, xx = np.mgrid[0:ny, 0:nx]
    rng = np.random.default_rng(9)
    centers = [(rng.integers(ny // 6, 5 * ny // 6), rng.integers(0, nx)) for _ in range(n_pairs)]
    r = max(min(ny, nx) // 30, 5)
    for t in range(T):
        phase = (t % 50) / 50.0
        sep = int((1.0 - min(phase * 2, 1.0)) * 3 * r) + r
        for cy, cx0 in centers:
            for s in (-sep, sep):
                cx = (cx0 + s) % nx
                dx = np.minimum(np.abs(xx - cx), nx - np.abs(xx - cx))
                data[t] |= (yy - cy) ** 2 + dx**2 <= r * r
    return data


def bench_fields(data: np.ndarray):
    """bench's ``(extreme_events, mask)`` reference Fields."""
    T, ny, nx = data.shape
    coords = {"time": pd.date_range("2015-01-01", periods=T, freq="D").to_numpy(), "lat": np.linspace(-60, 60, ny),
              "lon": np.linspace(0, 360, nx, endpoint=False)}
    ev = ref.Field(data, ("time", "lat", "lon"), coords, name="extreme_events")
    mask = ref.Field(np.ones((ny, nx), bool), ("lat", "lon"), {"lat": coords["lat"], "lon": coords["lon"]}, name="mask")
    return ev, mask


@pytest.mark.parametrize("shape", [(50, 60, 120, 6), (200, 180, 360, 24)], ids=["small", "bench"])
def test_card_recipe_is_benchs(shape):
    T, ny, nx, n_pairs = shape
    got = chip_smoke.config6_field(ny, nx, "cpu", T=T, n_pairs=n_pairs)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), bench_field(ny, nx, T=T, n_pairs=n_pairs))


@pytest.fixture(scope="module")
def small():
    return bench_fields(bench_field(60, 120, T=50, n_pairs=6))


@pytest.mark.parametrize("merging", [False, True], ids=["no_merge", "merge"])
def test_config6_matches_reference(small, merging):
    ev, mask = small
    kw = dict(chip_smoke.CONFIG6_TRACK, allow_merging=merging, quiet=True)
    r_tr = ref.tracker(ev, mask, **kw)
    r_tr.use_scan_march = False  # the per-step march, which the port follows
    p_tr = port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), device="cpu", **kw)
    if merging:
        r, p = r_tr.run(return_merges=True), p_tr.run(return_merges=True)
        assert_equal_runs(r, p)
        assert p[0].attrs["total_merges"] > 0 and p_tr.dispatch_counts["partition"] > 0
    else:
        r, p = r_tr.run(), p_tr.run()
        assert_same(r["ID_field"].values, p["ID_field"].values, "ID_field")
        assert p.attrs == r.attrs
        assert p.attrs["N_events_final"] > 0
