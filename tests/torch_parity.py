"""Helpers for the parity tests of the PyTorch port (``marex_tpu_torch``)
against the JAX reference (``marex_tpu``).

Inputs are made with numpy from a seed and handed to both packages; the port
runs with ``device="cpu"``, i.e. through the plain PyTorch versions of its
kernels. The contract: boolean and integer fields bit-identical, float fields
within 1e-5 (the anomaly tolerance of ``BASELINE.json``), attrs equal.

The module imports no JAX itself (the reference's ``Field`` is imported where
it is used), so ``tests/test_torch_cuda.py`` can take its inputs from here on
a machine without JAX.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

DETECT_FIXED = dict(
    method_anomaly="fixed_baseline",
    method_extreme="global_extreme",
    method_percentile="approximate",
    threshold_percentile=95,
)
# config-1 tracking at the small drive's scale (production: R_fill=12, T_fill=4, area 600)
TRACK_SMALL = dict(R_fill=2, T_fill=2, area_filter_absolute=8, allow_merging=False)
FLOAT_ATOL = 1e-5


def drive_sst(seed: int = 0, n_years: int = 3, ny: int = 24, nx: int = 48):
    """The verify drive: daily AR(1) SST, 3 yr x 24 x 48, with a land block."""
    from marex_tpu.core.field import Field

    rng = np.random.default_rng(seed)
    times = pd.date_range("2000-01-01", periods=n_years * 365, freq="D").to_numpy()
    T = len(times)
    lat = np.linspace(-60, 60, ny)
    lon = np.linspace(0, 360, nx, endpoint=False)
    sst = 15 + rng.standard_normal((T, ny, nx)).astype(np.float32)
    for k in range(1, T):
        sst[k] = 0.7 * sst[k - 1] + 0.4 * sst[k]
    sst[:, 3:6, 10:15] = np.nan
    return Field(sst, ("time", "lat", "lon"), {"time": times, "lat": lat, "lon": lon}, name="sst")


def blob_field(seed: int, T: int, H: int, W: int, n_blobs: int, r_max: int = 6) -> np.ndarray:
    """(T, H, W) bool field of random disks (periodic in x) lasting 1-4 steps,
    plus a seam-crossing block, so labelling meets wrap and time links."""
    rng = np.random.default_rng(seed)
    data = np.zeros((T, H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(n_blobs):
        t0 = int(rng.integers(0, T))
        dur = int(rng.integers(1, 5))
        cy, cx = int(rng.integers(0, H)), int(rng.integers(0, W))
        r = int(rng.integers(1, r_max + 1))
        dx = np.minimum(np.abs(xx - cx), W - np.abs(xx - cx))
        data[t0 : t0 + dur] |= (yy - cy) ** 2 + dx**2 <= r * r
    data[T // 3 : T // 3 + 3, H // 3 : H // 3 + 4, :2] = True
    data[T // 3 : T // 3 + 3, H // 3 : H // 3 + 4, W - 2 :] = True
    return data


def merge_dense_field(T: int = 60, n_pairs: int = 5, seed: int = 3, ny: int = 48, nx: int = 180) -> np.ndarray:
    """(T, ny, nx) bool field of disk pairs (radius 5, periodic in x) that
    converge, merge and separate every 20 steps: the merge-dense recipe of
    ``tests/test_scan_march.py:merge_dense_field``."""
    data = np.zeros((T, ny, nx), bool)
    yy, xx = np.mgrid[0:ny, 0:nx]
    rng = np.random.default_rng(seed)
    centers = [(int(rng.integers(ny // 5, 4 * ny // 5)), int(rng.integers(0, nx))) for _ in range(n_pairs)]
    r = 5
    for t in range(T):
        phase = (t % 20) / 20.0
        sep = int((1.0 - min(phase * 2, 1.0)) * 3 * r) + r
        for cy, cx0 in centers:
            for s in (-sep, sep):
                cx = (cx0 + s) % nx
                dx = np.minimum(np.abs(xx - cx), nx - np.abs(xx - cx))
                data[t] |= (yy - cy) ** 2 + dx**2 <= r * r
    return data


def partition_inputs(seed: int, H: int, W: int, K: int, P: int, cap: float, edge: bool = False):
    """One march step's batch for the grid partition, as numpy arrays:
    ``(prev, cur, (child_ids, piece_ids, parent_ids, parent_valid,
    parent_cents, max_dist))``. K children (disks of ids 1001..) each over P
    parent disks (ids 1..K*P) in the previous slice, the first crossing the
    seam; piece ids 2000 + k*P + p, the first the child's own id; every cap
    ``cap``. ``edge`` adds an empty parent mask (a valid slot whose id is
    absent), an invalid slot holding a real id, and, with K > 1, an inactive
    last child slot (id 0)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]

    def disk(cy, cx, r):
        dx = np.minimum(np.abs(xx - cx), W - np.abs(xx - cx))
        return (yy - cy) ** 2 + dx**2 <= r * r

    prev = np.zeros((H, W), np.int32)
    cur = np.zeros((H, W), np.int32)
    scale = max(min(H, W) // 40, 1)
    pids = np.arange(1, K * P + 1, dtype=np.int32).reshape(K, P)
    for k in range(K):
        cy, cx = int(rng.integers(0, H)), int(rng.integers(0, W))
        if k == 0:
            cx = 0  # the first parent crosses the seam
        r_child = int(rng.integers(6, 14)) * scale
        cur[disk(cy, cx, r_child)] = 1001 + k
        for p in range(P):
            py = int(np.clip(cy + rng.integers(-r_child, r_child + 1), 0, H - 1))
            px = cx if p == 0 else int((cx + rng.integers(-r_child, r_child + 1)) % W)
            prev[disk(py, px, int(rng.integers(1, 5)) * scale)] = pids[k, p]
    child = 1001 + np.arange(K, dtype=np.int32)
    piece = (2000 + np.arange(K * P, dtype=np.int32)).reshape(K, P)
    piece[:, 0] = child
    valid = np.ones((K, P), bool)
    cents = rng.uniform([0, 0], [H - 1, W - 1], (K, P, 2)).astype(np.float32)
    if edge:
        pids[0, P - 1] = K * P + 7  # valid, but not in the previous slice
        valid[(1 % K), P // 2] = False  # its id is in the slice
        if K > 1:
            child[K - 1] = 0
    mdist = np.full(K, cap, np.float32)
    return prev, cur, (child, piece, pids, valid, cents, mdist)


def bool_fields(data: np.ndarray, mask: np.ndarray):
    """``(extreme_events, mask)`` reference Fields on a global 0..360 grid."""
    from marex_tpu.core.field import Field

    T, H, W = data.shape
    coords = {
        "time": pd.date_range("2000-01-01", periods=T, freq="D").to_numpy(),
        "lat": np.linspace(-60, 60, H),
        "lon": np.linspace(0, 360, W, endpoint=False),
    }
    ev = Field(data, ("time", "lat", "lon"), coords, name="extreme_events")
    mk = Field(mask, ("lat", "lon"), {"lat": coords["lat"], "lon": coords["lon"]}, name="mask")
    return ev, mk


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


def mesh_merge_field(lat_c: np.ndarray, lon_c: np.ndarray, T: int = 30, seed: int = 5) -> np.ndarray:
    """(T, C) bool field on a mesh: in two latitude bands a pair of patches
    that converge (one pair across the lon seam), join and drift apart again,
    plus blinking blobs of several sizes — merges and splits that the area
    filter leaves in."""
    rng = np.random.default_rng(seed)
    data = np.zeros((T, len(lat_c)), bool)

    def dlon(c):
        return np.minimum(np.abs(lon_c - c), 360.0 - np.abs(lon_c - c))

    for t in range(T):
        sep = max(52.0 - 3.0 * min(t, T - 1 - t), 10.0)
        for lat0, lon0 in ((15.0, 100.0), (-20.0, 355.0)):
            for sgn in (-1, 1):
                data[t] |= (np.abs(lat_c - lat0) < 15.0) & (dlon((lon0 + sgn * sep) % 360.0) < 20.0)
    for _ in range(12):
        lat0, lon0, rad = rng.uniform(-50, 50), rng.uniform(0, 360), rng.uniform(4, 12)
        days = rng.random(T) < 0.4
        data[days] |= (np.abs(lat_c - lat0) < rad) & (dlon(lon0) < rad)
    return data


def mesh_fields(data: np.ndarray, lat_c, lon_c, neighbours, cell_areas, mask=None):
    """``(extreme_events, mask, neighbours, cell_areas)`` reference Fields on
    an unstructured mesh (dims ``time``, ``ncells``, ``nv``)."""
    from marex_tpu.core.field import Field

    T, C = data.shape
    sc = {"lat": ("ncells", np.asarray(lat_c)), "lon": ("ncells", np.asarray(lon_c))}
    times = pd.date_range("2001-03-01", periods=T, freq="D").to_numpy()
    ev = Field(data, ("time", "ncells"), {"time": times, **sc}, name="extreme_events")
    mk = Field(np.ones(C, bool) if mask is None else mask, ("ncells",), sc, name="mask")
    return ev, mk, Field(neighbours, ("nv", "ncells"), name="neighbours"), Field(cell_areas, ("ncells",), name="cell_areas")


MESH_KW = dict(unstructured_grid=True, coordinate_units="degrees", dimensions={"x": "ncells"},
               coordinates={"x": "lon", "y": "lat"}, quiet=True)


def to_np(x) -> np.ndarray:
    """Host numpy view of a torch tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(ref, port, what: str = "") -> None:
    """Bit-identical values and dtype kind (bool / integer)."""
    a, b = to_np(ref), to_np(port)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    assert a.dtype.kind == b.dtype.kind, f"{what}: dtype {a.dtype} vs {b.dtype}"
    assert np.array_equal(a, b), f"{what}: {int(np.sum(a != b))} of {a.size} values differ"


def assert_close(ref, port, atol: float = FLOAT_ATOL, what: str = "") -> None:
    """Float fields: same NaN pattern, finite values within ``atol``."""
    a, b = to_np(ref).astype(np.float64), to_np(port).astype(np.float64)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{what}: NaN pattern")
    np.testing.assert_allclose(a, b, rtol=0, atol=atol, equal_nan=True, err_msg=what)


def assert_extremes_near(ref_anom, ref_thr, port_thr, ref_ext, port_ext, doy_idx, near: float,
                         max_share: float = 1e-4, what: str = "extreme_events") -> int:
    """Extremes from anomalies that agree only within a tolerance: at most
    ``max_share`` of the cells differ, and at each the reference's anomaly
    lies within ``near`` of the reference's threshold or between the two
    packages' thresholds. ``*_thr`` are per (dayofyear, *spatial) when
    ``doy_idx`` (0-based, per time step) is given, else per point. Returns
    the count of differing cells."""
    a, re_, pe = to_np(ref_anom), to_np(ref_ext), to_np(port_ext)
    rt, pt = to_np(ref_thr), to_np(port_thr)
    if doy_idx is not None:
        rt, pt = rt[doy_idx], pt[doy_idx]
    else:
        rt, pt = np.broadcast_to(rt, a.shape), np.broadcast_to(pt, a.shape)
    diff = re_ != pe
    n = int(diff.sum())
    assert n <= max_share * diff.size, f"{what}: {n} of {diff.size} cells differ (limit {max_share:g})"
    av, rv, pv = a[diff].astype(np.float64), rt[diff].astype(np.float64), pt[diff].astype(np.float64)
    ok = (np.abs(av - rv) <= near) | ((av >= np.minimum(rv, pv)) & (av <= np.maximum(rv, pv)))
    assert ok.all(), f"{what}: differing cells far from the threshold: {list(zip(av[~ok], rv[~ok], pv[~ok]))[:5]}"
    return n


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module's tests, restored after: the small
    fields here gain nothing from more, and beside the other test workers'
    threads more only contend (a streamed run took 170 s with 8 threads and
    1 s with one, six such processes on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
