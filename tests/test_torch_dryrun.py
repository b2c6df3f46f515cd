"""The port's ``dryrun_multichip`` against ``__graft_entry__.dryrun_multichip``.

Both run live, side by side, in subprocesses: the reference on 2 virtual CPU
devices (``JAX_PLATFORMS=cpu``), the port as ``dryrun_multichip(2,
device="cpu")``, which spawns 2 ``gloo`` ranks. The reference's line must
carry ``chip_smoke.DRYRUN_REFERENCE``, the counts that ``chip_smoke.py``
keeps. The port's line must carry ``chip_smoke.DRYRUN_PORT``: the
reference's mesh, shape, Hobday extremes and mesh events; on the grid drive
its own events and merges, because the drive's ``detrend_harmonic`` fit is
float64 in the port and float32 in the reference, which strays 1.1e-2 on
this 64-day series. The last test shows that this fit is the whole
difference: the reference's own tracker, fed the port's extremes, counts the
port's events and merges.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import marex_tpu as ref
import marex_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # chip_smoke.py

import chip_smoke  # noqa: E402

TIMEOUT_S = 240
REFERENCE = "import __graft_entry__ as g; g.dryrun_multichip(2)"
PORT = "from marex_tpu_torch.entry import dryrun_multichip; dryrun_multichip(2, device='cpu')"


def _start(code: str, **env) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            env={**os.environ, "PYTHONPATH": REPO, **env}, text=True)


def _line(proc: subprocess.Popen, what: str) -> str:
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"{what} did not end within {TIMEOUT_S} s")
    assert proc.returncode == 0, f"{what} failed:\n{out[-4000:]}"
    lines = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip OK: ")]
    assert len(lines) == 1, f"{what} printed {len(lines)} result lines:\n{out[-4000:]}"
    return lines[0]


@pytest.fixture(scope="module")
def lines():
    """The reference's and the port's lines, from runs made side by side."""
    procs = {"reference": _start(REFERENCE, JAX_PLATFORMS="cpu"), "port": _start(PORT, OMP_NUM_THREADS="2")}
    return {k: _line(p, k) for k, p in procs.items()}


def _head(line: str) -> str:
    """The mesh and the shape, before the counts."""
    return line.split(", n_events=")[0]


def test_reference_prints_chip_smokes_constants(lines):
    assert chip_smoke.dryrun_counts(lines["reference"]) == chip_smoke.DRYRUN_REFERENCE


def test_port_prints_the_reference_line(lines):
    """The same mesh and shape, the reference's counts on the drives whose
    detect agrees (shifting baseline + Hobday, the mesh), the port's own
    (``DRYRUN_PORT``) on the grid drive; the streamed tracker's events equal
    the in-memory ones in both."""
    assert _head(lines["port"]) == _head(lines["reference"])
    assert _head(lines["port"]) == "dryrun_multichip OK: mesh=OrderedDict({'time': 2, 'space': 1}), " \
                                   "preprocess_data+tracker.run on (64, 16, 32)"
    got, want = chip_smoke.dryrun_counts(lines["port"]), chip_smoke.dryrun_counts(lines["reference"])
    assert got == chip_smoke.DRYRUN_PORT
    for key in ("shifting+hobday extremes", "unstructured n_events"):
        assert got[key] == want[key], key
    assert got["streamed n_events"] == got["n_events"] and want["streamed n_events"] == want["n_events"]


def grid_drive():
    """The dry run's grid drive: its SST (seed 0, two converging warm blobs)
    and coordinates."""
    T, H, W = 64, 16, 32
    rng = np.random.default_rng(0)
    sst = 15.0 + 0.5 * rng.standard_normal((T, H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(T // 3, T // 3 + 16):
        k = t - T // 3
        for cx0, sgn in ((6, +1), (26, -1)):
            cx = (cx0 + sgn * k) % W
            dx = np.minimum(np.abs(xx - cx), W - np.abs(xx - cx))
            sst[t][(yy - H // 2) ** 2 + dx**2 <= 4**2] += 8.0
    coords = {"time": pd.date_range("2000-01-01", periods=T, freq="D").to_numpy(), "lat": np.linspace(-40, 40, H),
              "lon": np.linspace(0, 360, W, endpoint=False)}
    return sst, coords


def test_grid_drive_differs_by_the_detrend_fit_alone():
    """In one process: the port's anomalies sit within 5e-5 of a float64
    fit, the reference's 1e-2 from it; the reference's tracker counts
    ``DRYRUN_REFERENCE``'s events and merges on its own extremes and
    ``DRYRUN_PORT``'s on the port's, as the port's tracker does."""
    from marex_tpu_torch.core.timeaxis import decompose_time
    from marex_tpu_torch.ops.detrend import build_design_matrix

    sst, coords = grid_drive()
    dims = ("time", "lat", "lon")
    detect = dict(method_anomaly="detrend_harmonic", method_extreme="global_extreme", threshold_percentile=90,
                  quiet=True)
    track = dict(R_fill=2, T_fill=2, area_filter_quartile=0.25, allow_merging=True, nn_partitioning=True,
                 overlap_threshold=0.25, quiet=True)
    r_ds = ref.preprocess_data(ref.Field(sst, dims, coords, name="sst"), **detect)
    p_ds = port.preprocess_data(port.Field(sst, dims, coords, name="sst"), device="cpu", **detect)

    model, pmodel = build_design_matrix(decompose_time(coords["time"]), [1], True)
    x = sst.reshape(sst.shape[0], -1).astype(np.float64)
    oracle = x - model.T @ (pmodel.T @ x)
    oracle = (oracle - oracle.mean(axis=0)).reshape(sst.shape)
    assert np.abs(np.asarray(p_ds["dat_anomaly"].values) - oracle).max() < 5e-5
    assert np.abs(np.asarray(r_ds["dat_anomaly"].values) - oracle).max() > 1e-3

    mask = ref.Field(np.ones(sst.shape[1:], bool), ("lat", "lon"), {"lat": coords["lat"], "lon": coords["lon"]},
                     name="mask")
    for ds, want in ((r_ds, chip_smoke.DRYRUN_REFERENCE), (p_ds, chip_smoke.DRYRUN_PORT)):
        extremes = ref.Field(np.asarray(ds["extreme_events"].values), dims, coords, name="extreme_events")
        tr = ref.tracker(extremes, mask, **track)
        tr.use_scan_march = False  # the per-step march, which the port follows
        attrs = tr.run().attrs
        assert (attrs["N_events_final"], attrs["total_merges"]) == (want["n_events"], want["total_merges"])
    p_events = port.tracker(port.Field(np.asarray(p_ds["extreme_events"].values), dims, coords, name="extreme_events"),
                            port.Field(np.ones(sst.shape[1:], bool), ("lat", "lon"),
                                       {"lat": coords["lat"], "lon": coords["lon"]}, name="mask"),
                            device="cpu", **track).run()
    assert p_events.attrs["N_events_final"] == chip_smoke.DRYRUN_PORT["n_events"]
    assert p_events.attrs["total_merges"] == chip_smoke.DRYRUN_PORT["total_merges"]
