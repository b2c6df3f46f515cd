"""No-merge event labelling past the fused 3-D fixpoint's int32 limit: the
port's two-level route (per-slice labels, inter-slice edges on the device, a
host union-find, one remap), forced here by lowering
``marex_tpu_torch.track.TWO_LEVEL_CELLS``, against the port's fused route and
against ``marex_tpu``'s own two-level route (forced by its switch
``MAREX_TWO_LEVEL_CCL=1``). ``ID_field`` must be bit-identical to both, on a
global grid (periodic in x) and a regional one; edge cases: an event across
the seam, events joined only diagonally in time, an empty field, a single
slice, and ``identify_objects(time_connectivity=True)``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marex_tpu as ref
import marex_tpu_torch as port
import marex_tpu_torch.track as ptrack
from marex_tpu_torch.core.field import from_reference

from .torch_parity import assert_same, blob_field, bool_fields, one_torch_thread  # noqa: F401

H, W = 20, 32
WRAPS = [True, False]
WRAP_IDS = ["global", "regional"]


def _fields(data, wrap):
    ev, mask = bool_fields(data, np.ones(data.shape[1:], bool))
    if not wrap:  # the same grid read as a regional domain: no seam in x
        for f in (ev, mask):
            f.coords["lon"] = type(f.coords["lon"])(("lon",), np.linspace(-30.0, 40.0, data.shape[2]))
    return ev, mask


def _kw(wrap, **kw):
    kw = dict(R_fill=1, T_fill=2, area_filter_absolute=4, allow_merging=False, quiet=True, **kw)
    if not wrap:
        kw.update(regional_mode=True, coordinate_units="degrees")
    return kw


def _port_tracker(ev, mask, wrap, **kw):
    return port.tracker(from_reference(ev, "cpu"), from_reference(mask, "cpu"), device="cpu", **_kw(wrap, **kw))


@pytest.fixture
def ref_two_level(monkeypatch):
    """``marex_tpu``'s two-level route at any size, on its device path."""
    monkeypatch.setenv("MAREX_TWO_LEVEL_CCL", "1")
    monkeypatch.setenv("MAREX_HOST_CCL", "0")


@pytest.mark.parametrize("seed", [2, 9])
@pytest.mark.parametrize("wrap", WRAPS, ids=WRAP_IDS)
def test_run_matches_fused_and_reference(wrap, seed, ref_two_level, monkeypatch, one_torch_thread):  # noqa: F811
    """``tracker(allow_merging=False).run()`` end to end: the two-level route
    reuses the area filter's per-slice roots."""
    data = blob_field(seed, 40, H, W, 70, 4)
    ev, mask = _fields(data, wrap)
    fused_tr = _port_tracker(ev, mask, wrap)
    fused = fused_tr.run()
    assert "ccl3d/edges" not in fused_tr.stage_walls
    monkeypatch.setattr(ptrack, "TWO_LEVEL_CELLS", 1)
    two_tr = _port_tracker(ev, mask, wrap)
    two = two_tr.run()
    assert {"ccl3d/edges", "ccl3d/union", "ccl3d/remap"} <= set(two_tr.stage_walls)
    assert "ccl3d" not in two_tr.ccl_iterations, "the two-level route labels the slices once, in the area filter"
    r = ref.tracker(ev, mask, **_kw(wrap)).run()
    assert two.attrs["N_events_final"] > 1
    assert_same(fused["ID_field"].data, two["ID_field"].data, "two-level vs fused")
    assert_same(r["ID_field"].values, two["ID_field"].data, "two-level vs marex_tpu's two-level")
    assert two.attrs == fused.attrs == r.attrs


def _seam(T=4):
    """One event that crosses the lon seam: its cells at x = W - 1 at t and x
    = 0 at t + 1 (joined only through the periodic x), and one inside."""
    d = np.zeros((T, H, W), bool)
    d[0, 5:8, W - 3 : W] = True
    d[1, 5:8, 0:3] = True
    d[2, 5:8, 1:4] = True
    d[1:3, 12:15, 10:14] = True
    return d


def _diagonal(T=4):
    """Events joined only diagonally in time: (t, y, x) -> (t+1, y+1, x+1),
    and a chain that steps back across rows; plus one pair that only touches
    at a distance of 2 (not joined)."""
    d = np.zeros((T, H, W), bool)
    for t in range(T):
        d[t, 2 + t, 3 + t] = True
        d[t, 15 - t, 20 + (t % 2)] = True
    d[1, 10, 10] = True
    d[2, 12, 12] = True
    return d


def _speckle(T):
    return np.random.default_rng(4).random((T, H, W)) < 0.3


EDGE_CASES = {
    "seam": _seam,
    "diagonal": _diagonal,
    "empty": lambda: np.zeros((4, H, W), bool),
    "single_slice": lambda: _speckle(1),
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
@pytest.mark.parametrize("wrap", WRAPS, ids=WRAP_IDS)
def test_labelling_edge_cases(case, wrap, ref_two_level, monkeypatch):
    """The ``ccl3d`` stage alone (``run_tracking`` on a field given as it is)."""
    data = EDGE_CASES[case]()
    ev, mask = _fields(np.ones_like(data) if case == "empty" else data, wrap)  # a tracker needs an object to build
    p_tr = _port_tracker(ev, mask, wrap)
    fused, _, n_fused = p_tr.run_tracking(torch.from_numpy(data))
    monkeypatch.setattr(ptrack, "TWO_LEVEL_CELLS", 1)
    two, _, n_two = p_tr.run_tracking(torch.from_numpy(data))
    r_ds, _, n_ref = ref.tracker(ev, mask, **_kw(wrap)).run_tracking(jnp.asarray(data))
    assert n_two == n_fused == n_ref
    assert_same(fused["ID_field"].data, two["ID_field"].data, f"{case}: two-level vs fused")
    assert_same(r_ds["ID_field"].values, two["ID_field"].data, f"{case}: two-level vs marex_tpu")
    if case == "seam":
        assert n_two == (2 if wrap else 3)
    if case == "diagonal":
        assert n_two == 4
    if case == "empty":
        assert n_two == 0 and not bool(two["ID_field"].data.any())


@pytest.mark.parametrize("wrap", WRAPS, ids=WRAP_IDS)
def test_identify_objects_time_connected_by_both_routes(wrap, ref_two_level, monkeypatch):
    data = blob_field(5, 12, H, W, 30, 3)
    ev, mask = _fields(data, wrap)
    p_tr = _port_tracker(ev, mask, wrap)
    fused, _, n_fused = p_tr.identify_objects(from_reference(ev, "cpu"), time_connectivity=True)
    monkeypatch.setattr(ptrack, "TWO_LEVEL_CELLS", 1)
    two, _, n_two = p_tr.identify_objects(from_reference(ev, "cpu"), time_connectivity=True)
    r, _, n_ref = ref.tracker(ev, mask, **_kw(wrap)).identify_objects(ev, time_connectivity=True)
    assert n_two == n_fused == n_ref > 1
    assert_same(fused.data, two.data, "identify_objects: two-level vs fused")
    assert_same(r.values, two.data, "identify_objects: two-level vs marex_tpu")


def test_adjacency_edges_are_the_nine_shifts():
    """The edge set against a direct count of every 3x3x3 neighbour pair."""
    from marex_tpu_torch.ops.overlap import adjacency_edges

    rng = np.random.default_rng(8)
    lab = (rng.random((4, 7, 9)) < 0.35) * rng.integers(1, 20, (4, 7, 9))
    for wrap in (True, False):
        want = set()
        T, h, w = lab.shape
        for t in range(T - 1):
            for y in range(h):
                for x in range(w):
                    b = lab[t + 1, y, x]
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            yy, xx = y + dy, x + dx
                            if not 0 <= yy < h or not (wrap or 0 <= xx < w):
                                continue
                            a = lab[t, yy, xx % w]
                            if a and b:
                                want.add((int(a), int(b)))
        got = adjacency_edges(torch.from_numpy(lab.astype(np.int32)), 21, wrap).numpy()
        assert [tuple(e) for e in got] == sorted(want)
