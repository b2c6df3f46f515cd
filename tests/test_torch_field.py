"""The port's ``Field`` surface against ``marex_tpu.Field`` on the same
arrays: selection, broadcasting, the operators, the reductions, the masking
utilities and the module functions. The port computes in torch on the
payload's device (tensors here, on the CPU; a numpy payload on the host and
back to numpy); integer and bool results must equal the reference's exactly,
float results within 1e-5 relative, with the same dtype, dims, coords, name
and attrs."""

import contextlib
import importlib.util
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import marex_tpu.core.field as rf
import marex_tpu_torch.core.field as pf
from marex_tpu.exceptions import DependencyError as RefDependencyError
from marex_tpu_torch.exceptions import DependencyError

T, H, W = 6, 4, 5
DIMS = ("time", "lat", "lon")
COORDS = {
    "time": pd.date_range("2001-01-01", periods=T, freq="D").to_numpy(),
    "lat": np.linspace(-30.0, 30.0, H),
    "lon": np.linspace(0.0, 288.0, W),
}
ATTRS = {"units": "K", "note": "seeded"}


def _payloads():
    rng = np.random.default_rng(11)
    f = rng.standard_normal((T, H, W)).astype(np.float32)
    f[rng.random(f.shape) < 0.15] = np.nan
    f[:, 0, 0] = np.nan  # an all-NaN series along time
    return {
        "bool": rng.random((T, H, W)) < 0.4,
        "int32": rng.integers(-50, 50, (T, H, W)).astype(np.int32),
        "float32": f,
    }


PAYLOADS = _payloads()
KINDS = list(PAYLOADS)
DIM_CASES = [None, "time", ("lat", "lon")]
DIM_IDS = ["all", "time", "lat-lon"]


def _pair(kind, tensor=True):
    x = PAYLOADS[kind]
    r = rf.Field(x, DIMS, COORDS, name=kind, attrs=ATTRS)
    p = pf.Field(torch.from_numpy(x.copy()) if tensor else x.copy(), DIMS, COORDS, name=kind, attrs=ATTRS)
    return r, p


def assert_fields(r, p, what=""):
    """Same dims, coords, name, attrs and dtype; integer and bool values
    exact, floats within 1e-5 relative with the same NaN pattern."""
    assert p.dims == r.dims, what
    assert p.name == r.name and p.attrs == r.attrs, what
    assert set(p.coords) == set(r.coords), what
    for k in r.coords:
        assert p.coords[k].dims == r.coords[k].dims, (what, k)
        np.testing.assert_array_equal(p.coords[k].values, r.coords[k].values, err_msg=f"{what}: coord {k}")
    a, b = np.asarray(r.values), p.values
    assert b.dtype == a.dtype, f"{what}: dtype {b.dtype} vs {a.dtype}"
    assert b.shape == a.shape, what
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=0, equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(b, a, err_msg=what)


REDUCTIONS = {
    "sum": lambda f, d: f.sum(d),
    "nansum": lambda f, d: f.sum(d, skipna=True),
    "mean": lambda f, d: f.mean(d),
    "mean_keepnan": lambda f, d: f.mean(d, skipna=False),
    "std": lambda f, d: f.std(d),
    "max": lambda f, d: f.max(d),
    "min": lambda f, d: f.min(d),
    "any": lambda f, d: f.any(d),
    "all": lambda f, d: f.all(d),
    "count": lambda f, d: f.count(d),
    "quantile": lambda f, d: f.quantile(0.3, d),
}


# np.nanquantile refuses bool payloads, so the reference has no bool quantile
REDUCTION_CASES = [(n, k) for n in REDUCTIONS for k in KINDS if (n, k) != ("quantile", "bool")]


@contextlib.contextmanager
def _quiet():
    """Silence numpy's warnings for all-NaN slices in the reference."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("dim", DIM_CASES, ids=DIM_IDS)
@pytest.mark.parametrize("name,kind", REDUCTION_CASES)
def test_reductions_match(name, kind, dim):
    r, p = _pair(kind)
    with _quiet():
        want = REDUCTIONS[name](r, dim)
    got = REDUCTIONS[name](p, dim)
    assert isinstance(got.data, torch.Tensor), "a tensor payload's reduction stays a tensor"
    assert_fields(want, got, f"{name} {kind} {dim}")


@pytest.mark.parametrize("kind", KINDS)
def test_argmax_matches(kind):
    r, p = _pair(kind)
    assert_fields(r.argmax(None), p.argmax(None), f"argmax {kind}")
    # one dim: the reference hands numpy a tuple axis and raises; hold the
    # port against numpy's own argmax over that axis
    got = p.argmax("time")
    assert got.dims == ("lat", "lon")
    np.testing.assert_array_equal(got.values, np.argmax(PAYLOADS[kind], axis=0))


@pytest.mark.parametrize("kind", KINDS)
def test_numpy_payload_stays_numpy(kind):
    r, p = _pair(kind, tensor=False)
    with _quiet():
        want = r.max("time")
    got = p.max("time")
    assert isinstance(got.data, np.ndarray)
    assert_fields(want, got, f"numpy payload max {kind}")
    assert isinstance((p > 0).data, np.ndarray)


OPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "truediv": lambda a, b: a / b,
    "pow": lambda a, b: a**b,
    "ge": lambda a, b: a >= b,
    "gt": lambda a, b: a > b,
    "le": lambda a, b: a <= b,
    "lt": lambda a, b: a < b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}


# an int32 payload to the float powers of another field overflows in both,
# and neither package has a reflected power
OP_CASES = [(op, kind, other) for op in OPS for kind in ("int32", "float32")
            for other in ("field", "scalar", "float_scalar", "reflexive", "aligned")
            if not (op == "pow" and (other == "reflexive" or kind == "int32" and other in ("field", "aligned")))]


@pytest.mark.parametrize("op,kind,other", OP_CASES)
def test_operators_match(op, kind, other):
    r, p = _pair(kind)
    fn = OPS[op]
    if other == "field":
        r2, p2 = _pair("float32" if kind == "int32" else "int32")
        r2, p2 = r2.rename("b"), p2.rename("b")
        args_r, args_p = (r, r2), (p, p2)
    elif other == "aligned":  # a (lon, lat) field: aligned by name, broadcast over time
        y = np.abs(PAYLOADS["float32"][1].T) + 1.0
        r2 = rf.Field(np.nan_to_num(y, nan=2.0), ("lon", "lat"), {"lat": COORDS["lat"], "lon": COORDS["lon"]})
        p2 = pf.Field(torch.from_numpy(r2.values.copy()), ("lon", "lat"), {"lat": COORDS["lat"], "lon": COORDS["lon"]})
        args_r, args_p = (r, r2), (p, p2)
    elif other == "scalar":
        args_r, args_p = (r, 2), (p, 2)
    elif other == "float_scalar":
        args_r, args_p = (r, 1.5), (p, 1.5)
    else:
        args_r, args_p = (3, r), (3, p)
    with np.errstate(all="ignore"):
        want = fn(*args_r)
    got = fn(*args_p)
    assert_fields(want, got, f"{op} {kind} {other}")


@pytest.mark.parametrize("op", ["and", "or", "invert", "neg"])
def test_logical_and_unary_match(op):
    r, p = _pair("bool")
    r2, p2 = _pair("bool")
    r2 = rf.Field(~r2.values, DIMS, COORDS, name="b")
    p2 = pf.Field(torch.from_numpy(r2.values.copy()), DIMS, COORDS, name="b")
    fns = {"and": lambda a, b: a & b, "or": lambda a, b: a | b, "invert": lambda a, b: ~a, "neg": lambda a, b: -a}
    if op == "neg":
        r, p = _pair("float32")
    assert_fields(fns[op](r, r2), fns[op](p, p2), op)


@pytest.mark.parametrize("kind", KINDS)
def test_masking_utilities_match(kind):
    r, p = _pair(kind)
    cond = PAYLOADS["int32"] > 0
    rc = rf.Field(cond, DIMS, COORDS)
    pc = pf.Field(torch.from_numpy(cond.copy()), DIMS, COORDS)
    assert_fields(r.where(rc), p.where(pc), "where nan")
    assert_fields(r.where(rc, 0), p.where(pc, 0), "where 0")
    assert_fields(r.where(cond), p.where(torch.from_numpy(cond)), "where array")
    assert_fields(r.isnull(), p.isnull(), "isnull")
    assert_fields(r.notnull(), p.notnull(), "notnull")
    assert_fields(r.pad_dim("lon", 2), p.pad_dim("lon", 2), "pad constant")
    for mode in ("edge", "wrap", "reflect", "symmetric"):
        assert_fields(r.pad_dim("time", 3, mode=mode), p.pad_dim("time", 3, mode=mode), f"pad {mode}")
    if kind != "bool":
        vals = [1, 2, -3, 7]
        assert_fields(r.isin(vals), p.isin(vals), "isin")
        assert_fields(r.fillna(-9), p.fillna(-9), "fillna")
        assert_fields(r.clip(-0.5, 0.5), p.clip(-0.5, 0.5), "clip float")
        assert_fields(r.clip(-3, None), p.clip(-3, None), "clip lo")
        fill = np.nan if kind == "float32" else -1
        assert_fields(r.shift(time=2, fill_value=fill), p.shift(time=2, fill_value=fill), "shift +")
        assert_fields(r.shift({"lon": -1, "lat": 1}, fill_value=fill), p.shift({"lon": -1, "lat": 1}, fill_value=fill),
                      "shift two dims")


@pytest.mark.parametrize("kind", ["int32", "float32"])
@pytest.mark.parametrize("shifts", [{"time": 6}, {"time": 7}, {"time": -9}, {"lon": -5, "lat": 100}],
                         ids=["time=T", "time=T+1", "time=-T-3", "lon,lat past"])
def test_shift_past_the_axis_matches(kind, shifts):
    r, p = _pair(kind)
    fill = np.nan if kind == "float32" else -1
    assert_fields(r.shift(shifts, fill_value=fill), p.shift(shifts, fill_value=fill), f"shift {shifts}")


def test_where_drop_on_a_series():
    x = PAYLOADS["float32"][:, 1, 2]
    r = rf.Field(x, ("time",), {"time": COORDS["time"]}, name="s")
    p = pf.Field(torch.from_numpy(x.copy()), ("time",), {"time": COORDS["time"]}, name="s")
    keep = np.array([True, False, True, True, False, True])
    assert_fields(r.where(keep, drop=True), p.where(torch.from_numpy(keep), drop=True), "where drop")


def test_selection_and_shape_helpers_match():
    r, p = _pair("float32")
    assert_fields(r.sel(lat=COORDS["lat"][2]), p.sel(lat=COORDS["lat"][2]), "sel scalar")
    assert_fields(r.sel(lon=COORDS["lon"][[3, 1]]), p.sel(lon=COORDS["lon"][[3, 1]]), "sel list")
    t0, t1 = COORDS["time"][1], COORDS["time"][4]
    assert_fields(r.sel(time=slice(t0, t1)), p.sel(time=slice(t0, t1)), "sel slice")
    assert_fields(r.sel(lat=-29.0, method="nearest"), p.sel(lat=-29.0, method="nearest"), "sel nearest")
    with pytest.raises(KeyError):
        p.sel(lat=123.0)
    one_r, one_p = r.isel(time=[2]), p.isel(time=[2])
    assert_fields(one_r.squeeze(), one_p.squeeze(), "squeeze")
    assert_fields(one_r.squeeze("time"), one_p.squeeze("time"), "squeeze dim")
    assert_fields(r.expand_dims({"member": 3}), p.expand_dims({"member": 3}), "expand_dims")
    assert_fields(r.expand_dims("member"), p.expand_dims("member"), "expand_dims one")
    assert_fields(r.stack_spatial(["lat", "lon"]), p.stack_spatial(["lat", "lon"]), "stack_spatial")
    small_r = rf.Field(PAYLOADS["int32"][0, :, 0], ("lat",), {"lat": COORDS["lat"]}, name="row")
    small_p = pf.Field(torch.from_numpy(small_r.values.copy()), ("lat",), {"lat": COORDS["lat"]}, name="row")
    assert_fields(small_r.broadcast_like(r), small_p.broadcast_like(p), "broadcast_like")
    ra, rb = rf.broadcast(small_r, r)
    pa, pb = pf.broadcast(small_p, p)
    assert_fields(ra, pa, "broadcast a")
    assert_fields(rb, pb, "broadcast b")


@pytest.mark.parametrize("kind", KINDS)
def test_module_functions_match(kind):
    r, p = _pair(kind)
    assert_fields(rf.ones_like(r), pf.ones_like(p), "ones_like")
    assert_fields(rf.zeros_like(r, np.float32), pf.zeros_like(p, np.float32), "zeros_like")
    assert_fields(rf.full_like(r, 7, np.int32), pf.full_like(p, 7, np.int32), "full_like")
    assert_fields(rf.isfinite(r), pf.isfinite(p), "isfinite")
    assert pf.ones_like(p).data.device == p.data.device


def test_dt_accessor_matches():
    r = rf.Field(COORDS["time"], ("time",), {"time": COORDS["time"]}, name="time")
    p = pf.Field(COORDS["time"], ("time",), {"time": COORDS["time"]}, name="time")
    for part in ("year", "month", "day", "dayofyear"):
        assert_fields(getattr(r.dt, part), getattr(p.dt, part), part)


def test_to_xarray_and_to_device():
    r, p = _pair("float32")
    if importlib.util.find_spec("xarray") is not None:
        np.testing.assert_array_equal(p.to_xarray().values, r.to_xarray().values)
    else:
        with pytest.raises(RefDependencyError):
            r.to_xarray()
        with pytest.raises(DependencyError):
            p.to_xarray()
        with pytest.raises(DependencyError):
            pf.FieldSet({"a": p}).to_xarray()
    moved = pf.Field(PAYLOADS["int32"], DIMS, COORDS, name="n").to_device("cpu")
    assert isinstance(moved.data, torch.Tensor) and moved.data.device.type == "cpu"
    np.testing.assert_array_equal(moved.values, PAYLOADS["int32"])
