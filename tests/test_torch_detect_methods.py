"""Every detect method of the PyTorch port through ``preprocess_data``
against ``marex_tpu``, on a small drive (3 yr x 8 x 16; the other files
run the verify size): each anomaly method with each extreme method and each
percentile method, and ``std_normalise``.

Tolerances, by anomaly method (``tests/test_torch_climatology.py`` and
``tests/test_torch_detrend.py`` give the reasons): ``dat_anomaly`` within
1e-5 (fixed baseline), 1e-4 (both detrended methods) or 5e-4 (shifting
baseline) of the reference, with the NaN pattern identical. From the fixed
baseline's anomalies the thresholds agree within 1e-6 and the extremes bit
for bit. Otherwise approximate thresholds differ by at most one bin in at
most 2 % of the cells, exact ones by at most the anomaly tolerance, and
extremes in at most 1e-4 of the cells, each near its threshold. Masks,
dims and attrs are equal.
"""

import numpy as np
import pytest

import marex_tpu as ref
import marex_tpu_torch as port
from marex_tpu_torch.core.field import from_reference
from marex_tpu_torch.core.timeaxis import decompose_time

from .torch_parity import assert_close, assert_extremes_near, assert_same, drive_sst, to_np

ANOMALY_ATOL = {"fixed_baseline": 1e-5, "detrend_harmonic": 1e-4, "detrend_fixed_baseline": 1e-4,
                "shifting_baseline": 5e-4}
CASES = [
    dict(method_anomaly=a, method_extreme=e, method_percentile=p)
    for a in ANOMALY_ATOL
    for e in ("global_extreme", "hobday_extreme")
    for p in ("approximate", "exact")
] + [dict(method_anomaly="detrend_harmonic", method_extreme="hobday_extreme", method_percentile="approximate",
          std_normalise=True)]


@pytest.fixture(scope="module")
def sst():
    return drive_sst(ny=8, nx=16)


def _check_extremes(r, p, suffix: str, anom_key: str, tol: float, exact: bool, hobday: bool) -> None:
    r_thr, p_thr = r["thresholds" + suffix].values, to_np(p["thresholds" + suffix].data)
    r_ext, p_ext = r["extreme_events" + suffix].values, p["extreme_events" + suffix].data
    if tol <= 1e-5:  # the fixed baseline: the Hobday and global stages see the same anomalies
        assert_close(r_thr, p_thr, atol=1e-6, what="thresholds" + suffix)
        assert_same(r_ext, p_ext, "extreme_events" + suffix)
        return
    np.testing.assert_array_equal(np.isnan(r_thr), np.isnan(p_thr))
    d = np.abs(r_thr.astype(np.float64) - p_thr)[np.isfinite(r_thr)]
    if exact:
        assert d.max() <= tol, d.max()
    else:
        assert d.max() <= 0.01 * (1 + 1e-4) and (d > 1e-6).mean() <= 0.02, (d.max(), (d > 1e-6).mean())
    doy = decompose_time(r.coords["time"].values).dayofyear - 1 if hobday else None
    assert_extremes_near(r[anom_key].values, r_thr, p_thr, r_ext, p_ext, doy, near=tol, what="extreme_events" + suffix)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(str(v) for v in c.values()))
def test_preprocess_method_matches(sst, case):
    kw = dict(case, window_year_baseline=2, quiet=True)
    r = ref.preprocess_data(sst, **kw)
    p = port.preprocess_data(from_reference(sst, "cpu"), device="cpu", **kw)
    assert sorted(p.data_vars) == sorted(r.data_vars)
    assert p.attrs == r.attrs
    for name in r.data_vars:
        assert p[name].dims == r[name].dims, name
    assert_same(r["mask"].values, p["mask"].data, "mask")
    tol = ANOMALY_ATOL[case["method_anomaly"]]
    assert_close(r["dat_anomaly"].values, p["dat_anomaly"].data, atol=tol, what="dat_anomaly")
    exact, hobday = case["method_percentile"] == "exact", case["method_extreme"] == "hobday_extreme"
    _check_extremes(r, p, "", "dat_anomaly", tol, exact, hobday)
    if case.get("std_normalise"):
        assert_close(r["dat_stn"].values, p["dat_stn"].data, atol=tol, what="dat_stn")
        _check_extremes(r, p, "_stn", "dat_stn", tol, exact, hobday)
