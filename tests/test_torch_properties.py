"""Object properties of the PyTorch port against ``marex_tpu.ops.properties``:
areas and periodic centroids per label (pixel counts and cell weights, wrap
on and off, objects across the x seam inside EDGE_ZONE), the batched mask
props of the merge march, the (time, ID) table of original ids (both
reference branches) and the pixel -> coordinate interpolation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marex_tpu.ops import label as ref_label
from marex_tpu.ops import properties as ref_props
from marex_tpu_torch.ops import properties as port_props

from .torch_parity import assert_same, blob_field


def assert_equal_nan(ref, port, what=""):
    a, b = np.asarray(ref), port.cpu().numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, f"{what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _dense_labels(T, H, W, seed):
    """Per-slice dense labels of random disks plus an object across the x
    seam (columns 0-1 and W-2..W-1, inside both edge zones)."""
    data = blob_field(seed, T, H, W, 40, 6)
    data[:, 2:6, :3] = True
    data[:, 2:6, W - 3 :] = True
    labels, counts = ref_label.label_slices_grid(jnp.asarray(data))
    return np.array(labels), int(np.asarray(counts).max())


@pytest.mark.parametrize("W", [48, 256], ids=["W48", "W256"])
@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "nowrap"])
@pytest.mark.parametrize("weighted", [False, True], ids=["pixels", "weights"])
def test_grid_label_props_matches(W, wrap, weighted):
    labels, n = _dense_labels(5, 24, W, seed=W)
    weights = None
    if weighted:
        weights = np.random.default_rng(1).uniform(500.0, 800.0, (24, W)).astype(np.float32)
    r = ref_props.grid_label_props(jnp.asarray(labels), n, wrap, None if weights is None else jnp.asarray(weights))
    p = port_props.grid_label_props(torch.from_numpy(labels), n, wrap,
                                    None if weights is None else torch.from_numpy(weights))
    for name, a, b in zip(("areas", "cy", "cx"), r, p):
        if weighted:
            # the reference sums float32 products in float32, the port in
            # float64: cx of a wrapped object subtracts W * cnt_right from
            # sum_x, which leaves the reference a few float32 ulp of W off
            # (ulp(256) = 3e-5 pixels)
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5, atol=1e-4, err_msg=name)
            np.testing.assert_array_equal(np.isnan(np.asarray(a)), np.isnan(b.numpy()), err_msg=name)
        else:
            assert_equal_nan(a, b, name)
    if weighted:  # and the port is within float32 rounding of a float64 oracle
        t, k = 2, 1
        m = labels[t] == k
        w = weights.astype(np.float64)[m]
        y, x = np.nonzero(m)
        shift = W if wrap and (x < 100).any() and (x >= W - 100).any() else 0
        cx = (w * np.where(x > W / 2, x - shift, x)).sum() / w.sum()
        np.testing.assert_allclose(p[1][t, k].item(), (w * y).sum() / w.sum(), rtol=1e-6)
        np.testing.assert_allclose(p[2][t, k].item(), cx + W if cx < 0 else cx, rtol=1e-6)
    # the seam object really wraps: its x centroid lies near the seam
    cx = p[2].numpy()
    if wrap:
        assert np.nanmax(cx) > W - 3 or np.nanmin(cx) < 2


@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "nowrap"])
def test_grid_mask_props_batched_matches(wrap):
    rng = np.random.default_rng(5)
    H, W = 20, 230
    masks = rng.random((2, 7, H, W)) < 0.02
    masks[0, 0] = False  # an empty mask gives (0, 0, 0)
    masks[1, 2, 4:9, :2] = True  # across the seam, inside both edge zones
    masks[1, 2, 4:9, W - 2 :] = True
    masks[1, 3, :, 100:130] = True  # between the edge zones
    r = jax.vmap(jax.vmap(lambda m: ref_props.grid_mask_props(m, wrap)))(jnp.asarray(masks))
    p = port_props.grid_mask_props(torch.from_numpy(masks), wrap)
    assert_equal_nan(r, p, "mask props")


@pytest.mark.parametrize("n_events", [7, 90], ids=["le64", "gt64"])
def test_event_global_id_lookup_matches(n_events):
    rng = np.random.default_rng(n_events)
    T, H, W = 6, 16, 40
    n_old = 300
    old = rng.integers(0, n_old + 1, (T, H, W)).astype(np.int32)
    old[rng.random(old.shape) < 0.4] = 0
    lookup = np.zeros(n_old + 2, np.int32)
    lookup[1:] = rng.integers(1, n_events + 1, n_old + 1)
    r = ref_props.event_global_id_lookup(jnp.asarray(old), jnp.asarray(lookup), n_events)
    p = port_props.event_global_id_lookup(torch.from_numpy(old), torch.from_numpy(lookup), n_events)
    assert_same(r, p, "global id table")


def test_interp_coord_matches():
    coords = np.linspace(-89.5, 89.5, 37).astype(np.float32) ** 3 / 8000.0  # non-uniform spacing
    pix = np.array([[-3.0, 0.0, 0.25, 1.5, 17.9, 35.999, 36.0, 40.0, np.nan]], np.float32)
    pix = np.concatenate([pix, np.random.default_rng(0).uniform(-1, 37, (3, 9)).astype(np.float32)])
    r = ref_props.interp_coord(jnp.asarray(pix), jnp.asarray(coords))
    p = port_props.interp_coord(torch.from_numpy(pix), torch.from_numpy(coords))
    assert_equal_nan(r, p, "interp")
