"""Child partitioning of the PyTorch port against ``marex_tpu.ops.partition``
on seeded numpy inputs: the periodic row distance, the exact EDT (against the
reference's full one, and against its row-windowed one within the window),
nearest-cell and nearest-centroid assignment, the batched partition of all
merging children of a step (with each piece's props; edge cases: an empty
parent mask, an invalid parent slot, an inactive child slot, a cap of 0, ten
parents with one across the seam, with and without wrap) and the
consolidation relabel. Integer outputs are bit-identical and float32 props
equal exactly. On the CPU the port runs its plain versions, which the CUDA
kernel is held against on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marex_tpu.ops import label as ref_label
from marex_tpu.ops import partition as ref_part
from marex_tpu_torch.ops import partition as port_part

from .torch_parity import assert_same, blob_field, partition_inputs

H, W = 40, 120


def _masks(seed, n, density=0.004):
    rng = np.random.default_rng(seed)
    m = rng.random((n, H, W)) < density
    m[0, 5:9, :3] = True  # across the seam
    m[0, 5:9, W - 2 :] = True
    m[-1] = False  # an empty mask
    return m


def _cents(seed, n):
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(0, H - 1, n), rng.uniform(0, W - 1, n)], axis=-1).astype(np.float32)
    c[0] = (3.5, 0.25)  # near the seam: the wrapped distance decides
    return c


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "nowrap"])
def test_row_distance_matches(wrap):
    m = _masks(0, 4, density=0.02)
    m[1, 3] = False  # an empty row
    m[1, 4] = False
    m[1, 4, 7] = True  # a row with one cell
    assert_same(ref_part._row_distance_periodic(jnp.asarray(m), wrap), port_part._row_distance_periodic(_t(m), wrap))


@pytest.mark.parametrize("row_window", [0, 6], ids=["full", "window6"])
@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "nowrap"])
def test_edt_matches(wrap, row_window):
    """The port's EDT is exact everywhere: equal to the reference's full one,
    and to its row-windowed one wherever that is exact (within the window)."""
    m = _masks(1, 4)
    r = np.asarray(ref_part.euclidean_distance_transform_grid(jnp.asarray(m), wrap, row_window))
    p = port_part.euclidean_distance_transform_grid(_t(m), wrap).numpy()
    if row_window:
        near = r <= row_window**2
        assert near.any() and not near.all()
        r, p = r[near], p[near]
    assert_same(r, p, "squared distances")


@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "nowrap"])
def test_centroid_assign_matches(wrap):
    cents = _cents(2, 5)
    valid = np.array([True, True, False, True, True])
    r = ref_part.centroid_assign_grid(jnp.asarray(cents), jnp.asarray(valid), jnp.zeros((H, W)), wrap)
    p = port_part.centroid_assign_grid(_t(cents), _t(valid), (H, W), wrap)
    assert_same(r, p, "centroid assignment")


@pytest.mark.parametrize("row_window", [0, 8], ids=["full", "window8"])
@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "nowrap"])
def test_partition_nn_matches(wrap, row_window):
    """The exact EDT capped at 6 gives the reference's assignment everywhere,
    against its full EDT and against its EDT windowed at 8 rows (>= the cap)."""
    pm = _masks(3, 4, density=0.01)
    child = np.random.default_rng(4).random((H, W)) < 0.5
    valid = np.array([True, True, True, False])
    cents = _cents(5, 4)
    mdist = np.float32(6.0)  # small: many cells fall back to the centroids
    r = ref_part.partition_nn_grid(jnp.asarray(child), jnp.asarray(pm), jnp.asarray(valid), jnp.asarray(cents),
                                   jnp.asarray(mdist), wrap, row_window)
    p = port_part.partition_nn_grid(_t(child), _t(pm), _t(valid), _t(cents), torch.tensor(mdist), wrap)
    assert_same(r, p, "nearest-cell assignment")


def _slices(seed):
    """Two consecutive per-slice label slices from a blob field."""
    data = blob_field(seed, 2, H, W, 30, 7)
    data[1] |= data[0]
    labels, _ = ref_label.label_slices_grid(jnp.asarray(data))
    labels = np.array(labels)
    labels[1] = np.where(labels[1] > 0, labels[1] + 100, 0)  # ids unique across the two slices
    return labels[0], labels[1]


@pytest.mark.parametrize("nn", [True, False], ids=["nn", "centroid"])
def test_partition_children_batched_matches(nn):
    prev, cur = _slices(6)
    cur_ids = np.unique(cur[cur > 0])[:3]
    prev_ids = np.unique(prev[prev > 0])
    rng = np.random.default_rng(7)
    K, P = 4, 3
    child = np.zeros(K, np.int32)
    child[:3] = cur_ids
    pids = np.zeros((K, P), np.int32)
    valid = np.zeros((K, P), bool)
    for k, n in enumerate([3, 2, 2]):
        pids[k, :n] = rng.choice(prev_ids, n, replace=False)
        valid[k, :n] = True
    piece = np.where(valid, 500 + np.arange(K * P).reshape(K, P), 0).astype(np.int32)
    piece[:3, 0] = child[:3]
    cents = rng.uniform([0, 0], [H - 1, W - 1], (K, P, 2)).astype(np.float32)
    mdist = np.array([5.0, 40.0, 12.0, 0.0], np.float32)
    args = (child, piece, pids, valid, cents, mdist)
    r_cur, r_props = ref_part.partition_children_grid_batched(
        jnp.asarray(prev), jnp.asarray(cur), *map(jnp.asarray, args), nn, True, 0
    )
    p_cur, p_props = port_part.partition_children_grid_batched(_t(prev), _t(cur), *map(_t, args), nn, True)
    assert_same(r_cur, p_cur, "partitioned slice")
    np.testing.assert_array_equal(np.asarray(r_props), p_props.numpy())
    assert (p_cur.numpy() >= 500).any()  # pieces were written


@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "nowrap"])
@pytest.mark.parametrize(
    "case, K, P, cap, edge",
    [("edge", 4, 3, 12.0, True), ("cap0", 3, 3, 0.0, False), ("ten_parents", 2, 10, 40.0, True)],
    ids=["edge", "cap0", "ten_parents"],
)
def test_partition_children_batched_cases(case, K, P, cap, edge, wrap):
    """Nearest-cell partitioning of a batch against the reference: an empty
    parent mask, an invalid slot and an inactive child slot (``edge``); a cap
    of 0, so only cells on a parent cell are reached and the rest fall back to
    the centroids; ten parents (the tracker's limit), the first across the
    seam; each with and without wrap."""
    prev, cur, args = partition_inputs(11, H, W, K, P, cap, edge)
    r_cur, r_props = ref_part.partition_children_grid_batched(
        jnp.asarray(prev), jnp.asarray(cur), *map(jnp.asarray, args), True, wrap, 0
    )
    p_cur, p_props = port_part.partition_children_grid_batched(_t(prev), _t(cur), *map(_t, args), True, wrap)
    assert_same(r_cur, p_cur, f"{case} partitioned slice")
    np.testing.assert_array_equal(np.asarray(r_props), p_props.numpy())
    n_pieces = (p_props.numpy()[..., 0] > 0).sum(axis=1)
    assert (n_pieces[: K - 1] >= 2).all(), n_pieces  # the children were cut
    if edge and K > 1:
        assert not p_props.numpy()[K - 1].any()  # the inactive slot


def test_partition_kernel_argument_checks():
    """The kernel's wrapper raises on what the kernel does not take."""
    prev, cur, args = partition_inputs(12, H, W, 2, 3, 40.0)
    t = [_t(x) for x in args]
    port_part._check_partition_args(_t(prev), _t(cur), *t)
    bad = {
        "child_ids": t[0].long(),
        "parent_ids": t[2].long(),
        "parent_cents": t[4].transpose(1, 2).contiguous(),
        "max_dist": t[5].double(),
        "piece_ids": _t(np.ascontiguousarray(np.tile(args[1], (1, 2))))[:, ::2],
    }
    for name, x in bad.items():
        u = list(t)
        u[["child_ids", "piece_ids", "parent_ids", "parent_valid", "parent_cents", "max_dist"].index(name)] = x
        with pytest.raises(ValueError, match=name):
            port_part._check_partition_args(_t(prev), _t(cur), *u)
    with pytest.raises(ValueError, match="prev_labels"):
        port_part._check_partition_args(_t(prev[:, :-1]), _t(cur), *t)
    none = [torch.zeros((2, 0), dtype=torch.int32), torch.zeros((2, 0), dtype=torch.int32),
            torch.zeros((2, 0), dtype=torch.bool), torch.zeros((2, 0, 2))]
    with pytest.raises(ValueError, match="parent slot"):
        port_part._check_partition_args(_t(prev), _t(cur), t[0], *none, t[5])


def test_relabel_and_props_matches():
    prev, _ = _slices(8)
    ids = np.unique(prev[prev > 0])
    olds = np.array([ids[1], ids[2], ids[4], 0], np.int32)
    news = np.array([ids[0], ids[0], ids[3], 0], np.int32)
    targets = np.array([ids[0], ids[3], ids[5], 0], np.int32)
    r_out, r_props = ref_part.relabel_and_props_slice(jnp.asarray(prev), jnp.asarray(olds), jnp.asarray(news),
                                                      jnp.asarray(targets), True)
    p_out, p_props = port_part.relabel_and_props_slice(_t(prev), olds, news, _t(targets), True)
    assert_same(r_out, p_out, "relabelled slice")
    np.testing.assert_array_equal(np.asarray(r_props), p_props.numpy())
    # relabel_values_slice alone
    assert_same(ref_part.relabel_values_slice(jnp.asarray(prev), jnp.asarray(olds), jnp.asarray(news)),
                port_part.relabel_values_slice(_t(prev), olds, news), "renames")
