"""The mesh CCL kernels of the PyTorch port (``ops/graph_step.py``) on the
CPU, where they run their plain versions: the neighbour min against the
reference's gather-min; the step over the list of active cells against the
dense step (hook, stale ``out``, flag) and the jump over the list against
the whole-field jump; the list and the 64-bit split of its flat indices; and
the fixpoint built on them against ``marex_tpu``'s
``label_slices_unstructured`` and a ``scipy.sparse.csgraph`` oracle, on
symmetric and asymmetric tables and on a renumbered mesh."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

import marex_tpu_torch as port
from marex_tpu.ops import label as ref_label
from marex_tpu.track import _symmetrize_neighbours as ref_symmetrize
from marex_tpu_torch.ops import label as port_label
from marex_tpu_torch.ops import graph_step as port_graph_step
from marex_tpu_torch.ops.graph_step import (
    active_cells,
    graph_jump,
    graph_jump_plain,
    graph_step,
    graph_step_active_plain,
    graph_step_plain,
    neighbour_min_plain,
    split_flat,
)
from marex_tpu_torch.ops.min_stencil import BIG, hook_plain, pointer_jump_plain
from marex_tpu_torch.track import _symmetrize_neighbours

from .conftest import make_unstructured_mesh
from .torch_parity import assert_same, tri_mesh


def random_table(C: int, K: int, seed: int, missing: float = 0.3) -> np.ndarray:
    """A directed (K, C) 0-based table with -1 entries: asymmetric on purpose."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, C, (K, C)).astype(np.int32)
    nb[rng.random((K, C)) < missing] = -1
    return nb


def tables():
    """(name, symmetrised (K', C) table): a Delaunay mesh, the periodic
    triangle-pair mesh, and two random directed tables (K' > 3, ragged C)."""
    _, _, nb, _ = make_unstructured_mesh(n_side=12)
    yield "delaunay", ref_symmetrize(nb.astype(np.int32) - 1)
    yield "tri_mesh", ref_symmetrize(tri_mesh(800)[0] - 1)
    yield "random_k3", ref_symmetrize(random_table(301, 3, 1))
    yield "random_k2_sparse", ref_symmetrize(random_table(777, 2, 2, missing=0.6))


TABLES = dict(tables())


def oracle_labels(data: np.ndarray, sym: np.ndarray) -> np.ndarray:
    """Per-slice dense labels by scipy: components of the active subgraph,
    numbered in ascending order of their minimum cell index."""
    T, C = data.shape
    out = np.zeros((T, C), np.int32)
    src = np.repeat(np.arange(C)[None], sym.shape[0], 0)[sym >= 0]
    dst = sym[sym >= 0]
    for t in range(T):
        on = data[t][src] & data[t][dst]
        graph = coo_matrix((np.ones(on.sum()), (src[on], dst[on])), shape=(C, C))
        _, comp = connected_components(graph, directed=False)
        cells = np.nonzero(data[t])[0]
        _, first = np.unique(comp[cells], return_index=True)  # first (lowest) cell of each component
        rank = {comp[cells[i]]: r + 1 for r, i in enumerate(np.sort(first))}
        out[t, cells] = [rank[c] for c in comp[cells]]
    return out


def test_symmetrize_matches_reference():
    for nb in (random_table(200, 3, 5), random_table(64, 4, 6, missing=0.8), tri_mesh(200)[0] - 1):
        np.testing.assert_array_equal(_symmetrize_neighbours(nb), ref_symmetrize(nb))
    assert ref_symmetrize(random_table(301, 3, 1)).shape[0] > 3


@pytest.mark.parametrize("name", list(TABLES))
def test_neighbour_min_matches_reference_gather_min(name):
    sym = TABLES[name]
    C = sym.shape[1]
    rng = np.random.default_rng(3)
    data = rng.random((5, C)) < 0.6
    lab = np.where(data, rng.integers(0, C, (5, C)), BIG).astype(np.int32)
    g = jnp.where(jnp.asarray(sym >= 0)[None], jnp.asarray(lab)[:, np.maximum(sym, 0)], BIG)  # the reference's step
    want = jnp.where(jnp.asarray(data), jnp.minimum(jnp.asarray(lab), g.min(axis=1)), BIG)
    got = neighbour_min_plain(torch.from_numpy(lab), torch.from_numpy(data), torch.from_numpy(sym))
    assert_same(want, got, "neighbour min")


@pytest.mark.parametrize("stale", [False, True], ids=["out_big", "out_stale"])
@pytest.mark.parametrize("name", list(TABLES))
def test_step_is_min_hook_and_flag(name, stale):
    """``out`` ends as ``hook_plain(lab, m)`` from a BIG-filled or a stale
    ``out >= m``, and the flag says whether any active label fell."""
    sym = torch.from_numpy(TABLES[name])
    C = sym.shape[1]
    g = torch.Generator().manual_seed(7)
    data = torch.rand((4, C), generator=g) < 0.7
    lab = torch.randint(0, C, (4, C), generator=g, dtype=torch.int32).masked_fill_(~data, BIG)
    m = neighbour_min_plain(lab, data, sym)
    out = torch.full_like(lab, BIG)
    if stale:
        out = torch.where(m >= BIG - 2, m, m + torch.randint(0, 3, m.shape, generator=g, dtype=torch.int32))
    dense = out.clone()
    flag = graph_step(lab, active_cells(data), sym, out)  # a CPU tensor takes the plain version
    assert_same(hook_plain(lab, m, C), out, "hooked field")
    assert int(flag) == int(bool(((m < lab) & data).any()))
    assert int(graph_step_plain(lab, data, sym, dense)) == int(flag)
    assert_same(dense, out, "step over the list vs the dense step")
    # converged labels: nothing falls, the flag is 0, out is the labels
    roots = torch.where(data, lab, BIG)
    for _ in range(200):
        nxt = pointer_jump_plain(hook_plain(roots, neighbour_min_plain(roots, data, sym), C), C)
        if torch.equal(nxt, roots):
            break
        roots = nxt
    out = torch.full_like(roots, BIG)
    assert int(graph_step_plain(roots, data, sym, out)) == 0
    assert_same(roots, out, "out at the fixpoint")


@pytest.mark.parametrize("density", [0.35, 0.7])
@pytest.mark.parametrize("name", list(TABLES))
def test_fixpoint_matches_reference_and_scipy(name, density):
    sym = TABLES[name]
    data = np.random.default_rng(11).random((6, sym.shape[1])) < density
    data[0] = False  # an empty slice
    r_lab, r_counts = ref_label.label_slices_unstructured(jnp.asarray(data), jnp.asarray(sym))
    p_lab, p_counts, iters = port_label.label_slices_unstructured(torch.from_numpy(data), torch.from_numpy(sym))
    assert_same(r_lab, p_lab, "dense labels vs marex_tpu")
    assert_same(r_counts, p_counts, "counts vs marex_tpu")
    assert_same(oracle_labels(data, sym), p_lab, "dense labels vs scipy")
    assert iters >= 1 and int(p_counts[0]) == 0


def test_directed_table_is_followed_as_given():
    """Labelling follows the table it is given: on a one-way chain only the
    symmetrised table joins the cells, which is why the tracker labels on it."""
    C = 6
    nb = np.full((1, C), -1, np.int32)
    nb[0, :-1] = np.arange(1, C)  # cell i lists i + 1 only
    data = torch.ones((1, C), dtype=torch.bool)
    _, counts_sym, _ = port_label.label_slices_unstructured(data, torch.from_numpy(_symmetrize_neighbours(nb)))
    assert int(counts_sym[0]) == 1
    lab, counts, _ = port_label.label_slices_unstructured(data, torch.from_numpy(nb))
    assert_same(ref_label.label_slices_unstructured(jnp.asarray(data.numpy()), jnp.asarray(nb))[0], lab, "directed")
    assert int(counts[0]) >= 1


def test_hook_cuts_the_iterations_of_a_long_chain():
    """A snake through the mesh: without the hook a label moves one cell an
    iteration (a jump every 16, as in the reference); with it the fixpoint
    needs a few."""
    C = 600
    nb = np.full((2, C), -1, np.int32)
    order = np.random.default_rng(0).permutation(C)
    nb[0, order[:-1]] = order[1:]
    sym = torch.from_numpy(_symmetrize_neighbours(nb))
    data = torch.ones((1, C), dtype=torch.bool)
    lab, counts, iters = port_label.label_slices_unstructured(data, sym)
    assert int(counts[0]) == 1 and bool((lab == 1).all())
    assert iters <= 40


def test_fixpoint_raises_at_its_cap(monkeypatch):
    monkeypatch.setattr(port_label, "MAX_ITERS_MESH", 1)
    sym = torch.from_numpy(TABLES["tri_mesh"])
    with pytest.raises(port.TrackingError, match="did not converge"):
        port_label.label_slices_unstructured(torch.ones((2, sym.shape[1]), dtype=torch.bool), sym)


@pytest.mark.parametrize(
    "change, error",
    [
        (dict(lab=lambda x: x.long()), TypeError),
        (dict(lab=lambda x: x[None]), ValueError),
        (dict(active=lambda x: x.int()), TypeError),
        (dict(active=lambda x: x.view(2, -1)), ValueError),
        (dict(nb=lambda x: x.long()), TypeError),
        (dict(nb=lambda x: x[:, :-1]), ValueError),
        (dict(nb=lambda x: x.t().contiguous().t()), ValueError),
        (dict(out=lambda x: x[:1]), ValueError),
        (dict(out=lambda x: x.t().contiguous().t()), ValueError),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(change, error):
    C = 10
    args = dict(lab=torch.zeros((2, C), dtype=torch.int32), active=torch.arange(2 * C),
                nb=torch.zeros((3, C), dtype=torch.int32), out=torch.zeros((2, C), dtype=torch.int32))
    for key, fn in change.items():
        args[key] = fn(args[key])
    with pytest.raises(error):
        graph_step(args["lab"], args["active"], args["nb"], args["out"])


@pytest.mark.parametrize(
    "change, error",
    [
        (dict(b=lambda x: x.long()), TypeError),
        (dict(active=lambda x: x.int()), TypeError),
        (dict(active=lambda x: x[::2]), ValueError),
        (dict(out=lambda x: x[:1]), ValueError),
        (dict(out="b"), ValueError),
    ],
)
def test_jump_wrapper_refuses_what_the_kernel_does_not_take(change, error):
    C = 10
    args = dict(b=torch.zeros((2, C), dtype=torch.int32), active=torch.arange(2 * C),
                out=torch.zeros((2, C), dtype=torch.int32))
    for key, fn in change.items():
        args[key] = args[fn] if isinstance(fn, str) else fn(args[key])
    with pytest.raises(error):
        graph_jump(args["b"], args["active"], args["out"])


def test_cpu_calls_launch_nothing():
    sym = torch.from_numpy(TABLES["tri_mesh"])
    data = torch.ones((2, sym.shape[1]), dtype=torch.bool)
    before = (graph_step.launch_count, graph_jump.launch_count)
    port_label.label_slices_unstructured(data, sym)
    assert (graph_step.launch_count, graph_jump.launch_count) == before


@pytest.mark.parametrize("name", list(TABLES))
def test_step_on_the_list_equals_the_dense_step_on_any_labels(name):
    """With labels left at inactive cells too (the dense step reads them
    only as neighbours, as the step over the list does), and hooks aimed at
    inactive cells: ``out`` and the flag equal the dense step's, and the
    plain version over the list is what the wrapper runs."""
    sym = torch.from_numpy(TABLES[name])
    C = sym.shape[1]
    g = torch.Generator().manual_seed(5)
    for T, density in ((1, 0.0), (3, 0.3), (5, 1.0)):
        data = torch.rand((T, C), generator=g) < density
        lab = torch.randint(0, C, (T, C), generator=g, dtype=torch.int32)
        lab.masked_fill_(torch.rand((T, C), generator=g) < 0.2, BIG)
        out0 = torch.full_like(lab, BIG)
        want, got, plain = out0.clone(), out0.clone(), out0.clone()
        flag_want = graph_step_plain(lab, data, sym, want)
        active = active_cells(data)
        assert int(graph_step(lab, active, sym, got)) == int(flag_want)
        assert int(graph_step_active_plain(lab, active, sym, plain)) == int(flag_want)
        assert_same(want, got, f"{name} T={T}")
        assert_same(want, plain, f"{name} T={T}")


@pytest.mark.parametrize("name", list(TABLES))
def test_jump_on_the_list_matches_pointer_jump(name):
    """On fields whose inactive cells hold BIG, the jump over the list is
    the whole-field ``pointer_jump``; it writes only the listed cells."""
    C = TABLES[name].shape[1]
    g = torch.Generator().manual_seed(9)
    data = torch.rand((4, C), generator=g) < 0.6
    b = torch.randint(0, C, (4, C), generator=g, dtype=torch.int32)
    b.masked_fill_(~data | (torch.rand((4, C), generator=g) < 0.05), BIG)  # a few active cells BIG too
    active = active_cells(data)
    got = graph_jump(b, active, torch.full_like(b, BIG))
    assert_same(pointer_jump_plain(b, C), got, f"{name} jump")
    stale = torch.randint(0, C, (4, C), generator=g, dtype=torch.int32)
    kept = stale.clone()
    graph_jump(b, active, out=stale)
    assert_same(kept[~data], stale[~data], "unlisted cells")
    assert_same(got[data], stale[data], "listed cells")


def test_active_cells_are_the_ascending_flat_indices(monkeypatch):
    data = np.random.default_rng(2).random((7, 333)) < 0.3
    want = np.flatnonzero(data)
    got = active_cells(torch.from_numpy(data))
    assert got.dtype == torch.int64
    assert_same(want, got, "active cells")
    monkeypatch.setattr(port_graph_step, "_NONZERO_CELLS", 100)  # in chunks across slices
    assert_same(want, active_cells(torch.from_numpy(data)), "active cells in chunks")
    assert active_cells(torch.zeros((0, 5), dtype=torch.bool)).numel() == 0


@pytest.mark.parametrize("C", [1, 3, 1048352, 2**31 - 2])
def test_split_flat_past_2_31(C):
    """The kernels' split of an int64 flat index into (slice base, cell),
    by a float64 reciprocal and one correction, is exact from 0 up to
    2**52: at slice edges past 2**31 and at random indices."""
    t = np.array([0, 1, 2048, 2049, 2100, (2**31) // C, (2**31) // C + 1, (2**52 - 1) // C], np.int64)
    flat = np.concatenate([t * C, t * C + C - 1, [2**31 - 1, 2**31, 2**32 + 7, 2**52 - 1]])
    rng = np.random.default_rng(C % 1000)
    flat = np.concatenate([flat, rng.integers(0, 2**52, 1000), rng.integers(2**31 - 2**20, 2**31 + 2**20, 1000)])
    flat = flat[flat < 2**52]
    base, c = split_flat(torch.from_numpy(flat), C)
    q, r = np.divmod(flat, C)
    np.testing.assert_array_equal(base.numpy(), q * C)
    np.testing.assert_array_equal(c.numpy(), r)


def test_renumbered_mesh_matches_reference():
    """The triangle-pair mesh with its cells renumbered by a seeded
    permutation, table and data alike: no longer a lattice's local
    numbering. Labels equal ``marex_tpu``'s and scipy's on the renumbered
    mesh, and its components are those of the mesh as numbered."""
    sym = TABLES["tri_mesh"]
    K, C = sym.shape
    rng = np.random.default_rng(17)
    perm = rng.permutation(C)  # new cell j is old cell perm[j]
    inv = np.argsort(perm)
    sym_p = np.where(sym[:, perm] >= 0, inv[np.maximum(sym[:, perm], 0)], -1).astype(np.int32)
    data = rng.random((5, C)) < 0.55
    data_p = data[:, perm]
    r_lab, r_counts = ref_label.label_slices_unstructured(jnp.asarray(data_p), jnp.asarray(sym_p))
    p_lab, p_counts, _ = port_label.label_slices_unstructured(torch.from_numpy(data_p), torch.from_numpy(sym_p))
    assert_same(r_lab, p_lab, "renumbered labels vs marex_tpu")
    assert_same(r_counts, p_counts, "renumbered counts vs marex_tpu")
    assert_same(oracle_labels(data_p, sym_p), p_lab, "renumbered labels vs scipy")
    lab, counts, _ = port_label.label_slices_unstructured(torch.from_numpy(data), torch.from_numpy(sym))
    assert_same(counts, p_counts, "counts as numbered")
    t = np.repeat(np.arange(len(data)), C)
    pairs = np.stack([t, lab.numpy()[:, perm].ravel(), p_lab.numpy().ravel()], 1)  # a bijection in each slice
    assert len(np.unique(pairs, axis=0)) == len(np.unique(pairs[:, :2], axis=0)) == len(np.unique(pairs[:, ::2], axis=0))


@pytest.mark.parametrize(
    "mask, error",
    [
        (torch.ones((2, 10), dtype=torch.int32), TypeError),
        (torch.ones((10, 2), dtype=torch.bool).t(), ValueError),
    ],
    ids=["not_bool", "not_contiguous"],
)
def test_active_cells_refuses_what_the_kernel_does_not_take(mask, error):
    with pytest.raises(error):
        active_cells(mask)
