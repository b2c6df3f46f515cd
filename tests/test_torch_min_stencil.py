"""The CCL kernels of the PyTorch port against the reference: the min-stencil
against the Pallas kernel bodies themselves (``_stencil_kernel_masked``,
``_stencil_kernel_plain``, run by ``pl.pallas_call(interpret=True)``) and the
XLA stencils ``_min_pool_3x3`` (``wrap_x=False``) and ``_min_pool_3x3x3``;
the fused step against the hook applied to those reference stencils, with
the hook against a loop oracle (the reference has no hook); the jump against
``_jump``.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
themselves are compared with those on the card in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from marex_tpu.ops import label as ref_label
from marex_tpu.ops import pallas_kernels as pk
from marex_tpu_torch.ops.min_stencil import (
    BIG,
    ccl_step,
    ccl_step_plain,
    hook_plain,
    min_stencil,
    min_stencil_plain,
    pointer_jump,
    pointer_jump_plain,
    spacetime_min_plain,
)

from .torch_parity import assert_same, blob_field


def _inputs(shape, seed, density=0.5):
    rng = np.random.default_rng(seed)
    T, H, W = shape
    lab = rng.integers(0, H * W, shape).astype(np.int32)
    data = rng.random(shape) < density
    lab[rng.random(shape) < 0.3] = BIG
    return lab, data


def _pallas(lab: np.ndarray, data: np.ndarray, masked: bool, tb: int = 8) -> np.ndarray:
    """``min_stencil_pallas``'s grid and block specs, run in interpret mode."""
    T, H, W = lab.shape
    T_pad = -(-T // tb) * tb
    lab = np.concatenate([lab, np.full((T_pad - T, H, W), BIG, np.int32)])
    data = np.concatenate([data, np.zeros((T_pad - T, H, W), bool)])
    spec = pl.BlockSpec((tb, H, W), lambda i: (i, 0, 0))
    out_shape = jax.ShapeDtypeStruct((T_pad, H, W), jnp.int32)
    if masked:
        out = pl.pallas_call(
            pk._stencil_kernel_masked, out_shape=out_shape, grid=(T_pad // tb,),
            in_specs=[spec, spec], out_specs=spec, interpret=True,
        )(jnp.asarray(lab), jnp.asarray(data))
    else:
        out = pl.pallas_call(
            pk._stencil_kernel_plain, out_shape=out_shape, grid=(T_pad // tb,),
            in_specs=[spec], out_specs=spec, interpret=True,
        )(jnp.asarray(lab))
    return np.asarray(out)[:T]


@pytest.mark.parametrize("shape", [(4, 16, 32), (11, 9, 20), (1, 1, 7)])
@pytest.mark.parametrize("masked", [True, False])
def test_min_stencil_matches_pallas_bodies(shape, masked):
    lab, data = _inputs(shape, seed=sum(shape))
    got = min_stencil(torch.from_numpy(lab), torch.from_numpy(data) if masked else None, masked=masked)
    assert_same(_pallas(lab, data, masked), got, f"min_stencil masked={masked} {shape}")


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("wrap_x", [True, False])
def test_min_stencil_matches_xla_stencil(masked, wrap_x):
    lab, data = _inputs((9, 12, 17), seed=3)
    ref = ref_label._min_pool_3x3(jnp.asarray(lab), wrap_x)
    if masked:
        ref = jnp.where(jnp.asarray(data), ref, BIG)
    got = min_stencil(torch.from_numpy(lab), torch.from_numpy(data) if masked else None, masked=masked, wrap_x=wrap_x)
    assert_same(ref, got, f"min_stencil masked={masked} wrap_x={wrap_x}")


def test_spacetime_min_matches_min_pool_3x3x3():
    """The 3-D propagation of the port's plain step (plain plane min, then
    the +-1 time min) equals the reference's ``_min_pool_3x3x3``."""
    lab, _ = _inputs((6, 8, 10), seed=5)
    got = spacetime_min_plain(torch.from_numpy(lab), torch.ones(lab.shape, dtype=torch.bool))
    assert_same(ref_label._min_pool_3x3x3(jnp.asarray(lab), True), got, "3x3x3 min")


def _reference_m(lab, data, depth3, wrap_x):
    """The masked propagation of the reference: the Pallas masked body
    (2-D, wrapped), ``_min_pool_3x3`` (2-D, unwrapped) or ``_min_pool_3x3x3``."""
    if depth3:
        m = ref_label._min_pool_3x3x3(jnp.asarray(lab), wrap_x)
    elif wrap_x:
        return np.array(_pallas(lab, data, masked=True))
    else:
        m = ref_label._min_pool_3x3(jnp.asarray(lab), wrap_x)
    return np.array(jnp.where(jnp.asarray(data), m, BIG))


@pytest.mark.parametrize("depth3", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("wrap_x", [True, False])
@pytest.mark.parametrize("stale", [False, True], ids=["big_out", "stale_out"])
@pytest.mark.parametrize("shape", [(5, 7, 13), (1, 1, 5), (2, 3, 1)])
def test_ccl_step_matches_hook_of_reference_stencil(shape, stale, wrap_x, depth3):
    """The fused step equals ``hook_plain(lab, m)`` for the reference's
    masked stencil ``m``, whether ``out`` starts BIG or holds a stale field
    ``>= m``, and its flag says whether some active cell had ``m < lab``."""
    T, H, W = shape
    S = T * H * W if depth3 else H * W
    rng = np.random.default_rng(sum(shape) + 2 * depth3 + wrap_x)
    lab = rng.integers(0, S, shape).astype(np.int32)
    data = rng.random(shape) < 0.6
    lab[~data & (rng.random(shape) < 0.5)] = BIG
    m = _reference_m(lab, data, depth3, wrap_x)
    want = hook_plain(torch.from_numpy(lab), torch.from_numpy(m), S)
    out = torch.full(shape, BIG, dtype=torch.int32)
    if stale:
        out = torch.from_numpy(np.minimum(m.astype(np.int64) + rng.integers(0, 3, shape), BIG).astype(np.int32))
    flag = ccl_step(torch.from_numpy(lab), torch.from_numpy(data), out, depth3=depth3, wrap_x=wrap_x)
    assert_same(want, out, f"fused step depth3={depth3} wrap_x={wrap_x} stale={stale}")
    assert flag.shape == (1,) and bool(flag) == bool(((m < lab) & data).any())


@pytest.mark.parametrize("depth3", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("case", [(10, 32, 48, 60, 5), (6, 64, 128, 400, 1), (8, 20, 36, 6, 9)])
def test_ccl_step_flag_says_whether_the_labels_change(case, depth3):
    """At every iteration of a fixpoint, the step's flag equals
    ``not torch.equal(new, lab)`` for the labels after the jump."""
    data = torch.from_numpy(blob_field(5, *case))
    T, H, W = data.shape
    S = T * H * W if depth3 else H * W
    idx = torch.arange(S, dtype=torch.int32)
    a = (idx if depth3 else idx.repeat(T)).view(T, H, W).masked_fill_(~data, BIG)
    b = torch.full_like(a, BIG)
    for _ in range(64):
        changed = bool(ccl_step(a, data, b, depth3=depth3))
        new = pointer_jump(b, S)
        assert changed == (not torch.equal(new, a))
        if not changed:
            return
        a.copy_(new)
    raise AssertionError("no fixpoint in 64 iterations")


@pytest.mark.parametrize("per_slice", [True, False])
def test_pointer_jump_matches_reference_jump(per_slice):
    T, H, W = 5, 6, 7
    S = H * W if per_slice else T * H * W
    rng = np.random.default_rng(11)
    lab = rng.integers(0, S, (T, H, W)).astype(np.int32)
    lab[rng.random(lab.shape) < 0.3] = BIG
    ref = ref_label._jump(jnp.asarray(lab.reshape(-1, S)))
    assert_same(ref, pointer_jump(torch.from_numpy(lab), S).reshape(-1, S), "pointer jump")


@pytest.mark.parametrize("per_slice", [True, False])
def test_hook_matches_loop_oracle(per_slice):
    """Each cell whose new label m is below its old label r lowers cell r of
    its slice to at most m (the union-find "hook" of the fixpoints)."""
    T, H, W = 4, 5, 6
    S = H * W if per_slice else T * H * W
    rng = np.random.default_rng(13)
    lab = rng.integers(0, S, (T, H, W)).astype(np.int32)
    lab[rng.random(lab.shape) < 0.3] = BIG
    m = np.where(lab == BIG, BIG, np.minimum(lab, rng.integers(0, S, lab.shape))).astype(np.int32)
    want = m.reshape(-1).copy()
    for c, (r, v) in enumerate(zip(lab.reshape(-1), m.reshape(-1))):
        if r != BIG and v < r:
            i = c - c % S + r
            want[i] = min(want[i], v)
    got = hook_plain(torch.from_numpy(lab), torch.from_numpy(m), S)
    assert_same(want.reshape(lab.shape), got, "hook")


def test_wrappers_validate_inputs_and_count_only_kernel_launches():
    lab = torch.zeros((2, 3, 4), dtype=torch.int32)
    data = torch.ones((2, 3, 4), dtype=torch.bool)
    before = (ccl_step.launch_count, pointer_jump.launch_count)
    with pytest.raises(TypeError):
        min_stencil(lab.float(), data)
    with pytest.raises(TypeError):
        min_stencil(lab, None, masked=True)
    with pytest.raises(ValueError):
        min_stencil(lab.transpose(1, 2), data.transpose(1, 2))
    with pytest.raises(ValueError):
        min_stencil(lab, data[:, :2])
    with pytest.raises(ValueError):
        min_stencil(lab[0], data[0])
    with pytest.raises(ValueError):
        pointer_jump(lab, 5)
    with pytest.raises(ValueError):
        pointer_jump(lab, 12, out=lab)
    with pytest.raises(TypeError):
        ccl_step(lab, data.int(), lab.clone())
    with pytest.raises(ValueError):
        ccl_step(lab, data, lab[:1].clone())
    with pytest.raises(ValueError):
        ccl_step(lab.view(1, 6, 4), data, lab.clone())
    assert_same(min_stencil_plain(lab, data), min_stencil(lab, data), "cpu wrapper")
    out, want = torch.full_like(lab, BIG), torch.full_like(lab, BIG)
    assert_same(ccl_step_plain(lab, data, want), ccl_step(lab, data, out), "cpu wrapper flag")
    assert_same(want, out, "cpu wrapper")
    assert_same(pointer_jump_plain(lab, 12), pointer_jump(lab, 12, out=torch.empty_like(lab)), "cpu wrapper")
    after = (ccl_step.launch_count, pointer_jump.launch_count)
    assert after == before  # CPU tensors launch no kernel

