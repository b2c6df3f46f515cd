"""The port's entry module (``marex_tpu_torch.entry``) against the
repository's ``__graft_entry__.py``.

The fused one-step detect+track program runs on the same numpy inputs
through both: ``__graft_entry__._detect_track_step`` jitted on the CPU, and
the port's on CPU tensors (the plain versions of its kernels). The labels and
the event count must be bit-identical (the ids ranked by each event's
smallest flat index), the anomalies within 1e-5. The inputs are ``entry()``'s
own and two seeded fields of (64, 24, 48) with warm blobs, four years of 16
days each, so that there are more events than ``entry()``'s three and the
year axis is full. The reference caps its labelling at 64 iterations; the
port runs to its fixpoint, and these cases show the labels equal.
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest
import torch

import marex_tpu_torch.entry as port_entry
from marex_tpu_torch.exceptions import DeviceError

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # __graft_entry__.py

import __graft_entry__ as graft  # noqa: E402

ANOM_ATOL = 1e-5


def warm_inputs(seed: int, T: int = 64, H: int = 24, W: int = 48):
    """``(data, year_idx, doy_idx, mask)``: unit noise with eight warm disks
    (+3, periodic in x) of 2-5 days, ``year_idx = t // 16``, ``doy_idx = t %
    16``, a mask of ones."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((T, H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(8):
        t0, dur = int(rng.integers(0, T - 4)), int(rng.integers(2, 6))
        cy, cx, r = int(rng.integers(0, H)), int(rng.integers(0, W)), int(rng.integers(2, 6))
        dx = np.minimum(np.abs(xx - cx), W - np.abs(xx - cx))
        data[t0 : t0 + dur][:, (yy - cy) ** 2 + dx**2 <= r * r] += 3.0
    t = np.arange(T)
    return data, (t // 16).astype(np.int32), (t % 16).astype(np.int32), np.ones((H, W), bool)


def entry_inputs():
    _, args = port_entry.entry(device="cpu")
    return tuple(a.numpy() for a in args)


@pytest.mark.parametrize("case", ["entry", "warm seed 1", "warm seed 2"])
def test_step_matches_reference(case):
    inputs = entry_inputs() if case == "entry" else warm_inputs(int(case[-1]))
    r_anom, r_lab, r_n = jax.jit(graft._detect_track_step)(*inputs)
    anom, lab, n = port_entry._detect_track_step(*(torch.from_numpy(x) for x in inputs))
    assert lab.dtype == torch.int32 and tuple(lab.shape) == inputs[0].shape
    np.testing.assert_array_equal(lab.numpy(), np.asarray(r_lab))
    assert n == int(r_n) == int(lab.max())
    assert n >= (3 if case == "entry" else 10)
    assert anom.dtype == torch.float32
    np.testing.assert_allclose(anom.numpy(), np.asarray(r_anom), rtol=0, atol=ANOM_ATOL)


def test_entry_inputs_are_the_references():
    """Seed 0, (32, 16, 32), two years of 16 days, a mask of ones, on the CPU
    when asked."""
    fn, args = port_entry.entry(device="cpu")
    _, r_args = graft.entry()
    assert fn is port_entry._detect_track_step
    for got, want in zip(args, r_args):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype


def test_entry_needs_the_card(monkeypatch):
    """No card and no ``device="cpu"``: ``DeviceError``, never CPU tensors;
    the dry run likewise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match="CUDA"):
        port_entry.entry()
    with pytest.raises(DeviceError, match="CUDA"):
        port_entry.dryrun_multichip(1)


def test_dryrun_needs_enough_ranks(monkeypatch):
    """A world of fewer ranks than asked for raises before any work, as the
    reference does."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="needs 2 devices but the torch.distributed world exposes 1"):
        port_entry.dryrun_multichip(2, device="cpu")
