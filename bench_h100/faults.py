"""
Faults planted under the timed path, each of which the correctness check
has to catch: ``control.py --faults`` reads them at a cell's own size on the
card, ``tests/test_h100bench_reference.py`` on the CPU. Each is a context
manager that breaks the port while it is open.
"""

from __future__ import annotations

import contextlib
from typing import Iterator
from unittest import mock

import numpy as np


@contextlib.contextmanager
def unchanged_state() -> Iterator[None]:
    """A step that returns its state unchanged: every labelling fixpoint
    stops at its start, each cell its own object."""
    import marex_tpu_torch.ops.label as label

    with mock.patch.object(label, "_fixpoint", lambda start, step, jump, max_iters, what: (start.pop(), 1)):
        yield


@contextlib.contextmanager
def half_the_days() -> Iterator[None]:
    """Half of the batch left out, the mean taken over the rest: the
    climatology from the first half of the days (fixed baseline) or the
    nearer half of the baseline years (shifting baseline)."""
    import marex_tpu_torch.ops.climatology as clim
    import marex_tpu_torch.ops.pipeline as pipe

    fixed, rolling = pipe._doy_nanmean_direct, clim.rolling_climatology_ymd

    def first_half(data, doy_idx, clim_time_mask):
        keep = np.asarray(clim_time_mask, bool) & (np.arange(len(doy_idx)) < len(doy_idx) // 2)
        return fixed(data, doy_idx, keep)

    with mock.patch.object(pipe, "_doy_nanmean_direct", first_half), \
            mock.patch.object(clim, "rolling_climatology_ymd", lambda ymd, w: rolling(ymd, max(1, w // 2))):
        yield


def _join(dense, counts):
    """Labels ``dense`` (T, S) with ids 1..counts[t] in each slice (or one
    id space when ``counts`` is None): the first slice with two objects gets
    its second object's cells under its first object's id, the later ids one
    lower."""
    flat = dense.view(dense.shape[0], -1) if counts is not None else dense.view(1, -1)
    n = counts if counts is not None else [int(flat.max())]
    for t in range(flat.shape[0]):
        if int(n[t]) >= 2:
            row = flat[t]
            row.sub_((row >= 2).to(row.dtype))
            if counts is not None:
                counts[t] -= 1
            return True
    return False


@contextlib.contextmanager
def join_two() -> Iterator[None]:
    """Two components given one label where the labelling produces them:
    the 3-D events (no merging), the per-slice objects (merging, grid) and
    the mesh's per-slice objects."""
    import marex_tpu_torch.ops.label as label

    spacetime, slices, mesh = label.densify_spacetime_roots, label.densify_slice_roots, label.label_slices_unstructured

    def spacetime_joined(labf):
        dense, n = spacetime(labf)
        return dense, n - 1 if _join(dense, None) else n

    def slices_joined(*args, **kwargs):
        dense, counts = slices(*args, **kwargs)
        _join(dense, counts)
        return dense, counts

    def mesh_joined(*args, **kwargs):
        labels, counts, iters = mesh(*args, **kwargs)
        _join(labels, counts)
        return labels, counts, iters

    with mock.patch.object(label, "densify_spacetime_roots", spacetime_joined), \
            mock.patch.object(label, "densify_slice_roots", slices_joined), \
            mock.patch.object(label, "label_slices_unstructured", mesh_joined):
        yield


@contextlib.contextmanager
def alter_answer() -> Iterator[None]:
    """An answer altered where it is produced: one cell of the tracker's
    event ids."""
    import marex_tpu_torch.track as track

    run = track.tracker.run

    def altered(self, *args, **kwargs):
        out = run(self, *args, **kwargs)
        events = out[0] if isinstance(out, tuple) else out
        ids = events["ID_field"].data
        ids.view(-1)[ids.numel() // 2] += 1
        return out

    with mock.patch.object(track.tracker, "run", altered):
        yield


FAULTS = {f.__name__: f for f in (unchanged_state, half_the_days, join_two, alter_answer)}
