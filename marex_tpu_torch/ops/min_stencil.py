"""
The CCL kernels: the fused min-stencil and hook, and the pointer jump.

The Pallas TPU kernel ``marex_tpu/ops/pallas_kernels.py:min_stencil_pallas``
is the hand-written CUDA kernel ``csrc/min_stencil.cu:marex_ccl_step``
(built for ``sm_90a`` by :mod:`marex_tpu_torch._cuda_build`). ``min_stencil``
runs it with the hook off and computes what the Pallas kernel computes;
``ccl_step`` runs it as one fixpoint iteration's propagation (3x3 per slice,
or 3x3x3) fused with the hook, which lets a cell lower the label of the cell
its old label names (the port's accelerator, where the reference used
segmented-min sweeps), and a convergence flag. ``pointer_jump``, the other
entry point of the source, is the ``lab <- min(lab, lab[lab])`` hop
(``marex_tpu/ops/label.py:_jump``).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else. A CUDA tensor always goes to the kernel; a CPU tensor goes to
the plain PyTorch version beside it (``*_plain``), which is also what the
kernel is held against on the card. ``<wrapper>.launch_count`` counts kernel
launches, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

BIG = 2**31 - 1


def _check_labels(lab: torch.Tensor, ndim: Optional[int] = 3) -> None:
    if not isinstance(lab, torch.Tensor) or lab.dtype != torch.int32:
        raise TypeError(f"labels must be an int32 tensor, got {getattr(lab, 'dtype', type(lab))}")
    if ndim is not None and lab.dim() != ndim:
        raise ValueError(f"labels must be {ndim}-D, got shape {tuple(lab.shape)}")
    if not lab.is_contiguous():
        raise ValueError("labels must be contiguous")
    if lab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {lab.device}")


def _launch_check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {code}")


def min_stencil_plain(
    lab: torch.Tensor, data: Optional[torch.Tensor] = None, masked: bool = True, wrap_x: bool = True
) -> torch.Tensor:
    """3x3 neighbourhood min of (T, H, W) int32 labels in plain PyTorch: pad
    by one ring (BIG rows in y; wrapped or BIG columns in x), then a 9-way
    ``torch.minimum``; ``masked`` writes BIG where ``data`` is False."""
    T, H, W = lab.shape
    x = torch.full((T, H + 2, W + 2), BIG, dtype=torch.int32, device=lab.device)
    x[:, 1:-1, 1:-1] = lab
    if wrap_x:
        x[:, 1:-1, 0] = lab[:, :, -1]
        x[:, 1:-1, -1] = lab[:, :, 0]
    m = x[:, 0:H, 0:W].clone()
    for dy in range(3):
        for dx in range(3):
            if (dy, dx) != (0, 0):
                torch.minimum(m, x[:, dy : dy + H, dx : dx + W], out=m)
    if masked:
        m.masked_fill_(~data, BIG)
    return m


def min_stencil(
    lab: torch.Tensor, data: Optional[torch.Tensor] = None, masked: bool = True, wrap_x: bool = True
) -> torch.Tensor:
    """
    One CCL propagation step on (T, H, W) int32 labels, what the Pallas
    kernel computes:

    masked=True  : ``where(data, 3x3-min(lab), BIG)``
    masked=False : ``3x3-min(lab)``

    Periodic in x when ``wrap_x``, BIG beyond the x edges otherwise; BIG
    beyond the y edges. Returns a new tensor. On the card it is
    ``marex_ccl_step`` with the hook off, and counts into
    ``ccl_step.launch_count``.
    """
    _check_labels(lab)
    if masked:
        _check_data(lab, data)
    elif data is not None:
        raise ValueError("data is only used when masked=True")
    if lab.device.type == "cpu":
        return min_stencil_plain(lab, data, masked, wrap_x)
    out = torch.empty_like(lab)
    if lab.numel():
        _launch_step(lab, data if masked else None, out, None, int(masked), wrap_x)
    return out


def _check_data(lab: torch.Tensor, data: Optional[torch.Tensor]) -> None:
    if not isinstance(data, torch.Tensor) or data.dtype != torch.bool:
        raise TypeError("masked min_stencil and ccl_step need a bool data tensor")
    if data.shape != lab.shape or data.device != lab.device or not data.is_contiguous():
        raise ValueError("data must be contiguous, on the labels' device, and of the labels' shape")


def _launch_step(lab, data, out, flag, mode: int, wrap_x: bool) -> None:
    from .._cuda_build import kernel_library

    T, H, W = lab.shape
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        code = kernel_library().marex_ccl_step(
            lab.data_ptr(), None if data is None else data.data_ptr(), out.data_ptr(),
            None if flag is None else flag.data_ptr(), T, H, W, mode, int(wrap_x), stream,
        )
    ccl_step.launch_count += 1
    _launch_check(code, "marex_ccl_step")


def hook_plain(lab: torch.Tensor, m: torch.Tensor, slice_size: int) -> torch.Tensor:
    """A copy of ``m`` in which, for every cell with ``r = lab != BIG`` and
    ``m < r``, the cell ``base + r`` of its slice holds at most ``m``."""
    lab_f, m_f = lab.reshape(-1), m.reshape(-1)
    pos = ((lab_f != BIG) & (m_f < lab_f)).nonzero().squeeze(1)
    idx = pos - pos % slice_size + lab_f[pos].long()
    return m_f.clone().scatter_reduce_(0, idx, m_f[pos], reduce="amin").reshape(m.shape)


def spacetime_min_plain(lab: torch.Tensor, data: torch.Tensor, wrap_x: bool = True) -> torch.Tensor:
    """``where(data, 3x3x3-min(lab), BIG)``: the plane min, then the min over
    planes t-1, t, t+1 (BIG beyond the first and last)."""
    plane = min_stencil_plain(lab, masked=False, wrap_x=wrap_x)
    tpad = torch.nn.functional.pad(plane, (0, 0, 0, 0, 1, 1), value=BIG)
    m = torch.minimum(torch.minimum(tpad[:-2], tpad[1:-1]), tpad[2:])
    return m.masked_fill_(~data, BIG)


def ccl_step_plain(
    lab: torch.Tensor, data: torch.Tensor, out: torch.Tensor, depth3: bool = False, wrap_x: bool = True
) -> torch.Tensor:
    """The fused step in plain PyTorch: ``m`` is the masked 3x3 (per slice)
    or 3x3x3 (whole block) min, ``out <- min(out, hook_plain(lab, m))``;
    returns the flag, 1 where some active cell had ``m < lab``."""
    T, H, W = lab.shape
    m = spacetime_min_plain(lab, data, wrap_x) if depth3 else min_stencil_plain(lab, data, True, wrap_x)
    torch.minimum(out, hook_plain(lab, m, T * H * W if depth3 else H * W), out=out)
    return ((m < lab) & data).any().int().reshape(1)


def ccl_step(
    lab: torch.Tensor, data: torch.Tensor, out: torch.Tensor, depth3: bool = False, wrap_x: bool = True
) -> torch.Tensor:
    """
    One iteration's propagation and hook, fused, on (T, H, W) int32 labels
    ``lab`` and bool ``data``: ``m`` = ``where(data, 3x3-min(lab), BIG)`` per
    slice, or with ``depth3`` ``where(data, 3x3x3-min(lab), BIG)``; then
    every active cell lowers its own cell of ``out`` to ``m`` and, when
    ``m < r`` for its old label ``r != BIG``, the cell ``r`` of its hook
    slice (H*W cells, or T*H*W with ``depth3``). ``out`` is lowered in
    place and must hold a field ``>= m`` on entry (BIG-filled, or the
    previous iteration's hooked field); then it ends as
    ``hook_plain(lab, m)``. Labels must be BIG or a flat index inside their
    hook slice. Returns a (1,) int32 flag on the labels' device, nonzero iff
    some active cell had ``m < lab``: iff the iteration changes the labels.
    """
    _check_labels(lab)
    _check_data(lab, data)
    _check_labels(out)
    if out.shape != lab.shape or out.device != lab.device:
        raise ValueError("out must be of the labels' shape and on their device")
    T, H, W = lab.shape
    if (lab.numel() if depth3 else H * W) >= BIG:
        raise ValueError(f"flat indices of the hook slice must fit in int32, got shape {tuple(lab.shape)}")
    if lab.device.type == "cpu":
        return ccl_step_plain(lab, data, out, depth3, wrap_x)
    flag = torch.zeros(1, dtype=torch.int32, device=lab.device)
    if lab.numel():
        _launch_step(lab, data, out, flag, 3 if depth3 else 2, wrap_x)
    return flag


ccl_step.launch_count = 0


def _check_slices(lab: torch.Tensor, slice_size: int) -> None:
    _check_labels(lab, ndim=None)
    if slice_size <= 0 or lab.numel() % slice_size:
        raise ValueError(f"slice_size {slice_size} does not divide the {lab.numel()} labels")


def pointer_jump_plain(lab: torch.Tensor, slice_size: int) -> torch.Tensor:
    """``out = min(lab, lab[base + lab])`` per slice of ``slice_size`` flat
    cells (``base`` = the slice's first cell), BIG kept as BIG."""
    flat = lab.reshape(-1, slice_size)
    active = flat != BIG
    hopped = torch.gather(flat, 1, torch.where(active, flat, 0).long())
    return torch.where(active, torch.minimum(flat, hopped), flat).reshape(lab.shape)


def pointer_jump(lab: torch.Tensor, slice_size: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """
    One pointer-jumping hop of the CCL fixpoints, out of place: every
    non-BIG label ``v`` of a slice becomes ``min(v, label of cell v)``.
    Labels must be BIG or a flat cell index inside their own slice (the CCL
    invariant); ``lab`` may have any shape whose size is a multiple of
    ``slice_size``. Written into ``out`` when given (another tensor of
    ``lab``'s shape and device), else into a new tensor; returns it.
    """
    _check_slices(lab, slice_size)
    n = lab.numel()
    if out is not None:
        _check_labels(out, ndim=None)
        if out.shape != lab.shape or out.device != lab.device or out.data_ptr() == lab.data_ptr():
            raise ValueError("out must be another tensor of the labels' shape on their device")
    if lab.device.type == "cpu":
        hopped = pointer_jump_plain(lab, slice_size)
        return hopped if out is None else out.copy_(hopped)
    from .._cuda_build import kernel_library

    if out is None:
        out = torch.empty_like(lab)
    if n == 0:
        return out
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        code = kernel_library().marex_pointer_jump(
            lab.data_ptr(), out.data_ptr(), ctypes.c_longlong(n // slice_size), ctypes.c_longlong(slice_size), stream
        )
    pointer_jump.launch_count += 1
    _launch_check(code, "marex_pointer_jump")
    return out


pointer_jump.launch_count = 0
