"""
The CCL kernels: the 3x3 min-stencil, the hook and the pointer jump.

``min_stencil`` replaces the Pallas TPU kernel
``marex_tpu/ops/pallas_kernels.py:min_stencil_pallas`` with the hand-written
CUDA kernel ``csrc/min_stencil.cu:marex_min_stencil`` (built for ``sm_90a``
by :mod:`marex_tpu_torch._cuda_build`). Two more entry points of the same
source complete a fixpoint iteration: ``hook``, which lets a cell lower the
label of the cell its old label names (the port's accelerator, where the
reference used segmented-min sweeps), and ``pointer_jump``, the
``lab <- min(lab, lab[lab])`` hop (``marex_tpu/ops/label.py:_jump``).

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
        raise ValueError(f"labels must be {ndim}-D (T, H, W), got shape {tuple(lab.shape)}")
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
    One CCL propagation step on (T, H, W) int32 labels.

    masked=True  : ``where(data, 3x3-min(lab), BIG)`` (2-D per-slice CCL)
    masked=False : ``3x3-min(lab)``                   (plane min of the 3-D CCL)

    Periodic in x when ``wrap_x``, BIG beyond the x edges otherwise; BIG
    beyond the y edges. Returns a new tensor.
    """
    _check_labels(lab)
    if masked:
        if not isinstance(data, torch.Tensor) or data.dtype != torch.bool:
            raise TypeError("masked min_stencil needs a bool data tensor")
        if data.shape != lab.shape or data.device != lab.device or not data.is_contiguous():
            raise ValueError("data must be contiguous, on the labels' device, and of the labels' shape")
    elif data is not None:
        raise ValueError("data is only used when masked=True")
    if lab.device.type == "cpu":
        return min_stencil_plain(lab, data, masked, wrap_x)
    from .._cuda_build import kernel_library

    T, H, W = lab.shape
    out = torch.empty_like(lab)
    if lab.numel() == 0:
        return out
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        code = kernel_library().marex_min_stencil(
            lab.data_ptr(), data.data_ptr() if masked else None, out.data_ptr(), T, H, W, int(masked), int(wrap_x), stream
        )
    min_stencil.launch_count += 1
    _launch_check(code, "marex_min_stencil")
    return out


min_stencil.launch_count = 0


def _check_slices(lab: torch.Tensor, slice_size: int) -> None:
    _check_labels(lab, ndim=None)
    if slice_size <= 0 or lab.numel() % slice_size:
        raise ValueError(f"slice_size {slice_size} does not divide the {lab.numel()} labels")


def hook_plain(lab: torch.Tensor, m: torch.Tensor, slice_size: int) -> torch.Tensor:
    """A copy of ``m`` in which, for every cell with ``r = lab != BIG`` and
    ``m < r``, the cell ``base + r`` of its slice holds at most ``m``."""
    lab_f, m_f = lab.reshape(-1), m.reshape(-1)
    pos = ((lab_f != BIG) & (m_f < lab_f)).nonzero().squeeze(1)
    idx = pos - pos % slice_size + lab_f[pos].long()
    return m_f.clone().scatter_reduce_(0, idx, m_f[pos], reduce="amin").reshape(m.shape)


def hook(lab: torch.Tensor, m: torch.Tensor, slice_size: int) -> torch.Tensor:
    """
    The hooking step of the CCL fixpoints, out of place: ``lab`` holds the
    labels before an iteration's propagation and ``m`` after it. Returns a
    copy of ``m`` in which the cell each old label names (within its slice of
    ``slice_size`` flat cells) is lowered to the smallest new label of the
    cells that carried that old label. Labels must be BIG or a flat cell
    index inside their own slice.
    """
    _check_slices(lab, slice_size)
    _check_labels(m, ndim=None)
    if m.shape != lab.shape or m.device != lab.device:
        raise ValueError("hook needs old and new labels of one shape on one device")
    if lab.device.type == "cpu":
        return hook_plain(lab, m, slice_size)
    from .._cuda_build import kernel_library

    out = m.clone()
    n = lab.numel()
    if n == 0:
        return out
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        code = kernel_library().marex_hook(
            lab.data_ptr(), m.data_ptr(), out.data_ptr(), ctypes.c_longlong(n // slice_size),
            ctypes.c_longlong(slice_size), stream,
        )
    hook.launch_count += 1
    _launch_check(code, "marex_hook")
    return out


hook.launch_count = 0


def pointer_jump_plain(lab: torch.Tensor, slice_size: int) -> torch.Tensor:
    """``out = min(lab, lab[base + lab])`` per slice of ``slice_size`` flat
    cells (``base`` = the slice's first cell), BIG kept as BIG."""
    flat = lab.reshape(-1, slice_size)
    active = flat != BIG
    hopped = torch.gather(flat, 1, torch.where(active, flat, 0).long())
    return torch.where(active, torch.minimum(flat, hopped), flat).reshape(lab.shape)


def pointer_jump(lab: torch.Tensor, slice_size: int) -> torch.Tensor:
    """
    One pointer-jumping hop of the CCL fixpoints, out of place: every
    non-BIG label ``v`` of a slice becomes ``min(v, label of cell v)``.
    Labels must be BIG or a flat cell index inside their own slice (the CCL
    invariant); ``lab`` may have any shape whose size is a multiple of
    ``slice_size``.
    """
    _check_slices(lab, slice_size)
    n = lab.numel()
    if lab.device.type == "cpu":
        return pointer_jump_plain(lab, slice_size)
    from .._cuda_build import kernel_library

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
