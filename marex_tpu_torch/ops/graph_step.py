"""
The mesh CCL kernel: one fixpoint iteration on an unstructured mesh.

``graph_step`` is the mesh counterpart of ``min_stencil.ccl_step``: the
neighbour-table min of ``marex_tpu/ops/label.py:_unstr_block`` (an XLA gather
in the reference) fused with the hook and the convergence flag, as the
hand-written CUDA kernel ``csrc/graph_step.cu:marex_graph_step`` (built for
``sm_90a`` by :mod:`marex_tpu_torch._cuda_build`). It has ``ccl_step``'s
contract, so the same ping-pong fixpoint (``ops/label.py:_fixpoint``) drives
both.

A CUDA tensor always goes to the kernel; a CPU tensor goes to
``graph_step_plain``, which is also what the kernel is held against on the
card. ``graph_step.launch_count`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .min_stencil import BIG, _check_data, _check_labels, _launch_check, hook_plain


def _check_table(lab: torch.Tensor, neighbours: torch.Tensor) -> None:
    if not isinstance(neighbours, torch.Tensor) or neighbours.dtype != torch.int32 or neighbours.dim() != 2:
        raise TypeError("neighbours must be a (K, C) int32 tensor")
    if neighbours.shape[1] != lab.shape[1] or neighbours.device != lab.device or not neighbours.is_contiguous():
        raise ValueError("neighbours must be contiguous, on the labels' device, with one column a cell")


def neighbour_min_plain(lab: torch.Tensor, data: torch.Tensor, neighbours: torch.Tensor) -> torch.Tensor:
    """``where(data, min(lab, lab at each valid neighbour), BIG)`` on (T, C)
    labels: a gather and a min a table row."""
    m = lab.clone()
    for row in neighbours:
        g = lab.index_select(1, row.clamp_min(0).long())
        torch.minimum(m, g.masked_fill_(row < 0, BIG), out=m)
    return m.masked_fill_(~data, BIG)


def graph_step_plain(lab: torch.Tensor, data: torch.Tensor, neighbours: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The fused mesh step in plain PyTorch: ``m`` is the masked neighbour
    min, ``out <- min(out, hook_plain(lab, m))`` with the slice as the hook's
    range; returns the flag, 1 where some active cell had ``m < lab``."""
    m = neighbour_min_plain(lab, data, neighbours)
    torch.minimum(out, hook_plain(lab, m, lab.shape[1]), out=out)
    return ((m < lab) & data).any().int().reshape(1)


def graph_step(lab: torch.Tensor, data: torch.Tensor, neighbours: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """
    One iteration's propagation and hook, fused, on (T, C) int32 labels
    ``lab``, bool ``data`` and the (K, C) int32 table ``neighbours`` (0-based
    cell indices, negative = no neighbour), which all slices share: ``m`` =
    ``where(data, min(lab, lab at the valid neighbours), BIG)``; then every
    active cell lowers its own cell of ``out`` to ``m`` and, when ``m < r``
    for its old label ``r != BIG``, the cell ``r`` of its slice. ``out`` is
    lowered in place and must hold a field ``>= m`` on entry (BIG-filled, or
    the previous iteration's hooked field); then it ends as
    ``hook_plain(lab, m)``. Labels must be BIG or a cell index inside the
    slice, and table entries below C. Returns a (1,) int32 flag on the
    labels' device, nonzero iff some active cell had ``m < lab``: iff the
    iteration changes the labels.
    """
    _check_labels(lab, ndim=2)
    _check_data(lab, data)
    _check_labels(out, ndim=2)
    if out.shape != lab.shape or out.device != lab.device:
        raise ValueError("out must be of the labels' shape and on their device")
    _check_table(lab, neighbours)
    T, C = lab.shape
    if C >= BIG:
        raise ValueError(f"cell indices must fit in int32, got {C} cells")
    if lab.device.type == "cpu":
        return graph_step_plain(lab, data, neighbours, out)
    from .._cuda_build import kernel_library

    flag = torch.zeros(1, dtype=torch.int32, device=lab.device)
    if lab.numel():
        with torch.cuda.device(lab.device):
            stream = torch.cuda.current_stream(lab.device).cuda_stream
            code = kernel_library().marex_graph_step(
                lab.data_ptr(), data.data_ptr(), neighbours.data_ptr(), out.data_ptr(), flag.data_ptr(), T, C,
                neighbours.shape[0], stream,
            )
        graph_step.launch_count += 1
        _launch_check(code, "marex_graph_step")
    return flag


graph_step.launch_count = 0
