"""
The mesh CCL kernels: one fixpoint iteration on an unstructured mesh, over
the field's active cells.

``graph_step`` is the mesh counterpart of ``min_stencil.ccl_step``: the
neighbour-table min of ``marex_tpu/ops/label.py:_unstr_block`` (an XLA gather
in the reference) fused with the hook and the convergence flag, as the
hand-written CUDA kernel ``csrc/graph_step.cu:marex_graph_step`` (built for
``sm_90a`` by :mod:`marex_tpu_torch._cuda_build`). ``graph_jump`` is the
fixpoint's pointer jump (the reference's ``_jump``), the kernel
``marex_graph_jump`` of the same source. Both walk only the list of active
cells (:func:`active_cells`: ascending int64 flat indices, made once a
fixpoint by the source's compaction kernels), and
``ops/label.py:label_slices_unstructured`` drives them.

A CUDA tensor always goes to the kernel; a CPU tensor goes to the plain
version beside it (``active_cells_plain``, ``graph_step_active_plain``,
``graph_jump_plain``), which is also what the kernel is held against on the
card. The dense ``neighbour_min_plain`` and ``graph_step_plain`` over the
mask are the tests' oracle. ``<wrapper>.launch_count`` counts kernel
launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .min_stencil import BIG, _check_labels, _launch_check, hook_plain

# the largest flat index the kernels split exactly (slice_base in csrc/graph_step.cu)
MAX_FLAT = 2**52
# cells a nonzero call takes at a time, below its int32 element limit
_NONZERO_CELLS = 2**30


def active_cells_plain(data: torch.Tensor) -> torch.Tensor:
    """``active_cells`` in plain PyTorch: ``nonzero`` of the flat mask, in
    chunks of at most ``_NONZERO_CELLS`` cells."""
    flat = data.reshape(-1)
    if flat.numel() <= _NONZERO_CELLS:
        return flat.nonzero().squeeze(1)
    return torch.cat([flat[a : a + _NONZERO_CELLS].nonzero().squeeze(1) + a for a in range(0, flat.numel(), _NONZERO_CELLS)])


def active_cells(data: torch.Tensor) -> torch.Tensor:
    """The (n,) int64 flat indices ``t * C + c`` of the True cells of a
    contiguous bool field, ascending (slice-major, then by cell): the list
    the mesh kernels walk, made once a fixpoint. On the card the kernels
    ``marex_count_active`` and ``marex_write_active`` around a prefix sum of
    the tiles' counts; reads the count back (one synchronisation, as
    ``nonzero`` does)."""
    if not isinstance(data, torch.Tensor) or data.dtype != torch.bool:
        raise TypeError("the mask must be a bool tensor")
    if not data.is_contiguous() or data.device.type not in ("cpu", "cuda"):
        raise ValueError("the mask must be a contiguous CPU or CUDA tensor")
    if data.device.type == "cpu":
        return active_cells_plain(data)
    from .._cuda_build import kernel_library

    n = data.numel()
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=data.device)
    lib = kernel_library()
    ends = torch.empty(lib.marex_active_tiles(n), dtype=torch.int64, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        _launch_check(lib.marex_count_active(data.data_ptr(), n, ends.data_ptr(), stream), "marex_count_active")
        ends.cumsum_(0)
        active = torch.empty(int(ends[-1]), dtype=torch.int64, device=data.device)
        code = lib.marex_write_active(data.data_ptr(), n, ends.data_ptr(), active.data_ptr(), stream)
    active_cells.launch_count += 1
    _launch_check(code, "marex_write_active")
    return active


active_cells.launch_count = 0


def split_flat(flat: torch.Tensor, C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slice base ``t * C``, cell ``c``) of int64 flat indices ``t * C + c``
    below ``MAX_FLAT``, as the kernels split them: the float64 quotient by a
    reciprocal of C, within 1 of t, then one correction."""
    base = (flat.double() * (1.0 / C)).long() * C
    base = base - C * (base > flat).long() + C * (flat - base >= C).long()
    return base, flat - base


def _check_table(lab: torch.Tensor, neighbours: torch.Tensor) -> None:
    if not isinstance(neighbours, torch.Tensor) or neighbours.dtype != torch.int32 or neighbours.dim() != 2:
        raise TypeError("neighbours must be a (K, C) int32 tensor")
    if neighbours.shape[1] != lab.shape[1] or neighbours.device != lab.device or not neighbours.is_contiguous():
        raise ValueError("neighbours must be contiguous, on the labels' device, with one column a cell")


def _check_active(lab: torch.Tensor, active: torch.Tensor) -> None:
    if not isinstance(active, torch.Tensor) or active.dtype != torch.int64:
        raise TypeError("active must be an int64 tensor of flat cell indices")
    if active.dim() != 1 or active.device != lab.device or not active.is_contiguous():
        raise ValueError("active must be a contiguous 1-D tensor on the labels' device")
    if lab.shape[1] >= BIG or lab.numel() > MAX_FLAT:
        raise ValueError(f"cell indices must fit in int32 and flat indices below 2**52, got shape {tuple(lab.shape)}")


def neighbour_min_plain(lab: torch.Tensor, data: torch.Tensor, neighbours: torch.Tensor) -> torch.Tensor:
    """``where(data, min(lab, lab at each valid neighbour), BIG)`` on (T, C)
    labels: a gather and a min a table row."""
    m = lab.clone()
    for row in neighbours:
        g = lab.index_select(1, row.clamp_min(0).long())
        torch.minimum(m, g.masked_fill_(row < 0, BIG), out=m)
    return m.masked_fill_(~data, BIG)


def graph_step_plain(lab: torch.Tensor, data: torch.Tensor, neighbours: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The fused mesh step over every cell, densely, in plain PyTorch: ``m``
    is the masked neighbour min, ``out <- min(out, hook_plain(lab, m))`` with
    the slice as the hook's range; returns the flag, 1 where some active cell
    had ``m < lab``. The oracle of ``graph_step``."""
    m = neighbour_min_plain(lab, data, neighbours)
    torch.minimum(out, hook_plain(lab, m, lab.shape[1]), out=out)
    return ((m < lab) & data).any().int().reshape(1)


def graph_step_active_plain(
    lab: torch.Tensor, active: torch.Tensor, neighbours: torch.Tensor, out: torch.Tensor
) -> torch.Tensor:
    """``graph_step`` in plain PyTorch, on the same arguments: the neighbour
    min of each listed cell, then ``out`` lowered by ``scatter_reduce_`` amin
    at the cell and, where ``m < r``, at the cell ``r != BIG`` of its slice
    that its old label names; returns the flag."""
    base, c = split_flat(active, lab.shape[1])
    flat, out_f = lab.view(-1), out.view(-1)
    r = flat[active]
    m = r.clone()
    for row in neighbours:
        n = row[c].long()
        torch.minimum(m, flat[base + n.clamp_min(0)].masked_fill_(n < 0, BIG), out=m)
    fell = m < r
    hook = fell & (r != BIG)
    out_f.scatter_reduce_(0, active, m, reduce="amin")
    out_f.scatter_reduce_(0, base[hook] + r[hook].long(), m[hook], reduce="amin")
    return fell.any().int().reshape(1)


def graph_jump_plain(b: torch.Tensor, active: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``graph_jump`` in plain PyTorch: at each listed cell, ``out`` =
    ``min(v, b[t, v])`` for ``v = b[t, c] != BIG``, BIG kept; returns ``out``."""
    base, _ = split_flat(active, b.shape[1])
    flat = b.view(-1)
    v = flat[active]
    valid = v != BIG
    hop = flat[base + torch.where(valid, v, 0).long()]
    out.view(-1)[active] = torch.where(valid, torch.minimum(v, hop), v)
    return out


def graph_step(lab: torch.Tensor, active: torch.Tensor, neighbours: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """
    One iteration's propagation and hook, fused, on (T, C) int32 labels
    ``lab`` at the cells listed in ``active`` (ascending int64 flat indices
    ``t * C + c``, :func:`active_cells` of the mask) over the (K, C) int32
    table ``neighbours`` (0-based cell indices, negative = no neighbour),
    which all slices share: ``m`` = ``min(lab, lab at the valid
    neighbours)``; then every listed cell lowers its own cell of ``out`` to
    ``m`` and, when ``m < r`` for its old label ``r != BIG``, the cell ``r``
    of its slice. ``out`` is lowered in place and must hold a field ``>= m``
    on entry (BIG-filled, or the previous iteration's hooked field); then it
    ends as ``graph_step_plain``'s on the mask of the listed cells. Labels
    must be BIG or a cell index inside the slice, table entries below C.
    Returns a (1,) int32 flag on the labels' device, nonzero iff some listed
    cell had ``m < lab``: iff the iteration changes the labels.
    """
    _check_labels(lab, ndim=2)
    _check_active(lab, active)
    _check_labels(out, ndim=2)
    if out.shape != lab.shape or out.device != lab.device:
        raise ValueError("out must be of the labels' shape and on their device")
    _check_table(lab, neighbours)
    if lab.device.type == "cpu":
        return graph_step_active_plain(lab, active, neighbours, out)
    from .._cuda_build import kernel_library

    flag = torch.zeros(1, dtype=torch.int32, device=lab.device)
    if active.numel():
        with torch.cuda.device(lab.device):
            stream = torch.cuda.current_stream(lab.device).cuda_stream
            code = kernel_library().marex_graph_step(
                lab.data_ptr(), active.data_ptr(), active.numel(), neighbours.data_ptr(), out.data_ptr(),
                flag.data_ptr(), lab.shape[1], neighbours.shape[0], stream,
            )
        graph_step.launch_count += 1
        _launch_check(code, "marex_graph_step")
    return flag


graph_step.launch_count = 0


def graph_jump(b: torch.Tensor, active: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """
    One pointer-jumping hop of the mesh fixpoint at the cells listed in
    ``active`` (as for :func:`graph_step`): ``out[t, c] = min(v, b[t, v])``
    for ``v = b[t, c] != BIG``, BIG kept. ``out``, another (T, C) int32
    tensor on ``b``'s device, is written at the listed cells only, so where
    ``b`` and ``out`` hold BIG at every unlisted cell the result is
    ``pointer_jump(b, C)``. Returns ``out``.
    """
    _check_labels(b, ndim=2)
    _check_active(b, active)
    _check_labels(out, ndim=2)
    if out.shape != b.shape or out.device != b.device or out.data_ptr() == b.data_ptr():
        raise ValueError("out must be another tensor of b's shape on its device")
    if b.device.type == "cpu":
        return graph_jump_plain(b, active, out)
    from .._cuda_build import kernel_library

    if active.numel():
        with torch.cuda.device(b.device):
            stream = torch.cuda.current_stream(b.device).cuda_stream
            code = kernel_library().marex_graph_jump(
                b.data_ptr(), active.data_ptr(), active.numel(), out.data_ptr(), b.shape[1], stream
            )
        graph_jump.launch_count += 1
        _launch_check(code, "marex_graph_jump")
    return out


graph_jump.launch_count = 0
