"""
Per-launch split of the CCL fixpoints at full size, on one CUDA GPU.

    python3 ccl_split.py [--seed N] [--reps R] [--mesh]

Builds the main path's own CCL inputs through the entry points, from
``chip_smoke.py``'s data (3 yr x 720 x 1440 daily, generated on the card
from ``--seed``) and production parameters: the area filter's input (the
field after ``fill_spatial`` and ``fill_time``; the same on config 1 and
config 4) and config 1's 3-D input (the area filter's output). Then it runs
each fixpoint by hand, ``--reps`` times, with CUDA events around every
launch, and prints the summed milliseconds of each operation over the
iterations, the iteration count and the fixpoint's wall (host clock, ending
in a synchronise), one JSON line per fixpoint and repetition.

With ``--mesh`` it does the same for the mesh fixpoint alone (``graph_step``
and ``pointer_jump``) on config 5's field, 2 yr x 1,048,352 cells: run it
from a copy of another tree to compare two versions of the kernel in one
call.

It reads the iteration from the tree it runs in. Up to PR 2 an iteration
was ``min_stencil``, ``hook`` (with its clone), ``pointer_jump`` and
``torch.equal``, and the 3-D one also a PyTorch time min and a
``masked_fill``; from PR 3 on it is the fused ``ccl_step`` and
``pointer_jump``, with a 4-byte convergence flag read back.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from chip_smoke import BIG, Split, filter_input, fused_fixpoint, mesh_filter_input


def fixpoint_fused(ms, data, depth3: bool, split: Split) -> int:
    return fused_fixpoint(data, depth3, split)[0]


def fixpoint_parent(ms, data, depth3: bool, split: Split) -> int:
    """The iteration up to PR 2: stencil, hook, jump, full comparison."""
    T, H, W = data.shape
    S = T * H * W if depth3 else H * W
    idx = torch.arange(S, dtype=torch.int32, device=data.device)
    lab = (idx if depth3 else idx.repeat(T)).view(T, H, W).masked_fill_(~data, BIG)
    inactive = ~data
    for it in range(1, 200):
        if depth3:
            m = split.time("min_stencil", lambda: ms.min_stencil(lab, masked=False))

            def time_min():
                pair = torch.minimum(m[:-1], m[1:])
                m[0] = pair[0]
                m[-1] = pair[-1]
                torch.minimum(pair[:-1], pair[1:], out=m[1:-1])

            split.time("time min", time_min)
            split.time("masked_fill", lambda: m.masked_fill_(inactive, BIG))
        else:
            m = split.time("min_stencil", lambda: ms.min_stencil(lab, data, masked=True))
        hooked = split.time("hook", lambda: ms.hook(lab, m, S))
        del m
        new = split.time("pointer_jump", lambda: ms.pointer_jump(hooked, S))
        del hooked
        same = split.time("torch.equal", lambda: torch.equal(new, lab))
        split.settle()
        if same:
            return it
        lab = new
    raise AssertionError("no convergence")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--mesh", action="store_true", help="the mesh fixpoint on config 5's field instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ccl_split: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    from marex_tpu_torch.ops import min_stencil as ms

    import marex_tpu_torch as mx

    fused = hasattr(ms, "ccl_step")
    fixpoint = fixpoint_fused if fused else fixpoint_parent
    if args.mesh:
        field, table = mesh_filter_input(mx, args.seed)
        print(f"iteration: graph_step + pointer_jump; active cells: {int(field.sum())} of {field.numel()}")
        fixpoints = (("mesh filter/ccl_fixpoint", field, False),)

        def fixpoint(ms, data, depth3, split):
            return fused_fixpoint(data, False, split, neighbours=table)[0]
    else:
        filled, tr = filter_input(mx, args.seed)
        filtered = tr.filter_small_objects(filled)[0].contiguous()
        del tr
        print(f"iteration: {'fused ccl_step + pointer_jump' if fused else 'min_stencil + hook + pointer_jump + equal'}; "
              f"active cells: filter {int(filled.sum())}, 3-D {int(filtered.sum())} of {filled.numel()}")
        fixpoints = (("filter/ccl_fixpoint", filled, False), ("ccl3d", filtered, True))
    for rep in range(args.reps):
        for name, data, depth3 in fixpoints:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            split = Split()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iters = fixpoint(ms, data, depth3, split)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(json.dumps({
                "fixpoint": name, "rep": rep, "iterations": iters, "wall_s": wall,
                "ms": split.ms, "each_ms": split.each,
                "peak_above_input_bytes": torch.cuda.max_memory_allocated() - base,
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
