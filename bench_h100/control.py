#!/usr/bin/env python3
"""
The readings that the limits of a cell's correctness check are set from.

    python3 bench_h100/control.py --workload <cell> --seeds <n> [<n> ...] [--no-control] [--faults <name> ...]

For each seed, on the card and at the cell's own size: the plain reference
in float32 (the configuration's precision), then

- the program: one whole path through the entry points (as the window runs
  it), compared with the reference: the lower readings;
- the control: the reference again with detect computed in bfloat16 (the
  precision below the configuration's float32) in the program's place,
  compared likewise: the upper readings, which must fail the check;
- each fault of ``faults.py`` named: one path with it planted, compared
  likewise, which must fail the check too (a path that raises reads as
  ``{"raised": 1}``).

Prints one JSON line a seed and side (``{"seed", "side", "numbers"}``) and,
last, the largest reading of each number over the seeds, per side. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_h100 import catalog, compare, faults as faults_mod, job as job_mod  # noqa: E402
from bench_h100.run import prepare_program, run_reference  # noqa: E402

CONTROL_PRECISION = torch.bfloat16


def readings(spec: dict, seed: int, device: str, control: bool = True, faults=()) -> dict:
    """{side: numbers} for one seed: ``program``, ``control`` and
    ``fault:<name>`` for each fault named."""
    import marex_tpu_torch as mx
    from marex_tpu_torch.exceptions import MarExError

    cfg, mix = spec["config_data"], spec["traffic_data"]
    inputs = catalog.generator(cfg["generator"]).generate(cfg, seed, device)
    path = job_mod.Job(mx, cfg, mix, inputs, device).run_path()
    got = job_mod.outputs(path)
    del path
    want = run_reference(spec, inputs, device)
    out = {"program": compare.numbers(got, want, device)}
    del got
    if control:
        ctl = run_reference(spec, inputs, device, precision=CONTROL_PRECISION)
        out["control"] = compare.numbers(ctl, want, device)
        del ctl
    for name in faults:
        try:
            with faults_mod.FAULTS[name]():
                broken = job_mod.outputs(job_mod.Job(mx, cfg, mix, inputs, device).run_path())
        except MarExError:
            out[f"fault:{name}"] = {"raised": 1.0}
            continue
        out[f"fault:{name}"] = compare.numbers(broken, want, device)
        del broken
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--faults", nargs="*", default=[], choices=sorted(faults_mod.FAULTS))
    args = p.parse_args(argv)
    spec = catalog.cell(args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    prepare_program("cuda")
    worst: dict = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        for side, nums in readings(spec, seed, "cuda", not args.no_control, args.faults).items():
            print(json.dumps({"seed": seed, "side": side, "seconds": time.perf_counter() - t0, "numbers": nums}),
                  flush=True)
            w = worst.setdefault(side, {})
            for k, v in nums.items():
                w[k] = max(w.get(k, 0.0), v) if side == "program" else min(w.get(k, float("inf")), v)
    print(json.dumps({"program_max": worst.pop("program", {}), "control_min": worst.pop("control", {}),
                      **{f"{side}_min": w for side, w in worst.items()},
                      "passed": {side: compare.passed(compare.judge(w, spec["limits"])) for side, w in worst.items()}},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
