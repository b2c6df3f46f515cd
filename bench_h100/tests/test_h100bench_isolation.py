"""A run imports neither JAX nor the JAX package, and fails without a card
instead of falling back to the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_RUN_SMALL = """
import json, sys
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from h100bench_small import small_spec
from bench_h100 import run
result, _ = run.run_cell(small_spec("grid-merge"), 3, 0.0, False, device="cpu")
print(json.dumps({{"correct": result["correct"], "forbidden": run.forbidden_modules(),
                  "port": "marex_tpu_torch" in sys.modules}}))
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_run_loads_no_jax():
    code = _RUN_SMALL.format(tests=str(Path(__file__).resolve().parent))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "port": True}


def test_forbidden_names_are_whole():
    from bench_h100.run import forbidden_modules

    before = set(sys.modules)
    sys.modules.setdefault("marex_tpu_torch_probe", sys)
    try:
        assert "marex_tpu" not in forbidden_modules() or "marex_tpu" in {m.split(".")[0] for m in before}
    finally:
        sys.modules.pop("marex_tpu_torch_probe", None)


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", "grid-merge", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "CUDA" in out.stderr
