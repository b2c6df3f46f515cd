#!/bin/bash
# One-GPU batch submission (the port's counterpart of the reference's
# submit_tpu.sh and SLURM submit_track.sh): detect, then track, on one card.
# Arguments are passed to both jobs (e.g. --device cpu --small for a quick
# check without a card).
#SBATCH --job-name=marex_gpu
#SBATCH --gres=gpu:1
#SBATCH --cpus-per-task=8
#SBATCH --time=01:00:00

set -euo pipefail

HERE=$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)

export MAREX_PCTL=${MAREX_PCTL:-95}
export MAREX_OVERLAP=${MAREX_OVERLAP:-0.25}
export MAREX_QUIET=1
# the CUDA kernels are built by nvcc at first use into marex_tpu_torch/_build/
# and reused by later jobs while their sources are unchanged

python "$HERE/run_detect.py" "$@"
python "$HERE/run_track.py" "$@"
