#!/bin/bash
# GPU batch submission (the port's counterpart of the reference's
# submit_tpu.sh and SLURM submit_track.sh): detect, then track, on one card,
# or with MAREX_GPUS=N on N cards of the node under torchrun, one process a
# card (detect splits the rows over them, track the days). Arguments are
# passed to both jobs (e.g. --device cpu --small for a quick check without a
# card; with MAREX_GPUS the processes then join a gloo world on the CPU).
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

GPUS=${MAREX_GPUS:-1}
if [ "$GPUS" -gt 1 ]; then
    torchrun --standalone --nproc_per_node="$GPUS" "$HERE/run_detect.py" --mesh "$@"
    torchrun --standalone --nproc_per_node="$GPUS" "$HERE/run_track.py" --mesh "$@"
else
    python "$HERE/run_detect.py" "$@"
    python "$HERE/run_track.py" "$@"
fi
