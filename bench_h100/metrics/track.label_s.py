"""Seconds per path in event labelling: the per-slice labels of the merge
path (``ccl``) or the 3-D labels without merging (``ccl3d``), from ``stage_walls``."""

from bench_h100.metrics import stage_mean


def read(run):
    return stage_mean(run, ("ccl", "ccl3d"))
