"""Seconds per path in the merge march's partition of merging children
(``stage_walls["march/partition"]``)."""

from bench_h100.metrics import stage_mean


def read(run):
    return stage_mean(run, ("march/partition",))
