"""Seconds per path in the merge march (``stage_walls["march"]``)."""

from bench_h100.metrics import stage_mean


def read(run):
    return stage_mean(run, ("march",))
