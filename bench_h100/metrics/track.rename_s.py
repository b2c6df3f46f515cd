"""Seconds per path in the event clustering (``stage_walls["rename"]``)."""

from bench_h100.metrics import stage_mean


def read(run):
    return stage_mean(run, ("rename",))
