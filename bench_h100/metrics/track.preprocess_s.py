"""Seconds per path in the tracker's preprocess: the spatial fill, the
temporal fill and the area filter (``stage_walls``)."""

from bench_h100.metrics import stage_mean


def read(run):
    return stage_mean(run, ("fill_spatial", "fill_time", "filter_small"))
