"""Seconds per path in ``preprocess_data``: the benchmark's host clock
around the call, which ends in a synchronise (detect has no ranges of its own)."""


def read(run):
    paths = run["paths"]
    return sum(p["detect_s"] for p in paths) / len(paths) if paths else None
