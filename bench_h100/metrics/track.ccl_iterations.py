"""Labelling iterations per path: every fixpoint the tracker runs (the area
filter's, ``ccl``, ``ccl3d``), summed, from the tracker's ``ccl_iterations``
view (each stage's last count, or its largest over a streamed run's blocks;
on the paths the benchmark runs each stage's fixpoint runs once, so the sum
equals that of the ``ccl/iterations/<stage>`` counters)."""


def read(run):
    paths = [p for p in run["paths"] if p.get("ccl_iterations")]
    return sum(sum(p["ccl_iterations"].values()) for p in paths) / len(paths) if paths else None
