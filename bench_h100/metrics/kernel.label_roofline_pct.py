"""
Share of the labelling's roofline: over every CCL range a path runs
(``filter/ccl_fixpoint``, ``ccl``, ``ccl3d``), the least time the card could
take, over the device time of the work launched inside those ranges.

The least time counts what the input needs, whatever implements it: the
mask read once (1 byte a cell) and the int32 labels written once (4 bytes a
cell) over every cell the range labels, at the card's published memory
bandwidth. Iterations, fusion or extra passes do not change the count.
"""

from bench_h100.label_bytes import labelling_bytes

RANGES = ("filter/ccl_fixpoint", "ccl", "ccl3d")


def read(run):
    tr, bw, path = run["trace"], run["hbm_bytes_per_s"], run["traced_path"]
    if tr is None or not bw or path is None:
        return None
    device_s = tr.range_device_s(RANGES)
    n = sum(len(v) for v in device_s.values())
    spent = sum(sum(v) for v in device_s.values())
    if n == 0 or spent <= 0:
        return None
    # the path labels the same field in each range it runs
    cells = path["labelled_cells"]
    return 100.0 * n * labelling_bytes(cells) / bw / spent
