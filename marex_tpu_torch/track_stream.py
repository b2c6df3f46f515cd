"""
Streamed tracking: split/merge event tracking of a field larger than device
memory.

The port of ``marex_tpu/track_stream.py``. The binary field (a lazy zarr
payload, or any host array) streams through the tracker's own stages in time
blocks; everything that grows with time x space lives in zarr stores on
disk, never whole on the device or the host, so a block's working set, not
the series, bounds device memory:

1. **Pass A (preprocess and label).** Blocks with a ``2*T_fill`` halo go
   through the spatial fill, the temporal gap fill and the per-slice CCL;
   the interior's filled field goes to a temporary store bit-packed (a bit
   a cell), the per-object cell counts to the host (one small array a
   slice).
2. **Filter (host).** The area filter's rules from those counts, both sets:
   on a grid the first object dropped and ``>=``; on a mesh the >50 (>5
   with an absolute threshold) pre-filter, a strict ``>`` and no drop. A
   block's renumber rows map its old labels to the kept objects' dense ids,
   which are the ids the in-memory filter gives.
3. **Pass B (march).** The tracker's per-step march
   (``tracker._split_and_merge_device``) over a :class:`_WindowStore`: at
   step t the march touches only slices t-2, t-1 and t, and slice t-1 is
   final once step t ends, so the store holds a block and the slices just
   before it on the device, pages the next block in from pass A's store
   (labelled again, renumbered, given its global ids, its objects entered
   in the table, its pairs counted), and writes final slices to a second
   store with their overlap pairs. The object table, the pair cache, the next free id and the
   merge records stay on the host, as in the in-memory run.
4. **Pass C (events).** Blockwise event lookup, remap and statistics:
   ``ID_field``, ``global_ID``, ``area``, ``centroid``, ``presence`` and
   ``merge_ledger`` written region by region, first and last presence kept
   incrementally; the returned Fields are backed by the output store.

The result equals :meth:`tracker.run` bit for bit (ids, tables, ledger and
merge records; areas and centroids are the same sums in the same order).
Only ``allow_merging=True`` runs are streamed.

The stores are the I/O, so each is read or written once and in threads:
the input a chunk at a time (each chunk decompressed once, several ahead),
the bits at 1/32 of the labels pass A would otherwise write (labelling a
block again costs less than reading its labels), the final labels raw, the
output's ``ID_field`` in zlib chunks of a few slices that compress in
parallel.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .exceptions import ConfigurationError, TrackingError
from .io import zarr_lite
from .logging_config import get_logger, log_timing
from .ops import label as _label
from .ops import properties as _props
from .track import ObjectTable, _merges_by_time, _SliceStore, tracker

logger = get_logger(__name__)

# Device bytes a block's cell costs: pass A's morphology, CCL and root
# statistics (counted over the block and its halo), and passes B and C (the
# CCL again, the renumber, the pair keys, the property sums, the window of
# about two blocks)
_PASS_A_BYTES_PER_CELL = 40
_PASS_BC_BYTES_PER_CELL = 56
# bytes of one chunk of a label store, at most (several compress at once)
_CHUNK_BYTES = 32 << 20
# threads that read and write the stores (one core is left to the march)
_IO_THREADS = max(2, min(8, (os.cpu_count() or 2) - 2))


def block_length(T: int, cells: int, halo: int, memory_budget_mb: int) -> int:
    """Slices a block for ``memory_budget_mb`` MiB of device memory: the
    largest block whose pass A (block and halo) and passes B and C fit."""
    budget = int(memory_budget_mb) * 2**20
    a = budget // (max(cells, 1) * _PASS_A_BYTES_PER_CELL) - 2 * halo
    bc = budget // (max(cells, 1) * _PASS_BC_BYTES_PER_CELL)
    return int(max(1, min(T, a, bc)))


def chunk_length(block_T: int, cells: int) -> int:
    """Slices a chunk of a label store: the largest divisor of ``block_T``
    whose int32 chunk stays within ``_CHUNK_BYTES`` (every block starts on a
    chunk, and a block's chunks are written and read in parallel)."""
    want = max(1, _CHUNK_BYTES // max(4 * cells, 1))
    return max(d for d in range(1, min(block_T, want) + 1) if block_T % d == 0)


def _pack_bits(data: torch.Tensor) -> torch.Tensor:
    """(n, *spatial) bool -> (n, ceil(S / 8)) uint8, eight cells a byte,
    the first in the lowest bit (numpy's ``packbits(bitorder="little")``)."""
    n = data.shape[0]
    flat = data.reshape(n, -1)
    pad = (-flat.shape[1]) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(n, pad)], dim=1)
    weights = 1 << torch.arange(8, dtype=torch.uint8, device=data.device)
    return (flat.view(n, -1, 8).to(torch.uint8) * weights).sum(dim=-1, dtype=torch.uint8)


def _unpack_bits(packed: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """The inverse of :func:`_pack_bits`: (n, *shape) bool."""
    n, S = packed.shape[0], int(np.prod(shape))
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = ((packed[..., None] >> shifts) & 1).bool().view(n, -1)
    return bits[:, :S].reshape((n,) + tuple(shape))


def _read_ahead(tr: tracker, read: Callable[[int, int], Any], T: int, block_T: int) -> Iterator[Tuple[int, int, Any]]:
    """``(s0, s1, read(s0, s1))`` over the blocks of ``block_T`` slices, the
    next block read in a background thread while the caller works on this
    one (zarr reads release the GIL); waits count as ``stream/read``."""
    starts = list(range(0, T, block_T))
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="zarr-reader") as pool:
        nxt = pool.submit(read, 0, min(block_T, T)) if starts else None
        for i, s0 in enumerate(starts):
            s1 = min(s0 + block_T, T)
            with tr._stage_ctx("stream/read"):
                data = nxt.result()
            if i + 1 < len(starts):
                nxt = pool.submit(read, s1, min(s1 + block_T, T))
            yield s0, s1, data


class _ChunkRows:
    """
    Rows ``[a, b)`` (along time) of a payload, for calls that move forward
    in time and may overlap (pass A's blocks overlap by their halos): a lazy
    zarr payload is read a chunk of its time axis at a time, each chunk read
    and decompressed once, in ``pool``'s threads and ``ahead`` chunks ahead;
    any other payload is sliced. Called from one thread.
    """

    def __init__(self, src: Any, pool: ThreadPoolExecutor, ahead: int = 4):
        self.src, self.pool, self.ahead = src, pool, ahead
        self.c = src.chunks[0] if isinstance(src, zarr_lite.LazyZarrArray) else 0
        self.T = src.shape[0]
        self.chunks: Dict[int, Any] = {}

    def __call__(self, a: int, b: int):
        if not self.c:
            return self.src[a:b]
        c, n = self.c, -(-self.T // self.c)
        first, last = a // c, (b - 1) // c
        for i in range(first, min(last + self.ahead, n - 1) + 1):
            if i not in self.chunks:
                self.chunks[i] = self.pool.submit(self.src.__getitem__, slice(i * c, min((i + 1) * c, self.T)))
        for i in [i for i in self.chunks if i < first]:
            del self.chunks[i]
        parts = [self.chunks[i].result() for i in range(first, last + 1)]
        rows = np.concatenate(parts) if len(parts) > 1 else parts[0]
        return rows[a - first * c : b - first * c]


def _to_device(block: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A host block on ``device``, through pinned memory on CUDA (PyTorch's
    caching host allocator reuses the pinned buffers)."""
    if isinstance(block, torch.Tensor):
        return block.to(device=device, dtype=dtype)
    host = torch.from_numpy(np.ascontiguousarray(block))
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device=device, dtype=dtype, non_blocking=True)


def run_tracking_streamed(
    tr: tracker,
    out_path: str,
    memory_budget_mb: int = 4096,
    block_T: Optional[int] = None,
    return_merges: bool = False,
):
    """
    Stream the whole tracking pipeline of ``tr`` (a configured
    :class:`~marex_tpu_torch.track.tracker`, whose ``data_bin`` may be a lazy
    zarr payload) into the zarr store ``out_path``. Returns what
    :meth:`tracker.run` returns, with the per-event fields backed by the
    store. ``block_T`` (slices a block) defaults to :func:`block_length` of
    ``memory_budget_mb``; the temporary stores go under ``tr.temp_dir`` and
    are removed at the end.
    """
    if not tr.allow_merging:
        raise ConfigurationError(
            "Streamed tracking covers merge/split-aware runs (allow_merging=True)",
            details="No-merge tracking labels events with the 3-D CCL, which needs the whole field",
            suggestions=[
                "Set allow_merging=True (the production configuration)",
                "For no-merge runs, use tracker.run()",
            ],
        )
    T = tr.data_bin.sizes[tr.timedim]
    sshape = tuple(tr.data_bin.sizes[d] for d in tr._spatial_dims())
    cells = int(np.prod(sshape))
    halo = 2 * int(tr.T_fill)
    if block_T is None:
        block_T = block_length(T, cells, halo, memory_budget_mb)
    block_T = int(max(1, min(block_T, T)))
    logger.info(f"Streamed tracking: T={T}, block_T={block_T}, halo={halo}, spatial={sshape}")
    tr.stream_block_T = block_T

    chunk = chunk_length(block_T, cells)
    if tr.temp_dir:
        os.makedirs(tr.temp_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="marex_trkstream_", dir=tr.temp_dir or None)
    bits_store, fin_store = os.path.join(tmp, "filled_bits.zarr"), os.path.join(tmp, "labels_final.zarr")
    zarr_lite.create_group(bits_store)
    zarr_lite.create_array(bits_store, "bits", (T, -(-cells // 8)), np.uint8, (tr.timedim, "byte"),
                           chunks=(block_T, -(-cells // 8)), compressor=None)
    zarr_lite.create_group(fin_store)
    zarr_lite.create_array(fin_store, "labels", (T,) + sshape, np.int32, (tr.timedim,) + tr._spatial_dims(),
                           chunks=(chunk,) + sshape, compressor=None)
    try:
        with zarr_lite.RegionWriter(workers=_IO_THREADS) as writer, \
                ThreadPoolExecutor(max_workers=_IO_THREADS, thread_name_prefix="zarr-reader") as readers:
            with log_timing(logger, "Streamed preprocess + per-slice labelling", log_memory=True), \
                    tr._stage_ctx("preprocess"):
                counts_old, areas, raw_area = _pass_a(tr, bits_store, block_T, halo, writer, readers)
                writer.flush()
                keep, stats = _filter(tr, counts_old, areas)
            with log_timing(logger, "Streamed split/merge march", log_memory=True), tr._stage_ctx("march"):
                store = _WindowStore(tr, bits_store, fin_store, keep, counts_old, block_T, writer)
                _, table, overlap_list, merge_events = tr._split_and_merge_device(store, ObjectTable())
                writer.flush()
            total_raw, total_processed = float(raw_area.sum()), float(store.processed_area.sum())
            object_stats = stats + ((total_raw / total_processed) if total_processed else 0.0,)
            with log_timing(logger, "Streamed event relabelling + statistics", log_memory=True), \
                    tr._stage_ctx("rename"):
                events_ds, N = _pass_c(tr, fin_store, out_path, block_T, chunk, sshape, table, overlap_list,
                                       merge_events, store.labels_max, writer, readers)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    events_ds = tr.run_stats_attributes(events_ds, merge_events, object_stats, N)
    if return_merges:
        return events_ds, merge_events
    return events_ds


def _label_block(tr: tracker, data: torch.Tensor, stage: str = "filter/ccl_fixpoint",
                 stats_stage: str = "filter/root_stats") -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Per-slice dense labels of a block in ascending-root order, as the
    in-memory area filter labels them, with the counts and each object's
    cell count: ``(labels, counts (n,), areas (n, L) float32)``. The
    fixpoint's most iterations over the blocks are recorded under
    ``stage``."""
    with tr._stage_ctx(stage):
        if tr.unstructured_grid:
            labels, counts, iters = _label.label_slices_unstructured(data & tr.mask_dev, tr._nb_sym_dev)
        else:
            root_flat, _, iters = _label.label_slices_grid_roots(data, wrap_x=tr._wrap)
        tr.ccl_iterations[stage] = max(tr.ccl_iterations.get(stage, 0), iters)
    with tr._stage_ctx(stats_stage):
        if tr.unstructured_grid:
            counts = counts.cpu().numpy()
            L = int(counts.max()) if counts.size else 0
            areas = _label.label_cell_counts(labels, L)[:, 1:].float().cpu().numpy()
        else:
            root_ids, areas_dev, _, counts_dev = _label.slice_root_stats(root_flat)
            labels = _label.densify_slice_roots(root_flat, root_ids)[0].view(data.shape)
            del root_flat
            counts, areas = counts_dev.cpu().numpy(), areas_dev.cpu().numpy()
    return labels, counts, areas


def _pass_a(tr: tracker, bits_store: str, block_T: int, halo: int, writer: zarr_lite.RegionWriter,
            readers: ThreadPoolExecutor):
    """Fill, gap fill and label every block (with its halo); the filled
    field goes to ``bits_store`` bit-packed. Returns the per-slice object
    counts, the per-slice object cell counts (float32, ascending root) and
    the raw active area a slice."""
    src = tr.data_bin.data
    T = src.shape[0]
    counts_old = np.zeros(T, np.int64)
    areas_per_slice: List[np.ndarray] = [np.empty(0, np.float32)] * T
    raw_area = []

    rows = _ChunkRows(src, readers)

    def read(s0: int, s1: int):
        return rows(max(0, s0 - halo), min(T, s1 + halo))

    for s0, s1, raw in _read_ahead(tr, read, T, block_T):
        e0 = max(0, s0 - halo)
        with tr._stage_ctx("stream/read"):
            dev = _to_device(raw, tr.device, torch.bool)
        del raw
        raw_area.append(tr.compute_area(dev[s0 - e0 : s1 - e0]))
        with tr._stage_ctx("fill_spatial"):
            filled = tr.fill_holes(dev)
        del dev
        with tr._stage_ctx("fill_time"):
            closed = tr.fill_time_gaps(filled)
        del filled
        interior = closed[s0 - e0 : s1 - e0].contiguous()
        del closed
        labels, counts, areas = _label_block(tr, interior)
        del labels
        counts_old[s0:s1] = counts
        for t in range(s0, s1):
            areas_per_slice[t] = areas[t - s0, : counts[t - s0]].copy()
        with tr._stage_ctx("stream/write"):
            writer.write(bits_store, "bits", (s0, 0), _pack_bits(interior))
        del interior
    return counts_old, areas_per_slice, np.concatenate(raw_area)


def _filter(tr: tracker, counts_old: np.ndarray, areas_per_slice: List[np.ndarray]):
    """The area filter on the host, with the in-memory filter's rules for
    the grid or the mesh (``tracker.filter_small_objects``). Returns the
    per-slice keep masks and ``(total_area_IDed, N_prefiltered, N_filtered,
    area_threshold, accepted_area_fraction)``."""
    object_areas = np.concatenate(areas_per_slice) if len(areas_per_slice) else np.empty(0, np.float32)
    if object_areas.size == 0:
        raise TrackingError(
            "No objects found for area-based filtering",
            details={"objects_count": 0, "area_filter_quartile": tr.area_filter_quartile},
            suggestions=[
                "Check if input data contains any extreme events",
                "Verify that preprocessing parameters are appropriate",
                "Consider lowering the extreme threshold percentile",
            ],
        )
    if tr.unstructured_grid:
        min_sz = 5 if tr._use_absolute_filtering else 50
        object_areas = object_areas[object_areas > min_sz]
        if len(object_areas) == 0:
            raise TrackingError(
                "No objects found for area-based filtering",
                details={"objects_count": 0, "grid_type": "unstructured"},
                suggestions=["Check if input data contains any extreme events"],
            )
        if tr._use_absolute_filtering:
            area_threshold = float(tr.area_filter_absolute)
        else:
            area_threshold = float(np.percentile(object_areas, tr.area_filter_quartile * 100))
        keep = [a > area_threshold for a in areas_per_slice]
        n_filtered = int(np.sum(object_areas > area_threshold))
    else:
        if tr._use_absolute_filtering:
            area_threshold = float(tr.area_filter_absolute)
        else:
            area_threshold = float(np.percentile(object_areas, tr.area_filter_quartile * 100.0))
        keep = [a >= np.float32(area_threshold) for a in areas_per_slice]
        # the reference's first object (smallest root of the first slice with any) always goes
        t_first = int(np.argmax(counts_old > 0))
        keep[t_first] = keep[t_first].copy()
        keep[t_first][0] = False
        n_filtered = int(sum(int(k.sum()) for k in keep))
    logger.info(f"Filtered {object_areas.size} -> {n_filtered} objects (threshold: {area_threshold})")
    total_area = float(object_areas.sum())
    accepted = float(object_areas[object_areas > area_threshold].sum())
    stats = (total_area, int(object_areas.size), n_filtered, area_threshold, accepted / total_area if total_area else 0.0)
    return keep, stats


class _WindowStore(_SliceStore):
    """
    The march's label field as a window on the device (the protocol of
    ``track._SliceStore``). Before step t it holds slices t-2 onwards up to
    the end of the latest block: at a block's first step the block is paged
    in from pass A's store, and once a block of slices is final (every slice
    up to t-2 is) they are written to ``fin_store`` with their overlap
    pairs. So it holds at most about two blocks.

    A paged block's filled field is labelled again (the labels of pass A),
    renumbered to the kept objects (the filter's rows), its objects'
    properties entered in the table, given its global ids (cumulative
    offsets over the whole series) and its in-block pair lists entered in
    the march's pair cache. A pair across the block edge stays
    empty and is counted on demand, as a refreshed pair is; an entry the
    march has not invalidated holds two unchanged slices, so either way the
    cache holds what the in-memory march's initial list holds.
    """

    def __init__(self, tr: tracker, bits_store: str, fin_store: str, keep: List[np.ndarray], counts_old: np.ndarray,
                 block_T: int, writer: zarr_lite.RegionWriter):
        self.tr, self.fin_store, self.B, self.writer = tr, fin_store, block_T, writer
        self.bits = zarr_lite.LazyZarrArray(os.path.join(bits_store, "bits"))
        self.sshape = tuple(tr.data_bin.sizes[d] for d in tr._spatial_dims())
        self.keep = keep
        self.lmax_old = int(counts_old.max()) if counts_old.size else 0
        self.counts = np.array([int(k.sum()) for k in keep], np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.counts)[:-1]]).astype(np.int64)
        self.n_ids = int(self.counts.sum())
        self.table: Optional[ObjectTable] = None
        self.res: Dict[int, torch.Tensor] = {}
        self.pair_cache: List[Optional[np.ndarray]] = []
        self.final: List[np.ndarray] = []
        self.loaded = 0  # slices paged in so far
        self.done = 0  # slices written so far
        self.labels_max = 0
        self.processed_area: Optional[np.ndarray] = None
        self._blocks = _read_ahead(tr, lambda a, b: self.bits[a:b], self.T, block_T)

    @property
    def T(self) -> int:
        return self.bits.shape[0]

    def initial_pairs(self, tr: tracker) -> List[Optional[np.ndarray]]:
        self.pair_cache = [None] * max(self.T - 1, 0)
        return self.pair_cache

    def first_new_id(self, table: ObjectTable) -> int:
        self.table = table
        return self.n_ids + 1

    def begin_step(self, t: int) -> None:
        if t == self.loaded:
            self._page_in()
        while self.done + self.B <= t - 2:
            self._retire(self.done + self.B)

    def get_dev(self, t: int) -> torch.Tensor:
        return self.res[t]

    def set_dev(self, t: int, sl: torch.Tensor) -> None:
        self.res[t] = sl

    def final_pairs(self, tr: tracker) -> List[np.ndarray]:
        while self.done < self.T:
            self._retire(min(self.done + self.B, self.T))
        return self.final

    def flush(self) -> None:
        """The labels are in ``fin_store``: only the reader thread ends here."""
        self._blocks.close()

    def _rows(self, s0: int, s1: int) -> np.ndarray:
        """Old dense label -> kept dense id (0 = dropped or background), a row
        a slice of ``[s0, s1)``."""
        rows = np.zeros((s1 - s0, self.lmax_old + 1), np.int32)
        for t in range(s0, s1):
            k = self.keep[t]
            rows[t - s0, 1 : len(k) + 1] = np.where(k, np.cumsum(k), 0)
        return rows

    def _page_in(self) -> None:
        tr = self.tr
        s0, s1, bits = next(self._blocks)
        with tr._stage_ctx("march/page"):
            data = _unpack_bits(_to_device(bits, tr.device, torch.uint8), self.sshape)
            del bits
        old = _label_block(tr, data, "ccl", "march/page")[0]
        del data
        with tr._stage_ctx("march/page"):
            n = s1 - s0
            rows = torch.from_numpy(self._rows(s0, s1)).to(tr.device)
            labels = torch.gather(rows, 1, old.view(n, -1).long()).view(old.shape)
            del old, rows
            area = tr.compute_area(labels > 0)
            if self.processed_area is None:
                self.processed_area = np.zeros(self.T, area.dtype)
            self.processed_area[s0:s1] = area
        with tr._stage_ctx("march/props"):
            tr._compute_props_for_labels(labels, self.counts[s0:s1], self.offsets[s0:s1], self.table)
            off = torch.from_numpy(self.offsets[s0:s1].astype(np.int32)).to(tr.device)
            labels.add_(torch.where(labels > 0, off.view((n,) + (1,) * (labels.dim() - 1)), 0))
        with tr._stage_ctx("march/pairs"):
            self.pair_cache[s0 : s1 - 1] = tr._per_slice_pairs_device(labels)
        for i in range(n):
            self.res[s0 + i] = labels[i]
        self.loaded = s1
        tr._count_dispatch("march_block")

    def _retire(self, e: int) -> None:
        """Write the final slices ``[done, e)`` and count their overlap pairs
        (with slice e, when there is one: it is final too)."""
        tr, w = self.tr, self.done
        with tr._stage_ctx("march/overlaps"):
            stack = torch.stack([self.res[s] for s in range(w, min(e + 1, self.T))])
            self.final.extend(tr._per_slice_pairs_device(stack))
            block = stack[: e - w]
            self.labels_max = max(self.labels_max, int(block.max()))
        with tr._stage_ctx("stream/write"):
            self.writer.write(self.fin_store, "labels", (w,) + (0,) * (block.dim() - 1), block)
        for s in range(w, e):
            del self.res[s]
        self.done = e


def _pass_c(tr: tracker, fin_store: str, out_path: str, block_T: int, chunk: int, sshape: Tuple[int, ...],
            table: ObjectTable, overlap_list: np.ndarray, merge_events, labels_max: int, writer: zarr_lite.RegionWriter,
            readers: ThreadPoolExecutor):
    """The blockwise counterpart of ``tracker._cluster_rename``: the same
    union-find, then per block the (time, ID) table of original ids, the
    remap to event ids and the event statistics, each written to
    ``out_path``. Returns ``(events_ds, N_events)`` backed by the store."""
    T = tr.data_bin.sizes[tr.timedim]
    lookup, N, max_id = tr._event_lookup(table, overlap_list, labels_max)
    lookup_dev = torch.from_numpy(lookup).to(tr.device)
    time_vals = np.asarray(tr.data_bin.coords[tr.timecoord].values)
    merges_by_t = _merges_by_time(merge_events, time_vals)
    sibling = merges_by_t[2]

    NW = max(N, 1)  # a store array needs a column; an event-free run reads back zero wide
    tdims, sdims = (tr.timedim,), tr._spatial_dims()
    zarr_lite.create_group(out_path)
    zarr_lite.create_array(out_path, "ID_field", (T,) + sshape, np.int32, tdims + sdims, chunks=(chunk,) + sshape)
    for name, dtype in (("global_ID", np.int32), ("area", np.float32), ("presence", bool)):
        zarr_lite.create_array(out_path, name, (T, NW), dtype, (tr.timedim, "ID"), chunks=(block_T, NW))
    zarr_lite.create_array(out_path, "centroid", (2, T, NW), np.float32, ("component", tr.timedim, "ID"),
                           chunks=(2, block_T, NW))
    zarr_lite.create_array(out_path, "merge_ledger", (T, NW, sibling), np.int32, (tr.timedim, "ID", "sibling_ID"),
                           chunks=(block_T, NW, sibling))

    first_idx = np.full(N + 1, -1, np.int64)
    last_idx = np.zeros(N + 1, np.int64)
    cols = slice(1, None) if N else slice(0, 1)
    lab_lazy = zarr_lite.LazyZarrArray(os.path.join(fin_store, "labels"))
    for s0, s1, block in _read_ahead(tr, _ChunkRows(lab_lazy, readers), T, block_T):
        with tr._stage_ctx("stream/read"):
            labels = _to_device(block, tr.device, torch.int32)
        del block
        with tr._stage_ctx("rename/gid"):
            gid = _props.event_global_id_lookup(labels, lookup_dev, N)
        with tr._stage_ctx("rename/remap"):
            new = _label.remap_labels(lookup_dev, labels)
        with tr._stage_ctx("rename/stats"):
            areas, clat, clon = tr._event_stats(new, N)
            clat, clon = tr._centroid_units(clat, clon)
        pres = (gid > 0).cpu().numpy()
        # first and last presence, for time_start and time_end
        seen = pres.any(axis=0)
        first_new = seen & (first_idx < 0)
        first_idx[first_new] = s0 + pres.argmax(axis=0)[first_new]
        last_idx[seen] = s0 + (s1 - s0 - 1) - pres[::-1].argmax(axis=0)[seen]
        ledger = tr._ledger_block(merges_by_t, lookup, max_id, N, s0, s1)
        with tr._stage_ctx("stream/write"):
            zero = (0,) * len(sshape)
            writer.write(out_path, "ID_field", (s0,) + zero, new)
            writer.write(out_path, "global_ID", (s0, 0), gid[:, cols])
            writer.write(out_path, "area", (s0, 0), areas[:, cols])
            writer.write(out_path, "centroid", (0, s0, 0), torch.stack([clat[:, cols], clon[:, cols]]))
            writer.write(out_path, "presence", (s0, 0), pres[:, cols])
            writer.write(out_path, "merge_ledger", (s0, 0, 0), ledger[:, cols])
        del labels, new, gid, areas, clat, clon
    writer.flush()

    # an event never present gets the in-memory argmax's first and last slice
    never = first_idx < 0
    first_idx[never] = 0
    last_idx[never] = T - 1

    def stored(name: str):
        arr = zarr_lite.LazyZarrArray(os.path.join(out_path, name))
        if N or name == "ID_field":
            return arr
        # the placeholder column cut away: (..., ID[, sibling_ID]) zero wide
        return np.asarray(arr)[:, :0] if name == "merge_ledger" else np.asarray(arr)[..., :0]

    events_ds = tr._events_fieldset(
        stored("ID_field"), stored("global_ID"), stored("area"), stored("centroid"), stored("presence"),
        time_vals[first_idx][1:], time_vals[last_idx][1:], stored("merge_ledger"), N,
    )
    return events_ds, N
