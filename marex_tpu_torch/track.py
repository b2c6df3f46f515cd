"""
MarEx track on PyTorch: event identification and tracking.

The port of ``marex_tpu/track.py``: morphological hole and gap filling,
the area filter over per-slice connected components, then either 3x3x3
spatio-temporal event labelling (``allow_merging=False`` on a grid; from
``TWO_LEVEL_CELLS`` cells in two levels, per-slice labels joined across time
by a host union-find, as the reference does) or the split/merge march (``allow_merging=True``, the default, and always on a
mesh): per-slice objects linked through their overlaps, merging children
partitioned among their parents, and the objects clustered into events with
per-event area, centroid, presence and merge ledger. Grids are global
(periodic in longitude) or, with ``regional_mode=True``, open at every
boundary; ``unstructured_grid=True`` tracks (time, cell) data on a
triangular mesh given by its neighbour table and cell areas. The labellings
run on the hand-written CUDA kernels (the min-stencil or the mesh's
neighbour min, fused with the hook, and the pointer jump) when the field
lies on a GPU.

The march follows the reference's per-step form
(``tracker._split_and_merge_device``): its bookkeeping (thresholds,
consolidation chains, new ids, the ledger) is host Python on small tables,
and every full-field or per-slice array operation runs on the tracker's
device.

The mid-level API (``identify_objects``, ``calculate_object_properties``,
``check_overlap_slice``, ``find_overlapping_objects``) runs the same ops on
the tracker's device.

Preprocessing checkpoints (``checkpoint='save'``, ``'load'``, ``'auto'``)
persist the filtered field and its statistics as a zarr store and an
``.npz`` under ``temp_dir``. :meth:`tracker.run_streamed` tracks a field
larger than device memory in time blocks (``track_stream.py``), on the same
march through a windowed label store.

On a device mesh (``mesh=``, or ``parallel.use_mesh``) each process tracks
one slab of time slices: the spatial fill and the labels are local, the
temporal fill takes ``T_fill + 1`` slices from the neighbouring slabs, the
area filter and the event statistics gather small per-slice tables, no-merge
labelling joins the slabs' per-slice labels in two levels, and the merge
march runs slab after slab, each rank handing the next the march's state
(``_ShardStore``). The outputs equal one process's; ``ID_field`` is a
DTensor split over time. Device placement is explicit: a torch tensor input keeps its device; numpy or
``Field`` payloads move to ``device``; a lazy zarr payload stays on disk
until ``run()`` reads it whole or ``run_streamed()`` a block at a time.
"""

from __future__ import annotations

import hashlib
import logging
import os
import tempfile
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import tracing
from .core.field import Coord, Field, FieldSet, as_field, gathered, is_dtensor, on_device
from .detect import mesh_of
from .exceptions import ConfigurationError, TrackingError, create_coordinate_error, create_data_validation_error
from .logging_config import configure_logging, get_logger, log_array_info, log_memory_usage, log_timing
from .ops import label as _label
from .ops import morphology as _morph
from .ops import overlap as _overlap
from .ops import partition as _part
from .ops import properties as _props

logger = get_logger(__name__)

MAX_PARENTS = 10  # parent capacity per merge event

#: Cells (T*H*W) from which the 3-D event labelling (``ccl3d``, and
#: ``identify_objects(time_connectivity=True)``) runs in two levels, per-slice
#: labels joined across time by a host union-find, in place of the fused 3-D
#: fixpoint, whose flat indices are int32. Both give the same ids; tests lower
#: it to hold them equal.
TWO_LEVEL_CELLS = _label.BIG

# the scalar statistics of preprocessing, in the order of ``object_stats``
_STATS_KEYS = (
    "total_area_IDed",
    "N_objects_prefiltered",
    "N_objects_filtered",
    "area_threshold",
    "accepted_area_fraction",
    "preprocessed_area_fraction",
)


def _is_bool(data: Any) -> bool:
    return data.dtype == torch.bool if isinstance(data, torch.Tensor) else np.dtype(data.dtype) == np.bool_


def _dtype_name(field: Field) -> str:
    """A payload's dtype as numpy names it (``float32``), tensor or array."""
    return str(field.dtype).removeprefix("torch.")


class _SliceStore:
    """
    The merge march's label field, whole on the device. A rewritten slice is
    written into the field at once (the reference keeps overrides because
    its arrays are immutable), so ``flush`` only hands the field back.

    The march reads and writes only slices t-2, t-1 and t at step t, and
    slice t-1 is final once step t ends; it asks the store for what it needs
    through these methods, so a store that holds only a window of slices
    (``track_stream._WindowStore``) runs the same march.
    """

    #: whether the march's steps here end the series (the end-of-series
    #: consolidation is this store's)
    ends_series = True

    def __init__(self, labels: torch.Tensor):
        self.dev = labels

    @property
    def T(self) -> int:
        return self.dev.shape[0]

    def steps(self, march: "_March"):
        """The time steps the march runs here: all of them."""
        return range(self.T)

    def end_march(self, march: "_March", error: Optional[BaseException]) -> None:
        """Called when the steps end, with the error that ended them, if any."""
        if error is not None:
            raise error

    def initial_pairs(self, tr: "tracker") -> List[Optional[np.ndarray]]:
        """The pair cache at the start: every consecutive pair's overlaps."""
        return tr._per_slice_pairs_device(self.dev)

    def first_new_id(self, table: "ObjectTable") -> int:
        """The first id the march may allocate: above every object's."""
        return int(table.max_id()) + 1

    def begin_step(self, t: int) -> None:
        """Called before step t (the whole field is always here)."""

    def get_dev(self, t: int) -> torch.Tensor:
        return self.dev[t]

    def set_dev(self, t: int, sl: torch.Tensor) -> None:
        self.dev[t] = sl

    def final_pairs(self, tr: "tracker") -> List[np.ndarray]:
        """Every consecutive pair's overlaps on the final labels."""
        return tr._per_slice_pairs_device(self.dev)

    def flush(self) -> torch.Tensor:
        return self.dev


class _March:
    """The merge march's state between its steps: the object table, the pair
    cache, the next free id and the merge records."""

    def __init__(self, table: "ObjectTable", pairs: List[Optional[np.ndarray]], next_new_id: int):
        self.table = table
        self.pairs = pairs
        self.next_new_id = next_new_id
        self.merge_times: List[Any] = []
        self.merge_child_ids: List[np.ndarray] = []
        self.merge_parent_ids: List[np.ndarray] = []
        self.merge_areas: List[np.ndarray] = []

    def records(self) -> Tuple[List[Any], ...]:
        return self.merge_times, self.merge_child_ids, self.merge_parent_ids, self.merge_areas

    def set_records(self, records: Tuple[List[Any], ...]) -> None:
        self.merge_times, self.merge_child_ids, self.merge_parent_ids, self.merge_areas = (list(r) for r in records)


class ObjectTable:
    """Host registry of per-object properties: id -> (area, cy, cx)."""

    def __init__(self) -> None:
        self._rows: Dict[int, Tuple[float, float, float]] = {}

    def add(self, oid: int, area: float, c0: float, c1: float) -> None:
        self._rows[int(oid)] = (float(area), float(c0), float(c1))

    def drop(self, oid: int) -> None:
        self._rows.pop(int(oid), None)

    def __contains__(self, oid: int) -> bool:
        return int(oid) in self._rows

    def area(self, oid: int) -> float:
        return self._rows[int(oid)][0]

    def centroid(self, oid: int) -> Tuple[float, float]:
        _, c0, c1 = self._rows[int(oid)]
        return (c0, c1)

    def max_id(self) -> int:
        return max(self._rows.keys(), default=0)

    def ids(self) -> np.ndarray:
        return np.array(sorted(self._rows.keys()), dtype=np.int64)


class _ShardStore(_SliceStore):
    """
    The merge march's label field on a mesh (the protocol of
    :class:`_SliceStore`): this rank's slab of slices ``[t0, t1)`` on its
    device, and the two slices before it once the march reaches it.

    The march is sequential in time, so the ranks run their steps one after
    another. Rank r waits for rank r-1's hand-over (slices t0-2 and t0-1, the
    object table, the next free id, the merge records and the pair-cache
    entry of those two slices), runs its steps, sends slice t0-1 back to
    rank r-1 (its step t0's consolidation may change it), hands the same
    state on to rank r+1 and takes back its own last slice from it. Each card
    holds only its slab; the march is no faster than in one process. Every
    message is sent even after an error, carrying the error instead, so no
    rank waits for one that never comes; ``end_march`` then raises it on
    every rank, and otherwise gives every rank the last rank's table and
    records.
    """

    def __init__(self, labels: torch.Tensor, comm, T: int, t0: int, n_ids: int):
        super().__init__(labels)
        self.comm, self._T, self.t0, self.n_ids = comm, T, t0, n_ids
        self.t1 = t0 + labels.shape[0]
        self.prev = comm.index - 1 if comm.index > 0 else None
        self.next = comm.index + 1 if comm.index + 1 < comm.size else None
        self.halo: Dict[int, torch.Tensor] = {}
        self._sent_back = self._sent_on = self._taken_back = False

    @property
    def T(self) -> int:
        return self._T

    @property
    def ends_series(self) -> bool:
        return self.next is None

    def initial_pairs(self, tr: "tracker") -> List[Optional[np.ndarray]]:
        pairs: List[Optional[np.ndarray]] = [None] * max(self.T - 1, 0)
        pairs[self.t0 : self.t1 - 1] = tr._per_slice_pairs_device(self.dev)
        return pairs

    def first_new_id(self, table: "ObjectTable") -> int:
        return self.n_ids + 1

    def get_dev(self, t: int) -> torch.Tensor:
        return self.dev[t - self.t0] if t >= self.t0 else self.halo[t]

    def set_dev(self, t: int, sl: torch.Tensor) -> None:
        if t >= self.t0:
            self.dev[t - self.t0] = sl
        else:
            self.halo[t] = sl

    def _edge(self, t1: int) -> List[int]:
        """The slices a hand-over carries: the two before ``t1``."""
        return [t for t in (t1 - 2, t1 - 1) if t >= 0]

    def _recv(self, src: int, n_slices: int) -> Tuple[Any, List[torch.Tensor]]:
        """A message and its slices; the error it carries is raised."""
        from .parallel.comm import rebuilt_error

        kind, obj = self.comm.recv_obj(src)
        if kind == "error":
            raise rebuilt_error(obj)
        shape, dtype = self.dev.shape[1:], self.dev.dtype
        return obj, [self.comm.recv_tensor(shape, dtype, src) for _ in range(n_slices)]

    def steps(self, march: "_March"):
        if self.prev is not None:
            state, slices = self._recv(self.prev, len(self._edge(self.t0)))
            own = march.table
            march.table = ObjectTable()
            march.table._rows = state["table"]
            march.table._rows.update(own._rows)
            march.next_new_id = state["next_new_id"]
            march.set_records(state["records"])
            if self.t0 >= 2:
                march.pairs[self.t0 - 2] = state["pairs"]
            self.halo = dict(zip(self._edge(self.t0), slices))
        yield from range(self.t0, self.t1)
        if self.prev is not None:
            self._sent_back = True
            self.comm.send(("ok", None), [self.halo[self.t0 - 1]], self.prev)
        if self.next is not None:
            self._sent_on = True
            state = {"table": march.table._rows, "next_new_id": march.next_new_id, "records": march.records(),
                     "pairs": march.pairs[self.t1 - 2] if self.t1 >= 2 else None}
            self.comm.send(("ok", state), [self.get_dev(t) for t in self._edge(self.t1)], self.next)
            self._taken_back = True
            _, (last,) = self._recv(self.next, 1)
            self.set_dev(self.t1 - 1, last)

    def end_march(self, march: "_March", error: Optional[BaseException]) -> None:
        if error is not None:
            from .parallel.comm import portable_error

            message = ("error", portable_error(error))
            if self.prev is not None and not self._sent_back:
                self.comm.send(message, [], self.prev)
            if self.next is not None and not self._sent_on:
                self.comm.send(message, [], self.next)
            if self.next is not None and not self._taken_back:
                try:
                    self._recv(self.next, 1)
                except Exception:
                    pass  # the next rank failed too: this rank's own error goes on
        self.comm.agree(error)
        table, records, next_new_id = self.comm.broadcast(
            (march.table._rows, march.records(), march.next_new_id), self.comm.size - 1)
        march.table = ObjectTable()
        march.table._rows = table
        march.set_records(records)
        march.next_new_id = next_new_id

    def final_pairs(self, tr: "tracker") -> List[np.ndarray]:
        """Every consecutive pair's overlaps: this slab's, the pair across its
        end (with the next rank's first slice), gathered in time order."""
        _, after = self.comm.halo(self.dev, 0, 0, 1)
        own = tr._per_slice_pairs_device(self.dev)
        if after.shape[0]:
            own += tr._per_slice_pairs_device(torch.stack([self.dev[-1], after[0]]))
        return [p for part in self.comm.gather(own) for p in part]


class tracker:
    """
    Identify and track binary objects through time (API-compatible with
    ``marex_tpu.tracker``): gridded global or regional data, or (time, cell)
    data on an unstructured mesh, with and without merging.

    ``data_bin`` / ``mask`` may be Fields (of this package or duck-typed
    equivalents) with numpy or torch payloads; ``device`` places payloads
    that are not already tensors.

    ``mesh`` (a ``DeviceMesh`` from ``parallel.make_mesh``, or True for a
    mesh over every process of the ``torch.distributed`` world; None takes
    ``parallel.use_mesh``'s) tracks on every process of the mesh, each on
    one slab of time slices (``parallel.track_sharding``; a DTensor input
    is redistributed, a host one cut before its upload), or on all of them
    when time does not divide by the mesh's size (the replicated route).
    Every process must construct the tracker and call :meth:`run`; the
    outputs equal one process's, ``ID_field`` a DTensor split over time and
    the (time, ID) tables whole on every rank.
    """

    def __init__(
        self,
        data_bin: Any,
        mask: Any,
        R_fill: Union[int, float],
        area_filter_quartile: Optional[float] = None,
        area_filter_absolute: Optional[int] = None,
        temp_dir: Optional[str] = None,
        T_fill: int = 2,
        allow_merging: bool = True,
        nn_partitioning: bool = False,
        overlap_threshold: float = 0.5,
        unstructured_grid: bool = False,
        dimensions: Optional[Dict[str, str]] = None,
        coordinates: Optional[Dict[str, str]] = None,
        neighbours: Optional[Any] = None,
        cell_areas: Optional[Any] = None,
        grid_resolution: Optional[float] = None,
        max_iteration: int = 40,
        checkpoint: Optional[str] = None,
        debug: int = 0,
        verbose: Optional[bool] = None,
        quiet: Optional[bool] = None,
        regional_mode: bool = False,
        coordinate_units: Optional[str] = None,
        mesh: Optional[Any] = None,
        merge_ledger_mode: str = "reference",
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        if verbose is not None or quiet is not None:
            configure_logging(verbose=verbose, quiet=quiet)
        self.mesh = mesh_of(mesh, device)
        #: the mesh's collectives while time is split over it (None in one
        #: process and on the replicated route)
        self._comm = None
        if self.mesh is not None:
            from .parallel.mesh import mesh_device

            device = mesh_device(self.mesh)
        if merge_ledger_mode not in ("reference", "siblings"):
            raise ConfigurationError(
                f"Invalid merge_ledger_mode '{merge_ledger_mode}'",
                details="merge_ledger_mode selects the merge_ledger fill scheme",
                suggestions=[
                    "Use 'reference' (default) for the reference's scheme: each merging parent's own id broadcast over sibling slots",
                    "Use 'siblings' for the richer scheme recording the full merge-partner list per parent",
                ],
            )
        self.merge_ledger_mode = merge_ledger_mode

        logger.info("Initialising MarEx tracker (PyTorch)")
        logger.info(
            f"Parameters: R_fill={R_fill}, T_fill={T_fill}, "
            f"area_filter_quartile={area_filter_quartile}, area_filter_absolute={area_filter_absolute}"
        )

        self.data_bin = as_field(data_bin)
        self.mask = as_field(mask)
        if is_dtensor(self.mask.data):  # the mask is whole on every rank
            self.mask = self.mask._replace(data=gathered(self.mask.data))
        if not isinstance(self.mask.data, (torch.Tensor, np.ndarray)):
            self.mask = self.mask.compute()  # a lazy zarr mask: one slice, read now
        log_array_info(logger, self.data_bin, "Binary input data")

        self.regional_mode = bool(regional_mode)
        self.unstructured_grid = bool(unstructured_grid)
        self.temp_dir = temp_dir
        self.max_iteration = max_iteration
        self.checkpoint = checkpoint
        self.debug = debug
        self.allow_merging = allow_merging
        self.nn_partitioning = nn_partitioning
        self.coordinate_units = coordinate_units

        dimensions = dimensions or {}
        coordinates = coordinates or {}
        self.timedim = dimensions.get("time", "time")
        self.xdim = dimensions.get("x", "lon")
        self.ydim: Optional[str] = dimensions.get("y", "lat")
        self.timecoord = coordinates.get("time", self.timedim)
        # on a mesh the coordinates default to lon and lat, not to the dim names
        self.xcoord = coordinates.get("x", "lon" if unstructured_grid else self.xdim)
        self.ycoord = coordinates.get("y", "lat" if unstructured_grid else self.ydim)

        if self.xcoord not in self.data_bin.coords or self.ycoord not in self.data_bin.coords:
            raise create_data_validation_error(
                "Missing required coordinates in input data",
                details=f"Expected coordinates ({self.timecoord}, {self.xcoord}, {self.ycoord}), "
                f"found {list(self.data_bin.coords)}",
                suggestions=[
                    "Ensure data_bin contains time, x, and y coordinates",
                    "Specify coordinates in the tracker initialisation with `coordinates` parameter.",
                ],
            )

        self.lat_init = np.array(self.data_bin.coords[self.ycoord].values, copy=True)
        self.lon_init = np.array(self.data_bin.coords[self.xcoord].values, copy=True)
        self._unify_coordinates()

        self.R_fill = int(R_fill)
        self.T_fill = T_fill
        self._resolve_area_filtering_parameters(area_filter_quartile, area_filter_absolute)
        if not (0.0 <= float(overlap_threshold) <= 1.0):
            raise ConfigurationError(
                f"Invalid overlap_threshold {overlap_threshold}",
                details="overlap_threshold is the minimum overlap fraction (0-1) for linking objects in time",
                suggestions=[
                    "Use a value between 0 and 1 (the reference default is 0.5)",
                    "Lower the threshold to link more objects; raise it to link fewer",
                ],
                context={"overlap_threshold": overlap_threshold},
            )
        self.overlap_threshold = float(overlap_threshold)

        self.lat = np.asarray(self.data_bin.coords[self.ycoord].values, dtype=np.float64)
        self.lon = np.asarray(self.data_bin.coords[self.xcoord].values, dtype=np.float64)
        self.data_attrs = dict(self.data_bin.attrs)

        self._validate_inputs(neighbours, cell_areas, grid_resolution, temp_dir)

        # payloads on their device: the binary field, and the mask beside it.
        # A lazy zarr payload stays on disk: run() reads it whole,
        # run_streamed() a block at a time; on a mesh run() takes this rank's slab
        self._n_time = self.data_bin.sizes[self.timedim]
        self._t0 = 0  # this rank's first slice
        if self.mesh is not None:
            from .parallel.comm import ShardComm

            comm = ShardComm(self.mesh)
            if self._n_time > 0 and self._n_time % comm.size == 0:
                self._comm = comm
                self._t0 = comm.bounds(self._n_time)[0]
            else:
                logger.info(f"{self.timedim} ({self._n_time}) does not split over {comm.size} ranks: "
                            "tracking runs replicated")
        elif isinstance(self.data_bin.data, (torch.Tensor, np.ndarray)):
            self.data_bin = self.data_bin._replace(data=on_device(self.data_bin.data, device).contiguous())
            device = self.data_bin.data.device
        self.mask_dev = on_device(self.mask.data, device).to(device)
        self.device = self.mask_dev.device
        #: the tracker's view of its stage spans (``tracing``): the seconds of
        #: each stage, added up over its calls
        self.stage_walls: Dict[str, float] = {}
        #: each stage's own peak of allocated device memory in bytes (its
        #: largest over its calls), read inside ``tracing.collect()`` on CUDA
        self.stage_peak_bytes: Dict[str, int] = {}
        #: labelling iterations by stage (also the counters ``ccl/iterations/<stage>``)
        self.ccl_iterations: Dict[str, int] = {}
        #: device calls of the merge march by kind: "pairs" (one slice pair's
        #: overlaps refreshed), "consolidate", "partition" (also the counters
        #: ``march/dispatch/<kind>``)
        self.dispatch_counts: Dict[str, int] = {}
        # the area filter's per-slice roots, kept for the merge path's labels
        self._label_reuse = None

        # ---- cell areas -------------------------------------------------
        if unstructured_grid:
            self._setup_mesh(neighbours, cell_areas)
            return
        self.neighbours_int = self.neighbours_sym = None
        ny, nx = len(self.lat), len(self.lon)
        if grid_resolution is not None:
            logger.info(f"Calculating cell areas from grid resolution: {grid_resolution} degrees")
            R_earth = 6378.0
            lat_r = np.radians(self.lat)
            dlat = np.radians(grid_resolution)
            dlon = np.radians(grid_resolution)
            grid_area = (R_earth**2 * np.abs(np.sin(lat_r + dlat / 2) - np.sin(lat_r - dlat / 2)) * dlon).astype(np.float32)
            if cell_areas is not None:
                logger.warning("grid_resolution parameter overrides provided cell_areas for structured grid")
            self.cell_area = np.broadcast_to(grid_area[:, None], (ny, nx)).astype(np.float32).copy()
        elif cell_areas is None:
            self.cell_area = np.ones((ny, nx), dtype=np.float32)
            logger.info("No cell_areas provided for structured grid - using unit areas (cell counts)")
        else:
            ca = as_field(cell_areas)
            if set(ca.dims) != {self.ydim, self.xdim}:
                raise create_data_validation_error(
                    "Invalid cell_areas dimensions for structured grid",
                    details=f"Expected spatial dimensions {{{self.ydim}, {self.xdim}}}, got {set(ca.dims)}",
                    suggestions=["Ensure cell_areas matches the spatial dimensions of your data"],
                )
            self.cell_area = np.asarray(ca.transpose(self.ydim, self.xdim).values, dtype=np.float32)
        self.mean_cell_area = float(np.mean(self.cell_area))

    def _setup_mesh(self, neighbours: Any, cell_areas: Any) -> None:
        """The mesh's cell areas and neighbour tables: the (3, C) table as
        given, 0-based with -1 for missing, which morphology and the
        partition's search follow, and its symmetrised (K', C) form, which
        labelling follows (mesh files carry asymmetric entries, and the
        reference labels the undirected graph)."""
        ca = as_field(cell_areas, dims=(self.xdim,), name="cell_areas")
        self.cell_area = np.asarray(ca.values, dtype=np.float32)
        self.mean_cell_area = float(np.mean(self.cell_area))
        nb = as_field(neighbours, dims=("nv", self.xdim), name="neighbours")
        nb_vals = np.asarray(nb.values, dtype=np.int32)
        if nb_vals.shape[0] != 3:
            raise create_data_validation_error(
                "Invalid neighbour array for triangular grid",
                details=f"Expected shape (3, ncells), got {nb_vals.shape}",
                suggestions=[
                    "Ensure triangular grid connectivity",
                    "Check neighbour array from grid file",
                    "Verify unstructured grid format",
                ],
                data_info={"actual_shape": nb_vals.shape, "expected_shape": "(3, ncells)"},
            )
        if tuple(nb.dims) != ("nv", self.xdim):
            raise create_data_validation_error(
                "Invalid neighbour array dimensions",
                details=f"Expected dimensions ('nv', '{self.xdim}'), got {nb.dims}",
                suggestions=["Check dimension names in grid file", "Verify coordinate mapping"],
                data_info={"actual_dims": nb.dims, "expected_dims": ("nv", self.xdim)},
            )
        self.neighbours_int = nb_vals - 1
        self.neighbours_sym = _symmetrize_neighbours(self.neighbours_int)
        dev = self.device
        self._nb_dev = torch.from_numpy(self.neighbours_int).to(dev)
        self._nb_sym_dev = torch.from_numpy(self.neighbours_sym).to(dev)
        self._cell_area_dev = torch.from_numpy(self.cell_area).to(dev)
        self._mesh_unit = torch.from_numpy(_props.mesh_unit_vectors(self.lat, self.lon)).to(dev)
        self._mesh_wall = _props.mesh_weights(self.lat, self.lon, self.cell_area, dev)

    @property
    def _wrap(self) -> bool:
        """Periodic in longitude: every gridded run but a regional one."""
        return not self.regional_mode

    def _spatial_dims(self) -> Tuple[str, ...]:
        return (self.xdim,) if self.unstructured_grid else (self.ydim, self.xdim)

    # ------------------------------------------------------------------
    # Validation & coordinates
    # ------------------------------------------------------------------

    def _resolve_area_filtering_parameters(
        self, area_filter_quartile: Optional[float], area_filter_absolute: Optional[int]
    ) -> None:
        provided = sum(x is not None for x in (area_filter_quartile, area_filter_absolute))
        if provided == 0:
            self.area_filter_quartile = 0.5
            self.area_filter_absolute = 0
            self._use_absolute_filtering = False
        elif provided == 1:
            if area_filter_quartile is not None:
                self.area_filter_quartile = area_filter_quartile
                self.area_filter_absolute = 0
                self._use_absolute_filtering = False
            else:
                self.area_filter_quartile = 0.0
                self.area_filter_absolute = area_filter_absolute
                self._use_absolute_filtering = True
        else:
            raise ConfigurationError(
                "Cannot specify both area filtering parameters",
                details="area_filter_quartile and area_filter_absolute are mutually exclusive",
                suggestions=[
                    "Use area_filter_quartile for percentile-based filtering (e.g., 0.25 for smallest 25%)",
                    "Use area_filter_absolute for fixed minimum area (e.g., 10 for minimum 10 cells)",
                    "Omit both parameters to use default quartile filtering (0.5)",
                ],
                context={
                    "area_filter_quartile": area_filter_quartile,
                    "area_filter_absolute": area_filter_absolute,
                },
            )

    def _validate_inputs(
        self, neighbours: Any, cell_areas: Any, grid_resolution: Optional[float], temp_dir: Optional[str]
    ) -> None:
        if self.regional_mode and self.unstructured_grid:
            raise NotImplementedError("regional_mode is not yet implemented for unstructured grids")

        if self.unstructured_grid:
            self.ydim = None
            if tuple(self.data_bin.dims) != (self.timedim, self.xdim):
                try:
                    self.data_bin = self.data_bin.transpose(self.timedim, self.xdim)
                except ValueError:
                    raise create_data_validation_error(
                        "Invalid dimensions for unstructured data",
                        details=f"Expected 2D array with dimensions ({self.timedim}, {self.xdim}), "
                        f"got {list(self.data_bin.dims)}",
                        suggestions=["Ensure data has time and cell dimensions only"],
                    )
        elif tuple(self.data_bin.dims) != (self.timedim, self.ydim, self.xdim):
            try:
                self.data_bin = self.data_bin.transpose(self.timedim, self.ydim, self.xdim)
            except ValueError:
                raise create_data_validation_error(
                    "Invalid dimensions for gridded data",
                    details=f"Expected 3D array with dimensions ({self.timedim}, {self.ydim}, {self.xdim}), "
                    f"got {list(self.data_bin.dims)}",
                    suggestions=["Ensure data has time, latitude, and longitude dimensions"],
                )

        if not _is_bool(self.data_bin.data):
            raise create_data_validation_error(
                "Input DataArray must be binary (boolean type)",
                details=f"Found dtype {_dtype_name(self.data_bin)}, expected bool",
                suggestions=[
                    "Convert data using da > threshold for binary events",
                    "Use field.astype(bool) for boolean conversion",
                ],
                data_info={"actual_dtype": _dtype_name(self.data_bin), "expected_dtype": "bool"},
            )

        if self.unstructured_grid:
            if neighbours is None:
                raise create_data_validation_error(
                    "neighbours array is required for unstructured grids",
                    details="Unstructured grid processing requires cell connectivity information",
                    suggestions=["Provide a neighbours parameter when using unstructured_grid=True"],
                )
            if cell_areas is None:
                raise create_data_validation_error(
                    "cell_areas array is required for unstructured grids",
                    details="Unstructured grid processing requires cell area information",
                    suggestions=["Provide a cell_areas parameter when using unstructured_grid=True"],
                )

        if grid_resolution is not None:
            if self.unstructured_grid:
                raise create_data_validation_error(
                    "grid_resolution parameter is not supported for unstructured grids",
                    details="Grid resolution calculation requires structured (lat/lon) coordinates",
                    suggestions=["Use cell_areas parameter directly for unstructured grids"],
                )
            if not isinstance(grid_resolution, (int, float)) or grid_resolution <= 0:
                raise create_data_validation_error(
                    "grid_resolution must be a positive number",
                    details=f"Received grid_resolution={grid_resolution}",
                    suggestions=["Provide a positive float value representing grid resolution in degrees"],
                )

        if not _is_bool(self.mask.data):
            raise create_data_validation_error(
                "Mask must be binary (boolean type)",
                details=f"Found mask dtype {_dtype_name(self.mask)}, expected bool",
                suggestions=["Convert mask using mask > 0 or mask.astype(bool)"],
                data_info={"mask_dtype": _dtype_name(self.mask)},
            )

        if not bool(self.mask.data.any()):
            raise create_data_validation_error(
                "Mask contains only False values",
                details="Mask should indicate valid regions with True values",
                suggestions=[
                    "Check mask orientation - it should mark valid (ocean) regions as True",
                    "Invert mask if needed: mask = ~mask",
                ],
            )

        if not self._use_absolute_filtering:
            if (self.area_filter_quartile < 0) or (self.area_filter_quartile > 1):
                raise ConfigurationError(
                    "Invalid area_filter_quartile value",
                    details=f"Value {self.area_filter_quartile} is outside valid range [0, 1]",
                    suggestions=[
                        "Use values between 0.0 and 1.0",
                        "Use 0.25 to filter smallest 25% of events",
                    ],
                    context={"provided_value": self.area_filter_quartile, "valid_range": [0, 1]},
                )
        elif self.area_filter_absolute <= 0:
            raise ConfigurationError(
                "Invalid area_filter_absolute value",
                details=f"area_filter_absolute={self.area_filter_absolute} must be positive",
                suggestions=["Set area_filter_absolute to a positive integer (e.g., 5, 10, 50)"],
                context={"area_filter_absolute": self.area_filter_absolute},
            )

        if self.T_fill % 2 != 0:
            raise ConfigurationError(
                "T_fill must be even for temporal symmetry",
                details=f"Provided T_fill={self.T_fill} is odd",
                suggestions=["Use even values: 2, 4, 6, 8, etc."],
                context={"provided_value": self.T_fill, "requirement": "even number"},
            )

    def _unify_coordinates(self) -> None:
        """Auto-detect units (a regional run must state them) and convert
        radians -> degrees."""
        if self.regional_mode and self.coordinate_units is None:
            raise create_coordinate_error(
                "coordinate_units must be specified when regional_mode=True",
                suggestions=[
                    "Set coordinate_units='degrees' for degree-based coordinates",
                    "Set coordinate_units='radians' for radian-based coordinates",
                ],
            )
        if self.coordinate_units is not None:
            if self.coordinate_units not in ("degrees", "radians"):
                raise create_coordinate_error(
                    f"Invalid coordinate_units '{self.coordinate_units}'",
                    details="coordinate_units must be either 'degrees' or 'radians'",
                    suggestions=["Use coordinate_units='degrees' or coordinate_units='radians'"],
                )
        else:
            lon = np.asarray(self.data_bin.coords[self.xcoord].values, dtype=np.float64)
            lon_range = float(lon.max() - lon.min())
            # tolerate one grid-spacing short of the full circle (endpoint-free grids)
            tol_deg = max(1.0, 360.0 / max(lon.size, 1) + 1e-6)
            tol_rad = max(0.02, 2 * np.pi / max(lon.size, 1) + 1e-9)
            if abs(lon_range - 360.0) <= tol_deg:
                self.coordinate_units = "degrees"
            elif abs(lon_range - 2 * np.pi) <= tol_rad:
                self.coordinate_units = "radians"
            else:
                raise create_coordinate_error(
                    f"Cannot auto-detect coordinate units from range {lon_range:.3f}",
                    details=f"Expected ranges: ~360 degrees or ~{2*np.pi:.3f} radians. Found range: {lon_range:.3f}",
                    suggestions=[
                        "Use regional_mode=True with coordinate_units specified for regional data",
                        "Specify coordinate_units='degrees' or coordinate_units='radians' explicitly",
                    ],
                    context={"detected_range": lon_range, "xdim": self.xcoord},
                )

        if self.coordinate_units == "radians":
            for cname in (self.xcoord, self.ycoord):
                c = self.data_bin.coords[cname]
                self.data_bin.coords[cname] = Coord(c.dims, np.asarray(c.values) * 180.0 / np.pi)

    # ------------------------------------------------------------------
    # Main public pipeline
    # ------------------------------------------------------------------

    def run(self, return_merges: bool = False, checkpoint: Optional[str] = None):
        """Run preprocessing, tracking and statistics; returns the events
        FieldSet, or ``(events, merges)`` with ``return_merges`` when
        merging is on. ``checkpoint`` ('save', 'load' or 'auto') overrides
        the tracker's own (:meth:`run_preprocess`)."""
        with tracing.span("track", self.device):
            if self._comm is not None:
                with self._comm.guard():
                    return self._run(return_merges, checkpoint)
            return self._run(return_merges, checkpoint)

    def _run(self, return_merges: bool, checkpoint: Optional[str]):
        logger.info("Starting complete tracking pipeline")
        log_memory_usage(logger, "Pipeline start", logging.DEBUG)

        with log_timing(logger, "Data preprocessing", log_memory=True, span="track/preprocess"):
            data_bin_preprocessed, object_stats = self.run_preprocess(checkpoint=checkpoint)

        with log_timing(logger, "Object identification and tracking", log_memory=True, span="track/tracking"):
            events_ds, merges_ds, N_events_final = self.run_tracking(data_bin_preprocessed)
        del data_bin_preprocessed

        with log_timing(logger, "Computing event statistics and attributes", log_memory=True, span="track/stats"):
            events_ds = self.run_stats_attributes(events_ds, merges_ds, object_stats, N_events_final)

        logger.info(f"Tracking pipeline completed successfully - {N_events_final} events identified")
        if self.allow_merging and return_merges:
            return events_ds, merges_ds
        return events_ds

    def run_streamed(
        self,
        out_path: str,
        memory_budget_mb: int = 4096,
        block_T: Optional[int] = None,
        return_merges: bool = False,
    ):
        """
        Track a field larger than device memory: the whole pipeline
        (morphology, area filter, split/merge march, event clustering and
        statistics) streams over time blocks, and the outputs are written to
        the zarr store ``out_path`` as they are made (``track_stream.py``).
        ``data_bin`` may be a lazy zarr payload. Equal to :meth:`run`;
        merging runs only (``allow_merging=True``). Returns the events
        FieldSet backed by the store, or ``(events, merges)`` with
        ``return_merges``.

        The streamed tracker runs in one process, whatever the mesh, as
        ``marex_tpu``'s does. With a mesh, every rank calls this: the mesh's
        first rank runs the tracker on its own device (a DTensor input
        gathered whole first, by every rank) and alone writes ``out_path``,
        while the others wait, as long as the process group's timeout
        allows; an error there is raised on every rank. Every rank then
        returns the same events, backed by the same store, so ``out_path``
        must be a directory that every rank can read.
        """
        from .track_stream import run_tracking_streamed

        def run():
            with tracing.span("track", self.device):
                return run_tracking_streamed(
                    self, out_path, memory_budget_mb=memory_budget_mb, block_T=block_T, return_merges=return_merges
                )

        if self.mesh is None:
            return run()
        from .parallel.comm import ShardComm

        comm = self._comm or ShardComm(self.mesh)
        data = gathered(self.data_bin.data) if is_dtensor(self.data_bin.data) else self.data_bin.data
        result = None
        with comm.guard():
            if comm.index == 0:
                with self._in_one_process(data):
                    result = run()
        return comm.broadcast(result, 0)

    @contextmanager
    def _in_one_process(self, data: Any):
        """The tracker as one process's, on ``data`` (the whole field), while
        the block runs: no mesh, no slab."""
        saved = self.mesh, self._comm, self._t0, self.data_bin
        self.mesh, self._comm, self._t0 = None, None, 0
        self.data_bin = self.data_bin._replace(data=data)
        try:
            yield
        finally:
            self.mesh, self._comm, self._t0, self.data_bin = saved

    def _stage_ctx(self, name: str):
        """The tracing span of a pipeline stage, seen in ``stage_walls`` and
        ``stage_peak_bytes``; on CUDA it waits for the tracker's device. The
        benchmark reads these walls without ``tracing.collect()``, so a stage
        records outside it too (``tracing._VIEWS``)."""
        return tracing.span(name, self.device, self.stage_walls, self.stage_peak_bytes)

    def _count_iterations(self, stage: str, iters: int, most: bool = False) -> None:
        """A labelling fixpoint's iterations under ``stage``: the counter adds
        them up, the view keeps the last (with ``most``, the largest)."""
        self.ccl_iterations[stage] = max(self.ccl_iterations.get(stage, 0), iters) if most else iters
        tracing.count(f"ccl/iterations/{stage}", iters)

    # -- a mesh's slabs ------------------------------------------------

    def _joined(self, local: np.ndarray) -> np.ndarray:
        """A host array of this rank's slices (or their objects) joined with
        the other ranks' in time order, as one process has it."""
        return local if self._comm is None else np.concatenate(self._comm.gather(local))

    def _joined_dev(self, local: torch.Tensor) -> torch.Tensor:
        """:meth:`_joined` of a (T_rank, ...) tensor, on its device."""
        if self._comm is None:
            return local
        return torch.from_numpy(self._joined(local.cpu().numpy())).to(local.device)

    def _sharded(self, local: torch.Tensor) -> torch.Tensor:
        """A (T_rank, ...) result of this rank's slices as the whole field's
        DTensor under ``track_sharding`` (replicated on that route); as it is
        in one process."""
        if self.mesh is None:
            return local
        from .parallel.mesh import from_local, replicated, track_sharding

        sharding = track_sharding(self.mesh) if self._comm is not None else replicated(self.mesh)
        return from_local(local.contiguous(), sharding, (self._n_time,) + tuple(local.shape[1:]))

    def _slab(self) -> torch.Tensor:
        """The binary field this rank tracks, on its device: all of it in one
        process and on the replicated route, else its slab of slices. A
        DTensor is redistributed; a host payload is cut before the upload."""
        data = self.data_bin.data
        if self.mesh is None:
            return on_device(data, self.device).contiguous()
        if is_dtensor(data):
            from .parallel.mesh import constrain, replicated, track_sharding

            sharding = track_sharding(self.mesh) if self._comm is not None else replicated(self.mesh)
            return constrain(data, sharding).to_local().to(self.device).contiguous()
        if self._comm is not None:
            data = data[self._t0 : self._t0 + self._n_time // self._comm.size]
        data = data if isinstance(data, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(data))
        return data.to(self.device).contiguous()

    # ------------------------------------------------------------------
    # Stage 1: preprocessing
    # ------------------------------------------------------------------

    def compute_area(self, data_bin: torch.Tensor) -> np.ndarray:
        """Active cell count per timestep (int32 accumulator: a bool sum
        first casts the whole field to it), or on a mesh the active area (a
        float64 sum of the float32 cell areas, rounded to float32), as a
        small host array."""
        if self.unstructured_grid:
            area = self._cell_area_dev.double()
            tb = _morph._TIME_CHUNK
            sums = [data_bin[t0 : t0 + tb].double() @ area for t0 in range(0, data_bin.shape[0], tb)]
            return torch.cat(sums).float().cpu().numpy()
        return data_bin.sum(dim=(1, 2), dtype=torch.int32).cpu().numpy()

    def fill_holes(self, data: torch.Tensor, R_fill: Optional[int] = None) -> torch.Tensor:
        """Morphological closing+opening with a disk of ``R_fill`` (on a
        mesh: by ``R_fill`` hops over the neighbour table as given)."""
        if R_fill is None:
            R_fill = self.R_fill
        if self.unstructured_grid:
            return _morph.binary_close_open_unstructured(data, self._nb_dev, self.mask_dev, int(R_fill))
        return _morph.binary_close_open_grid(data, int(R_fill), self.mask_dev, mode="wrap" if self._wrap else "edge")

    def fill_time_gaps(self, data: torch.Tensor) -> torch.Tensor:
        """Temporal closing, then a re-fill of new spatial holes at R_fill //
        2. On a mesh ``data`` is this rank's slab, closed with ``T_fill + 1``
        slices of the neighbouring slabs on each side (the closing's False
        pad only at the series' own ends)."""
        if self.T_fill == 0:
            return data
        if self._comm is None:
            closed = _morph.binary_close_time(data, int(self.T_fill))
        else:
            k = int(self.T_fill) + 1
            before, after = self._comm.halo(data, 0, k, k)
            closed = _morph.binary_close_time(torch.cat([before, data, after]), int(self.T_fill))
            closed = closed[before.shape[0] : before.shape[0] + data.shape[0]]
        return self.fill_holes(closed, R_fill=self.R_fill // 2)

    def filter_small_objects(self, data: torch.Tensor):
        """
        Remove per-slice objects below the area threshold. Returns
        ``(filtered, area_threshold, object_areas, N_prefiltered, N_filtered)``.

        On a grid, like the reference, the globally first object (smallest
        root of the first slice holding any) is always dropped: the reference
        marks ``object_ids_keep[0] = -1`` meaning to skip the background id 0,
        which is never in that list, so its first real object goes. On a mesh
        nothing of the kind happens (:meth:`_filter_small_objects_mesh`).

        On a device mesh ``data`` is this rank's slab: the per-slice counts and
        the object areas are gathered in time order, so the threshold and
        the statistics are one process's, and only the rank that holds the
        first object drops it.
        """
        if self.unstructured_grid:
            return self._filter_small_objects_mesh(data)
        with self._stage_ctx("filter/ccl_fixpoint"):
            root_flat, counts_dev, iters = _label.label_slices_grid_roots(data, wrap_x=self._wrap)
            counts_own = counts_dev.cpu().numpy()
        self._count_iterations("filter/ccl_fixpoint", iters)
        counts = self._joined(counts_own)
        L = int(counts.max()) if counts.size else 0
        if L == 0:
            raise TrackingError(
                "No objects found for area-based filtering",
                details={"objects_count": 0, "area_filter_quartile": self.area_filter_quartile},
                suggestions=[
                    "Check if input data contains any extreme events",
                    "Verify that preprocessing parameters are appropriate",
                    "Consider lowering the extreme threshold percentile",
                ],
            )
        # the first object is in slice t_first, which this rank may hold
        t_first = int(np.argmax(counts > 0)) - self._t0
        holds_first = 0 <= t_first < data.shape[0]
        L_own = int(counts_own.max()) if counts_own.size else 0
        with self._stage_ctx("filter/root_stats"):
            root_ids, areas_dev, area_cell, _ = _label.slice_root_stats(root_flat, L_own)
            areas_tj = areas_dev.cpu().numpy()  # (T, L) ascending root order, 0 padded
        slot = np.arange(L_own)[None, :] < counts_own[:, None]
        object_areas = self._joined(areas_tj[slot])  # the first object's area first

        N_prefiltered = int(object_areas.size)
        if self._use_absolute_filtering:
            area_threshold = float(self.area_filter_absolute)
        else:
            area_threshold = float(np.percentile(object_areas, self.area_filter_quartile * 100.0))
        keep_first = object_areas[0] >= area_threshold
        N_filtered = int(np.sum(object_areas >= area_threshold)) - int(keep_first)

        with self._stage_ctx("filter/apply"):
            filtered = area_cell >= torch.tensor(area_threshold, dtype=torch.float32, device=area_cell.device)
            if holds_first:
                first = root_flat[t_first] == root_ids[t_first, 0]
                filtered[t_first].logical_and_(~first)
            out = filtered.view(data.shape)
        if self.allow_merging or data.numel() >= TWO_LEVEL_CELLS or self._comm is not None:
            # Area filtering drops whole components, so the filtered field's
            # per-slice roots are the kept ones of root_flat: the merge path
            # and the two-level 3-D labelling densify these instead of
            # labelling the field again. The keep table repeats
            # filter/apply's float32 compare.
            keep = slot & (areas_tj >= np.float32(area_threshold))
            if holds_first:
                keep[t_first, 0] = False
            self._label_reuse = (weakref.ref(out), root_flat, root_ids, torch.from_numpy(keep).to(root_ids.device))
        return out, area_threshold, object_areas, N_prefiltered, N_filtered

    def _filter_small_objects_mesh(self, data: torch.Tensor):
        """The area filter on a mesh, with the reference's rules there: an
        object's area is its cell count; objects of at most 50 cells (5 with
        an absolute threshold) are left out of the percentile and of the
        statistics; an object is kept when its count is strictly above the
        threshold; no first object is dropped."""
        with self._stage_ctx("filter/ccl_fixpoint"):
            labels, counts_own = self._label_slices(data, "filter/ccl_fixpoint")
        counts = self._joined(counts_own)
        L = int(counts.max()) if counts.size else 0
        if L == 0:
            raise TrackingError(
                "No objects found for area-based filtering",
                details={"objects_count": 0, "area_filter_quartile": self.area_filter_quartile},
                suggestions=[
                    "Check if input data contains any extreme events",
                    "Verify that preprocessing parameters are appropriate",
                    "Consider lowering the extreme threshold percentile",
                ],
            )
        L_own = int(counts_own.max()) if counts_own.size else 0
        with self._stage_ctx("filter/root_stats"):
            areas_tl = _label.label_cell_counts(labels, L_own).float().cpu().numpy()
        object_areas = areas_tl[:, 1:][np.arange(L_own)[None, :] < counts_own[:, None]]

        min_sz = 5 if self._use_absolute_filtering else 50
        object_areas = self._joined(object_areas[object_areas > min_sz])
        if len(object_areas) == 0:
            raise TrackingError(
                "No objects found for area-based filtering",
                details={"objects_count": 0, "grid_type": "unstructured"},
                suggestions=["Check if input data contains any extreme events"],
            )
        if self._use_absolute_filtering:
            area_threshold = float(self.area_filter_absolute)
        else:
            area_threshold = float(np.percentile(object_areas, self.area_filter_quartile * 100))
        keep_tl = areas_tl > area_threshold
        keep_tl[:, 0] = False
        with self._stage_ctx("filter/apply"):
            filtered = _label.select_labels(labels, torch.from_numpy(keep_tl).to(labels.device))
        return filtered, area_threshold, object_areas, int(len(object_areas)), int(np.sum(object_areas > area_threshold))

    def _checkpoint_paths(self) -> Tuple[str, str]:
        """The checkpoint's store and statistics files under ``temp_dir`` (the
        system temp dir without one), named by a fingerprint of the data
        shape and the preprocessing parameters: configurations that share a
        directory do not overwrite each other, and 'save' then 'load' of one
        configuration meet. The names are ``marex_tpu``'s, so either package
        loads the other's checkpoint."""
        base = self.temp_dir or tempfile.gettempdir()
        key = (
            f"{tuple(self.data_bin.shape)}|{self.R_fill}|{self.T_fill}|"
            f"{self.area_filter_quartile}|{self.area_filter_absolute}|"
            f"{self.unstructured_grid}|{self.regional_mode}"
        )
        tag = hashlib.sha1(key.encode()).hexdigest()[:10]
        return (
            os.path.join(base, f"marex_tpu_checkpoint_{tag}_proc_bin.zarr"),
            os.path.join(base, f"marex_tpu_checkpoint_{tag}_stats.npz"),
        )

    def _save_checkpoint(self, data_filtered: torch.Tensor, object_stats: Tuple) -> None:
        """Persist the filtered field (a zarr store) and its statistics (npz).
        On a mesh the first rank writes the whole field, gathered from every
        rank's slab, and every rank waits for it."""
        from .io.zarr_lite import to_zarr

        bin_path, stats_path = self._checkpoint_paths()
        writes = self.mesh is None or torch.distributed.get_rank() == 0
        if writes:
            os.makedirs(os.path.dirname(bin_path), exist_ok=True)
            np.savez(stats_path, **dict(zip(_STATS_KEYS, object_stats)))
        dims = (self.timedim,) + self._spatial_dims()
        f = Field(self._sharded(data_filtered), dims, self.data_bin.coords, name="data_bin_preproc")
        to_zarr(FieldSet({"data_bin_preproc": f}), bin_path)
        logger.info(f"Saved preprocessing checkpoint to {bin_path}")

    def _load_checkpoint(self):
        """The checkpoint of this configuration: ``(filtered, object_stats)``,
        the field on the tracker's device."""
        from .io.zarr_lite import open_zarr

        bin_path, stats_path = self._checkpoint_paths()
        if not (os.path.exists(bin_path) and os.path.exists(stats_path)):
            raise TrackingError(
                "No preprocessing checkpoint found for this configuration",
                details=f"Expected checkpoint files at {bin_path} and {stats_path}",
                suggestions=[
                    "Run once with checkpoint='save' (or 'auto') to create the checkpoint",
                    "Check that temp_dir matches the directory used when saving",
                    "Checkpoint paths embed the tracker configuration - parameters must match the saving run",
                ],
                context={"bin_path": bin_path, "stats_path": stats_path},
            )
        stored = open_zarr(bin_path, lazy=True)["data_bin_preproc"].data
        if self._comm is not None:  # this rank's slab only
            stored = stored[self._t0 : self._t0 + self._n_time // self._comm.size]
        data = torch.from_numpy(np.asarray(stored, dtype=bool)).to(self.device)
        with np.load(stats_path) as npz:
            stats = tuple(int(npz[k]) if k.startswith("N_") else float(npz[k]) for k in _STATS_KEYS)
        logger.info(f"Loaded preprocessing checkpoint from {bin_path}")
        return data, stats

    def run_preprocess(self, checkpoint: Optional[str] = None):
        """
        Morphological fill and area filtering; returns ``(filtered,
        object_stats)``. ``checkpoint`` (default: the tracker's own) 'save'
        writes the result under ``temp_dir``, 'load' reads it instead of
        computing it, and 'auto' loads this configuration's checkpoint when
        there is one and otherwise computes and saves it.
        """
        checkpoint = checkpoint or self.checkpoint
        if checkpoint == "load":
            return self._load_checkpoint()
        if checkpoint == "auto" and all(os.path.exists(p) for p in self._checkpoint_paths()):
            return self._load_checkpoint()

        data = self._slab()
        raw_area = self._joined(self.compute_area(data))

        logger.info(f"Filling spatial holes with radius R_fill={self.R_fill}")
        with self._stage_ctx("fill_spatial"):
            data = self.fill_holes(data)

        logger.info(f"Filling temporal gaps with T_fill={self.T_fill}")
        with self._stage_ctx("fill_time"):
            data = self.fill_time_gaps(data)

        logger.info("Filtering small objects")
        with self._stage_ctx("filter_small"):
            data_filtered, area_threshold, object_areas, N_pre, N_post = self.filter_small_objects(data)
        del data
        logger.info(f"Filtered {N_pre} -> {N_post} objects (threshold: {area_threshold})")

        processed_area = self._joined(self.compute_area(data_filtered))

        total_area_IDed = float(object_areas.sum())
        accepted_area = float(object_areas[object_areas > area_threshold].sum())
        accepted_area_fraction = accepted_area / total_area_IDed if total_area_IDed else 0.0
        total_raw = float(raw_area.sum())
        total_processed = float(processed_area.sum())
        preprocessed_area_fraction = total_raw / total_processed if total_processed else 0.0

        object_stats = (
            total_area_IDed,
            N_pre,
            N_post,
            area_threshold,
            accepted_area_fraction,
            preprocessed_area_fraction,
        )
        if checkpoint and ("save" in str(checkpoint) or checkpoint == "auto"):
            self._save_checkpoint(data_filtered, object_stats)
        return data_filtered, object_stats

    # ------------------------------------------------------------------
    # Stage 2: tracking
    # ------------------------------------------------------------------

    def run_tracking(self, data_bin_preprocessed: torch.Tensor):
        """Track objects through time; returns ``(events_ds, merges_ds,
        N_events)``. Without merging, events are the 3x3x3-connected
        components in (time, y, x); with it, and always on a mesh, the
        split/merge march."""
        if self.allow_merging or self.unstructured_grid:
            events_ds, merges_ds, N_events = self.track_objects(data_bin_preprocessed)
            logger.info("Finished tracking all extreme events!")
            return events_ds, merges_ds, N_events
        with self._stage_ctx("ccl3d"):
            labels, N_events = self._label_spacetime(data_bin_preprocessed, slab=True)
        events_ds = FieldSet({"ID_field": self._id_field(self._sharded(labels))})
        logger.info("Finished tracking all extreme events!")
        return events_ds, FieldSet(), N_events

    def _id_field(self, labels: torch.Tensor) -> Field:
        return Field(labels, (self.timedim,) + self._spatial_dims(), self.data_bin.coords, name="ID_field")

    def _label_spacetime(self, data: torch.Tensor, slab: bool = False) -> Tuple[torch.Tensor, int]:
        """3x3x3-connected event labels of a (T, H, W) field, ids 1..N in
        order of each event's first cell in (t, y, x) order: the fused 3-D
        fixpoint below ``TWO_LEVEL_CELLS`` cells, two levels from there and
        whenever ``data`` is this rank's slab of a field split over a mesh."""
        if data.numel() >= TWO_LEVEL_CELLS or (slab and self._comm is not None):
            return self._label_spacetime_two_level(data, slab)
        labf, iters = _label.label_spacetime_roots(data, wrap_x=self._wrap)
        self._count_iterations("ccl3d", iters)
        dense, n_events = _label.densify_spacetime_roots(labf)
        return dense.view(data.shape), n_events

    def _label_spacetime_two_level(self, data: torch.Tensor, slab: bool = False) -> Tuple[torch.Tensor, int]:
        """The reference's two-level labelling (``track._label_spacetime_two_level``):
        per-slice labels (the area filter's roots when ``data`` is its
        output) made unique by cumulative offsets, the inter-slice edges of
        3x3x3 connectivity on the device, the union-find of the objects on
        the host, then one remap in place. An event's id is the rank of its
        first object, which holds its first cell: the fused route's ids. On a
        mesh (``slab``) the offsets count every rank's earlier slices, the
        edges include those between the previous slab's last slice and this
        slab's first, and every rank unions the gathered edge lists."""
        labels, counts_own = self._label_slices(data, "ccl3d")
        split = slab and self._comm is not None
        counts = self._joined(counts_own) if split else counts_own
        base = int(counts[: self._t0].sum()) if split else 0
        labels = _label.offset_labels(labels, torch.from_numpy(counts_own), base)
        n_obj = int(counts.sum())
        with self._stage_ctx("ccl3d/edges"):
            edges = _overlap.adjacency_edges(labels, n_obj + 1, self._wrap)
            if split:
                before, _ = self._comm.halo(labels, 0, 1, 0)
                edges = torch.cat([_overlap.adjacency_edges(torch.cat([before, labels[:1]]), n_obj + 1, self._wrap),
                                   edges])
                edges = np.unique(np.concatenate(self._comm.gather(edges.cpu().numpy())), axis=0)
            else:
                edges = edges.cpu().numpy()
        with self._stage_ctx("ccl3d/union"):
            comp = _overlap.union_find_components(edges, np.arange(1, n_obj + 1))
            lookup = np.zeros(n_obj + 1, np.int32)
            lookup[1:] = comp + 1
        with self._stage_ctx("ccl3d/remap"):
            labels = _label.remap_labels(torch.from_numpy(lookup).to(labels.device), labels)
        return labels, int(comp.max()) + 1 if n_obj else 0

    # -- mid-level API ---------------------------------------------------

    @property
    def mask_values(self) -> np.ndarray:
        """The mask as a host bool array."""
        return np.asarray(self.mask.values, dtype=bool)

    def _payload(self, field: Any, dtype: torch.dtype) -> torch.Tensor:
        """A Field, tensor or array as a contiguous tensor of ``dtype`` on the
        tracker's device; a DTensor whole (gathered, which every rank of its
        mesh must call: the mid-level API works on whole fields)."""
        data = field.data if isinstance(field, Field) else field
        return on_device(gathered(data), self.device).to(self.device, dtype).contiguous()

    def identify_objects(self, data_bin: Any, time_connectivity: bool = False):
        """
        Label connected regions; returns ``(labels Field, None, N)``. With
        ``time_connectivity`` (grids only) the 3x3x3 event labels of the
        ``ccl3d`` stage, by the same route; otherwise per-slice labels made
        globally unique by cumulative offsets.
        """
        data = self._payload(data_bin, torch.bool)
        if time_connectivity:
            if self.unstructured_grid:
                raise ConfigurationError(
                    "Time connectivity not supported for unstructured grids",
                    details="Automatic time connectivity computation requires regular grids",
                    suggestions=["Set time_connectivity=False for unstructured data"],
                )
            labels, n = self._label_spacetime(data)
            return self._id_field(labels), None, n
        labels, counts = self._label_slices(data)
        return self._id_field(_label.offset_labels(labels, torch.from_numpy(counts))), None, int(counts.sum())

    def calculate_object_properties(self, object_id_field: Any, properties: Optional[List[str]] = None) -> FieldSet:
        """Area and centroid of each object id (pixel units on a grid,
        degrees on a mesh): the area summed over time, the centroid of the
        slice where the object is largest (the first such slice); a FieldSet
        indexed by ``ID``. The property tables are made per time chunk over
        each slice's ids ranked 1..L, so they are (T, L + 1) for the most ids
        L in a slice, not (T, number of ids + 1)."""
        labels = self._payload(object_id_field, torch.int32)
        T = labels.shape[0]
        flat = labels.reshape(T, -1)
        n_labels = int(flat.max()) if flat.numel() else 0
        if n_labels == 0:
            ids = Coord("ID", np.array([], np.int32))
            return FieldSet(
                {
                    "area": Field(np.array([], np.float32), ("ID",), {"ID": ids}),
                    "centroid": Field(np.zeros((2, 0), np.float32), ("component", "ID"), {"ID": ids}),
                }
            )
        K = n_labels + 1
        rows = []  # (t, id, area, c0, c1) of every id present in a slice
        tb = max(1, _label._CHUNK_CELLS // max(flat.shape[1], 1))
        for t0 in range(0, T, tb):
            chunk = flat[t0 : t0 + tb]
            t_idx = torch.arange(chunk.shape[0], device=chunk.device)[:, None]
            keys, local = torch.unique(t_idx * K + chunk, return_inverse=True)
            t_k, id_k = keys // K, keys % K
            first = torch.searchsorted(keys, t_k * K)  # each slice's first key (its background, if any)
            rank = torch.arange(keys.numel(), device=keys.device) - first + (id_k[first] != 0).long()
            local = rank[local].int()
            L = int(rank.max())
            if self.unstructured_grid:
                props = _props.unstructured_label_props(local, self._mesh_wall, L)
            else:
                props = _props.grid_label_props(local.view((-1,) + labels.shape[1:]), L, wrap=self._wrap)
            on = id_k > 0
            rows.append(torch.stack([(t_k + t0).double(), id_k.double()] + [x[t_k, rank].double() for x in props])[:, on])
        t_k, id_k, area, c0, c1 = torch.cat(rows, dim=1).cpu().numpy()
        # per id, its largest entry first (the earliest slice among equals)
        order = np.lexsort((t_k, -area, id_k))
        id_s = id_k[order].astype(np.int32)
        head = np.r_[True, id_s[1:] != id_s[:-1]]
        ids = id_s[head]
        tot_area = np.zeros(K, np.float64)
        np.add.at(tot_area, id_k.astype(np.int64), area)
        idc = Coord("ID", ids)
        centroid = np.stack([c0[order][head], c1[order][head]]).astype(np.float32)
        return FieldSet(
            {
                "area": Field(tot_area[ids].astype(np.float32), ("ID",), {"ID": idc}, name="area"),
                "centroid": Field(centroid, ("component", "ID"),
                                  {"ID": idc, "component": Coord("component", np.array([0, 1]))}, name="centroid"),
            }
        )

    def check_overlap_slice(self, ids_t0: Any, ids_next: Any) -> np.ndarray:
        """(id0, id1, weight) overlap triples of one slice pair, in ascending
        (id0, id1) order: shared cells on a grid, their summed area on a
        mesh; (N, 3) float64 on the host."""
        a = self._payload(ids_t0, torch.int32).reshape(-1)
        b = self._payload(ids_next, torch.int32).reshape(-1)
        stride = int(torch.maximum(a.max(), b.max())) + 2 if a.numel() else 2
        pa, pb, pw = _overlap.slice_pairs(a, b, stride, self._cell_weights())
        return torch.stack([pa, pb, pw], dim=1).double().cpu().numpy()

    def find_overlapping_objects(self, object_id_field: Any) -> np.ndarray:
        """Overlap triples of every consecutive slice pair of an object id
        field, merged over time: (N, 3) float64, ascending (id0, id1)."""
        labels = self._payload(object_id_field, torch.int32)
        return _merge_pair_lists(self._per_slice_pairs_device(labels))

    # -- merge tracking --------------------------------------------------

    def _label_slices(self, data: torch.Tensor, stage: str = "ccl") -> Tuple[torch.Tensor, np.ndarray]:
        """Per-slice dense labels 1..n_t in ascending-root order, and the
        counts n_t. On a grid, when ``data`` is the very field the area
        filter returned, its kept roots are densified (single use);
        otherwise the slices are labelled afresh, on a mesh over the
        symmetrised table after the mask is applied. The fixpoint's
        iterations are recorded under ``stage``."""
        if self.unstructured_grid:
            labels, counts, iters = _label.label_slices_unstructured(data & self.mask_dev, self._nb_sym_dev)
            self._count_iterations(stage, iters)
            return labels, counts.cpu().numpy()
        cache, self._label_reuse = self._label_reuse, None
        if cache is not None and cache[0]() is data:
            _, root_flat, root_ids, keep = cache
        else:
            root_flat, _, iters = _label.label_slices_grid_roots(data, wrap_x=self._wrap)
            self._count_iterations(stage, iters)
            root_ids, _, _, _ = _label.slice_root_stats(root_flat)
            keep = None
        del cache
        dense, counts = _label.densify_slice_roots(root_flat, root_ids, keep)
        return dense.view(data.shape), counts.cpu().numpy()

    def track_objects(self, data_bin: torch.Tensor):
        """Split/merge-aware tracking: per-slice objects, the march, then the
        event clustering. Returns ``(events_ds, merge_events, N_events)``."""
        with self._stage_ctx("ccl"):
            labels, counts_own = self._label_slices(data_bin)
        counts = self._joined(counts_own)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        own = slice(self._t0, self._t0 + labels.shape[0])
        with self._stage_ctx("march"):
            with self._stage_ctx("march/props"):
                object_table = self._compute_props_for_labels(labels, counts_own, offsets[own])
            logger.info("Finished calculating object properties")
            labels = _label.offset_labels(labels, torch.from_numpy(counts_own), int(offsets[self._t0]))
            logger.info(f"Finished assigning {int(counts.sum())} globally unique object IDs")
            if self._comm is None:
                store = _SliceStore(labels)
            else:
                store = _ShardStore(labels, self._comm, self._n_time, self._t0, int(counts.sum()))
            labels, object_table, overlap_list, merge_events = self._split_and_merge_device(store, object_table)
        logger.info("Finished splitting and merging objects")
        with self._stage_ctx("rename"):
            events_ds, N_events = self._cluster_rename(labels, object_table, overlap_list, merge_events)
        logger.info("Finished clustering and renaming objects into coherent consistent events")
        return events_ds, merge_events, N_events

    def _compute_props_for_labels(
        self, labels: torch.Tensor, counts: np.ndarray, offsets: np.ndarray, table: Optional[ObjectTable] = None
    ) -> ObjectTable:
        """The object table of per-slice dense labels: object k of slice t
        gets id offsets[t] + k (entered in ``table`` when given)."""
        L = int(counts.max()) if counts.size else 0
        table = ObjectTable() if table is None else table
        if L == 0:
            return table
        if self.unstructured_grid:
            props = _props.unstructured_label_props(labels, self._mesh_wall, L)
        else:
            props = _props.grid_label_props(labels, L, wrap=self._wrap)
        areas, c0, c1 = (x.cpu().numpy() for x in props)
        for t in range(labels.shape[0]):
            for k in range(1, int(counts[t]) + 1):
                table.add(int(offsets[t]) + k, float(areas[t, k]), float(c0[t, k]), float(c1[t, k]))
        return table

    def _enforce_threshold(self, pairs: np.ndarray, table: ObjectTable) -> np.ndarray:
        """The pairs whose overlap is at least ``overlap_threshold`` of the
        smaller object's area."""
        if len(pairs) == 0:
            return pairs.reshape(0, 3)
        with tracing.span("march/threshold", self.device):
            keep = []
            for a, b, w in pairs:
                ia, ib = int(a), int(b)
                if ia not in table or ib not in table:
                    continue
                min_area = min(table.area(ia), table.area(ib))
                if min_area > 0 and (w / min_area) >= self.overlap_threshold:
                    keep.append((a, b, w))
            return np.array(keep, dtype=np.float64).reshape(-1, 3)

    def _count_dispatch(self, kind: str) -> None:
        self.dispatch_counts[kind] = self.dispatch_counts.get(kind, 0) + 1
        tracing.count(f"march/dispatch/{kind}")

    def _per_slice_pairs_device(self, labels: torch.Tensor) -> List[np.ndarray]:
        """(id_a, id_b, w) triples for every consecutive slice pair, one
        (n, 3) float64 host array per pair, in ascending (a, b) order."""
        T = labels.shape[0]
        if T < 2:
            return []
        t, a, b, w = _overlap.consecutive_pairs(labels, int(labels.max()) + 2, self._cell_weights())
        triples = torch.stack([a, b, w], dim=1).double().cpu().numpy()
        bounds = np.searchsorted(t.cpu().numpy(), np.arange(T))
        return [triples[bounds[i] : bounds[i + 1]] for i in range(T - 1)]

    def _pairs_dev(self, a_dev: torch.Tensor, b_dev: torch.Tensor, key_stride: int) -> np.ndarray:
        """Overlap triples of one slice pair, counted on the device."""
        self._count_dispatch("pairs")
        pa, pb, pw = _overlap.slice_pairs(a_dev, b_dev, key_stride, self._cell_weights())
        return torch.stack([pa, pb, pw], dim=1).double().cpu().numpy()

    def _cell_weights(self) -> Optional[torch.Tensor]:
        """What an overlap sums: cell areas on a mesh, cell counts on a grid."""
        return self._cell_area_dev if self.unstructured_grid else None

    def _consolidate_slice_device(self, store: _SliceStore, table: ObjectTable, back: np.ndarray, t_slice: int,
                                  invalidate) -> None:
        """(t-2 -> t-1) consolidation: the children a parent at t-2 links to
        at t-1 are renamed to the first of them. The ordered renames are
        composed on the host (chains resolved), applied in one relabel, and
        the surviving targets' properties recomputed in the same call —
        the semantics of the reference's sequential per-child loop."""
        parents, counts_p = np.unique(back[:, 0], return_counts=True)
        renames: List[Tuple[int, int]] = []
        ren_dict: Dict[int, int] = {}
        changed_targets: List[int] = []
        for parent_id in parents[counts_p > 1]:
            if int(parent_id) not in table:
                continue
            children = back[back[:, 0] == parent_id, 1].astype(np.int64)
            first = int(children[0])
            if first not in table:
                continue
            changed = False
            for child in children[1:]:
                child = int(child)
                if child not in table:
                    continue
                renames.append((child, first))
                ren_dict[child] = first
                table.drop(child)
                changed = True
            if changed:
                changed_targets.append(first)
        if not renames:
            return
        self._count_dispatch("consolidate")

        def resolve(x: int) -> int:
            seen = set()
            while x in ren_dict and x not in seen:
                seen.add(x)
                x = ren_dict[x]
            return x

        olds = [o for o, _ in renames]
        news = [resolve(o) for o, _ in renames]
        final_targets = sorted({resolve(f) for f in changed_targets})
        sl = store.get_dev(t_slice)
        targets = torch.tensor(final_targets, dtype=torch.int32, device=sl.device)
        if self.unstructured_grid:
            sl, tprops = _part.relabel_and_props_unstructured(sl, olds, news, targets, self._mesh_wall)
        else:
            sl, tprops = _part.relabel_and_props_slice(sl, olds, news, targets, self._wrap)
        store.set_dev(t_slice, sl)
        tp = tprops.cpu().numpy()
        for i, fid in enumerate(final_targets):
            if tp[i, 0] > 0:
                table.add(int(fid), float(tp[i, 0]), float(tp[i, 1]), float(tp[i, 2]))
        invalidate(t_slice)

    def _split_and_merge_device(self, store: _SliceStore, table: ObjectTable):
        """
        The split/merge march over time steps, with the reference's
        semantics and order: consolidation of t-1 against t-2, then up to 10
        iterations per step in which every child linked to several parents
        is partitioned among them (all such children of an iteration in one
        device call), new ids allocated in pair-list order, and the overlap
        pairs of the touched slices refreshed on the device. The store says
        which steps run here (all of them, but on a mesh).
        """
        T = store.T
        with self._stage_ctx("march/pairs"):
            pair_cache: List[Optional[np.ndarray]] = store.initial_pairs(self)
        st = _March(table, pair_cache, store.first_new_id(table))
        time_values = np.asarray(self.data_bin.coords[self.timecoord].values)

        def get_pairs(t: int) -> np.ndarray:
            if st.pairs[t] is None:
                with self._stage_ctx("march/pairs"):
                    st.pairs[t] = self._pairs_dev(store.get_dev(t), store.get_dev(t + 1), st.next_new_id + 1)
            return st.pairs[t]

        def invalidate(t: int) -> None:
            if 0 <= t - 1 < T - 1:
                st.pairs[t - 1] = None
            if 0 <= t < T - 1:
                st.pairs[t] = None

        def consolidate(back: np.ndarray, t_slice: int) -> None:
            with self._stage_ctx("march/consolidate"):
                self._consolidate_slice_device(store, st.table, back, t_slice, invalidate)

        error = None
        try:
            for t in store.steps(st):
                store.begin_step(t)
                # -- consolidation of t-1 using t-2 --------------------------
                if t > 1:
                    back = self._enforce_threshold(get_pairs(t - 2), st.table)
                    if len(back):
                        consolidate(back, t - 1)
                if t == 0:
                    continue

                # -- per-timestep merge resolution ---------------------------
                for _ in range(10):
                    cur = self._enforce_threshold(get_pairs(t - 1), st.table)
                    if len(cur) == 0:
                        break
                    children, child_counts = np.unique(cur[:, 1], return_counts=True)
                    merging = children[child_counts > 1]
                    if len(merging) == 0:
                        break

                    batch: List[Tuple[int, np.ndarray, np.ndarray]] = []
                    with tracing.span("march/batch", self.device):
                        for child_id in merging:
                            child_id = int(child_id)
                            rows_idx = np.nonzero(cur[:, 1] == child_id)[0]
                            rows = cur[rows_idx]
                            if len(rows) < 2:
                                continue
                            parent_ids = rows[:, 0].astype(np.int64)
                            n_parents = len(parent_ids)
                            if n_parents > MAX_PARENTS:
                                raise TrackingError(
                                    "Too many parent objects for tracking",
                                    details=f"Child {child_id} has {n_parents} parents (limit: {MAX_PARENTS})",
                                    suggestions=[
                                        "Increase overlap_threshold to reduce fragmentation",
                                        "Apply stronger area filtering",
                                    ],
                                    context={"child_id": child_id, "n_parents": int(n_parents), "limit": MAX_PARENTS},
                                )
                            new_ids = np.arange(st.next_new_id, st.next_new_id + n_parents - 1, dtype=np.int64)
                            st.next_new_id += n_parents - 1
                            child_ids = np.concatenate([[child_id], new_ids]).astype(np.int64)
                            cur[rows_idx[1:], 1] = new_ids  # in-place rewiring

                            st.merge_times.append(time_values[t])
                            st.merge_child_ids.append(child_ids)
                            st.merge_parent_ids.append(parent_ids)
                            st.merge_areas.append(rows[:, 2])
                            batch.append((child_id, parent_ids, child_ids))

                    if batch:
                        with self._stage_ctx("march/partition"):
                            self._partition_batch(store, st.table, batch, t)
                    invalidate(t)
                else:
                    logger.warning(f"Resolving mergers at timestep {t} did not converge after 10 iterations")

            # end-of-series consolidation
            if T >= 2 and store.ends_series:
                back = self._enforce_threshold(get_pairs(T - 2), st.table)
                if len(back):
                    consolidate(back, T - 1)
        except Exception as e:  # the store passes it on (on a mesh, to every rank) and raises it
            error = e
        store.end_march(st, error)

        with self._stage_ctx("march/overlaps"):
            overlap_list = self._enforce_threshold(_merge_pair_lists(store.final_pairs(self)), st.table)
        labels = store.flush()

        if len(overlap_list):
            uc, cc = np.unique(overlap_list[:, 1], return_counts=True)
            dups = uc[cc > 1]
            if len(dups):
                logger.warning(
                    f"There are {len(dups)} children with multiple parents after splitting/merging "
                    "(expected for disjoint objects grouped by the overlap logic)"
                )

        merge_events = _build_merge_events(*st.records())
        return labels, st.table, overlap_list[:, :2] if len(overlap_list) else np.empty((0, 2)), merge_events

    def _partition_batch(self, store: _SliceStore, table: ObjectTable, batch, t: int) -> None:
        """Cut each merging child of slice t among its parents at t-1 (one
        device call for the batch) and enter every piece in the table."""
        K = len(batch)
        P = max(len(par) for _, par, _ in batch)
        child_arr = np.zeros(K, np.int32)
        piece = np.zeros((K, P), np.int32)
        pids = np.zeros((K, P), np.int32)
        valid = np.zeros((K, P), bool)
        cents = np.zeros((K, P, 2), np.float32)
        mdist = np.zeros(K, np.float32)
        for i, (cid, par, cids) in enumerate(batch):
            n = len(par)
            child_arr[i] = cid
            piece[i, :n] = cids
            pids[i, :n] = par
            valid[i, :n] = True
            cents[i, :n] = np.array([table.centroid(int(p)) for p in par], np.float32)
            if self.nn_partitioning:
                max_area = max(table.area(int(p)) for p in par)
                if self.unstructured_grid:  # a cap in hops, from the area in cells
                    mdist[i] = float(max(int(np.sqrt(max_area / self.mean_cell_area) * 2.0), 20) * 2)
                else:
                    mdist[i] = float(max(int(np.sqrt(max_area) * 3.0), 40))
        self._count_dispatch("partition")
        cur = store.get_dev(t)
        dev = cur.device
        arrays = [torch.from_numpy(x).to(dev) for x in (child_arr, piece, pids, valid, cents, mdist)]
        if self.unstructured_grid:
            new_cur, piece_props = _part.partition_children_unstructured_batched(
                store.get_dev(t - 1), cur, *arrays, self._nb_dev, self._mesh_unit, self._mesh_wall,
                self.nn_partitioning, int(max(mdist.max(), 1.0)),
            )
        else:
            new_cur, piece_props = _part.partition_children_grid_batched(
                store.get_dev(t - 1), cur, *arrays, self.nn_partitioning, self._wrap
            )
        store.set_dev(t, new_cur)
        self._enter_pieces(table, batch, piece_props.cpu().numpy())

    @staticmethod
    def _enter_pieces(table: ObjectTable, batch, pp: np.ndarray) -> None:
        """Enter the (K, P, 3) properties of a batch's pieces in the table."""
        for i, (_, _, cids) in enumerate(batch):
            for j, pid_new in enumerate(cids):
                pid_new = int(pid_new)
                area, cyv, cxv = float(pp[i, j, 0]), float(pp[i, j, 1]), float(pp[i, j, 2])
                if area > 0:
                    table.add(pid_new, area, cyv, cxv)
                elif j == 0:
                    table.drop(pid_new)
                    logger.info(f"Deleted child_id {pid_new} because parents have split/morphed")
                else:
                    logger.warning(f"Missing newly created child_id {pid_new} because parents have split/morphed")

    def _cluster_rename(self, labels: torch.Tensor, table: ObjectTable, overlap_list: np.ndarray,
                        merge_events: FieldSet):
        """Cluster the overlap graph into events (host union-find), then on
        the device: the (time, ID) table of original ids, the full-field
        remap to event ids (over the old ids, in place), and the per-time
        event statistics. Returns ``(events_ds, N_events)``."""
        with self._stage_ctx("rename/max"):
            labels_max = int(self._joined(np.array([int(labels.max())])).max())
        lookup, N, max_id = self._event_lookup(table, overlap_list, labels_max)
        lookup_dev = torch.from_numpy(lookup).to(labels.device)

        T = self._n_time
        # the (time, ID) table first, from the old ids; then the remap over them
        with self._stage_ctx("rename/gid"):
            global_id = self._joined_dev(_props.event_global_id_lookup(labels, lookup_dev, N))
        with self._stage_ctx("rename/remap"):
            new_field = _label.remap_labels(lookup_dev, labels)
        del labels

        presence = global_id > 0
        time_vals = np.asarray(self.data_bin.coords[self.timecoord].values)
        first_idx = torch.argmax(presence.byte(), dim=0).cpu().numpy()
        last_idx = T - 1 - torch.argmax(presence.flip(0).byte(), dim=0).cpu().numpy()

        with self._stage_ctx("rename/stats"):
            areas, clat, clon = (self._joined_dev(x) for x in self._event_stats(new_field, N))
            clat, clon = self._centroid_units(clat, clon)

        merges_by_t = _merges_by_time(merge_events, time_vals)
        ledger = self._ledger_block(merges_by_t, lookup, max_id, N, 0, T)
        events_ds = self._events_fieldset(
            self._sharded(new_field), global_id[:, 1:], areas[:, 1:], torch.stack([clat[:, 1:], clon[:, 1:]], dim=0),
            presence[:, 1:], time_vals[first_idx][1:], time_vals[last_idx][1:], ledger[:, 1:], N,
        )
        return events_ds, N

    def _event_lookup(self, table: ObjectTable, overlap_list: np.ndarray, labels_max: int):
        """Cluster the overlap graph into events (host union-find). Returns
        the lookup of each object id's event id (int32, 0 = none; ids up to
        the largest of ``labels_max`` and the graph's), the event count, and
        that largest id."""
        field_ids = table.ids()
        if len(overlap_list):
            overlap_ids = np.unique(overlap_list.astype(np.int64))
            overlap_ids = overlap_ids[overlap_ids > 0]
            all_ids = np.unique(np.concatenate([field_ids.astype(np.int64), overlap_ids]))
        else:
            all_ids = field_ids.astype(np.int64)
        logger.info(f"Found {len(all_ids)} valid object IDs")

        comp = _overlap.union_find_components(overlap_list, all_ids)
        n_events = int(comp.max()) + 1 if len(comp) else 0
        logger.info(f"Identified {n_events} connected components (events)")

        max_id = max(labels_max, int(all_ids.max()) if len(all_ids) else 0)
        lookup = np.zeros(max_id + 2, dtype=np.int32)
        lookup[all_ids] = comp.astype(np.int32) + 1
        return lookup, n_events, max_id

    def _ledger_block(self, merges_by_t, lookup: np.ndarray, max_id: int, n_events: int, t0: int, t1: int) -> np.ndarray:
        """
        Rows t0..t1-1 of the merge ledger (time, ID, sibling_ID): (t1 - t0,
        n_events + 1, sibling) int32, -1 filled, column 0 unused.
        'reference' writes each merging parent's own event id across its
        sibling slots (a participation marker; the genealogy is in the merge
        records); 'siblings' the full list of merge partners.
        """
        pids, rows_by_t, sibling = merges_by_t
        ledger = np.full((t1 - t0, n_events + 1, sibling), -1, dtype=np.int32)
        for tixd in range(t0, t1):
            for m in rows_by_t.get(tixd, ()):
                parents_old = pids[m][pids[m] > 0]
                parents_new = lookup[np.clip(parents_old, 0, max_id + 1)]
                parents_new = parents_new[parents_new > 0]
                if self.merge_ledger_mode == "reference":
                    for pn in parents_new:
                        ledger[tixd - t0, pn, :] = pn
                else:
                    for pn in parents_new:
                        k = min(len(parents_new), sibling)
                        ledger[tixd - t0, pn, :k] = parents_new[:k]
        return ledger

    def _events_fieldset(self, id_field, global_id, area, centroid, presence, time_start, time_end, ledger,
                         n_events: int) -> FieldSet:
        """The events FieldSet from its payloads (tensors, host arrays or lazy
        zarr arrays), every per-event table without the background column."""
        tdims = (self.timedim,)
        coords = dict(self.data_bin.coords)
        id_coord = Coord("ID", np.arange(1, n_events + 1, dtype=np.int32))
        id_c = {**coords, "ID": id_coord}
        return FieldSet(
            {
                "ID_field": Field(id_field, tdims + self._spatial_dims(), coords, name="ID_field"),
                "global_ID": Field(global_id, (self.timedim, "ID"), id_c, name="global_ID"),
                "area": Field(area, (self.timedim, "ID"), id_c, name="area"),
                "centroid": Field(
                    centroid,
                    ("component", self.timedim, "ID"),
                    {**id_c, "component": Coord("component", np.array([0, 1]))},
                    name="centroid",
                ),
                "presence": Field(presence, (self.timedim, "ID"), id_c, name="presence"),
                "time_start": Field(time_start, ("ID",), {"ID": id_coord}, name="time_start"),
                "time_end": Field(time_end, ("ID",), {"ID": id_coord}, name="time_end"),
                "merge_ledger": Field(
                    ledger,
                    (self.timedim, "ID", "sibling_ID"),
                    {**id_c, "sibling_ID": Coord("sibling_ID", np.arange(ledger.shape[-1]))},
                    name="merge_ledger",
                ),
            },
            attrs={},
        )

    def _event_stats(self, event_field: torch.Tensor, n_events: int):
        """Physical areas and area-weighted (lat, lon) centroids per (time,
        event), NaN where the event is absent; (T, n_events + 1) float32 on
        the field's device. On a mesh the centroids are spherical."""
        dev = event_field.device
        if n_events == 0:
            z = torch.zeros((event_field.shape[0], 1), dtype=torch.float32, device=dev)
            return z, z.clone(), z.clone()
        nan = torch.tensor(float("nan"), device=dev)
        if self.unstructured_grid:
            areas, clat, clon = _props.unstructured_label_props(event_field, self._mesh_wall, n_events)
            return torch.where(areas > 0, areas, nan), clat, clon
        areas, cy, cx = _props.grid_label_props(event_field, n_events, wrap=self._wrap,
                                                cell_weights=torch.from_numpy(self.cell_area).to(dev))
        cy = _props.interp_coord(cy, torch.from_numpy(self.lat.astype(np.float32)).to(dev))
        cx = _props.interp_coord(cx, torch.from_numpy(self.lon.astype(np.float32)).to(dev))
        present = areas > 0
        clat = torch.where(present, cy, nan)
        clon = torch.where(present, cx, nan)
        return torch.where(present, areas, nan), clat, clon

    # ------------------------------------------------------------------
    # Stage 3: statistics & attributes
    # ------------------------------------------------------------------

    def run_stats_attributes(
        self,
        events_ds: FieldSet,
        merges_ds: FieldSet,
        object_stats: Tuple[float, int, int, float, float, float],
        N_events_final: int,
    ) -> FieldSet:
        """Attach summary statistics and restore the original coordinates."""
        (
            total_area_IDed,
            N_objects_prefiltered,
            N_objects_filtered,
            area_threshold,
            accepted_area_fraction,
            preprocessed_area_fraction,
        ) = object_stats

        events_ds.attrs["allow_merging"] = int(self.allow_merging)
        events_ds.attrs["N_objects_prefiltered"] = int(N_objects_prefiltered)
        events_ds.attrs["N_objects_filtered"] = int(N_objects_filtered)
        events_ds.attrs["N_events_final"] = int(N_events_final)
        events_ds.attrs["R_fill"] = self.R_fill
        events_ds.attrs["T_fill"] = self.T_fill
        events_ds.attrs["area_filter_quartile"] = self.area_filter_quartile
        events_ds.attrs["area_threshold (cells)"] = area_threshold
        events_ds.attrs["accepted_area_fraction"] = accepted_area_fraction
        events_ds.attrs["preprocessed_area_fraction"] = preprocessed_area_fraction

        print("Tracking Statistics:")
        print(f"   Binary Hobday to Processed Area Fraction: {preprocessed_area_fraction}")
        print(f"   Total Object Area IDed (cells): {total_area_IDed}")
        print(f"   Number of Initial Pre-Filtered Objects: {N_objects_prefiltered}")
        print(f"   Number of Final Filtered Objects: {N_objects_filtered}")
        print(f"   Area Cutoff Threshold (cells): {int(area_threshold)}")
        print(f"   Accepted Area Fraction: {accepted_area_fraction}")
        print(f"   Total Events Tracked: {N_events_final}")

        if self.allow_merging:
            events_ds.attrs["overlap_threshold"] = self.overlap_threshold
            events_ds.attrs["nn_partitioning"] = int(self.nn_partitioning)
            n_merges = merges_ds["n_parents"].shape[0] if "n_parents" in merges_ds.data_vars else 0
            events_ds.attrs["total_merges"] = int(n_merges)
            if n_merges:
                events_ds.attrs["multi_parent_merges"] = int((merges_ds["n_parents"].values > 2).sum())
            else:
                events_ds.attrs["multi_parent_merges"] = 0
            print(f"   Total Merging Events Recorded: {events_ds.attrs['total_merges']}")

        events_ds.attrs.update(self.data_attrs)
        return self._remap_coordinates(events_ds)

    def _remap_coordinates(self, events_ds: FieldSet) -> FieldSet:
        """Restore the original coordinate values (units and ranges); the
        centroids are already in them (:meth:`_centroid_units`)."""
        ydims = events_ds.coords[self.ycoord].dims if self.ycoord in events_ds.coords else (self.ydim,)
        xdims = events_ds.coords[self.xcoord].dims if self.xcoord in events_ds.coords else (self.xdim,)
        events_ds.coords[self.ycoord] = Coord(ydims, self.lat_init)
        events_ds.coords[self.xcoord] = Coord(xdims, self.lon_init)
        return events_ds

    def _centroid_units(self, clat: torch.Tensor, clon: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Centroids (degrees) in the input's units, longitudes in its range
        (shifted positive when its longitudes run 0..360 or 0..2 pi)."""
        lon_min = float(np.min(self.lon_init))
        lon_max = float(np.max(self.lon_init))
        if self.coordinate_units == "radians":
            clat = clat * np.pi / 180.0
            clon = clon * np.pi / 180.0
            if lon_min >= 0 and lon_max > np.pi:
                clon = torch.where(clon < 0, clon + 2 * np.pi, clon)
        elif lon_min >= 0 and lon_max > 180:
            clon = torch.where(clon < 0, clon + 360, clon)
        return clat.float(), clon.float()


def _merge_pair_lists(lists: List[np.ndarray]) -> np.ndarray:
    """One (N, 3) list of per-slice pair lists, sorted by (a, b), with the
    weights of repeated pairs summed."""
    lists = [x for x in lists if len(x)]
    if not lists:
        return np.empty((0, 3), dtype=np.float64)
    allp = np.concatenate(lists)
    key = allp[:, 0].astype(np.int64) * np.int64(2**31) + allp[:, 1].astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros(len(uniq))
    np.add.at(sums, inv, allp[:, 2])
    return np.column_stack([uniq // 2**31, uniq % 2**31, sums]).astype(np.float64)


def _merges_by_time(merge_events: FieldSet, time_vals: np.ndarray):
    """The merge records grouped by time index: ``(parent_IDs, {time index:
    [record, ...]}, sibling slots)`` for :meth:`tracker._ledger_block`."""
    have_merges = "parent_IDs" in merge_events.data_vars and merge_events["parent_IDs"].shape[0] > 0
    if not have_merges:
        return np.zeros((0, MAX_PARENTS), np.int32), {}, MAX_PARENTS
    pids = merge_events["parent_IDs"].values
    time_to_idx = {v: i for i, v in enumerate(time_vals)}
    rows_by_t: Dict[int, List[int]] = {}
    for m, mt in enumerate(merge_events["merge_time"].values):
        tixd = time_to_idx.get(mt)
        if tixd is not None:
            rows_by_t.setdefault(tixd, []).append(m)
    return pids, rows_by_t, int(pids.shape[1])


def _build_merge_events(
    merge_times: List[Any],
    merge_child_ids: List[np.ndarray],
    merge_parent_ids: List[np.ndarray],
    merge_areas: List[np.ndarray],
) -> FieldSet:
    """The padded merge-events dataset (-1 fill): parent and child ids,
    overlap areas (int64, truncated like the reference's int32), merge time
    and the parent and child counts of every merge."""
    if merge_parent_ids and merge_child_ids:
        max_parents = max(len(x) for x in merge_parent_ids)
        max_children = max(len(x) for x in merge_child_ids)
    else:
        max_parents = 1
        max_children = 1
    n = len(merge_parent_ids)
    parent_arr = np.full((n, max_parents), -1, np.int32)
    child_arr = np.full((n, max_children), -1, np.int32)
    areas_arr = np.full((n, max_parents), -1, np.int64)
    for i, p in enumerate(merge_parent_ids):
        parent_arr[i, : len(p)] = p
    for i, c in enumerate(merge_child_ids):
        child_arr[i, : len(c)] = c
    for i, a in enumerate(merge_areas):
        a = np.nan_to_num(np.asarray(a, dtype=np.float64), nan=-1.0, posinf=-1.0, neginf=-1.0)
        areas_arr[i, : len(a)] = a

    mid = Coord("merge_ID", np.arange(n))
    mt = np.array(merge_times) if n else np.array([], dtype="datetime64[ns]")
    return FieldSet(
        {
            "parent_IDs": Field(parent_arr, ("merge_ID", "parent_idx"), {"merge_ID": mid}, name="parent_IDs"),
            "child_IDs": Field(child_arr, ("merge_ID", "child_idx"), {"merge_ID": mid}, name="child_IDs"),
            "overlap_areas": Field(areas_arr, ("merge_ID", "parent_idx"), {"merge_ID": mid}, name="overlap_areas"),
            "merge_time": Field(mt, ("merge_ID",), {"merge_ID": mid}, name="merge_time"),
            "n_parents": Field(
                np.array([len(p) for p in merge_parent_ids], np.int8), ("merge_ID",), {"merge_ID": mid}, name="n_parents"
            ),
            "n_children": Field(
                np.array([len(c) for c in merge_child_ids], np.int8), ("merge_ID",), {"merge_ID": mid}, name="n_children"
            ),
        },
        attrs={"fill_value": -1},
    )


def _symmetrize_neighbours(nb: np.ndarray) -> np.ndarray:
    """
    Symmetrised neighbour table: every directed edge (i -> j) of the (K, C)
    0-based table gains its reverse, grouped back into a fixed-width
    (K', C) table (-1 padded), each cell's neighbours ascending. Mesh files
    carry asymmetric entries; labelling treats them as undirected.
    """
    K, C = nb.shape
    src = np.broadcast_to(np.arange(C, dtype=np.int64), (K, C))[nb >= 0]
    dst = nb[nb >= 0].astype(np.int64)
    # one int64 key an edge, a * C + b: a flat sort in (a, b) order (a sort of
    # index pairs takes ten times as long at a million cells)
    keys = np.unique(np.concatenate([src * C + dst, dst * C + src]))
    a, b = keys // C, keys % C
    deg = np.bincount(a, minlength=C)
    out = np.full((max(int(deg.max()) if len(keys) else 1, 1), C), -1, np.int32)
    out[np.arange(len(keys)) - (np.cumsum(deg) - deg)[a], a] = b
    return out


def regional_tracker(
    data_bin: Any,
    mask: Any,
    coordinate_units: str,
    R_fill: Union[int, float],
    area_filter_quartile: Optional[float] = None,
    area_filter_absolute: Optional[int] = None,
    **kwargs: Any,
) -> tracker:
    """
    A tracker for a regional (non-global) domain with open boundaries: sets
    ``regional_mode=True`` and requires the coordinate units
    (``marex_tpu.regional_tracker``).
    """
    return tracker(
        data_bin,
        mask,
        R_fill=R_fill,
        area_filter_quartile=area_filter_quartile,
        area_filter_absolute=area_filter_absolute,
        regional_mode=True,
        coordinate_units=coordinate_units,
        **kwargs,
    )
