"""
MarEx track on PyTorch: event identification and tracking.

The port of ``marex_tpu/track.py`` for the main path: gridded, global
(periodic in longitude) tracking without merging — morphological hole and
gap filling, the area filter over per-slice connected components (with the
reference's drop-first-object quirk), 3x3x3 spatio-temporal event labelling
and the summary attributes. Both labellings run on the hand-written CUDA
min-stencil, hook and pointer-jump kernels when the field lies on a GPU.

``allow_merging=True``, ``unstructured_grid=True``, ``regional_mode=True``,
``mesh`` and ``checkpoint`` raise ``NotImplementedError`` naming the ROADMAP
item that brings them. Device placement is explicit: a torch tensor input
keeps its device; numpy or ``Field`` payloads move to ``device``.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .core.field import Coord, Field, FieldSet, as_field, on_device
from .exceptions import ConfigurationError, TrackingError, create_coordinate_error, create_data_validation_error
from .logging_config import configure_logging, get_logger, log_array_info, log_memory_usage, log_timing
from .ops import label as _label
from .ops import morphology as _morph

logger = get_logger(__name__)

_NOT_PORTED = {
    "allow_merging": "ROADMAP queue 1, item 5 (merge tracking)",
    "unstructured_grid": "ROADMAP queue 1, item 9 (unstructured meshes)",
    "regional_mode": "ROADMAP queue 1, item 8 (regional mode)",
    "mesh": "ROADMAP queue 1, item 11 (multi-GPU)",
    "checkpoint": "ROADMAP queue 1, item 3 (tracker checkpoints, with io/zarr_lite from item 10)",
}


def _is_bool(data: Any) -> bool:
    return data.dtype == torch.bool if isinstance(data, torch.Tensor) else np.dtype(data.dtype) == np.bool_


class tracker:
    """
    Identify and track binary objects through time (API-compatible with
    ``marex_tpu.tracker``; gridded, global, no-merge tracking is ported).

    ``data_bin`` / ``mask`` may be Fields (of this package or duck-typed
    equivalents) with numpy or torch payloads; ``device`` places payloads
    that are not already tensors.
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
        for name, value in (
            ("allow_merging", allow_merging),
            ("unstructured_grid", unstructured_grid),
            ("regional_mode", regional_mode),
            ("mesh", mesh is not None),
            ("checkpoint", bool(checkpoint)),
        ):
            if value:
                raise NotImplementedError(f"{name} is not ported to marex_tpu_torch yet: {_NOT_PORTED[name]}")
        if verbose is not None or quiet is not None:
            configure_logging(verbose=verbose, quiet=quiet)

        logger.info("Initialising MarEx tracker (PyTorch)")
        logger.info(
            f"Parameters: R_fill={R_fill}, T_fill={T_fill}, "
            f"area_filter_quartile={area_filter_quartile}, area_filter_absolute={area_filter_absolute}"
        )

        self.data_bin = as_field(data_bin)
        self.mask = as_field(mask)
        log_array_info(logger, self.data_bin, "Binary input data")

        self.regional_mode = False
        self.unstructured_grid = False
        self.allow_merging = False
        self.coordinate_units = coordinate_units

        dimensions = dimensions or {}
        coordinates = coordinates or {}
        self.timedim = dimensions.get("time", "time")
        self.xdim = dimensions.get("x", "lon")
        self.ydim = dimensions.get("y", "lat")
        self.timecoord = coordinates.get("time", self.timedim)
        self.xcoord = coordinates.get("x", self.xdim)
        self.ycoord = coordinates.get("y", self.ydim)

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

        self.lat = np.asarray(self.data_bin.coords[self.ycoord].values, dtype=np.float64)
        self.lon = np.asarray(self.data_bin.coords[self.xcoord].values, dtype=np.float64)
        self.data_attrs = dict(self.data_bin.attrs)

        self._validate_inputs(grid_resolution)

        # payloads on their device: the binary field, and the mask beside it
        self.data_bin = self.data_bin._replace(data=on_device(self.data_bin.data, device).contiguous())
        self.device = self.data_bin.data.device
        self.mask_dev = on_device(self.mask.data, self.device).to(self.device)
        self.stage_walls: Dict[str, float] = {}
        #: torch.cuda.max_memory_allocated() read at the end of each stage that
        #: ran on CUDA: a running maximum, so the first stage to show the final
        #: value is the one that set the peak
        self.stage_peak_bytes: Dict[str, int] = {}
        self.ccl_iterations: Dict[str, int] = {}

        # ---- cell areas -------------------------------------------------
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

    def _validate_inputs(self, grid_resolution: Optional[float]) -> None:
        if tuple(self.data_bin.dims) != (self.timedim, self.ydim, self.xdim):
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
                details=f"Found dtype {self.data_bin.dtype}, expected bool",
                suggestions=[
                    "Convert data using da > threshold for binary events",
                    "Use field.astype(bool) for boolean conversion",
                ],
                data_info={"actual_dtype": str(self.data_bin.dtype), "expected_dtype": "bool"},
            )

        if grid_resolution is not None and (not isinstance(grid_resolution, (int, float)) or grid_resolution <= 0):
            raise create_data_validation_error(
                "grid_resolution must be a positive number",
                details=f"Received grid_resolution={grid_resolution}",
                suggestions=["Provide a positive float value representing grid resolution in degrees"],
            )

        if not _is_bool(self.mask.data):
            raise create_data_validation_error(
                "Mask must be binary (boolean type)",
                details=f"Found mask dtype {self.mask.dtype}, expected bool",
                suggestions=["Convert mask using mask > 0 or mask.astype(bool)"],
                data_info={"mask_dtype": str(self.mask.dtype)},
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
        """Auto-detect units and convert radians -> degrees (global grids)."""
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

    def run(self, return_merges: bool = False, checkpoint: Optional[str] = None) -> FieldSet:
        """Run preprocessing, tracking and statistics; returns the events FieldSet."""
        if checkpoint:
            raise NotImplementedError(f"checkpoint is not ported to marex_tpu_torch yet: {_NOT_PORTED['checkpoint']}")
        logger.info("Starting complete tracking pipeline")
        log_memory_usage(logger, "Pipeline start", logging.DEBUG)

        with log_timing(logger, "Data preprocessing", log_memory=True):
            data_bin_preprocessed, object_stats = self.run_preprocess()

        with log_timing(logger, "Object identification and tracking", log_memory=True):
            events_ds, merges_ds, N_events_final = self.run_tracking(data_bin_preprocessed)
        del data_bin_preprocessed

        with log_timing(logger, "Computing event statistics and attributes", log_memory=True):
            events_ds = self.run_stats_attributes(events_ds, merges_ds, object_stats, N_events_final)

        logger.info(f"Tracking pipeline completed successfully - {N_events_final} events identified")
        return events_ds

    @contextmanager
    def _stage_ctx(self, name: str):
        """Accumulate the wall time of a pipeline substage into
        ``self.stage_walls``. A stage that ran on CUDA ends with a
        synchronise, so its device work is inside its own wall."""
        t0 = time.perf_counter()
        try:
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                self.stage_peak_bytes[name] = torch.cuda.max_memory_allocated(self.device)
        finally:
            d = self.stage_walls
            d[name] = round(d.get(name, 0.0) + (time.perf_counter() - t0), 4)

    # ------------------------------------------------------------------
    # Stage 1: preprocessing
    # ------------------------------------------------------------------

    def compute_area(self, data_bin: torch.Tensor) -> np.ndarray:
        """Active cell count per timestep, as a small host array (int32
        accumulator: a bool sum first casts the whole field to it)."""
        return data_bin.sum(dim=(1, 2), dtype=torch.int32).cpu().numpy()

    def fill_holes(self, data: torch.Tensor, R_fill: Optional[int] = None) -> torch.Tensor:
        """Morphological closing+opening with a disk of ``R_fill``."""
        if R_fill is None:
            R_fill = self.R_fill
        return _morph.binary_close_open_grid(data, int(R_fill), self.mask_dev)

    def fill_time_gaps(self, data: torch.Tensor) -> torch.Tensor:
        """Temporal closing, then a re-fill of new spatial holes at R_fill // 2."""
        if self.T_fill == 0:
            return data
        closed = _morph.binary_close_time(data, int(self.T_fill))
        return self.fill_holes(closed, R_fill=self.R_fill // 2)

    def filter_small_objects(self, data: torch.Tensor):
        """
        Remove per-slice objects below the area threshold. Returns
        ``(filtered, area_threshold, object_areas, N_prefiltered, N_filtered)``.

        Like the reference, the globally first object (smallest root of the
        first slice holding any) is always dropped: the reference marks
        ``object_ids_keep[0] = -1`` meaning to skip the background id 0, which
        is never in that list, so its first real object goes.
        """
        with self._stage_ctx("filter/ccl_fixpoint"):
            root_flat, counts_dev, iters = _label.label_slices_grid_roots(data, wrap_x=True)
            counts = counts_dev.cpu().numpy()
        self.ccl_iterations["filter/ccl_fixpoint"] = iters
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
        t_first = int(np.argmax(counts > 0))
        with self._stage_ctx("filter/root_stats"):
            root_ids, areas_dev, area_cell, _ = _label.slice_root_stats(root_flat, L)
            areas_tj = areas_dev.cpu().numpy()  # (T, L) ascending root order, 0 padded
        slot = np.arange(L)[None, :] < counts[:, None]
        object_areas = areas_tj[slot]

        N_prefiltered = int(object_areas.size)
        if self._use_absolute_filtering:
            area_threshold = float(self.area_filter_absolute)
        else:
            area_threshold = float(np.percentile(object_areas, self.area_filter_quartile * 100.0))
        keep_first = areas_tj[t_first, 0] >= area_threshold
        N_filtered = int(np.sum(object_areas >= area_threshold)) - int(keep_first)

        with self._stage_ctx("filter/apply"):
            filtered = area_cell >= torch.tensor(area_threshold, dtype=torch.float32, device=area_cell.device)
            first = root_flat[t_first] == root_ids[t_first, 0]
            filtered[t_first].logical_and_(~first)
            out = filtered.view(data.shape)
        return out, area_threshold, object_areas, N_prefiltered, N_filtered

    def run_preprocess(self):
        """Morphological fill and area filtering; returns ``(filtered, object_stats)``."""
        data = self.data_bin.data
        raw_area = self.compute_area(data)

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

        processed_area = self.compute_area(data_filtered)

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
        return data_filtered, object_stats

    # ------------------------------------------------------------------
    # Stage 2: tracking
    # ------------------------------------------------------------------

    def run_tracking(self, data_bin_preprocessed: torch.Tensor):
        """Label events as 3x3x3-connected components in (time, y, x);
        returns ``(events_ds, merges_ds, N_events)``."""
        with self._stage_ctx("ccl3d"):
            labf, iters = _label.label_spacetime_roots(data_bin_preprocessed, wrap_x=True)
            dense, N_events = _label.densify_spacetime_roots(labf)
            del labf
            labels = dense.view(data_bin_preprocessed.shape)
        self.ccl_iterations["ccl3d"] = iters
        dims = (self.timedim, self.ydim, self.xdim)
        events_ds = FieldSet({"ID_field": Field(labels, dims, self.data_bin.coords, name="ID_field")})
        logger.info("Finished tracking all extreme events!")
        return events_ds, FieldSet(), N_events

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

        events_ds.attrs.update(self.data_attrs)
        return self._remap_coordinates(events_ds)

    def _remap_coordinates(self, events_ds: FieldSet) -> FieldSet:
        """Restore the original coordinate values (units and ranges)."""
        ydims = events_ds.coords[self.ycoord].dims if self.ycoord in events_ds.coords else (self.ydim,)
        xdims = events_ds.coords[self.xcoord].dims if self.xcoord in events_ds.coords else (self.xdim,)
        events_ds.coords[self.ycoord] = Coord(ydims, self.lat_init)
        events_ds.coords[self.xcoord] = Coord(xdims, self.lon_init)
        return events_ds
