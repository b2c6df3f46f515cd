"""
MarEx detect on PyTorch: anomalies and extreme-event identification.

The port of ``marex_tpu/detect.py`` on gridded (time, lat, lon) and
unstructured (time, cell) data: the four anomaly
methods (``detrend_harmonic`` with ``std_normalise``, ``shifting_baseline``,
``fixed_baseline``, ``detrend_fixed_baseline``), the two extreme methods
(``global_extreme``, ``hobday_extreme``), each with the approximate and the
exact percentile, the public shifting-baseline helpers, and the reference's
validation and output contract (``dat_anomaly``, ``mask``,
``extreme_events``, ``thresholds`` and provenance attrs). Unstructured data
needs explicit ``coordinates``, takes no spatial Hobday window, and carries
``neighbours`` and ``cell_areas`` through for the tracker. On a device mesh
(``mesh=``, or ``parallel.use_mesh``) each process computes one band of
whole latitude rows (a range of cells on an unstructured mesh), cut from the
input before it is uploaded; only the Hobday spatial window exchanges rows
with the neighbouring bands, and the outputs are DTensors split the same
way, equal to one process's.

Device placement is explicit: a torch tensor input keeps its device; numpy
or ``Field`` payloads move to ``device`` (default ``"cuda"``). Nothing falls
back to the CPU on its own, and every output (``dat_stn`` and ``STD``
included) stays on the device.
"""

from __future__ import annotations

import logging
import sys
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import tracing
from .core.field import Coord, Field, FieldSet, as_field, is_dtensor, on_device
from .core.timeaxis import TimeIndexInfo, decompose_time, gather_from_year_doy, scatter_to_year_doy
from .exceptions import ConfigurationError, create_data_validation_error
from .logging_config import configure_logging, get_logger, log_array_info, log_memory_usage, log_timing
from .ops import climatology as _clim
from .ops import detrend as _detrend
from .ops import pipeline as _pipe
from .ops import quantile as _quant

logger = get_logger(__name__)

_ANOMALY_METHODS = ["detrend_harmonic", "shifting_baseline", "fixed_baseline", "detrend_fixed_baseline"]


# ============================
# Validation Functions
# ============================


def _validate_dimensions_exist(da: Field, dimensions: Dict[str, str]) -> None:
    """Ensure every mapped dimension name exists on the Field."""
    missing = [f"'{actual}' (for {concept})" for concept, actual in dimensions.items() if actual not in da.dims]
    if missing:
        available = list(da.dims)
        raise create_data_validation_error(
            f"Missing required dimensions: {', '.join(missing)}",
            details=f"Dataset has dimensions: {available}",
            suggestions=[
                "Check dimension names in your data",
                "Update the 'dimensions' parameter to match your data structure",
                f"Available dimensions: {available}",
            ],
            data_info={
                "missing_dimensions": missing,
                "available_dimensions": available,
                "provided_dimensions": dimensions,
            },
        )


def _validate_coordinates_exist(da: Field, coordinates: Dict[str, str]) -> None:
    """Ensure every mapped coordinate name exists."""
    missing = [f"'{actual}' (for {concept})" for concept, actual in coordinates.items() if actual not in da.coords]
    if missing:
        available = list(da.coords.keys())
        raise create_data_validation_error(
            f"Missing required coordinates: {', '.join(missing)}",
            details=f"Dataset has coordinates: {available}",
            suggestions=[
                "Check coordinate names in your data",
                "Update the 'coordinates' parameter to match your data structure",
                f"Available coordinates: {available}",
            ],
            data_info={
                "missing_coordinates": missing,
                "available_coordinates": available,
                "provided_coordinates": coordinates,
            },
        )


def _infer_dims_coords(
    da: Field, dimensions: Optional[Dict[str, str]], coordinates: Optional[Dict[str, str]]
) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Apply the default dim/coord names {time: time, x: lon, y: lat} and
    validate. Unstructured data (no 'y' dimension) needs explicit coordinates."""
    if dimensions is None:
        dimensions = {"time": "time", "x": "lon", "y": "lat"}
    if "time" not in dimensions:
        dimensions = {"time": "time", **dimensions}
    if coordinates is None:
        if "y" not in dimensions:
            logger.error("Coordinates parameter required for unstructured data")
            raise create_data_validation_error(
                "Coordinates parameter must be explicitly specified for unstructured data",
                details="Unstructured data requires coordinate names for x and y spatial coordinates",
                suggestions=[
                    "Specify coordinates parameter with spatial coordinate names",
                    "Example: coordinates={'time': 'time', 'x': 'lon', 'y': 'lat'}",
                    f"Your x dimension '{dimensions['x']}' needs associated coordinate names",
                    "If data is gridded, ensure 'y' dimension is also specified",
                ],
                data_info={
                    "data_structure": "unstructured (2D)",
                    "dimensions": dimensions,
                    "missing_coordinates": "x and y spatial coordinates",
                },
            )
        coordinates = dimensions.copy()
    elif "time" not in coordinates:
        coordinates = {"time": dimensions.get("time", "time"), **coordinates}

    _validate_dimensions_exist(da, dimensions)
    _validate_coordinates_exist(da, coordinates)
    return dimensions, coordinates


def _validate_data_values(data: torch.Tensor) -> None:
    """
    The reference's NaN/inf policy: the spatial mask comes from time step 0;
    any non-finite value at a valid location at any other time is an error.
    ``data`` is (T, *spatial); the statistics are reduced on its device (on
    a mesh, over every rank's band).
    """
    finite = torch.isfinite(data)
    spatial_mask = finite[0]
    invalid_in_valid = torch.where(spatial_mask, (~finite).sum(dim=0, dtype=torch.int32), 0)
    del finite
    stats = {
        "total_values": int(data.numel()),
        "total_ocean_locations": int(spatial_mask.sum()),
        "max_invalid": int(invalid_in_valid.max()) if invalid_in_valid.numel() else 0,
        "total_invalid": int(invalid_in_valid.sum()),
        "locations_affected": int((invalid_in_valid > 0).sum()),
    }
    if _BAND is not None:
        stats = _BAND.combine(stats, max_keys=("max_invalid",))
    if stats["total_ocean_locations"] == 0:
        raise create_data_validation_error(
            "Dataset contains no valid (finite) data",
            details="All values in the first time step are NaN or infinite",
            suggestions=[
                "Check your input data for data quality issues",
                "Verify the data was loaded correctly",
            ],
            data_info={"total_values": stats["total_values"]},
        )
    max_invalid = stats["max_invalid"]
    if max_invalid > 0:
        total_invalid = stats["total_invalid"]
        locations_affected = stats["locations_affected"]
        raise create_data_validation_error(
            f"Dataset contains {total_invalid} invalid values in {locations_affected} ocean locations",
            details=(
                f"Found invalid data across time series. Worst location has {max_invalid} "
                f"invalid time steps out of {data.shape[0]}."
            ),
            suggestions=[
                "Remove or interpolate NaN/infinite values before preprocessing",
                "Check data quality and loading procedures",
                "For ocean data, ensure land mask is properly applied before preprocessing",
            ],
            data_info={
                "total_invalid_values_in_ocean": total_invalid,
                "locations_affected": locations_affected,
                "total_ocean_locations": stats["total_ocean_locations"],
                "max_invalid_at_one_location": max_invalid,
                "total_time_steps": int(data.shape[0]),
            },
        )


def _reject_reference_period(method_anomaly: str, reference_period) -> None:
    if reference_period is not None and method_anomaly not in ("fixed_baseline", "detrend_fixed_baseline"):
        raise ConfigurationError(
            f"reference_period is not supported for method_anomaly='{method_anomaly}'",
            details="reference_period is only applicable to 'fixed_baseline' and 'detrend_fixed_baseline' methods",
            suggestions=[
                "Remove the reference_period parameter, or",
                "Use method_anomaly='fixed_baseline' or 'detrend_fixed_baseline'",
            ],
        )


# ============================
# Internal staging
# ============================


class _Staged:
    """The input as a (T, H, W) float32 tensor (gridded) or a (T, C) one
    (unstructured) on its device, with the calendar decomposition of its
    time coordinate."""

    def __init__(self, da: Field, dimensions: Dict[str, str], coordinates: Dict[str, str], device):
        self.timedim = dimensions["time"]
        ydim = dimensions.get("y")
        self.is_gridded = ydim is not None and ydim in da.dims
        self.spatial_dims = (ydim, dimensions["x"]) if self.is_gridded else (dimensions["x"],)
        payload = da.data
        da = da.transpose(self.timedim, *self.spatial_dims)
        self.field = da
        self.spatial_shape = tuple(da.sizes[d] for d in self.spatial_dims)
        self.data = on_device(da.data, device).to(torch.float32).contiguous()
        #: True when ``data`` is a private copy, not the caller's tensor
        self.copied = not (isinstance(payload, torch.Tensor) and self.data.data_ptr() == payload.data_ptr())
        self.tinfo: TimeIndexInfo = decompose_time(da.coords[coordinates["time"]].values)

    @property
    def flat(self) -> torch.Tensor:
        """The payload as a (T, S) view."""
        return self.data.view(self.data.shape[0], -1)

    def spatial_coords(self) -> Dict[str, Coord]:
        return {name: c for name, c in self.field.coords.items() if set(c.dims) <= set(self.spatial_dims)}

    def doy_coords(self) -> Dict[str, Coord]:
        return {**self.spatial_coords(), "dayofyear": Coord("dayofyear", np.arange(1, 367))}

    def time_field(self, data: torch.Tensor, name: str) -> Field:
        """A (T, *spatial) result on the input's dims and coords."""
        return Field(data.view((-1,) + self.spatial_shape), (self.timedim,) + self.spatial_dims,
                     self.field.coords, name=name)

    def doy_field(self, data: torch.Tensor, name: str) -> Field:
        """A (366, *spatial) result on ("dayofyear", *spatial dims)."""
        return Field(data.view((366,) + self.spatial_shape), ("dayofyear",) + self.spatial_dims,
                     self.doy_coords(), name=name)

    def anomaly_set(self, anomalies: torch.Tensor, mask: torch.Tensor, extra: Optional[Dict[str, Field]] = None):
        """``dat_anomaly`` and ``mask`` (plus ``extra``) as a FieldSet."""
        data_vars = {
            "dat_anomaly": self.time_field(anomalies, "dat_anomaly"),
            "mask": Field(mask, self.spatial_dims, self.spatial_coords(), name="mask"),
            **(extra or {}),
        }
        return FieldSet(data_vars, dict(self.field.coords))


# ============================
# Device meshes
# ============================


def mesh_of(mesh: Any, device: Union[str, torch.device]):
    """The mesh an entry point runs on (``parallel.mesh.resolve_mesh``), or
    None; ``parallel`` is imported only when a mesh is asked for or may be
    scoped (a default mesh exists only once it has been imported)."""
    if mesh is None and "marex_tpu_torch.parallel.mesh" not in sys.modules:
        return None
    from .parallel.mesh import resolve_mesh

    return resolve_mesh(mesh, device)


#: this process's share of the ``preprocess_data`` run on a mesh (None in one process)
_BAND: Optional["_Band"] = None


class _Band:
    """
    This process's share of ``preprocess_data`` on a mesh: one band of whole
    latitude rows (a range of cells on an unstructured mesh) under
    ``parallel.detect_sharding``, or all of it when the spatial dim does not
    divide by the mesh's size (the replicated route, logged). Its methods
    are the stage's only communication: the global statistics of the
    input's validation and of the threshold range, the Hobday window's halo
    rows, and the outputs as DTensors.
    """

    def __init__(self, mesh, da: Field, dimensions: Dict[str, str]):
        from .parallel.comm import ShardComm

        self.mesh = mesh
        self.comm = ShardComm(mesh)
        ydim = dimensions.get("y")
        self.dim = ydim if ydim is not None and ydim in da.dims else dimensions["x"]
        self.n = da.sizes[self.dim]
        self.split = self.n > 0 and self.n % self.comm.size == 0
        if not self.split:
            logger.info(f"{self.dim} ({self.n}) does not split over {self.comm.size} ranks: detect runs replicated")
        self.start, self.stop = self.comm.bounds(self.n) if self.split else (0, self.n)
        self.coords = {k: c for k, c in da.coords.items() if self.dim in c.dims}

    def _placements(self, axis: int):
        from torch.distributed.tensor import Replicate, Shard

        return (Shard(axis),) * 2 if self.split else (Replicate(),) * 2

    def local(self, da: Field) -> Field:
        """This rank's band of the input: a host payload (numpy, a lazy
        store) is cut here, before any upload; a DTensor is redistributed."""
        band = slice(self.start, self.stop)
        if is_dtensor(da.data):
            from .parallel.mesh import Sharding, constrain

            part = constrain(da.data, Sharding(self.mesh, self._placements(da.dims.index(self.dim)))).to_local()
            coords = {k: c.isel({self.dim: band}) if self.dim in c.dims else c for k, c in da.coords.items()}
            return Field(part, da.dims, coords, da.name, da.attrs)
        return da.isel({self.dim: band})

    def combine(self, stats: Dict[str, int], max_keys: Tuple[str, ...] = ()) -> Dict[str, int]:
        """Per-band statistics summed over the bands (the largest for ``max_keys``)."""
        if not self.split:
            return stats
        every = self.comm.gather(stats)
        return {k: (max if k in max_keys else sum)(s[k] for s in every) for k in stats}

    def nan_range(self, lo: float, hi: float) -> Tuple[float, float]:
        """The threshold range over every band (NaN where none is finite)."""
        if not self.split:
            return lo, hi
        pairs = np.array(self.comm.gather((lo, hi)), dtype=np.float64)
        if not np.isfinite(pairs).any():
            return float("nan"), float("nan")
        return float(np.nanmin(pairs[:, 0])), float(np.nanmax(pairs[:, 1]))

    def row_halo(self, data: torch.Tensor, rows: int) -> Tuple[torch.Tensor, int, int]:
        """(T, H', W) band with up to ``rows`` rows of the neighbouring bands
        on each side (none beyond the grid's first and last rows), and how
        many it got before and after."""
        if not self.split or rows == 0:
            return data, 0, 0
        before, after = self.comm.halo(data, 1, rows, rows)
        if before.shape[1] + after.shape[1] == 0:
            return data, 0, 0
        return torch.cat([before, data, after], dim=1), before.shape[1], after.shape[1]

    def wrap(self, ds: FieldSet) -> FieldSet:
        """The band's outputs as DTensors of the whole field (this rank's
        band of each, no communication), on the input's full coordinates."""
        from .parallel.mesh import Sharding, from_local

        out = {}
        for name, f in ds.data_vars.items():
            axis = f.dims.index(self.dim)
            shape = list(f.shape)
            shape[axis] = self.n
            data = from_local(f.data.contiguous(), Sharding(self.mesh, self._placements(axis)), shape)
            coords = {**f.coords, **{k: c for k, c in self.coords.items() if set(c.dims) <= set(f.dims)}}
            out[name] = Field(data, f.dims, coords, f.name, f.attrs)
        return FieldSet(out, {**ds.coords, **self.coords}, ds.attrs)


# ============================
# Public API
# ============================


def preprocess_data(
    da: Any,
    method_anomaly: str = "shifting_baseline",
    method_extreme: str = "hobday_extreme",
    threshold_percentile: float = 95,
    window_year_baseline: int = 15,
    smooth_days_baseline: int = 21,
    window_days_hobday: int = 11,
    window_spatial_hobday: Optional[int] = None,
    std_normalise: bool = False,
    detrend_orders: Optional[List[int]] = None,
    force_zero_mean: bool = True,
    reference_period: Optional[Tuple[int, int]] = None,
    method_percentile: str = "approximate",
    precision: float = 0.01,
    max_anomaly: float = 5.0,
    dask_chunks: Optional[Dict[str, int]] = None,
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    neighbours: Optional[Any] = None,
    cell_areas: Optional[Any] = None,
    use_temp_checkpoints: bool = False,
    verbose: Optional[bool] = None,
    quiet: Optional[bool] = None,
    mesh: Optional[Any] = None,
    donate_input: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> FieldSet:
    """
    Complete preprocessing pipeline: anomalies + extreme identification,
    API-compatible with ``marex_tpu.preprocess_data``.

    ``dask_chunks`` and ``use_temp_checkpoints`` are accepted and ignored.
    With ``donate_input=True`` a float32 tensor input may be overwritten in
    place by the anomalies (saving one field-sized buffer).

    Returns a FieldSet with ``dat_anomaly``, ``mask``, ``extreme_events`` and
    ``thresholds`` (plus ``dat_stn``, ``STD``, ``extreme_events_stn`` and
    ``thresholds_stn`` with ``std_normalise`` on ``detrend_harmonic``), as
    tensors on the input's device, and provenance attrs. The shifting
    baseline drops its first ``window_year_baseline`` years.

    ``mesh`` (a ``DeviceMesh`` from ``parallel.make_mesh``, or True for a
    mesh over every process of the ``torch.distributed`` world, one on
    ``device``'s type; None takes ``parallel.use_mesh``'s) runs the stage on
    every process of the mesh, each on one band of whole latitude rows (a
    range of cells on an unstructured mesh), cut from a host input before
    its upload. The outputs are DTensors split the same way (whole on every
    rank when the spatial dim does not divide by the mesh's size), equal to
    one process's run. Every process of the mesh must call it.
    """
    if detrend_orders is None:
        detrend_orders = [1]
    if verbose is not None or quiet is not None:
        configure_logging(verbose=verbose, quiet=quiet)

    logger.info(f"Starting data preprocessing - Method: {method_anomaly} -> {method_extreme}")
    logger.info(f"Parameters: percentile={threshold_percentile}%, method_percentile={method_percentile}")

    da = as_field(da)
    log_array_info(logger, da, "Input data")
    log_memory_usage(logger, "Initial memory state", logging.DEBUG)
    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)

    kw = dict(
        method_anomaly=method_anomaly, method_extreme=method_extreme, threshold_percentile=threshold_percentile,
        window_year_baseline=window_year_baseline, smooth_days_baseline=smooth_days_baseline,
        window_days_hobday=window_days_hobday, window_spatial_hobday=window_spatial_hobday,
        std_normalise=std_normalise, detrend_orders=detrend_orders, force_zero_mean=force_zero_mean,
        reference_period=reference_period, method_percentile=method_percentile, precision=precision,
        max_anomaly=max_anomaly, dimensions=dimensions, coordinates=coordinates, neighbours=neighbours,
        cell_areas=cell_areas, donate_input=donate_input, device=device,
    )
    mesh = mesh_of(mesh, device)
    with tracing.span("detect"):
        if mesh is None:
            return _preprocess(da, None, **kw)
        global _BAND
        band = _Band(mesh, da, dimensions)
        _BAND = band
        try:
            with band.comm.guard():
                return _preprocess(band.local(da), band, **kw)
        finally:
            _BAND = None


def _preprocess(da: Field, band: Optional[_Band], method_anomaly, method_extreme, threshold_percentile,
                window_year_baseline, smooth_days_baseline, window_days_hobday, window_spatial_hobday, std_normalise,
                detrend_orders, force_zero_mean, reference_period, method_percentile, precision, max_anomaly,
                dimensions, coordinates, neighbours, cell_areas, donate_input, device) -> FieldSet:
    """The body of :func:`preprocess_data` on ``da`` (on a mesh, this rank's
    ``band`` of it)."""
    # stage the payload on its device once; a copy made here is ours to overwrite
    if not isinstance(da.data, torch.Tensor):
        da = Field(on_device(np.asarray(da.data, dtype=np.float32), device), da.dims, da.coords, da.name, da.attrs)
        donate_input = True
    _reject_reference_period(method_anomaly, reference_period)
    _validate_data_values(da.data.movedim(da.dims.index(dimensions["time"]), 0))

    with log_timing(logger, f"Anomaly computation using {method_anomaly} method", log_memory=True,
                    span="detect/anomaly"):
        ds = compute_normalised_anomaly(
            da,
            method_anomaly,
            dimensions,
            coordinates,
            window_year_baseline,
            smooth_days_baseline,
            std_normalise,
            detrend_orders,
            force_zero_mean,
            reference_period,
            donate_input=donate_input,
            device=device,
        )

    if method_anomaly == "shifting_baseline":
        ds = _trim_baseline_years(ds, dimensions["time"], coordinates["time"], window_year_baseline)

    with log_timing(logger, f"Extreme event identification using {method_extreme} method", log_memory=True,
                    span="detect/extremes"):
        extremes, thresholds = identify_extremes(
            ds["dat_anomaly"],
            method_extreme,
            threshold_percentile,
            dimensions,
            coordinates,
            window_days_hobday,
            window_spatial_hobday,
            method_percentile,
            precision,
            max_anomaly,
            device=device,
        )
    ds["extreme_events"] = extremes
    ds["thresholds"] = thresholds

    if std_normalise and method_anomaly == "detrend_harmonic":
        logger.info("Processing standardised anomalies for extreme identification")
        extremes_stn, thresholds_stn = identify_extremes(
            ds["dat_stn"],
            method_extreme,
            threshold_percentile,
            dimensions,
            coordinates,
            window_days_hobday,
            window_spatial_hobday,
            method_percentile,
            precision,
            max_anomaly,
            device=device,
        )
        ds["extreme_events_stn"] = extremes_stn
        ds["thresholds_stn"] = thresholds_stn

    n_extremes = int(ds["extreme_events"].data.flatten(1).sum(dim=1, dtype=torch.int32).sum())
    if band is not None:
        n_extremes = band.combine({"n": n_extremes})["n"]
        ds = band.wrap(ds)

    if neighbours is not None:
        nb = as_field(neighbours)
        ds["neighbours"] = nb.astype(np.int32)
        if "nv" in nb.dims:
            ds.coords.setdefault("nv", Coord("nv", np.arange(nb.sizes["nv"])))
    if cell_areas is not None:
        ds["cell_areas"] = as_field(cell_areas).astype(np.float32)

    ds.attrs.update(
        {
            "method_anomaly": method_anomaly,
            "method_extreme": method_extreme,
            "threshold_percentile": threshold_percentile,
            "preprocessing_steps": _get_preprocessing_steps(
                method_anomaly,
                method_extreme,
                std_normalise,
                detrend_orders,
                window_year_baseline,
                smooth_days_baseline,
                window_days_hobday,
                window_spatial_hobday,
                reference_period,
            ),
        }
    )
    if method_anomaly == "detrend_harmonic":
        ds.attrs.update(
            {"detrend_orders": detrend_orders, "force_zero_mean": force_zero_mean, "std_normalise": std_normalise}
        )
    elif method_anomaly == "shifting_baseline":
        ds.attrs.update(
            {"window_year_baseline": window_year_baseline, "smooth_days_baseline": smooth_days_baseline}
        )
    else:
        if method_anomaly == "detrend_fixed_baseline":
            ds.attrs.update({"detrend_orders": detrend_orders, "force_zero_mean": force_zero_mean})
        if reference_period is not None:
            ds.attrs["reference_period"] = list(reference_period)
    if method_extreme == "hobday_extreme":
        ds.attrs["window_days_hobday"] = window_days_hobday
    ds.attrs.update({"method_percentile": method_percentile, "precision": precision, "max_anomaly": max_anomaly})

    logger.info(f"Preprocessing completed successfully - {n_extremes} extreme events identified")
    return ds


def _trim_baseline_years(ds: FieldSet, timedim: str, timecoord: str, window_year_baseline: int) -> FieldSet:
    """Drop the shifting baseline's first ``window_year_baseline`` years (they
    have no climatology)."""
    tinfo = decompose_time(ds.coords[timecoord].values)
    total_years = int(tinfo.year.max() - tinfo.year.min() + 1)
    if total_years < window_year_baseline:
        raise create_data_validation_error(
            "Insufficient data for shifting_baseline method",
            details=f"Dataset spans {total_years} years but requires at least {window_year_baseline} years",
            suggestions=[
                "Use more years of data to meet minimum requirement",
                f"Reduce window_year_baseline parameter (currently {window_year_baseline})",
                "Consider using detrend_fixed_baseline or detrend_harmonic method instead",
            ],
            data_info={"available_years": total_years, "required_years": int(window_year_baseline)},
        )
    start_year = int(tinfo.year.min() + window_year_baseline)
    keep = np.nonzero(tinfo.year >= start_year)[0]
    if keep.size == 0:
        # `total_years < window` lets the equality case through, which would
        # empty the dataset: fail loudly instead, as the reference does
        raise create_data_validation_error(
            "Insufficient data for shifting_baseline method",
            details=(
                f"Removing the first {window_year_baseline} baseline years "
                f"leaves no timesteps (dataset spans {total_years} years)"
            ),
            suggestions=[
                "Use more years of data (at least window_year_baseline + 1)",
                f"Reduce window_year_baseline parameter (currently {window_year_baseline})",
                "Consider using detrend_fixed_baseline or detrend_harmonic method instead",
            ],
            data_info={"available_years": total_years, "required_years": int(window_year_baseline) + 1},
        )
    logger.info(f"Trimming data to start from {start_year} (removing first {window_year_baseline} years)")
    return ds.isel({timedim: keep})


def _get_preprocessing_steps(
    method_anomaly: str,
    method_extreme: str,
    std_normalise: bool,
    detrend_orders: List[int],
    window_year_baseline: int,
    smooth_days_baseline: int,
    window_days_hobday: int,
    window_spatial_hobday: Optional[int],
    reference_period: Optional[Tuple[int, int]] = None,
) -> List[str]:
    """Provenance description of the processing chain."""
    steps = []
    if method_anomaly == "detrend_harmonic":
        steps.append(f"Removed polynomial trend orders={detrend_orders} & seasonal cycle")
        if std_normalise:
            steps.append("Normalised by 30-day rolling STD")
    elif method_anomaly == "shifting_baseline":
        steps.append(f"Rolling climatology using {window_year_baseline} years")
        steps.append(f"Smoothed with {smooth_days_baseline}-day window")
    elif method_anomaly == "fixed_baseline":
        if reference_period is not None:
            steps.append(f"Daily climatology computed from {reference_period[0]}-{reference_period[1]}")
        else:
            steps.append("Daily climatology computed from full time series")
    elif method_anomaly == "detrend_fixed_baseline":
        steps.append(f"Removed polynomial trend orders={detrend_orders}")
        if reference_period is not None:
            steps.append(f"Daily climatology computed from detrended data ({reference_period[0]}-{reference_period[1]})")
        else:
            steps.append("Daily climatology computed from detrended data")

    if method_extreme == "global_extreme":
        steps.append("Global percentile threshold applied to all days")
    elif method_extreme == "hobday_extreme":
        if window_spatial_hobday is not None:
            steps.append(
                f"Day-of-year thresholds with {window_days_hobday} day window & {window_spatial_hobday} spatial neighbours"
            )
        else:
            steps.append(f"Day-of-year thresholds with {window_days_hobday} day window")
    return steps


def compute_normalised_anomaly(
    da: Any,
    method_anomaly: str = "shifting_baseline",
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    window_year_baseline: int = 15,
    smooth_days_baseline: int = 21,
    std_normalise: bool = False,
    detrend_orders: Optional[List[int]] = None,
    force_zero_mean: bool = True,
    reference_period: Optional[Tuple[int, int]] = None,
    use_temp_checkpoints: bool = False,
    verbose: Optional[bool] = None,
    quiet: Optional[bool] = None,
    donate_input: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> FieldSet:
    """
    Anomalies by the selected method; returns a FieldSet with ``dat_anomaly``
    and ``mask`` (plus ``dat_stn`` and ``STD`` for ``detrend_harmonic``
    with ``std_normalise``).
    """
    if detrend_orders is None:
        detrend_orders = [1]
    if verbose is not None or quiet is not None:
        configure_logging(verbose=verbose, quiet=quiet)
    da = as_field(da)
    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)
    _reject_reference_period(method_anomaly, reference_period)

    if method_anomaly == "detrend_harmonic":
        return _anomaly_detrended(
            da, dimensions, coordinates, std_normalise, detrend_orders, force_zero_mean, True, donate_input, device
        )
    if method_anomaly == "shifting_baseline":
        return _anomaly_shifting_baseline(
            da, dimensions, coordinates, window_year_baseline, smooth_days_baseline, donate_input, device
        )
    if method_anomaly == "fixed_baseline":
        return _anomaly_fixed_baseline(da, dimensions, coordinates, reference_period, donate_input, device)
    if method_anomaly == "detrend_fixed_baseline":
        detrended = _anomaly_detrended(
            da, dimensions, coordinates, False, detrend_orders, force_zero_mean, False, donate_input, device
        )
        # the intermediate detrended field is ours: the climatology step overwrites it
        return _anomaly_fixed_baseline(detrended["dat_anomaly"], dimensions, coordinates, reference_period, True, device)
    raise ConfigurationError(
        f"Unknown anomaly method '{method_anomaly}'",
        details="Invalid method_anomaly parameter",
        suggestions=[
            "Use 'detrend_harmonic' for efficient processing with trend and harmonic removal",
            "Use 'shifting_baseline' for accurate climatology (requires more data)",
            "Use 'fixed_baseline' to remove a single daily climatology across all years",
            "Use 'detrend_fixed_baseline' for trend removal followed by fixed climatology",
        ],
        context={"provided_method": method_anomaly, "valid_methods": _ANOMALY_METHODS},
    )


def _anomaly_shifting_baseline(
    da: Field,
    dimensions: Dict[str, str],
    coordinates: Dict[str, str],
    window_year_baseline: int,
    smooth_days_baseline: int,
    donate: bool,
    device,
) -> FieldSet:
    """Smoothed rolling climatology anomaly (NaN for the first
    ``window_year_baseline`` years)."""
    staged = _Staged(da, dimensions, coordinates, device)
    mask = torch.isfinite(staged.data[0])
    out = staged.flat if (donate or staged.copied) else None
    anomalies = _pipe.shifting_baseline_anomaly(
        staged.flat, staged.tinfo, window_year_baseline, smooth_days_baseline, out=out
    )
    return staged.anomaly_set(anomalies, mask)


def _anomaly_fixed_baseline(
    da: Field,
    dimensions: Dict[str, str],
    coordinates: Dict[str, str],
    reference_period: Optional[Tuple[int, int]],
    donate: bool,
    device,
) -> FieldSet:
    """Fixed daily climatology anomaly."""
    staged = _Staged(da, dimensions, coordinates, device)
    tinfo = staged.tinfo
    if reference_period is not None:
        start_year, end_year = reference_period
        if start_year > end_year:
            raise ConfigurationError(
                f"Invalid reference_period: start year ({start_year}) must be <= end year ({end_year})",
                details="The reference_period tuple must be (start_year, end_year) with start_year <= end_year",
                suggestions=[f"Swap the order: use reference_period=({end_year}, {start_year})"],
            )
        clim_mask = (tinfo.year >= start_year) & (tinfo.year <= end_year)
        if not clim_mask.any():
            y0, y1 = int(tinfo.year.min()), int(tinfo.year.max())
            raise ConfigurationError(
                f"No data found in reference_period ({start_year}, {end_year})",
                details=f"Dataset spans {y0}-{y1} but no timesteps fall within the specified period",
                suggestions=[
                    f"Adjust reference_period to overlap with data range ({y0}-{y1})",
                    "Set reference_period=None to use the full time series",
                ],
            )
    else:
        clim_mask = np.ones(tinfo.n_time, dtype=bool)

    mask = torch.isfinite(staged.data[0])
    # overwrite the staged block only when it is a private copy or the caller donated it
    in_place = donate or staged.copied
    anomalies = _pipe.fixed_baseline_anomaly(
        staged.data, tinfo.dayofyear - 1, clim_mask, out=staged.data if in_place else None
    )
    return staged.anomaly_set(anomalies, mask)


def _anomaly_detrended(
    da: Field,
    dimensions: Dict[str, str],
    coordinates: Dict[str, str],
    std_normalise: bool,
    detrend_orders: List[int],
    force_zero_mean: bool,
    remove_harmonics: bool,
    donate: bool,
    device,
) -> FieldSet:
    """Polynomial (+ harmonic) detrending anomaly, and with ``std_normalise``
    the anomalies over their 30-day rolling day-of-year STD."""
    if not detrend_orders:
        raise ConfigurationError(
            "detrend_orders cannot be empty",
            details="At least one polynomial order must be specified for detrending",
            suggestions=[
                "Use detrend_orders=[1] for linear detrending",
                "Use detrend_orders=[1, 2] for linear + quadratic detrending",
                "Remove detrend_orders optional parameter to use default [1]",
            ],
        )
    if any(order < 1 for order in detrend_orders):
        invalid = [o for o in detrend_orders if o < 1]
        raise ConfigurationError(
            f"Invalid polynomial orders: {invalid}",
            details="Polynomial orders must be positive integers (>= 1)",
            suggestions=[
                "Use only positive integers for polynomial orders",
                "Common values: [1] for linear, [1,2] for linear+quadratic",
                f"Remove invalid orders: {invalid}",
            ],
        )
    if 1 not in detrend_orders and len(detrend_orders) > 1:
        warnings.warn("Higher-order detrending without linear term may be unstable", UserWarning, stacklevel=2)

    staged = _Staged(da, dimensions, coordinates, device)
    mask = torch.isfinite(staged.data[0])
    model, pmodel = _detrend.build_design_matrix(staged.tinfo, detrend_orders, remove_harmonics)
    out = staged.flat if (donate or staged.copied) else None
    anomalies = _pipe.detrended_anomaly(staged.flat, model, pmodel, force_zero_mean, out=out)

    extra: Dict[str, Field] = {}
    if std_normalise:
        std_doy = _clim.dayofyear_std(scatter_to_year_doy(anomalies, staged.tinfo))
        std_rolling = _clim.wrapped_rolling_rms_doy(std_doy, window=30, pad=16)
        del std_doy
        std_safe = torch.where(std_rolling > 1e-10, std_rolling, torch.nan)
        dat_stn = _pipe.doy_op(torch.div, anomalies, std_safe, staged.tinfo.dayofyear - 1, torch.empty_like(anomalies))
        extra["dat_stn"] = staged.time_field(dat_stn, "dat_stn")
        extra["STD"] = staged.doy_field(std_rolling, "STD")
    return staged.anomaly_set(anomalies, mask, extra)


# ===============================================
# Shifting Baseline public helpers
# ===============================================


def rolling_climatology(
    da: Any,
    window_year_baseline: int = 15,
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    use_temp_checkpoints: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Field:
    """
    Rolling climatology: for each timestep, the mean over the same day-of-year
    in the previous ``window_year_baseline`` years. Years without sufficient
    history are NaN.
    """
    da = as_field(da)
    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)
    staged = _Staged(da, dimensions, coordinates, device)
    clim_y = _clim.rolling_climatology_ymd(scatter_to_year_doy(staged.flat, staged.tinfo), window_year_baseline)
    return staged.time_field(gather_from_year_doy(clim_y, staged.tinfo), da.name)


def smoothed_rolling_climatology(
    da: Any,
    window_year_baseline: int = 15,
    smooth_days_baseline: int = 21,
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    use_temp_checkpoints: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Field:
    """
    Rolling climatology of the time-smoothed data (smoothing the raw series
    first is cheaper than smoothing the climatology).
    """
    da = as_field(da)
    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)
    staged = _Staged(da, dimensions, coordinates, device)
    smoothed = _clim.centered_rolling_mean_time(staged.flat, smooth_days_baseline)
    clim_y = _clim.rolling_climatology_ymd(scatter_to_year_doy(smoothed, staged.tinfo), window_year_baseline)
    return staged.time_field(gather_from_year_doy(clim_y, staged.tinfo), da.name)


def add_decimal_year(da: Any, dim: str = "time", coord: Optional[str] = None) -> Field:
    """Attach a ``decimal_year`` coordinate along ``dim``."""
    da = as_field(da)
    coord_name = coord if coord is not None else dim
    dy = decompose_time(da.coords[coord_name].values).decimal_year
    return da.assign_coords(decimal_year=(dim, dy))


# ==========================
# Extreme identification
# ==========================


def identify_extremes(
    da: Any,
    method_extreme: str = "hobday_extreme",
    threshold_percentile: float = 95,
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    window_days_hobday: int = 11,
    window_spatial_hobday: Optional[int] = None,
    method_percentile: str = "approximate",
    precision: float = 0.01,
    max_anomaly: float = 5.0,
    use_temp_checkpoints: bool = False,
    verbose: Optional[bool] = None,
    quiet: Optional[bool] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[Field, Field]:
    """
    Identify extreme events exceeding a percentile threshold; returns
    ``(extremes, thresholds)``: thresholds per point (``global_extreme``) or
    per day of year and point (``hobday_extreme``, with a default spatial
    window of 5 on gridded data and none on a mesh).
    """
    if verbose is not None or quiet is not None:
        configure_logging(verbose=verbose, quiet=quiet)
    da = as_field(da)
    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)

    valid_methods = ["exact", "approximate"]
    if method_percentile not in valid_methods:
        raise ConfigurationError(
            f"Unknown method_percentile '{method_percentile}'",
            details="Invalid method_percentile parameter",
            suggestions=[
                "Use 'exact' for precise percentile computation (memory intensive)",
                "Use 'approximate' for efficient histogram-based computation (default)",
            ],
            context={"provided_method": method_percentile, "valid_methods": valid_methods},
        )
    if method_percentile == "exact":
        if precision != 0.01:
            raise ConfigurationError(
                "Parameter 'precision' cannot be used with method_percentile='exact'",
                details="The precision parameter is only used by the approximate histogram method",
                suggestions=[
                    "Remove the 'precision' parameter when using method_percentile='exact'",
                    "Use method_percentile='approximate' if you want to control histogram precision",
                ],
                context={"method_percentile": method_percentile, "provided_precision": precision},
            )
        if max_anomaly != 5.0:
            raise ConfigurationError(
                "Parameter 'max_anomaly' cannot be used with method_percentile='exact'",
                details="The max_anomaly parameter is only used by the approximate histogram method",
                suggestions=[
                    "Remove the 'max_anomaly' parameter when using method_percentile='exact'",
                    "Use method_percentile='approximate' if you want to control histogram binning range",
                ],
                context={"method_percentile": method_percentile, "provided_max_anomaly": max_anomaly},
            )
    if not 0 < threshold_percentile <= 100:
        raise ConfigurationError(
            f"threshold_percentile must be in (0, 100], got {threshold_percentile}",
            suggestions=["Use a percentile like 90, 95, or 99 for extreme event detection"],
            context={"threshold_percentile": threshold_percentile},
        )
    if threshold_percentile < 60 and method_percentile == "approximate":
        raise ConfigurationError(
            f"Percentile threshold {threshold_percentile}% is not supported with method_percentile='approximate'",
            details="Low percentile thresholds (<60%) produce undefined behaviour with approximate histograms",
            suggestions=[
                "Use method_percentile='exact' for percentiles below 60%",
                "Use a higher percentile threshold (>=60%) with method_percentile='approximate'",
            ],
            context={
                "threshold_percentile": threshold_percentile,
                "method_percentile": method_percentile,
                "min_supported_percentile": 60,
            },
        )
    has_y_dim = "y" in dimensions and dimensions["y"] in da.dims
    if window_spatial_hobday is not None:
        if not has_y_dim:
            raise ConfigurationError(
                "window_spatial_hobday is not supported for unstructured grids",
                details="Spatial smoothing requires structured grids with both x and y dimensions",
                suggestions=[
                    "Remove the window_spatial_hobday parameter for unstructured grids",
                    "Use structured grid data if spatial smoothing is required",
                    "Set window_spatial_hobday=None to use default behavior",
                ],
                context={"grid_type": "unstructured", "window_spatial_hobday": window_spatial_hobday},
            )
        if method_extreme != "hobday_extreme":
            raise ConfigurationError(
                "window_spatial_hobday can only be used with method_extreme='hobday_extreme'",
                details="The window_spatial_hobday parameter is only implemented for the Hobday extreme method",
                suggestions=[
                    "Remove the window_spatial_hobday parameter when using method_extreme='global_extreme'",
                    "Use method_extreme='hobday_extreme' if spatial smoothing is required",
                ],
                context={"method_extreme": method_extreme, "window_spatial_hobday": window_spatial_hobday},
            )
        if method_percentile == "exact":
            raise ConfigurationError(
                "window_spatial_hobday is not supported with method_percentile='exact'",
                details="The window_spatial_hobday parameter is only implemented for the approximate percentile method",
                suggestions=[
                    "Remove the window_spatial_hobday parameter when using method_percentile='exact'",
                    "Use method_percentile='approximate' if spatial smoothing is required",
                ],
                context={"method_percentile": method_percentile, "window_spatial_hobday": window_spatial_hobday},
            )
    if method_extreme == "hobday_extreme":
        if window_days_hobday is not None and window_days_hobday % 2 == 0:
            raise ConfigurationError(
                "window_days_hobday must be an odd number",
                details=f"window_days_hobday={window_days_hobday} is even, which would create asymmetric temporal windows.",
                suggestions=[f"Use window_days_hobday={window_days_hobday + 1} or {window_days_hobday - 1}", "Choose an odd number"],
                context={"window_days_hobday": window_days_hobday, "is_odd": False},
            )
        if window_spatial_hobday is None and has_y_dim:  # gridded data: the default 5 x 5 neighbourhood
            window_spatial_hobday = 5
        if window_spatial_hobday is not None and window_spatial_hobday % 2 == 0:
            raise ConfigurationError(
                "window_spatial_hobday must be an odd number",
                details=f"window_spatial_hobday={window_spatial_hobday} is even, which would create asymmetric spatial windows.",
                suggestions=["Choose an odd number."],
                context={"window_spatial_hobday": window_spatial_hobday, "is_odd": False},
            )

    exact = method_percentile == "exact"
    if method_extreme == "global_extreme":
        return _identify_extremes_constant(
            da, threshold_percentile, exact, dimensions, coordinates, precision, max_anomaly, device
        )
    if method_extreme == "hobday_extreme":
        return _identify_extremes_hobday(
            da, threshold_percentile, window_days_hobday, window_spatial_hobday, exact, dimensions, coordinates,
            precision, max_anomaly, device,
        )
    raise ConfigurationError(
        f"Unknown extreme method '{method_extreme}'",
        details="Invalid method_extreme parameter",
        suggestions=[
            "Use 'global_extreme' for efficient constant percentile threshold",
            "Use 'hobday_extreme' for day-of-year specific thresholds",
        ],
        context={"provided_method": method_extreme, "valid_methods": ["global_extreme", "hobday_extreme"]},
    )


def _warn_threshold_bounds(pre_min: float, pre_max: float, bin_edges: np.ndarray, max_anomaly: float) -> None:
    """Warn on out-of-range thresholds (the clamp itself happens on device)."""
    upper_bound = float(bin_edges[-2])
    lower_bound = float(bin_edges[3])
    if np.isfinite(pre_max) and pre_max > upper_bound:
        warnings.warn(
            f"Quantile values exceed expected range: max={pre_max:.4f} > {upper_bound:.4f}. "
            f"Consider increasing max_anomaly parameter (currently {max_anomaly:.2f}) or using a lower percentile threshold.",
            UserWarning,
            stacklevel=2,
        )
    if np.isfinite(pre_min) and pre_min < lower_bound:
        warnings.warn(
            f"Quantile values below expected range in some locations: min={pre_min:.4f} < {lower_bound:.4f}. "
            "This is likely due to a constant anomaly in certain regions (e.g. due to sea ice). "
            "Double check the computed threshold values are correct.",
            UserWarning,
            stacklevel=2,
        )


def _bins(precision: float, max_anomaly: float, device) -> Tuple[np.ndarray, int, torch.Tensor]:
    """Bin edges, bin count and bin centres (on ``device``)."""
    bin_edges = _quant.make_bin_edges(precision, max_anomaly)
    centers = torch.from_numpy(_quant.make_bin_centers(bin_edges)).to(device)
    return bin_edges, len(bin_edges) - 1, centers


def _identify_extremes_hobday(
    da: Field,
    threshold_percentile: float,
    window_days_hobday: int,
    window_spatial_hobday: Optional[int],
    exact: bool,
    dimensions: Dict[str, str],
    coordinates: Dict[str, str],
    precision: float,
    max_anomaly: float,
    device,
) -> Tuple[Field, Field]:
    """Day-of-year thresholds and the comparison."""
    staged = _Staged(da, dimensions, coordinates, device)
    q = threshold_percentile / 100.0
    n_years = len(np.unique(staged.tinfo.year))
    n_samples = n_years * window_days_hobday * (window_spatial_hobday if window_spatial_hobday is not None else 1) ** 2
    n_above = n_samples * (1.0 - q)
    if n_above < 50:
        logger.warning(
            f"Not enough samples for accurate extreme detection: {n_above} < 50. "
            "Consider using a lower threshold_percentile, increasing your time-series size, "
            "increasing the window_days_hobday, or using a larger window_spatial_hobday."
        )

    bin_edges, nbins, centers = _bins(precision, max_anomaly, staged.data.device)
    anomalies, grid, halo = staged.flat, staged.spatial_shape if staged.is_gridded else None, (0, 0)
    if _BAND is not None and grid is not None and not exact:
        # the spatial window of a band's edge rows reaches into the next bands
        ext, lo, hi = _BAND.row_halo(staged.data, _quant._halo(window_spatial_hobday))
        anomalies, grid, halo = ext.view(ext.shape[0], -1), tuple(ext.shape[1:]), (lo, hi)
    extremes, thr, pre_min, pre_max = _pipe.hobday_program(
        anomalies, staged.tinfo, q, precision, centers, float(bin_edges[3]), nbins, window_days_hobday,
        window_spatial_hobday, grid, True, exact, halo_rows=halo,
    )
    if _BAND is not None:
        pre_min, pre_max = _BAND.nan_range(pre_min, pre_max)
    if not exact:
        _warn_threshold_bounds(pre_min, pre_max, bin_edges, max_anomaly)
    return staged.time_field(extremes, "extreme_events"), staged.doy_field(thr, "thresholds")


def _identify_extremes_constant(
    da: Field,
    threshold_percentile: float,
    exact: bool,
    dimensions: Dict[str, str],
    coordinates: Dict[str, str],
    precision: float,
    max_anomaly: float,
    device,
) -> Tuple[Field, Field]:
    """Global-in-time threshold per spatial point."""
    staged = _Staged(da, dimensions, coordinates, device)
    bin_edges, nbins, centers = _bins(precision, max_anomaly, staged.data.device)
    extremes, thr, pre_min, pre_max = _pipe.global_extreme_program(
        staged.data, threshold_percentile / 100.0, precision, centers, float(bin_edges[3]), nbins, exact
    )
    if _BAND is not None:
        pre_min, pre_max = _BAND.nan_range(pre_min, pre_max)
    if not exact:
        _warn_threshold_bounds(pre_min, pre_max, bin_edges, max_anomaly)
    return (
        staged.time_field(extremes, "extreme_events"),
        Field(thr, staged.spatial_dims, staged.spatial_coords(), name="thresholds"),
    )
