"""
MarEx detect on PyTorch: anomalies and extreme-event identification.

The port of ``marex_tpu/detect.py`` for the main path: the
``fixed_baseline`` anomaly and the approximate ``global_extreme`` threshold,
with the reference's validation and output contract (``dat_anomaly``,
``mask``, ``extreme_events``, ``thresholds`` and provenance attrs). Other
methods raise ``NotImplementedError`` naming the ROADMAP item that brings
them.

Device placement is explicit: a torch tensor input keeps its device; numpy
or ``Field`` payloads move to ``device`` (default ``"cuda"``). Nothing falls
back to the CPU on its own.
"""

from __future__ import annotations

import logging
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .core.field import Coord, Field, FieldSet, as_field, on_device
from .core.timeaxis import TimeIndexInfo, decompose_time
from .exceptions import ConfigurationError, create_data_validation_error
from .logging_config import configure_logging, get_logger, log_array_info, log_memory_usage, log_timing
from .ops import pipeline as _pipe
from .ops import quantile as _quant

logger = get_logger(__name__)

_ANOMALY_METHODS = ["detrend_harmonic", "shifting_baseline", "fixed_baseline", "detrend_fixed_baseline"]
_NOT_PORTED = {
    "shifting_baseline": "ROADMAP queue 1, item 6 (reference-default detect)",
    "detrend_harmonic": "ROADMAP queue 1, item 7 (detrend methods and std_normalise)",
    "detrend_fixed_baseline": "ROADMAP queue 1, item 7 (detrend methods and std_normalise)",
    "hobday_extreme": "ROADMAP queue 1, item 6 (reference-default detect)",
    "exact": "ROADMAP queue 1, item 2 (detect: the exact percentile path)",
    "std_normalise": "ROADMAP queue 1, item 7 (detrend methods and std_normalise)",
    "mesh": "ROADMAP queue 1, item 11 (multi-GPU)",
    "unstructured": "ROADMAP queue 1, item 9 (unstructured meshes)",
}


def _not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to marex_tpu_torch yet: {_NOT_PORTED[key]}")


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
    validate. Only gridded data (with a 'y' dimension) is ported."""
    if dimensions is None:
        dimensions = {"time": "time", "x": "lon", "y": "lat"}
    if "time" not in dimensions:
        dimensions = {"time": "time", **dimensions}
    if "y" not in dimensions:
        raise _not_ported("Unstructured (2-D) data", "unstructured")
    if coordinates is None:
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
    ``data`` is (T, *spatial); the statistics are reduced on its device.
    """
    finite = torch.isfinite(data)
    spatial_mask = finite[0]
    invalid_in_valid = torch.where(spatial_mask, (~finite).sum(dim=0, dtype=torch.int32), 0)
    del finite
    if not bool(spatial_mask.any()):
        raise create_data_validation_error(
            "Dataset contains no valid (finite) data",
            details="All values in the first time step are NaN or infinite",
            suggestions=[
                "Check your input data for data quality issues",
                "Verify the data was loaded correctly",
            ],
            data_info={"total_values": int(data.numel())},
        )
    max_invalid = int(invalid_in_valid.max())
    if max_invalid > 0:
        total_invalid = int(invalid_in_valid.sum())
        locations_affected = int((invalid_in_valid > 0).sum())
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
                "total_ocean_locations": int(spatial_mask.sum()),
                "max_invalid_at_one_location": max_invalid,
                "total_time_steps": int(data.shape[0]),
            },
        )


# ============================
# Internal staging
# ============================


class _Staged:
    """The input as a (T, H, W) float32 tensor on its device, with the
    calendar decomposition of its time coordinate."""

    def __init__(self, da: Field, dimensions: Dict[str, str], coordinates: Dict[str, str], device):
        self.timedim = dimensions["time"]
        self.spatial_dims = (dimensions["y"], dimensions["x"])
        payload = da.data
        da = da.transpose(self.timedim, *self.spatial_dims)
        self.field = da
        self.spatial_shape = tuple(da.sizes[d] for d in self.spatial_dims)
        self.data = on_device(da.data, device).to(torch.float32).contiguous()
        #: True when ``data`` is a private copy, not the caller's tensor
        self.copied = not (isinstance(payload, torch.Tensor) and self.data.data_ptr() == payload.data_ptr())
        self.tinfo: TimeIndexInfo = decompose_time(da.coords[coordinates["time"]].values)

    def spatial_coords(self) -> Dict[str, Coord]:
        return {name: c for name, c in self.field.coords.items() if set(c.dims) <= set(self.spatial_dims)}


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

    Ported: ``method_anomaly='fixed_baseline'`` with
    ``method_extreme='global_extreme'`` and ``method_percentile='approximate'``.
    ``dask_chunks`` and ``use_temp_checkpoints`` are accepted and ignored.
    With ``donate_input=True`` a float32 tensor input may be overwritten in
    place by the anomalies (saving one field-sized buffer).

    Returns a FieldSet with ``dat_anomaly``, ``mask``, ``extreme_events`` and
    ``thresholds`` (tensors on the input's device) and provenance attrs.
    """
    if mesh is not None:
        raise _not_ported("mesh", "mesh")
    if method_anomaly in _NOT_PORTED:
        raise _not_ported(f"method_anomaly='{method_anomaly}'", method_anomaly)
    if method_extreme in _NOT_PORTED:
        raise _not_ported(f"method_extreme='{method_extreme}'", method_extreme)
    if std_normalise:
        raise _not_ported("std_normalise", "std_normalise")
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

    # stage the payload on its device once; a copy made here is ours to overwrite
    if not isinstance(da.data, torch.Tensor):
        da = Field(on_device(np.asarray(da.data, dtype=np.float32), device), da.dims, da.coords, da.name, da.attrs)
        donate_input = True
    _validate_data_values(da.data.movedim(da.dims.index(dimensions["time"]), 0))

    with log_timing(logger, f"Anomaly computation using {method_anomaly} method", log_memory=True):
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

    with log_timing(logger, f"Extreme event identification using {method_extreme} method", log_memory=True):
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

    if neighbours is not None:
        nb = as_field(neighbours)
        ds["neighbours"] = nb.astype(np.int32)
        if "nv" in nb.dims:
            ds.coords.setdefault("nv", Coord("nv", np.arange(nb.sizes["nv"])))
    if cell_areas is not None:
        ds["cell_areas"] = as_field(cell_areas).astype(np.float32)

    steps = (
        [f"Daily climatology computed from {reference_period[0]}-{reference_period[1]}"]
        if reference_period is not None
        else ["Daily climatology computed from full time series"]
    )
    steps.append("Global percentile threshold applied to all days")
    ds.attrs.update(
        {
            "method_anomaly": method_anomaly,
            "method_extreme": method_extreme,
            "threshold_percentile": threshold_percentile,
            "preprocessing_steps": steps,
        }
    )
    if reference_period is not None:
        ds.attrs["reference_period"] = list(reference_period)
    ds.attrs.update({"method_percentile": method_percentile, "precision": precision, "max_anomaly": max_anomaly})

    n_extremes = int(ds["extreme_events"].data.sum(dim=(1, 2), dtype=torch.int32).sum())
    logger.info(f"Preprocessing completed successfully - {n_extremes} extreme events identified")
    return ds


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
    and ``mask``. Ported: ``fixed_baseline`` (with ``reference_period``).
    """
    if verbose is not None or quiet is not None:
        configure_logging(verbose=verbose, quiet=quiet)
    da = as_field(da)
    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)

    if reference_period is not None and method_anomaly not in ("fixed_baseline", "detrend_fixed_baseline"):
        raise ConfigurationError(
            f"reference_period is not supported for method_anomaly='{method_anomaly}'",
            details="reference_period is only applicable to 'fixed_baseline' and 'detrend_fixed_baseline' methods",
            suggestions=[
                "Remove the reference_period parameter, or",
                "Use method_anomaly='fixed_baseline' or 'detrend_fixed_baseline'",
            ],
        )
    if method_anomaly == "fixed_baseline":
        return _anomaly_fixed_baseline(da, dimensions, coordinates, reference_period, donate_input, device)
    if method_anomaly in _NOT_PORTED:
        raise _not_ported(f"method_anomaly='{method_anomaly}'", method_anomaly)
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
    dims = (staged.timedim,) + staged.spatial_dims
    anom = Field(anomalies, dims, dict(staged.field.coords), name="dat_anomaly")
    mask_f = Field(mask, staged.spatial_dims, staged.spatial_coords(), name="mask")
    return FieldSet({"dat_anomaly": anom, "mask": mask_f}, dict(staged.field.coords))


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
    ``(extremes, thresholds)``. Ported: ``global_extreme`` with
    ``method_percentile='approximate'``.
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
    if method_extreme == "global_extreme":
        if window_spatial_hobday is not None:
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
            raise _not_ported("method_percentile='exact'", "exact")
        return _identify_extremes_constant(da, threshold_percentile, dimensions, coordinates, precision, max_anomaly, device)
    if method_extreme in _NOT_PORTED:
        raise _not_ported(f"method_extreme='{method_extreme}'", method_extreme)
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


def _identify_extremes_constant(
    da: Field,
    threshold_percentile: float,
    dimensions: Dict[str, str],
    coordinates: Dict[str, str],
    precision: float,
    max_anomaly: float,
    device,
) -> Tuple[Field, Field]:
    """Global-in-time threshold per spatial point."""
    staged = _Staged(da, dimensions, coordinates, device)
    bin_edges = _quant.make_bin_edges(precision, max_anomaly)
    nbins = len(bin_edges) - 1
    centers = torch.from_numpy(_quant.make_bin_centers(bin_edges)).to(staged.data.device)
    extremes, thr, pre_min, pre_max = _pipe.global_extreme_program(
        staged.data, threshold_percentile / 100.0, precision, centers, float(bin_edges[3]), nbins
    )
    _warn_threshold_bounds(pre_min, pre_max, bin_edges, max_anomaly)
    dims = (staged.timedim,) + staged.spatial_dims
    return (
        Field(extremes, dims, staged.field.coords, name="extreme_events"),
        Field(thr, staged.spatial_dims, staged.spatial_coords(), name="thresholds"),
    )
