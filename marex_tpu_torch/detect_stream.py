"""
Streamed detect: preprocessing of a field larger than device (or host)
memory.

The port of ``marex_tpu/detect_stream.py``. The input (a zarr store opened
lazily, a FieldSet or a Field) is read in latitude-row tiles (cell ranges
on a mesh), each tile carrying the Hobday spatial window's halo rows (NaN
beyond the domain, which bins to the sentinel: exactly the padding the
Hobday histogram gives itself at the poles, ``ops/quantile.hobday_tiles``).
Each tile goes through this package's own ``compute_normalised_anomaly`` and
``identify_extremes`` on the device, and its interior rows are
region-written to a chunked zarr store, so memory is bounded by the tile.

On a CUDA device a tile is filled on the host in a pinned buffer by a
background thread and uploaded on a copy stream, so that tile i+1's read
and upload overlap tile i's compute; the outputs are compressed and written
by background threads (``zarr_lite.RegionWriter``).

Every reduction of the climatology methods and of both percentile paths is
over time at one point, and the spatial window sees the same neighbours in
a tile as in the whole field, so the streamed outputs equal
:func:`~marex_tpu_torch.detect.preprocess_data`'s bit for bit; the detrended
methods' float64 fits agree to round-off.
"""

from __future__ import annotations

import logging
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import detect as _detect
from .core.field import Coord, Field, FieldSet
from .core.timeaxis import decompose_time
from .exceptions import ConfigurationError, create_data_validation_error
from .io import zarr_lite
from .logging_config import get_logger, log_timing

logger = get_logger(__name__)

# the device pipeline holds about six copies of a (T, rows, nx) float32 tile
# (payload, the (years, 366, S) scatter, anomalies, bins, extremes and
# thresholds, slack); the Hobday histogram has its own tile budget
# (``ops/quantile._HIST_TILE_BYTES``)
_TILE_COPIES = 6


def _resolve_input(data: Any, var: Optional[str]) -> Field:
    """Accept a zarr path (opened lazily), FieldSet, or Field."""
    if isinstance(data, str):
        if not os.path.isdir(data):
            raise create_data_validation_error(
                f"Not a zarr store: {data}",
                suggestions=["Pass a path to a directory-style zarr v2 store, a Field, or a FieldSet"],
            )
        data = zarr_lite.open_zarr(data, lazy=True)
    if isinstance(data, FieldSet):
        if var is None:
            big = [n for n, f in data.data_vars.items() if f.ndim >= 2]
            if len(big) != 1:
                raise ConfigurationError(
                    "Cannot infer the data variable for streamed preprocessing",
                    details=f"Store has {len(big)} multi-dimensional variables: {big}",
                    suggestions=["Pass var='<name>' to select the variable to process"],
                )
            var = big[0]
        return data.data_vars[var]
    if isinstance(data, Field):
        return data
    raise create_data_validation_error(
        f"Unsupported input type for streamed preprocessing: {type(data)!r}",
        suggestions=["Pass a zarr store path, a marex_tpu_torch FieldSet, or a Field"],
    )


def _auto_row_block(T: int, ny: int, nx: int, memory_budget_mb: int) -> int:
    """Tile height from the working-set budget: ``_TILE_COPIES`` copies of
    the (T, rows, nx) float32 tile."""
    budget = memory_budget_mb * 2**20
    rows = max(1, budget // (T * nx * 4 * _TILE_COPIES))
    return int(min(rows, ny))


class _TileSource:
    """
    Tiles of the input on the device, one read ahead: a background thread
    fills a host buffer (pinned on CUDA, two in turn) with the tile's rows
    and its NaN padding, and on CUDA uploads it on a copy stream into a new
    device tensor. :meth:`get` waits for tile i, makes the compute stream
    wait for its upload, and starts tile i+1.
    """

    def __init__(self, payload: Any, spans: List[Tuple[int, int, int]], shape: Tuple[int, ...], device: torch.device):
        self.payload, self.spans, self.shape, self.device = payload, spans, shape, device
        self.cuda = device.type == "cuda"
        pin = self.cuda
        self.host = [torch.empty(shape, dtype=torch.float32, pin_memory=pin) for _ in range(2 if self.cuda else 1)]
        self.copied: List[Optional[torch.cuda.Event]] = [None] * len(self.host)
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.read_s = 0.0
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tile-reader")
        self._next = self._pool.submit(self._load, 0) if spans else None

    def _load(self, i: int):
        """Tile i: (device tensor, its upload's event or None, all-NaN first slice)."""
        t0 = time.perf_counter()
        c0, c1, off = self.spans[i]
        j = i % len(self.host)
        if self.copied[j] is not None:  # the buffer's previous upload must be done
            self.copied[j].synchronize()
        buf = self.host[j].numpy()
        buf.fill(np.nan)
        rows = self.payload[:, c0:c1]
        buf[:, off : off + (c1 - c0)] = rows.cpu().numpy() if isinstance(rows, torch.Tensor) else rows
        land = not np.isfinite(buf[0]).any()
        if not self.cuda:
            tile, event = torch.from_numpy(buf.copy()), None
        else:
            with torch.cuda.stream(self.stream):
                tile = torch.empty(self.shape, dtype=torch.float32, device=self.device)
                tile.copy_(self.host[j], non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.stream)
            self.copied[j] = event
        self.read_s += time.perf_counter() - t0
        return tile, event, land

    def get(self, i: int):
        tile, event, land = self._next.result()
        self._next = self._pool.submit(self._load, i + 1) if i + 1 < len(self.spans) else None
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
            tile.record_stream(torch.cuda.current_stream(self.device))
        return tile, land

    def close(self) -> None:
        self._pool.shutdown(wait=True)


def preprocess_data_streamed(
    data: Any,
    out_path: str,
    var: Optional[str] = None,
    row_block: Optional[int] = None,
    memory_budget_mb: int = 1024,
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
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    neighbours: Optional[Any] = None,
    cell_areas: Optional[Any] = None,
    compressor: Optional[str] = "zlib",
    device: Union[str, torch.device] = "cuda",
    timings: Optional[Dict[str, float]] = None,
) -> FieldSet:
    """
    Streamed :func:`~marex_tpu_torch.detect.preprocess_data`: the same
    parameters and numerics, but the input is read in latitude-row tiles
    (cell-range tiles on a mesh) and the outputs are region-written to
    ``out_path`` as they are produced.

    Parameters beyond :func:`preprocess_data`:

    data : zarr store path (opened lazily), FieldSet, or Field (time-major)
    out_path : output zarr store (created/overwritten)
    var : data variable name when ``data`` is a store with several
    row_block : tile height in grid rows (cells when unstructured); default
        sized so the tile working set fits ``memory_budget_mb``
    compressor : 'zlib' (default) or None (raw chunks, fastest)
    device : where the tiles are processed (default ``"cuda"``)
    timings : if given, filled with the wall seconds of reading tiles (in
        the reader thread), of waiting for them, of device work, and of
        copying results back and handing them to the writers

    Returns the output store opened lazily (a FieldSet of lazy zarr arrays).
    """
    if detrend_orders is None:
        detrend_orders = [1]
    device = torch.device(device)

    da = _resolve_input(data, var)
    dimensions, coordinates = _detect._infer_dims_coords(da, dimensions, coordinates)
    timedim = dimensions["time"]
    xdim = dimensions["x"]
    ydim = dimensions.get("y")
    is_gridded = ydim is not None and ydim in da.dims

    order = (timedim, ydim, xdim) if is_gridded else (timedim, xdim)
    if tuple(da.dims) != order:
        raise create_data_validation_error(
            "Streamed preprocessing requires time-major input layout",
            details=f"Expected dimension order {order}, found {tuple(da.dims)}",
            suggestions=[
                "Store the input with dimensions ordered (time, y, x) / (time, cell)",
                "Use marEx.preprocess_data for in-memory data in any order",
            ],
        )

    payload = da.data
    T = int(payload.shape[0])
    if is_gridded:
        ny, nx = int(payload.shape[1]), int(payload.shape[2])
    else:
        ny, nx = int(payload.shape[1]), 1  # cells tile like rows with nx=1

    # ---- the Hobday spatial window and its halo ----------------------------
    eff_spatial = window_spatial_hobday
    if method_extreme == "hobday_extreme" and eff_spatial is None and is_gridded and method_percentile != "exact":
        eff_spatial = 5  # identify_extremes' default on a grid
    halo = (eff_spatial // 2) if (is_gridded and eff_spatial is not None and eff_spatial > 1) else 0

    if row_block is None:
        row_block = _auto_row_block(T, ny, nx, memory_budget_mb)
    row_block = int(max(1, min(row_block, ny)))
    n_tiles = -(-ny // row_block)

    logger.info(
        f"Streamed preprocessing: {n_tiles} tiles of {row_block} rows (+{halo} halo) over "
        f"({T}, {ny}{', ' + str(nx) if is_gridded else ''}) - {method_anomaly} -> {method_extreme}"
    )

    # ---- time handling (trim for shifting_baseline) ------------------------
    time_vals = np.asarray(da.coords[coordinates["time"]].values)
    tinfo = decompose_time(time_vals)
    if method_anomaly == "shifting_baseline":
        total_years = int(tinfo.year.max() - tinfo.year.min() + 1)
        if total_years < window_year_baseline:
            raise create_data_validation_error(
                "Insufficient data for shifting_baseline method",
                details=f"Dataset spans {total_years} years but requires at least {window_year_baseline} years",
                suggestions=[
                    "Use more years of data to meet minimum requirement",
                    f"Reduce window_year_baseline parameter (currently {window_year_baseline})",
                ],
                data_info={"available_years": total_years, "required_years": int(window_year_baseline)},
            )
        start_year = int(tinfo.year.min() + window_year_baseline)
        keep_t = np.nonzero(tinfo.year >= start_year)[0]
        if keep_t.size == 0:
            # the equality case (total_years == window) would leave an empty store
            raise create_data_validation_error(
                "Insufficient data for shifting_baseline method",
                details=(
                    f"Removing the first {window_year_baseline} baseline years "
                    f"leaves no timesteps (dataset spans {total_years} years)"
                ),
                suggestions=[
                    "Use more years of data (at least window_year_baseline + 1)",
                    f"Reduce window_year_baseline parameter (currently {window_year_baseline})",
                ],
                data_info={"available_years": total_years, "required_years": int(window_year_baseline) + 1},
            )
    else:
        keep_t = np.arange(T)
    T_out = int(len(keep_t))
    time_out = time_vals[keep_t]

    _detect._reject_reference_period(method_anomaly, reference_period)

    # ---- the output store's layout ------------------------------------------
    sdims = (ydim, xdim) if is_gridded else (xdim,)
    sshape = (ny, nx) if is_gridded else (ny,)
    t_chunk = int(min(T_out, 366))

    def _schunks(lead: Tuple[int, ...]) -> Tuple[int, ...]:
        return lead + ((row_block, nx) if is_gridded else (row_block,))

    thr_has_doy = method_extreme == "hobday_extreme"
    thr_dims = (("dayofyear",) + sdims) if thr_has_doy else sdims
    thr_shape = ((366,) + sshape) if thr_has_doy else sshape
    thr_chunks = _schunks((366,)) if thr_has_doy else _schunks(())
    want_stn = std_normalise and method_anomaly == "detrend_harmonic"
    layout = {
        "dat_anomaly": ((T_out,) + sshape, np.float32, (timedim,) + sdims, _schunks((t_chunk,))),
        "extreme_events": ((T_out,) + sshape, bool, (timedim,) + sdims, _schunks((t_chunk,))),
        "mask": (sshape, bool, sdims, _schunks(())),
        "thresholds": (thr_shape, np.float32, thr_dims, thr_chunks),
    }
    if want_stn:
        layout.update({
            "dat_stn": ((T_out,) + sshape, np.float32, (timedim,) + sdims, _schunks((t_chunk,))),
            "STD": ((366,) + sshape, np.float32, ("dayofyear",) + sdims, _schunks((366,))),
            "extreme_events_stn": ((T_out,) + sshape, bool, (timedim,) + sdims, _schunks((t_chunk,))),
            "thresholds_stn": (thr_shape, np.float32, thr_dims, thr_chunks),
        })
    zarr_lite.create_group(out_path, mode="w")
    for name, (shape, dtype, dims, chunks) in layout.items():
        zarr_lite.create_array(out_path, name, shape, dtype, dims, chunks, compressor=compressor)

    # coords (eager, small)
    zarr_lite._write_array(out_path, coordinates["time"], time_out, (timedim,), {})
    for cname, coord in da.coords.items():
        if cname != coordinates["time"] and set(coord.dims) <= set(sdims):
            zarr_lite._write_array(out_path, cname, np.asarray(coord.values), tuple(coord.dims), {})
    if thr_has_doy:
        zarr_lite._write_array(out_path, "dayofyear", np.arange(1, 367), ("dayofyear",), {})
    if neighbours is not None:
        nb = neighbours if isinstance(neighbours, Field) else Field(np.asarray(neighbours), ("nv", xdim))
        zarr_lite._write_array(out_path, "neighbours", np.asarray(nb.values, np.int32), tuple(nb.dims), {})
    if cell_areas is not None:
        ca = cell_areas if isinstance(cell_areas, Field) else Field(np.asarray(cell_areas), sdims)
        zarr_lite._write_array(out_path, "cell_areas", np.asarray(ca.values, np.float32), tuple(ca.dims), {})

    # lat coords of a padded tile (the values do not feed the numerics; only
    # the time coord does)
    ycoord = coordinates.get("y")
    lat_vals = (
        np.asarray(da.coords[ycoord].values, np.float64)
        if is_gridded and ycoord in da.coords and da.coords[ycoord].dims == (ydim,)
        else np.arange(ny, dtype=np.float64)
    )

    rows_tile = row_block + 2 * halo
    spans = []  # (first row read, end row read, where they land in the tile)
    for ti in range(n_tiles):
        r0 = ti * row_block
        c0, c1 = max(0, r0 - halo), min(ny, r0 + row_block + halo)
        spans.append((c0, c1, c0 - (r0 - halo)))
    tile_shape = (T, rows_tile, nx) if is_gridded else (T, rows_tile)
    source = _TileSource(payload, spans, tile_shape, device)

    seen_warnings: set = set()
    detect_logger = _detect.logger
    walls = {"read": 0.0, "wait_read": 0.0, "compute": 0.0, "write": 0.0}

    def _sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    writer = zarr_lite.RegionWriter()
    try:
        for ti in range(n_tiles):
            r0 = ti * row_block
            r1 = min(r0 + row_block, ny)
            n_rows = r1 - r0
            starts_s = (r0, 0) if is_gridded else (r0,)
            with log_timing(logger, f"Streamed tile {ti + 1}/{n_tiles} rows [{r0}:{r1})"):
                t0 = time.perf_counter()
                tile, land = source.get(ti)
                walls["wait_read"] += time.perf_counter() - t0

                if land:
                    # all land (or padding): the whole-field path gives NaN
                    # anomalies and thresholds and False extremes here
                    sh_t = (T_out, n_rows, nx) if is_gridded else (T_out, n_rows)
                    sh_s = sh_t[1:]
                    t0 = time.perf_counter()
                    for name, (shape, dtype, _, _) in layout.items():
                        lead = len(shape) - len(sshape)
                        block_shape = shape[:lead] + sh_s
                        fill = np.nan if np.dtype(dtype).kind == "f" else False
                        writer.write(out_path, name, (0,) * lead + starts_s, np.full(block_shape, fill, dtype))
                    walls["write"] += time.perf_counter() - t0
                    del tile
                    continue

                t0 = time.perf_counter()
                if is_gridded:
                    tile_lat = np.arange(r0 - halo, r0 - halo + rows_tile, dtype=np.float64)
                    inb = (tile_lat >= 0) & (tile_lat < ny)
                    lat_pad = np.interp(tile_lat, np.arange(ny), lat_vals)  # clamped beyond the ends
                    lat_pad[inb] = lat_vals[tile_lat[inb].astype(int)]
                    tile_coords: Dict[str, Any] = {
                        coordinates["time"]: Coord(timedim, time_vals),
                        coordinates.get("y", "lat"): Coord(ydim, lat_pad),
                    }
                    if coordinates.get("x") in da.coords and da.coords[coordinates["x"]].dims == (xdim,):
                        tile_coords[coordinates["x"]] = Coord(xdim, np.asarray(da.coords[coordinates["x"]].values))
                    tile_field = Field(tile, (timedim, ydim, xdim), tile_coords, name=da.name)
                else:
                    c0, c1, _ = spans[ti]
                    tile_coords = {coordinates["time"]: Coord(timedim, time_vals)}
                    for ck in ("x", "y"):
                        cname = coordinates.get(ck)
                        if cname and cname in da.coords and da.coords[cname].dims == (xdim,):
                            cv = np.zeros(rows_tile, np.float32)
                            cv[: (c1 - c0)] = np.asarray(da.coords[cname].values)[c0:c1]
                            tile_coords[cname] = Coord(xdim, cv)
                    tile_field = Field(tile, (timedim, xdim), tile_coords, name=da.name)

                _detect._validate_data_values(tile)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    prev_level = detect_logger.level
                    if ti > 0:
                        detect_logger.setLevel(logging.ERROR)  # the same parameter warnings every tile
                    try:
                        ds_tile = _detect.compute_normalised_anomaly(
                            tile_field, method_anomaly, dimensions, coordinates, window_year_baseline,
                            smooth_days_baseline, std_normalise, detrend_orders, force_zero_mean, reference_period,
                            donate_input=True, device=device,
                        )
                        del tile_field, tile
                        if T_out != T:
                            ds_tile = ds_tile.isel({timedim: keep_t})
                        outputs = {"dat_anomaly": ds_tile["dat_anomaly"], "mask": ds_tile["mask"]}
                        pairs = [("dat_anomaly", "extreme_events", "thresholds")]
                        if want_stn:
                            outputs.update({"dat_stn": ds_tile["dat_stn"], "STD": ds_tile["STD"]})
                            pairs.append(("dat_stn", "extreme_events_stn", "thresholds_stn"))
                        for src, ext, thr in pairs:
                            outputs[ext], outputs[thr] = _detect.identify_extremes(
                                outputs[src], method_extreme, threshold_percentile, dimensions, coordinates,
                                window_days_hobday, window_spatial_hobday, method_percentile, precision,
                                max_anomaly, device=device,
                            )
                        del ds_tile
                    finally:
                        detect_logger.setLevel(prev_level)
                for w in caught:
                    key = (w.category, str(w.message))
                    if key not in seen_warnings:
                        seen_warnings.add(key)
                        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
                _sync()
                walls["compute"] += time.perf_counter() - t0

                # ---- region-write the interior rows -------------------------
                t0 = time.perf_counter()
                for name, (shape, _, _, _) in layout.items():
                    lead = len(shape) - len(sshape)
                    rows = outputs[name].data.narrow(lead, halo, n_rows)
                    writer.write(out_path, name, (0,) * lead + starts_s, rows)
                del outputs
                walls["write"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        writer.flush()
        walls["write"] += time.perf_counter() - t0
    finally:
        source.close()
        writer.close()
    walls["read"] = source.read_s
    if timings is not None:
        timings.update(walls)

    # ---- group attrs (the provenance of preprocess_data) --------------------
    attrs: Dict[str, Any] = {
        "method_anomaly": method_anomaly,
        "method_extreme": method_extreme,
        "threshold_percentile": threshold_percentile,
        "method_percentile": method_percentile,
        "precision": precision,
        "max_anomaly": max_anomaly,
        "preprocessing_steps": _detect._get_preprocessing_steps(
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
        "streamed": 1,
        "stream_row_block": row_block,
        "stream_n_tiles": n_tiles,
    }
    if method_anomaly == "detrend_harmonic":
        attrs.update({"detrend_orders": detrend_orders, "force_zero_mean": force_zero_mean, "std_normalise": std_normalise})
    elif method_anomaly == "shifting_baseline":
        attrs.update({"window_year_baseline": window_year_baseline, "smooth_days_baseline": smooth_days_baseline})
    elif method_anomaly in ("fixed_baseline", "detrend_fixed_baseline"):
        if method_anomaly == "detrend_fixed_baseline":
            attrs.update({"detrend_orders": detrend_orders, "force_zero_mean": force_zero_mean})
        if reference_period is not None:
            attrs["reference_period"] = list(reference_period)
    if method_extreme == "hobday_extreme":
        attrs["window_days_hobday"] = window_days_hobday
    zarr_lite.create_group(out_path, attrs, mode="a")

    logger.info(f"Streamed preprocessing complete: {n_tiles} tiles -> {out_path}")
    return zarr_lite.open_zarr(out_path, lazy=True)
