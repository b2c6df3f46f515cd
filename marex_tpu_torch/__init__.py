"""
MarEx on PyTorch: marine extremes detection and tracking on an NVIDIA GPU
==========================================================================

The PyTorch port of ``marex_tpu``, with the same public entry points:

>>> import marex_tpu_torch as marEx
>>> ds = marEx.preprocess_data(sst, window_year_baseline=2, device="cuda")
>>> events, merges = marEx.tracker(ds.extreme_events, ds.mask, R_fill=12, T_fill=4,
...                                area_filter_absolute=600, grid_resolution=0.25,
...                                allow_merging=True, nn_partitioning=True,
...                                overlap_threshold=0.25).run(return_merges=True)

Ported so far: detect on gridded and unstructured data (every anomaly
method, the approximate and exact global and Hobday thresholds,
``std_normalise``), and tracking without merging (3x3x3 event labelling) and
with it (the split/merge march with nearest-cell or centroid partitioning,
event clustering, per-event area, centroid, presence and merge ledger, and
the merge records) on global grids, on regional ones (``regional_tracker``)
and on unstructured triangular meshes (``unstructured_grid=True`` with the
mesh's ``neighbours`` and ``cell_areas``). Data larger than memory goes
through the out-of-core path: zarr stores (``io.zarr_lite``),
``preprocess_data_streamed`` (latitude-row tiles) and
``tracker(...).run_streamed`` (time blocks), and the tracker's preprocessing
checkpoints (``run(checkpoint='save' | 'load' | 'auto')``). Tensors stay on
the device they were given; numpy inputs move to ``device`` (default
``"cuda"``); lazy zarr payloads stay on disk until read. The
connected-component labelling runs on hand-written CUDA kernels
(``csrc/min_stencil.cu`` on a grid, ``csrc/graph_step.cu`` on a mesh),
compiled with ``nvcc`` at first use; event clustering uses the host
union-find of ``csrc/marex_host.cpp``, compiled with ``g++`` at first use.
"""

from .core.field import Coord, Field, FieldSet, as_field, concat, from_reference
from .detect import (
    add_decimal_year,
    compute_normalised_anomaly,
    identify_extremes,
    preprocess_data,
    rolling_climatology,
    smoothed_rolling_climatology,
)
from .exceptions import (
    ConfigurationError,
    CoordinateError,
    DataValidationError,
    DependencyError,
    DeviceError,
    MarExError,
    ProcessingError,
    TrackingError,
    VisualisationError,
)
from .detect_stream import preprocess_data_streamed
from .track import regional_tracker, tracker

__all__ = [
    "Field",
    "FieldSet",
    "Coord",
    "as_field",
    "concat",
    "from_reference",
    "preprocess_data",
    "preprocess_data_streamed",
    "compute_normalised_anomaly",
    "identify_extremes",
    "rolling_climatology",
    "smoothed_rolling_climatology",
    "add_decimal_year",
    "tracker",
    "regional_tracker",
    "MarExError",
    "DataValidationError",
    "CoordinateError",
    "ProcessingError",
    "ConfigurationError",
    "DependencyError",
    "TrackingError",
    "VisualisationError",
    "DeviceError",
]

__version__ = "0.1.0"
