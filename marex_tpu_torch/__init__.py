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
checkpoints (``run(checkpoint='save' | 'load' | 'auto')``). No-merge
tracking past 2**31 - 1 cells labels in two levels, as the reference does;
the tracker's mid-level API (``identify_objects``,
``calculate_object_properties``, ``check_overlap_slice``,
``find_overlapping_objects``), the ``Field`` operators and reductions (in
torch, on the payload's device) and the runtime helpers (``helper``) are
ported, and so is the third stage, visualisation (``plotX``,
``PlotConfig``, ``specify_grid``; matplotlib needed to draw), which reduces
a field on its own device and brings one slice a frame to the host; so
is the multi-device package ``parallel``: under ``torchrun``, one process a
GPU, ``preprocess_data(mesh=True)`` splits space over the processes and
``tracker(..., mesh=True)`` splits time, with outputs equal to one
process's. Tensors stay on
the device they were given; numpy inputs move to ``device`` (default
``"cuda"``); lazy zarr payloads stay on disk until read. The
connected-component labelling runs on hand-written CUDA kernels
(``csrc/min_stencil.cu`` on a grid, ``csrc/graph_step.cu`` on a mesh),
compiled with ``nvcc`` at first use; event clustering uses the host
union-find of ``csrc/marex_host.cpp``, compiled with ``g++`` at first use.
"""

from ._dependencies import (
    get_dependency_status,
    get_installation_profile,
    has_dependency,
    print_dependency_status,
)
from .core.field import Coord, Field, FieldSet, as_field, concat, from_reference, from_xarray
from .detect import (
    add_decimal_year,
    compute_normalised_anomaly,
    identify_extremes,
    preprocess_data,
    rolling_climatology,
    smoothed_rolling_climatology,
)
from .detect_stream import preprocess_data_streamed
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
    create_coordinate_error,
    create_data_validation_error,
    create_processing_error,
    create_tracking_error,
    wrap_exception,
)
from .helper import configure_dask, configure_devices
from .logging_config import (
    configure_logging,
    get_logger,
    get_verbosity_level,
    is_quiet_mode,
    is_verbose_mode,
    set_normal_logging,
    set_quiet_mode,
    set_verbose_mode,
)
from .track import regional_tracker, tracker

__all__ = [
    # Core containers
    "Field",
    "FieldSet",
    "Coord",
    "as_field",
    "from_xarray",
    "concat",
    "from_reference",
    # Core data preprocessing
    "preprocess_data",
    "preprocess_data_streamed",
    "compute_normalised_anomaly",
    "smoothed_rolling_climatology",
    "rolling_climatology",
    "identify_extremes",
    "add_decimal_year",
    # Tracking
    "tracker",
    "regional_tracker",
    # Visualisation
    "specify_grid",
    "PlotConfig",
    # Exceptions
    "MarExError",
    "DataValidationError",
    "CoordinateError",
    "ProcessingError",
    "ConfigurationError",
    "DependencyError",
    "TrackingError",
    "VisualisationError",
    "DeviceError",
    "create_data_validation_error",
    "create_coordinate_error",
    "create_processing_error",
    "create_tracking_error",
    "wrap_exception",
    # Dependency management
    "has_dependency",
    "print_dependency_status",
    "get_dependency_status",
    "get_installation_profile",
    # Logging configuration
    "configure_logging",
    "set_verbose_mode",
    "set_quiet_mode",
    "set_normal_logging",
    "get_verbosity_level",
    "is_verbose_mode",
    "is_quiet_mode",
    "get_logger",
    # Runtime helpers
    "configure_dask",
    "configure_devices",
]

__version__ = "0.1.0"

def __getattr__(name):
    # importlib.import_module, not ``from . import x``: the latter re-enters
    # this __getattr__ during the submodule import
    import importlib

    if name in ("helper", "check_device_health", "run_with_retries", "start_local_cluster",
                "start_distributed_cluster"):
        mod = importlib.import_module(".helper", __name__)
        return mod if name == "helper" else getattr(mod, name)
    if name in ("specify_grid", "PlotConfig", "plotX"):
        mod = importlib.import_module(".plotX", __name__)
        return mod if name == "plotX" else getattr(mod, name)
    if name in ("io", "parallel"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'marex_tpu_torch' has no attribute {name!r}")
