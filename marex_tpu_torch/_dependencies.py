"""
Optional-dependency registry for marex_tpu_torch.

A copy of ``marex_tpu/_dependencies.py`` for the port: one place that
records which optional packages are importable, raises helpful errors when a
feature needs one, and reports installation profiles. The core stack here is
torch, numpy and pandas; ``triton`` and the CUDA compiler ``nvcc`` are
registered too, ``nvcc`` probed as a binary on ``PATH`` or under
``$CUDA_HOME/bin`` (the port's CUDA kernels are built by it at first use).
"""

from __future__ import annotations

import importlib.util
import os
import shutil
from typing import Dict, List

from .exceptions import DependencyError

# name -> (pip package or install hint, why it is needed)
OPTIONAL_DEPENDENCIES: Dict[str, tuple] = {
    "triton": ("triton", "Triton kernels on a CUDA GPU"),
    "nvcc": ("the CUDA toolkit", "building the hand-written CUDA kernels (marex_tpu_torch/csrc)"),
    "xarray": ("xarray", "xarray interop (accepting/returning xarray objects)"),
    "dask": ("dask[distributed]", "ingesting dask-backed arrays"),
    "zarr": ("zarr", "reading compressed external zarr stores (zarr-lite covers zlib/raw/blosc)"),
    "matplotlib": ("matplotlib", "plotX visualisation"),
    "cartopy": ("cartopy", "map projections in plotX"),
    "cmocean": ("cmocean", "oceanographic colormaps"),
    "seaborn": ("seaborn", "statistical plot styling"),
    "pillow": ("Pillow", "animation frame encoding"),
    "psutil": ("psutil", "memory telemetry in logs"),
    "h5py": ("h5py", "HDF5/NetCDF4 ingest"),
    "scipy": ("scipy", "reference kernels for testing"),
    "netCDF4": ("netCDF4", "NetCDF ingest"),
}

REQUIRED_DEPENDENCIES: Dict[str, str] = {
    "torch": "torch",
    "numpy": "numpy",
    "pandas": "pandas",
}

INSTALLATION_PROFILES: Dict[str, List[str]] = {
    "minimal": [],
    "performance": ["psutil"],
    "io": ["zarr", "xarray", "h5py", "netCDF4"],
    "plotting": ["matplotlib", "cartopy", "cmocean", "seaborn", "pillow"],
    "full": sorted(OPTIONAL_DEPENDENCIES.keys()),
}

_availability_cache: Dict[str, bool] = {}

_IMPORT_NAMES = {"pillow": "PIL"}
# dependencies that are programs, not Python packages
_BINARIES = {"nvcc"}


def _find_binary(name: str) -> bool:
    if shutil.which(name):
        return True
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.access(os.path.join(cuda_home, "bin", name), os.X_OK)


def has_dependency(name: str) -> bool:
    """Return True when the optional dependency ``name`` is available."""
    if name in _availability_cache:
        return _availability_cache[name]
    if name in _BINARIES:
        ok = _find_binary(name)
    else:
        ok = importlib.util.find_spec(_IMPORT_NAMES.get(name, name)) is not None
    _availability_cache[name] = ok
    return ok


def _install_hint(names: List[str]) -> str:
    """The reference's ``pip install`` hint; a program's hint where one of
    ``names`` is a program."""
    hints = [OPTIONAL_DEPENDENCIES.get(n, (n, ""))[0] for n in names]
    if any(n in _BINARIES for n in names):
        return f"Install: {', '.join(hints)}"
    return f"Install with: pip install {' '.join(hints)}"


def require_dependencies(names: List[str], feature: str = "this feature") -> None:
    """
    Raise :class:`DependencyError` when any of ``names`` is missing, with an
    install hint.
    """
    missing = [n for n in names if not has_dependency(n)]
    if missing:
        raise DependencyError(
            f"Missing dependencies for {feature}: {', '.join(missing)}",
            details=f"{feature} requires additional packages that are not installed",
            suggestions=[_install_hint(missing)],
            context={"missing": missing, "feature": feature},
        )


_warned: set = set()


def warn_missing_dependency(name: str, feature: str = "Some functionality") -> None:
    """Log (once per dependency) that a feature is degraded."""
    if name in _warned:
        return
    _warned.add(name)
    from .logging_config import get_logger

    get_logger(__name__).warning(f"{feature} requires '{name}' which is not installed. {_install_hint([name])}")


def get_dependency_status() -> Dict[str, bool]:
    """Availability map for every known optional dependency."""
    return {name: has_dependency(name) for name in sorted(OPTIONAL_DEPENDENCIES)}


def get_installation_profile() -> str:
    """
    Classify the current environment against the installation profiles,
    returning the richest fully-satisfied profile name.
    """
    status = get_dependency_status()
    best = "minimal"
    for profile in ("performance", "io", "plotting", "full"):
        if all(status.get(n, False) for n in INSTALLATION_PROFILES[profile]):
            best = profile
    return best


def print_dependency_status() -> None:
    """Human-readable dump of dependency availability."""
    status = get_dependency_status()
    print("marex_tpu_torch optional dependencies:")
    for name, ok in status.items():
        _, why = OPTIONAL_DEPENDENCIES[name]
        mark = "+" if ok else "-"
        print(f"  [{mark}] {name:<12} {why}")
    print(f"Installation profile: {get_installation_profile()}")
