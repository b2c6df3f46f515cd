"""
PlotX for the PyTorch port: the visualisation subsystem.

The port of ``marex_tpu/plotX``, with the same polymorphic design:
automatic grid-type detection (a ``y`` dimension means gridded), a global
grid registry set by :func:`specify_grid`, and a ``plotX`` accessor — a
property of :class:`marex_tpu_torch.Field`, which imports this package at
first use (the reference registers it on import), and on xarray DataArrays
too when xarray is installed (with both packages in one process, the one
imported last owns ``DataArray.plotX``). The plotters draw the reference's
arrays; what they reduce and bring to the host is in :mod:`.prep`, which
needs no matplotlib.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Dict, Optional, Union

from .._dependencies import has_dependency
from ..core.field import Field
from ..exceptions import ConfigurationError
from ..logging_config import get_logger
from .base import PlotConfig, PlotterBase
from .gridded import GriddedPlotter
from .unstructured import UnstructuredPlotter, clear_cache

logger = get_logger(__name__)

_fpath_tgrid: Optional[str] = None
_fpath_ckdtree: Optional[str] = None
_grid_type: Optional[str] = None


def _detect_grid_type(obj, dimensions: Optional[Dict[str, str]] = None, coordinates: Optional[Dict[str, str]] = None) -> str:
    """'gridded' when a y dimension exists, else 'unstructured'
    (cf. plotX/__init__.py:44-79)."""
    if dimensions is None:
        dimensions = {"time": "time", "y": "lat", "x": "lon"}
    has_y_dim = "y" in dimensions and dimensions["y"] in obj.dims
    return "gridded" if has_y_dim else "unstructured"


class PlotXAccessor:
    """Accessor object returned by ``field.plotX`` — call it to get a plotter."""

    def __init__(self, obj: Field):
        self._obj = obj

    def __call__(
        self,
        dimensions: Optional[Dict[str, str]] = None,
        coordinates: Optional[Dict[str, str]] = None,
    ) -> PlotterBase:
        detected = _detect_grid_type(self._obj, dimensions, coordinates)
        if _grid_type is not None:
            if _grid_type != detected:
                warnings.warn(
                    f"Specified grid type '{_grid_type}' differs from detected type '{detected}'. "
                    f"Using specified type '{_grid_type}'.",
                    stacklevel=2,
                )
            final = _grid_type
        else:
            final = detected

        cls = UnstructuredPlotter if final == "unstructured" else GriddedPlotter
        obj = self._obj
        if not isinstance(obj, Field):
            from ..core.field import as_field

            obj = as_field(obj)
        plotter = cls(obj, dimensions, coordinates)
        if final == "unstructured" and (_fpath_tgrid is not None or _fpath_ckdtree is not None):
            plotter.specify_grid(fpath_tgrid=_fpath_tgrid, fpath_ckdtree=_fpath_ckdtree)
        return plotter

    def single_plot(self, config: PlotConfig, **kwargs):
        return self().single_plot(config, **kwargs)

    def multi_plot(self, config: PlotConfig, **kwargs):
        return self().multi_plot(config, **kwargs)

    def animate(self, config: PlotConfig, **kwargs):
        return self().animate(config, **kwargs)


def specify_grid(
    grid_type: Optional[str] = None,
    fpath_tgrid: Optional[Union[str, Path]] = None,
    fpath_ckdtree: Optional[Union[str, Path]] = None,
) -> None:
    """Set the global grid specification used by all plotters
    (cf. plotX/__init__.py:157-194)."""
    global _fpath_tgrid, _fpath_ckdtree, _grid_type

    if grid_type is not None and grid_type.lower() not in ("gridded", "unstructured"):
        raise ConfigurationError(
            "Invalid grid type specification",
            details=f"Provided grid_type '{grid_type}' is not supported",
            suggestions=[
                "Use 'gridded' for regular lat/lon grids",
                "Use 'unstructured' for triangular/irregular meshes",
            ],
            context={"provided_type": grid_type, "valid_types": ["gridded", "unstructured"]},
        )
    _fpath_tgrid = str(fpath_tgrid) if fpath_tgrid else None
    _fpath_ckdtree = str(fpath_ckdtree) if fpath_ckdtree else None
    _grid_type = grid_type.lower() if grid_type else None


# Field.plotX is a property of the port's Field (core/field.py), there before
# this package is imported; xarray's accessor is registered here when present
if has_dependency("xarray"):  # pragma: no cover - exercised only with xarray installed
    try:
        import xarray as xr

        @xr.register_dataarray_accessor("plotX")
        class _XrPlotXAccessor(PlotXAccessor):
            pass

    except Exception:
        pass

__all__ = [
    "PlotConfig",
    "clear_cache",
    "PlotterBase",
    "GriddedPlotter",
    "UnstructuredPlotter",
    "PlotXAccessor",
    "specify_grid",
]
