"""
GriddedPlotter: regular lat/lon rendering (cf. plotX/gridded.py), the port
of ``marex_tpu/plotX/gridded.py``; the slice drawn is the one slice brought
to the host.

Wraps one longitude column so pcolormesh closes the periodic seam, and plots
in PlateCarree data coordinates when cartopy is available.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from . import prep
from .base import PlotterBase


class GriddedPlotter(PlotterBase):
    """Plotter for structured (time, lat, lon) data."""

    def wrap_lon(self, data: np.ndarray, lon: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Append a wrapped longitude column (plotX/gridded.py:48-60)."""
        lon_wrapped = np.concatenate([lon, [lon[0] + 360.0]])
        data_wrapped = np.concatenate([data, data[:, :1]], axis=1)
        return data_wrapped, lon_wrapped

    def plot(self, ax: Any, cmap: Any, clim: Optional[Tuple[float, float]] = None, norm: Optional[Any] = None):
        da = self.da
        tdim = self.dimensions.get("time", "time")
        if tdim in da.dims:
            da = da.isel({tdim: 0})

        ydim = self.dimensions["y"]
        xdim = self.dimensions["x"]
        da = da.transpose(ydim, xdim)

        lat = np.asarray(da.coords[self.coordinates["y"]].values, dtype=float)
        lon = np.asarray(da.coords[self.coordinates["x"]].values, dtype=float)
        vals = np.asarray(prep.host_values(da), dtype=float)

        vals, lon = self.wrap_lon(vals, lon)

        kwargs = dict(cmap=cmap, shading="auto")
        if norm is not None:
            kwargs["norm"] = norm
        elif clim is not None:
            kwargs["vmin"], kwargs["vmax"] = clim
        if self._ccrs is not None and hasattr(ax, "projection"):
            kwargs["transform"] = self._ccrs.PlateCarree()

        im = ax.pcolormesh(lon, lat, vals, **kwargs)
        return ax, im
