"""
PlotterBase & PlotConfig — core of the port's plotX visualisation subsystem.

The port of ``marex_tpu/plotX/base.py``: the same PlotConfig surface
(title/units/symmetric colormaps/percentile clims/ID plotting with a seeded
random colormap/projection/framerate) and the same
single_plot/multi_plot/animate API, drawing the same arrays. What changes is
where the data sits: the ID maximum and the robust colour limits are reduced
on the payload's device, ``plot_IDs`` masks only the slices that are drawn,
and a frame or a panel brings back one slice (:mod:`.prep`). matplotlib is
required for any plotting; cartopy is optional — without it plots fall back
to plain lat/lon axes instead of map projections (gated through the
dependency registry, so the rest of the framework works headless).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .._dependencies import has_dependency, require_dependencies
from ..core.field import Field
from ..exceptions import VisualisationError
from ..io.zarr_lite import LazyZarrArray
from ..logging_config import configure_logging, get_logger
from . import prep

logger = get_logger(__name__)


def _check_plotting_dependencies() -> None:
    require_dependencies(["matplotlib"], "Plotting functionality")


def _render_frame_task(payload):
    """Render ONE animation frame from a picklable payload (runs in a worker
    process of the batched animate pool, or inline on the serial fallback).
    The payload holds numpy only: a worker forked from a process that holds
    a CUDA context must not touch the card."""
    plotter_cls, da_np, dimensions, coordinates, grid_attrs, cfg_kwargs, centroid, out_path = payload
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    panel = plotter_cls(da_np, dimensions, coordinates)
    for attr, val in grid_attrs.items():
        setattr(panel, attr, val)
    panel_config = PlotConfig(**cfg_kwargs)
    fig, ax, _ = panel.single_plot(panel_config)
    if centroid is not None:
        try:
            kw = (
                {"transform": panel._ccrs.PlateCarree()}
                if (getattr(panel, "_ccrs", None) and panel_config.projection is not None)
                else {}
            )
            ax.scatter(centroid[1], centroid[0], s=30, c="red", marker="x", zorder=10, **kw)
        except Exception:  # pragma: no cover
            pass
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


def _get_cartopy():
    if has_dependency("cartopy"):
        import cartopy.crs as ccrs
        import cartopy.feature as cfeature

        return ccrs, cfeature
    return None, None


@dataclass
class PlotConfig:
    """Plot parameter bundle (cf. plotX/base.py:75-134)."""

    title: Optional[str] = None
    var_units: str = ""
    issym: bool = False
    cmap: Optional[Any] = None
    cperc: Optional[List[int]] = None
    clim: Optional[Tuple[float, float]] = None
    show_colorbar: bool = True
    grid_lines: bool = True
    grid_labels: bool = False
    dimensions: Optional[Dict[str, str]] = None
    coordinates: Optional[Dict[str, str]] = None
    norm: Optional[Any] = None
    plot_IDs: bool = False
    extend: str = "both"
    verbose: Optional[bool] = None
    quiet: Optional[bool] = None
    projection: Optional[Any] = None
    framerate: int = 10
    # frames rendered (and pickled to the pool) per batch — the reference
    # computes dask.delayed frames in batches of 200 (plotX/base.py:516-524)
    frame_batch_size: int = 200

    def __post_init__(self) -> None:
        if self.cperc is None:
            self.cperc = [4, 96]
        if self.dimensions is None:
            self.dimensions = {"time": "time", "y": "lat", "x": "lon"}
        if self.coordinates is None:
            self.coordinates = {"time": "time", "y": "lat", "x": "lon"}
        if self.plot_IDs:
            self.show_colorbar = False
        if self.projection is None:
            ccrs, _ = _get_cartopy()
            if ccrs is not None:
                self.projection = ccrs.Robinson()
        if self.verbose is not None or self.quiet is not None:
            configure_logging(verbose=self.verbose, quiet=self.quiet)


def _validate_dims_coords(da: Field, dimensions: Dict[str, str], coordinates: Dict[str, str]) -> None:
    missing = [
        f"'{actual}' (for {concept})"
        for concept, actual in dimensions.items()
        if concept != "time" and actual not in da.dims
    ]
    if missing:
        raise VisualisationError(
            f"Missing required dimensions: {', '.join(missing)}",
            details=f"Dataset has dimensions: {list(da.dims)}",
            suggestions=["Check dimension names", "Update the 'dimensions' parameter"],
            context={"missing_dimensions": missing, "available_dimensions": list(da.dims)},
        )
    missing_c = [
        f"'{actual}' (for {concept})"
        for concept, actual in coordinates.items()
        if concept != "time" and actual not in da.coords
    ]
    if missing_c:
        raise VisualisationError(
            f"Missing required coordinates: {', '.join(missing_c)}",
            details=f"Dataset has coordinates: {list(da.coords)}",
            suggestions=["Check coordinate names", "Update the 'coordinates' parameter"],
            context={"missing_coordinates": missing_c, "available_coordinates": list(da.coords)},
        )


class PlotterBase:
    """Common plotting infrastructure (cf. plotX/base.py:193-590)."""

    def __init__(
        self,
        da: Field,
        dimensions: Optional[Dict[str, str]] = None,
        coordinates: Optional[Dict[str, str]] = None,
    ) -> None:
        _check_plotting_dependencies()
        self.da = da
        self.dimensions = dimensions or {"time": "time", "y": "lat", "x": "lon"}
        self.coordinates = coordinates or {"time": "time", "y": "lat", "x": "lon"}
        _validate_dims_coords(da, self.dimensions, self.coordinates)
        self._ccrs, self._cfeature = _get_cartopy()

    # -- parameter setup ----------------------------------------------------

    def setup_plot_params(self) -> None:
        import matplotlib.pyplot as plt

        plt.rcParams.update({"font.size": 10})

    def setup_id_plot_params(self, cmap: Optional[Any]) -> Tuple[Any, Any, str]:
        """Random categorical colormap seeded at 42 + BoundaryNorm
        (plotX/base.py:578-590)."""
        from matplotlib.colors import BoundaryNorm, ListedColormap

        max_id = int(prep.nanmax(self.da.data)) if self.da.size else 1
        max_id = max(max_id, 1)
        if cmap is None:
            rng = np.random.default_rng(42)
            colors = rng.random((max_id, 3))
            cmap = ListedColormap(colors)
        bounds = np.arange(0.5, max_id + 1.5)
        norm = BoundaryNorm(bounds, cmap.N if hasattr(cmap, "N") else max_id)
        return cmap, norm, "ID"

    @staticmethod
    def clim_robust(data: np.ndarray, issym: bool, percentiles: List[int]) -> Tuple[float, float]:
        """Percentile-based robust color limits (plotX/base.py:559-571), on
        the device of a tensor ``data`` (:func:`.prep.robust_limits`)."""
        if not isinstance(data, (torch.Tensor, LazyZarrArray, prep.PositiveOnly)):
            data = np.asarray(data)
        return prep.robust_limits(data, issym, percentiles)

    def _setup_common_params(self, config: PlotConfig):
        self.setup_plot_params()
        if config.plot_IDs:
            cmap, norm, var_units = self.setup_id_plot_params(config.cmap)
            clim = None
            extend = "neither"
            # self.da.where(self.da > 0), masked a slice at a time as it is drawn
            self.da = self.da._replace(data=prep.PositiveOnly(self.da.data))
        else:
            cmap = config.cmap if config.cmap is not None else ("RdBu_r" if config.issym else "viridis")
            norm = config.norm
            if config.clim is None and norm is None:
                # every tenth time slice, sampled on the payload's device
                time_dim = self.dimensions.get("time", "time")
                axis = self.da.dims.index(time_dim) if time_dim in self.da.dims else None
                clim = prep.robust_limits(self.da.data, config.issym, config.cperc, axis=axis)
            else:
                clim = config.clim
            var_units = config.var_units
            extend = config.extend
        return cmap, norm, clim, var_units, extend

    def _setup_axes(self, ax: Optional[Any] = None, projection: Optional[Any] = None):
        import matplotlib.pyplot as plt

        if ax is None:
            fig = plt.figure(figsize=(7, 5))
            if projection is not None and self._ccrs is not None:
                ax = plt.axes(projection=projection)
            else:
                ax = plt.axes()
        else:
            fig = ax.get_figure()
        return fig, ax

    def _add_map_features(self, ax: Any, grid_lines: bool = True, grid_labels: bool = False) -> None:
        if self._cfeature is not None and hasattr(ax, "add_feature"):
            ax.add_feature(self._cfeature.LAND.with_scale("50m"), facecolor="darkgrey", zorder=2)
            ax.add_feature(self._cfeature.COASTLINE.with_scale("50m"), linewidth=0.5, zorder=3)
            if grid_lines:
                ax.gridlines(
                    crs=self._ccrs.PlateCarree(),
                    draw_labels=grid_labels,
                    linewidth=1,
                    color="gray",
                    alpha=0.5,
                    linestyle="--",
                    zorder=4,
                )
        elif grid_lines:
            ax.grid(True, linewidth=0.5, color="gray", alpha=0.5, linestyle="--")

    def _setup_colorbar(self, fig, im, show_colorbar: bool, var_units: str, extend: str = "both", position=None):
        import matplotlib.pyplot as plt

        if not show_colorbar:
            return None
        if position is not None:
            cbar_ax = fig.add_axes(position)
            cb = fig.colorbar(im, cax=cbar_ax, extend=extend)
        else:
            cb = plt.colorbar(im, shrink=0.6, ax=plt.gca(), extend=extend)
        if var_units:
            cb.ax.set_ylabel(var_units, fontsize=10)
        cb.ax.tick_params(labelsize=10)
        return cb

    def _get_title(self, index: int, col_name: str) -> str:
        if col_name == self.dimensions.get("time", "time"):
            tvals = self.da.coords[self.coordinates.get("time", "time")].values
            import pandas as pd

            return str(pd.Timestamp(tvals[index]).strftime("%Y-%m-%d"))
        return f"{col_name}={self.da.coords[col_name].values[index]}"

    # -- public API -----------------------------------------------------------

    def plot(self, ax, cmap, clim=None, norm=None):  # pragma: no cover - abstract
        raise NotImplementedError

    def single_plot(self, config: PlotConfig, ax: Optional[Any] = None):
        """Render one frame (cf. plotX/base.py:331-346)."""
        cmap, norm, clim, var_units, extend = self._setup_common_params(config)
        fig, ax = self._setup_axes(ax, config.projection)
        ax, im = self.plot(ax=ax, cmap=cmap, clim=clim, norm=norm)
        if config.title:
            ax.set_title(config.title, size=12)
        self._setup_colorbar(fig, im, config.show_colorbar, var_units, extend)
        self._add_map_features(ax, config.grid_lines, config.grid_labels)
        return fig, ax, im

    def multi_plot(self, config: PlotConfig, col: str = "time", col_wrap: int = 3):
        """Wrapped subplot grid with a shared colorbar (plotX/base.py:348-406)."""
        import matplotlib.pyplot as plt

        col_dim = self.dimensions.get(col, col)
        npanels = self.da.sizes[col_dim]
        nrows = int(np.ceil(npanels / col_wrap))
        ncols = min(npanels, col_wrap)

        cmap, norm, clim, var_units, extend = self._setup_common_params(config)

        subplot_kw = {"projection": config.projection} if (config.projection is not None and self._ccrs) else {}
        fig, axes = plt.subplots(nrows, ncols, figsize=(6 * ncols, 3 * nrows), subplot_kw=subplot_kw)
        axes = np.atleast_1d(axes).flatten()

        for i, ax in enumerate(axes):
            if i < npanels:
                panel = type(self)(prep.host_frame(self.da, col_dim, i), self.dimensions, self.coordinates)
                for attr in ("fpath_tgrid", "fpath_ckdtree", "_tri_cache"):
                    if hasattr(self, attr):
                        setattr(panel, attr, getattr(self, attr))
                panel_config = PlotConfig(
                    title=self._get_title(i, col_dim),
                    cmap=cmap,
                    clim=clim,
                    show_colorbar=False,
                    grid_labels=False,
                    norm=norm,
                    plot_IDs=False,
                    extend=extend,
                    dimensions=config.dimensions,
                    coordinates=config.coordinates,
                    projection=config.projection,
                )
                panel.single_plot(panel_config, ax=ax)
            else:
                fig.delaxes(ax)

        if config.show_colorbar:
            from matplotlib.colors import Normalize

            fig.subplots_adjust(right=0.9)
            use_norm = norm if norm is not None else (Normalize(vmin=clim[0], vmax=clim[1]) if clim else None)
            sm = plt.cm.ScalarMappable(cmap=cmap, norm=use_norm)
            sm.set_array([])
            self._setup_colorbar(fig, sm, True, var_units, extend, position=[0.92, 0.15, 0.02, 0.7])
        return fig, axes

    def animate(
        self,
        config: PlotConfig,
        plot_dir: Union[str, Path] = "./",
        file_name: Optional[str] = None,
        centroids: Optional[Field] = None,
        object_ids: Optional[Field] = None,
    ) -> Optional[str]:
        """
        Render per-timestep frames and assemble an MP4 via ffmpeg (or an
        animated GIF via PIL when ffmpeg is missing) — plotX/base.py:408-552.
        """
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        time_dim = self.dimensions.get("time", "time")
        if time_dim not in self.da.dims:
            raise VisualisationError(
                "Animation requires a time dimension",
                suggestions=["Pass a (time, space) field to animate"],
            )

        cmap, norm, clim, var_units, extend = self._setup_common_params(config)
        T = self.da.sizes[time_dim]

        plot_dir = Path(plot_dir)
        plot_dir.mkdir(parents=True, exist_ok=True)
        tmpdir = Path(tempfile.mkdtemp(prefix="marex_frames_"))

        # Batched frame rendering (the reference renders dask.delayed frames
        # in batches of 200, plotX/base.py:479-524; here a process pool plays
        # the worker role — rendering is host-side matplotlib work). Batches
        # bound the pickled payload volume; a non-picklable config or a
        # single-core host degrades gracefully to the serial path.
        batch = max(int(getattr(config, "frame_batch_size", 0) or 200), 1)
        n_workers = min(os.cpu_count() or 1, 8)

        def _panel_payload(t):
            da_np = prep.host_frame(self.da, time_dim, t)
            grid_attrs = {
                attr: getattr(self, attr)
                for attr in ("fpath_tgrid", "fpath_ckdtree")
                if hasattr(self, attr)
            }
            cfg_kwargs = dict(
                title=self._get_title(t, time_dim),
                cmap=cmap,
                clim=clim,
                show_colorbar=config.show_colorbar,
                grid_labels=False,
                norm=norm,
                plot_IDs=False,
                extend=extend,
                dimensions=config.dimensions,
                coordinates=config.coordinates,
                projection=config.projection,
            )
            centroid = None
            if centroids is not None:
                try:
                    cvals = prep.host_values(centroids.isel({time_dim: t}))
                    centroid = (float(cvals[0]), float(cvals[1]))
                except Exception:  # pragma: no cover
                    centroid = None
            fp = tmpdir / f"frame_{t:06d}.jpg"
            return (type(self), da_np, dict(self.dimensions), dict(self.coordinates), grid_attrs, cfg_kwargs, centroid, str(fp))

        frame_paths = []
        pool = None
        if n_workers > 1 and T > 1:
            try:
                import multiprocessing as mp

                pool = mp.get_context("fork").Pool(processes=n_workers)
            except Exception:  # pragma: no cover - platform without fork
                pool = None
        try:
            for start in range(0, T, batch):
                payloads = [_panel_payload(t) for t in range(start, min(start + batch, T))]
                if pool is not None:
                    try:
                        frame_paths.extend(pool.map(_render_frame_task, payloads))
                        continue
                    except Exception:  # pragma: no cover - unpicklable config
                        logger.debug("parallel frame rendering failed; falling back to serial")
                        pool.terminate()
                        pool = None
                frame_paths.extend(_render_frame_task(p) for p in payloads)
        finally:
            if pool is not None:
                pool.close()
                pool.join()
        frame_paths = [Path(p) for p in frame_paths]

        name = file_name or (self.da.name or "animation")
        out_mp4 = plot_dir / f"{name}.mp4"

        if shutil.which("ffmpeg") is not None:
            cmd = [
                "ffmpeg", "-y", "-framerate", str(config.framerate),
                "-i", str(tmpdir / "frame_%06d.jpg"),
                "-c:v", "libx264", "-pix_fmt", "yuv420p",
                "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
                str(out_mp4),
            ]
            subprocess.run(cmd, check=True, capture_output=True)
            result = str(out_mp4)
        elif has_dependency("pillow"):
            from PIL import Image

            out_gif = plot_dir / f"{name}.gif"
            frames = [Image.open(p) for p in frame_paths]
            frames[0].save(
                out_gif,
                save_all=True,
                append_images=frames[1:],
                duration=int(1000 / config.framerate),
                loop=0,
            )
            result = str(out_gif)
        else:  # pragma: no cover
            warnings.warn("Neither ffmpeg nor PIL available; leaving raw frames", stacklevel=2)
            result = str(tmpdir)

        if result != str(tmpdir):
            shutil.rmtree(tmpdir, ignore_errors=True)
        logger.info(f"Animation written to {result}")
        return result
