"""IO layer: dependency-free zarr v2 stores."""

from .zarr_lite import LazyZarrArray, open_zarr, to_zarr

__all__ = ["LazyZarrArray", "open_zarr", "to_zarr"]
