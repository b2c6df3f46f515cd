"""Core array and calendar layer for marex_tpu_torch."""

from .field import (
    Coord,
    Field,
    FieldSet,
    as_field,
    broadcast,
    concat,
    from_reference,
    from_xarray,
    full_like,
    isfinite,
    on_device,
    ones_like,
    zeros_like,
)
from .timeaxis import (
    TimeIndexInfo,
    decompose_time,
    doy_window_indices,
    gather_from_year_doy,
    scatter_to_year_doy,
)

__all__ = [
    "Coord",
    "Field",
    "FieldSet",
    "as_field",
    "broadcast",
    "concat",
    "from_xarray",
    "full_like",
    "isfinite",
    "ones_like",
    "zeros_like",
    "TimeIndexInfo",
    "decompose_time",
    "doy_window_indices",
    "gather_from_year_doy",
    "scatter_to_year_doy",
    # the port's own: a reference Field carried across, and a payload on a device
    "from_reference",
    "on_device",
]
