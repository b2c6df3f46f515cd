"""Core array and calendar layer for marex_tpu_torch."""

from .field import Coord, Field, FieldSet, as_field, concat, from_reference, on_device
from .timeaxis import TimeIndexInfo, decompose_time

__all__ = ["Coord", "Field", "FieldSet", "as_field", "concat", "from_reference", "on_device", "TimeIndexInfo", "decompose_time"]
