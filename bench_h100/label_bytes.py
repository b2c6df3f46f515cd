"""The bytes a connected-component labelling of a field needs at least: its
boolean mask read once and its int32 labels written once."""

MASK_BYTES = 1
LABEL_BYTES = 4


def labelling_bytes(cells: int) -> int:
    return cells * (MASK_BYTES + LABEL_BYTES)
