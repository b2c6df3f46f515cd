"""Multi-device execution on ``torch.distributed``: device meshes, shardings
(:mod:`.mesh`) and the stages' collectives (:mod:`.comm`), one process a
device."""

from .mesh import (
    constrain,
    detect_sharding,
    get_default_mesh,
    make_mesh,
    pad_to_multiple,
    replicated,
    set_default_mesh,
    shard_if_divisible,
    shard_put,
    track_sharding,
    use_mesh,
)

__all__ = [
    "make_mesh",
    "detect_sharding",
    "track_sharding",
    "replicated",
    "constrain",
    "shard_put",
    "shard_if_divisible",
    "pad_to_multiple",
    "set_default_mesh",
    "get_default_mesh",
    "use_mesh",
]
