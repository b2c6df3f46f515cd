"""
Device meshes and shardings on ``torch.distributed``.

The port of ``marex_tpu/parallel/mesh.py``. One process drives one device
(``torchrun --nproc_per_node=N``, or :func:`marex_tpu_torch.helper.start_distributed_cluster`),
and a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
(n_time, n_space) over the world's ranks, with dims named ("time", "space").
A *sharding* is the pair ``(mesh, placements)`` of DTensor placements, one a
mesh dim:

* detect is pointwise in space, so its arrays are split along their spatial
  dim (``detect_sharding``: ``[Shard(1), Shard(1)]`` on a (T, lat, lon) or
  (T, cell) array), over both mesh dims at once: rank ``i * n_space + j``
  holds the ``i * n_space + j``-th band of whole latitude rows (or of cells);
* tracking needs whole slices, so its arrays are split along time
  (``track_sharding``: ``[Shard(0), Shard(0)]``), in the same order;
* small tables are ``replicated`` on every rank.

An array whose sharded dim does not divide by the mesh's size runs
replicated (:func:`shard_if_divisible`, as the reference leaves it
unsharded). ``use_mesh`` scopes a default mesh that ``preprocess_data`` and
``tracker`` pick up when given none.
"""

from __future__ import annotations

import os
import socket
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from ..exceptions import ConfigurationError, DeviceError
from ..logging_config import get_logger

logger = get_logger(__name__)


class Sharding(NamedTuple):
    """Where an array lives on a mesh: one DTensor placement per mesh dim."""

    mesh: DeviceMesh
    placements: Tuple[Placement, ...]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_single_process(device_type: str) -> None:
    """A world of this one process on its own device: what a mesh over "all
    devices" is in a process that nobody started as part of a larger world."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    logger.info(f"Initialised a one-process {backend} world for the default mesh")


def make_mesh(n_time: Optional[int] = None, n_space: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """
    A ("time", "space") mesh over the world's ranks (all of them on "time"
    by default). Without a process group it starts one: through
    :func:`~marex_tpu_torch.helper.start_distributed_cluster` when ``torchrun``'s
    variables are set, else a world of this process alone. A CUDA mesh needs
    a CUDA device; nothing is moved to the CPU in its place.
    """
    if device_type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(
            "make_mesh(device_type='cuda') needs a CUDA device",
            details="torch.cuda.is_available() is False",
            suggestions=["Run on a machine with a GPU", "Pass device_type='cpu' for a gloo mesh on the CPU"],
        )
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            from ..helper import start_distributed_cluster

            start_distributed_cluster(backend="nccl" if device_type == "cuda" else "gloo")
        else:
            _init_single_process(device_type)
    world = dist.get_world_size()
    if n_time is None:
        n_time = world // n_space
    if n_time * n_space != world:
        raise ConfigurationError(
            f"A ({n_time}, {n_space}) mesh does not cover the world of {world} processes",
            suggestions=["Choose n_time * n_space equal to the number of processes"],
            context={"n_time": n_time, "n_space": n_space, "world_size": world},
        )
    return init_device_mesh(device_type, (n_time, n_space), mesh_dim_names=("time", "space"))


def detect_sharding(mesh: DeviceMesh) -> Sharding:
    """(T, S) or (T, H, W) arrays split along dim 1, the spatial one."""
    return Sharding(mesh, (Shard(1), Shard(1)))


def track_sharding(mesh: DeviceMesh, spatial_ndim: int = 2) -> Sharding:
    """(T, ...) arrays split along time. ``spatial_ndim`` is kept for the
    reference's signature."""
    return Sharding(mesh, (Shard(0), Shard(0)))


def replicated(mesh: DeviceMesh, ndim: int = 0) -> Sharding:
    """Arrays whole on every rank. ``ndim`` is kept for the reference's
    signature."""
    return Sharding(mesh, (Replicate(), Replicate()))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This process's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def sharded_dim(sharding: Sharding) -> Optional[int]:
    """The array dim that ``sharding`` splits (None when replicated)."""
    dims = {p.dim for p in sharding.placements if isinstance(p, Shard)}
    if len(dims) > 1:
        raise ConfigurationError("A sharding must split one array dim over every mesh dim")
    return dims.pop() if dims else None


def chunk_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """The ``[start, stop)`` of each of ``parts`` equal chunks of ``n``."""
    step = n // parts
    return [(i * step, (i + 1) * step) for i in range(parts)]


def _chunk_index(mesh: DeviceMesh) -> int:
    """This rank's position in the mesh's row-major order."""
    return mesh.mesh.flatten().tolist().index(dist.get_rank())


def divides(shape: Sequence[int], sharding: Sharding) -> bool:
    """Whether every sharded dim of ``shape`` splits evenly over the mesh."""
    d = sharded_dim(sharding)
    return d is None or (shape[d] > 0 and shape[d] % sharding.mesh.size() == 0)


def from_local(local: torch.Tensor, sharding: Sharding, global_shape: Sequence[int]) -> DTensor:
    """A DTensor of this rank's block ``local`` (no communication)."""
    shape = torch.Size(global_shape)
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False, shape=shape, stride=stride)


def shard_put(x: Any, sharding: Sharding) -> DTensor:
    """
    Place ``x`` with ``sharding``. A DTensor is redistributed; anything else
    (numpy, a tensor, a lazy zarr array) holds the whole array on every
    rank, and each rank uploads only its own block of it to its device, so
    a card never holds the whole input. The sharded dim must divide by the
    mesh's size.
    """
    if isinstance(x, DTensor):
        return constrain(x, sharding)
    shape = tuple(x.shape)
    if not divides(shape, sharding):
        raise ConfigurationError(
            f"Dim {sharded_dim(sharding)} of an array of shape {shape} does not split over {sharding.mesh.size()} ranks",
            suggestions=["Use shard_if_divisible, which replicates such arrays", "Pad with pad_to_multiple"],
        )
    d = sharded_dim(sharding)
    block = x
    if d is not None:
        a, b = chunk_bounds(shape[d], sharding.mesh.size())[_chunk_index(sharding.mesh)]
        block = x[(slice(None),) * d + (slice(a, b),)]
    dev = mesh_device(sharding.mesh)
    local = block.to(dev) if isinstance(block, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(block)).to(dev)
    return from_local(local.contiguous(), sharding, shape)


def constrain(x: Any, sharding: Sharding) -> DTensor:
    """``x`` redistributed to ``sharding`` (a reshard between stages; a
    collective, which every rank calls). A plain array goes to
    :func:`shard_put`."""
    if not isinstance(x, DTensor):
        return shard_put(x, sharding)
    if tuple(x.placements) == tuple(sharding.placements):
        return x
    return x.redistribute(sharding.mesh, sharding.placements)


def shard_if_divisible(x: Any, sharding: Sharding) -> DTensor:
    """``x`` placed with ``sharding`` when its sharded dim divides by the
    mesh's size, replicated on every rank otherwise (logged)."""
    if divides(tuple(x.shape), sharding):
        return shard_put(x, sharding)
    logger.info(
        f"Dim {sharded_dim(sharding)} of shape {tuple(x.shape)} does not split over {sharding.mesh.size()} ranks: "
        "the array runs replicated"
    )
    return constrain(x, replicated(sharding.mesh))


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int, fill=0) -> Tuple[np.ndarray, int]:
    """
    Pad ``axis`` up to a multiple of the mesh's size, so shards are equal
    (NaN for floats when ``fill`` is None). Returns the padded array and the
    original length.
    """
    n = x.shape[axis]
    target = int(-(-n // multiple) * multiple)
    if target == n:
        return x, n
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, target - n)
    if np.issubdtype(x.dtype, np.floating):
        out = np.pad(x, pads, constant_values=np.nan if fill is None else fill)
    else:
        out = np.pad(x, pads, constant_values=fill)
    return out, n


# ----------------------------------------------------------------------------
# The default mesh, scoped by use_mesh (as the reference's)
# ----------------------------------------------------------------------------

_default_mesh: Optional[DeviceMesh] = None


def set_default_mesh(mesh: Optional[DeviceMesh]) -> None:
    """Set (or clear, with None) the process-global default mesh."""
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh() -> Optional[DeviceMesh]:
    return _default_mesh


class use_mesh:
    """Context manager scoping the default mesh: ``preprocess_data`` and
    ``tracker`` entered inside run on it."""

    def __init__(self, mesh: Optional[DeviceMesh]):
        self.mesh = mesh
        self._prev: Optional[DeviceMesh] = None

    def __enter__(self):
        global _default_mesh
        self._prev = _default_mesh
        _default_mesh = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _default_mesh
        _default_mesh = self._prev
        return False


def resolve_mesh(mesh: Any, device: Any) -> Optional[DeviceMesh]:
    """The mesh an entry point runs on: ``mesh`` itself, a new mesh of
    ``device``'s type for True, the default mesh for None. The mesh's device
    type must be ``device``'s."""
    if mesh is None:
        mesh = _default_mesh
    elif mesh is True:
        mesh = make_mesh(device_type=torch.device(device).type)
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise ConfigurationError(
            f"mesh must be a DeviceMesh, True or None, got {type(mesh).__name__}",
            suggestions=["Build one with marex_tpu_torch.parallel.make_mesh()"],
        )
    if mesh.device_type != torch.device(device).type:
        raise ConfigurationError(
            f"The mesh is on '{mesh.device_type}' but the run asks for device '{device}'",
            suggestions=[f"Pass device='{mesh.device_type}', or build the mesh with device_type='{torch.device(device).type}'"],
        )
    if mesh.size() != dist.get_world_size():
        raise ConfigurationError(
            f"The mesh holds {mesh.size()} of the world's {dist.get_world_size()} processes",
            suggestions=["Build the mesh over every process (make_mesh)"],
        )
    return mesh
