"""
The few collectives that the detect and track stages need on a mesh.

Every rank of the mesh calls each of them, in the same order:

* :meth:`ShardComm.halo`: the slices (or rows) next to this rank's block
  along the sharded dim, from the ranks that hold them (``batch_isend_irecv``;
  fewer at the global ends, where there are none);
* :meth:`ShardComm.gather`: an all-gather of small host objects (per-slice
  counts, object areas, edge lists, the (time, ID) tables), in mesh order;
* :meth:`ShardComm.agree`: every rank's error or None; any error is raised
  on every rank, so a check that fails on one rank never leaves the others
  waiting in a collective (``gather`` carries the flag itself, ``halo``
  and ``broadcast`` share it first, and :meth:`ShardComm.guard` shares it
  when a stage ends);
* :meth:`ShardComm.send`, :meth:`ShardComm.recv_obj` and
  :meth:`ShardComm.recv_tensor`: one object and its tensors to or from one
  rank (the merge march's hand-over).

A rank's position is its index in the mesh's row-major order: rank ``i``
holds the ``i``-th block of a sharded dim (``mesh.detect_sharding`` and
``mesh.track_sharding`` split one dim over both mesh dims).
"""

from __future__ import annotations

import pickle
from contextlib import contextmanager
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import chunk_bounds, mesh_device


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as the collectives carry it (bool as uint8)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


class RemoteError(RuntimeError):
    """An error raised on another rank whose own class could not be rebuilt here."""


class ShardComm:
    """One process's view of a mesh: its position, its device, and the
    collectives over the mesh's ranks."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.ranks: List[int] = mesh.mesh.flatten().tolist()
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.device = mesh_device(mesh)
        # objects travel as byte tensors on the backend's device
        self._obj_device = self.device if mesh.device_type == "cuda" else torch.device("cpu")

    def bounds(self, n: int) -> Tuple[int, int]:
        """This rank's ``[start, stop)`` of a dim of length ``n``."""
        return chunk_bounds(n, self.size)[self.index]

    # -- neighbours ------------------------------------------------------

    def halo(self, x: torch.Tensor, dim: int, lo: int, hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """
        ``(before, after)``: the ``lo`` entries along ``dim`` just before this
        rank's block ``x`` and the ``hi`` just after it, in global order,
        from whichever ranks hold them (every block has ``x``'s length);
        fewer at the global start and end.
        """
        self.agree()
        n = x.shape[dim]
        start = self.index * n
        total = self.size * n
        ops = []
        parts = {"before": [], "after": []}
        for peer in range(self.size):
            if peer == self.index:
                continue
            p0 = peer * n
            # what I receive from peer: its share of [start - lo, start) and of [stop, stop + hi)
            for key, (a, b) in (("before", (max(start - lo, 0), start)), ("after", (start + n, min(start + n + hi, total)))):
                a, b = max(a, p0), min(b, p0 + n)
                if a < b:
                    shape = list(x.shape)
                    shape[dim] = b - a
                    buf = torch.empty(shape, dtype=x.dtype, device=x.device)
                    parts[key].append((a, buf))
                    ops.append(dist.P2POp(dist.irecv, _wire(buf), self.ranks[peer]))
            # what peer receives from me: my share of its [p0 - lo, p0) and [p0 + n, p0 + n + hi)
            for a, b in ((max(p0 - lo, 0), p0), (p0 + n, min(p0 + n + hi, total))):
                a, b = max(a, start), min(b, start + n)
                if a < b:
                    ops.append(dist.P2POp(dist.isend, _wire(x.narrow(dim, a - start, b - a).contiguous()),
                                          self.ranks[peer]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

        def joined(key: str) -> torch.Tensor:
            pieces = [buf for _, buf in sorted(parts[key], key=lambda p: p[0])]
            if not pieces:
                return x.narrow(dim, 0, 0)
            return torch.cat(pieces, dim=dim)

        return joined("before"), joined("after")

    # -- host objects ----------------------------------------------------

    def _exchange(self, error: Optional[BaseException], obj: Any) -> List[Any]:
        """All-gather of (error, obj) pairs in mesh order; when any rank
        has an error it is raised on every rank (a rank's own first)."""
        out: List[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(out, (None if error is None else portable_error(error), obj))
        pairs = [out[r] for r in self.ranks]
        first = error if error is not None else next((rebuilt_error(e) for e, _ in pairs if e is not None), None)
        if first is not None:
            first.shared_by_every_rank = True  # read by guard()
            raise first
        return [o for _, o in pairs]

    def gather(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in mesh order (and every rank's error flag:
        a rank that failed calls :meth:`agree` in its place)."""
        return self._exchange(None, obj)

    def agree(self, error: Optional[BaseException] = None) -> None:
        """Share each rank's error (or None): if any rank has one, every rank
        raises (its own, else the first in mesh order). Called before a
        collective that follows a check, and by a failed rank in place of
        its next collective, so that no rank is left waiting."""
        self._exchange(error, None)

    def broadcast(self, obj: Any, src_index: int) -> Any:
        """``obj`` of the rank at position ``src_index``, on every rank."""
        self.agree()
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[src_index], device=self._obj_device)
        return box[0]

    # -- point to point --------------------------------------------------

    def send(self, obj: Any, tensors: Sequence[torch.Tensor], dst_index: int) -> None:
        """``obj`` (pickled) then ``tensors`` to the rank at ``dst_index``;
        the receiver must know the tensors' shapes and dtypes from ``obj``."""
        dist.send_object_list([obj], dst=self.ranks[dst_index], device=self._obj_device)
        for t in tensors:
            dist.send(_wire(t.contiguous()), dst=self.ranks[dst_index])

    def recv_obj(self, src_index: int) -> Any:
        box = [None]
        dist.recv_object_list(box, src=self.ranks[src_index], device=self._obj_device)
        return box[0]

    def recv_tensor(self, shape: Sequence[int], dtype: torch.dtype, src_index: int) -> torch.Tensor:
        buf = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        dist.recv(_wire(buf), src=self.ranks[src_index])
        return buf

    @contextmanager
    def guard(self):
        """A stage on every rank: an error on one rank (outside the
        collectives) is raised on all of them when the stage ends or reaches
        its next collective, instead of leaving them waiting."""
        try:
            yield
        except Exception as e:
            if not getattr(e, "shared_by_every_rank", False):
                self.agree(e)
            raise
        self.agree()


def portable_error(error: BaseException) -> Any:
    """An error as it can travel: itself when it pickles, else its class
    name and message."""
    try:
        pickle.loads(pickle.dumps(error))
        return error
    except Exception:
        return (type(error).__name__, str(error))


def rebuilt_error(e: Any) -> BaseException:
    if isinstance(e, BaseException):
        return e
    name, msg = e
    return RemoteError(f"{name} on another rank: {msg}")
