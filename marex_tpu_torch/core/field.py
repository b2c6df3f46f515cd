"""
Lightweight labeled arrays for marex_tpu_torch.

The port of ``marex_tpu/core/field.py``: a thin :class:`Field`
(DataArray-analogue) and :class:`FieldSet` (Dataset-analogue) whose payloads
are ``numpy`` arrays, ``torch`` tensors, or lazy zarr arrays
(:class:`~marex_tpu_torch.io.zarr_lite.LazyZarrArray`, which read only the
chunks a slice touches). A tensor payload keeps its device, a lazy one stays
on disk until it is sliced or materialised; ``.values`` always returns host
numpy. A payload may also be a ``torch.distributed`` DTensor (the sharded
outputs of a run on a mesh): operations on it go through DTensor's own
dispatch (an operation DTensor cannot shard raises, naming it), and only
``.values``, ``compute()``, ``to_xarray()`` and ``io.zarr_lite.to_zarr``
gather it whole (``full_tensor()``, a collective that every rank of the
mesh must call). :func:`from_reference` carries a ``marex_tpu`` Field/FieldSet across
(duck-typed, so this module never imports ``marex_tpu`` or ``jax``).

Design rules:
  * no lazy graphs — compute runs eagerly through the ops modules (a lazy
    zarr payload is storage, not a graph);
  * ``.persist()/.compute()/.chunk()`` exist as no-op compatibility shims so
    scripts written against the reference API keep working;
  * coords are 1-D (or small N-D) host numpy arrays; bulk data may live on
    device.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd
import torch

from ..exceptions import DataValidationError

ArrayLike = Any  # np.ndarray | torch.Tensor


def _is_torch(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor (the sharded payload of a mesh run)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def gathered(x: Any) -> Any:
    """``x`` whole on this rank: a DTensor's ``full_tensor()`` (a collective:
    every rank of its mesh calls it), anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def _asnumpy(x: Any) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return gathered(x).detach().cpu().numpy()
    return np.asarray(x)


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or of a torch dtype, itself)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _astype(x: ArrayLike, dtype) -> ArrayLike:
    """``x.astype(dtype)`` for numpy or torch payloads (``dtype`` is a numpy
    dtype; a tensor keeps its device)."""
    if isinstance(x, torch.Tensor):
        return x.to(_torch_dtype(dtype))
    return x.astype(dtype)


def _np_dtype(x: Any) -> np.dtype:
    """The numpy dtype of a payload or scalar (a tensor's as numpy names it)."""
    if isinstance(x, torch.Tensor):
        return torch.empty(0, dtype=x.dtype).numpy().dtype
    return np.dtype(x.dtype)


def _as_tensor(x: Any) -> torch.Tensor:
    """A payload as a tensor: a tensor as it is, anything else on the host
    (datetimes and time deltas as their int64 counts)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.kind in "mM":
        a = a.view(np.int64)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    return torch.from_numpy(a)


def _like(t: torch.Tensor, *payloads: Any) -> ArrayLike:
    """A result in the kind of its payloads: a tensor where one was a tensor,
    host numpy otherwise."""
    if any(isinstance(p, torch.Tensor) for p in payloads):
        return t
    return t.numpy()


def _device(*payloads: Any) -> torch.device:
    """The device of the first tensor among ``payloads``; the host otherwise."""
    for p in payloads:
        if isinstance(p, torch.Tensor):
            return p.device
    return torch.device("cpu")


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, list, tuple)) or hasattr(x, "dtype")


def _operand(x: Any, device: torch.device, dtype: Optional[torch.dtype]) -> Any:
    """An operand for a torch op: an array-like as a tensor on ``device`` in
    ``dtype``; a Python scalar (or None) as it is."""
    if not _is_array(x):
        return x
    t = _as_tensor(x).to(device)
    return t if dtype is None else t.to(dtype)


def _numpy_dtype_of(fn: Callable, *args: Any) -> Optional[np.dtype]:
    """The dtype numpy gives ``fn(*args)``, found on one-element stand-ins of
    the array arguments (Python scalars stay weak, as in numpy); None where
    numpy refuses the operation."""
    probes = [np.ones(1, dtype=_np_dtype(np.asarray(a) if isinstance(a, (list, tuple)) else a)) if _is_array(a) else a
              for a in args]
    try:
        with np.errstate(all="ignore"):
            return np.asarray(fn(*probes)).dtype
    except (TypeError, ValueError):
        return None


def _apply(np_fn: Callable, *args: Any, torch_fn: Optional[Callable] = None) -> ArrayLike:
    """``torch_fn`` (default ``np_fn``, for operators) over numpy-or-torch
    arguments, in torch on the device of the first tensor among them, with
    the result dtype that numpy gives ``np_fn``: each array operand is cast to
    it first (to numpy's common dtype where the result is a bool). The
    result is a tensor where an argument was one, host numpy otherwise."""
    dt = _numpy_dtype_of(np_fn, *args)
    if dt is not None and dt == np.bool_:
        dt = _numpy_dtype_of(lambda *a: np.result_type(*[v for v in a if v is not None]), *args)
    tdt = _torch_dtype(dt) if dt is not None and dt.kind in "biuf" else None
    dev = _device(*args)
    res = (torch_fn or np_fn)(*[_operand(a, dev, tdt) for a in args])
    return _like(res, *args)


class Coord:
    """A named coordinate: values along one or more dims (host numpy)."""

    __slots__ = ("dims", "values")

    def __init__(self, dims: Union[str, Tuple[str, ...]], values: ArrayLike):
        if isinstance(dims, str):
            dims = (dims,)
        self.dims = tuple(dims)
        self.values = _asnumpy(values)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Coord(dims={self.dims}, shape={self.values.shape}, dtype={self.values.dtype})"

    def isel(self, indexers: Mapping[str, Any]) -> "Coord":
        idx = tuple(indexers.get(d, slice(None)) for d in self.dims)
        vals = self.values[idx]
        # Drop dims that were integer-indexed
        new_dims = tuple(d for d, i in zip(self.dims, idx) if not np.isscalar(i) and not isinstance(i, int))
        return Coord(new_dims, vals) if new_dims else Coord((), vals)


def _normalize_coords(coords: Optional[Mapping[str, Any]], dims: Tuple[str, ...], shape: Tuple[int, ...]) -> Dict[str, Coord]:
    out: Dict[str, Coord] = {}
    if not coords:
        return out
    sizes = dict(zip(dims, shape))
    for name, val in coords.items():
        if isinstance(val, Coord):
            out[name] = val
        elif isinstance(val, Field):
            out[name] = Coord(val.dims, val.values)
        elif isinstance(val, tuple) and len(val) == 2 and isinstance(val[0], (str, tuple, list)):
            out[name] = Coord(tuple(val[0]) if not isinstance(val[0], str) else val[0], val[1])
        else:
            arr = _asnumpy(val)
            if arr.ndim == 0:
                out[name] = Coord((), arr)
            elif name in sizes and arr.shape == (sizes[name],):
                out[name] = Coord(name, arr)
            else:
                # try match by length against dims
                matched = [d for d in dims if sizes[d] == arr.shape[0]] if arr.ndim == 1 else []
                if arr.ndim == 1 and name in dims:
                    out[name] = Coord(name, arr)
                elif len(matched) == 1:
                    out[name] = Coord(matched[0], arr)
                else:
                    raise DataValidationError(
                        f"Cannot infer dims for coordinate '{name}'",
                        details=f"coord shape {arr.shape} vs dims {sizes}",
                        suggestions=["Pass coords as {'name': (dims, values)}"],
                    )
    # xarray parity: an index coordinate whose length conflicts with the
    # data's dimension size is an error, not a silent mismatch (a broadcast
    # bug upstream otherwise propagates a collapsed axis all the way into
    # detect/track outputs before anything notices).
    for name, c in out.items():
        for d, n in zip(c.dims, c.values.shape):
            if d in sizes and sizes[d] != n:
                raise DataValidationError(
                    f"conflicting sizes for dimension '{d}': coordinate '{name}' has length {n} "
                    f"but the data has size {sizes[d]} along '{d}'",
                    data_info={"coord": name, "coord_shape": tuple(c.values.shape), "dim_sizes": sizes},
                    suggestions=[
                        "Check that the data array actually varies along this dimension "
                        "(a pure-broadcast construction can silently collapse an axis to length 1)",
                        "Pass coordinate values whose length matches the data shape",
                    ],
                )
    return out


class _DtAccessor:
    """Pandas-backed datetime accessor for a 1-D time coordinate."""

    def __init__(self, field: "Field"):
        self._field = field
        self._index = pd.DatetimeIndex(field.values)

    def _wrap(self, values: np.ndarray) -> "Field":
        f = self._field
        return Field(np.asarray(values), dims=f.dims, coords=f.coords, name=f.name)

    @property
    def year(self) -> "Field":
        return self._wrap(self._index.year.to_numpy())

    @property
    def month(self) -> "Field":
        return self._wrap(self._index.month.to_numpy())

    @property
    def day(self) -> "Field":
        return self._wrap(self._index.day.to_numpy())

    @property
    def dayofyear(self) -> "Field":
        return self._wrap(self._index.dayofyear.to_numpy())


class Field:
    """
    A named, dimension-labeled array.

    Parameters
    ----------
    data : numpy array or torch tensor
    dims : sequence of str
    coords : mapping, optional
        name -> values | (dims, values) | Coord | Field
    name : str, optional
    attrs : dict, optional
    """

    __slots__ = ("data", "dims", "coords", "name", "attrs")

    def __init__(
        self,
        data: ArrayLike,
        dims: Sequence[str],
        coords: Optional[Mapping[str, Any]] = None,
        name: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        if np.isscalar(data) or (not _is_torch(data) and hasattr(data, "ndim") and data.ndim == 0):
            data = np.asarray(data)
        self.data = data
        self.dims = tuple(dims)
        if len(self.dims) != data.ndim:
            raise DataValidationError(
                f"dims {self.dims} do not match array rank {data.ndim}",
                data_info={"dims": self.dims, "shape": tuple(data.shape)},
            )
        self.coords = _normalize_coords(coords, self.dims, tuple(data.shape))
        self.name = name
        self.attrs = dict(attrs) if attrs else {}

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.dims, self.shape))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def values(self) -> np.ndarray:
        """The payload as host numpy; a DTensor is gathered whole, which
        every rank of its mesh must call."""
        return _asnumpy(self.data)

    @property
    def dt(self) -> _DtAccessor:
        return _DtAccessor(self)

    def item(self):
        return self.values.item()

    def __len__(self) -> int:
        return self.shape[0]

    def __repr__(self) -> str:  # pragma: no cover
        coord_names = ", ".join(self.coords)
        return (
            f"<marex_tpu_torch.Field {self.name or ''}{self.sizes} dtype={self.dtype} "
            f"coords=[{coord_names}] backend={'torch' if _is_torch(self.data) else 'numpy'}>"
        )

    # ------------------------------------------------------------------
    # compatibility shims (no task graph in this framework)
    # ------------------------------------------------------------------
    def persist(self) -> "Field":
        return self

    def compute(self) -> "Field":
        """The Field with a host numpy payload (a tensor copied back, a lazy
        zarr payload read)."""
        if isinstance(self.data, np.ndarray):
            return self
        return self._replace(data=_asnumpy(self.data))

    def load(self) -> "Field":
        return self.compute()

    def chunk(self, *args: Any, **kwargs: Any) -> "Field":
        return self

    @property
    def chunks(self):
        # Single-chunk semantics: one chunk per dim
        return tuple((s,) for s in self.shape)

    @property
    def chunksizes(self) -> Dict[str, Tuple[int, ...]]:
        return {d: (s,) for d, s in self.sizes.items()}

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    def _replace(
        self,
        data: Optional[ArrayLike] = None,
        dims: Optional[Sequence[str]] = None,
        coords: Optional[Mapping[str, Any]] = None,
        name: Optional[str] = None,
    ) -> "Field":
        return Field(
            self.data if data is None else data,
            self.dims if dims is None else tuple(dims),
            self.coords if coords is None else coords,
            self.name if name is None else name,
            self.attrs,
        )

    def rename(self, name: Union[str, Mapping[str, str], None] = None, **dim_renames: str) -> "Field":
        if isinstance(name, str) or name is None and not dim_renames:
            return self._replace(name=name)
        mapping = dict(name) if isinstance(name, Mapping) else {}
        mapping.update(dim_renames)
        new_dims = tuple(mapping.get(d, d) for d in self.dims)
        new_coords = {
            mapping.get(k, k): Coord(tuple(mapping.get(d, d) for d in c.dims), c.values) for k, c in self.coords.items()
        }
        return Field(self.data, new_dims, new_coords, self.name, self.attrs)

    def copy(self) -> "Field":
        data = self.data.clone() if _is_torch(self.data) else np.array(self.data, copy=True)
        return Field(data, self.dims, dict(self.coords), self.name, dict(self.attrs))

    def astype(self, dtype) -> "Field":
        return self._replace(data=_astype(self.data, dtype))

    def assign_coords(self, coords: Optional[Mapping[str, Any]] = None, **kw: Any) -> "Field":
        new = dict(self.coords)
        merged = dict(coords or {})
        merged.update(kw)
        new.update(_normalize_coords(merged, self.dims, self.shape))
        return Field(self.data, self.dims, new, self.name, self.attrs)

    def drop_vars(self, names: Union[str, Iterable[str]], errors: str = "ignore") -> "Field":
        if isinstance(names, str):
            names = [names]
        new = {k: v for k, v in self.coords.items() if k not in set(names)}
        return Field(self.data, self.dims, new, self.name, self.attrs)

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def isel(self, indexers: Optional[Mapping[str, Any]] = None, **kw: Any) -> "Field":
        idxs = dict(indexers or {})
        idxs.update(kw)
        # Normalize Field/array indexers to numpy
        norm: Dict[str, Any] = {}
        for d, i in idxs.items():
            if d not in self.dims:
                continue
            if isinstance(i, Field):
                i = i.values
            if isinstance(i, (list, np.ndarray)) and np.asarray(i).dtype == bool:
                i = np.nonzero(np.asarray(i))[0]
            norm[d] = i
        index = tuple(norm.get(d, slice(None)) for d in self.dims)
        data = self.data[index]
        dropped = {d for d, i in norm.items() if isinstance(i, (int, np.integer))}
        new_dims = tuple(d for d in self.dims if d not in dropped)
        new_coords: Dict[str, Coord] = {}
        for cname, c in self.coords.items():
            if not set(c.dims) & set(norm.keys()):
                if not set(c.dims) & dropped:
                    new_coords[cname] = c
                continue
            sub = c.isel(norm)
            new_coords[cname] = sub
        return Field(data, new_dims, new_coords, self.name, self.attrs)

    def sel(self, indexers: Optional[Mapping[str, Any]] = None, method: Optional[str] = None, **kw: Any) -> "Field":
        """Select by coordinate label: a label, a list of labels, or a slice
        of labels (both ends included); ``method="nearest"`` takes the
        closest label where a scalar label is missing."""
        idxs = dict(indexers or {})
        idxs.update(kw)
        pos: Dict[str, Any] = {}
        for d, label in idxs.items():
            coord = self.coords.get(d)
            if coord is None or coord.dims != (d,):
                raise DataValidationError(f"No 1-D index coordinate for dim '{d}'")
            cv = coord.values
            if isinstance(label, slice):
                lo = 0 if label.start is None else int(np.searchsorted(cv, np.asarray(label.start, dtype=cv.dtype), "left"))
                hi = len(cv) if label.stop is None else int(np.searchsorted(cv, np.asarray(label.stop, dtype=cv.dtype), "right"))
                pos[d] = slice(lo, hi)
                continue
            lab = np.asarray(label)
            if lab.ndim == 0:
                matches = np.nonzero(cv == lab)[0]
                if len(matches):
                    pos[d] = int(matches[0])
                elif method == "nearest":
                    pos[d] = int(np.argmin(np.abs(cv.astype("f8") - float(lab))))
                else:
                    raise KeyError(label)
            else:
                sorter = np.argsort(cv)
                taken = sorter[np.clip(np.searchsorted(cv, lab, sorter=sorter), 0, len(cv) - 1)]
                missing = cv[taken] != lab
                if missing.any():
                    raise KeyError(list(lab[missing]))
                pos[d] = taken
        return self.isel(pos)

    def squeeze(self, dim: Optional[str] = None) -> "Field":
        """Drop ``dim`` (every dim without one) where its size is 1."""
        if dim is not None:
            return self.isel({dim: 0}) if self.sizes[dim] == 1 else self
        out = self
        for d in list(out.dims):
            if out.sizes[d] == 1:
                out = out.isel({d: 0})
        return out

    def transpose(self, *dims: str) -> "Field":
        if not dims:
            dims = tuple(reversed(self.dims))
        if Ellipsis in dims:
            named = [d for d in dims if d is not Ellipsis]
            rest = [d for d in self.dims if d not in named]
            i = dims.index(Ellipsis)
            dims = tuple(named[:i] + rest + named[i:])
        axes = [self.dims.index(d) for d in dims]
        if sorted(axes) != list(range(self.ndim)):
            raise ValueError(f"transpose needs a permutation of {self.dims}, got {dims}")
        if axes == list(range(self.ndim)):
            return Field(self.data, dims, self.coords, self.name, self.attrs)
        if _is_torch(self.data):
            data = self.data.permute(*axes).contiguous()
        else:
            data = np.transpose(self.data, axes)
        return Field(data, dims, self.coords, self.name, self.attrs)

    def expand_dims(self, dim: Union[str, Mapping[str, int]]) -> "Field":
        """Prepend new dims of the given sizes (broadcasting the data)."""
        if isinstance(dim, str):
            dim = {dim: 1}
        out = self
        for d, n in dim.items():
            x = _as_tensor(out.data)
            data = _like(x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous(), out.data)
            out = Field(data, (d,) + out.dims, out.coords, out.name, out.attrs)
        return out

    def broadcast_like(self, other: "Field") -> "Field":
        a, _ = broadcast(self, other)
        return a

    def stack_spatial(self, dims: Sequence[str], new_dim: str = "space") -> "Field":
        """Flatten the trailing spatial dims into one (device-layout helper)."""
        axes = [self.dims.index(d) for d in dims]
        if axes != sorted(axes) or axes[-1] != self.ndim - 1:
            raise DataValidationError("stack_spatial requires trailing contiguous dims")
        lead = self.shape[: axes[0]]
        data = self.data.reshape(lead + (-1,))
        return Field(data, self.dims[: axes[0]] + (new_dim,), {}, self.name, self.attrs)

    # ------------------------------------------------------------------
    # arithmetic / comparisons (dim-aligned broadcasting), in torch on the
    # payload's device, with numpy's result dtypes
    # ------------------------------------------------------------------
    def _binop(self, other: Any, op: Callable, reflexive: bool = False) -> "Field":
        if isinstance(other, Field):
            a, b = broadcast(self, other)
            x, y, dims, coords = a.data, b.data, a.dims, a.coords
        else:
            x, y, dims, coords = self.data, other, self.dims, self.coords
        if reflexive:
            x, y = y, x
        return Field(_apply(op, x, y), dims, coords, self.name, self.attrs)

    def __add__(self, o): return self._binop(o, operator.add)
    def __radd__(self, o): return self._binop(o, operator.add, True)
    def __sub__(self, o): return self._binop(o, operator.sub)
    def __rsub__(self, o): return self._binop(o, operator.sub, True)
    def __mul__(self, o): return self._binop(o, operator.mul)
    def __rmul__(self, o): return self._binop(o, operator.mul, True)
    def __truediv__(self, o): return self._binop(o, operator.truediv)
    def __rtruediv__(self, o): return self._binop(o, operator.truediv, True)
    def __pow__(self, o): return self._binop(o, operator.pow)
    def __ge__(self, o): return self._binop(o, operator.ge)
    def __gt__(self, o): return self._binop(o, operator.gt)
    def __le__(self, o): return self._binop(o, operator.le)
    def __lt__(self, o): return self._binop(o, operator.lt)
    def __eq__(self, o): return self._binop(o, operator.eq)  # type: ignore[override]
    def __ne__(self, o): return self._binop(o, operator.ne)  # type: ignore[override]
    def __and__(self, o): return self._binop(o, operator.and_)
    def __or__(self, o): return self._binop(o, operator.or_)
    def __invert__(self): return self._replace(data=_like(~_as_tensor(self.data), self.data))
    def __neg__(self): return self._replace(data=_like(-_as_tensor(self.data), self.data))

    __hash__ = object.__hash__

    # ------------------------------------------------------------------
    # reductions, in torch on the payload's device (numpy's result dtypes;
    # floats skip NaN where numpy's nan-functions would)
    # ------------------------------------------------------------------
    def _reduce(self, fn: Callable, dim: Union[str, Sequence[str], None] = None) -> "Field":
        """``fn(x, dims)`` over the named dims (all with None): ``x`` is the
        payload as a tensor with the reduced axes moved last and flattened
        into one, so every ``fn`` reduces its last axis."""
        if dim is None:
            dim = list(self.dims)
        elif isinstance(dim, str):
            dim = [dim]
        axes = [self.dims.index(d) for d in dim]
        keep = [i for i in range(self.ndim) if i not in axes]
        x = _as_tensor(self.data)
        x = x.permute(*keep, *axes).reshape([x.shape[i] for i in keep] + [-1])
        new_dims = tuple(self.dims[i] for i in keep)
        coords = {k: c for k, c in self.coords.items() if set(c.dims) <= set(new_dims)}
        return Field(_like(fn(x), self.data), new_dims, coords, self.name, self.attrs)

    def _is_float(self) -> bool:
        return _np_dtype(self.data).kind == "f"

    def sum(self, dim=None, skipna: bool = False):
        nan = skipna and self._is_float()
        return self._reduce(lambda x: x.nansum(-1) if nan else x.sum(-1), dim)

    def mean(self, dim=None, skipna: bool = True):
        if not self._is_float():
            return self._reduce(lambda x: x.double().mean(-1), dim)
        return self._reduce(lambda x: x.nanmean(-1) if skipna else x.mean(-1), dim)

    def std(self, dim=None):
        if not self._is_float():
            return self._reduce(lambda x: x.double().std(-1, correction=0), dim)

        def nanstd(x):
            finite = ~torch.isnan(x)
            dev = torch.where(finite, x - x.nanmean(-1, keepdim=True), 0)
            return ((dev * dev).sum(-1) / finite.sum(-1)).sqrt()

        return self._reduce(nanstd, dim)

    def _extreme(self, dim, largest: bool):
        if _np_dtype(self.data) == np.bool_:
            return self._reduce(lambda x: x.any(-1) if largest else x.all(-1), dim)
        if not self._is_float():
            return self._reduce(lambda x: x.amax(-1) if largest else x.amin(-1), dim)

        def nan_extreme(x):
            isnan = torch.isnan(x)
            fill = float("-inf") if largest else float("inf")
            r = x.masked_fill(isnan, fill)
            r = r.amax(-1) if largest else r.amin(-1)
            return r.masked_fill(isnan.all(-1), float("nan"))

        return self._reduce(nan_extreme, dim)

    def max(self, dim=None):
        return self._extreme(dim, True)

    def min(self, dim=None):
        return self._extreme(dim, False)

    def any(self, dim=None):
        return self._reduce(lambda x: x.any(-1), dim)

    def all(self, dim=None):
        return self._reduce(lambda x: x.all(-1), dim)

    def count(self, dim=None):
        """Finite values (every value of a non-float payload) along ``dim``;
        the result carries no name or attrs, as in the reference."""
        return Field(isfinite(self).data, self.dims, self.coords)._reduce(lambda x: x.sum(-1), dim)

    def argmax(self, dim: Optional[str] = None) -> "Field":
        """Index of the largest value (of the first NaN where there is one)
        along ``dim``, or into the flattened payload with None."""
        return self._reduce(lambda x: (x.byte() if x.dtype == torch.bool else x).argmax(-1), dim)

    def quantile(self, q: float, dim: Union[str, Sequence[str], None] = None) -> "Field":
        """``np.nanquantile``'s linear method: NaN are left out, and an
        all-NaN selection gives NaN; float64 for integer payloads."""
        out_dtype = torch.float64 if not self._is_float() else None

        def nanquantile(x):
            v, _ = torch.sort(x.double(), dim=-1)  # NaN sort last
            n = (~torch.isnan(v)).sum(-1, keepdim=True)
            pos = q * (n - 1).clamp_min(0).double()
            lo = pos.floor().long()
            hi = (lo + 1).clamp_max((n - 1).clamp_min(0))
            a, b = v.gather(-1, lo), v.gather(-1, hi)
            g = pos - lo
            r = torch.where(g >= 0.5, b - (b - a) * (1 - g), a + (b - a) * g).squeeze(-1)
            r = r.masked_fill(n.squeeze(-1) == 0, float("nan"))
            return r.to(out_dtype or x.dtype)

        return self._reduce(nanquantile, dim)

    # ------------------------------------------------------------------
    # masking / selection utilities
    # ------------------------------------------------------------------
    def where(self, cond: Union["Field", ArrayLike], other: Any = np.nan, drop: bool = False) -> "Field":
        """This field where ``cond`` holds, ``other`` elsewhere (aligned by
        dims when ``cond`` is a Field); ``drop`` keeps only the selected
        entries of a 1-D field."""
        cond_f = cond if isinstance(cond, Field) else Field(cond, self.dims)
        a, c = broadcast(self, cond_f)
        if isinstance(other, Field):
            other = other.data
        mask = _as_tensor(c.data).to(_device(a.data, other)).bool()
        data = _apply(lambda x, o: np.where(True, x, o), a.data, other, torch_fn=lambda x, o: torch.where(mask, x, o))
        res = Field(data, a.dims, a.coords, self.name, self.attrs)
        if drop and res.ndim == 1:
            return res.isel({res.dims[0]: mask.nonzero().squeeze(1).cpu().numpy()})
        return res

    def isin(self, values: Any) -> "Field":
        vals = values.data if isinstance(values, Field) else np.asarray(values)
        return self._replace(data=_apply(np.isin, self.data, vals, torch_fn=torch.isin))

    def isnull(self) -> "Field":
        x = _as_tensor(self.data)
        return self._replace(data=_like(torch.isnan(x) if self._is_float() else torch.zeros_like(x, dtype=torch.bool),
                                        self.data))

    def notnull(self) -> "Field":
        return ~self.isnull()

    def fillna(self, value: Any) -> "Field":
        x = _as_tensor(self.data)
        return self._replace(data=_like(x.masked_fill(torch.isnan(x), value) if self._is_float() else x.clone(),
                                        self.data))

    def clip(self, lo=None, hi=None) -> "Field":
        return self._replace(data=_apply(np.clip, self.data, lo, hi, torch_fn=torch.clamp))

    def shift(self, shifts: Optional[Mapping[str, int]] = None, fill_value: Any = np.nan, **kw: int) -> "Field":
        """Shift along dims by whole steps, ``fill_value`` shifted in."""
        sh = dict(shifts or {})
        sh.update(kw)
        out = _as_tensor(self.data).clone()
        for d, n in sh.items():
            if n == 0:
                continue
            ax = self.dims.index(d)
            out = torch.roll(out, n, dims=ax)
            width = min(abs(n), out.shape[ax])  # a shift past the axis fills all of it
            out.narrow(ax, 0 if n > 0 else out.shape[ax] - width, width).fill_(fill_value)
        return self._replace(data=_like(out, self.data))

    def pad_dim(self, dim: str, width: int, mode: str = "constant", constant_values: Any = 0) -> "Field":
        """Pad ``dim`` by ``width`` at both ends in one of ``np.pad``'s modes
        constant, edge, wrap, reflect or symmetric; coordinates along it go."""
        ax = self.dims.index(dim)
        x = _as_tensor(self.data)
        n = x.shape[ax]
        i = np.arange(-width, n + width)
        if mode == "constant":
            shape = list(x.shape)
            shape[ax] = n + 2 * width
            out = torch.full(shape, constant_values, dtype=x.dtype, device=x.device)
            out.narrow(ax, width, n).copy_(x)
        else:
            if mode == "edge":
                src = np.clip(i, 0, n - 1)
            elif mode == "wrap":
                src = i % n
            elif mode in ("reflect", "symmetric"):
                period = 2 * n - 2 if mode == "reflect" else 2 * n
                src = np.abs(i) if mode == "reflect" else np.where(i < 0, -i - 1, i)
                src = src % max(period, 1)
                src = np.where(src >= n, period - src - (mode == "symmetric"), src)
            else:
                raise ValueError(f"pad_dim: unsupported mode {mode!r}")
            out = x.index_select(ax, torch.from_numpy(src).to(x.device))
        coords = {k: c for k, c in self.coords.items() if dim not in c.dims}
        return Field(_like(out, self.data), self.dims, coords, self.name, self.attrs)

    # ------------------------------------------------------------------
    # interop
    # ------------------------------------------------------------------
    def to_xarray(self):
        """Convert to an xarray.DataArray (requires xarray); a DTensor
        payload is gathered, which every rank of its mesh must call."""
        from .._dependencies import require_dependencies

        require_dependencies(["xarray"], "Field.to_xarray")
        import xarray as xr

        coords = {k: (c.dims, c.values) for k, c in self.coords.items()}
        return xr.DataArray(self.values, dims=self.dims, coords=coords, name=self.name, attrs=self.attrs)

    def to(self, device: Union[str, torch.device]) -> "Field":
        """The Field with its payload as a tensor on ``device``."""
        return self._replace(data=on_device(self.data, device).to(device))

    def to_device(self, device: Union[str, torch.device] = "cuda") -> "Field":
        """Move the payload to the card (to ``device``)."""
        return self.to(device)

    @property
    def plotX(self):
        """The plotting accessor: ``field.plotX()`` is a plotter, and
        ``field.plotX.single_plot(config)`` draws (:mod:`marex_tpu_torch.plotX`,
        imported here at first use; drawing needs matplotlib)."""
        from ..plotX import PlotXAccessor

        return PlotXAccessor(self)


def on_device(data: ArrayLike, device: Union[str, torch.device]) -> torch.Tensor:
    """``data`` as a tensor: a tensor (a DTensor too) keeps its own device,
    anything else (numpy, or a lazy zarr payload, which is read whole here)
    is copied to ``device``."""
    if isinstance(data, torch.Tensor):
        return data
    return torch.tensor(np.asarray(data), device=device)


def broadcast(a: Field, b: Field) -> Tuple[Field, Field]:
    """Align two Fields over the union of their dims (xarray-style); the
    payloads are expanded views, tensors on the first tensor payload's
    device where either is a tensor."""
    out_dims = list(a.dims) + [d for d in b.dims if d not in a.dims]
    sizes: Dict[str, int] = {}
    for f in (a, b):
        for d, s in f.sizes.items():
            if d in sizes and sizes[d] != s:
                raise DataValidationError(
                    f"Dimension size mismatch for '{d}': {sizes[d]} vs {s}",
                    data_info={"a_dims": a.sizes, "b_dims": b.sizes},
                )
            sizes[d] = s
    dev = _device(a.data, b.data)

    def _expand(f: Field) -> ArrayLike:
        # reorder to the output dim order, insert missing axes, broadcast
        x = _as_tensor(f.data).to(dev)
        x = x.permute(*[f.dims.index(d) for d in out_dims if d in f.dims])
        x = x.reshape([sizes[d] if d in f.dims else 1 for d in out_dims])
        return _like(x.expand([sizes[d] for d in out_dims]), a.data, b.data)

    coords: Dict[str, Coord] = {}
    coords.update(b.coords)
    coords.update(a.coords)
    return Field(_expand(a), out_dims, coords, a.name, a.attrs), Field(_expand(b), out_dims, coords, b.name, b.attrs)


def full_like(f: Field, fill: Any, dtype=None) -> Field:
    """A Field like ``f`` filled with ``fill`` (in ``dtype``, a numpy dtype,
    else ``f``'s), on ``f``'s device."""
    if isinstance(f.data, torch.Tensor):
        dt = f.data.dtype if dtype is None else _torch_dtype(dtype)
        return f._replace(data=torch.full(f.shape, fill, dtype=dt, device=f.data.device))
    return f._replace(data=np.full(f.shape, fill, dtype=dtype or f.dtype))


def ones_like(f: Field, dtype=None) -> Field:
    return full_like(f, 1, dtype)


def zeros_like(f: Field, dtype=None) -> Field:
    return full_like(f, 0, dtype)


def isfinite(f: Field) -> Field:
    """Where ``f`` is finite (everywhere for a non-float payload)."""
    x = _as_tensor(f.data)
    return f._replace(data=_like(torch.isfinite(x) if f._is_float() else torch.ones_like(x, dtype=torch.bool), f.data))


def concat(fields: Sequence[Field], dim: str) -> Field:
    """
    Concatenate fields along ``dim`` (created as a new leading dim when the
    fields lack it), with the first field's other coords, name and attrs.
    Tensor payloads are joined on their device when all are tensors;
    anything else is joined on the host.
    """
    if not fields:
        raise ValueError("concat needs at least one field")
    first = fields[0]
    new_dim = dim not in first.dims
    ax = 0 if new_dim else first.dims.index(dim)
    if all(_is_torch(f.data) for f in fields):
        parts = [f.data.unsqueeze(0) if new_dim else f.data for f in fields]
        data = torch.cat(parts, dim=ax)
    else:
        parts = [_asnumpy(f.data)[None] if new_dim else _asnumpy(f.data) for f in fields]
        data = np.concatenate(parts, axis=ax)
    dims = ((dim,) + first.dims) if new_dim else first.dims
    coords = {k: c for k, c in first.coords.items() if dim not in c.dims}
    return Field(data, dims, coords, first.name, first.attrs)


class FieldSet:
    """
    Dataset-analogue: named Fields sharing dims/coords + global attrs.
    """

    def __init__(
        self,
        data_vars: Optional[Mapping[str, Field]] = None,
        coords: Optional[Mapping[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.data_vars: Dict[str, Field] = dict(data_vars or {})
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.coords: Dict[str, Coord] = {}
        if coords:
            for k, v in coords.items():
                if isinstance(v, Coord):
                    self.coords[k] = v
                elif isinstance(v, Field):
                    self.coords[k] = Coord(v.dims, v.values)
                elif isinstance(v, tuple) and len(v) == 2:
                    self.coords[k] = Coord(v[0], v[1])
                else:
                    self.coords[k] = Coord(k, _asnumpy(v))
        # absorb variable coords
        for f in self.data_vars.values():
            for k, c in f.coords.items():
                self.coords.setdefault(k, c)

    # Mapping-ish interface ------------------------------------------------
    def __getitem__(self, key: str) -> Field:
        if key in self.data_vars:
            return self.data_vars[key]
        if key in self.coords:
            c = self.coords[key]
            return Field(c.values, c.dims, {key: c} if c.dims == (key,) else {}, name=key)
        raise KeyError(key)

    def __setitem__(self, key: str, value: Field) -> None:
        self.data_vars[key] = value
        for k, c in value.coords.items():
            self.coords.setdefault(k, c)

    def __contains__(self, key: str) -> bool:
        return key in self.data_vars

    def __getattr__(self, key: str) -> Field:
        if "data_vars" not in self.__dict__:  # not set up yet, as while unpickling
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __iter__(self):
        return iter(self.data_vars)

    def keys(self):
        return self.data_vars.keys()

    @property
    def dims(self) -> Dict[str, int]:
        return self.sizes

    @property
    def sizes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.data_vars.values():
            out.update(f.sizes)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        lines = [f"<marex_tpu_torch.FieldSet dims={self.sizes}>"]
        for k, f in self.data_vars.items():
            lines.append(f"  {k:<18} {f.dims} {f.dtype}")
        return "\n".join(lines)

    # xarray-compat no-ops -------------------------------------------------
    def persist(self, **kw: Any) -> "FieldSet":
        return self

    def compute(self) -> "FieldSet":
        return FieldSet({k: v.compute() for k, v in self.data_vars.items()}, self.coords, self.attrs)

    def chunk(self, *a: Any, **kw: Any) -> "FieldSet":
        return self

    # transforms -----------------------------------------------------------
    def isel(self, indexers: Optional[Mapping[str, Any]] = None, **kw: Any) -> "FieldSet":
        idxs = dict(indexers or {})
        idxs.update(kw)
        new_vars = {}
        for k, f in self.data_vars.items():
            sub = {d: i for d, i in idxs.items() if d in f.dims}
            new_vars[k] = f.isel(sub) if sub else f
        new_coords = {}
        for k, c in self.coords.items():
            sub = {d: i for d, i in idxs.items() if d in c.dims}
            new_coords[k] = c.isel(sub) if sub else c
        return FieldSet(new_vars, new_coords, self.attrs)

    def assign_coords(self, coords: Optional[Mapping[str, Any]] = None, **kw: Any) -> "FieldSet":
        merged = dict(coords or {})
        merged.update(kw)
        out = FieldSet(self.data_vars, self.coords, self.attrs)
        for k, v in merged.items():
            if isinstance(v, Field):
                out.coords[k] = Coord(v.dims, v.values)
            elif isinstance(v, tuple) and len(v) == 2:
                out.coords[k] = Coord(v[0], v[1])
            else:
                out.coords[k] = Coord(k, _asnumpy(v))
        return out

    def drop_vars(self, names: Union[str, Iterable[str]], errors: str = "ignore") -> "FieldSet":
        if isinstance(names, str):
            names = [names]
        names = set(names)
        return FieldSet(
            {k: v for k, v in self.data_vars.items() if k not in names},
            {k: c for k, c in self.coords.items() if k not in names},
            self.attrs,
        )

    def to_xarray(self):
        """Convert to an xarray.Dataset (requires xarray)."""
        from .._dependencies import require_dependencies

        require_dependencies(["xarray"], "FieldSet.to_xarray")
        import xarray as xr

        return xr.Dataset(
            {k: v.to_xarray() for k, v in self.data_vars.items()},
            coords={k: (c.dims, c.values) for k, c in self.coords.items()},
            attrs=self.attrs,
        )

def from_xarray(obj: Any) -> Union[Field, FieldSet]:
    """Adapt an xarray DataArray/Dataset (or duck-typed equivalent)."""
    if hasattr(obj, "data_vars"):
        coords = {k: Coord(tuple(v.dims), np.asarray(v.values)) for k, v in obj.coords.items()}
        dvars = {}
        for k, v in obj.data_vars.items():
            dvars[k] = Field(np.asarray(v.values), tuple(v.dims), name=k, attrs=dict(v.attrs))
        return FieldSet(dvars, coords, dict(obj.attrs))
    coords = {k: Coord(tuple(v.dims), np.asarray(v.values)) for k, v in obj.coords.items()}
    return Field(np.asarray(obj.values), tuple(obj.dims), coords, getattr(obj, "name", None), dict(obj.attrs))


def as_field(obj: Any, dims: Optional[Sequence[str]] = None, name: Optional[str] = None) -> Field:
    """
    Coerce Field / xarray.DataArray / ndarray or tensor (+dims) into a Field.
    Dask-backed xarray inputs are materialised by ``.values``.
    """
    if isinstance(obj, Field):
        return obj
    if hasattr(obj, "dims") and hasattr(obj, "values"):  # xarray duck-type
        return from_xarray(obj)
    arr = obj if isinstance(obj, torch.Tensor) else np.asarray(obj)
    if dims is None:
        raise DataValidationError(
            "Cannot infer dims for raw array input",
            suggestions=["Pass a marex_tpu_torch Field, an xarray.DataArray, or provide dims explicitly"],
        )
    return Field(arr, dims, name=name)


def from_reference(obj: Any, device: Union[str, torch.device]) -> Union[Field, FieldSet]:
    """
    Carry a ``marex_tpu`` Field or FieldSet into this package, its payloads
    as tensors on ``device``. Duck-typed on ``.data``/``.dims``/``.coords``/
    ``.name``/``.attrs`` (and ``.data_vars`` for a FieldSet); payloads are
    read with ``np.asarray``, so nothing of ``marex_tpu`` or ``jax`` is
    imported here.
    """

    def _coords(coords: Mapping[str, Any]) -> Dict[str, Coord]:
        return {k: Coord(tuple(c.dims), np.asarray(c.values)) for k, c in coords.items()}

    def _field(f: Any) -> Field:
        return Field(on_device(np.asarray(f.data), device), tuple(f.dims), _coords(f.coords), f.name, dict(f.attrs))

    if hasattr(obj, "data_vars"):
        return FieldSet({k: _field(v) for k, v in obj.data_vars.items()}, _coords(obj.coords), dict(obj.attrs))
    return _field(obj)
