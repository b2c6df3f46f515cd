"""
Lightweight labeled arrays for marex_tpu_torch.

The port of ``marex_tpu/core/field.py``: a thin :class:`Field`
(DataArray-analogue) and :class:`FieldSet` (Dataset-analogue) whose payloads
are ``numpy`` arrays, ``torch`` tensors, or lazy zarr arrays
(:class:`~marex_tpu_torch.io.zarr_lite.LazyZarrArray`, which read only the
chunks a slice touches). A tensor payload keeps its device, a lazy one stays
on disk until it is sliced or materialised; ``.values`` always returns host
numpy. :func:`from_reference` carries a ``marex_tpu`` Field/FieldSet across
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

from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..exceptions import DataValidationError

ArrayLike = Any  # np.ndarray | torch.Tensor


def _is_torch(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def _asnumpy(x: Any) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _astype(x: ArrayLike, dtype) -> ArrayLike:
    """``x.astype(dtype)`` for numpy or torch payloads (``dtype`` is a numpy
    dtype; a tensor keeps its device)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.from_numpy(np.empty(0, dtype=dtype)).dtype)
    return x.astype(dtype)


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
        return _asnumpy(self.data)

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

    def to(self, device: Union[str, torch.device]) -> "Field":
        """The Field with its payload as a tensor on ``device``."""
        return self._replace(data=on_device(self.data, device).to(device))


def on_device(data: ArrayLike, device: Union[str, torch.device]) -> torch.Tensor:
    """``data`` as a tensor: a tensor keeps its own device, anything else
    (numpy, or a lazy zarr payload, which is read whole here) is copied to
    ``device``."""
    if isinstance(data, torch.Tensor):
        return data
    return torch.tensor(np.asarray(data), device=device)


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
