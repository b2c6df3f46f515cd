"""
Plot preparation on the payload's device: what the plotters reduce and pull.

``marex_tpu.plotX`` pulls whole fields to the host: ``np.nanmax`` of the
whole ID field for its colour table, a float copy of the whole field for
``plot_IDs``, every tenth slice for the robust colour limits. A payload of
the port can be a CUDA tensor of several GB or a lazy zarr array, so here:

* :func:`nanmax` reduces on the payload's device (a lazy payload a chunk row
  at a time, read in threads) and brings back a scalar;
* :func:`robust_limits` samples, filters and selects the two order statistics
  of each percentile on the device, then interpolates them on the host with
  numpy's own steps, so the limits equal ``np.percentile`` of the sample bit
  for bit;
* :class:`PositiveOnly` is ``field.where(field > 0)`` as a view: a slice of it
  is masked when it is read, so only the slices that are drawn are masked;
* :func:`host_frame` and :func:`host_values` bring back one slice as numpy,
  which is all a frame, a panel or a plot needs (a frame's payload goes to a
  forked worker, which must never touch a tensor).

Every tensor that leaves torch here goes through :func:`pull`, which counts
its bytes in ``pull.bytes``. No function here imports matplotlib.
"""

from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.field import Field, _as_tensor, _np_dtype
from ..io.zarr_lite import LazyZarrArray

# elements of one block of a tensor or numpy payload reduced at a time: the
# NaN-filled copy a float block needs stays at 512 MB of float32
_BLOCK_ELEMS = 1 << 27
# chunk rows of a lazy payload read ahead, each in its own thread (zlib
# releases the GIL)
_READ_AHEAD = 8
# the robust colour limits sample every tenth index along the time axis, as
# the reference's ``isel(time=slice(None, None, 10))`` does
_SAMPLE_STRIDE = 10


def pull(x: Any) -> np.ndarray:
    """``x`` as host numpy; a tensor's bytes are added to ``pull.bytes``."""
    if isinstance(x, torch.Tensor):
        pull.bytes += x.numel() * x.element_size()
        return x.detach().cpu().numpy()
    return np.asarray(x)


pull.bytes = 0


def _masked_dtype(dtype: np.dtype) -> np.dtype:
    """The dtype of ``np.where(cond, x, np.nan)`` for ``x`` of ``dtype``."""
    return np.where(np.ones(1, bool), np.zeros(1, dtype), np.nan).dtype


def _mask_host(vals: np.ndarray) -> np.ndarray:
    return np.where(vals > 0, vals, np.nan)


class PositiveOnly:
    """``field.where(field > 0)`` of a payload, as a view: the values above 0,
    NaN elsewhere, in the dtype ``np.where`` gives them. Indexing reads the
    base's selection, brings it to the host and masks it there; the whole
    array is masked only when it is asked for as one (``np.asarray``)."""

    def __init__(self, base: Any):
        self.base = base.base if isinstance(base, PositiveOnly) else base
        self.shape = tuple(self.base.shape)
        self.dtype = _masked_dtype(_np_dtype(self.base))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __getitem__(self, idx: Any) -> np.ndarray:
        return _mask_host(pull(self.base[idx]))

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = _mask_host(pull(self.base))
        return arr.astype(dtype) if dtype is not None else arr


def _base(data: Any) -> Tuple[Any, bool]:
    """The payload under a :class:`PositiveOnly` view, and whether there was one."""
    if isinstance(data, PositiveOnly):
        return data.base, True
    return data, False


def _blocks(data: Any, stride: int = 1) -> Iterator[Tuple[int, torch.Tensor]]:
    """(first row, block) along axis 0, each block a tensor on the payload's
    device: views of a tensor, a numpy payload's rows on the host, a lazy
    payload read a chunk row at a time (``_READ_AHEAD`` rows in threads),
    leaving out the chunk rows that hold no multiple of ``stride``."""
    if data.ndim == 0:
        yield 0, _as_tensor(data).reshape(1)
        return
    n = data.shape[0]
    if isinstance(data, LazyZarrArray):
        step = data.chunks[0]
        starts = [s for s in range(0, n, step) if (-s) % stride < min(step, n - s)]
        with ThreadPoolExecutor(max_workers=_READ_AHEAD) as pool:
            pending = [pool.submit(data.__getitem__, slice(s, s + step)) for s in starts[:_READ_AHEAD]]
            for i, s in enumerate(starts):
                block = pending[i].result()
                if i + _READ_AHEAD < len(starts):
                    nxt = starts[i + _READ_AHEAD]
                    pending.append(pool.submit(data.__getitem__, slice(nxt, nxt + step)))
                pending[i] = None
                yield s, torch.from_numpy(block)
        return
    row = int(np.prod(data.shape[1:])) if data.ndim > 1 else 1
    step = max(1, _BLOCK_ELEMS // max(row, 1))
    for s in range(0, n, step):
        yield s, _as_tensor(data[s : s + step])


def nanmax(data: Any) -> Any:
    """``np.nanmax(np.asarray(data))``, reduced on the payload's device; only
    the scalar comes back. A :class:`PositiveOnly` view gives the largest
    value above 0 in its own dtype. Raises and warns as numpy does:
    ``ValueError`` on an empty payload, ``RuntimeWarning`` and NaN where no
    value counts (all NaN; of a view, none above 0)."""
    base, positive = _base(data)
    dtype = _np_dtype(base)
    floating = dtype.kind == "f"
    if 0 in tuple(data.shape):
        raise ValueError("zero-size array to reduction operation fmax which has no identity")
    best: List[torch.Tensor] = []
    seen: List[torch.Tensor] = []
    for _, block in _blocks(base):
        if block.dtype == torch.bool:
            block = block.to(torch.uint8)
        if floating:
            isnan = torch.isnan(block)
            best.append(block.masked_fill(isnan, float("-inf")).amax())
            seen.append((~isnan).any())
        else:
            best.append(block.amax())
    top = pull(torch.stack(best).amax().reshape(1)).astype(dtype)[0]
    none = floating and not bool(pull(torch.stack(seen).any().reshape(1))[0])
    if positive:
        out_type = data.dtype.type
        none = none or not top > 0
        top = out_type(top)
    else:
        out_type = dtype.type
    if none:
        warnings.warn("All-NaN slice encountered", RuntimeWarning, stacklevel=2)
        return out_type(np.nan)
    return top


def _finite_sample(data: Any, axis: Optional[int]) -> torch.Tensor:
    """The finite values of every ``_SAMPLE_STRIDE``-th index along ``axis``
    (all of the payload with None), as a 1-D tensor on the payload's device;
    of a :class:`PositiveOnly` view the values above 0."""
    base, positive = _base(data)
    parts: List[torch.Tensor] = []
    for s, block in _blocks(base, _SAMPLE_STRIDE if axis == 0 else 1):
        if axis is not None:
            first = (-s) % _SAMPLE_STRIDE if axis == 0 else 0
            index = [slice(None)] * block.ndim
            index[axis] = slice(first, None, _SAMPLE_STRIDE)
            block = block[tuple(index)]
        if block.is_floating_point():
            keep = torch.isfinite(block) & (block > 0) if positive else torch.isfinite(block)
        elif positive:
            keep = block > 0
        else:
            parts.append(block.reshape(-1))
            continue
        parts.append(block[keep])
    if not parts:
        return torch.empty(0)
    return torch.cat(parts) if len(parts) > 1 else parts[0].reshape(-1)


def _quantile_is_valid(q: np.ndarray) -> bool:
    if q.ndim == 1 and q.size < 10:
        return all(0.0 <= q[i] <= 1.0 for i in range(q.size))
    return bool(q.min() >= 0 and q.max() <= 1)


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> Any:
    """numpy's interpolation between the order statistics (``np.percentile``'s
    ``_lerp``, step for step, so that the rounding is the same)."""
    diff_b_a = np.subtract(b, a)
    lerp_interpolation = np.asanyarray(np.add(a, diff_b_a * t))
    np.subtract(b, diff_b_a * (1 - t), out=lerp_interpolation, where=t >= 0.5, casting="unsafe",
                dtype=type(lerp_interpolation.dtype))
    if lerp_interpolation.ndim == 0:
        lerp_interpolation = lerp_interpolation[()]
    return lerp_interpolation


def percentile(values: torch.Tensor, dtype: np.dtype, percentiles: Any) -> Any:
    """``np.percentile(v, percentiles)`` (the linear method) of the values
    ``v`` of ``dtype`` held in the 1-D tensor ``values``, which must be
    finite: the order statistics are selected on the tensor's device (a
    sort on CUDA, numpy's partition on the CPU), the virtual indexes and the
    interpolation computed on the host exactly as numpy computes them."""
    dtype = np.dtype(dtype)
    q = np.true_divide(percentiles, dtype.type(100) if dtype.kind == "f" else 100)
    q = np.asanyarray(q)
    if not _quantile_is_valid(q):
        raise ValueError("Percentiles must be in the range [0, 100]")
    n = values.numel()
    virtual = np.asanyarray((n - 1) * q)
    previous = np.asanyarray(np.floor(virtual))
    following = np.asanyarray(previous + 1)
    above = virtual >= n - 1
    previous[above] = -1
    following[above] = -1
    below = virtual < 0
    previous[below] = 0
    following[below] = 0
    previous = previous.astype(np.intp)
    following = following.astype(np.intp)
    ks = sorted({int(k) % n for k in np.concatenate([previous.ravel(), following.ravel()])})
    if values.is_cuda:
        # one sort over every SM; CUDA's kthvalue selects a slice in one block
        stats = pull(torch.sort(values).values[torch.tensor(ks, device=values.device)])
    else:
        # one introselect for every rank; kthvalue would make a pass a rank
        stats = pull(torch.from_numpy(np.partition(values.numpy(), ks)[ks]))
    at = dict(zip(ks, stats.astype(dtype)))
    a = np.array([at[int(k) % n] for k in previous.ravel()], dtype=dtype).reshape(previous.shape)
    b = np.array([at[int(k) % n] for k in following.ravel()], dtype=dtype).reshape(following.shape)
    gamma = np.asanyarray(virtual - previous)
    gamma = np.asanyarray(gamma, dtype=virtual.dtype)
    return _lerp(a, b, gamma)


def robust_limits(data: Any, issym: bool, percentiles: Sequence[float],
                  axis: Optional[int] = None) -> Tuple[Any, Any]:
    """The plotters' percentile colour limits of ``data`` (a payload or a
    :class:`PositiveOnly` view), sampled at every ``_SAMPLE_STRIDE``-th index
    along ``axis`` (the whole payload with None): ``np.percentile`` of the finite
    values of the sample, (0.0, 1.0) where there is none, and made symmetric
    about 0 with ``issym``. The sample and its filter stay on the payload's
    device; the count and the order statistics come back."""
    values = _finite_sample(data, axis)
    if values.numel() == 0:
        return (0.0, 1.0)
    dtype = data.dtype if isinstance(data, PositiveOnly) else _np_dtype(data)
    lo, hi = percentile(values, dtype, percentiles)
    if issym:
        m = max(abs(lo), abs(hi))
        return (-m, m)
    return (float(lo), float(hi))


def host_values(field: Field) -> np.ndarray:
    """A field's values as host numpy (a tensor through :func:`pull`)."""
    return pull(field.data)


def host_frame(field: Field, dim: str, index: int) -> Field:
    """Slice ``index`` of ``dim`` as a Field with a host numpy payload: the
    only part of the field a frame or a panel needs."""
    sl = field.isel({dim: index})
    return Field(host_values(sl), sl.dims, sl.coords, name=sl.name, attrs=sl.attrs)
