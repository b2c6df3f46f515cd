"""
Polynomial and harmonic detrending.

The port of ``marex_tpu/ops/detrend.py``: the (K, T) design matrix and its
pseudo-inverse are built on the host in float64; the fit ``pinv(M) @ data``
and its removal ``data - M @ coeffs`` are two small matrix products with
``torch.matmul``.

The products run in float64 (the reference's are float32): the fit of
K <= 7 rows is then exact to float32 after the one rounding of the result,
closer to a float64 oracle than the reference, and the CPU and CUDA differ
only where a float64 value lies within a few float64 ulp of a float32
rounding boundary. No TF32 is involved (float64 products never use it).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core.timeaxis import TimeIndexInfo


def build_design_matrix(
    tinfo: TimeIndexInfo,
    detrend_orders: List[int],
    remove_harmonics: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    The (K, T) model matrix and its (T, K) pseudo-inverse, in float64: a
    constant row, centred ``decimal_year**k`` rows for each requested order,
    and optionally the annual and semi-annual sin/cos harmonics; each
    non-constant row is orthogonalised against the constant row.
    """
    dy = tinfo.decimal_year
    rows = [np.ones(len(dy))]
    centered = dy - dy.mean()
    for order in detrend_orders:
        rows.append(centered**order)
    if remove_harmonics:
        rows.extend(
            [
                np.sin(2 * np.pi * dy),
                np.cos(2 * np.pi * dy),
                np.sin(4 * np.pi * dy),
                np.cos(4 * np.pi * dy),
            ]
        )
    model = np.array(rows)
    for i in range(1, model.shape[0]):
        model[i] = model[i] - model[i].mean() * model[0]
    pmodel = np.linalg.pinv(model)
    return model, pmodel


def detrend_subtract(data: torch.Tensor, model: torch.Tensor, pmodel: torch.Tensor) -> torch.Tensor:
    """
    ``data - model.T @ (pmodel.T @ data)`` in float64, for a (T, S) block and
    float64 ``model`` (K, T) and ``pmodel`` (T, K) on its device. NaN over land
    stays NaN (each column is fitted on its own).
    """
    x = data.to(torch.float64)
    coeffs = torch.matmul(pmodel.T, x)  # (K, S)
    return x - torch.matmul(model.T, coeffs)


def remove_time_mean(data: torch.Tensor) -> torch.Tensor:
    """Subtract the nan-aware mean over time (dim 0); a column with no finite
    value keeps its values."""
    finite = torch.isfinite(data)
    n = finite.sum(dim=0)
    mean = torch.where(finite, data, 0.0).sum(dim=0) / n.clamp(min=1)
    return data - torch.where(n > 0, mean, 0.0)
