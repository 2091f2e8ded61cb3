"""Savitzky-Golay filtering as a precomputed linear map (counterpart of
`diffusiondrive_tpu/ops/savgol.py`).

The comfort metrics smooth and differentiate 41-sample signals with scipy's
`savgol_filter`. The filter (its `mode='interp'` edges included) is linear
in the input, so the exact (T, T) matrix is built once on the host in
float64 by filtering the identity, cast to the input's dtype at the use
site as JAX does, copied to each device once, and applied as one product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def savgol_matrix(
    num_samples: int, window_length: int, poly_order: int, deriv: int = 0, delta: float = 1.0
) -> np.ndarray:
    """Exact scipy-equivalent savgol operator: filtered = M @ y."""
    from scipy.signal import savgol_filter

    eye = np.eye(num_samples, dtype=np.float64)
    # filter each basis vector (columns) along axis 0
    M = savgol_filter(eye, window_length=window_length, polyorder=poly_order,
                      deriv=deriv, delta=delta, axis=0)
    return M  # float64; cast to the input dtype at the use site


@functools.lru_cache(maxsize=None)
def _matrix_t(num_samples: int, window_length: int, poly_order: int, deriv: int, delta: float,
              dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Mᵀ in `dtype` on `device`, copied once."""
    M = savgol_matrix(num_samples, window_length, poly_order, deriv, delta)
    return torch.from_numpy(np.ascontiguousarray(M.T)).to(dtype).to(device)


def savgol_filter_torch(
    y: torch.Tensor, window_length: int, poly_order: int, deriv: int = 0, delta: float = 1.0
) -> torch.Tensor:
    """Apply savgol along the last axis of `y` (any leading batch dims)."""
    T = y.shape[-1]
    dtype = y.dtype if y.is_floating_point() else torch.float32
    Mt = _matrix_t(T, min(window_length, T), poly_order, deriv, float(delta), dtype, y.device)
    return y.to(dtype) @ Mt
