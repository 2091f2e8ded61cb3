"""Comfort metrics: six savgol-filtered kinematic bounds (counterpart of
`diffusiondrive_tpu/evaluate/comfort.py`).

Parity: nuplan's `pdm_comfort_metrics.py` — lon/lat acceleration, magnitude
jerk, lon jerk, yaw acceleration, yaw rate, each bounded after
Savitzky-Golay smoothing/differentiation (filters are precomputed matrices,
see `ops/savgol.py`). Every step runs on the states' device and dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from diffusiondrive_torch.common.enums import StateIndex
from diffusiondrive_torch.ops.savgol import savgol_filter_torch

# nuplan comfort bounds
MAX_ABS_MAG_JERK = 8.37      # [m/s^3]
MAX_ABS_LAT_ACCEL = 4.89     # [m/s^2]
MAX_LON_ACCEL = 2.40         # [m/s^2]
MIN_LON_ACCEL = -4.05
MAX_ABS_YAW_ACCEL = 1.93     # [rad/s^2]
MAX_ABS_LON_JERK = 4.13      # [m/s^3]
MAX_ABS_YAW_RATE = 0.95      # [rad/s]


def _round8(x: torch.Tensor) -> torch.Tensor:
    """Reference rounds to 8 decimals before thresholding; in x's dtype, half
    to even, as `jnp.round` (x * 1e8 loses bits in float32 before rounding,
    as it does in JAX). JAX writes `/ 1e8`, but its scorer runs under `jit`,
    where XLA turns a division by a constant into a product by its
    reciprocal; the product is what JAX's scores are made of, so it is what
    this computes (the two differ in the last bit of ~5% of float32 values)."""
    return torch.round(x * 1e8) * 1e-8


def _extract_acceleration(states: torch.Tensor, coord: str, window_length: int = 8) -> torch.Tensor:
    T = states.shape[-2]
    if coord == "x":
        acc = states[..., StateIndex.ACCELERATION_X]
    elif coord == "y":
        acc = states[..., StateIndex.ACCELERATION_Y]
    else:  # magnitude
        acc = torch.hypot(states[..., StateIndex.ACCELERATION_X], states[..., StateIndex.ACCELERATION_Y])
    return _round8(savgol_filter_torch(acc, min(window_length, T), 2))


def _phase_unwrap(headings: torch.Tensor) -> torch.Tensor:
    two_pi = 2.0 * np.pi
    diffs = headings.diff(dim=-1)
    adjustments = torch.round(diffs / two_pi).cumsum(-1)
    adjustments = torch.cat([torch.zeros_like(headings[..., :1]), adjustments], dim=-1)
    return headings - two_pi * adjustments


def _derivative(y: torch.Tensor, dt: float, window_length: int, poly_order: int, deriv: int) -> torch.Tensor:
    T = y.shape[-1]
    return savgol_filter_torch(y, min(window_length, T), poly_order, deriv=deriv, delta=dt)


def _within(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return ((x > lo) & (x < hi)).all(-1)


def ego_is_comfortable(states: torch.Tensor, time_point_s: np.ndarray) -> torch.Tensor:
    """(..., T, 11) states -> (..., 6) per-metric within-bound booleans."""
    T = states.shape[-2]
    dt = float(time_point_s[1] - time_point_s[0])

    lon_acc = _extract_acceleration(states, "x", window_length=T)
    lat_acc = _extract_acceleration(states, "y", window_length=T)

    mag_acc = _extract_acceleration(states, "magnitude")  # default window 8
    jerk = _round8(_derivative(mag_acc, dt, window_length=T, poly_order=2, deriv=1))

    x_acc = _extract_acceleration(states, "x")  # default window 8
    lon_jerk = _round8(_derivative(x_acc, dt, window_length=T, poly_order=2, deriv=1))

    # `_extract_ego_yaw_rate` never forwards its window_length to
    # `_approximate_derivatives`, so both yaw metrics use the latter's
    # default window of 5 (`pdm_comfort_metrics.py:135-141,180`).
    headings = _phase_unwrap(states[..., StateIndex.HEADING])
    yaw_rate = _round8(_derivative(headings, dt, window_length=5, poly_order=2, deriv=1))
    yaw_accel = _round8(_derivative(headings, dt, window_length=5, poly_order=3, deriv=2))

    return torch.stack(
        [
            _within(lon_acc, MIN_LON_ACCEL, MAX_LON_ACCEL),
            _within(lat_acc, -MAX_ABS_LAT_ACCEL, MAX_ABS_LAT_ACCEL),
            _within(jerk, -MAX_ABS_MAG_JERK, MAX_ABS_MAG_JERK),
            _within(lon_jerk, -MAX_ABS_LON_JERK, MAX_ABS_LON_JERK),
            _within(yaw_accel, -MAX_ABS_YAW_ACCEL, MAX_ABS_YAW_ACCEL),
            _within(yaw_rate, -MAX_ABS_YAW_RATE, MAX_ABS_YAW_RATE),
        ],
        dim=-1,
    )
