"""SE(2) pose algebra and frame conversions.

Copy of `diffusiondrive_tpu/common/geometry.py`. Every function takes a
pluggable array namespace, so the same code runs on host numpy and on torch
tensors (pass ``xp=torch``: the simulator and the scorer wrap angles on the
device with `normalize_angle`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Sequence

import numpy as np


@dataclass(frozen=True)
class StateSE2:
    """An (x, y, heading) pose. Iterable / indexable like a 3-tuple."""

    x: float
    y: float
    heading: float

    @property
    def point(self) -> np.ndarray:
        return np.array([self.x, self.y], dtype=np.float64)

    @property
    def array(self) -> np.ndarray:
        return np.array([self.x, self.y, self.heading], dtype=np.float64)

    def __iter__(self):
        return iter((self.x, self.y, self.heading))

    def __getitem__(self, idx: int) -> float:
        return (self.x, self.y, self.heading)[idx]

    def __hash__(self):
        return hash((self.x, self.y, self.heading))

    @classmethod
    def from_array(cls, arr: Sequence[float]) -> "StateSE2":
        return cls(float(arr[0]), float(arr[1]), float(arr[2]))

    def distance_to(self, other: "StateSE2") -> float:
        return math.hypot(self.x - other.x, self.y - other.y)


@dataclass(frozen=True)
class Point2D:
    """A 2D point."""

    x: float
    y: float

    @property
    def array(self) -> np.ndarray:
        return np.array([self.x, self.y], dtype=np.float64)

    def __iter__(self):
        return iter((self.x, self.y))


def normalize_angle(angle: Any, xp=np):
    """Wrap angle(s) to [-pi, pi]. Matches `pdm_geometry_utils.normalize_angle`."""
    return xp.arctan2(xp.sin(angle), xp.cos(angle))


def se2_array_from_poses(poses: Sequence[StateSE2]) -> np.ndarray:
    """Stack StateSE2 objects into an (N, 3) float64 array."""
    return np.array([[p.x, p.y, p.heading] for p in poses], dtype=np.float64)


def poses_from_se2_array(arr: np.ndarray) -> List[StateSE2]:
    return [StateSE2(float(r[0]), float(r[1]), float(r[2])) for r in arr]


def rotation_matrix(theta: Any, xp=np):
    """2x2 rotation matrix (supports batched theta with trailing (..., 2, 2))."""
    c, s = xp.cos(theta), xp.sin(theta)
    return xp.stack(
        [xp.stack([c, -s], axis=-1), xp.stack([s, c], axis=-1)], axis=-2
    )


def convert_absolute_to_relative_se2_array(origin, state_se2_array, xp=np):
    """Global (x, y, heading) array -> coordinates relative to `origin`.

    Parity: `pdm_geometry_utils.convert_absolute_to_relative_se2_array`.
    `origin` may be a StateSE2 or a length-3 array.
    """
    ox, oy, oh = origin[0], origin[1], origin[2]
    theta = -oh
    c, s = xp.cos(theta), xp.sin(theta)

    dx = state_se2_array[..., 0] - ox
    dy = state_se2_array[..., 1] - oy
    rel_x = dx * c - dy * s
    rel_y = dx * s + dy * c
    rel_h = normalize_angle(state_se2_array[..., 2] - oh, xp=xp)
    return xp.stack([rel_x, rel_y, rel_h], axis=-1)


def convert_relative_to_absolute_se2_array(origin, state_se2_array, xp=np):
    """Inverse of :func:`convert_absolute_to_relative_se2_array`."""
    ox, oy, oh = origin[0], origin[1], origin[2]
    c, s = xp.cos(oh), xp.sin(oh)

    abs_x = state_se2_array[..., 0] * c - state_se2_array[..., 1] * s + ox
    abs_y = state_se2_array[..., 0] * s + state_se2_array[..., 1] * c + oy
    abs_h = normalize_angle(state_se2_array[..., 2] + oh, xp=xp)
    return xp.stack([abs_x, abs_y, abs_h], axis=-1)


def convert_absolute_to_relative_point_array(origin, points, xp=np):
    """Global (..., 2) points -> coordinates relative to `origin` pose."""
    ox, oy, oh = origin[0], origin[1], origin[2]
    theta = -oh
    c, s = xp.cos(theta), xp.sin(theta)
    dx = points[..., 0] - ox
    dy = points[..., 1] - oy
    return xp.stack([dx * c - dy * s, dx * s + dy * c], axis=-1)


def translate_lon_and_lat(centers, headings, lon: float, lat: float, xp=np):
    """Translate points longitudinally/laterally w.r.t. their headings.

    Parity: `pdm_geometry_utils.translate_lon_and_lat`.
    """
    half_pi = math.pi / 2.0
    tx = lat * xp.cos(headings + half_pi) + lon * xp.cos(headings)
    ty = lat * xp.sin(headings + half_pi) + lon * xp.sin(headings)
    return centers + xp.stack([tx, ty], axis=-1)


def calculate_progress(path: Sequence[StateSE2]) -> np.ndarray:
    """Cumulative arc-length progress of a pose path."""
    xy = np.array([[p.x, p.y] for p in path], dtype=np.float64)
    seg = np.linalg.norm(np.diff(xy, axis=0), axis=-1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def parallel_discrete_path(discrete_path: Sequence[StateSE2], offset: float) -> List[StateSE2]:
    """Laterally offset copy of a discrete pose path."""
    out = []
    for state in discrete_path:
        theta = state.heading + math.pi / 2
        out.append(
            StateSE2(
                state.x + math.cos(theta) * offset,
                state.y + math.sin(theta) * offset,
                state.heading,
            )
        )
    return out


def se2_to_matrix(pose) -> np.ndarray:
    """StateSE2 -> 3x3 homogeneous transform."""
    x, y, h = pose[0], pose[1], pose[2]
    c, s = math.cos(h), math.sin(h)
    return np.array([[c, -s, x], [s, c, y], [0.0, 0.0, 1.0]], dtype=np.float64)


def quaternion_to_yaw(q: Sequence[float]) -> float:
    """Yaw from a (w, x, y, z) quaternion (the OpenScene log convention)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return math.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def yaw_to_quaternion(yaw: float) -> np.ndarray:
    """(w, x, y, z) quaternion of a pure-yaw rotation."""
    return np.array([math.cos(yaw / 2.0), 0.0, 0.0, math.sin(yaw / 2.0)], dtype=np.float64)
