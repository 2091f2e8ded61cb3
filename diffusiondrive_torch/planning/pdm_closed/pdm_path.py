"""Arc-length parameterized path (numpy).

Parity: `pdm_planner/utils/pdm_path.py` (PDMPath): progress array, linear
interpolation over (x, y, unwrapped heading), nearest-point projection and
substrings — shapely linestring + scipy interp1d replaced by vectorized
numpy.

Copy of `diffusiondrive_tpu/planning/pdm_closed/pdm_path.py` (numpy on the host, as there).
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from diffusiondrive_torch.common.geometry import StateSE2, normalize_angle, se2_array_from_poses


def project_points_to_polyline(points: np.ndarray, polyline: np.ndarray) -> np.ndarray:
    """Arc-length of the nearest point on the polyline for (..., 2) points."""
    seg_start = polyline[:-1]
    seg_vec = polyline[1:] - polyline[:-1]
    seg_len2 = np.maximum(np.sum(seg_vec**2, axis=-1), 1e-12)
    seg_len = np.sqrt(seg_len2)
    cum_len = np.concatenate([[0.0], np.cumsum(seg_len)])[:-1]

    rel = points[..., None, :] - seg_start
    t = np.clip(np.sum(rel * seg_vec, axis=-1) / seg_len2, 0.0, 1.0)
    proj = seg_start + t[..., None] * seg_vec
    dist2 = np.sum((points[..., None, :] - proj) ** 2, axis=-1)
    best = np.argmin(dist2, axis=-1)
    best_t = np.take_along_axis(t, best[..., None], axis=-1)[..., 0]
    return cum_len[best] + best_t * seg_len[best]


class PDMPath:
    """Discrete (x, y, heading) path with arc-length interpolation."""

    def __init__(self, discrete_path: Sequence[StateSE2]):
        self._discrete_path = list(discrete_path)
        arr = se2_array_from_poses(self._discrete_path)
        arr[:, 2] = np.unwrap(arr[:, 2])
        self._states_se2_array = arr
        seg = np.linalg.norm(np.diff(arr[:, :2], axis=0), axis=-1)
        self._progress = np.concatenate([[0.0], np.cumsum(seg)])

    @property
    def discrete_path(self) -> List[StateSE2]:
        return self._discrete_path

    @property
    def length(self) -> float:
        return float(self._progress[-1])

    @property
    def coords(self) -> np.ndarray:
        """(N, 2) xy vertices of the path."""
        return self._states_se2_array[:, :2]

    def project(self, points: np.ndarray) -> np.ndarray:
        """(..., 2) points -> arc-length of the nearest path point."""
        return project_points_to_polyline(np.asarray(points, np.float64), self.coords)

    def interpolate(self, distances: Union[Sequence[float], np.ndarray], as_array: bool = True):
        """Arc lengths -> (x, y, heading); clipped to [~0, length]."""
        d = np.clip(np.asarray(distances, np.float64), 1e-5, self.length)
        x = np.interp(d, self._progress, self._states_se2_array[:, 0])
        y = np.interp(d, self._progress, self._states_se2_array[:, 1])
        h = normalize_angle(np.interp(d, self._progress, self._states_se2_array[:, 2]))
        out = np.stack([x, y, h], axis=-1)
        out[np.isnan(out)] = 0.0
        if as_array:
            return out
        return [StateSE2(*row) for row in out]

    def substring(self, start_distance: float, end_distance: float) -> np.ndarray:
        """(M, 2) polyline between two arc lengths (endpoints interpolated)."""
        start = float(np.clip(start_distance, 0.0, self.length))
        end = float(np.clip(end_distance, 0.0, self.length))
        if end <= start:
            p = self.interpolate([start])[0][:2]
            return np.stack([p, p])
        inside = (self._progress > start) & (self._progress < end)
        pts = [self.interpolate([start])[0][:2]]
        pts.extend(self.coords[inside])
        pts.append(self.interpolate([end])[0][:2])
        return np.asarray(pts)
