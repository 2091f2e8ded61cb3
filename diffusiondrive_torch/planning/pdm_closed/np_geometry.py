"""Host-side (numpy) polygon geometry for the PDM-Closed planner.

Replaces the shapely predicates the reference uses during proposal generation
(`pdm_generator.py:197,265,290`): polygon-polygon distance, polyline-corridor
intersection, point-in-polygon. Object counts are tiny (tens) on this offline
path, so simple dense numpy is the right tool.

Copy of `diffusiondrive_tpu/planning/pdm_closed/np_geometry.py` (numpy on the host, as there).
"""

from __future__ import annotations

import numpy as np


def point_in_polygon(points: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Crossing-number test: (..., 2) points against one (V, 2) ring."""
    px, py = points[..., 0, None], points[..., 1, None]
    sx, sy = ring[:, 0], ring[:, 1]
    ex, ey = np.roll(ring[:, 0], -1), np.roll(ring[:, 1], -1)
    straddles = (sy > py) != (ey > py)
    denom = np.where(np.abs(ey - sy) < 1e-12, 1e-12, ey - sy)
    x_at_y = sx + (py - sy) * (ex - sx) / denom
    return (straddles & (px < x_at_y)).sum(-1) % 2 == 1


def _segment_point_distance(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distances from points p (..., 2) to segments (a, b) (..., 2)."""
    ab = b - a
    len2 = np.maximum(np.sum(ab**2, axis=-1), 1e-12)
    t = np.clip(np.sum((p - a) * ab, axis=-1) / len2, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return np.linalg.norm(p - proj, axis=-1)


def polygon_distance(ring_a: np.ndarray, ring_b: np.ndarray) -> float:
    """Min distance between two polygon rings (0 if overlapping)."""
    if point_in_polygon(ring_a[:1], ring_b)[0] or point_in_polygon(ring_b[:1], ring_a)[0]:
        return 0.0
    a0, a1 = ring_a, np.roll(ring_a, -1, axis=0)
    b0, b1 = ring_b, np.roll(ring_b, -1, axis=0)
    # vertex-to-edge distances both ways
    d_ab = _segment_point_distance(ring_a[:, None, :], b0[None], b1[None]).min()
    d_ba = _segment_point_distance(ring_b[:, None, :], a0[None], a1[None]).min()
    return float(min(d_ab, d_ba))


def polyline_polygon_distance(polyline: np.ndarray, ring: np.ndarray) -> float:
    """Min distance between a polyline and a polygon ring (0 on overlap)."""
    if point_in_polygon(polyline[:1], ring)[0]:
        return 0.0
    # polyline vertices to polygon edges
    b0, b1 = ring, np.roll(ring, -1, axis=0)
    d1 = _segment_point_distance(polyline[:, None, :], b0[None], b1[None]).min()
    # polygon vertices to polyline segments
    a0, a1 = polyline[:-1], polyline[1:]
    d2 = _segment_point_distance(ring[:, None, :], a0[None], a1[None]).min()
    # crossing => distance 0 (covered approximately by the vertex distances;
    # exact crossing check for robustness):
    if _any_segments_cross(a0, a1, b0, b1):
        return 0.0
    return float(min(d1, d2))


def _any_segments_cross(a0, a1, b0, b1) -> bool:
    def orient(p, q, r):
        return (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1]) - (q[..., 1] - p[..., 1]) * (
            r[..., 0] - p[..., 0]
        )

    A0, A1 = a0[:, None, :], a1[:, None, :]
    B0, B1 = b0[None, :, :], b1[None, :, :]
    d1 = orient(B0, B1, A0)
    d2 = orient(B0, B1, A1)
    d3 = orient(A0, A1, B0)
    d4 = orient(A0, A1, B1)
    return bool(np.any(((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))))


def corridor_intersects_polygon(corridor_polyline: np.ndarray, half_width: float, ring: np.ndarray) -> bool:
    """Whether a polygon intersects the corridor = polyline buffered by
    half_width (square caps approximated by the segment-distance test)."""
    return polyline_polygon_distance(corridor_polyline, ring) <= half_width


def polygon_intersection_area(ring_a: np.ndarray, ring_b: np.ndarray, resolution: int = 96) -> float:
    """Approximate intersection area of two polygon rings.

    Replaces shapely's `geom.intersection(polygon).area` used by route-loop
    removal (`route_utils.py:203`). Supports non-convex rings by counting a
    dense grid of cell centers over the bounding-box overlap; with the default
    resolution the error is far below the 1 m^2 loop-detection threshold for
    roadblock-scale polygons.
    """
    lo = np.maximum(ring_a.min(axis=0), ring_b.min(axis=0))
    hi = np.minimum(ring_a.max(axis=0), ring_b.max(axis=0))
    if np.any(hi <= lo):
        return 0.0
    xs = np.linspace(lo[0], hi[0], resolution, endpoint=False) + (hi[0] - lo[0]) / (2 * resolution)
    ys = np.linspace(lo[1], hi[1], resolution, endpoint=False) + (hi[1] - lo[1]) / (2 * resolution)
    grid = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
    inside = point_in_polygon(grid, ring_a) & point_in_polygon(grid, ring_b)
    cell_area = (hi[0] - lo[0]) * (hi[1] - lo[1]) / (resolution * resolution)
    return float(inside.sum() * cell_area)
