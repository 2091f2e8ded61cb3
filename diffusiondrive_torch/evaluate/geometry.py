"""Vectorized polygon geometry for scoring on the device (counterpart of
`diffusiondrive_tpu/evaluate/geometry.py`).

Every predicate is a dense, padded, branch-free tensor op, so the scorer
runs as a fixed sequence of launches over a batch of scenes:

- `points_in_polygons`: crossing-number test against padded vertex rings
- `polygons_intersect`: general simple-polygon overlap = any edge pair
  crosses OR either contains a vertex of the other
- `segment_intersects_polygon`: for the front-bumper collision test
- `project_onto_polyline`: arc-length projection for the progress metric

Padding convention: each polygon is (V_max, 2); padded slots repeat the last
valid vertex, producing zero-length edges that no predicate counts.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _edges(polygons: torch.Tensor) -> tuple:
    """(..., V, 2) ring -> edge starts/ends (wrapping last->first)."""
    return polygons, torch.roll(polygons, -1, dims=-2)


def points_in_polygons(points: torch.Tensor, polygons: torch.Tensor) -> torch.Tensor:
    """Crossing-number point-in-polygon.

    :param points: (..., 2)
    :param polygons: (..., P, V, 2) padded vertex rings (pad = repeat last
        vertex); leading dims broadcast against the points' leading dims.
    :return: bool (..., P)
    """
    px = points[..., 0][..., None, None]  # (..., 1, 1)
    py = points[..., 1][..., None, None]

    rolled = torch.roll(polygons, -1, dims=-2)
    sx, sy = polygons[..., 0], polygons[..., 1]   # (..., P, V)
    ex, ey = rolled[..., 0], rolled[..., 1]

    straddles = (sy > py) != (ey > py)            # (..., P, V)
    denom = ey - sy
    x_at_y = sx + (py - sy) * (ex - sx) / torch.where(denom.abs() < _EPS, _EPS, denom)
    crossings = straddles & (px < x_at_y)
    return crossings.sum(-1) % 2 == 1


def _orient(ax, ay, bx, by, cx, cy):
    """Signed area orientation of triangle abc."""
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def segments_intersect(a0, a1, b0, b1) -> torch.Tensor:
    """Proper/touching segment intersection; inputs (..., 2) broadcastable."""
    d1 = _orient(b0[..., 0], b0[..., 1], b1[..., 0], b1[..., 1], a0[..., 0], a0[..., 1])
    d2 = _orient(b0[..., 0], b0[..., 1], b1[..., 0], b1[..., 1], a1[..., 0], a1[..., 1])
    d3 = _orient(a0[..., 0], a0[..., 1], a1[..., 0], a1[..., 1], b0[..., 0], b0[..., 1])
    d4 = _orient(a0[..., 0], a0[..., 1], a1[..., 0], a1[..., 1], b1[..., 0], b1[..., 1])

    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))

    def on_segment(px, py, q0, q1, d):
        collinear = d.abs() < _EPS
        within = (
            (px <= torch.maximum(q0[..., 0], q1[..., 0]) + _EPS)
            & (px >= torch.minimum(q0[..., 0], q1[..., 0]) - _EPS)
            & (py <= torch.maximum(q0[..., 1], q1[..., 1]) + _EPS)
            & (py >= torch.minimum(q0[..., 1], q1[..., 1]) - _EPS)
        )
        return collinear & within

    touch = (
        on_segment(a0[..., 0], a0[..., 1], b0, b1, d1)
        | on_segment(a1[..., 0], a1[..., 1], b0, b1, d2)
        | on_segment(b0[..., 0], b0[..., 1], a0, a1, d3)
        | on_segment(b1[..., 0], b1[..., 1], a0, a1, d4)
    )
    return proper | touch


def polygons_intersect(poly_a: torch.Tensor, poly_b: torch.Tensor) -> torch.Tensor:
    """Overlap test between two batches of simple polygons.

    :param poly_a: (..., Va, 2) rings
    :param poly_b: (..., Vb, 2) rings (broadcast-compatible batch dims)
    :return: bool (...) — True when the polygons touch/overlap/contain.
    """
    a0, a1 = _edges(poly_a)
    b0, b1 = _edges(poly_b)

    # all edge pairs: (..., Va, Vb)
    edge_hits = segments_intersect(
        a0[..., :, None, :], a1[..., :, None, :], b0[..., None, :, :], b1[..., None, :, :]
    )
    any_edge = edge_hits.any(-1).any(-1)

    # containment: first vertex of one inside the other
    a_in_b = points_in_polygons(poly_a[..., 0, :], poly_b[..., None, :, :])[..., 0]
    b_in_a = points_in_polygons(poly_b[..., 0, :], poly_a[..., None, :, :])[..., 0]
    return any_edge | a_in_b | b_in_a


def segment_intersects_polygon(s0: torch.Tensor, s1: torch.Tensor, polygon: torch.Tensor) -> torch.Tensor:
    """Segment-vs-polygon intersection (edges or either endpoint inside).

    :param s0, s1: (..., 2) segment endpoints
    :param polygon: (..., V, 2) rings
    :return: bool (...)
    """
    p0, p1 = _edges(polygon)
    hits = segments_intersect(s0[..., None, :], s1[..., None, :], p0, p1)
    inside = points_in_polygons(s0, polygon[..., None, :, :])[..., 0]
    return hits.any(-1) | inside


def project_onto_polyline(points: torch.Tensor, polyline: torch.Tensor) -> torch.Tensor:
    """Arc-length of the nearest point on a polyline (shapely `project`).

    :param points: (..., 2)
    :param polyline: (..., L, 2) vertices; its leading dims broadcast against
        the points' (JAX's (L, 2) is the case of none; a batch of scenes
        passes (S, 1, L, 2) for points (S, B, 2))
    :return: (...) arc-length values
    """
    seg_start = polyline[..., :-1, :]                      # (..., L-1, 2)
    seg_vec = polyline[..., 1:, :] - polyline[..., :-1, :]
    seg_len2 = (seg_vec ** 2).sum(-1)
    seg_len = seg_len2.sqrt()
    cum_len = torch.cat([torch.zeros_like(seg_len[..., :1]), seg_len.cumsum(-1)], dim=-1)[..., :-1]

    rel = points[..., None, :] - seg_start                 # (..., L-1, 2)
    t = (rel * seg_vec).sum(-1) / torch.where(seg_len2 < _EPS, _EPS, seg_len2)
    t = t.clamp(0.0, 1.0)
    proj = seg_start + t[..., None] * seg_vec
    dist2 = ((points[..., None, :] - proj) ** 2).sum(-1)

    best = dist2.argmin(-1, keepdim=True)
    best_t = t.gather(-1, best)[..., 0]
    best_cum = cum_len.expand(t.shape).gather(-1, best)[..., 0]
    best_seg = seg_len.expand(t.shape).gather(-1, best)[..., 0]
    return best_cum + best_t * best_seg


def polyline_arclength(polyline: torch.Tensor) -> torch.Tensor:
    """Total arc length of a polyline (..., L, 2)."""
    return torch.linalg.vector_norm(polyline.diff(dim=-2), dim=-1).sum(-1)
