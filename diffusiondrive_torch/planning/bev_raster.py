"""BEV semantic rasterisation of map layers (copy of
`diffusiondrive_tpu/planning/bev_raster.py`).

Polygons are filled and centerlines drawn with cv2 in a (W, H) canvas, then
rot90 + flip into the (H, W) ego-centric frame. The map API is duck-typed:
anything with ``get_proximal_map_objects(point, radius, layers)`` returning
objects with a ``polygon`` or a ``baseline``.
"""

from __future__ import annotations

import numpy as np

from diffusiondrive_torch.common.enums import MapLayer
from diffusiondrive_torch.models.config import TransfuserConfig


def _to_local(coords: np.ndarray, ego_pose) -> np.ndarray:
    """Global (N, 2) -> ego-local coordinates."""
    ox, oy, oh = ego_pose[0], ego_pose[1], ego_pose[2]
    c, s = np.cos(oh), np.sin(oh)
    dx, dy = coords[:, 0] - ox, coords[:, 1] - oy
    return np.stack([c * dx + s * dy, -s * dx + c * dy], axis=-1)


def coords_to_pixel(coords: np.ndarray, config: TransfuserConfig) -> np.ndarray:
    """Local (x forward, y left) meters -> BEV pixel indices."""
    pixel_center = np.array([[0.0, config.bev_pixel_width / 2.0]])
    return ((coords / config.bev_pixel_size) + pixel_center).astype(np.int32)


def rasterize_map_layers(map_api, ego_pose, config: TransfuserConfig) -> np.ndarray:
    """(bev_pixel_height, bev_pixel_width) int64 raster of the map classes
    1 = road, 2 = walkways, 3 = centerlines (the target builder stamps the
    box classes afterwards)."""
    import cv2

    bev = np.zeros(config.bev_semantic_frame, dtype=np.int64)
    point = (ego_pose[0], ego_pose[1])
    layer_specs = [
        (1, "polygon", [MapLayer.LANE, MapLayer.INTERSECTION]),
        (2, "polygon", [MapLayer.WALKWAYS]),
        (3, "linestring", [MapLayer.LANE, MapLayer.LANE_CONNECTOR]),
    ]
    for label, kind, layers in layer_specs:
        mask = np.zeros(config.bev_semantic_frame[::-1], dtype=np.uint8)
        objs_by_layer = map_api.get_proximal_map_objects(point, config.bev_radius, layers)
        for layer in layers:
            for obj in objs_by_layer.get(layer, []):
                if kind == "polygon":
                    local = _to_local(np.asarray(obj.polygon, np.float64), ego_pose)
                    cv2.fillPoly(mask, [coords_to_pixel(local, config).reshape(-1, 1, 2)], color=255)
                else:
                    if obj.baseline is None:
                        continue
                    local = _to_local(np.asarray(obj.baseline[:, :2], np.float64), ego_pose)
                    cv2.polylines(mask, [coords_to_pixel(local, config).reshape(-1, 1, 2)],
                                  isClosed=False, color=255, thickness=2)
        mask = np.rot90(mask)[::-1]
        bev[mask > 0] = label
    return bev
