"""BEV scene rendering (matplotlib).

Parity: `navsim/visualization/bev.py` — ego-centric bird's-eye view of map
layers, annotation boxes, and trajectories.

Counterpart of `diffusiondrive_tpu/visualization/bev.py`: host code,
matplotlib imported inside the functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from diffusiondrive_torch.common.dataclasses import Scene, Trajectory
from diffusiondrive_torch.common.enums import BoundingBoxIndex
from diffusiondrive_torch.evaluate.observation import MapLayer
from diffusiondrive_torch.evaluate.state_array import box_to_corners, get_pacifica_parameters
from diffusiondrive_torch.visualization.config import (
    AGENT_CONFIG,
    BEV_PLOT_CONFIG,
    MAP_LAYER_CONFIG,
    TRAJECTORY_CONFIG,
)


def _add_polygon(ax, ring: np.ndarray, style: dict) -> None:
    from matplotlib.patches import Polygon as MplPolygon

    patch = MplPolygon(
        ring,
        closed=True,
        facecolor=style.get("fill_color", "none"),
        alpha=style.get("fill_alpha", 1.0),
        edgecolor=style.get("line_color", "black"),
        linewidth=style.get("line_width", 0.5),
        zorder=style.get("zorder", 0),
    )
    ax.add_patch(patch)


def _to_local(coords: np.ndarray, origin) -> np.ndarray:
    c, s = np.cos(origin[2]), np.sin(origin[2])
    d = coords - np.asarray(origin[:2])
    return np.stack([c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1]], axis=-1)


def add_configured_bev_on_ax(ax, scene: Scene, frame_idx: Optional[int] = None):
    """Draw map + annotations of one frame onto `ax` (ego-centric)."""
    frame_idx = frame_idx if frame_idx is not None else scene.scene_metadata.num_history_frames - 1
    frame = scene.frames[frame_idx]
    ego_pose = frame.ego_status.ego_pose
    margin = BEV_PLOT_CONFIG["figure_margin"]

    # map layers
    if scene.map_api is not None:
        radius = max(margin) / 2 * 1.5
        layer_order = [MapLayer.LANE, MapLayer.INTERSECTION, MapLayer.WALKWAYS, MapLayer.CARPARK_AREA,
                       MapLayer.CROSSWALK, MapLayer.LANE_CONNECTOR]
        found = scene.map_api.get_proximal_map_objects((ego_pose[0], ego_pose[1]), radius, layer_order)
        for layer in layer_order:
            style = MAP_LAYER_CONFIG.get(layer)
            if style is None:
                continue
            for obj in found.get(layer, []):
                _add_polygon(ax, _to_local(np.asarray(obj.polygon), ego_pose), style)

    # annotation boxes (already ego-local)
    for name, box in zip(frame.annotations.names, frame.annotations.boxes):
        style = AGENT_CONFIG.get(name, AGENT_CONFIG["generic_object"])
        corners = box_to_corners(
            box[BoundingBoxIndex.X], box[BoundingBoxIndex.Y], box[BoundingBoxIndex.HEADING],
            box[BoundingBoxIndex.LENGTH], box[BoundingBoxIndex.WIDTH],
        )
        _add_polygon(ax, np.asarray(corners), style)

    # ego box at the origin
    vehicle = get_pacifica_parameters()
    ego_corners = box_to_corners(
        np.float64(vehicle.rear_axle_to_center), np.float64(0.0), np.float64(0.0),
        np.float64(vehicle.length), np.float64(vehicle.width),
    )
    _add_polygon(ax, np.asarray(ego_corners), AGENT_CONFIG["ego"])

    ax.set_xlim(-margin[0] / 2, margin[0] / 2)
    ax.set_ylim(-margin[1] / 2, margin[1] / 2)
    ax.set_aspect("equal")
    ax.set_facecolor(BEV_PLOT_CONFIG["background_color"])
    ax.set_xticks([])
    ax.set_yticks([])
    return ax


def add_trajectory_to_bev_ax(ax, trajectory: Trajectory, style_key: str = "agent"):
    """Overlay an ego-frame trajectory (BEV axes are ego-local: x forward =
    plot x)."""
    style = TRAJECTORY_CONFIG[style_key]
    poses = np.asarray(trajectory.poses)
    ax.plot(
        poses[:, 0], poses[:, 1],
        color=style["line_color"], linewidth=style["line_width"], linestyle=style["line_style"],
        marker=style["marker"], markersize=style["marker_size"], zorder=style["zorder"],
    )
    return ax


def render_bev_semantic_map(bev_map: np.ndarray) -> np.ndarray:
    """(H, W) int class raster -> (H, W, 3) uint8 color image."""
    from diffusiondrive_torch.visualization.config import BEV_SEMANTIC_COLORS

    out = np.zeros((*bev_map.shape, 3), np.uint8)
    for cls, color in BEV_SEMANTIC_COLORS.items():
        out[bev_map == cls] = color
    return out
