"""Visualization color/style configuration.

Parity: `navsim/visualization/config.py` — per-layer and per-agent-type
plot styles for BEV and camera views.

Counterpart of `diffusiondrive_tpu/visualization/config.py`: the same styles.
"""

from __future__ import annotations

from diffusiondrive_torch.evaluate.observation import MapLayer

BEV_PLOT_CONFIG = {
    "figure_size": (8, 8),
    "figure_margin": (64, 64),  # [m]
    "background_color": "#FFFFFF",
}

MAP_LAYER_CONFIG = {
    MapLayer.LANE: dict(fill_color="#E0E0E0", fill_alpha=1.0, line_color="#BDBDBD", line_width=0.5, zorder=0),
    MapLayer.INTERSECTION: dict(fill_color="#D6D6D6", fill_alpha=1.0, line_color="#BDBDBD", line_width=0.5, zorder=0),
    MapLayer.LANE_CONNECTOR: dict(fill_color="none", fill_alpha=0.0, line_color="#9E9E9E", line_width=0.5, zorder=1),
    MapLayer.WALKWAYS: dict(fill_color="#FCE4C6", fill_alpha=0.8, line_color="#E8C49C", line_width=0.5, zorder=0),
    MapLayer.CROSSWALK: dict(fill_color="#D0D8E8", fill_alpha=0.8, line_color="#B0B8C8", line_width=0.5, zorder=1),
    MapLayer.ROADBLOCK: dict(fill_color="#EEEEEE", fill_alpha=0.5, line_color="#CCCCCC", line_width=0.5, zorder=0),
    MapLayer.CARPARK_AREA: dict(fill_color="#E8E0D0", fill_alpha=0.8, line_color="#CCC0A8", line_width=0.5, zorder=0),
}

AGENT_CONFIG = {
    "vehicle": dict(fill_color="#469BDD", fill_alpha=0.8, line_color="#2D7AB8", line_width=1.0, zorder=3),
    "pedestrian": dict(fill_color="#E574C3", fill_alpha=0.8, line_color="#C250A0", line_width=1.0, zorder=3),
    "bicycle": dict(fill_color="#C6F50A", fill_alpha=0.8, line_color="#9EC408", line_width=1.0, zorder=3),
    "traffic_cone": dict(fill_color="#FF7F50", fill_alpha=0.8, line_color="#D85F30", line_width=1.0, zorder=3),
    "barrier": dict(fill_color="#B79C4A", fill_alpha=0.8, line_color="#937C38", line_width=1.0, zorder=3),
    "czone_sign": dict(fill_color="#FF7F50", fill_alpha=0.8, line_color="#D85F30", line_width=1.0, zorder=3),
    "generic_object": dict(fill_color="#B0B0B0", fill_alpha=0.8, line_color="#909090", line_width=1.0, zorder=3),
    "ego": dict(fill_color="#DE5D4F", fill_alpha=1.0, line_color="#B53E32", line_width=1.5, zorder=5),
}

TRAJECTORY_CONFIG = {
    "human": dict(line_color="#2E8B57", line_width=2.0, line_style="-", marker="o", marker_size=3, zorder=6),
    "agent": dict(line_color="#DE5D4F", line_width=2.0, line_style="-", marker="o", marker_size=3, zorder=7),
    "pdm": dict(line_color="#469BDD", line_width=2.0, line_style="--", marker=None, marker_size=0, zorder=6),
}

BEV_SEMANTIC_COLORS = {
    0: (255, 255, 255),  # background
    1: (224, 224, 224),  # road
    2: (252, 228, 198),  # walkway
    3: (158, 158, 158),  # centerline
    4: (255, 127, 80),   # static objects
    5: (70, 155, 221),   # vehicles
    6: (229, 116, 195),  # pedestrians
}
