"""Lidar BEV scatter rendering.

Parity: `navsim/visualization/lidar.py` — point-cloud scatter in the BEV
frame, colored by height or intensity.

Counterpart of `diffusiondrive_tpu/visualization/lidar.py`: host code,
matplotlib imported inside the functions.
"""

from __future__ import annotations


import numpy as np

from diffusiondrive_torch.common.dataclasses import Lidar
from diffusiondrive_torch.common.enums import LidarIndex


def add_lidar_to_bev_ax(ax, lidar: Lidar, color_by: str = "z", max_points: int = 50000,
                        point_size: float = 0.5):
    """Scatter lidar returns on a BEV axis (ego frame: x fwd, y left)."""
    pc = lidar.lidar_pc
    if pc is None or pc.shape[1] == 0:
        return ax
    n = pc.shape[1]
    idx = np.random.default_rng(0).choice(n, min(n, max_points), replace=False)
    x, y = pc[LidarIndex.X, idx], pc[LidarIndex.Y, idx]
    if color_by == "intensity" and pc.shape[0] > LidarIndex.INTENSITY:
        c = pc[LidarIndex.INTENSITY, idx]
    else:
        c = pc[LidarIndex.Z, idx]
    ax.scatter(x, y, c=c, s=point_size, cmap="viridis", zorder=2)
    return ax


def plot_lidar_bev(lidar: Lidar, color_by: str = "z"):
    """Standalone lidar BEV figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    add_lidar_to_bev_ax(ax, lidar, color_by)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.tight_layout()
    return fig, ax
