"""Sensor preprocessing on the device (counterpart of `diffusiondrive_tpu/ops/preprocessing.py`).

- `stitch_cameras`: crop l0/f0/r0, hstack, bilinear-resize (no antialias)
  to 1024x256, scale to [0, 1];
- `lidar_bev`: padded point clouds -> 256x256 BEV histogram through the
  lidar-splat kernel (`ops/lidar_splat.py`).

The host keeps JPEG decode, PCD parse and padding (`pad_point_cloud`). The
JAX function's multi-device `mesh` branch comes with the data-parallel
slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.ops.lidar_splat import batched_splat_points
from diffusiondrive_torch.ops.sampling import resize_bilinear_no_aa

# OpenScene camera crops (`transfuser_features.py:64-69`)
ROW_CROP = (28, -28)
SIDE_COL_CROP = (416, -416)


def stitch_cameras(l0: torch.Tensor, f0: torch.Tensor, r0: torch.Tensor,
                   out_height: int = 256, out_width: int = 1024) -> torch.Tensor:
    """(B, 1080, 1920, 3) uint8 cams -> (B, out_h, out_w, 3) float32 in [0, 1].

    The crops are stitched in uint8 and the resize converts after its
    gather, where the JAX function casts the whole stitched image to float32
    first: the same values at a quarter of the memory.
    """
    l0c = l0[:, ROW_CROP[0]:ROW_CROP[1], SIDE_COL_CROP[0]:SIDE_COL_CROP[1]]
    f0c = f0[:, ROW_CROP[0]:ROW_CROP[1]]
    r0c = r0[:, ROW_CROP[0]:ROW_CROP[1], SIDE_COL_CROP[0]:SIDE_COL_CROP[1]]
    stitched = torch.cat([l0c, f0c, r0c], dim=2)
    return resize_bilinear_no_aa(stitched, (out_height, out_width)) / 255.0


def lidar_bev(points: torch.Tensor, valid: torch.Tensor,
              config: Optional[TransfuserConfig] = None) -> torch.Tensor:
    """(B, N, 3) padded float32 points + (B, N) bool mask -> (B, H, W, 1) BEV
    feature, one histogram launch for the batch on CUDA."""
    config = config or TransfuserConfig()
    return batched_splat_points(
        points, valid,
        min_x=config.lidar_min_x, max_x=config.lidar_max_x,
        min_y=config.lidar_min_y, max_y=config.lidar_max_y,
        bins=config.lidar_resolution_width,
        max_height=config.max_height_lidar,
        split_height=config.lidar_split_height,
        hist_max_per_pixel=config.hist_max_per_pixel,
    )


def pad_point_cloud(lidar_pc: np.ndarray, max_points: int = 131072) -> Tuple[np.ndarray, np.ndarray]:
    """(6, N) host point cloud -> ((max_points, 3), (max_points,)) padded xyz."""
    xyz = lidar_pc[:3].T.astype(np.float32)
    n = min(len(xyz), max_points)
    points = np.zeros((max_points, 3), np.float32)
    valid = np.zeros(max_points, bool)
    points[:n] = xyz[:n]
    valid[:n] = True
    return points, valid
