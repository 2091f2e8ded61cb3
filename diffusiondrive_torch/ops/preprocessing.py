"""Sensor preprocessing on the device (counterpart of `diffusiondrive_tpu/ops/preprocessing.py`).

- `stitch_cameras`: crop l0/f0/r0, hstack, bilinear-resize (no antialias)
  to 1024x256, scale to [0, 1];
- `lidar_bev`: padded point clouds -> 256x256 BEV histogram through the
  lidar-splat kernel (`ops/lidar_splat.py`).

The host keeps JPEG decode, PCD parse and padding (`pad_point_cloud`).
`lidar_bev(mesh=...)` is the JAX function's `shard_map` branch: each
device of the list splats its rows with the kernel, then the rows are
gathered.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.ops.lidar_splat import batched_splat_points
from diffusiondrive_torch.ops.sampling import resize_bilinear_no_aa
from diffusiondrive_torch.parallel.mesh import device_scope, gather_rows, split_rows

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
              config: Optional[TransfuserConfig] = None, mesh: Optional[Sequence[torch.device]] = None
              ) -> torch.Tensor:
    """(B, N, 3) padded float32 points + (B, N) bool mask -> (B, H, W, 1) BEV
    feature, one histogram launch for the batch on CUDA.

    With a device list `mesh` of more than one device, the rows are split
    over it (B a multiple of its length), each device runs one histogram
    launch on its rows (the kernel on a card; never a plain version there),
    and the BEV rows are gathered on the first device.
    """
    config = config or TransfuserConfig()
    if mesh is not None and len(mesh) > 1:
        bevs = []
        for dev, p, v in zip(mesh, split_rows(points, mesh), split_rows(valid, mesh)):
            with device_scope(dev):
                bevs.append(lidar_bev(p, v, config))
        return gather_rows(bevs)
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
