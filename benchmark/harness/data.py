"""The one generator of the benchmark's inputs, driven by a traffic file.

Every input is drawn on the device from the run's seed, in a few large
calls, so every seed gives the same sizes and only other values.

- `training_pool`: `pool_batches` distinct batches of `batch` samples in the
  training cache's layout (uint8 camera, lidar BEV in [0, 1], status;
  trajectory, agent boxes with about a third valid, BEV classes), brought
  to the host as numpy arrays, the form a loader's workers hand over;
- `sensor_batches`: `pool_batches` batches of raw sensors on the device
  (three uint8 cameras, a padded point cloud shaped like a lidar sweep, the
  status) and the diffusion head's noise for each.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness.weights import seed_for


def _status(B: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """(B, 8): a one-hot driving command, then velocity, acceleration (N(0, [5, 1, 1, 0.5]))."""
    command = torch.nn.functional.one_hot(torch.randint(0, 4, (B,), generator=gen, device=device), 4).float()
    scale = torch.tensor([5.0, 1.0, 1.0, 0.5], device=device)
    return torch.cat([command, torch.randn((B, 4), generator=gen, device=device) * scale], dim=1)


def training_pool(cfg: dict, traffic: dict, seed: int, device: torch.device) -> List[Dict[str, np.ndarray]]:
    """`pool_batches` numpy batches of `batch` training samples."""
    B, P, n = traffic["batch"], cfg["num_poses"], cfg["num_bounding_boxes"]
    H, W = cfg["camera_height"], cfg["camera_width"]
    h, w = cfg["lidar_resolution_height"], cfg["lidar_resolution_width"]
    pool = []
    for i in range(traffic["pool_batches"]):
        g = torch.Generator(device=device).manual_seed(seed_for(seed, 2, i))
        camera = torch.randint(0, 256, (B, H, W, 3), generator=g, device=device, dtype=torch.uint8)
        lidar = torch.randint(0, 6, (B, h, w, 1), generator=g, device=device).float() / 5.0
        status = _status(B, g, device)
        speed = torch.rand((B, 1), generator=g, device=device) * 12.0
        t = torch.arange(1, P + 1, device=device, dtype=torch.float32) * cfg["interval_length"]
        heading = torch.cumsum(torch.randn((B, P), generator=g, device=device) * 0.03, dim=1)
        traj = torch.stack([speed * t, torch.cumsum(speed * 0.5 * torch.sin(heading), dim=1), heading], dim=-1)
        u = torch.rand((B, n, 6), generator=g, device=device)
        lo = torch.tensor([-32.0, -32.0, -math.pi, 3.5, 1.6], device=device)
        hi = torch.tensor([32.0, 32.0, math.pi, 6.0, 2.4], device=device)
        labels = u[..., 5] < 0.35
        states = (lo + (hi - lo) * u[..., :5]) * labels[..., None]
        bev = torch.randint(0, cfg["num_bev_classes"], (B, cfg["bev_pixel_height"], cfg["bev_pixel_width"]),
                            generator=g, device=device, dtype=torch.int32)
        batch = {"camera_feature": camera, "lidar_feature": lidar, "status_feature": status,
                 "trajectory": traj, "agent_states": states, "agent_labels": labels, "bev_semantic_map": bev}
        pool.append({k: v.cpu().numpy() for k, v in batch.items()})
    return pool


def _point_cloud(B: int, N: int, cfg: dict, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """(B, N, 3) float32 clouds like a lidar sweep: ranges exponential around
    the ego (10 m), obstacles straddling the split plane, ground below it, a
    few returns above the height limit, some points on the grid's edges."""
    r = -10.0 * torch.log1p(-torch.rand((B, N), generator=gen, device=device))
    phi = (torch.rand((B, N), generator=gen, device=device) * 2.0 - 1.0) * math.pi
    kind = torch.rand((B, N), generator=gen, device=device)
    u = torch.rand((B, N), generator=gen, device=device)
    top = cfg["max_height_lidar"]
    z = torch.where(kind < 0.65, u * 3.0,
                    torch.where(kind < 0.95, -0.1 + 0.1 * torch.randn((B, N), generator=gen, device=device),
                                (top - 1.0) + 51.0 * u))
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    edge = torch.rand((B, N), generator=gen, device=device) < 0.01
    x = torch.where(edge & (u < 0.5), torch.full_like(x, cfg["lidar_max_x"]), x)
    y = torch.where(edge & (u >= 0.5), torch.full_like(y, cfg["lidar_min_y"]), y)
    return torch.stack([x, y, z], dim=-1)


def sensor_batches(cfg: dict, traffic: dict, seed: int, device: torch.device
                   ) -> List[Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """`pool_batches` (raw sensor batch, head noise) pairs on the device."""
    B, N = traffic["batch"], traffic["points"]
    ch, cw = traffic["camera_shape"]
    out = []
    for i in range(traffic["pool_batches"]):
        g = torch.Generator(device=device).manual_seed(seed_for(seed, 3, i))
        cams = {name: torch.randint(0, 256, (B, ch, cw, 3), generator=g, device=device, dtype=torch.uint8)
                for name in ("camera_l0", "camera_f0", "camera_r0")}
        batch = {**cams, "lidar_points": _point_cloud(B, N, cfg, g, device),
                 "lidar_valid": torch.ones((B, N), dtype=torch.bool, device=device),
                 "status_feature": _status(B, g, device)}
        noise = torch.randn((B, cfg["ego_fut_mode"], cfg["num_poses"], 2), generator=g, device=device)
        out.append((batch, noise))
    return out
