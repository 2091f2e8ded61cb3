"""The reference's sensor preprocessing: the raw sensors a scene brings to the
planner's inputs, as NAVSIM's Transfuser features define them.

- `camera`: the left, front and right 1920x1080 images cropped (28 rows off
  top and bottom, 416 columns off the outer side of each side camera),
  placed side by side, resized to 1024x256 by bilinear interpolation at
  half-pixel centres without antialiasing (OpenCV's INTER_LINEAR), scaled
  to [0, 1];
- `lidar_bev`: points above the 0.2 m split plane and below the height
  limit, binned into a 256x256 histogram over +-32 m (half-open bins, the
  outer edge in the last bin), clipped at 5 a pixel and divided by 5.
"""

from __future__ import annotations

import torch

ROW_CROP = 28
SIDE_CROP = 416


def resize_linear(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, oh, ow, C) float32, INTER_LINEAR semantics."""
    N, H, W, C = x.shape
    ys = (torch.arange(oh, dtype=torch.float32, device=x.device) + 0.5) * (H / oh) - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=x.device) + 0.5) * (W / ow) - 0.5
    y0 = ys.floor().clamp(0, H - 1).long()
    x0 = xs.floor().clamp(0, W - 1).long()
    y1, x1 = (y0 + 1).clamp_max(H - 1), (x0 + 1).clamp_max(W - 1)
    wy = (ys - y0).clamp(0.0, 1.0)[None, :, None, None]
    wx = (xs - x0).clamp(0.0, 1.0)[None, None, :, None]
    a, b = x[:, y0].float(), x[:, y1].float()
    top = a[:, :, x0] * (1 - wx) + a[:, :, x1] * wx
    bot = b[:, :, x0] * (1 - wx) + b[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def camera(l0: torch.Tensor, f0: torch.Tensor, r0: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Three (B, 1080, 1920, 3) uint8 images -> (B, 256, 1024, 3) float32 in [0, 1]."""
    rows = slice(ROW_CROP, -ROW_CROP)
    side = slice(SIDE_CROP, -SIDE_CROP)
    wide = torch.cat([l0[:, rows, side], f0[:, rows], r0[:, rows, side]], dim=2)
    return resize_linear(wide, cfg["camera_height"], cfg["camera_width"]) / 255.0


def lidar_bev(points: torch.Tensor, valid: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, N, 3) float32 points, (B, N) bool -> (B, bins, bins, 1) float32."""
    bins = cfg["lidar_resolution_width"]
    lo_x, hi_x, lo_y, hi_y = cfg["lidar_min_x"], cfg["lidar_max_x"], cfg["lidar_min_y"], cfg["lidar_max_y"]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    keep = valid & (z < cfg["max_height_lidar"]) & (z > cfg["lidar_split_height"])
    keep &= (x >= lo_x) & (x <= hi_x) & (y >= lo_y) & (y <= hi_y)
    ix = torch.floor((x - lo_x) * (bins / (hi_x - lo_x))).long().clamp(0, bins - 1)
    iy = torch.floor((y - lo_y) * (bins / (hi_y - lo_y))).long().clamp(0, bins - 1)
    B = points.shape[0]
    flat = (torch.arange(B, device=points.device)[:, None] * bins + ix) * bins + iy
    hist = torch.zeros(B * bins * bins, dtype=torch.float32, device=points.device)
    hist.index_add_(0, flat[keep], torch.ones(int(keep.sum()), dtype=torch.float32, device=points.device))
    cap = float(cfg["hist_max_per_pixel"])
    return (hist.reshape(B, bins, bins).clamp_max(cap) / cap)[..., None]
