"""Spatial sampling ops (counterpart of `diffusiondrive_tpu/ops/sampling.py`).

The port's feature maps are NCHW logical tensors (in channels_last memory),
so these take NCHW where the JAX functions take NHWC. The exception is
`resize_bilinear_no_aa`, which resizes NHWC camera images and keeps the JAX
layout.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def grid_sample_2d(value: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear grid sampling with zero padding, half-pixel corners.

    :param value: (N, C, H, W) feature map
    :param grid: (N, Hg, Wg, 2) locations in [-1, 1], last dim (x=width, y=height)
    :return: (N, Hg, Wg, C) in `value`'s dtype; sampled in float32 (float64
        for float64 values) so that bf16 coordinates do not shift the
        sample points
    """
    d = torch.float64 if value.dtype == torch.float64 else torch.float32
    out = F.grid_sample(value.to(d), grid.to(d), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1).to(value.dtype)


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear upsample of (N, C, H, W) to (N, C, *size), half-pixel centers.

    The JAX counterpart is `jax.image.resize`, which antialiases when it
    downsamples; the model only ever upsamples, where both agree.
    """
    size = (int(size[0]), int(size[1]))
    if size[0] < x.shape[2] or size[1] < x.shape[3]:
        raise ValueError(f"resize_bilinear only upsamples: {tuple(x.shape[2:])} -> {size}")
    if size == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def resize_bilinear_no_aa(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of NHWC (N, H, W, C) to (N, *size, C) WITHOUT
    antialiasing: cv2 INTER_LINEAR semantics (half-pixel centers, 2-tap
    kernel) also when downsampling. Returns float32.

    The float32 index arithmetic, the clips and the order of operations are
    those of the JAX function, so both give the same values. The four taps
    are gathered in `x`'s dtype and converted after the gather (exact for a
    uint8 image), so a uint8 input is never materialised in float32 at full
    size.
    """
    N, H, W, C = x.shape
    oh, ow = int(size[0]), int(size[1])
    ys = (torch.arange(oh, dtype=torch.float32, device=x.device) + 0.5) * (H / oh) - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=x.device) + 0.5) * (W / ow) - 0.5

    y0 = torch.clamp(torch.floor(ys), 0, H - 1).long()
    x0 = torch.clamp(torch.floor(xs), 0, W - 1).long()
    y1 = torch.clamp_max(y0 + 1, H - 1)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    ty = torch.clamp(ys - y0, 0.0, 1.0)[None, :, None, None]
    tx = torch.clamp(xs - x0, 0.0, 1.0)[None, None, :, None]

    rows0, rows1 = x.index_select(1, y0), x.index_select(1, y1)
    top = rows0.index_select(2, x0).float() * (1 - tx) + rows0.index_select(2, x1).float() * tx
    bot = rows1.index_select(2, x0).float() * (1 - tx) + rows1.index_select(2, x1).float() * tx
    return top * (1 - ty) + bot * ty


def adaptive_avg_pool2d(x: torch.Tensor, output_size: Sequence[int]) -> torch.Tensor:
    """Average pool (N, C, H, W) to (N, C, *output_size); integer factors only."""
    H, W = x.shape[2:]
    oh, ow = output_size
    if H % oh or W % ow:
        raise ValueError(f"adaptive pool needs integer factors, got {(H, W)} -> {(oh, ow)}")
    return F.avg_pool2d(x, (H // oh, W // ow))


def take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather ``arr[b, idx[b, i]]``: (B, N, ...), (B, I) -> (B, I, ...).

    Counterpart of the JAX package's `onehot_take_rows` (a one-hot matmul
    there, for the TPU's sake); here a plain gather.
    """
    batch = torch.arange(arr.shape[0], device=arr.device)[:, None]
    return arr[batch, idx]
