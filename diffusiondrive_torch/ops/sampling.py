"""Spatial sampling ops (counterpart of `diffusiondrive_tpu/ops/sampling.py`).

The port's feature maps are NCHW logical tensors (in channels_last memory),
so these take NCHW where the JAX functions take NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def grid_sample_2d(value: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear grid sampling with zero padding, half-pixel corners.

    :param value: (N, C, H, W) feature map
    :param grid: (N, Hg, Wg, 2) locations in [-1, 1], last dim (x=width, y=height)
    :return: (N, Hg, Wg, C) in `value`'s dtype; sampled in float32 so that
        bf16 coordinates do not shift the sample points
    """
    out = F.grid_sample(value.float(), grid.float(), mode="bilinear",
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
