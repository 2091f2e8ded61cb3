"""Positional and timestep embeddings (counterpart of `diffusiondrive_tpu/ops/embed.py`).

Frequency tables are computed host-side in float64 and rounded once to
float32, as in the JAX package, so both index identical constants. Each
table is copied to a device once (a host-to-device copy synchronises the
stream).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _sine_dim_t(half: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        (10000.0 ** (2.0 * (np.arange(half) // 2) / half)).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _time_freqs(half: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.exp(np.arange(half) * -(math.log(10000.0) / (half - 1))).astype(np.float32)).to(device)


def gen_sineembed_for_position(pos: torch.Tensor, hidden_dim: int = 256) -> torch.Tensor:
    """(..., 2) points (x, y) -> (..., hidden_dim) = [y-embed | x-embed], each
    interleaved sin/cos over frequency pairs (DAB-DETR style)."""
    half = hidden_dim // 2
    dim_t = _sine_dim_t(half, pos.device)
    scale = 2.0 * math.pi

    def _embed(coord: torch.Tensor) -> torch.Tensor:
        p = (coord * scale)[..., None] / dim_t
        interleaved = torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], dim=-1)
        return interleaved.reshape(*p.shape[:-1], half)

    return torch.cat([_embed(pos[..., 1]), _embed(pos[..., 0])], dim=-1)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Transformer timestep embedding: (B,) -> (B, dim) = [sin | cos]."""
    half = dim // 2
    args = t.to(torch.float32)[:, None] * _time_freqs(half, t.device)[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1)
