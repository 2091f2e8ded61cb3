"""Conditional 1D UNet with FiLM conditioning (counterpart of
`diffusiondrive_tpu/models/conditional_unet1d.py`): the vanilla
diffusion-policy denoiser of the 20-step DDIM ablation.

`ConditionalUnet1D` takes and returns (B, T, C) sequences, as the Flax
module does; inside, the convolutions run over (B, C, T). Module names are
the Flax scopes (down{i}_res{j}, down{i}_ds, mid_res{j}, up{i}_res{j},
up{i}_us, final_block, final_conv; block0/block1/cond_fc/residual_conv;
conv/norm), so `utils/port_jax.py` maps a Flax tree one to one. GroupNorm
takes eps 1e-5 and float32 statistics (`layers.GroupNorm`); mish is
x * tanh(softplus(x)); the upsampler is Flax's
``ConvTranspose((4,), strides=2, padding=((2, 2),))``, torch's
`ConvTranspose1d(k=4, s=2, p=1)` with the taps reversed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from diffusiondrive_torch.models.layers import Conv1d, ConvTranspose1d, GroupNorm, Linear, mish
from diffusiondrive_torch.ops.embed import sinusoidal_pos_emb


class Conv1dBlock(nn.Module):
    """Conv1d -> GroupNorm -> Mish over (B, C, T)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, n_groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv1d(in_channels, features, kernel_size, padding=kernel_size // 2, dtype=dtype)
        self.norm = GroupNorm(n_groups, features, 1e-5, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(self.norm(self.conv(x)))


class ConditionalResidualBlock1D(nn.Module):
    """Two conv blocks with FiLM conditioning and a 1x1 residual where the width changes."""

    def __init__(self, in_channels: int, features: int, cond_dim: int, cond_predict_scale: bool = False,
                 kernel_size: int = 3, n_groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cond_predict_scale = cond_predict_scale
        self.block0 = Conv1dBlock(in_channels, features, kernel_size, n_groups, dtype)
        self.cond_fc = Linear(cond_dim, features * 2 if cond_predict_scale else features, dtype=dtype)
        self.block1 = Conv1dBlock(features, features, kernel_size, n_groups, dtype)
        if in_channels != features:
            self.residual_conv = Conv1d(in_channels, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        out = self.block0(x)
        embed = self.cond_fc(mish(cond))[:, :, None]
        if self.cond_predict_scale:
            scale, bias = embed.chunk(2, dim=1)
            out = out * scale + bias
        else:
            out = out + embed
        out = self.block1(out)
        residual = self.residual_conv(x) if hasattr(self, "residual_conv") else x
        return out + residual


class ConditionalUnet1D(nn.Module):
    """(B, T, input_dim) noisy sequence + timesteps [+ global cond] -> (B, T, input_dim)."""

    def __init__(self, input_dim: int, global_cond_dim: Optional[int] = None,
                 diffusion_step_embed_dim: int = 256, down_dims: Sequence[int] = (256, 512, 1024),
                 kernel_size: int = 3, n_groups: int = 8, cond_predict_scale: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dsed = self.dsed = diffusion_step_embed_dim
        dims = self.dims = list(down_dims)
        cond_dim = dsed + (global_cond_dim or 0)
        blk = dict(cond_predict_scale=cond_predict_scale, kernel_size=kernel_size, n_groups=n_groups,
                   dtype=dtype)
        self.time_fc1 = Linear(dsed, dsed * 4, dtype=dtype)
        self.time_fc2 = Linear(dsed * 4, dsed, dtype=dtype)
        cin = input_dim
        for i, dim in enumerate(dims):
            self.add_module(f"down{i}_res0", ConditionalResidualBlock1D(cin, dim, cond_dim, **blk))
            self.add_module(f"down{i}_res1", ConditionalResidualBlock1D(dim, dim, cond_dim, **blk))
            if i < len(dims) - 1:
                self.add_module(f"down{i}_ds", Conv1d(dim, dim, 3, stride=2, padding=1, dtype=dtype))
            cin = dim
        self.mid_res0 = ConditionalResidualBlock1D(dims[-1], dims[-1], cond_dim, **blk)
        self.mid_res1 = ConditionalResidualBlock1D(dims[-1], dims[-1], cond_dim, **blk)
        cin = dims[-1]
        for i, dim in enumerate(reversed(dims[:-1])):
            # the input and the skip it is joined with have the same width
            self.add_module(f"up{i}_res0", ConditionalResidualBlock1D(2 * cin, dim, cond_dim, **blk))
            self.add_module(f"up{i}_res1", ConditionalResidualBlock1D(dim, dim, cond_dim, **blk))
            self.add_module(f"up{i}_us", ConvTranspose1d(dim, dim, 4, stride=2, padding=1, dtype=dtype))
            cin = dim
        self.final_block = Conv1dBlock(dims[0], dims[0], kernel_size, n_groups, dtype)
        self.final_conv = Conv1d(dims[0], input_dim, 1, dtype=dtype)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                global_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = sample.shape[0]
        t = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(B)
        t_embed = self.time_fc2(mish(self.time_fc1(sinusoidal_pos_emb(t, self.dsed))))
        cond = t_embed if global_cond is None else torch.cat([t_embed, global_cond.to(t_embed.dtype)], dim=-1)

        x = sample.transpose(1, 2)
        skips = []
        for i in range(len(self.dims)):
            x = getattr(self, f"down{i}_res0")(x, cond)
            x = getattr(self, f"down{i}_res1")(x, cond)
            skips.append(x)
            if i < len(self.dims) - 1:
                x = getattr(self, f"down{i}_ds")(x)
        x = self.mid_res1(self.mid_res0(x, cond), cond)
        for i in range(len(self.dims) - 1):
            x = torch.cat([x, skips.pop()], dim=1)
            x = getattr(self, f"up{i}_res0")(x, cond)
            x = getattr(self, f"up{i}_res1")(x, cond)
            x = getattr(self, f"up{i}_us")(x)
        return self.final_conv(self.final_block(x)).transpose(1, 2)
