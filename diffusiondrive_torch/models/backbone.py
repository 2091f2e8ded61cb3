"""Transfuser sensor-fusion backbone (counterpart of `diffusiondrive_tpu/models/backbone.py`).

Two ResNet branches run stage by stage; after each stage both feature maps
are pooled to fixed token grids, jointly self-attended by a small GPT,
projected back, bilinearly upsampled and residually added. The lidar
branch's final map is the transformer-decoder memory and the FPN input.
Feature maps are NCHW logical in channels_last memory; eval only (dropout
is the identity). The GPT attention is plain matmul + softmax, as the JAX
package's default path is.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.models.layers import Conv2d, LayerNorm, Linear, softmax_f32
from diffusiondrive_torch.models.resnet import ARCH_SPECS, ResNetStage, ResNetStem
from diffusiondrive_torch.ops.sampling import adaptive_avg_pool2d, resize_bilinear


class GPTSelfAttention(nn.Module):
    """Fused-token self-attention (query/key/value/proj)."""

    def __init__(self, n_embd: int, n_head: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head = n_head
        self.query = Linear(n_embd, n_embd, dtype=dtype)
        self.key = Linear(n_embd, n_embd, dtype=dtype)
        self.value = Linear(n_embd, n_embd, dtype=dtype)
        self.proj = Linear(n_embd, n_embd, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        d_head = C // self.n_head

        def split(t):
            return t.reshape(B, T, self.n_head, d_head).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        att = softmax_f32((q @ k.transpose(-2, -1)) / math.sqrt(d_head))
        y = (att @ v).transpose(1, 2).reshape(B, T, C)
        return self.proj(y)


class GPTBlock(nn.Module):
    """Pre-LN transformer block with ReLU MLP."""

    def __init__(self, n_embd: int, n_head: int, block_exp: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(n_embd, dtype)
        self.attn = GPTSelfAttention(n_embd, n_head, dtype)
        self.ln2 = LayerNorm(n_embd, dtype)
        self.mlp_fc1 = Linear(n_embd, block_exp * n_embd, dtype=dtype)
        self.mlp_fc2 = Linear(block_exp * n_embd, n_embd, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp_fc2(F.relu(self.mlp_fc1(self.ln2(x))))


class GPTFusion(nn.Module):
    """Joint image + lidar token transformer for one backbone stage."""

    def __init__(self, n_embd: int, config: TransfuserConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.n_img = cfg.img_vert_anchors * cfg.img_horz_anchors
        self.n_layer = cfg.n_layer
        n_lidar = cfg.lidar_vert_anchors * cfg.lidar_horz_anchors
        self.pos_emb = nn.Parameter(torch.zeros(1, self.n_img + n_lidar, n_embd))
        for i in range(cfg.n_layer):
            self.add_module(f"block{i}", GPTBlock(n_embd, cfg.n_head, cfg.block_exp, dtype))
        self.ln_f = LayerNorm(n_embd, dtype)

    def forward(self, image_tokens: torch.Tensor,
                lidar_tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_tokens (B, C, ih, iw), lidar_tokens (B, C, lh, lw) -> same shapes."""
        B, C, ih, iw = image_tokens.shape
        _, _, lh, lw = lidar_tokens.shape
        tokens = torch.cat([image_tokens.flatten(2).transpose(1, 2),
                            lidar_tokens.flatten(2).transpose(1, 2)], dim=1)
        x = tokens + self.pos_emb.to(tokens.dtype)
        for i in range(self.n_layer):
            x = getattr(self, f"block{i}")(x)
        x = self.ln_f(x)
        img = x[:, :self.n_img].transpose(1, 2).reshape(B, C, ih, iw)
        lid = x[:, self.n_img:].transpose(1, 2).reshape(B, C, lh, lw)
        return img, lid


class TransfuserBackbone(nn.Module):
    """Interleaved two-branch ResNet with per-stage GPT fusion + BEV FPN."""

    def __init__(self, config: TransfuserConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        img_block, img_sizes, img_widths, img_chs = ARCH_SPECS[cfg.image_architecture]
        lid_block, lid_sizes, lid_widths, lid_chs = ARCH_SPECS[cfg.lidar_architecture]
        self.image_encoder_stem = ResNetStem(3, dtype)
        self.lidar_encoder_stem = ResNetStem(cfg.lidar_in_channels, dtype)
        img_in = lid_in = 64
        for i in range(4):
            stride = 1 if i == 0 else 2
            self.add_module(f"image_encoder_layer{i + 1}", ResNetStage(
                img_in, img_widths[i], img_sizes[i], stride, img_block, dtype))
            self.add_module(f"lidar_encoder_layer{i + 1}", ResNetStage(
                lid_in, lid_widths[i], lid_sizes[i], stride, lid_block, dtype))
            img_in, lid_in = img_chs[i], lid_chs[i]
            self.add_module(f"lidar_to_img{i}", Conv2d(lid_chs[i], img_chs[i], 1, dtype=dtype))
            self.add_module(f"fusion{i}", GPTFusion(img_chs[i], cfg, dtype))
            self.add_module(f"img_to_lidar{i}", Conv2d(img_chs[i], lid_chs[i], 1, dtype=dtype))
        channel = cfg.bev_features_channels
        self.c5_conv = Conv2d(lid_chs[3], channel, 1, dtype=dtype)
        self.up_conv5 = Conv2d(channel, channel, 3, padding=1, dtype=dtype)
        self.up_conv4 = Conv2d(channel, channel, 3, padding=1, dtype=dtype)

    def forward(self, camera: torch.Tensor, lidar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """camera (B, 3, H, W), lidar (B, C_lidar, h, w) ->
        (bev_feature_upscale (B, 64, h/4, w/4), bev_feature (B, 512, h/32, w/32))."""
        cfg = self.config
        img = self.image_encoder_stem(camera)
        lid = self.lidar_encoder_stem(lidar)
        for i in range(4):
            img = getattr(self, f"image_encoder_layer{i + 1}")(img)
            lid = getattr(self, f"lidar_encoder_layer{i + 1}")(lid)
            img_tokens = adaptive_avg_pool2d(img, (cfg.img_vert_anchors, cfg.img_horz_anchors))
            lid_tokens = adaptive_avg_pool2d(lid, (cfg.lidar_vert_anchors, cfg.lidar_horz_anchors))
            lid_tokens = getattr(self, f"lidar_to_img{i}")(lid_tokens)
            img_out, lid_out = getattr(self, f"fusion{i}")(img_tokens, lid_tokens)
            lid_out = getattr(self, f"img_to_lidar{i}")(lid_out)
            img = img + resize_bilinear(img_out, img.shape[2:])
            lid = lid + resize_bilinear(lid_out, lid.shape[2:])

        bev_feature = lid
        p5 = F.relu(self.c5_conv(bev_feature))
        p5_up = resize_bilinear(p5, (p5.shape[2] * cfg.bev_upsample_factor,
                                     p5.shape[3] * cfg.bev_upsample_factor))
        p4 = F.relu(self.up_conv5(p5_up))
        target = (cfg.lidar_resolution_height // cfg.bev_down_sample_factor,
                  cfg.lidar_resolution_width // cfg.bev_down_sample_factor)
        p3 = F.relu(self.up_conv4(resize_bilinear(p4, target)))
        return p3, bev_feature
