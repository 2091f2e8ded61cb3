"""Truncated-diffusion trajectory head (counterpart of `diffusiondrive_tpu/models/diffusion_head.py`).

Test path only (`forward_test`): the plan anchors are noised at the
truncation step t=8, then denoised with 2 DDIM steps (timesteps 10, 0);
each step runs the full cascade of decoder layers and feeds the predicted
x/y back through the scheduler. `forward_train` comes with the training
slice.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.models.layers import (
    Conv2d, LayerNorm, Linear, LinearReluLn, MultiHeadAttention, mish)
from diffusiondrive_torch.ops.ddim import DDIMScheduler
from diffusiondrive_torch.ops.embed import gen_sineembed_for_position, sinusoidal_pos_emb
from diffusiondrive_torch.ops.sampling import grid_sample_2d, take_rows

# Normalization box of the ego-frame trajectory space:
# x in [-1.2, 55.7], y in [-20, 26], heading in [-2, 1.9].
_NORM_OFFSET = np.array([1.2, 20.0, 2.0], dtype=np.float32)
_NORM_SCALE = np.array([56.9, 46.0, 3.9], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _norm_box(d: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offset, scale) of the first `d` coordinates, copied to `device` once."""
    return (torch.from_numpy(_NORM_OFFSET[:d]).to(device),
            torch.from_numpy(_NORM_SCALE[:d]).to(device))


def norm_odo(x: torch.Tensor) -> torch.Tensor:
    """Map ego-frame (x, y[, heading]) into [-1, 1] diffusion space."""
    off, scale = _norm_box(x.shape[-1], x.device)
    return 2.0 * (x + off) / scale - 1.0


def denorm_odo(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`norm_odo`."""
    off, scale = _norm_box(x.shape[-1], x.device)
    return (x + 1.0) / 2.0 * scale - off


def default_plan_anchors() -> np.ndarray:
    """The default (20, 8, 2) plan anchors shipped with the package: k-means
    centroids of synthetic driving rollouts, the same asset as the JAX
    package's."""
    return np.load(Path(__file__).parent.parent / "assets" / "default_plan_anchors.npy").astype(np.float32)


class GridSampleCrossBEVAttention(nn.Module):
    """Per-trajectory-point BEV feature sampling with learned point weights."""

    def __init__(self, config: TransfuserConfig, num_points: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        d = config.tf_d_model
        self.attention_weights = Linear(d, num_points, dtype=dtype)
        self.value_conv = Conv2d(d, 256, 3, padding=1, dtype=dtype)
        self.output_proj = Linear(256, d, dtype=dtype)

    def forward(self, queries: torch.Tensor, traj_points: torch.Tensor,
                bev_feature: torch.Tensor) -> torch.Tensor:
        """queries (B, M, C), traj_points (B, M, P, 2) ego meters, bev_feature (B, C_bev, H, W)."""
        cfg = self.config
        # ego frame (x forward, y left) -> grid coords: gx = y / max_y, gy = x / max_x
        grid = torch.stack([traj_points[..., 1] / cfg.lidar_max_y,
                            traj_points[..., 0] / cfg.lidar_max_x], dim=-1)
        attention = torch.softmax(self.attention_weights(queries), dim=-1)  # (B, M, P)
        value = F.relu(self.value_conv(bev_feature))
        sampled = grid_sample_2d(value, grid)                                # (B, M, P, 256)
        out = torch.einsum("bmp,bmpc->bmc", attention, sampled)
        return self.output_proj(out) + queries


class ModulationLayer(nn.Module):
    """Time-conditioned FiLM: x * (1 + scale) + shift."""

    def __init__(self, embed_dims: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale_shift = Linear(embed_dims, embed_dims * 2, dtype=dtype)

    def forward(self, x: torch.Tensor, time_embed: torch.Tensor) -> torch.Tensor:
        scale, shift = self.scale_shift(mish(time_embed)).chunk(2, dim=-1)
        return x * (1.0 + scale) + shift


class PlanningRefinement(nn.Module):
    """Reg/cls branches."""

    def __init__(self, embed_dims: int, num_poses: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_poses = num_poses
        self.cls_ln = LinearReluLn(embed_dims, embed_dims, in_loops=1, out_loops=2, dtype=dtype)
        self.cls_out = Linear(embed_dims, 1, dtype=dtype)
        self.reg_fc1 = Linear(embed_dims, embed_dims, dtype=dtype)
        self.reg_fc2 = Linear(embed_dims, embed_dims, dtype=dtype)
        self.reg_out = Linear(embed_dims, num_poses * 3, dtype=dtype)

    def forward(self, traj_feature: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, M, _ = traj_feature.shape
        plan_cls = self.cls_out(self.cls_ln(traj_feature))[..., 0]
        h = F.relu(self.reg_fc1(traj_feature))
        h = F.relu(self.reg_fc2(h))
        plan_reg = self.reg_out(h).reshape(B, M, self.num_poses, 3)
        return plan_reg, plan_cls


class DiffusionDecoderLayer(nn.Module):
    """One cascade layer: BEV sampling, agent/ego cross-attention, FFN, time
    FiLM, residual pose refinement."""

    def __init__(self, config: TransfuserConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        d = cfg.tf_d_model
        self.cross_bev = GridSampleCrossBEVAttention(cfg, cfg.num_poses, dtype)
        self.cross_agent = MultiHeadAttention(d, cfg.tf_num_head, dtype)
        self.norm1 = LayerNorm(d, dtype)
        self.cross_ego = MultiHeadAttention(d, cfg.tf_num_head, dtype)
        self.norm2 = LayerNorm(d, dtype)
        self.ffn_fc1 = Linear(d, cfg.tf_d_ffn, dtype=dtype)
        self.ffn_fc2 = Linear(cfg.tf_d_ffn, d, dtype=dtype)
        self.norm3 = LayerNorm(d, dtype)
        self.time_modulation = ModulationLayer(d, dtype)
        self.task_decoder = PlanningRefinement(d, cfg.num_poses, dtype)

    def forward(self, traj_feature, noisy_traj_points, bev_feature, agents_query, ego_query,
                time_embed) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.cross_bev(traj_feature, noisy_traj_points, bev_feature)
        x = self.norm1(x + self.cross_agent(x, agents_query, agents_query))
        x = self.norm2(x + self.cross_ego(x, ego_query, ego_query))
        # the reference replaces (not residually adds) with norm3(ffn(x))
        x = self.norm3(self.ffn_fc2(F.relu(self.ffn_fc1(x))))
        x = self.time_modulation(x, time_embed)
        poses_reg, poses_cls = self.task_decoder(x)
        poses_xy = poses_reg[..., :2] + noisy_traj_points
        poses_heading = torch.tanh(poses_reg[..., 2:3]) * math.pi
        return torch.cat([poses_xy, poses_heading.to(poses_xy.dtype)], dim=-1), poses_cls


class DiffusionTrajectoryHead(nn.Module):
    """Anchored truncated-diffusion planner head."""

    def __init__(self, config: TransfuserConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        d = cfg.tf_d_model
        self.scheduler = DDIMScheduler()
        anchors = default_plan_anchors()
        if anchors.shape != (cfg.ego_fut_mode, cfg.num_poses, 2):
            raise ValueError(f"the shipped plan anchors are {anchors.shape}; config wants "
                             f"{(cfg.ego_fut_mode, cfg.num_poses, 2)}: load anchors into `plan_anchor`")
        self.register_buffer("plan_anchor", torch.from_numpy(anchors))
        self.anchor_encoder_ln = LinearReluLn(cfg.num_poses * 64, d, 1, 1, dtype)
        self.anchor_encoder_out = Linear(d, d, dtype=dtype)
        self.time_fc1 = Linear(d, d * 4, dtype=dtype)
        self.time_fc2 = Linear(d * 4, d, dtype=dtype)
        for i in range(cfg.diff_decoder_layers):
            self.add_module(f"layer{i}", DiffusionDecoderLayer(cfg, dtype))

    def _embed_anchor(self, points: torch.Tensor) -> torch.Tensor:
        """(B, M, P, 2) points -> (B, M, d) anchor embedding."""
        B, M, P, _ = points.shape
        pos = gen_sineembed_for_position(points, hidden_dim=64).reshape(B, M, P * 64)
        return self.anchor_encoder_out(self.anchor_encoder_ln(pos))

    def _embed_time(self, timesteps: torch.Tensor) -> torch.Tensor:
        """(B,) int timesteps -> (B, 1, d)."""
        h = sinusoidal_pos_emb(timesteps, self.config.tf_d_model)
        return self.time_fc2(mish(self.time_fc1(h)))[:, None, :]

    def _run_cascade(self, traj_feature, traj_points, bev_feature, agents_query, ego_query,
                     time_embed) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        regs, clss = [], []
        points = traj_points
        for i in range(self.config.diff_decoder_layers):
            poses_reg, poses_cls = getattr(self, f"layer{i}")(
                traj_feature, points, bev_feature, agents_query, ego_query, time_embed)
            regs.append(poses_reg)
            clss.append(poses_cls)
            points = poses_reg[..., :2].detach()
        return regs, clss

    def forward_test(self, ego_query: torch.Tensor, agents_query: torch.Tensor,
                     bev_feature: torch.Tensor,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Truncated 2-step DDIM rollout.

        `noise` (B, M, P, 2) fixes the anchor-noising draw; otherwise it is
        drawn from `generator` on the anchors' device.
        """
        cfg = self.config
        B = ego_query.shape[0]
        device = self.plan_anchor.device
        img = norm_odo(self.plan_anchor[None].expand(B, -1, -1, -1))
        if noise is None:
            noise = torch.randn(img.shape, generator=generator, device=device, dtype=img.dtype)
        trunc_t = torch.full((B,), cfg.diffusion_test_trunc_t, dtype=torch.long, device=device)
        img = self.scheduler.add_noise(img, noise.to(device=device, dtype=img.dtype), trunc_t)

        poses_reg = poses_cls = None
        for k in self.scheduler.truncated_rollout_timesteps(cfg.diffusion_test_steps,
                                                            cfg.diffusion_test_span):
            points = denorm_odo(img.clamp(-1.0, 1.0))
            traj_feature = self._embed_anchor(points)
            time_embed = self._embed_time(torch.full((B,), k, dtype=torch.long, device=device))
            regs, clss = self._run_cascade(traj_feature, points, bev_feature, agents_query,
                                           ego_query, time_embed)
            poses_reg, poses_cls = regs[-1], clss[-1]
            img = self.scheduler.step(norm_odo(poses_reg[..., :2]), k, img)

        mode_idx = poses_cls.argmax(dim=-1)
        best = take_rows(poses_reg, mode_idx[:, None])[:, 0]
        return {"trajectory": best, "poses_reg": poses_reg, "poses_cls": poses_cls}
