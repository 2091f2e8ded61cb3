"""The diffusion trajectory heads (counterpart of `diffusiondrive_tpu/models/diffusion_head.py`).

`DiffusionTrajectoryHead` is DiffusionDrive's truncated-diffusion head;
`UnetTrajectoryHead` the vanilla diffusion-policy ablation (below).

Train (`forward_train`): the plan anchors are noised at a random
t in [0, 50), clamped in normalised space, denormalised, sine-embedded and
refined by the cascade of decoder layers with dropout live; every layer
emits (reg, cls) for the loss, and the points are detached between layers.

Test (`forward_test`): the plan anchors are noised at the truncation step
t=8, then denoised with 2 DDIM steps (timesteps 10, 0); each step runs the
full cascade of decoder layers and feeds the predicted x/y back through the
scheduler.
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
    Conv2d, Dropout, LayerNorm, Linear, LinearReluLn, MultiHeadAttention, mish)
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


@functools.lru_cache(maxsize=None)
def _kmeans_anchors(num_modes: int, num_poses: int) -> np.ndarray:
    from diffusiondrive_torch.utils.anchors import kmeans_plan_anchors, synthetic_driving_trajectories

    return kmeans_plan_anchors(synthetic_driving_trajectories(num_poses=num_poses), num_modes)


def default_plan_anchors(num_modes: int = 20, num_poses: int = 8) -> np.ndarray:
    """Default (num_modes, num_poses, 2) plan anchors, as the JAX package
    makes them: the shipped (20, 8) asset (the JAX package's file), else
    k-means centroids of synthetic driving rollouts (`utils/anchors.py`,
    numpy with fixed seeds: the JAX package's anchors bit for bit; computed
    once a process per shape)."""
    asset = Path(__file__).parent.parent / "assets" / "default_plan_anchors.npy"
    if num_modes == 20 and num_poses == 8 and asset.exists():
        return np.load(asset).astype(np.float32)
    return _kmeans_anchors(num_modes, num_poses).copy()


class GridSampleCrossBEVAttention(nn.Module):
    """Per-trajectory-point BEV feature sampling with learned point weights."""

    def __init__(self, config: TransfuserConfig, num_points: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        d = config.tf_d_model
        self.attention_weights = Linear(d, num_points, dtype=dtype)
        self.value_conv = Conv2d(d, 256, 3, padding=1, dtype=dtype)
        self.output_proj = Linear(256, d, dtype=dtype)
        self.drop = Dropout(0.1)

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
        return self.drop(self.output_proj(out)) + queries


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
        self.cross_agent = MultiHeadAttention(d, cfg.tf_num_head, dtype, cfg.tf_dropout)
        self.norm1 = LayerNorm(d, dtype)
        self.cross_ego = MultiHeadAttention(d, cfg.tf_num_head, dtype, cfg.tf_dropout)
        self.norm2 = LayerNorm(d, dtype)
        self.drop_agent, self.drop_ego = Dropout(0.1), Dropout(0.1)
        self.ffn_fc1 = Linear(d, cfg.tf_d_ffn, dtype=dtype)
        self.ffn_fc2 = Linear(cfg.tf_d_ffn, d, dtype=dtype)
        self.norm3 = LayerNorm(d, dtype)
        self.time_modulation = ModulationLayer(d, dtype)
        self.task_decoder = PlanningRefinement(d, cfg.num_poses, dtype)

    def forward(self, traj_feature, noisy_traj_points, bev_feature, agents_query, ego_query,
                time_embed) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.cross_bev(traj_feature, noisy_traj_points, bev_feature)
        x = self.norm1(x + self.drop_agent(self.cross_agent(x, agents_query, agents_query)))
        x = self.norm2(x + self.drop_ego(self.cross_ego(x, ego_query, ego_query)))
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
        self.register_buffer("plan_anchor", torch.from_numpy(default_plan_anchors(cfg.ego_fut_mode,
                                                                                  cfg.num_poses)))
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

    @property
    def train_max_t(self) -> int:
        """The training timesteps are drawn from [0, train_max_t)."""
        return self.config.diffusion_train_max_t

    @property
    def noise_shape(self) -> Tuple[int, ...]:
        """A row's noise: (M, P, 2), the anchors' shape."""
        return tuple(self.plan_anchor.shape)

    def train_draws(self, batch: int, generator: Optional[torch.Generator] = None,
                    timesteps: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward's two draws for `batch` rows, (timesteps (B,),
        noise (B, M, P, 2)), each drawn from `generator` on the anchors'
        device unless given (timesteps first, as JAX draws). Data-parallel
        training draws them for the global batch and gives each rank its
        rows, as a JAX step sharded over a mesh draws them."""
        if timesteps is None:
            timesteps = torch.randint(0, self.train_max_t, (batch,), generator=generator,
                                      device=self.plan_anchor.device)
        if noise is None:
            noise = self.draw_noise(batch, generator)
        return timesteps, noise

    def draw_noise(self, batch: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, M, P, 2) standard normal noise for `batch` rows from `generator`
        on the anchors' device, as either forward draws it. Data-parallel
        callers draw it for the global batch and give each rank or device
        its rows."""
        return torch.randn((batch, *self.plan_anchor.shape), generator=generator, device=self.plan_anchor.device,
                           dtype=torch.promote_types(self.plan_anchor.dtype, torch.float32))

    def forward_train(self, ego_query: torch.Tensor, agents_query: torch.Tensor,
                      bev_feature: torch.Tensor, timesteps: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The training forward: per-layer (reg, cls) stacks for the loss and
        the best mode's trajectory.

        `timesteps` (B,) ints in [0, diffusion_train_max_t) and `noise`
        (B, M, P, 2) fix the two draws; otherwise each is drawn from
        `generator` on the anchors' device (timesteps first, as JAX draws).
        """
        B = ego_query.shape[0]
        device = self.plan_anchor.device
        anchors = self.plan_anchor[None].expand(B, -1, -1, -1)
        normed = norm_odo(anchors)
        timesteps, noise = self.train_draws(B, generator, timesteps, noise)
        timesteps = timesteps.to(device)
        noisy = self.scheduler.add_noise(normed, noise.to(device=device, dtype=normed.dtype), timesteps)
        noisy_points = denorm_odo(noisy.clamp(-1.0, 1.0))

        traj_feature = self._embed_anchor(noisy_points)
        time_embed = self._embed_time(timesteps)
        regs, clss = self._run_cascade(traj_feature, noisy_points, bev_feature, agents_query,
                                       ego_query, time_embed)
        mode_idx = clss[-1].argmax(dim=-1)
        best = take_rows(regs[-1], mode_idx[:, None])[:, 0]
        return {"trajectory": best,
                "poses_reg_layers": torch.stack(regs),   # (L, B, M, P, 3)
                "poses_cls_layers": torch.stack(clss),   # (L, B, M)
                "plan_anchor": anchors}

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
            noise = self.draw_noise(B, generator)
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


class UnetTrajectoryHead(nn.Module):
    """Vanilla diffusion-policy trajectory head (the 20-step DDIM ablation).

    The normalised (x, y, heading) trajectory is denoised by
    `ConditionalUnet1D` with sample-prediction DDIM, FiLM-conditioned on the
    ego query and the status encoding.

    Train (`forward_train`): the GT trajectory is noised at a timestep in
    [0, 1000) and clamped; the UNet predicts the clean sample, returned
    clamped and denormalised (the single-mode L1 loss reads it). Test
    (`forward_test`): `unet_test_steps` DDIM steps ((950, 900, ..., 0) for
    20) from standard normal noise of shape (B, P, 3). Both take their draws
    as the diffusion head's do: `timesteps=`, `noise=`, else from
    `generator` (`train_draws`, `draw_noise`; timesteps first).
    """

    def __init__(self, config: TransfuserConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        from diffusiondrive_torch.models.conditional_unet1d import ConditionalUnet1D

        cfg = self.config = config
        self.scheduler = DDIMScheduler()
        self.unet = ConditionalUnet1D(input_dim=3, global_cond_dim=2 * cfg.tf_d_model,
                                      down_dims=tuple(cfg.unet_down_dims), dtype=dtype)

    @property
    def train_max_t(self) -> int:
        """The training timesteps are drawn from [0, train_max_t)."""
        return self.scheduler.num_train_timesteps

    @property
    def noise_shape(self) -> Tuple[int, ...]:
        """A row's noise: (P, 3), one trajectory."""
        return (self.config.num_poses, 3)

    def _device(self) -> torch.device:
        return self.unet.final_conv.weight.device

    def draw_noise(self, batch: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, P, 3) standard normal noise for `batch` rows from `generator`
        on the head's device (float32; float64 for a float64 head)."""
        w = self.unet.final_conv.weight
        return torch.randn((batch, *self.noise_shape), generator=generator, device=w.device,
                           dtype=torch.promote_types(w.dtype, torch.float32))

    def train_draws(self, batch: int, generator: Optional[torch.Generator] = None,
                    timesteps: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(timesteps (B,) in [0, 1000), noise (B, P, 3)), each from
        `generator` on the head's device unless given (timesteps first)."""
        if timesteps is None:
            timesteps = torch.randint(0, self.train_max_t, (batch,), generator=generator, device=self._device())
        if noise is None:
            noise = self.draw_noise(batch, generator)
        return timesteps, noise

    @staticmethod
    def _cond(ego_query: torch.Tensor, status_encoding: torch.Tensor) -> torch.Tensor:
        """(B, 1, d) ego query + (B, 1, d) status token -> (B, 2d) global cond."""
        return torch.cat([ego_query[:, 0], status_encoding[:, 0].to(ego_query.dtype)], dim=-1)

    def forward_train(self, ego_query: torch.Tensor, status_encoding: torch.Tensor,
                      targets: Dict[str, torch.Tensor], timesteps: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        cond = self._cond(ego_query, status_encoding)
        normed = norm_odo(targets["trajectory"])
        timesteps, noise = self.train_draws(normed.shape[0], generator, timesteps, noise)
        timesteps = timesteps.to(normed.device)
        noisy = self.scheduler.add_noise(normed, noise.to(device=normed.device, dtype=normed.dtype),
                                         timesteps).clamp(-1.0, 1.0)
        pred = self.unet(noisy, timesteps, cond)
        return {"trajectory": denorm_odo(pred.clamp(-1.0, 1.0))}

    def forward_test(self, ego_query: torch.Tensor, status_encoding: torch.Tensor,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        cond = self._cond(ego_query, status_encoding)
        B = ego_query.shape[0]
        img = self.draw_noise(B, generator) if noise is None else noise.to(ego_query.device)
        steps = self.config.unet_test_steps
        for k in self.scheduler.rollout_timesteps(steps):
            t = torch.full((B,), k, dtype=torch.long, device=img.device)
            pred = self.unet(img.clamp(-1.0, 1.0), t, cond)
            # the update runs in the wider of the two types (float32 under bf16), as in JAX
            pred = pred.to(torch.promote_types(pred.dtype, img.dtype))
            img = self.scheduler.step(pred, k, img, num_inference_steps=steps)
        return {"trajectory": denorm_odo(img.clamp(-1.0, 1.0))}
