"""DiffusionDrive model (counterpart of `diffusiondrive_tpu/models/transfuser_model.py`).

Pipeline: backbone(camera, lidar) -> 8x8x512 BEV memory + 64x64x64 FPN BEV
-> 64 BEV tokens + 1 status token (+ learned keyval embedding) -> 3-layer
transformer decoder over [1 ego query | 30 agent queries] -> BEV semantic
head, agent box head and the trajectory head: the truncated-diffusion head
("diffusion"), the diffusion-policy UNet ("unet") or the Transfuser
baseline's MLP ("mlp"), each under the scope `trajectory_head`.

Public tensors keep the JAX layout: NHWC camera (B, 256, 1024, 3) uint8 or
float, NHWC lidar (B, 256, 256, C), status (B, 8); `bev_semantic_map` comes
back NHWC (B, 128, 256, 7). Inside, maps are NCHW in channels_last memory,
so the permutes at the edges move no bytes.

`model.train()` selects the training forward (batch-statistics BatchNorm
on cuDNN convolutions, dropout live, the head's `forward_train`);
`model.eval()` the planner forward (the fused stem and layer-1 kernels, the
head's `forward_test`: the truncated DDIM rollout, the UNet's full one).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusiondrive_torch.common.enums import BoundingBox2DIndex
from diffusiondrive_torch.models.backbone import TransfuserBackbone
from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.models.diffusion_head import DiffusionTrajectoryHead, UnetTrajectoryHead
from diffusiondrive_torch.models.layers import (
    Conv2d, Linear, LinearReluLn, Mlp, TransformerDecoder, set_dropout_generator)
from diffusiondrive_torch.models.resnet import feature_channels
from diffusiondrive_torch.ops.sampling import resize_bilinear


class AgentHead(nn.Module):
    """BEV agent box head: (x, y) in +-32 m, heading in +-pi, raw length/width."""

    def __init__(self, config: TransfuserConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = config.tf_d_model
        self.states_fc1 = Linear(d, config.tf_d_ffn, dtype=dtype)
        self.states_fc2 = Linear(config.tf_d_ffn, BoundingBox2DIndex.size(), dtype=dtype)
        self.label_fc = Linear(d, 1, dtype=dtype)

    def forward(self, agent_queries: torch.Tensor) -> Dict[str, torch.Tensor]:
        states = self.states_fc2(F.relu(self.states_fc1(agent_queries)))
        xy = torch.tanh(states[..., BoundingBox2DIndex.POINT]) * 32.0
        h = BoundingBox2DIndex.HEADING
        heading = torch.tanh(states[..., h:h + 1]) * math.pi
        agent_states = torch.cat([xy, heading, states[..., h + 1:]], dim=-1)
        return {"agent_states": agent_states, "agent_labels": self.label_fc(agent_queries)[..., 0]}


class MLPTrajectoryHead(Mlp):
    """Deterministic single-mode head of the Transfuser baseline: an `Mlp`
    (fc1, ReLU, fc2) to (x, y) raw and heading tanh x pi. It draws nothing
    (`train_draws` and `draw_noise` return None)."""

    noise_shape = None

    def __init__(self, config: TransfuserConfig, dtype: torch.dtype = torch.float32):
        super().__init__(config.tf_d_model, config.tf_d_ffn, config.num_poses * 3, F.relu, dtype)
        self.num_poses = config.num_poses

    def train_draws(self, batch: int, generator: Optional[torch.Generator] = None,
                    timesteps: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        return None, None

    def draw_noise(self, batch: int, generator: Optional[torch.Generator] = None) -> None:
        return None

    def forward(self, ego_query: torch.Tensor) -> Dict[str, torch.Tensor]:
        poses = super().forward(ego_query).reshape(ego_query.shape[0], self.num_poses, 3)
        heading = torch.tanh(poses[..., 2:3]) * math.pi
        return {"trajectory": torch.cat([poses[..., :2], heading], dim=-1)}


TRAJECTORY_HEADS = ("diffusion", "unet", "mlp")


class DiffusionDriveModel(nn.Module):
    """V2 Transfuser with a trajectory head of `trajectory_head_type`
    ("diffusion", "unet" or "mlp", JAX's argument).

    `dtype` is the compute type (Flax's `dtype`); parameters and BatchNorm
    statistics stay float32.
    """

    def __init__(self, config: TransfuserConfig, trajectory_head_type: str = "diffusion",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if trajectory_head_type not in TRAJECTORY_HEADS:
            raise ValueError(f"trajectory_head_type {trajectory_head_type!r} not in {TRAJECTORY_HEADS}")
        cfg = self.config = config
        self.trajectory_head_type = trajectory_head_type
        self.dtype = dtype
        d = cfg.tf_d_model
        bev_tokens = (cfg.lidar_resolution_height // 32) * (cfg.lidar_resolution_width // 32)
        self.backbone = TransfuserBackbone(cfg, dtype)
        # the last lidar stage's width: 512 for ResNet-18/34, 2048 for ResNet-50
        self.bev_downscale = Conv2d(feature_channels(cfg.lidar_architecture)[3], d, 1, dtype=dtype)
        self.status_encoding = Linear(8, d, dtype=dtype)
        self.keyval_embedding = nn.Parameter(torch.zeros(bev_tokens + 1, d))
        self.bev_proj = LinearReluLn(d + cfg.bev_features_channels, d, 1, 1, dtype)
        self.query_embedding = nn.Parameter(torch.zeros(1 + cfg.num_bounding_boxes, d))
        self.tf_decoder = TransformerDecoder(d, cfg.tf_num_head, cfg.tf_d_ffn, cfg.tf_num_layers, dtype,
                                             cfg.tf_dropout)
        self.bev_semantic_conv1 = Conv2d(cfg.bev_features_channels, cfg.bev_features_channels, 3,
                                         padding=1, dtype=dtype)
        self.bev_semantic_conv2 = Conv2d(cfg.bev_features_channels, cfg.num_bev_classes, 1, dtype=dtype)
        head = {"diffusion": DiffusionTrajectoryHead, "unet": UnetTrajectoryHead,
                "mlp": MLPTrajectoryHead}[trajectory_head_type]
        self.trajectory_head = head(cfg, dtype)
        self.agent_head = AgentHead(cfg, dtype)

    def forward(self, camera_feature: torch.Tensor, lidar_feature: torch.Tensor,
                status_feature: torch.Tensor, targets: Optional[Dict[str, torch.Tensor]] = None,
                diffusion_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                timesteps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """camera (B, H, W, 3) uint8 or float, lidar (B, h, w, C), status (B, 8).

        `diffusion_noise` (the head's `noise_shape` a row: (modes, poses, 2)
        for the diffusion head, (poses, 3) for the UNet) fixes the trajectory
        head's noise and, in train mode, `timesteps` (B,) its noising steps;
        otherwise they are drawn from `generator`, which in train mode also
        feeds every dropout. The MLP head draws nothing. `targets` is taken
        in train mode as the JAX model takes it; the UNet head reads its
        `trajectory`, the others nothing.
        """
        cfg = self.config
        if self.training:
            set_dropout_generator(self, generator)
        # uint8 cameras are normalized on the device: the host copy moves 1 B/px
        if camera_feature.dtype == torch.uint8:
            camera_feature = camera_feature.float() / 255.0
        camera = camera_feature.permute(0, 3, 1, 2).to(self.dtype)
        lidar = lidar_feature.permute(0, 3, 1, 2).to(self.dtype)
        B = status_feature.shape[0]
        d = cfg.tf_d_model

        bev_upscale, bev_feature = self.backbone(camera, lidar)
        bh, bw = bev_feature.shape[2:]

        bev_tokens = self.bev_downscale(bev_feature).flatten(2).transpose(1, 2)   # (B, 64, d)
        status_encoding = self.status_encoding(status_feature)
        keyval = torch.cat([bev_tokens, status_encoding[:, None]], dim=1)
        keyval = keyval + self.keyval_embedding[None].to(keyval.dtype)

        if self.trajectory_head_type == "diffusion":
            # the diffusion head's BEV memory; the other heads leave `bev_proj`
            # unused (JAX computes it and drops it; its gradient is zero there)
            keyval_bev = keyval[:, :-1].transpose(1, 2).reshape(B, d, bh, bw)
            keyval_bev = resize_bilinear(keyval_bev, bev_upscale.shape[2:])
            cross_bev = torch.cat([keyval_bev, bev_upscale.to(keyval_bev.dtype)], dim=1)
            cross_bev = self.bev_proj(cross_bev.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

        query = self.query_embedding[None].expand(B, -1, -1).to(keyval.dtype)
        query_out = self.tf_decoder(query, keyval)
        ego_query, agents_query = query_out[:, :1], query_out[:, 1:]

        sem = self.bev_semantic_conv2(F.relu(self.bev_semantic_conv1(bev_upscale)))
        bev_semantic_map = resize_bilinear(sem, cfg.bev_semantic_frame).permute(0, 2, 3, 1)

        output: Dict[str, torch.Tensor] = {"bev_semantic_map": bev_semantic_map}
        head = self.trajectory_head
        if self.trajectory_head_type == "mlp":
            output.update(head(ego_query))
        elif self.trajectory_head_type == "unet":
            status = status_encoding[:, None]
            output.update(head.forward_train(ego_query, status, targets, timesteps=timesteps, noise=diffusion_noise,
                                             generator=generator) if self.training else
                          head.forward_test(ego_query, status, noise=diffusion_noise, generator=generator))
        elif self.training:
            output.update(head.forward_train(ego_query, agents_query, cross_bev, timesteps=timesteps,
                                             noise=diffusion_noise, generator=generator))
        else:
            output.update(head.forward_test(ego_query, agents_query, cross_bev, noise=diffusion_noise,
                                            generator=generator))
        output.update(self.agent_head(agents_query))
        return output
