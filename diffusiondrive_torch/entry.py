"""Entry points: the planner and the raw-sensor agent, with seeded inputs.

`entry()` builds the full-width DiffusionDrive planner (default
`TransfuserConfig`: ResNet-34 branches, 256x1024 camera, 256x256 lidar BEV)
in eval mode with seeded random weights, plus example inputs, on CUDA unless
`device="cpu"` is passed; it is the port's counterpart of
`__graft_entry__.entry()`. `agent_entry()` builds the
`DiffusionDriveAgent` that preprocesses the raw sensors on the device, plus a
seeded `AgentInput` (`example_agent_input`), for
``agent.compute_trajectory(agent_input)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from diffusiondrive_torch.common.dataclasses import (
    CAMERA_NAMES, AgentInput, Camera, Cameras, EgoStatus, Lidar)
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.models.layers import flax_default_init_
from diffusiondrive_torch.models.transfuser_model import DiffusionDriveModel


def build_model(config: Optional[TransfuserConfig] = None, dtype: torch.dtype = torch.float32,
                seed: int = 0) -> DiffusionDriveModel:
    """The planner on the CPU in eval mode, weights drawn from `seed`.

    The BatchNorm statistics are drawn too (mean ~ N(0, 0.3), var ~
    U(0.7, 1.5)), so that folding them into the kernels' affine is exercised.
    """
    gen = torch.Generator().manual_seed(seed)
    model = DiffusionDriveModel(config or TransfuserConfig(), dtype=dtype)
    flax_default_init_(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.7, 1.5, generator=gen)
    return model.eval()


def example_inputs(config: TransfuserConfig, batch: int, device: torch.device,
                   seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded uint8 camera, float lidar BEV and status on `device`."""
    gen = torch.Generator().manual_seed(seed)
    camera = torch.randint(0, 256, (batch, config.camera_height, config.camera_width, 3),
                           generator=gen, dtype=torch.uint8)
    lidar = torch.rand((batch, config.lidar_resolution_height, config.lidar_resolution_width,
                        config.lidar_in_channels), generator=gen)
    status = torch.randn((batch, 8), generator=gen)
    return {"camera_feature": camera.to(device), "lidar_feature": lidar.to(device),
            "status_feature": status.to(device)}


def entry(device: Optional[Union[str, torch.device]] = None, dtype: torch.dtype = torch.bfloat16,
          batch: int = 1, seed: int = 0) -> Tuple[DiffusionDriveModel, Dict[str, torch.Tensor]]:
    """(model, example inputs) for the planner forward, on CUDA by default.

    Raises without a GPU unless `device="cpu"` is passed. Call as
    ``with torch.no_grad(): model(**inputs)``.
    """
    device = resolve_device(device)
    config = TransfuserConfig()
    model = build_model(config, dtype=dtype, seed=seed).to(device)
    return model, example_inputs(config, batch, device, seed=seed + 1)


def example_point_cloud(rng: np.random.Generator, num_points: int,
                        config: Optional[TransfuserConfig] = None) -> np.ndarray:
    """A seeded (6, num_points) float32 cloud shaped like a lidar sweep.

    Ranges are exponential around the ego (scale 10 m), so most points lie
    within +-32 m and the bins next to the ego are hot; points are ordered
    by ring and azimuth, as a scan is, so neighbours share bins. Heights mix
    obstacles above the split plane, ground below it and a few returns above
    `max_height_lidar`. Some points sit exactly on the grid's outer edges
    (+-32.0) and on inner bin edges. Rows: x, y, z, intensity, ring, id.
    """
    cfg = config or TransfuserConfig()
    r = rng.exponential(10.0, num_points)
    phi = rng.uniform(-np.pi, np.pi, num_points)
    order = np.lexsort((phi, np.floor(r * 2.0)))
    r, phi = r[order], phi[order]
    x, y = r * np.cos(phi), r * np.sin(phi)
    kind = rng.uniform(size=num_points)
    z = np.where(kind < 0.65, rng.uniform(0.0, 3.0, num_points),             # straddles the split
                 np.where(kind < 0.95, rng.normal(-0.1, 0.1, num_points),     # ground
                          rng.uniform(cfg.max_height_lidar - 1.0, cfg.max_height_lidar + 50.0,
                                      num_points)))
    edge = rng.choice(num_points, size=max(num_points // 100, 8), replace=False)
    edges = np.array([cfg.lidar_min_x, cfg.lidar_max_x, cfg.lidar_min_y, cfg.lidar_max_y,
                      0.0, 0.25, -0.25, 12.5], np.float64)
    x[edge[0::2]] = rng.choice(edges, size=len(edge[0::2]))
    y[edge[1::2]] = rng.choice(edges, size=len(edge[1::2]))
    z[edge] = 1.0
    pc = np.zeros((6, num_points), np.float32)
    pc[0], pc[1], pc[2] = x, y, z
    pc[3] = rng.uniform(0.0, 255.0, num_points)
    pc[4] = np.floor(r * 2.0) % 128
    return pc


def example_agent_input(config: Optional[TransfuserConfig] = None, seed: int = 0,
                        num_points: int = 131072,
                        camera_shape: Sequence[int] = (1080, 1920)) -> AgentInput:
    """A seeded one-frame `AgentInput`: uint8 l0/f0/r0 cameras of
    (*camera_shape, 3) (the other five empty), an `example_point_cloud` of
    `num_points` and an ego status with a one-hot driving command."""
    rng = np.random.default_rng(seed)
    images = {name: Camera(image=rng.integers(0, 256, (*camera_shape, 3), dtype=np.uint8))
              for name in ("cam_l0", "cam_f0", "cam_r0")}
    cameras = Cameras(**{name: images.get(name, Camera()) for name in CAMERA_NAMES})
    command = np.zeros(4, np.float32)
    command[rng.integers(0, 4)] = 1.0
    status = EgoStatus(ego_pose=np.zeros(3, np.float32),
                       ego_velocity=rng.normal(0.0, 5.0, 2).astype(np.float32),
                       ego_acceleration=rng.normal(0.0, 1.0, 2).astype(np.float32),
                       driving_command=command)
    return AgentInput(ego_statuses=[status], cameras=[cameras],
                      lidars=[Lidar(example_point_cloud(rng, num_points, config))])


def agent_entry(device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16, seed: int = 0, num_points: int = 131072):
    """(agent, agent_input) for the raw-sensor agent path, on CUDA by default.

    The agent is the full-width `DiffusionDriveAgent(preprocess_on_device=True)`
    with seeded weights, initialized; call ``agent.compute_trajectory(agent_input)``
    or ``agent.forward(features)``. Raises without a GPU unless `device="cpu"`.
    """
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent

    config = TransfuserConfig()
    agent = DiffusionDriveAgent(config, dtype=dtype, seed=seed, preprocess_on_device=True,
                                device=device)
    agent.initialize()
    return agent, example_agent_input(config, seed=seed + 1, num_points=num_points)
