"""Planner entry point: the port's counterpart of `__graft_entry__.entry()`.

`entry()` builds the full-width DiffusionDrive planner (default
`TransfuserConfig`: ResNet-34 branches, 256x1024 camera, 256x256 lidar BEV)
in eval mode with seeded random weights, plus example inputs, on CUDA unless
`device="cpu"` is passed.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

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
