"""EgoStatusMLP agent (counterpart of `diffusiondrive_tpu/agents/ego_status_mlp_agent.py`).

A 4-layer MLP on (velocity, acceleration, driving command): the
sensor-free baseline (navsim's `ego_status_mlp_agent.py`). The feature and
target builders are copies; the MLP is an `nn.Module` whose layers carry
the Flax scope names `fc0`, `fc1`, `fc2` and `out`, so
`utils/port_jax.py:load_jax_variables` carries JAX's params across. Its
checkpoint is a torch file of the module's `state_dict` (`torch.save`).
Runs on CUDA unless `device="cpu"` is passed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from diffusiondrive_torch.agents.abstract_agent import AbstractAgent
from diffusiondrive_torch.common.dataclasses import AgentInput, Scene, SensorConfig, TrajectorySampling
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.training.abstract_feature_target_builder import (
    AbstractFeatureBuilder,
    AbstractTargetBuilder,
)


class EgoStatusFeatureBuilder(AbstractFeatureBuilder):
    """(velocity[2], acceleration[2], driving_command[4]) -> (8,) feature."""

    def get_unique_name(self) -> str:
        return "ego_status_feature"

    def compute_features(self, agent_input: AgentInput) -> Dict[str, np.ndarray]:
        status = agent_input.ego_statuses[-1]
        feature = np.concatenate(
            [
                np.asarray(status.ego_velocity, np.float32),
                np.asarray(status.ego_acceleration, np.float32),
                np.asarray(status.driving_command, np.float32),
            ]
        )
        return {"ego_status": feature}


class TrajectoryTargetBuilder(AbstractTargetBuilder):
    """GT future trajectory target."""

    def __init__(self, trajectory_sampling: TrajectorySampling):
        self._trajectory_sampling = trajectory_sampling

    def get_unique_name(self) -> str:
        return "trajectory_target"

    def compute_targets(self, scene: Scene) -> Dict[str, np.ndarray]:
        future = scene.get_future_trajectory(self._trajectory_sampling.num_poses)
        return {"trajectory": np.asarray(future.poses, np.float32)}


class _EgoStatusMLP(nn.Module):
    """Three ReLU layers of `hidden_dim`, then (num_poses, 3) poses."""

    def __init__(self, hidden_dim: int, num_poses: int, in_dim: int = 8):
        super().__init__()
        self.num_poses = num_poses
        self.fc0 = nn.Linear(in_dim, hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.out = nn.Linear(hidden_dim, num_poses * 3)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax `Dense`'s initialisation: LeCun normal kernels (truncated at
        two standard deviations), zero biases."""
        with torch.no_grad():
            for layer in (self.fc0, self.fc1, self.fc2, self.out):
                std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in (self.fc0, self.fc1, self.fc2):
            x = torch.relu(layer(x))
        x = self.out(x)
        return x.reshape(x.shape[0], self.num_poses, 3)


class EgoStatusMLPAgent(AbstractAgent):
    """Sensor-free MLP planner."""

    requires_scene = False

    def __init__(self, trajectory_sampling: TrajectorySampling = None, hidden_layer_dim: int = 512,
                 lr: float = 1e-4, checkpoint_path: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self._trajectory_sampling = trajectory_sampling or TrajectorySampling(time_horizon=4, interval_length=0.5)
        self._hidden_layer_dim = hidden_layer_dim
        self._lr = lr
        self._checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        self.model: Optional[_EgoStatusMLP] = None

    def name(self) -> str:
        return self.__class__.__name__

    def initialize(self) -> None:
        """Build the MLP once (idempotent): from the checkpoint when one is
        given, else seeded (seed 0, as JAX's `PRNGKey(0)` init)."""
        if self.model is not None:
            return
        model = _EgoStatusMLP(self._hidden_layer_dim, self._trajectory_sampling.num_poses)
        if self._checkpoint_path:
            model.load_state_dict(torch.load(self._checkpoint_path, map_location="cpu", weights_only=True))
        else:
            model.reset_parameters(torch.Generator().manual_seed(0))
        self.model = model.to(self.device)

    def get_sensor_config(self) -> SensorConfig:
        return SensorConfig.build_no_sensors()

    def get_feature_builders(self) -> List[AbstractFeatureBuilder]:
        return [EgoStatusFeatureBuilder()]

    def get_target_builders(self) -> List[AbstractTargetBuilder]:
        return [TrajectoryTargetBuilder(self._trajectory_sampling)]

    def forward(self, features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        self.initialize()
        x = torch.as_tensor(np.asarray(features["ego_status"], np.float32)).to(self.device)
        with torch.no_grad():
            poses = self.model(x)
        return {"trajectory": poses.cpu().numpy()}

    def compute_loss(self, features, targets, predictions):
        return torch.mean(torch.abs(predictions["trajectory"] - targets["trajectory"]))

    def get_optimizers(self):
        """Adam at the agent's lr with optax's defaults (betas 0.9, 0.999;
        eps 1e-8 added after the square root)."""
        self.initialize()
        return torch.optim.Adam(self.model.parameters(), lr=self._lr, betas=(0.9, 0.999), eps=1e-8)

    def save_checkpoint(self, path) -> None:
        """The MLP's `state_dict` as a torch file (`checkpoint_path` reads it)."""
        torch.save({k: v.cpu() for k, v in self.model.state_dict().items()}, path)
