"""Agent interface (counterpart of `diffusiondrive_tpu/agents/abstract_agent.py`).

An agent owns a model; `forward` consumes a batched numpy feature dict and
returns a prediction dict of numpy arrays; the `compute_trajectory` template
method (build features -> add batch dim -> no-grad forward -> Trajectory)
is kept so PDMS harnesses run unchanged. `set_mesh` takes a list of
devices, the port's counterpart of the JAX package's mesh.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from diffusiondrive_torch.common.dataclasses import AgentInput, SensorConfig, Trajectory
from diffusiondrive_torch.training.abstract_feature_target_builder import (
    AbstractFeatureBuilder,
    AbstractTargetBuilder,
)


class AbstractAgent(ABC):
    """Interface for an agent in the framework."""

    requires_scene: bool = False

    @abstractmethod
    def name(self) -> str:
        ...

    @abstractmethod
    def get_sensor_config(self) -> SensorConfig:
        ...

    @abstractmethod
    def initialize(self) -> None:
        """Load checkpoints / weights; called inside each eval worker."""
        ...

    def forward(self, features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Batched forward pass: feature dict -> prediction dict."""
        raise NotImplementedError

    def get_feature_builders(self) -> List[AbstractFeatureBuilder]:
        raise NotImplementedError("No feature builders. Agent does not support training.")

    def get_target_builders(self) -> List[AbstractTargetBuilder]:
        raise NotImplementedError("No target builders. Agent does not support training.")

    def compute_trajectory(self, agent_input: AgentInput) -> Trajectory:
        """Template method: features -> batch dim -> forward -> Trajectory."""
        features: Dict[str, np.ndarray] = {}
        for builder in self.get_feature_builders():
            features.update(builder.compute_features(agent_input))
        features = {k: np.asarray(v)[None] for k, v in features.items()}
        predictions = self.forward(features)
        poses = np.asarray(predictions["trajectory"])[0]
        return Trajectory(poses.astype(np.float32))

    def compute_loss(self, features: Dict[str, Any], targets: Dict[str, Any],
                     predictions: Dict[str, Any]):
        raise NotImplementedError("No loss. Agent does not support training.")

    def get_optimizers(self):
        raise NotImplementedError("No optimizers. Agent does not support training.")

    def get_training_callbacks(self, output_dir: Any = None) -> List[Any]:
        return []

    def set_mesh(self, mesh: Optional[Sequence[Any]]) -> None:
        """Split this agent's batched forward over a list of devices.

        Default no-op: host-side agents (constant-velocity, human replay)
        have no device program. Device agents run a replica of their model
        on each device of the list on its rows of the batch."""
