"""Feature/target builder contracts (copy of
`diffusiondrive_tpu/training/abstract_feature_target_builder.py`).

Builders produce plain numpy dicts (NHWC); batching and the copy to the
device happen in the agent or the dataset.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict

import numpy as np

from diffusiondrive_torch.common.dataclasses import AgentInput


class AbstractFeatureBuilder(ABC):
    """Builds model input features from (unprivileged) AgentInput."""

    @abstractmethod
    def get_unique_name(self) -> str:
        ...

    @abstractmethod
    def compute_features(self, agent_input: AgentInput) -> Dict[str, np.ndarray]:
        ...


class AbstractTargetBuilder(ABC):
    """Builds training targets from a (privileged) scene; the port's `Scene`
    comes with the dataset slice."""

    @abstractmethod
    def get_unique_name(self) -> str:
        ...

    @abstractmethod
    def compute_targets(self, scene: Any) -> Dict[str, np.ndarray]:
        ...
