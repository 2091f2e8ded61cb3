"""Privileged GT-replay agent: copy of `diffusiondrive_tpu/agents/human_agent.py`
(parity: `navsim/agents/human_agent.py`)."""

from __future__ import annotations

from diffusiondrive_torch.agents.abstract_agent import AbstractAgent
from diffusiondrive_torch.common.dataclasses import AgentInput, SensorConfig, Trajectory, TrajectorySampling


class HumanAgent(AbstractAgent):
    """Returns the ground-truth future trajectory (PDMS upper bound ~94.8)."""

    requires_scene = True

    def __init__(self, trajectory_sampling: TrajectorySampling = None):
        self._trajectory_sampling = trajectory_sampling or TrajectorySampling(
            time_horizon=4, interval_length=0.5
        )

    def name(self) -> str:
        return self.__class__.__name__

    def initialize(self) -> None:
        pass

    def get_sensor_config(self) -> SensorConfig:
        return SensorConfig.build_no_sensors()

    def compute_trajectory(self, agent_input: AgentInput, scene=None) -> Trajectory:
        if scene is None:
            raise ValueError("HumanAgent requires the privileged Scene.")
        return scene.get_future_trajectory(self._trajectory_sampling.num_poses)
