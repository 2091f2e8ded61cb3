"""Constant-velocity baseline: copy of `diffusiondrive_tpu/agents/constant_velocity_agent.py`
(parity: `navsim/agents/constant_velocity_agent.py`)."""

from __future__ import annotations


import numpy as np

from diffusiondrive_torch.agents.abstract_agent import AbstractAgent
from diffusiondrive_torch.common.dataclasses import AgentInput, SensorConfig, Trajectory, TrajectorySampling


class ConstantVelocityAgent(AbstractAgent):
    """Drives straight at the current speed."""

    requires_scene = False

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

    def compute_trajectory(self, agent_input: AgentInput) -> Trajectory:
        speed = float(np.linalg.norm(agent_input.ego_statuses[-1].ego_velocity))
        n, dt = self._trajectory_sampling.num_poses, self._trajectory_sampling.interval_length
        poses = np.zeros((n, 3), dtype=np.float32)
        poses[:, 0] = (np.arange(1, n + 1) * dt * speed).astype(np.float32)
        return Trajectory(poses, self._trajectory_sampling)
