"""Trajectory sampling spec (copy of `diffusiondrive_tpu/common/dataclasses.py:TrajectorySampling`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TrajectorySampling:
    """Sampling spec of a discrete trajectory; any two of the three fields
    determine the third (mirrors nuplan's TrajectorySampling contract)."""

    num_poses: Optional[int] = None
    time_horizon: Optional[float] = None
    interval_length: Optional[float] = None

    def __post_init__(self):
        num_given = sum(v is not None for v in (self.num_poses, self.time_horizon, self.interval_length))
        if num_given < 2:
            raise ValueError("TrajectorySampling needs at least two of num_poses/time_horizon/interval_length")
        if self.num_poses is None:
            object.__setattr__(self, "num_poses", int(round(self.time_horizon / self.interval_length)))
        elif self.time_horizon is None:
            object.__setattr__(self, "time_horizon", self.num_poses * self.interval_length)
        elif self.interval_length is None:
            object.__setattr__(self, "interval_length", self.time_horizon / self.num_poses)

    @property
    def step_time(self) -> float:
        return self.interval_length
