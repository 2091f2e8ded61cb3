"""Emergency-brake trajectory generation.

Parity: `pdm_planner/utils/pdm_emergency_brake.py` — when the best proposal's
time-to-at-fault-collision or time-to-ttc-infraction falls below
`time_to_infraction_threshold`, replace the trajectory with a maximum-
deceleration straight-line stop.

Copy of `diffusiondrive_tpu/planning/pdm_closed/emergency_brake.py` (numpy on the host, as there).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from diffusiondrive_torch.common.dataclasses import TrajectorySampling
from diffusiondrive_torch.common.enums import StateIndex


@dataclass
class PDMEmergencyBrake:
    trajectory_sampling: TrajectorySampling = field(
        default_factory=lambda: TrajectorySampling(num_poses=50, interval_length=0.1)
    )
    time_to_infraction_threshold: float = 2.0
    max_long_accel: float = 2.40
    max_lat_accel: float = 4.89
    emergency_decel: float = -4.05  # comfort bound; hard decel if infraction imminent

    def should_brake(self, time_to_at_fault_collision: float, time_to_ttc_infraction: float) -> bool:
        time_to_infraction = min(time_to_at_fault_collision, time_to_ttc_infraction)
        return time_to_infraction <= self.time_to_infraction_threshold

    def brake_trajectory(self, ego_state: np.ndarray) -> np.ndarray:
        """(T+1, 3) straight max-decel stop from the current state."""
        n = self.trajectory_sampling.num_poses
        dt = self.trajectory_sampling.interval_length
        t = np.arange(n + 1) * dt
        v0 = float(ego_state[StateIndex.VELOCITY_X])
        decel = abs(self.emergency_decel)
        t_stop = v0 / decel if decel > 0 else 0.0
        tt = np.minimum(t, t_stop)
        dist = v0 * tt - 0.5 * decel * tt**2
        heading = float(ego_state[StateIndex.HEADING])
        poses = np.zeros((n + 1, 3))
        poses[:, 0] = ego_state[StateIndex.X] + dist * np.cos(heading)
        poses[:, 1] = ego_state[StateIndex.Y] + dist * np.sin(heading)
        poses[:, 2] = heading
        return poses
