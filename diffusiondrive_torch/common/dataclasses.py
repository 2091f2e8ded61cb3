"""In-memory scene and sensor data model.

Copies of `diffusiondrive_tpu/common/dataclasses.py`: `TrajectorySampling`,
the sensor containers (`Camera`, `Cameras`, `Lidar`), `EgoStatus`,
`AgentInput`, `Trajectory` and `SensorConfig`. Arrays are plain numpy on the
host. The disk loaders (`Cameras.from_camera_dict`, `Lidar.from_paths`,
`load_pcd`, `AgentInput.from_scene_dict_list`) come with the dataset slice;
here an `AgentInput` is built in memory.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import List, Optional, Union

import numpy as np


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


@dataclass
class Camera:
    """A single camera frame: image + calibration."""

    image: Optional[np.ndarray] = None
    sensor2lidar_rotation: Optional[np.ndarray] = None
    sensor2lidar_translation: Optional[np.ndarray] = None
    intrinsics: Optional[np.ndarray] = None
    distortion: Optional[np.ndarray] = None


CAMERA_NAMES = ("cam_f0", "cam_l0", "cam_l1", "cam_l2", "cam_r0", "cam_r1", "cam_r2", "cam_b0")


@dataclass
class Cameras:
    """The 8-camera rig."""

    cam_f0: Camera
    cam_l0: Camera
    cam_l1: Camera
    cam_l2: Camera
    cam_r0: Camera
    cam_r1: Camera
    cam_r2: Camera
    cam_b0: Camera


@dataclass
class Lidar:
    """Merged lidar point cloud: (6, N) float32 — see `LidarIndex`."""

    lidar_pc: Optional[np.ndarray] = None


@dataclass
class EgoStatus:
    """Ego vehicle status (rear-axle pose, velocity, acceleration, command)."""

    ego_pose: np.ndarray
    ego_velocity: np.ndarray
    ego_acceleration: np.ndarray
    driving_command: np.ndarray
    in_global_frame: bool = False


@dataclass
class AgentInput:
    """Unprivileged agent input: history of ego statuses + sensors."""

    ego_statuses: List[EgoStatus]
    cameras: List[Cameras]
    lidars: List[Lidar]


@dataclass
class Trajectory:
    """A local-frame (x, y, heading) trajectory."""

    poses: np.ndarray
    trajectory_sampling: TrajectorySampling = field(
        default_factory=lambda: TrajectorySampling(time_horizon=4, interval_length=0.5)
    )

    def __post_init__(self):
        self.poses = np.asarray(self.poses)
        if self.poses.ndim != 2 or self.poses.shape[1] != 3:
            raise ValueError(f"Trajectory poses must be (num_poses, 3), got {self.poses.shape}")
        if self.poses.shape[0] != self.trajectory_sampling.num_poses:
            raise ValueError(f"Trajectory has {self.poses.shape[0]} poses but sampling expects "
                             f"{self.trajectory_sampling.num_poses}")


@dataclass
class SensorConfig:
    """Which sensors to load at which history iterations (bool or index list)."""

    cam_f0: Union[bool, List[int]]
    cam_l0: Union[bool, List[int]]
    cam_l1: Union[bool, List[int]]
    cam_l2: Union[bool, List[int]]
    cam_r0: Union[bool, List[int]]
    cam_r1: Union[bool, List[int]]
    cam_r2: Union[bool, List[int]]
    cam_b0: Union[bool, List[int]]
    lidar_pc: Union[bool, List[int]]

    def get_sensors_at_iteration(self, iteration: int) -> List[str]:
        names: List[str] = []
        for sensor_name, include in asdict(self).items():
            if isinstance(include, bool) and include:
                names.append(sensor_name)
            elif isinstance(include, list) and iteration in include:
                names.append(sensor_name)
        return names

    @classmethod
    def build_all_sensors(cls, include: Union[bool, List[int]] = True) -> "SensorConfig":
        return SensorConfig(**{name: include for name in CAMERA_NAMES}, lidar_pc=include)

    @classmethod
    def build_no_sensors(cls) -> "SensorConfig":
        return cls.build_all_sensors(include=False)
