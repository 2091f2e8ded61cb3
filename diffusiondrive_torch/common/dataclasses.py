"""Scene and sensor data model.

Copies of `diffusiondrive_tpu/common/dataclasses.py`: `TrajectorySampling`,
the sensor containers (`Camera`, `Cameras`, `Lidar`) with their disk
loaders (`_load_image` by cv2, imported when a camera is read; `load_pcd`
for ascii, binary and binary_compressed PCD; `_lzf_decompress`),
`EgoStatus`, `AgentInput`, `Annotations`, `Trajectory`, the scene types
(`SceneMetadata`, `Frame`, `Scene`, `SceneFilter`), `SensorConfig` and
`PDMResults`. Arrays are plain numpy on the host. Scenes build from the
pickled OpenScene logs' frame dicts; a requested sensor is read from its
blob under the sensor root, others stay empty. LZF runs in the port's
native library (`native/`), or in Python where that cannot be built, as
in JAX. With `build_map_api=True`
(the default), a scene carries the port's `LocalMapAPI` of its location,
loaded from `$NUPLAN_MAPS_ROOT/<map_name>.ddmap.pkl` (maps converted by
either package load), or `None` when the root is unset or holds no such
file, as in JAX. A map file that exists but does not load raises here,
where JAX returns `None`: a scene without its map would plan by the
constant-velocity fallback and cache a wrong reference without an error.
"""

from __future__ import annotations

import io
import os
import struct
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from diffusiondrive_torch.common.geometry import (
    StateSE2,
    convert_absolute_to_relative_se2_array,
    quaternion_to_yaw,
)
from diffusiondrive_torch.planning.map_api import get_maps_api

NAVSIM_INTERVAL_LENGTH: float = 0.5

NUPLAN_MAPS_ROOT = os.environ.get("NUPLAN_MAPS_ROOT")

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

    @classmethod
    def from_camera_dict(
        cls, sensor_blobs_path: Path, camera_dict: Dict[str, Any], sensor_names: List[str]
    ) -> "Cameras":
        """Load the requested cameras from a per-frame log dict; others stay empty."""
        data: Dict[str, Camera] = {}
        for camera_name, spec in camera_dict.items():
            identifier = camera_name.lower()
            if identifier in sensor_names:
                data[identifier] = Camera(
                    image=_load_image(Path(sensor_blobs_path) / spec["data_path"]),
                    sensor2lidar_rotation=spec.get("sensor2lidar_rotation"),
                    sensor2lidar_translation=spec.get("sensor2lidar_translation"),
                    intrinsics=spec.get("cam_intrinsic"),
                    distortion=spec.get("distortion"),
                )
            else:
                data[identifier] = Camera()
        return Cameras(**{name: data.get(name, Camera()) for name in CAMERA_NAMES})


def _load_image(path: Path) -> np.ndarray:
    """Decode an image file to an (H, W, 3) uint8 RGB array (cv2)."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"Could not read image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


@dataclass
class Lidar:
    """Merged lidar point cloud: (6, N) float32 — see `LidarIndex`."""

    lidar_pc: Optional[np.ndarray] = None

    @classmethod
    def from_paths(cls, sensor_blobs_path: Path, lidar_path: Path, sensor_names: List[str]) -> "Lidar":
        if "lidar_pc" in sensor_names:
            return Lidar(load_pcd(Path(sensor_blobs_path) / lidar_path))
        return Lidar()


_PCD_TYPES = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4",
              ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4"}


def load_pcd(path: Path) -> np.ndarray:
    """Minimal PCD reader (ascii / binary / binary_compressed) -> (fields, N) float32."""
    with open(path, "rb") as fp:
        raw = fp.read()
    header_end = raw.find(b"DATA")
    newline = raw.find(b"\n", header_end)
    header_lines = raw[:newline].decode("ascii", errors="replace").splitlines()
    meta: Dict[str, List[str]] = {}
    for line in header_lines:
        if line.startswith("#") or not line.strip():
            continue
        key, *vals = line.split()
        meta[key.upper()] = vals
    fields = meta["FIELDS"]
    sizes = [int(s) for s in meta["SIZE"]]
    types = meta["TYPE"]
    counts = [int(c) for c in meta.get("COUNT", ["1"] * len(fields))]
    num_points = int(meta["POINTS"][0])
    data_mode = meta["DATA"][0].lower()
    body = raw[newline + 1:]
    dtype = np.dtype([(name, _PCD_TYPES[(t, s)], (c,)) if c > 1 else (name, _PCD_TYPES[(t, s)])
                      for name, t, s, c in zip(fields, types, sizes, counts)])

    if data_mode == "ascii":
        arr = np.loadtxt(io.BytesIO(body), dtype=np.float32, max_rows=num_points)
        return arr.T.astype(np.float32)
    if data_mode == "binary":
        structured = np.frombuffer(body, dtype=dtype, count=num_points)
    elif data_mode == "binary_compressed":
        comp_size, uncomp_size = struct.unpack("<II", body[:8])
        decompressed = _lzf_decompress(body[8:8 + comp_size], uncomp_size)
        # binary_compressed stores the data column-major (all xs, then all ys, ...)
        structured = np.empty(num_points, dtype=dtype)
        offset = 0
        for name, t, s, c in zip(fields, types, sizes, counts):
            nbytes = s * c * num_points
            col = np.frombuffer(decompressed[offset:offset + nbytes], dtype=_PCD_TYPES[(t, s)])
            structured[name] = col.reshape(num_points, c) if c > 1 else col
            offset += nbytes
    else:
        raise ValueError(f"Unsupported PCD DATA mode: {data_mode}")

    cols = [np.asarray(structured[name], dtype=np.float32).reshape(num_points, -1) for name in fields]
    return np.concatenate(cols, axis=1).T.copy()


def _lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """LZF decompression (PCD binary_compressed payloads): the native
    library when it builds, the pure-Python decoder otherwise."""
    from diffusiondrive_torch.native import lzf_decompress

    native = lzf_decompress(data, expected_size)
    return native if native is not None else _lzf_decompress_python(data, expected_size)


def _lzf_decompress_python(data: bytes, expected_size: int) -> bytes:
    """The pure-Python LZF decoder."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected_size:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run
            run = ctrl + 1
            out += data[i:i + run]
            i += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    return bytes(out)


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

    @classmethod
    def from_scene_dict_list(
        cls,
        scene_dict_list: List[Dict],
        sensor_blobs_path: Path,
        num_history_frames: int,
        sensor_config: "SensorConfig",
    ) -> "AgentInput":
        if not scene_dict_list:
            raise ValueError("Scene list is empty!")
        global_poses = _global_ego_poses(scene_dict_list[:num_history_frames])
        local_poses = convert_absolute_to_relative_se2_array(
            StateSE2.from_array(global_poses[-1]), global_poses
        )

        ego_statuses, cameras, lidars = [], [], []
        for frame_idx in range(num_history_frames):
            dyn = scene_dict_list[frame_idx]["ego_dynamic_state"]
            ego_statuses.append(
                EgoStatus(
                    ego_pose=np.asarray(local_poses[frame_idx], dtype=np.float32),
                    ego_velocity=np.asarray(dyn[:2], dtype=np.float32),
                    ego_acceleration=np.asarray(dyn[2:], dtype=np.float32),
                    driving_command=np.asarray(scene_dict_list[frame_idx]["driving_command"]),
                )
            )
            sensor_names = sensor_config.get_sensors_at_iteration(frame_idx)
            cameras.append(
                Cameras.from_camera_dict(sensor_blobs_path, scene_dict_list[frame_idx]["cams"], sensor_names)
            )
            lidars.append(
                Lidar.from_paths(sensor_blobs_path, Path(scene_dict_list[frame_idx]["lidar_path"]), sensor_names)
            )
        return AgentInput(ego_statuses, cameras, lidars)


def _global_ego_poses(scene_dict_list: List[Dict]) -> np.ndarray:
    poses = []
    for frame in scene_dict_list:
        t = frame["ego2global_translation"]
        yaw = quaternion_to_yaw(frame["ego2global_rotation"])
        poses.append([t[0], t[1], yaw])
    return np.asarray(poses, dtype=np.float64)


@dataclass
class Annotations:
    """Per-frame object annotations (boxes in BoundingBoxIndex layout)."""

    boxes: np.ndarray
    names: List[str]
    velocity_3d: np.ndarray
    instance_tokens: List[str]
    track_tokens: List[str]

    def __post_init__(self):
        lengths = {k: len(v) for k, v in vars(self).items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"Annotations attribute lengths differ: {lengths}")


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
class SceneMetadata:
    log_name: str
    scene_token: str
    map_name: str
    initial_token: str
    num_history_frames: int
    num_future_frames: int


@dataclass
class Frame:
    """A privileged scene frame."""

    token: str
    timestamp: int
    roadblock_ids: List[str]
    traffic_lights: List[Tuple[str, bool]]
    annotations: Annotations
    ego_status: EgoStatus
    lidar: Lidar
    cameras: Cameras


@dataclass
class Scene:
    """A NAVSIM scene: history + future frames with privileged info."""

    scene_metadata: SceneMetadata
    map_api: Optional[Any]
    frames: List[Frame]

    def get_future_trajectory(self, num_trajectory_frames: Optional[int] = None) -> Trajectory:
        if num_trajectory_frames is None:
            num_trajectory_frames = self.scene_metadata.num_future_frames
        start = self.scene_metadata.num_history_frames - 1
        global_poses = np.array(
            [self.frames[i].ego_status.ego_pose for i in range(start, start + num_trajectory_frames + 1)],
            dtype=np.float64,
        )
        local = convert_absolute_to_relative_se2_array(StateSE2.from_array(global_poses[0]), global_poses[1:])
        return Trajectory(
            local, TrajectorySampling(num_poses=len(local), interval_length=NAVSIM_INTERVAL_LENGTH)
        )

    def get_history_trajectory(self, num_trajectory_frames: Optional[int] = None) -> Trajectory:
        if num_trajectory_frames is None:
            num_trajectory_frames = self.scene_metadata.num_history_frames
        global_poses = np.array(
            [self.frames[i].ego_status.ego_pose for i in range(num_trajectory_frames)], dtype=np.float64
        )
        local = convert_absolute_to_relative_se2_array(StateSE2.from_array(global_poses[-1]), global_poses)
        return Trajectory(
            local, TrajectorySampling(num_poses=len(local), interval_length=NAVSIM_INTERVAL_LENGTH)
        )

    def get_agent_input(self) -> AgentInput:
        local_poses = self.get_history_trajectory().poses
        ego_statuses, cameras, lidars = [], [], []
        for frame_idx in range(self.scene_metadata.num_history_frames):
            status = self.frames[frame_idx].ego_status
            ego_statuses.append(
                EgoStatus(
                    ego_pose=local_poses[frame_idx],
                    ego_velocity=status.ego_velocity,
                    ego_acceleration=status.ego_acceleration,
                    driving_command=status.driving_command,
                )
            )
            cameras.append(self.frames[frame_idx].cameras)
            lidars.append(self.frames[frame_idx].lidar)
        return AgentInput(ego_statuses, cameras, lidars)

    @classmethod
    def _build_annotations(cls, scene_frame: Dict) -> Annotations:
        return Annotations(
            boxes=scene_frame["anns"]["gt_boxes"],
            names=scene_frame["anns"]["gt_names"],
            velocity_3d=scene_frame["anns"]["gt_velocity_3d"],
            instance_tokens=scene_frame["anns"]["instance_tokens"],
            track_tokens=scene_frame["anns"]["track_tokens"],
        )

    @classmethod
    def _build_ego_status(cls, scene_frame: Dict) -> EgoStatus:
        t = scene_frame["ego2global_translation"]
        yaw = quaternion_to_yaw(scene_frame["ego2global_rotation"])
        dyn = scene_frame["ego_dynamic_state"]
        return EgoStatus(
            ego_pose=np.array([t[0], t[1], yaw], dtype=np.float64),
            ego_velocity=np.asarray(dyn[:2], dtype=np.float32),
            ego_acceleration=np.asarray(dyn[2:], dtype=np.float32),
            driving_command=np.asarray(scene_frame["driving_command"]),
            in_global_frame=True,
        )

    @classmethod
    def from_scene_dict_list(
        cls,
        scene_dict_list: List[Dict],
        sensor_blobs_path: Path,
        num_history_frames: int,
        num_future_frames: int,
        sensor_config: "SensorConfig",
        build_map_api: bool = True,
    ) -> "Scene":
        if not scene_dict_list:
            raise ValueError("Scene list is empty!")
        current = scene_dict_list[num_history_frames - 1]
        scene_metadata = SceneMetadata(
            log_name=current["log_name"],
            scene_token=current["scene_token"],
            map_name=current["map_location"],
            initial_token=current["token"],
            num_history_frames=num_history_frames,
            num_future_frames=num_future_frames,
        )
        map_api = cls._build_map_api(scene_metadata.map_name) if build_map_api else None

        frames: List[Frame] = []
        for frame_idx, frame_dict in enumerate(scene_dict_list):
            sensor_names = sensor_config.get_sensors_at_iteration(frame_idx)
            frames.append(
                Frame(
                    token=frame_dict["token"],
                    timestamp=frame_dict["timestamp"],
                    roadblock_ids=frame_dict["roadblock_ids"],
                    traffic_lights=frame_dict["traffic_lights"],
                    annotations=cls._build_annotations(frame_dict),
                    ego_status=cls._build_ego_status(frame_dict),
                    lidar=Lidar.from_paths(sensor_blobs_path, Path(frame_dict["lidar_path"]), sensor_names),
                    cameras=Cameras.from_camera_dict(sensor_blobs_path, frame_dict["cams"], sensor_names),
                )
            )
        return Scene(scene_metadata=scene_metadata, map_api=map_api, frames=frames)

    @classmethod
    def _build_map_api(cls, map_name: str):
        """The location's `LocalMapAPI`, or None without a maps root or its file."""
        return get_maps_api(NUPLAN_MAPS_ROOT, map_name)


@dataclass
class SceneFilter:
    """Scene extraction/filter config (parity: `dataclasses.py:SceneFilter`)."""

    num_history_frames: int = 4
    num_future_frames: int = 10
    frame_interval: Optional[int] = None
    has_route: bool = True
    max_scenes: Optional[int] = None
    log_names: Optional[List[str]] = None
    tokens: Optional[List[str]] = None

    def __post_init__(self):
        if self.frame_interval is None:
            self.frame_interval = self.num_frames
        if self.num_history_frames < 1 or self.num_future_frames < 0 or self.frame_interval < 1:
            raise ValueError(f"invalid SceneFilter {self}")

    @property
    def num_frames(self) -> int:
        return self.num_history_frames + self.num_future_frames


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


@dataclass
class PDMResults:
    """Sub-scores of a PDM evaluation."""

    no_at_fault_collisions: float
    drivable_area_compliance: float
    ego_progress: float
    time_to_collision_within_bound: float
    comfort: float
    driving_direction_compliance: float
    score: float
