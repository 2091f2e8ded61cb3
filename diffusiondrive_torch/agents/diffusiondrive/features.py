"""DiffusionDrive/Transfuser feature builders (counterpart of
`diffusiondrive_tpu/agents/diffusiondrive/features.py`).

- `TransfuserFeatureBuilder`, on the host (numpy/cv2): camera crop l0/f0/r0
  (rows 28:-28; side cams cols 416:-416), hstack, resize to 1024x256, kept
  uint8 (the model normalizes on the device); lidar z-filter, split at
  0.2 m, 2D histogram onto the 256x256 BEV grid (clip 5 points/cell,
  normalize); status = driving_command[4], velocity[2], acceleration[2].
- `RawSensorFeatureBuilder`: the raw l0/f0/r0 images and the padded point
  cloud, for the agent's device preprocessing (`ops/preprocessing.py`).
- `TransfuserTargetBuilder`: the GT trajectory, the 30 nearest vehicle boxes
  (and their labels) and the 7-class BEV semantic map (map layers rasterised
  when the scene has a map API, else zeros, then the box classes). It reads
  a scene only through its attributes (`get_future_trajectory`,
  `scene_metadata`, `frames[i].annotations`, `frames[i].ego_status`,
  `map_api`), so any object that has them will do.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from diffusiondrive_torch.common.dataclasses import AgentInput
from diffusiondrive_torch.common.enums import BoundingBox2DIndex, BoundingBoxIndex, LidarIndex
from diffusiondrive_torch.evaluate.state_array import box_to_corners
from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.ops.preprocessing import pad_point_cloud
from diffusiondrive_torch.planning.bev_raster import coords_to_pixel, rasterize_map_layers
from diffusiondrive_torch.training.abstract_feature_target_builder import (
    AbstractFeatureBuilder,
    AbstractTargetBuilder,
)


def _status_feature(agent_input: AgentInput) -> np.ndarray:
    status = agent_input.ego_statuses[-1]
    return np.concatenate([np.asarray(status.driving_command, np.float32),
                           np.asarray(status.ego_velocity, np.float32),
                           np.asarray(status.ego_acceleration, np.float32)])


class TransfuserFeatureBuilder(AbstractFeatureBuilder):
    """Camera stitch + lidar BEV splat + ego status, on the host."""

    def __init__(self, config: TransfuserConfig):
        self._config = config

    def get_unique_name(self) -> str:
        return "transfuser_feature"

    def compute_features(self, agent_input: AgentInput) -> Dict[str, np.ndarray]:
        return {
            "camera_feature": self._get_camera_feature(agent_input),
            "lidar_feature": self._get_lidar_feature(agent_input),
            "status_feature": _status_feature(agent_input),
        }

    def _get_camera_feature(self, agent_input: AgentInput) -> np.ndarray:
        """Stitched (256, 1024, 3) uint8 front view."""
        import cv2

        cameras = agent_input.cameras[-1]
        l0 = cameras.cam_l0.image[28:-28, 416:-416]
        f0 = cameras.cam_f0.image[28:-28]
        r0 = cameras.cam_r0.image[28:-28, 416:-416]
        stitched = np.concatenate([l0, f0, r0], axis=1)
        return cv2.resize(stitched, (self._config.camera_width, self._config.camera_height))

    def _get_lidar_feature(self, agent_input: AgentInput) -> np.ndarray:
        """(256, 256, C) histogram splat (`transfuser_features.py:79-138`)."""
        cfg = self._config
        pc = agent_input.lidars[-1].lidar_pc[LidarIndex.POSITION].T  # (N, 3)

        pc = pc[pc[:, 2] < cfg.max_height_lidar]
        below = pc[pc[:, 2] <= cfg.lidar_split_height]
        above = pc[pc[:, 2] > cfg.lidar_split_height]

        def splat(points: np.ndarray) -> np.ndarray:
            xbins = np.linspace(cfg.lidar_min_x, cfg.lidar_max_x,
                                int((cfg.lidar_max_x - cfg.lidar_min_x) * cfg.pixels_per_meter) + 1)
            ybins = np.linspace(cfg.lidar_min_y, cfg.lidar_max_y,
                                int((cfg.lidar_max_y - cfg.lidar_min_y) * cfg.pixels_per_meter) + 1)
            hist = np.histogramdd(points[:, :2], bins=(xbins, ybins))[0]
            hist = np.minimum(hist, cfg.hist_max_per_pixel)
            return hist / cfg.hist_max_per_pixel

        above_feat = splat(above)
        if cfg.use_ground_plane:
            features = np.stack([splat(below), above_feat], axis=-1)
        else:
            features = above_feat[..., None]
        return features.astype(np.float32)


class RawSensorFeatureBuilder(AbstractFeatureBuilder):
    """Minimal host work: the raw camera images + the padded point cloud.

    Stitching, resize and the BEV histogram run on the device
    (`ops/preprocessing.py`). Used by
    `DiffusionDriveAgent(preprocess_on_device=True)`.
    """

    def __init__(self, config: TransfuserConfig, max_points: int = 131072):
        self._config = config
        self._max_points = max_points

    def get_unique_name(self) -> str:
        return "transfuser_raw_feature"

    def compute_features(self, agent_input: AgentInput) -> Dict[str, np.ndarray]:
        cameras = agent_input.cameras[-1]
        points, valid = pad_point_cloud(agent_input.lidars[-1].lidar_pc, self._max_points)
        return {
            "camera_l0": cameras.cam_l0.image,
            "camera_f0": cameras.cam_f0.image,
            "camera_r0": cameras.cam_r0.image,
            "lidar_points": points,
            "lidar_valid": valid,
            "status_feature": _status_feature(agent_input),
        }


class TransfuserTargetBuilder(AbstractTargetBuilder):
    """GT trajectory + nearest agent boxes + BEV semantic map."""

    # BEV classes stamped from the annotations: static objects, vehicles, pedestrians
    BOX_CLASSES = {4: ("czone_sign", "barrier", "traffic_cone", "generic_object"),
                   5: ("vehicle",),
                   6: ("pedestrian",)}

    def __init__(self, config: TransfuserConfig):
        self._config = config

    def get_unique_name(self) -> str:
        return "transfuser_target"

    def compute_targets(self, scene) -> Dict[str, np.ndarray]:
        cfg = self._config
        trajectory = scene.get_future_trajectory(cfg.trajectory_sampling.num_poses).poses.astype(np.float32)
        frame_idx = scene.scene_metadata.num_history_frames - 1
        annotations = scene.frames[frame_idx].annotations
        ego_pose = scene.frames[frame_idx].ego_status.ego_pose
        agent_states, agent_labels = self._compute_agent_targets(annotations)
        return {
            "trajectory": trajectory,
            "agent_states": agent_states,
            "agent_labels": agent_labels,
            "bev_semantic_map": self._compute_bev_semantic_map(annotations, scene.map_api, ego_pose),
        }

    def _compute_agent_targets(self, annotations) -> Tuple[np.ndarray, np.ndarray]:
        """The `num_bounding_boxes` nearest in-range vehicle boxes as (x, y,
        heading, length, width), zero-padded, and their bool labels."""
        cfg = self._config
        states: List[np.ndarray] = []
        for box, name in zip(annotations.boxes, annotations.names):
            x, y = box[BoundingBoxIndex.X], box[BoundingBoxIndex.Y]
            if name == "vehicle" and (cfg.lidar_min_x <= x <= cfg.lidar_max_x
                                      and cfg.lidar_min_y <= y <= cfg.lidar_max_y):
                states.append(np.array([x, y, box[BoundingBoxIndex.HEADING], box[BoundingBoxIndex.LENGTH],
                                        box[BoundingBoxIndex.WIDTH]], dtype=np.float32))
        agent_states = np.zeros((cfg.num_bounding_boxes, BoundingBox2DIndex.size()), np.float32)
        agent_labels = np.zeros(cfg.num_bounding_boxes, bool)
        if states:
            arr = np.stack(states)
            arr = arr[np.argsort(np.linalg.norm(arr[:, :2], axis=-1))[:cfg.num_bounding_boxes]]
            agent_states[:len(arr)] = arr
            agent_labels[:len(arr)] = True
        return agent_states, agent_labels

    def _compute_bev_semantic_map(self, annotations, map_api, ego_pose) -> np.ndarray:
        """The (bev_pixel_height, bev_pixel_width) int32 class raster."""
        import cv2

        cfg = self._config
        bev = np.zeros(cfg.bev_semantic_frame, dtype=np.int64)
        if map_api is not None:
            bev = rasterize_map_layers(map_api, ego_pose, cfg)
        for label, names in self.BOX_CLASSES.items():
            mask = np.zeros(cfg.bev_semantic_frame[::-1], dtype=np.uint8)
            for name, box in zip(annotations.names, annotations.boxes):
                if name not in names:
                    continue
                corners = box_to_corners(*(np.float64(box[i]) for i in (
                    BoundingBoxIndex.X, BoundingBoxIndex.Y, BoundingBoxIndex.HEADING,
                    BoundingBoxIndex.LENGTH, BoundingBoxIndex.WIDTH)))
                cv2.fillPoly(mask, [coords_to_pixel(corners.reshape(-1, 1, 2), cfg)], color=255)
            mask = np.rot90(mask)[::-1]
            bev[mask > 0] = label
        return bev.astype(np.int32)
