"""Synthetic straight-road fixtures shared by the quickstart, benchmarks and
tests: an OpenScene-format log pickle and a matching `LocalMapAPI`.

The scene is a constant-velocity drive along +x with one parked vehicle ahead
— just enough structure for the PDM-Closed planner, metric caching, and PDMS
scoring to exercise their real code paths without any datasets.

Copy of `diffusiondrive_tpu/utils/synthetic.py` (numpy on the host, as there).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from diffusiondrive_torch.common.geometry import yaw_to_quaternion
from diffusiondrive_torch.evaluate.observation import MapLayer
from diffusiondrive_torch.planning.map_api import LocalMapAPI, MapObjectData

CAM_NAMES = ["CAM_F0", "CAM_L0", "CAM_L1", "CAM_L2", "CAM_R0", "CAM_R1", "CAM_R2", "CAM_B0"]


def make_straight_map(num_blocks: int = 4, block_len: float = 100.0, width: float = 8.0,
                      start_x: float = -100.0) -> LocalMapAPI:
    """Straight road: chained roadblocks, one lane each, baseline along y=0."""
    objects = []
    for i in range(num_blocks):
        x0 = start_x + i * block_len
        x1 = x0 + block_len
        rect = np.array([[x0, -width / 2], [x1, -width / 2], [x1, width / 2], [x0, width / 2]])
        rb_token, lane_token = f"rb{i}", f"lane{i}"
        objects.append(
            MapObjectData(
                token=rb_token, layer=MapLayer.ROADBLOCK, polygon=rect,
                outgoing=[f"rb{i+1}"] if i + 1 < num_blocks else [],
                incoming=[f"rb{i-1}"] if i > 0 else [],
            )
        )
        baseline_x = np.arange(x0, x1 + 1.0, 1.0)
        baseline = np.stack([baseline_x, np.zeros_like(baseline_x), np.zeros_like(baseline_x)], axis=-1)
        objects.append(
            MapObjectData(
                token=lane_token, layer=MapLayer.LANE, polygon=rect, baseline=baseline,
                outgoing=[f"lane{i+1}"] if i + 1 < num_blocks else [],
                incoming=[f"lane{i-1}"] if i > 0 else [],
                parent_token=rb_token, speed_limit=15.0,
            )
        )
    return LocalMapAPI(objects, "synthetic")


def build_synthetic_log(
    root: Path,
    num_frames: int = 15,
    log_name: str = "demo_log",
    speed: float = 4.0,
    with_sensor_blobs: bool = False,
    obstacle_x: Optional[float] = 30.0,
    roadblock_ids: Tuple[str, ...] = ("rb1", "rb2", "rb3"),
) -> Tuple[Path, Path]:
    """Write one OpenScene-format log pickle (plus optional jpeg/pcd blobs).

    Returns (logs_dir, blobs_dir). Frame interval is 0.5 s; ego drives +x at
    `speed`; a parked vehicle sits at global (obstacle_x, 1) when set.
    """
    root = Path(root)
    logs_dir, blobs_dir = root / "logs", root / "blobs"
    logs_dir.mkdir(parents=True, exist_ok=True)
    (blobs_dir / "cams").mkdir(parents=True, exist_ok=True)
    (blobs_dir / "lidar").mkdir(parents=True, exist_ok=True)

    if with_sensor_blobs:
        import cv2

        rng = np.random.default_rng(0)
        cv2.imwrite(str(blobs_dir / "cams/img.jpg"),
                    rng.integers(0, 255, (1080, 1920, 3), dtype=np.uint8))
        pts = np.zeros((6, 2000), np.float32)
        pts[0] = rng.uniform(-30, 30, 2000)
        pts[1] = rng.uniform(-30, 30, 2000)
        pts[2] = rng.uniform(0.3, 2.0, 2000)
        header = ("VERSION 0.7\nFIELDS x y z intensity ring lidar_id\nSIZE 4 4 4 4 4 4\n"
                  "TYPE F F F F F F\nCOUNT 1 1 1 1 1 1\nWIDTH 2000\nHEIGHT 1\n"
                  "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS 2000\nDATA binary\n")
        with open(blobs_dir / "lidar/pc.pcd", "wb") as fp:
            fp.write(header.encode())
            fp.write(pts.T.tobytes())

    cams = {
        name: dict(data_path="cams/img.jpg", sensor2lidar_rotation=np.eye(3),
                   sensor2lidar_translation=np.zeros(3), cam_intrinsic=np.eye(3),
                   distortion=np.zeros(5))
        for name in CAM_NAMES
    }
    dx = speed * 0.5
    frames = []
    for i in range(num_frames):
        anns = (
            dict(
                gt_boxes=np.array([[obstacle_x - dx * i, 1.0, 0.5, 4.5, 2.0, 1.7, 0.0]], np.float32),
                gt_names=["vehicle"], gt_velocity_3d=np.zeros((1, 3), np.float32),
                instance_tokens=["inst_0"], track_tokens=["track_0"],
            )
            if obstacle_x is not None
            else dict(
                gt_boxes=np.zeros((0, 7), np.float32), gt_names=[],
                gt_velocity_3d=np.zeros((0, 3), np.float32), instance_tokens=[], track_tokens=[],
            )
        )
        frames.append(
            dict(
                token=f"{log_name}_token_{i:05d}", timestamp=int(i * 5e5), log_name=log_name,
                scene_token=f"{log_name}_scene", map_location="synthetic",
                roadblock_ids=list(roadblock_ids), traffic_lights=[],
                ego2global_translation=[dx * i, 0.0, 0.0],
                ego2global_rotation=list(yaw_to_quaternion(0.0)),
                ego_dynamic_state=[speed, 0.0, 0.0, 0.0], driving_command=[0, 1, 0, 0],
                cams=cams, lidar_path="lidar/pc.pcd", anns=anns,
            )
        )
    with open(logs_dir / f"{log_name}.pkl", "wb") as fp:
        pickle.dump(frames, fp)
    return logs_dir, blobs_dir
