"""Camera-view rendering: tiles, 3D box projection, lidar overlay.

Parity: `navsim/visualization/camera.py` — per-camera images with projected
annotation boxes and lidar points using the sensor2lidar calibration.

Counterpart of `diffusiondrive_tpu/visualization/camera.py`: host code,
cv2 imported inside the functions.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from diffusiondrive_torch.common.dataclasses import Camera, Cameras, Lidar
from diffusiondrive_torch.common.enums import BoundingBoxIndex, LidarIndex
from diffusiondrive_torch.visualization.config import AGENT_CONFIG


def _box_corners_3d(box: np.ndarray) -> np.ndarray:
    """(7,) box -> (8, 3) corners in the ego/lidar frame."""
    x, y, z = box[BoundingBoxIndex.POSITION]
    l, w, h = box[BoundingBoxIndex.DIMENSION]
    yaw = box[BoundingBoxIndex.HEADING]
    dx, dy, dz = l / 2, w / 2, h / 2
    corners = np.array(
        [[sx * dx, sy * dy, sz * dz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)]
    )
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return corners @ R.T + np.array([x, y, z])


def project_points_to_camera(points: np.ndarray, camera: Camera) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 3) lidar-frame points -> ((N, 2) pixels, (N,) in-front+in-image mask)."""
    R = np.asarray(camera.sensor2lidar_rotation)
    t = np.asarray(camera.sensor2lidar_translation)
    K = np.asarray(camera.intrinsics)
    cam_pts = (points - t) @ R  # lidar -> camera frame (R columns = cam axes in lidar)
    depths = cam_pts[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = (cam_pts @ K.T)[:, :2] / np.maximum(depths[:, None], 1e-6)
    h, w = camera.image.shape[:2]
    ok = (depths > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    return uv, ok


_BOX_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]


def add_annotations_to_camera(image: np.ndarray, camera: Camera, boxes: np.ndarray,
                              names: List[str]) -> np.ndarray:
    """Draw projected 3D boxes onto a copy of the camera image."""
    import cv2

    out = image.copy()
    for box, name in zip(boxes, names):
        corners = _box_corners_3d(np.asarray(box, np.float64))
        uv, ok = project_points_to_camera(corners, camera)
        if ok.sum() < 2:
            continue
        color = AGENT_CONFIG.get(name, AGENT_CONFIG["generic_object"])["line_color"]
        bgr = tuple(int(color.lstrip("#")[i : i + 2], 16) for i in (4, 2, 0))
        for a, b in _BOX_EDGES:
            if ok[a] and ok[b]:
                cv2.line(out, tuple(uv[a].astype(int)), tuple(uv[b].astype(int)), bgr, 2)
    return out


def add_lidar_to_camera(image: np.ndarray, camera: Camera, lidar: Lidar) -> np.ndarray:
    """Scatter lidar returns onto the camera image, colored by depth."""
    import cv2

    out = image.copy()
    pts = lidar.lidar_pc[LidarIndex.POSITION].T
    uv, ok = project_points_to_camera(pts, camera)
    depths = np.linalg.norm(pts[ok], axis=-1)
    if len(depths) == 0:
        return out
    d_norm = np.clip(depths / 60.0, 0, 1)
    for (u, v), d in zip(uv[ok].astype(int), d_norm):
        color = (int(255 * (1 - d)), 64, int(255 * d))
        cv2.circle(out, (u, v), 1, color, -1)
    return out


def add_trajectory_to_camera(image: np.ndarray, camera: Camera, poses: np.ndarray,
                             color: str = "#DE5D4F", z: float = 0.0) -> np.ndarray:
    """Project a local-frame trajectory ((N, >=2) poses) onto the camera image
    as a connected ground-plane polyline."""
    import cv2

    out = image.copy()
    pts = np.concatenate([np.asarray(poses)[:, :2], np.full((len(poses), 1), z)], axis=1)
    uv, ok = project_points_to_camera(pts, camera)
    bgr = tuple(int(color.lstrip("#")[i : i + 2], 16) for i in (4, 2, 0))
    uv = uv.astype(int)
    for a in range(len(uv) - 1):
        if ok[a] and ok[a + 1]:
            cv2.line(out, tuple(uv[a]), tuple(uv[a + 1]), bgr, 2)
    for a in range(len(uv)):
        if ok[a]:
            cv2.circle(out, tuple(uv[a]), 3, bgr, -1)
    return out


def camera_tile(cameras: Cameras, order: Optional[List[str]] = None) -> np.ndarray:
    """Stack available camera images into one tile image (rows of 3)."""
    order = order or ["cam_l0", "cam_f0", "cam_r0", "cam_l2", "cam_b0", "cam_r2"]
    imgs = [getattr(cameras, name).image for name in order if getattr(cameras, name).image is not None]
    if not imgs:
        return np.zeros((1, 1, 3), np.uint8)
    h = min(im.shape[0] for im in imgs)
    imgs = [im[:h] for im in imgs]
    rows = [np.concatenate(imgs[i : i + 3], axis=1) for i in range(0, len(imgs) - len(imgs) % 3, 3)]
    if not rows:
        return imgs[0]
    w = min(r.shape[1] for r in rows)
    return np.concatenate([r[:, :w] for r in rows], axis=0)
