"""Plan-anchor generation: k-means over GT future trajectories.

Copy of `diffusiondrive_tpu/utils/anchors.py` (numpy only), so that the
port computes the same anchors bit for bit with no import of the JAX
package: `default_plan_anchors(num_modes, num_poses)` for any shape but
the shipped (20, 8), and `script/make_plan_anchors.py` from a cache or
logs. Output shape: (num_modes, num_poses, 2), consumed via
`TransfuserConfig.plan_anchor_path` by `DiffusionDriveAgent.initialize()`.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterable, List

import numpy as np

logger = logging.getLogger(__name__)


def kmeans(points: np.ndarray, num_clusters: int, num_iters: int = 50, seed: int = 0) -> np.ndarray:
    """Plain Lloyd's k-means with k-means++ init over (N, D) rows.

    Deterministic for a given seed; empty clusters are re-seeded to the point
    farthest from its assigned centroid.
    """
    n = points.shape[0]
    if n < num_clusters:
        raise ValueError(f"need >= {num_clusters} samples, got {n}")
    rng = np.random.default_rng(seed)

    # k-means++ seeding
    centroids = [points[rng.integers(n)]]
    for _ in range(1, num_clusters):
        d2 = np.min(
            np.sum((points[:, None] - np.stack(centroids)[None]) ** 2, axis=-1), axis=-1
        )
        probs = d2 / max(d2.sum(), 1e-12)
        centroids.append(points[rng.choice(n, p=probs)])
    centroids = np.stack(centroids)

    for _ in range(num_iters):
        d2 = np.sum((points[:, None] - centroids[None]) ** 2, axis=-1)  # (N, K)
        assign = np.argmin(d2, axis=-1)
        new_centroids = centroids.copy()
        for k in range(num_clusters):
            members = points[assign == k]
            if len(members):
                new_centroids[k] = members.mean(axis=0)
            else:  # re-seed an empty cluster with the worst-fit point
                new_centroids[k] = points[np.argmax(np.min(d2, axis=-1))]
        if np.allclose(new_centroids, centroids):
            centroids = new_centroids
            break
        centroids = new_centroids
    return centroids


def kmeans_plan_anchors(
    trajectories: np.ndarray, num_modes: int = 20, num_iters: int = 50, seed: int = 0
) -> np.ndarray:
    """(N, P, >=2) GT futures -> (num_modes, P, 2) anchor trajectories."""
    xy = np.asarray(trajectories, np.float64)[..., :2]
    n, p, _ = xy.shape
    centroids = kmeans(xy.reshape(n, p * 2), num_modes, num_iters=num_iters, seed=seed)
    return centroids.reshape(num_modes, p, 2).astype(np.float32)


def collect_trajectories_from_cache(cache_path: Path,
                                    builder_name: str = "transfuser_target") -> np.ndarray:
    """Stack GT `trajectory` targets from a cached dataset
    (`cache/<log>/<token>/<builder>.gz`, see `training/dataset.py`)."""
    from diffusiondrive_torch.training.dataset import load_feature_target

    rows: List[np.ndarray] = []
    for gz in sorted(Path(cache_path).rglob(f"{builder_name}.gz")):
        data = load_feature_target(gz)
        if "trajectory" in data:
            rows.append(np.asarray(data["trajectory"], np.float32))
    if not rows:
        raise FileNotFoundError(f"no '{builder_name}.gz' with a 'trajectory' key under {cache_path}")
    return np.stack(rows)


def collect_trajectories_from_scenes(scene_loader, num_poses: int = 8) -> np.ndarray:
    """Stack GT futures straight from a SceneLoader (no feature cache needed)."""
    rows: List[np.ndarray] = []
    for token in scene_loader.tokens:
        scene = scene_loader.get_scene_from_token(token)
        rows.append(scene.get_future_trajectory(num_poses).poses.astype(np.float32))
    if not rows:
        raise ValueError("scene loader yielded no scenes")
    return np.stack(rows)


def synthetic_driving_trajectories(
    num_samples: int = 8192, num_poses: int = 8, dt: float = 0.5, seed: int = 0
) -> np.ndarray:
    """Sample (N, P, 2) ego-frame futures from a kinematic driving prior.

    Stand-in data source for anchor generation when no logs exist: unicycle
    rollouts x(t), y(t) under a mixture that mirrors urban-driving statistics
    (the navtrain distribution the reference's `kmeans_navsim_traj_20.npy`
    was clustered from) — mostly straight cruising, a spread of speeds up to
    ~14 m/s, braking-to-stop and pull-away modes, and genuine left/right
    turns (|curvature| up to 0.1 1/m). Everything stays inside the diffusion
    normalization box (x in [-1.2, 55.7], y in [-20, 26], `norm_odo`).
    """
    rng = np.random.default_rng(seed)
    n = num_samples

    # initial speed mixture: stopped / crawl / urban cruise
    comp = rng.choice(3, size=n, p=[0.10, 0.35, 0.55])
    v0 = np.where(comp == 0, rng.uniform(0.0, 0.3, n),
                  np.where(comp == 1, rng.uniform(0.3, 6.0, n),
                           rng.uniform(6.0, 13.5, n)))
    # longitudinal accel: mostly gentle, some hard braking / pull-away
    accel = np.clip(rng.normal(0.0, 1.0, n), -3.0, 2.0)
    accel = np.where((comp == 0) & (rng.uniform(size=n) < 0.5),
                     rng.uniform(0.5, 2.0, n), accel)  # pull-away from stop
    # curvature mixture: straight / gentle arc / intersection turn
    turn = rng.choice(3, size=n, p=[0.55, 0.30, 0.15])
    kappa = np.where(
        turn == 0, rng.normal(0.0, 0.003, n),
        np.where(turn == 1, rng.normal(0.0, 0.02, n),
                 rng.choice([-1.0, 1.0], n) * rng.uniform(0.03, 0.10, n)))
    # tight turns happen at low speed (lateral-accel comfort bound ~3 m/s^2)
    v_max_lat = np.sqrt(3.0 / np.maximum(np.abs(kappa), 1e-6))

    # Keep rollouts inside the normalization box BY CONSTRUCTION (no post-hoc
    # position clipping, which piles probability mass on the box edge and
    # flattens clipped arcs into kinematically inconsistent shapes):
    # - longitudinal: v <= 13.5 m/s keeps x_end <= 13.5 * 4 s = 54 < 55;
    # - lateral: an arc of length L on radius R=1/|kappa| reaches at most
    #   R(1-cos(L/R)) laterally, so cap L (hence v) to keep |y| < 19.5.
    horizon = num_poses * dt
    radius = 1.0 / np.maximum(np.abs(kappa), 1e-6)
    arc_max = radius * np.arccos(np.clip(1.0 - 19.5 / radius, -1.0, 1.0))
    v_cap = np.minimum(13.5, np.minimum(v_max_lat, arc_max / horizon))
    v0 = np.minimum(v0, v_cap)
    accel = np.minimum(accel, (v_cap - v0) / horizon)

    steps = 10  # integrate at 0.05 s then subsample to the 0.5 s pose grid
    h = dt / steps
    x = np.zeros(n)
    y = np.zeros(n)
    psi = np.zeros(n)
    v = v0.copy()
    poses = np.zeros((n, num_poses, 2), np.float64)
    for p in range(num_poses):
        for _ in range(steps):
            v = np.minimum(np.clip(v + accel * h, 0.0, None), v_cap)
            x = x + v * np.cos(psi) * h
            y = y + v * np.sin(psi) * h
            psi = psi + kappa * v * h
        poses[:, p, 0] = x
        poses[:, p, 1] = y
    return poses.astype(np.float32)
