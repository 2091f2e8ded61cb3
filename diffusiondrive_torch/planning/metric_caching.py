"""Metric-cache production: PDM-Closed rollout + GT observation per scene.

Parity: `navsim/planning/metric_caching/metric_cache_processor.py` and
`caching.py` — per token: run PDM-Closed for the reference trajectory,
interpolate GT detections 2 Hz -> 10 Hz, extract centerline/drivable map, and
dump one array-native `metric_cache.npz` (+ a metadata CSV). Resumable: the
processor returns early if the cache file exists.

The reference fans out per-log over Ray; here a host thread pool does the
same share-nothing fan-out, with hosts sharding tokens by index.

Counterpart of `diffusiondrive_tpu/planning/metric_caching.py`: the same
host code, with `device=` threaded through to each scene's
`PDMClosedPlanner` (the card unless `device="cpu"` is asked for). Every
thread of `cache_data` launches on that one device.
"""

from __future__ import annotations

import csv
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from diffusiondrive_torch.common.dataclasses import Scene
from diffusiondrive_torch.common.dataloader import SceneLoader
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.evaluate.metric_cache import MetricCache
from diffusiondrive_torch.planning.map_api import LocalMapAPI
from diffusiondrive_torch.planning.pdm_closed.observation_builder import (
    build_drivable_area_map,
    build_gt_observation,
    ego_state_array_from_scene,
)
from diffusiondrive_torch.planning.pdm_closed.planner import PDMClosedConfig, PDMClosedPlanner

logger = logging.getLogger(__name__)


class MetricCacheProcessor:
    """Computes and stores one metric cache per scene token."""

    def __init__(
        self,
        cache_path: str,
        force_feature_computation: bool = False,
        planner_config: Optional[PDMClosedConfig] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self._cache_path = Path(cache_path)
        self._force = force_feature_computation
        self._planner_config = planner_config or PDMClosedConfig()
        self.device = resolve_device(device)

    def cache_file(self, scene: Scene) -> Path:
        meta = scene.scene_metadata
        return self._cache_path / meta.log_name / meta.initial_token / "metric_cache.npz"

    def compute_metric_cache(self, scene: Scene, map_api: Optional[LocalMapAPI] = None) -> Optional[Path]:
        file_name = self.cache_file(scene)
        if file_name.exists() and not self._force:
            return file_name

        cfg = self._planner_config
        planner = PDMClosedPlanner(cfg, device=self.device)
        map_api = map_api if map_api is not None else scene.map_api
        pdm_poses, pdm_times = planner.compute_planner_trajectory(scene, map_api)

        ego_state = ego_state_array_from_scene(scene)
        gt_tracks = build_gt_observation(scene, cfg.proposal_sampling, cfg.trajectory_sampling)

        if planner.centerline is not None:
            centerline = planner.centerline.coords.astype(np.float32)
            route_lane_ids = list(planner._route_lane_dict.keys())
            drivable = planner.drivable_area_map
        else:
            # mapless fallback: centerline = planned path; empty drivable map
            centerline = pdm_poses[:, :2].astype(np.float32)
            route_lane_ids = []
            drivable = build_drivable_area_map(None, ego_state, [])

        MetricCache(
            token=scene.scene_metadata.initial_token,
            log_name=scene.scene_metadata.log_name,
            pdm_poses=pdm_poses,
            pdm_times=pdm_times,
            initial_state=ego_state,
            tracks=gt_tracks,
            drivable=drivable,
            centerline=centerline,
            route_lane_ids=route_lane_ids,
        ).save(file_name)
        return file_name


def cache_data(
    scene_loader: SceneLoader,
    cache_path: str,
    force: bool = False,
    num_workers: int = 8,
    host_id: int = 0,
    num_hosts: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> List[Path]:
    """Fan out metric caching over tokens; writes a metadata CSV
    (`caching.py:27-169`)."""
    processor = MetricCacheProcessor(cache_path, force_feature_computation=force, device=device)
    tokens = sorted(scene_loader.tokens)
    if num_hosts > 1:
        tokens = [t for i, t in enumerate(tokens) if i % num_hosts == host_id]

    paths: List[Path] = []
    failures = 0

    def process(token: str) -> Optional[Path]:
        try:
            scene = scene_loader.get_scene_from_token(token)
            return processor.compute_metric_cache(scene)
        except Exception:
            logger.exception("Metric caching failed for token %s", token)
            return None

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for result in pool.map(process, tokens):
            if result is None:
                failures += 1
            else:
                paths.append(result)

    metadata_dir = Path(cache_path) / "metadata"
    metadata_dir.mkdir(parents=True, exist_ok=True)
    csv_path = metadata_dir / f"metric_cache_metadata_node_{host_id}.csv"
    with open(csv_path, "w", newline="") as fp:
        writer = csv.writer(fp)
        writer.writerow(["file_name"])
        for p in paths:
            writer.writerow([str(p)])
    logger.info("Cached %d tokens (%d failures) -> %s", len(paths), failures, cache_path)
    return paths
