"""Scene and metric-cache loading from OpenScene logs.

Copy of `diffusiondrive_tpu/common/dataloader.py` (parity: navsim's
`filter_scenes`, `SceneLoader`, `MetricCacheLoader`). Logs are one pickle
per log file holding a list of frame dicts; scenes are fixed windows of
num_history + num_future frames. The metric cache is the array-native .npz
format (`evaluate/metric_cache.py`), indexed by a metadata CSV like the
reference's, so logs and caches written for the JAX package read here.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict, List

from diffusiondrive_torch.common.dataclasses import AgentInput, Scene, SceneFilter, SensorConfig
from diffusiondrive_torch.evaluate.metric_cache import MetricCache


def filter_scenes(data_path: Path, scene_filter: SceneFilter) -> Dict[str, List[Dict[str, Any]]]:
    """Scan logs and split into filtered scene windows (`dataloader.py:14-66`)."""
    filtered: Dict[str, List[Dict[str, Any]]] = {}
    tokens = set(scene_filter.tokens) if scene_filter.tokens is not None else None

    log_files = sorted(Path(data_path).iterdir())
    if scene_filter.log_names is not None:
        wanted = set(scene_filter.log_names)
        log_files = [f for f in log_files if f.name.replace(".pkl", "") in wanted]

    for log_path in log_files:
        with open(log_path, "rb") as fp:
            frames = pickle.load(fp)
        for start in range(0, len(frames), scene_filter.frame_interval):
            window = frames[start : start + scene_filter.num_frames]
            if len(window) < scene_filter.num_frames:
                continue
            current = window[scene_filter.num_history_frames - 1]
            if scene_filter.has_route and len(current["roadblock_ids"]) == 0:
                continue
            token = current["token"]
            if tokens is not None and token not in tokens:
                continue
            filtered[token] = window
            if scene_filter.max_scenes is not None and len(filtered) >= scene_filter.max_scenes:
                return filtered
    return filtered


class SceneLoader:
    """Loads Scene / AgentInput dataclasses by token."""

    def __init__(
        self,
        data_path: Path,
        sensor_blobs_path: Path,
        scene_filter: SceneFilter,
        sensor_config: SensorConfig = None,
        build_map_api: bool = True,
    ):
        self.scene_frames_dicts = filter_scenes(data_path, scene_filter)
        self._sensor_blobs_path = sensor_blobs_path
        self._scene_filter = scene_filter
        self._sensor_config = sensor_config or SensorConfig.build_no_sensors()
        self._build_map_api = build_map_api

    @property
    def tokens(self) -> List[str]:
        return list(self.scene_frames_dicts.keys())

    def __len__(self) -> int:
        return len(self.tokens)

    def __getitem__(self, idx: int) -> str:
        return self.tokens[idx]

    def get_scene_from_token(self, token: str) -> Scene:
        assert token in self.scene_frames_dicts, f"unknown token {token}"
        return Scene.from_scene_dict_list(
            self.scene_frames_dicts[token],
            self._sensor_blobs_path,
            num_history_frames=self._scene_filter.num_history_frames,
            num_future_frames=self._scene_filter.num_future_frames,
            sensor_config=self._sensor_config,
            build_map_api=self._build_map_api,
        )

    def get_agent_input_from_token(self, token: str) -> AgentInput:
        assert token in self.scene_frames_dicts, f"unknown token {token}"
        return AgentInput.from_scene_dict_list(
            self.scene_frames_dicts[token],
            self._sensor_blobs_path,
            num_history_frames=self._scene_filter.num_history_frames,
            sensor_config=self._sensor_config,
        )

    def get_tokens_list_per_log(self) -> Dict[str, List[str]]:
        per_log: Dict[str, List[str]] = {}
        for token, frames in self.scene_frames_dicts.items():
            per_log.setdefault(frames[0]["log_name"], []).append(token)
        return per_log


class MetricCacheLoader:
    """Loads array-native metric caches (.npz) from a cache directory."""

    FILE_NAME = "metric_cache.npz"

    def __init__(self, cache_path: Path, file_name: str = FILE_NAME):
        self._file_name = file_name
        self.metric_cache_paths = self._load_paths(Path(cache_path))

    def _load_paths(self, cache_path: Path) -> Dict[str, Path]:
        metadata_dir = cache_path / "metadata"
        if metadata_dir.exists():
            csvs = [f for f in metadata_dir.iterdir() if f.suffix == ".csv"]
            if csvs:
                with open(csvs[0]) as fp:
                    lines = fp.read().splitlines()[1:]
                return {Path(line).parts[-2]: Path(line) for line in lines}
        # fallback: glob the directory tree
        return {p.parent.name: p for p in cache_path.rglob(self._file_name)}

    @property
    def tokens(self) -> List[str]:
        return list(self.metric_cache_paths.keys())

    def __len__(self) -> int:
        return len(self.metric_cache_paths)

    def __getitem__(self, idx: int) -> MetricCache:
        return self.get_from_token(self.tokens[idx])

    def get_from_token(self, token: str) -> MetricCache:
        return MetricCache.load(self.metric_cache_paths[token])
