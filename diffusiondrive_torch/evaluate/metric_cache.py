"""Array-native metric cache: the per-scene record consumed by PDM scoring.

Copy of `diffusiondrive_tpu/evaluate/metric_cache.py`: a flat, numpy-only
record that serializes to one compressed .npz per token, so a cache written
by the JAX package loads here as it is. Contents mirror the reference cache
(`navsim/planning/metric_caching/metric_cache.py`):

- the PDM-Closed reference trajectory (global poses + times),
- the current ego state array,
- the GT-interpolated occupancy forecast in compact (pose, extent) form,
- the centerline polyline,
- the drivable-area polygons with layers/on-route masks.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

from diffusiondrive_torch.evaluate.observation import DrivableAreaArrays, TrackArrays


@dataclasses.dataclass
class MetricCache:
    """Per-scene scoring context (see module docstring)."""

    token: str
    log_name: str

    # PDM-Closed reference trajectory: global (M, 3) poses at `pdm_times` [s]
    # relative to the current frame (t=0 included).
    pdm_poses: np.ndarray
    pdm_times: np.ndarray

    initial_state: np.ndarray       # (11,) ego state array (global frame)

    tracks: TrackArrays
    drivable: DrivableAreaArrays
    centerline: np.ndarray          # (Lc, 2)
    route_lane_ids: Optional[list] = None

    def save(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            token=np.asarray(self.token),
            log_name=np.asarray(self.log_name),
            pdm_poses=self.pdm_poses,
            pdm_times=self.pdm_times,
            initial_state=self.initial_state,
            tracks_poses=self.tracks.poses,
            tracks_extents=self.tracks.extents,
            tracks_valid=self.tracks.valid,
            tracks_headings=self.tracks.headings,
            tracks_is_agent=self.tracks.is_agent,
            tracks_is_red_light=self.tracks.is_red_light,
            tracks_is_stopped=self.tracks.is_stopped,
            tracks_previously_collided=self.tracks.previously_collided,
            tracks_global_to_local=self.tracks.global_to_local,
            tracks_speeds=self.tracks.speeds,
            drivable_polygons=self.drivable.polygons,
            drivable_valid=self.drivable.valid,
            drivable_layers=self.drivable.layers,
            drivable_on_route=self.drivable.on_route,
            centerline=self.centerline,
            route_lane_ids=np.asarray(self.route_lane_ids or [], dtype=object),
        )

    @classmethod
    def load(cls, path: Path) -> "MetricCache":
        data = np.load(path, allow_pickle=True)
        if "tracks_poses" not in data and "tracks_polygons" in data:
            raise ValueError(
                f"{path} was written by an older cache format (dense track "
                "rings). Re-run metric caching (or pass --force) to "
                "regenerate caches in the compact (pose, extent) format."
            )
        return cls(
            token=str(data["token"]),
            log_name=str(data["log_name"]),
            pdm_poses=data["pdm_poses"],
            pdm_times=data["pdm_times"],
            initial_state=data["initial_state"],
            tracks=TrackArrays(
                poses=data["tracks_poses"],
                extents=data["tracks_extents"],
                valid=data["tracks_valid"],
                headings=data["tracks_headings"],
                is_agent=data["tracks_is_agent"],
                is_red_light=data["tracks_is_red_light"],
                is_stopped=data["tracks_is_stopped"],
                previously_collided=data["tracks_previously_collided"],
                global_to_local=data["tracks_global_to_local"],
                speeds=data["tracks_speeds"] if "tracks_speeds" in data else None,
            ),
            drivable=DrivableAreaArrays(
                polygons=data["drivable_polygons"],
                valid=data["drivable_valid"],
                layers=data["drivable_layers"],
                on_route=data["drivable_on_route"],
            ),
            centerline=data["centerline"],
            route_lane_ids=list(data["route_lane_ids"]),
        )
