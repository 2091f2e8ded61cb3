"""Array-native evaluation context: occupancy forecast + drivable map.

Copy of `diffusiondrive_tpu/evaluate/observation.py` (numpy, host side).
Replaces the object-graph `PDMObservation`/`PDMOccupancyMap`/`PDMDrivableMap`
(`pdm_planner/observation/*.py`) with padded, fixed-shape arrays so a batch
of scenes stacks into the scorer's tensors:

- tracks: one oriented box per (local timestep, object) with validity
  masks and per-object attributes (agent type, stopped, red-light,
  previously collided). Dynamic objects are forecast at constant velocity.
- drivable map: padded polygon rings with semantic-layer ids (`MapLayer`,
  in `common/enums.py`) and an on-route lane mask.

The `time index -> local map` subsampling (one occupancy map per
`observation_sample_res`=2 samples) is kept as an index table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from diffusiondrive_torch.common.dataclasses import TrajectorySampling
from diffusiondrive_torch.common.enums import MapLayer  # noqa: F401  (re-exported as in JAX)


@dataclass
class TrackArrays:
    """Padded per-object occupancy forecast, in COMPACT (pose + extent) form.

    Shapes: L = number of local occupancy maps, O = max objects.

    Tracks are oriented boxes: a per-local-map pose plus a per-object extent.
    The device scorer expands (pose, extent) -> 4-corner rings IN-GRAPH
    (`scorer.score_proposals`), so the metric cache and every host->device
    transfer carry 3 floats per (L, O) cell instead of a padded V-vertex ring
    — ~11x fewer bytes through the interconnect and 4x fewer edge pairs in
    each polygon-intersection test than the earlier (L, O, 16, 2) layout.

    Red-light lane connectors are not boxes; the planner builder supplies
    their exact rings via `rings_override`, which only HOST consumers (the
    IDM leading-agent corridor search, `planner.py`) ever read through the
    `polygons` property. The device scorer masks red lights out of every
    metric, matching the reference (`pdm_scorer.py:313,468`), so their
    box approximation on device is inconsequential.
    """

    poses: np.ndarray             # (L, O, 3) float32 box pose (x, y, heading) per local map
    extents: np.ndarray           # (O, 2) float32 (length, width)
    valid: np.ndarray             # (O,) bool — object exists
    headings: np.ndarray          # (O,) float32 box heading (current frame)
    is_agent: np.ndarray          # (O,) bool — AGENT_TYPES (vehicle/ped/bicycle)
    is_red_light: np.ndarray      # (O,) bool
    is_stopped: np.ndarray        # (O,) bool — track speed <= 5e-2 m/s
    previously_collided: np.ndarray  # (O,) bool — collision at t=0, ignored
    global_to_local: np.ndarray   # (T_global,) int — time idx -> local map idx
    speeds: np.ndarray = None     # (O,) float32 current speed (leading-agent search)
    rings_override: np.ndarray = None  # (L, O, V, 2) exact rings (host-only; red lights)

    def __post_init__(self):
        if self.speeds is None:
            self.speeds = np.zeros(self.poses.shape[1], np.float32)
        self._polygons_cache = None

    @property
    def num_objects(self) -> int:
        return self.poses.shape[1]

    @property
    def centers(self) -> np.ndarray:
        """(L, O, 2) box centers over time."""
        return self.poses[..., :2]

    @property
    def polygons(self) -> np.ndarray:
        """(L, O, V, 2) materialized rings for HOST consumers (cached).

        V=4 box corners expanded from (pose, extent); red-light slots come
        verbatim from `rings_override` (padded to its V if wider than 4).
        """
        if self._polygons_cache is None:
            from diffusiondrive_torch.evaluate.state_array import box_to_corners

            corners = box_to_corners(
                self.poses[..., 0], self.poses[..., 1], self.poses[..., 2],
                self.extents[None, :, 0], self.extents[None, :, 1],
            ).astype(np.float32)  # (L, O, 4, 2)
            if self.rings_override is not None:
                V = self.rings_override.shape[2]
                out = np.repeat(corners[:, :, 3:4], V, axis=2)
                out[:, :, :4] = corners
                override = self.is_red_light
                out[:, override] = self.rings_override[:, override]
                corners = out
            self._polygons_cache = corners
        return self._polygons_cache


@dataclass
class DrivableAreaArrays:
    """Padded drivable-area map polygons."""

    polygons: np.ndarray    # (P, V, 2) float32 rings
    valid: np.ndarray       # (P,) bool
    layers: np.ndarray      # (P,) int32 MapLayer ids
    on_route: np.ndarray    # (P,) bool — lane/lane-connector on the route


@dataclass
class ScoringContext:
    """Everything `score_proposals` needs for one scene, as arrays."""

    tracks: TrackArrays
    drivable: DrivableAreaArrays
    centerline: np.ndarray        # (Lc, 2) float32 polyline
    initial_state: np.ndarray     # (11,) ego state array at t=0


def pad_rings(rings: List[np.ndarray], max_vertices: int) -> np.ndarray:
    """Stack variable-length rings into (N, V, 2), repeating the last vertex.

    Rings longer than `max_vertices` are decimated by uniform subsampling
    (keeps endpoints; acceptable for map polygons at scorer tolerance).
    """
    out = np.zeros((len(rings), max_vertices, 2), dtype=np.float32)
    for i, ring in enumerate(rings):
        ring = np.asarray(ring, dtype=np.float32)
        # drop an explicit closing vertex
        if len(ring) > 1 and np.allclose(ring[0], ring[-1]):
            ring = ring[:-1]
        if len(ring) > max_vertices:
            idx = np.linspace(0, len(ring) - 1, max_vertices).round().astype(int)
            ring = ring[idx]
        out[i, : len(ring)] = ring
        out[i, len(ring) :] = ring[-1] if len(ring) else 0.0
    return out


def constant_velocity_forecast(
    boxes: np.ndarray,            # (O, 5): x, y, heading, length, width (current frame, global)
    velocities: np.ndarray,       # (O, 2): global-frame vx, vy
    is_dynamic: np.ndarray,       # (O,) bool — propagate only dynamic agents
    valid: np.ndarray,            # (O,) bool
    trajectory_sampling: TrajectorySampling,
    observation_samples: int,
    sample_res: int = 2,
) -> tuple:
    """Constant-velocity occupancy forecast (`pdm_observation.py:166-189`).

    Static objects stay frozen; dynamic agents translate by v * t (heading
    fixed). One local map per `sample_res` samples, each representing time
    (local_idx * sample_res * interval).
    :return: (poses (L, O, 3), global_to_local); pair with boxes[:, 3:5] as
             the TrackArrays extents.
    """
    interval = trajectory_sampling.interval_length
    num_local = observation_samples // sample_res + 1
    global_to_local = np.array(
        [idx // sample_res for idx in range(observation_samples + sample_res)], dtype=np.int32
    )

    times = np.arange(num_local, dtype=np.float64) * sample_res * interval      # (L,)
    vel_eff = np.where(is_dynamic[:, None] & valid[:, None], velocities, 0.0)   # (O, 2)
    poses = np.zeros((num_local, boxes.shape[0], 3), np.float32)
    poses[..., :2] = boxes[None, :, :2] + vel_eff[None] * times[:, None, None]
    poses[..., 2] = boxes[None, :, 2]
    poses[:, ~valid, :2] = 1e6  # far sentinel for padded slots
    return poses, global_to_local
