"""PDM closed-loop scorer, fully vectorized over scenes and proposals
(counterpart of `diffusiondrive_tpu/evaluate/scorer.py`).

Parity: `pdm_planner/scoring/pdm_scorer.py` (PDMScorer/PDMScorerConfig) and
`pdm_scorer_utils.py:get_collision_type`. Re-implements nuPlan's closed-loop
metric suite on simulated proposal states:

multiplicative: no-at-fault-collision, drivable-area, (driving-direction is
weighted with weight 0); weighted: progress (5), TTC (5), comfort (2).

The reference walks timesteps sequentially, mutating per-proposal "already
collided" token lists. The decision structure is equivalent to a
per-(proposal, track) first-intersection rule: the classification at the
first intersecting event decides (at-fault -> score penalty; else the token
is ignored forever), so collision and TTC become dense boolean tensors over
(proposal, time, object) reduced with argmax/min.

JAX scores one scene per `vmap` lane; here every tensor carries an explicit
leading scene dim S, and every reduction that JAX makes over one scene's
proposals (the progress normalisation's max) is made per scene. No step
reads a value back to the host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from diffusiondrive_torch.common.dataclasses import TrajectorySampling
from diffusiondrive_torch.common.enums import BBCoordsIndex, MapLayer, StateIndex, WeightedMetricIndex
from diffusiondrive_torch.common.geometry import normalize_angle
from diffusiondrive_torch.evaluate.comfort import ego_is_comfortable
from diffusiondrive_torch.evaluate.geometry import (
    points_in_polygons,
    polygons_intersect,
    project_onto_polyline,
    segment_intersects_polygon,
)
from diffusiondrive_torch.evaluate.state_array import (
    VehicleParameters,
    box_to_corners,
    coords_to_exterior,
    get_pacifica_parameters,
    state_array_to_coords_array,
)

STOPPED_TRACK_SPEED = 5e-2   # [m/s] for collision typing
AHEAD_ANGLE_DEG = 30.0       # is_agent_ahead tolerance
BEHIND_ANGLE_DEG = 150.0     # is_agent_behind tolerance
TTC_FUTURE_STEPS = np.arange(0, 10, 3)   # [0, 3, 6, 9]


@dataclasses.dataclass(frozen=True)
class PDMScorerConfig:
    progress_weight: float = 5.0
    ttc_weight: float = 5.0
    comfortable_weight: float = 2.0
    driving_direction_weight: float = 0.0

    driving_direction_horizon: float = 1.0          # [s]
    driving_direction_compliance_threshold: float = 2.0  # [m]
    driving_direction_violation_threshold: float = 6.0   # [m]
    stopped_speed_threshold: float = 5e-3           # [m/s] (ttc)
    progress_distance_threshold: float = 5.0        # [m]

    # Sequential chunk over the object dim for the dense collision/TTC
    # edge-pair tensors: one chunk of O is live at a time. None disables
    # chunking.
    object_chunk: int = 16


class ScorerOutput(NamedTuple):
    """Per-proposal final score and sub-metrics (all shape (S, B), float)."""

    score: torch.Tensor
    no_at_fault_collisions: torch.Tensor
    drivable_area_compliance: torch.Tensor
    driving_direction_compliance: torch.Tensor
    progress_normalized: torch.Tensor
    progress_raw: torch.Tensor
    ttc: torch.Tensor
    comfort: torch.Tensor
    collision_time_idcs: torch.Tensor
    ttc_time_idcs: torch.Tensor


def _bearing(ego_pose: torch.Tensor, target_xy: torch.Tensor) -> torch.Tensor:
    return normalize_angle(
        torch.atan2(target_xy[..., 1] - ego_pose[..., 1], target_xy[..., 0] - ego_pose[..., 0])
        - ego_pose[..., 2],
        xp=torch,
    )


def _is_ahead(ego_pose: torch.Tensor, target_xy: torch.Tensor) -> torch.Tensor:
    """nuplan `is_agent_ahead`: target within +-30 deg of ego heading."""
    return _bearing(ego_pose, target_xy).abs() < np.deg2rad(AHEAD_ANGLE_DEG)


def _is_behind(ego_pose: torch.Tensor, target_xy: torch.Tensor) -> torch.Tensor:
    """nuplan `is_agent_behind`: target beyond +-150 deg of ego heading."""
    return _bearing(ego_pose, target_xy).abs() > np.deg2rad(BEHIND_ANGLE_DEG)


def _intersect_over_object_chunks(ego_rings: torch.Tensor, polys: torch.Tensor,
                                  chunk: int) -> torch.Tensor:
    """`polygons_intersect` of every ego ring with every track ring of its
    scene and time, the object dim O taken in sequential chunks of `chunk`
    (padded by repeating the last polygon) so the live edge-pair
    intermediates hold one chunk of O; one pass when O <= chunk.

    :param ego_rings: (S, B, T[, K], 5, 2) ego rings
    :param polys: (S, T[, K], O, V, 2) track rings
    :return: bool (S, B, T[, K], O)
    """
    O = polys.shape[-3]
    ego = ego_rings[..., None, :, :]                  # (S, B, T[,K], 1, 5, 2)
    if not chunk or O <= chunk:
        return polygons_intersect(ego, polys[:, None])
    n_chunks = -(-O // chunk)
    pad = n_chunks * chunk - O
    if pad:
        polys = torch.cat([polys, polys[..., -1:, :, :].expand(*polys.shape[:-3], pad, *polys.shape[-2:])],
                          dim=-3)
    hits = [polygons_intersect(ego, polys[:, None, ..., c * chunk:(c + 1) * chunk, :, :])
            for c in range(n_chunks)]
    return torch.cat(hits, dim=-1)[..., :O]


@functools.lru_cache(maxsize=None)
def _index_tables(T: int, horizon: int, device: torch.device):
    """Index tensors of the scorer on `device`, copied once: the TTC lookup
    (T, K) = t + future step; the driving-direction window bounds (T,)."""
    fut_idx = np.arange(T)[:, None] + TTC_FUTURE_STEPS[None, :]
    idx_hi = np.arange(T) + 1
    idx_lo = np.maximum(0, np.arange(T) - horizon)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device) for a in (fut_idx, idx_hi, idx_lo))


@functools.lru_cache(maxsize=None)
def _layer_sets(dtype: torch.dtype, device: torch.device):
    """(DRIVABLE_LANES, DRIVABLE) layer ids in `dtype` on `device`, copied once."""
    return tuple(torch.tensor(ids, dtype=dtype).to(device) for ids in (MapLayer.DRIVABLE_LANES, MapLayer.DRIVABLE))


@functools.lru_cache(maxsize=None)
def _float_tables(config: PDMScorerConfig, dtype: torch.dtype, device: torch.device):
    """(TTC future steps as floats (K,), metric weights in `WeightedMetricIndex`
    order (4,)) on `device`, copied once."""
    weights = np.zeros(WeightedMetricIndex.size(), np.float32)
    weights[WeightedMetricIndex.PROGRESS] = config.progress_weight
    weights[WeightedMetricIndex.TTC] = config.ttc_weight
    weights[WeightedMetricIndex.COMFORTABLE] = config.comfortable_weight
    weights[WeightedMetricIndex.DRIVING_DIRECTION] = config.driving_direction_weight
    return (torch.from_numpy(TTC_FUTURE_STEPS).to(dtype).to(device), torch.from_numpy(weights).to(device))


def _take_time(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (S, B, T, ...) at per-(S, B, O) times idx -> (S, B, O, ...)."""
    index = idx.reshape(*idx.shape, *(1,) * (arr.ndim - 3)).expand(*idx.shape, *arr.shape[3:])
    return arr.gather(2, index)


def score_proposals(
    states: torch.Tensor,            # (S, B, T, 11) simulated proposal states
    track_poses: torch.Tensor,       # (S, L, O, 3) occupancy forecast box poses
    track_extents: torch.Tensor,     # (S, O, 2) box (length, width)
    track_valid: torch.Tensor,       # (S, O)
    track_is_agent: torch.Tensor,    # (S, O)
    track_is_red_light: torch.Tensor,   # (S, O)
    track_is_stopped: torch.Tensor,  # (S, O)
    track_previously_collided: torch.Tensor,  # (S, O)
    global_to_local: torch.Tensor,   # (S, >= T + 9) int
    map_polygons: torch.Tensor,      # (S, P, V, 2)
    map_valid: torch.Tensor,         # (S, P)
    map_layers: torch.Tensor,        # (S, P)
    map_on_route: torch.Tensor,      # (S, P)
    centerline: torch.Tensor,        # (S, Lc, 2)
    proposal_sampling: TrajectorySampling,
    config: PDMScorerConfig = PDMScorerConfig(),
    vehicle: VehicleParameters = None,
) -> ScorerOutput:
    vehicle = vehicle or get_pacifica_parameters()
    S, B, T, _ = states.shape
    dev, dtype = states.device, states.dtype
    interval = proposal_sampling.interval_length
    horizon = int(config.driving_direction_horizon / interval)
    fut_idx, idx_hi, idx_lo = _index_tables(T, horizon, dev)
    future_steps, weights = _float_tables(config, dtype, dev)
    lane_layers, drivable_layers = _layer_sets(map_layers.dtype, dev)
    scenes = torch.arange(S, device=dev)
    objects = torch.arange(track_poses.shape[2], device=dev)

    ego_coords = state_array_to_coords_array(states, vehicle, xp=torch)   # (S, B, T, 5, 2)
    ego_rings = coords_to_exterior(ego_coords, xp=torch)                  # (S, B, T, 5, 2) closed ring

    # ------------------------------------------------------------------ #
    # Ego areas (`_calculate_ego_area`)
    # ------------------------------------------------------------------ #
    maps = map_polygons[:, None, None, None]                              # (S, 1, 1, 1, P, V, 2)
    in_poly = points_in_polygons(ego_coords, maps) & map_valid[:, None, None, None]  # (S, B, T, 5, P)
    corners_in = in_poly[..., : BBCoordsIndex.CENTER, :]                 # (S, B, T, 4, P)
    center_in = in_poly[..., BBCoordsIndex.CENTER, :]                    # (S, B, T, P)

    lane_mask = (torch.isin(map_layers, lane_layers) & map_valid)[:, None, None]      # (S, 1, 1, P)
    drivable_mask = (torch.isin(map_layers, drivable_layers) & map_valid)[:, None, None, None]
    on_route_lane_mask = lane_mask & map_on_route[:, None, None]

    corners_per_lane = torch.where(lane_mask, corners_in.sum(-2), 0)     # (S, B, T, P)
    multiple_lanes = ((corners_per_lane > 0).sum(-1) > 1) & (
        torch.where(lane_mask, corners_per_lane, -1) != 4).all(-1)
    corner_in_any_drivable = (corners_in & drivable_mask).any(-1)        # (S, B, T, 4)
    non_drivable = corner_in_any_drivable.sum(-1) < 4
    oncoming = (center_in & on_route_lane_mask).sum(-1) == 0

    multi_or_nondrivable = multiple_lanes | non_drivable                 # (S, B, T)

    # ------------------------------------------------------------------ #
    # No-at-fault collision (`_calculate_no_at_fault_collision`)
    # ------------------------------------------------------------------ #
    def expand_corners(poses, extents):
        """poses (..., O, 3) + extents (..., O, 2) -> rings (..., O, 4, 2)."""
        return box_to_corners(poses[..., 0], poses[..., 1], poses[..., 2],
                              extents[..., 0], extents[..., 1], xp=torch)

    g2l = global_to_local[:, :T].long()                                  # (S, T)
    poses_t = track_poses[scenes[:, None], g2l]                          # (S, T, O, 3)
    polys_t = expand_corners(poses_t, track_extents[:, None])            # (S, T, O, 4, 2)

    per_object = (slice(None), None, None)                               # (S, O) -> (S, 1, 1, O)
    collides = _intersect_over_object_chunks(ego_rings, polys_t, config.object_chunk) \
        & track_valid[per_object]                                        # (S, B, T, O)

    eligible = track_valid & ~track_is_red_light & ~track_previously_collided    # (S, O)
    collides_eligible = collides & eligible[per_object]

    any_collision = collides_eligible.any(2)                             # (S, B, O)
    first_t = collides_eligible.to(torch.uint8).argmax(2)                # (S, B, O), the first True

    speeds = torch.hypot(states[..., StateIndex.VELOCITY_X], states[..., StateIndex.VELOCITY_Y])  # (S, B, T)
    ego_pose_first = _take_time(states[..., StateIndex.STATE_SE2], first_t)       # (S, B, O, 3)
    ego_ring_first = _take_time(ego_rings, first_t)                               # (S, B, O, 5, 2)
    ego_speed_first = speeds.gather(2, first_t)                                   # (S, B, O)
    multi_nd_first = multi_or_nondrivable.gather(2, first_t)                      # (S, B, O)

    # polygon of track o at its first collision time: gather the compact pose then expand
    track_pose_first = poses_t[scenes[:, None, None], first_t, objects]           # (S, B, O, 3)
    track_poly_first = expand_corners(track_pose_first, track_extents[:, None])   # (S, B, O, 4, 2)
    track_center_first = track_pose_first[..., :2]

    per_proposal = (slice(None), None)                                   # (S, O) -> (S, 1, O)
    is_ego_stopped = ego_speed_first <= STOPPED_TRACK_SPEED
    behind = _is_behind(ego_pose_first, track_center_first)
    front_seg_hit = segment_intersects_polygon(
        ego_ring_first[..., BBCoordsIndex.FRONT_LEFT, :],
        ego_ring_first[..., BBCoordsIndex.FRONT_RIGHT, :],
        track_poly_first,
    )

    # collision typing precedence (`pdm_scorer_utils.py:13-68`)
    track_stopped = track_is_stopped[per_proposal]
    stopped_track = ~is_ego_stopped & track_stopped
    active_front = ~is_ego_stopped & ~track_stopped & ~behind & front_seg_hit
    active_lateral = ~is_ego_stopped & ~track_stopped & ~behind & ~front_seg_hit

    at_fault = (stopped_track | active_front | (multi_nd_first & active_lateral)) & any_collision
    contribution = torch.where(at_fault, torch.where(track_is_agent[per_proposal], 0.0, 0.5), 1.0).to(dtype)
    no_collision_score = contribution.min(-1).values                     # (S, B)

    collision_time_idcs = torch.where(at_fault, first_t.to(dtype), torch.inf).min(-1).values

    # ------------------------------------------------------------------ #
    # Drivable-area compliance + driving direction
    # ------------------------------------------------------------------ #
    ones = torch.ones((), dtype=dtype, device=dev)
    drivable_score = torch.where(non_drivable.any(-1), 0.0, ones)

    centers = ego_coords[..., BBCoordsIndex.CENTER, :]                   # (S, B, T, 2)
    step_progress = torch.cat(
        [torch.zeros_like(centers[:, :, :1, 0]), torch.linalg.vector_norm(centers.diff(dim=2), dim=-1)], dim=2)
    oncoming_progress = torch.where(oncoming, step_progress, 0.0)
    # windowed sum over [t-horizon, t]
    cums = torch.cat([torch.zeros_like(oncoming_progress[..., :1]), oncoming_progress.cumsum(2)], dim=2)
    windowed = cums[..., idx_hi] - cums[..., idx_lo]
    max_oncoming = windowed.max(-1).values
    dd_score = torch.where(
        max_oncoming < config.driving_direction_compliance_threshold,
        1.0,
        torch.where(max_oncoming < config.driving_direction_violation_threshold, 0.5, 0.0),
    ).to(dtype)

    # ------------------------------------------------------------------ #
    # Progress along centerline (`_calculate_progress`)
    # ------------------------------------------------------------------ #
    start_arc = project_onto_polyline(centers[:, :, 0], centerline[:, None])
    end_arc = project_onto_polyline(centers[:, :, -1], centerline[:, None])
    progress_raw = (end_arc - start_arc).clamp(min=0.0)

    # ------------------------------------------------------------------ #
    # TTC (`_calculate_ttc`)
    # ------------------------------------------------------------------ #
    K = len(TTC_FUTURE_STEPS)
    heading = states[..., StateIndex.HEADING]
    dxy = torch.stack([heading.cos() * speeds, heading.sin() * speeds], dim=-1)          # (S, B, T, 2)
    deltas = future_steps * interval                                                     # (K,)
    ttc_rings = ego_rings[:, :, :, None] + dxy[:, :, :, None, None, :] * deltas[:, None, None]  # (S, B, T, K, 5, 2)

    # observation at t + future_step (extended horizon)
    g2l_fut = global_to_local[:, fut_idx].long()                         # (S, T, K)
    poses_fut = track_poses[scenes[:, None, None], g2l_fut]              # (S, T, K, O, 3)
    polys_fut = expand_corners(poses_fut, track_extents[:, None, None])  # (S, T, K, O, 4, 2)
    centers_fut = poses_fut[..., :2]                                     # (S, T, K, O, 2)

    per_event = (slice(None), None, None, None)                          # (S, O) -> (S, 1, 1, 1, O)
    ttc_hits = _intersect_over_object_chunks(ttc_rings, polys_fut, config.object_chunk) \
        & track_valid[per_event]                                         # (S, B, T, K, O)
    moving = speeds >= config.stopped_speed_threshold                    # (S, B, T)
    ttc_events = ttc_hits & eligible[per_event] & moving[..., None, None]

    flat_events = ttc_events.permute(0, 1, 4, 2, 3).reshape(S, B, -1, T * K)     # (S, B, O, T*K)
    any_event = flat_events.any(-1)
    first_event = flat_events.to(torch.uint8).argmax(-1)                 # (S, B, O) in t*K+k order
    ev_t = first_event // K
    ev_k = first_event % K

    ego_pose_ev = _take_time(states[..., StateIndex.STATE_SE2], ev_t)    # (S, B, O, 3)
    multi_nd_ev = multi_or_nondrivable.gather(2, ev_t)

    intersection_mask = (map_layers == MapLayer.INTERSECTION) & map_valid          # (S, P)
    rear_in_intersection = (points_in_polygons(states[..., StateIndex.POINT], map_polygons[:, None, None])
                            & intersection_mask[:, None, None]).any(-1)          # (S, B, T)
    rear_in_int_ev = rear_in_intersection.gather(2, ev_t)

    # track centroid at the event's projected time
    track_center_ev = centers_fut[scenes[:, None, None], ev_t, ev_k, objects]    # (S, B, O, 2)

    ahead_ev = _is_ahead(ego_pose_ev, track_center_ev)
    behind_ev = _is_behind(ego_pose_ev, track_center_ev)
    ttc_fault = (ahead_ev | ((multi_nd_ev | rear_in_int_ev) & ~behind_ev)) & any_event

    ttc_score = torch.where(ttc_fault.any(-1), 0.0, ones)
    ttc_time_idcs = torch.where(ttc_fault, ev_t.to(dtype), torch.inf).min(-1).values

    # ------------------------------------------------------------------ #
    # Comfort + aggregation (`_calculate_is_comfortable`, `_aggregate_scores`)
    # ------------------------------------------------------------------ #
    time_s = np.arange(T) * interval
    comfort_score = ego_is_comfortable(states, time_s).all(-1).to(dtype)

    multiplicative = no_collision_score * drivable_score
    raw_progress = progress_raw * multiplicative
    max_raw = raw_progress.max(-1, keepdim=True).values                  # per scene, as JAX's vmap lane
    normalized_progress = torch.where(
        max_raw > config.progress_distance_threshold,
        raw_progress / max_raw.clamp(min=1e-12),
        torch.where(multiplicative == 0.0, 0.0, ones),
    )

    # weight vector and metric stack both in WeightedMetricIndex order
    metrics = [None] * WeightedMetricIndex.size()
    metrics[WeightedMetricIndex.PROGRESS] = normalized_progress
    metrics[WeightedMetricIndex.TTC] = ttc_score
    metrics[WeightedMetricIndex.COMFORTABLE] = comfort_score
    metrics[WeightedMetricIndex.DRIVING_DIRECTION] = dd_score
    weighted = (weights[:, None, None] * torch.stack(metrics)).sum(0) / weights.sum()

    final = multiplicative * weighted

    return ScorerOutput(
        score=final,
        no_at_fault_collisions=no_collision_score,
        drivable_area_compliance=drivable_score,
        driving_direction_compliance=dd_score,
        progress_normalized=normalized_progress,
        progress_raw=progress_raw,
        ttc=ttc_score,
        comfort=comfort_score,
        collision_time_idcs=collision_time_idcs,
        ttc_time_idcs=ttc_time_idcs,
    )
