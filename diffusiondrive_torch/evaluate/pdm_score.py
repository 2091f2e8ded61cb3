"""PDM-Score orchestration: trajectory transform + simulate + score
(counterpart of `diffusiondrive_tpu/evaluate/pdm_score.py`, one device).

Parity: `navsim/evaluate/pdm_score.py` — an agent trajectory (8 ego-frame
poses at 0.5 s) is moved to the global frame, interpolated to 41 states at
10 Hz alongside the cached PDM-Closed trajectory, both are re-simulated
through the LQR-tracked bicycle model, and the closed-loop metric suite is
scored; sub-scores are reported for the prediction.

Per scene the proposal dim is 2 (pdm, pred). `batched_pdm_score` stacks S
scenes into (S, 2, 41, 11) + stacked context arrays on the host (float64
interpolation, cast to float32 there), copies them to the device, runs the
simulator and the scorer over the whole batch, and brings the results back
as one stacked transfer. The device is the card unless `device="cpu"` is
asked for (`device.resolve_device`). With `mesh`, a list of devices (the
JAX package's mesh), the scenes are padded to a multiple of its length by
repeating the last one, each device simulates and scores its rows, each
sends its results back in one transfer, and the padded rows are dropped.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from diffusiondrive_torch.common.dataclasses import PDMResults, Trajectory, TrajectorySampling
from diffusiondrive_torch.common.enums import StateIndex
from diffusiondrive_torch.common.geometry import (
    convert_relative_to_absolute_se2_array,
    normalize_angle,
)
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.evaluate.metric_cache import MetricCache
from diffusiondrive_torch.evaluate.scorer import PDMScorerConfig, ScorerOutput, score_proposals
from diffusiondrive_torch.evaluate.simulator import PDMSimulator
from diffusiondrive_torch.parallel.mesh import device_scope, pad_to_multiple


def interpolate_poses(poses: np.ndarray, times: np.ndarray, query_times: np.ndarray) -> np.ndarray:
    """Linear pose interpolation with unwrapped headings.

    :param poses: (M, 3) poses at `times`
    :param query_times: (Q,) times to sample (clipped to the pose range)
    :return: (Q, 3)
    """
    q = np.clip(query_times, times[0], times[-1])
    x = np.interp(q, times, poses[:, 0])
    y = np.interp(q, times, poses[:, 1])
    h = np.interp(q, times, np.unwrap(poses[:, 2]))
    return np.stack([x, y, normalize_angle(h)], axis=-1)


def transform_trajectory_to_states(
    model_trajectory: Trajectory,
    initial_state: np.ndarray,
    simulation_sampling: TrajectorySampling,
) -> np.ndarray:
    """Ego-frame trajectory -> (N+1, 11) global state array at 10 Hz.

    Mirrors `transform_trajectory` + `get_trajectory_as_array`: the current
    ego state is prepended at t=0; velocities/accelerations are left zero for
    future poses (the LQR profile fit only consumes poses).
    """
    sampling = model_trajectory.trajectory_sampling
    rel_times = np.arange(1, sampling.num_poses + 1) * sampling.interval_length
    abs_poses = convert_relative_to_absolute_se2_array(
        initial_state[StateIndex.STATE_SE2], np.asarray(model_trajectory.poses, dtype=np.float64)
    )
    all_poses = np.concatenate([initial_state[None, StateIndex.STATE_SE2], abs_poses], axis=0)
    all_times = np.concatenate([[0.0], rel_times])

    query = np.arange(simulation_sampling.num_poses + 1) * simulation_sampling.interval_length
    poses_10hz = interpolate_poses(all_poses, all_times, query)

    states = np.zeros((len(query), StateIndex.size()), dtype=np.float64)
    states[:, StateIndex.STATE_SE2] = poses_10hz
    states[0] = initial_state
    return states


def pdm_states_from_cache(metric_cache: MetricCache, simulation_sampling: TrajectorySampling) -> np.ndarray:
    """Cached PDM-Closed trajectory -> (N+1, 11) state array at 10 Hz."""
    query = np.arange(simulation_sampling.num_poses + 1) * simulation_sampling.interval_length
    poses = interpolate_poses(metric_cache.pdm_poses, metric_cache.pdm_times, query)
    states = np.zeros((len(query), StateIndex.size()), dtype=np.float64)
    states[:, StateIndex.STATE_SE2] = poses
    states[0] = metric_cache.initial_state
    return states


def pad_polyline(coords: np.ndarray, multiple: int = 256) -> np.ndarray:
    """Pad a polyline to the next length bucket by repeating its last vertex.

    Centerline length varies per scene (graph-search route length); scenes
    stack only at one length. Repeated-vertex padding is exact for the
    scorer: the padded zero-length segments add nothing to the arc-length
    table and can never win the nearest-segment argmin
    (`geometry.project_onto_polyline`).
    """
    L = len(coords)
    target = max(multiple, -(-L // multiple) * multiple)
    if target == L:
        return coords
    return np.concatenate([coords, np.repeat(coords[-1:], target - L, axis=0)], axis=0)


def stack_scenes(
    metric_caches: List[MetricCache],
    model_trajectories: List[Trajectory],
    sampling: TrajectorySampling,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Host side of a batch: (proposals (S, 2, N+1, 11) float32 — PDM-Closed
    then the model's — and the stacked context: initial states (S, 11)
    float32, the track, map and centerline arrays in `score_proposals`'
    order). All caches must share padded shapes (they do when produced by
    the same caching pipeline config); centerlines are bucket-padded to a
    common length."""
    cl_bucket = max(256, -(-max(len(c.centerline) for c in metric_caches) // 256) * 256)
    proposals, ctx = [], []
    for cache, traj in zip(metric_caches, model_trajectories):
        pdm_states = pdm_states_from_cache(cache, sampling)
        pred_states = transform_trajectory_to_states(traj, cache.initial_state, sampling)
        proposals.append(np.stack([pdm_states, pred_states]).astype(np.float32))
        t = cache.tracks
        d = cache.drivable
        ctx.append(
            (
                cache.initial_state.astype(np.float32),
                t.poses, t.extents, t.valid, t.is_agent, t.is_red_light, t.is_stopped,
                t.previously_collided, t.global_to_local,
                d.polygons, d.valid, d.layers, d.on_route,
                pad_polyline(cache.centerline.astype(np.float32), cl_bucket),
            )
        )
    return np.stack(proposals), [np.stack(x) for x in zip(*ctx)]


def scenes_to_device(proposals: np.ndarray, ctx: List[np.ndarray], device: torch.device
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The stacked host arrays of `stack_scenes` as tensors on `device`."""
    return (torch.from_numpy(proposals).to(device),
            [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in ctx])


def simulate_and_score(simulator: PDMSimulator, scorer_config: PDMScorerConfig,
                       proposals: torch.Tensor, initial_states: torch.Tensor, *ctx: torch.Tensor) -> ScorerOutput:
    """(S, 2, N+1, 11) proposals and their scenes' context on one device ->
    `ScorerOutput` of (S, 2) tensors there; no host sync."""
    simulated = simulator.simulate_proposals(proposals, initial_states[:, None])
    return score_proposals(simulated, *ctx, simulator.proposal_sampling, scorer_config)


def simulate_and_score_on(mesh: Sequence[torch.device], simulator: PDMSimulator,
                          scorer_config: PDMScorerConfig, proposals: np.ndarray,
                          ctx: List[np.ndarray]) -> ScorerOutput:
    """The stacked host arrays of S scenes simulated and scored over a list
    of devices: padded to a multiple of its length with the last scene,
    rows ``[i * S' / W, (i + 1) * S' / W)`` on device i (all launched
    before any result is read), one transfer back a device, the padding
    dropped. Returns numpy (S, 2) arrays."""
    num_real = len(proposals)
    proposals, _ = pad_to_multiple(proposals, len(mesh))
    ctx = [pad_to_multiple(x, len(mesh))[0] for x in ctx]
    per = len(proposals) // len(mesh)
    with torch.no_grad():
        outs = []
        for i, dev in enumerate(mesh):
            rows = slice(i * per, (i + 1) * per)
            with device_scope(dev):
                p, c = scenes_to_device(proposals[rows], [x[rows] for x in ctx], torch.device(dev))
                out = simulate_and_score(simulator, scorer_config, p, *c)
                outs.append(torch.stack([v.to(torch.float32) for v in out]))
        host = np.concatenate([o.cpu().numpy() for o in outs], axis=1)[:, :num_real]
    return ScorerOutput(*host)


def score_scenes(
    metric_caches: List[MetricCache],
    model_trajectories: List[Trajectory],
    simulator: PDMSimulator,
    scorer_config: PDMScorerConfig = PDMScorerConfig(),
    device: Optional[Union[str, torch.device]] = None,
    mesh: Optional[Sequence[torch.device]] = None,
) -> ScorerOutput:
    """Every sub-score of both proposals of S scenes, as numpy (S, 2) arrays
    (proposal 0 PDM-Closed, 1 the model's), brought to the host as one
    stacked transfer from each device of `mesh` (default: `device` alone)."""
    proposals, ctx = stack_scenes(metric_caches, model_trajectories, simulator.proposal_sampling)
    return simulate_and_score_on(mesh or [resolve_device(device)], simulator, scorer_config, proposals, ctx)


def pdm_score(
    metric_cache: MetricCache,
    model_trajectory: Trajectory,
    simulator: PDMSimulator,
    scorer_config: PDMScorerConfig = PDMScorerConfig(),
    device: Optional[Union[str, torch.device]] = None,
) -> PDMResults:
    """Score a single scene (reference-equivalent entry point)."""
    return batched_pdm_score([metric_cache], [model_trajectory], simulator, scorer_config, device)[0]


def batched_pdm_score(
    metric_caches: List[MetricCache],
    model_trajectories: List[Trajectory],
    simulator: PDMSimulator,
    scorer_config: PDMScorerConfig = PDMScorerConfig(),
    device: Optional[Union[str, torch.device]] = None,
    mesh: Optional[Sequence[torch.device]] = None,
) -> List[PDMResults]:
    """Score S scenes in one batch on `device` (the card unless "cpu"), or
    split over the devices of `mesh` (padded rows dropped)."""
    out = score_scenes(metric_caches, model_trajectories, simulator, scorer_config, device, mesh)
    pred = 1
    return [
        PDMResults(
            no_at_fault_collisions=float(out.no_at_fault_collisions[i, pred]),
            drivable_area_compliance=float(out.drivable_area_compliance[i, pred]),
            ego_progress=float(out.progress_normalized[i, pred]),
            time_to_collision_within_bound=float(out.ttc[i, pred]),
            comfort=float(out.comfort[i, pred]),
            driving_direction_compliance=float(out.driving_direction_compliance[i, pred]),
            score=float(out.score[i, pred]),
        )
        for i in range(len(metric_caches))
    ]
