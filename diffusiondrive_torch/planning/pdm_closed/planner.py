"""PDM-Closed rule-based planner (counterpart of
`diffusiondrive_tpu/planning/pdm_closed/planner.py`).

Parity: `pdm_planner/pdm_closed_planner.py`, `abstract_pdm_closed_planner.py`,
`abstract_pdm_planner.py`, and the IDM proposal unrolling of
`proposal/pdm_generator.py`:

route correction -> drivable map -> CV-forecast observation -> Dijkstra
centerline -> 3 lateral paths x 5 IDM policies -> 40-step IDM unroll with
leading-agent search -> LQR/bicycle re-simulation -> closed-loop scoring ->
argmax -> full 50-step trajectory of the winner.

Host/device split: everything up to the proposals is the JAX package's float64
numpy, copied. The 15 proposals are simulated and scored as one S=1 scene by
the same torch programs as agent evaluation (`pdm_score.simulate_and_score`)
on the planner's device: the card unless `device="cpu"` is asked for. Inputs
go up from pinned memory without a sync; the (1, 15) scores come back in one
transfer, the only host sync of a call, and the host takes the first maximum
(`np.argmax`), as JAX does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from diffusiondrive_torch.common.dataclasses import Scene, TrajectorySampling
from diffusiondrive_torch.common.enums import StateIndex
from diffusiondrive_torch.common.geometry import StateSE2, normalize_angle, parallel_discrete_path
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.evaluate.observation import DrivableAreaArrays, TrackArrays
from diffusiondrive_torch.evaluate.pdm_score import pad_polyline, simulate_and_score
from diffusiondrive_torch.evaluate.scorer import PDMScorerConfig
from diffusiondrive_torch.evaluate.simulator import PDMSimulator
from diffusiondrive_torch.evaluate.state_array import get_pacifica_parameters, state_array_to_coords_array
from diffusiondrive_torch.planning.map_api import LocalMapAPI, MapObjectData
from diffusiondrive_torch.planning.pdm_closed.graph_search import Dijkstra
from diffusiondrive_torch.planning.pdm_closed.idm import BatchIDMPolicy, PDMProposalManager
from diffusiondrive_torch.planning.pdm_closed.np_geometry import (
    corridor_intersects_polygon,
    point_in_polygon,
    polygon_distance,
)
from diffusiondrive_torch.planning.pdm_closed.route_correction import route_roadblock_correction
from diffusiondrive_torch.planning.pdm_closed.observation_builder import (
    build_drivable_area_map,
    build_planner_observation,
    ego_state_array_from_scene,
)
from diffusiondrive_torch.planning.pdm_closed.pdm_path import PDMPath

logger = logging.getLogger(__name__)


@dataclass
class PDMClosedConfig:
    trajectory_sampling: TrajectorySampling = field(
        default_factory=lambda: TrajectorySampling(num_poses=50, interval_length=0.1)
    )
    proposal_sampling: TrajectorySampling = field(
        default_factory=lambda: TrajectorySampling(num_poses=40, interval_length=0.1)
    )
    lateral_offsets: Optional[Tuple[float, ...]] = (-1.0, 1.0)
    map_radius: float = 100.0
    leading_agent_update_rate: int = 2


class PDMClosedPlanner:
    """Generates the privileged PDM-Closed reference trajectory for a scene."""

    def __init__(self, config: PDMClosedConfig = None, idm_policies: BatchIDMPolicy = None,
                 device: Optional[Union[str, torch.device]] = None):
        self._cfg = config or PDMClosedConfig()
        self._device = resolve_device(device)
        self._idm_policies = idm_policies or BatchIDMPolicy()
        self._simulator = PDMSimulator(self._cfg.proposal_sampling)
        self._vehicle = get_pacifica_parameters()

        # per-scene state
        self._map_api: Optional[LocalMapAPI] = None
        self._route_roadblock_dict: Dict[str, MapObjectData] = {}
        self._route_lane_dict: Dict[str, MapObjectData] = {}
        self.centerline: Optional[PDMPath] = None
        self.drivable_area_map: Optional[DrivableAreaArrays] = None
        self.observation: Optional[TrackArrays] = None
        self.proposals: Optional[np.ndarray] = None   # (15, 51, 11) float64, this scene's
        self.scores: Optional[np.ndarray] = None      # (15,) float32, their scores

    # ------------------------------------------------------------------ #
    # Route handling (`abstract_pdm_planner.py:48-75`, `route_utils.py`)
    # ------------------------------------------------------------------ #

    def _load_route_dicts(self, route_roadblock_ids: Sequence[str]) -> None:
        route_roadblock_ids = list(dict.fromkeys(route_roadblock_ids))
        self._route_roadblock_dict, self._route_lane_dict = {}, {}
        for rb_id in route_roadblock_ids:
            block = self._map_api.get_map_object(str(rb_id))
            if block is None:
                continue
            self._route_roadblock_dict[block.token] = block
            for lane_token in self._lanes_of_roadblock(block):
                lane = self._map_api.get_map_object(lane_token)
                if lane is not None:
                    self._route_lane_dict[lane.token] = lane

    def _lanes_of_roadblock(self, roadblock: MapObjectData) -> List[str]:
        """Interior lanes of a roadblock (lanes with parent_token == roadblock)."""
        return [lane.token for lane in self._map_api.lanes_of_roadblock(roadblock.token)]

    def _route_roadblock_correction(self, ego_state: np.ndarray) -> None:
        """Full route correction (`route_utils.py:97-216` via
        `route_correction.route_roadblock_correction`), then reload the route
        dicts from the corrected ids (`abstract_pdm_planner.py:64-75`)."""
        if not self._route_roadblock_dict:
            return
        corrected = route_roadblock_correction(ego_state, self._map_api, self._route_roadblock_dict)
        self._load_route_dicts(corrected)

    def _get_starting_lane(self, ego_state: np.ndarray) -> Optional[MapObjectData]:
        """On-route lane containing ego with min heading error, else nearest
        (`abstract_pdm_planner.py:101-162`)."""
        point = ego_state[StateIndex.POINT]
        heading = ego_state[StateIndex.HEADING]
        best, best_err = None, np.inf
        for lane in self._route_lane_dict.values():
            if point_in_polygon(point[None], lane.polygon)[0]:
                if lane.baseline is None:
                    continue
                dists = np.linalg.norm(lane.baseline[:, :2] - point, axis=-1)
                err = abs(normalize_angle(lane.baseline[np.argmin(dists), 2] - heading))
                if err < best_err:
                    best, best_err = lane, err
        if best is not None:
            return best
        # fallback: nearest route lane by polygon distance
        best_dist = np.inf
        for lane in self._route_lane_dict.values():
            d = float(np.linalg.norm(lane.polygon - point, axis=-1).min())
            if d < best_dist:
                best, best_dist = lane, d
        return best

    def _get_discrete_centerline(self, current_lane: MapObjectData, search_depth: int = 30) -> List[StateSE2]:
        """Dijkstra centerline (`abstract_pdm_planner.py:77-99`)."""
        roadblock_ids = list(self._route_roadblock_dict.keys())
        start_idx = roadblock_ids.index(current_lane.parent_token) if current_lane.parent_token in roadblock_ids else 0
        window = roadblock_ids[start_idx : start_idx + search_depth]
        target = window[-1]

        search = Dijkstra(self._map_api, current_lane, list(self._route_lane_dict.keys()))
        route_plan, _ = search.search(target)

        centerline: List[StateSE2] = []
        for lane in route_plan:
            if lane.baseline is not None:
                centerline.extend(StateSE2(*pose) for pose in lane.baseline)
        return centerline

    # ------------------------------------------------------------------ #
    # Proposal generation (`proposal/pdm_generator.py`)
    # ------------------------------------------------------------------ #

    def _generate_proposals(
        self, ego_state: np.ndarray, manager: PDMProposalManager, num_poses: int
    ) -> np.ndarray:
        """IDM unroll of all proposals to `num_poses` steps."""
        cfg = self._cfg
        dt = cfg.proposal_sampling.interval_length
        n_proposals = len(manager)
        obs = self.observation
        g2l = obs.global_to_local

        state_array = np.zeros((n_proposals, num_poses + 1, StateIndex.size()), np.float64)
        idm_states = np.zeros((n_proposals, num_poses + 1, 2), np.float64)  # progress, velocity
        leading = np.zeros((n_proposals, num_poses + 1, 3), np.float64)

        lateral_batches: Dict[int, List[int]] = {}
        for idx in range(n_proposals):
            lateral_batches.setdefault(manager[idx].lateral_idx, []).append(idx)

        corridor_cache: Dict[int, np.ndarray] = {}
        corridor_objects_cache: Dict[Tuple[int, int], List[int]] = {}
        ego_velocity = float(ego_state[StateIndex.VELOCITY_X])

        for lateral_idx, batch in lateral_batches.items():
            path = manager[batch[0]].path
            ego_progress = float(path.project(ego_state[StateIndex.POINT][None])[0])
            idm_states[batch, 0] = (ego_progress, ego_velocity)
            state_array[batch, 0, StateIndex.STATE_SE2] = path.interpolate([ego_progress])[0]

            # driving corridor for this path (cached per lateral index)
            corridor_len = ego_progress + abs(manager.max_target_velocity) * num_poses * dt
            corridor = path.substring(ego_progress, corridor_len)
            corridor_cache[lateral_idx] = corridor

            for time_idx in range(1, num_poses + 1):
                self._update_leading_agents(
                    batch, time_idx, manager, path, corridor, corridor_objects_cache,
                    lateral_idx, state_array, idm_states, leading,
                )
                longitudinal_idcs = [manager[i].longitudinal_idx for i in batch]
                idm_states[batch, time_idx] = manager.longitudinal_policies.propagate(
                    idm_states[batch, time_idx - 1], leading[batch, time_idx], longitudinal_idcs, dt
                )
                state_array[batch, time_idx, StateIndex.STATE_SE2] = path.interpolate(
                    idm_states[batch, time_idx, 0]
                )
        return state_array

    def _update_leading_agents(
        self, batch, time_idx, manager, path, corridor, corridor_objects_cache, lateral_idx,
        state_array, idm_states, leading,
    ) -> None:
        obs = self.observation
        if time_idx % self._cfg.leading_agent_update_rate != 0 and time_idx > 1:
            leading[batch, time_idx] = leading[batch, time_idx - 1]
            return

        local_idx = int(obs.global_to_local[min(time_idx, len(obs.global_to_local) - 1)])
        key = (lateral_idx, local_idx)
        if key not in corridor_objects_cache:
            hits = []
            for o in range(obs.polygons.shape[1]):
                if not obs.valid[o] or obs.previously_collided[o]:
                    continue
                ring = obs.polygons[local_idx, o]
                if corridor_intersects_polygon(corridor, self._vehicle.width / 2, ring):
                    hits.append(o)
            corridor_objects_cache[key] = hits
        hits = corridor_objects_cache[key]

        obj_progress = {
            o: float(path.project(obs.centers[local_idx, o][None])[0]) for o in hits
        }

        path_length = path.length
        path_rear = self._vehicle.length / 2
        for proposal_idx in batch:
            ego_progress = idm_states[proposal_idx, time_idx - 1, 0]
            ahead = {o: p for o, p in obj_progress.items() if p > ego_progress}
            row = np.zeros(3)
            if ahead:
                pose = state_array[proposal_idx, time_idx - 1]
                ego_ring = state_array_to_coords_array(pose[None, None], self._vehicle)[0, 0, :4]
                dists = [polygon_distance(ego_ring, obs.polygons[local_idx, o]) for o in ahead]
                argmin = int(np.argmin(dists))
                nearest = list(ahead.keys())[argmin]
                row[0] = ego_progress + dists[argmin]
                if not obs.is_red_light[nearest] and obs.is_agent[nearest]:
                    # leading agent velocity projected on ego heading
                    # (`pdm_generator.py:316-334`)
                    rel_heading = normalize_angle(obs.headings[nearest] - pose[StateIndex.HEADING])
                    row[1] = obs.speeds[nearest] * np.cos(rel_heading)
            else:
                row[0] = path_length
                row[2] = path_rear
            leading[proposal_idx, time_idx] = row

    # ------------------------------------------------------------------ #
    # Main entry
    # ------------------------------------------------------------------ #

    def compute_planner_trajectory(self, scene: Scene, map_api: Optional[LocalMapAPI] = None):
        """Plan for the scene's current frame.

        :return: (poses (T+1, 3) global at 10 Hz incl. t=0, times (T+1,) [s])
        """
        cfg = self._cfg
        self._map_api = map_api if map_api is not None else scene.map_api
        ego_state = ego_state_array_from_scene(scene)
        frame = scene.frames[scene.scene_metadata.num_history_frames - 1]

        if self._map_api is None:
            # No map: constant-velocity fallback keeps the pipeline total.
            logger.warning("PDMClosedPlanner: no map API; constant-velocity fallback.")
            return self._constant_velocity_fallback(ego_state)

        self._load_route_dicts([str(r) for r in frame.roadblock_ids])
        self._route_roadblock_correction(ego_state)

        self.drivable_area_map = build_drivable_area_map(
            self._map_api, ego_state, list(self._route_lane_dict.keys()), cfg.map_radius
        )
        self.observation = build_planner_observation(
            scene, list(self._route_lane_dict.keys()), self._map_api,
            cfg.proposal_sampling, cfg.trajectory_sampling, cfg.map_radius,
        )

        current_lane = self._get_starting_lane(ego_state)
        if current_lane is None:
            logger.warning("PDMClosedPlanner: no starting lane; constant-velocity fallback.")
            return self._constant_velocity_fallback(ego_state)

        centerline_path = self._get_discrete_centerline(current_lane)
        self.centerline = PDMPath(centerline_path)

        proposal_paths = [self.centerline]
        if cfg.lateral_offsets:
            for offset in cfg.lateral_offsets:
                proposal_paths.append(PDMPath(parallel_discrete_path(centerline_path, offset)))

        manager = PDMProposalManager(proposal_paths, self._idm_policies)
        manager.update(current_lane.speed_limit)

        proposals = self._generate_proposals(ego_state, manager, cfg.trajectory_sampling.num_poses)
        self.proposals = proposals
        self.scores = self._score_proposals(proposals, ego_state)
        best = int(np.argmax(self.scores))

        poses = proposals[best, :, StateIndex.STATE_SE2]
        times = np.arange(cfg.trajectory_sampling.num_poses + 1) * cfg.trajectory_sampling.interval_length
        return poses, times

    def scorer_inputs(self, proposals: np.ndarray, ego_state: np.ndarray) -> List[np.ndarray]:
        """The host arrays of one S=1 scene in `simulate_and_score`'s order
        and dtypes, as `pdm_score.stack_scenes` gives them for a batch:
        proposals (1, 15, 41, 11) and the ego state (1, 11) in float32, the
        observation and drivable-map arrays with a leading 1, and the
        centerline padded by `pad_polyline` as the JAX planner pads it."""
        obs, dam = self.observation, self.drivable_area_map
        centerline = pad_polyline(np.asarray(self.centerline.coords, np.float32))
        return [
            proposals[None, :, : self._cfg.proposal_sampling.num_poses + 1].astype(np.float32),
            ego_state[None].astype(np.float32),
            obs.poses[None], obs.extents[None], obs.valid[None], obs.is_agent[None],
            obs.is_red_light[None], obs.is_stopped[None], obs.previously_collided[None],
            obs.global_to_local[None],
            dam.polygons[None], dam.valid[None], dam.layers[None], dam.on_route[None],
            centerline[None],
        ]

    def _score_proposals(self, proposals: np.ndarray, ego_state: np.ndarray) -> np.ndarray:
        """(15,) float32 scores of the proposals, simulated and scored on the
        planner's device; one host sync (the result's transfer)."""
        pinned = self._device.type == "cuda"
        tensors = []
        for a in self.scorer_inputs(proposals, ego_state):
            t = torch.from_numpy(np.ascontiguousarray(a))
            tensors.append(t.pin_memory().to(self._device, non_blocking=True) if pinned else t.to(self._device))
        with torch.no_grad():
            out = simulate_and_score(self._simulator, PDMScorerConfig(), *tensors)
        return out.score[0].cpu().numpy()

    def _constant_velocity_fallback(self, ego_state: np.ndarray):
        cfg = self._cfg
        n = cfg.trajectory_sampling.num_poses
        dt = cfg.trajectory_sampling.interval_length
        times = np.arange(n + 1) * dt
        v = ego_state[StateIndex.VELOCITY_X]
        heading = ego_state[StateIndex.HEADING]
        poses = np.zeros((n + 1, 3))
        poses[:, 0] = ego_state[StateIndex.X] + v * times * np.cos(heading)
        poses[:, 1] = ego_state[StateIndex.Y] + v * times * np.sin(heading)
        poses[:, 2] = heading
        return poses, times
