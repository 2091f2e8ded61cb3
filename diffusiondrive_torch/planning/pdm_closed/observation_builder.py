"""Builders turning a Scene + LocalMapAPI into array-native scoring context.

Replaces `pdm_observation.py` (CV forecast + red lights; GT-interpolated
tracks) and `pdm_occupancy_map.py:PDMDrivableMap.from_simulation`, plus the
NavSimScenario adapter glue (`navsim_scenario_utils.py`: local->global box /
velocity conversion).

Copy of `diffusiondrive_tpu/planning/pdm_closed/observation_builder.py` (numpy on the host, as there).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from diffusiondrive_torch.common.dataclasses import Scene, TrajectorySampling
from diffusiondrive_torch.common.enums import BoundingBoxIndex, StateIndex
from diffusiondrive_torch.common.geometry import normalize_angle
from diffusiondrive_torch.evaluate.observation import (
    DrivableAreaArrays,
    MapLayer,
    TrackArrays,
    constant_velocity_forecast,
    pad_rings,
)
from diffusiondrive_torch.evaluate.state_array import (
    box_to_corners,
    get_pacifica_parameters,
    state_array_to_coords_array,
)
from diffusiondrive_torch.planning.map_api import LocalMapAPI
from diffusiondrive_torch.planning.pdm_closed.np_geometry import point_in_polygon, polygon_distance

AGENT_NAMES = ("vehicle", "pedestrian", "bicycle")
STOPPED_SPEED = 5e-2
RING_PAD = 16


def ego_state_array_from_scene(scene: Scene) -> np.ndarray:
    """Current-frame 11-field ego state array (global pose, local dynamics)."""
    frame = scene.frames[scene.scene_metadata.num_history_frames - 1]
    status = frame.ego_status
    state = np.zeros(StateIndex.size(), np.float64)
    state[StateIndex.STATE_SE2] = status.ego_pose
    state[StateIndex.VELOCITY_2D] = status.ego_velocity
    state[StateIndex.ACCELERATION_2D] = status.ego_acceleration
    return state


def _boxes_to_global(boxes: np.ndarray, velocities: np.ndarray, ego_pose) -> Tuple[np.ndarray, np.ndarray]:
    """Ego-local annotation boxes/velocities -> global frame
    (`navsim_scenario_utils.py:89-150`)."""
    ox, oy, oh = ego_pose[0], ego_pose[1], ego_pose[2]
    c, s = np.cos(oh), np.sin(oh)
    out = boxes.copy().astype(np.float64)
    gx = boxes[:, BoundingBoxIndex.X] * c - boxes[:, BoundingBoxIndex.Y] * s + ox
    gy = boxes[:, BoundingBoxIndex.X] * s + boxes[:, BoundingBoxIndex.Y] * c + oy
    gh = normalize_angle(boxes[:, BoundingBoxIndex.HEADING] + oh)
    out[:, BoundingBoxIndex.X], out[:, BoundingBoxIndex.Y], out[:, BoundingBoxIndex.HEADING] = gx, gy, gh
    gvx = velocities[:, 0] * c - velocities[:, 1] * s
    gvy = velocities[:, 0] * s + velocities[:, 1] * c
    return out, np.stack([gvx, gvy], axis=-1)


def _red_light_polygons(
    scene: Scene, route_lane_tokens: Sequence[str], map_api: Optional[LocalMapAPI]
) -> List[np.ndarray]:
    """Red-light lane-connector polygons on route
    (`pdm_observation.py:283-304`)."""
    if map_api is None:
        return []
    frame = scene.frames[scene.scene_metadata.num_history_frames - 1]
    polygons = []
    route = set(route_lane_tokens)
    for lane_connector_id, is_red in frame.traffic_lights:
        token = str(lane_connector_id)
        if is_red and token in route:
            obj = map_api.get_map_object(token)
            if obj is not None:
                polygons.append(np.asarray(obj.polygon, np.float64))
    return polygons


def build_planner_observation(
    scene: Scene,
    route_lane_tokens: Sequence[str],
    map_api: Optional[LocalMapAPI],
    proposal_sampling: TrajectorySampling,
    trajectory_sampling: TrajectorySampling,
    map_radius: float = 100.0,
    sample_res: int = 2,
    max_objects: int = 96,
) -> TrackArrays:
    """Constant-velocity forecast observation used while planning
    (`pdm_observation.py:105-205`)."""
    interval = proposal_sampling.interval_length
    samples = max(
        proposal_sampling.num_poses + int(1 / interval), trajectory_sampling.num_poses
    )
    num_local = samples // sample_res + 1
    global_to_local = np.array([i // sample_res for i in range(samples + sample_res)], np.int32)

    frame = scene.frames[scene.scene_metadata.num_history_frames - 1]
    ego_pose = frame.ego_status.ego_pose
    boxes_g, vel_g = _boxes_to_global(
        np.asarray(frame.annotations.boxes, np.float64),
        np.asarray(frame.annotations.velocity_3d, np.float64)[:, :2],
        ego_pose,
    )
    names = list(frame.annotations.names)
    tokens = list(frame.annotations.track_tokens)

    # filter by radius, keep NEAREST first (PDMObjectManager collects nearest
    # objects; truncation to max_objects must drop the farthest)
    dist = np.hypot(boxes_g[:, 0] - ego_pose[0], boxes_g[:, 1] - ego_pose[1])
    order = np.argsort(dist)
    order = order[dist[order] <= map_radius]
    boxes_g, vel_g = boxes_g[order], vel_g[order]
    names = [names[i] for i in order]
    tokens = [tokens[i] for i in order]

    red_lights = _red_light_polygons(scene, route_lane_tokens, map_api)

    O = max_objects
    num_tracks = min(len(names), O - len(red_lights))
    poses = np.full((num_local, O, 3), 1e6, np.float32)
    poses[..., 2] = 0.0
    extents = np.ones((O, 2), np.float32)
    valid = np.zeros(O, bool)
    headings = np.zeros(O, np.float32)
    is_agent = np.zeros(O, bool)
    is_red = np.zeros(O, bool)
    is_stopped = np.ones(O, bool)
    rings_override = None

    speeds = np.hypot(vel_g[:, 0], vel_g[:, 1])
    if num_tracks:
        dynamic = np.array([names[o] in AGENT_NAMES for o in range(num_tracks)], bool)
        valid[:num_tracks] = True
        headings[:num_tracks] = boxes_g[:num_tracks, BoundingBoxIndex.HEADING]
        is_agent[:num_tracks] = dynamic
        is_stopped[:num_tracks] = ~dynamic | (speeds[:num_tracks] <= STOPPED_SPEED)
        extents[:num_tracks, 0] = boxes_g[:num_tracks, BoundingBoxIndex.LENGTH]
        extents[:num_tracks, 1] = boxes_g[:num_tracks, BoundingBoxIndex.WIDTH]
        boxes5 = np.full((O, 5), 1e6, np.float64)
        boxes5[:num_tracks] = boxes_g[:num_tracks][:, [BoundingBoxIndex.X, BoundingBoxIndex.Y,
                                                       BoundingBoxIndex.HEADING,
                                                       BoundingBoxIndex.LENGTH,
                                                       BoundingBoxIndex.WIDTH]]
        boxes5[num_tracks:, 2:] = 0.0
        vels = np.zeros((O, 2)); vels[:num_tracks] = vel_g[:num_tracks]
        is_dyn = np.zeros(O, bool); is_dyn[:num_tracks] = dynamic
        poses, _ = constant_velocity_forecast(
            boxes5, vels, is_dyn, valid, proposal_sampling, samples, sample_res
        )

    if red_lights:
        # red-light lane connectors are arbitrary polygons: approximate the
        # (device-masked) box by the ring's bbox, keep exact rings host-side
        rings_override = np.full((num_local, O, RING_PAD, 2), 1e6, np.float32)
        for r, ring in enumerate(red_lights):
            o = num_tracks + r
            if o >= O:
                break
            padded = pad_rings([ring], RING_PAD)[0]
            valid[o] = True
            is_red[o] = True
            is_stopped[o] = True
            lo, hi = ring.min(axis=0), ring.max(axis=0)
            extents[o] = np.maximum(hi - lo, 0.1)
            poses[:, o, :2] = ring.mean(axis=0)
            poses[:, o, 2] = 0.0
            rings_override[:, o] = padded

    # pre-existing collisions at t=0 (`pdm_observation.py:193-204`)
    ego_state = ego_state_array_from_scene(scene)
    ego_ring = state_array_to_coords_array(ego_state[None, None], get_pacifica_parameters())[0, 0, :4]
    previously_collided = np.zeros(O, bool)
    for o in range(O):
        if not valid[o]:
            continue
        if is_red[o]:
            ring = rings_override[0, o]
            if polygon_distance(ego_ring, ring) == 0.0 and point_in_polygon(ego_ring, ring).all():
                # red lights only ignored when ego is fully within
                previously_collided[o] = True
            continue
        ring = box_to_corners(
            poses[0, o, 0], poses[0, o, 1], poses[0, o, 2], extents[o, 0], extents[o, 1]
        )
        if polygon_distance(ego_ring, ring) == 0.0:
            previously_collided[o] = True

    speeds_arr = np.zeros(O, np.float32)
    speeds_arr[:num_tracks] = speeds[:num_tracks]
    return TrackArrays(
        poses=poses, extents=extents, valid=valid, headings=headings,
        is_agent=is_agent, is_red_light=is_red, is_stopped=is_stopped,
        previously_collided=previously_collided, global_to_local=global_to_local,
        speeds=speeds_arr, rings_override=rings_override,
    )


def build_gt_observation(
    scene: Scene,
    proposal_sampling: TrajectorySampling,
    trajectory_sampling: TrajectorySampling,
    max_objects: int = 96,
) -> TrackArrays:
    """GT tracks interpolated from log frames (2 Hz) to 10 Hz — the
    observation stored in the metric cache
    (`metric_cache_processor.py:91-207`, sample_res=1, no red lights)."""
    interval = proposal_sampling.interval_length
    samples = max(proposal_sampling.num_poses + int(1 / interval), trajectory_sampling.num_poses)
    num_local = samples + 1
    global_to_local = np.arange(samples + 1, dtype=np.int32)

    start = scene.scene_metadata.num_history_frames - 1
    frames = scene.frames[start:]
    frame_dt = 0.5  # log interval [s]

    # per-token state trajectories (time, x, y, heading, l, w, is_agent)
    tracks: Dict[str, List] = {}
    meta: Dict[str, Tuple[float, float, bool]] = {}
    for f_idx, frame in enumerate(frames):
        ego_pose = frame.ego_status.ego_pose
        boxes_g, _ = _boxes_to_global(
            np.asarray(frame.annotations.boxes, np.float64),
            np.asarray(frame.annotations.velocity_3d, np.float64)[:, :2],
            ego_pose,
        )
        for b_idx, token in enumerate(frame.annotations.track_tokens):
            entry = (
                f_idx * frame_dt,
                boxes_g[b_idx, BoundingBoxIndex.X],
                boxes_g[b_idx, BoundingBoxIndex.Y],
                boxes_g[b_idx, BoundingBoxIndex.HEADING],
            )
            tracks.setdefault(token, []).append(entry)
            if token not in meta:
                meta[token] = (
                    float(boxes_g[b_idx, BoundingBoxIndex.LENGTH]),
                    float(boxes_g[b_idx, BoundingBoxIndex.WIDTH]),
                    frame.annotations.names[b_idx] in AGENT_NAMES,
                )

    O = max_objects
    # nearest-first truncation (distance to ego at t=0)
    ego0 = frames[0].ego_status.ego_pose
    def _min_dist(token):
        st = tracks[token][0]
        return float(np.hypot(st[1] - ego0[0], st[2] - ego0[1]))
    tokens = sorted(tracks.keys(), key=_min_dist)[:O]
    poses = np.full((num_local, O, 3), 1e6, np.float32)
    poses[..., 2] = 0.0
    extents = np.ones((O, 2), np.float32)
    valid = np.zeros(O, bool)
    headings = np.zeros(O, np.float32)
    is_agent = np.zeros(O, bool)
    is_stopped = np.ones(O, bool)
    speeds_arr = np.zeros(O, np.float32)

    query_times = np.arange(num_local) * interval
    for o, token in enumerate(tokens):
        states = np.asarray(tracks[token], np.float64)
        length, width, dynamic = meta[token]
        t = states[:, 0]
        # objects can appear/disappear; hold the boundary state outside range
        x = np.interp(query_times, t, states[:, 1])
        y = np.interp(query_times, t, states[:, 2])
        h = normalize_angle(np.interp(query_times, t, np.unwrap(states[:, 3])))
        # speed estimate for is_stopped (first segment)
        if len(t) > 1:
            speed = np.hypot(states[1, 1] - states[0, 1], states[1, 2] - states[0, 2]) / frame_dt
        else:
            speed = 0.0
        valid[o] = True
        headings[o] = h[0]
        is_agent[o] = dynamic
        is_stopped[o] = (not dynamic) or speed <= STOPPED_SPEED
        speeds_arr[o] = speed if dynamic else 0.0
        poses[:, o, 0] = x
        poses[:, o, 1] = y
        poses[:, o, 2] = h
        extents[o] = (length, width)

    return TrackArrays(
        poses=poses, extents=extents, valid=valid, headings=headings,
        is_agent=is_agent, is_red_light=np.zeros(O, bool), is_stopped=is_stopped,
        previously_collided=np.zeros(O, bool), global_to_local=global_to_local,
        speeds=speeds_arr,
    )


def build_drivable_area_map(
    map_api: Optional[LocalMapAPI],
    ego_pose,
    route_lane_tokens: Sequence[str],
    map_radius: float = 100.0,
    max_polygons: int = 256,
    ring_pad: int = 48,
) -> DrivableAreaArrays:
    """Drivable map extraction (`pdm_occupancy_map.py:130-223`)."""
    rings: List[np.ndarray] = []
    layers: List[int] = []
    on_route: List[bool] = []
    if map_api is not None:
        route = set(route_lane_tokens)
        query_layers = [MapLayer.ROADBLOCK, MapLayer.ROADBLOCK_CONNECTOR, MapLayer.INTERSECTION,
                        MapLayer.CARPARK_AREA, MapLayer.DRIVABLE_AREA, MapLayer.LANE, MapLayer.LANE_CONNECTOR]
        found = map_api.get_proximal_map_objects((ego_pose[0], ego_pose[1]), map_radius, query_layers)
        for layer, objs in found.items():
            for obj in objs:
                rings.append(np.asarray(obj.polygon, np.float64))
                layers.append(layer)
                on_route.append(obj.token in route)

    P = max(max_polygons, 1)
    polygons = np.full((P, ring_pad, 2), 1e6, np.float32)
    valid = np.zeros(P, bool)
    layer_arr = np.zeros(P, np.int32)
    route_arr = np.zeros(P, bool)
    for i, ring in enumerate(rings[:P]):
        polygons[i] = pad_rings([ring], ring_pad)[0]
        valid[i] = True
        layer_arr[i] = layers[i]
        route_arr[i] = on_route[i]
    return DrivableAreaArrays(polygons=polygons, valid=valid, layers=layer_arr, on_route=route_arr)
