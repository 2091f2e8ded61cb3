"""Route-roadblock correction for the PDM-Closed planner.

Full port of the reference semantics in
`navsim/planning/simulation/planner/pdm_planner/utils/route_utils.py:15-216`:

1. **Candidate selection** — roadblocks near ego scored per interior lane by
   displacement + heading error against the lane baseline; on-route candidates
   preferred, then qualifying off-route candidates, then any nearby roadblock.
2. **Fix 1 (off-route start)** — backward roadblock BFS from the first route
   block to ego's candidates (prepend), else forward BFS from ego's block into
   the first three route blocks (trim the overlapped prefix, prepend the path).
3. **Fix 2 (route gaps)** — consecutive route blocks that are not graph-linked
   are bridged by forward BFS; intermediate blocks are spliced in.
4. **Fix 3 (loops)** — the route is truncated at the first roadblock-connector
   whose polygon overlaps an earlier connector by more than 1 m^2.

All geometry is host-side numpy (this runs once per scene during metric
caching, never on the device).

Copy of `diffusiondrive_tpu/planning/pdm_closed/route_correction.py` (numpy on the host, as there).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from diffusiondrive_torch.common.enums import StateIndex
from diffusiondrive_torch.common.geometry import normalize_angle
from diffusiondrive_torch.evaluate.observation import MapLayer
from diffusiondrive_torch.planning.map_api import LocalMapAPI, MapObjectData
from diffusiondrive_torch.planning.pdm_closed.graph_search import BreadthFirstSearchRoadBlock
from diffusiondrive_torch.planning.pdm_closed.np_geometry import polygon_intersection_area

_ROADBLOCK_LAYERS = (MapLayer.ROADBLOCK, MapLayer.ROADBLOCK_CONNECTOR)


def get_current_roadblock_candidates(
    ego_state: np.ndarray,
    map_api: LocalMapAPI,
    route_roadblock_dict: Dict[str, MapObjectData],
    heading_error_thresh: float = np.pi / 4,
    displacement_error_thresh: float = 3.0,
) -> Tuple[Optional[MapObjectData], List[MapObjectData]]:
    """Most promising roadblock at ego plus all other candidates.

    Parity: `route_utils.get_current_roadblock_candidates` (`route_utils.py:15-94`).
    Each nearby roadblock is scored by its best interior lane: displacement to
    the nearest baseline pose and the heading error there. Qualifying lanes
    (both errors under threshold) sort the roadblock into on-route vs off-route
    candidate pools; pools are resolved by minimum displacement.
    """
    point = np.asarray(ego_state[StateIndex.POINT], dtype=np.float64)
    heading = float(ego_state[StateIndex.HEADING])

    found = map_api.get_proximal_map_objects(point, 1.0, list(_ROADBLOCK_LAYERS))
    candidates: List[MapObjectData] = [o for layer in _ROADBLOCK_LAYERS for o in found.get(layer, [])]
    if not candidates:
        for layer in _ROADBLOCK_LAYERS:
            token, _ = map_api.get_distance_to_nearest_map_object(point, layer)
            if token is not None:
                candidates.append(map_api.get_map_object(token))
    if not candidates:
        return None, []

    on_route: List[Tuple[float, MapObjectData]] = []
    off_route: List[Tuple[float, MapObjectData]] = []
    any_displacement: List[float] = []

    for roadblock in candidates:
        block_displacement = np.inf
        qualifies = False
        qualify_displacement = np.inf
        for lane in map_api.lanes_of_roadblock(roadblock.token):
            if lane.baseline is None or len(lane.baseline) == 0:
                continue
            dists = np.linalg.norm(lane.baseline[:, :2] - point, axis=-1)
            argmin = int(np.argmin(dists))
            displacement = float(dists[argmin])
            heading_error = abs(float(normalize_angle(lane.baseline[argmin, 2] - heading)))
            block_displacement = min(block_displacement, displacement)
            if heading_error < heading_error_thresh and displacement < displacement_error_thresh:
                qualifies = True
                qualify_displacement = min(qualify_displacement, displacement)
        any_displacement.append(block_displacement)
        if qualifies:
            pool = on_route if roadblock.token in route_roadblock_dict else off_route
            pool.append((qualify_displacement, roadblock))

    if on_route:
        best = min(on_route, key=lambda t: t[0])[1]
        return best, [rb for _, rb in on_route]
    if off_route:
        best = min(off_route, key=lambda t: t[0])[1]
        return best, [rb for _, rb in off_route]
    best_idx = int(np.argmin(any_displacement))
    return candidates[best_idx], candidates


def route_roadblock_correction(
    ego_state: np.ndarray,
    map_api: LocalMapAPI,
    route_roadblock_dict: Dict[str, MapObjectData],
    search_depth_backward: int = 15,
    search_depth_forward: int = 30,
) -> List[str]:
    """Corrected route roadblock id list (`route_utils.py:97-173`)."""
    starting_block, starting_candidates = get_current_roadblock_candidates(
        ego_state, map_api, route_roadblock_dict
    )
    route_ids = list(route_roadblock_dict.keys())
    if starting_block is None:
        return route_ids
    starting_ids = [rb.token for rb in starting_candidates]

    # Fix 1: ego starts off-route.
    if starting_block.token not in route_ids and route_ids:
        backward = BreadthFirstSearchRoadBlock(map_api, route_ids[0], forward=False)
        path, found = backward.search(starting_ids, max_depth=search_depth_backward)
        if found:
            # path runs ego-block -> ... -> route start (driving order)
            route_ids[:0] = path[:-1]
        else:
            forward = BreadthFirstSearchRoadBlock(map_api, starting_block.token, forward=True)
            path, found = forward.search(route_ids[:3], max_depth=search_depth_forward)
            if found:
                end_idx = route_ids.index(path[-1])
                route_ids = path + route_ids[end_idx + 1 :]

    # Fix 2: bridge unlinked consecutive roadblocks.
    to_insert: Dict[int, List[str]] = {}
    for i in range(len(route_ids) - 1):
        nxt = map_api.get_map_object(route_ids[i + 1])
        if nxt is None or route_ids[i] in nxt.incoming:
            continue
        bridge = BreadthFirstSearchRoadBlock(map_api, route_ids[i], forward=True)
        path, found = bridge.search([route_ids[i + 1]], max_depth=search_depth_forward)
        if found and path and len(path) >= 3:
            to_insert[i] = path[1:-1]
    offset = 1
    for i, path in to_insert.items():
        route_ids[i + offset : i + offset] = path
        offset += len(path)

    # Fix 3: cut route loops.
    return remove_route_loops(route_ids, map_api)


def remove_route_loops(route_ids: List[str], map_api: LocalMapAPI) -> List[str]:
    """Truncate the route at the first connector overlapping an earlier
    connector by >1 m^2 (`route_utils.py:176-216`)."""
    seen_connectors: List[np.ndarray] = []
    loop_idx: Optional[int] = None
    for idx, token in enumerate(route_ids):
        obj = map_api.get_map_object(token)
        if obj is None or obj.layer != MapLayer.ROADBLOCK_CONNECTOR:
            continue
        for earlier in seen_connectors:
            if polygon_intersection_area(earlier, obj.polygon) > 1.0:
                loop_idx = idx
                break
        if loop_idx is not None:
            break
        seen_connectors.append(obj.polygon)
    return route_ids[:loop_idx] if loop_idx is not None else route_ids
