"""Lane-graph route search over the LocalMapAPI.

Parity: `pdm_planner/utils/graph_search/dijkstra.py` (lane-level Dijkstra to
the target roadblock) and `bfs_roadblock.py` (roadblock-level BFS used by
route correction). Operates on `MapObjectData` (tokens + outgoing edges).

Copy of `diffusiondrive_tpu/planning/pdm_closed/graph_search.py` (numpy on the host, as there).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from diffusiondrive_torch.planning.map_api import LocalMapAPI, MapObjectData


class Dijkstra:
    """Shortest lane path ending in a target roadblock (edge cost = length)."""

    def __init__(self, map_api: LocalMapAPI, start_lane: MapObjectData, candidate_lane_ids: List[str]):
        self._map_api = map_api
        self._start = start_lane
        self._candidates = set(candidate_lane_ids)

    def _length(self, lane: MapObjectData) -> float:
        if lane.baseline is None or len(lane.baseline) < 2:
            return 1.0
        return float(np.linalg.norm(np.diff(lane.baseline[:, :2], axis=0), axis=-1).sum())

    def search(self, target_roadblock_id: str) -> Tuple[List[MapObjectData], bool]:
        import heapq

        parent: Dict[str, Optional[MapObjectData]] = {self._start.token: None}
        depth: Dict[str, int] = {self._start.token: 1}
        dist: Dict[str, float] = {self._start.token: 1.0}
        heap = [(1.0, 0, self._start.token)]
        expanded: Dict[str, MapObjectData] = {}
        counter = 0

        end_edge, path_found = self._start, False
        while heap:
            d, _, token = heapq.heappop(heap)
            if token in expanded:
                continue
            lane = self._map_api.get_map_object(token)
            expanded[token] = lane
            if lane.parent_token == target_roadblock_id:
                end_edge, path_found = lane, True
                break
            for next_token in lane.outgoing:
                if next_token not in self._candidates or next_token in expanded:
                    continue
                next_lane = self._map_api.get_map_object(next_token)
                if next_lane is None:
                    continue
                alt = d + self._length(next_lane)
                if next_token not in dist or alt < dist[next_token]:
                    dist[next_token] = alt
                    parent[next_token] = lane
                    depth[next_token] = depth[token] + 1
                    counter += 1
                    heapq.heappush(heap, (alt, counter, next_token))

        if not path_found and expanded:
            # fall back to the deepest (then cheapest) expanded edge
            max_depth = max(depth[t] for t in expanded)
            deepest = [t for t in expanded if depth[t] == max_depth]
            end_edge = self._map_api.get_map_object(min(deepest, key=lambda t: dist[t]))

        path = [end_edge]
        while parent.get(path[-1].token) is not None:
            path.append(parent[path[-1].token])
        path.reverse()
        return path, path_found


class BreadthFirstSearchRoadBlock:
    """Roadblock-level BFS (forward or backward) for route correction."""

    def __init__(self, map_api: LocalMapAPI, start_roadblock_id: str, forward: bool = True):
        self._map_api = map_api
        self._start_id = start_roadblock_id
        self._forward = forward

    def search(self, target_ids: List[str], max_depth: int = 30) -> Tuple[Optional[List[str]], bool]:
        """BFS until any target roadblock id is reached; returns id path in
        *driving order* (for backward search the raw parent chain already runs
        target -> start in driving order and is left unreversed, matching
        `bfs_roadblock.py:_construct_path`)."""
        targets = set(target_ids)
        start = self._map_api.get_map_object(self._start_id)
        if start is None:
            return None, False
        parent: Dict[str, Optional[str]] = {self._start_id: None}
        queue = [(self._start_id, 0)]
        while queue:
            token, d = queue.pop(0)
            if token in targets:
                path = [token]
                while parent[path[-1]] is not None:
                    path.append(parent[path[-1]])
                if self._forward:
                    path.reverse()
                return path, True
            if d >= max_depth:
                continue
            obj = self._map_api.get_map_object(token)
            if obj is None:
                continue
            neighbors = obj.outgoing if self._forward else obj.incoming
            for nxt in neighbors:
                if nxt not in parent:
                    parent[nxt] = token
                    queue.append((nxt, d + 1))
        return None, False
