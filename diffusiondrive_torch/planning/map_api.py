"""Self-contained local map API.

Replaces the used subset of nuplan's map interface (SURVEY §2.9): proximal
polygon/lane queries by semantic layer, lane baselines, and the lane graph
(incoming/outgoing edges) for route search. Maps are flat array records
loaded from one .npz per location — produced offline by a converter from the
nuplan GPKG maps (requires geopandas; see `planning/convert_maps.py`), or
constructed programmatically for tests/synthetic scenes.

Copy of `diffusiondrive_tpu/planning/map_api.py` (numpy on the host, as there).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _point_ring_distance(point: np.ndarray, ring: np.ndarray) -> float:
    """Distance from a point to a polygon ring's boundary/interior (0 inside)."""
    from diffusiondrive_torch.planning.pdm_closed.np_geometry import point_in_polygon

    if point_in_polygon(point[None], ring)[0]:
        return 0.0
    a = ring
    b = np.roll(ring, -1, axis=0)
    ab = b - a
    len2 = np.maximum(np.sum(ab**2, axis=-1), 1e-12)
    t = np.clip(np.sum((point - a) * ab, axis=-1) / len2, 0.0, 1.0)
    proj = a + t[:, None] * ab
    return float(np.linalg.norm(point - proj, axis=-1).min())


@dataclass
class MapObjectData:
    """One map element: polygon + optional baseline path + graph edges."""

    token: str
    layer: int                          # MapLayer id
    polygon: np.ndarray                 # (N, 2) exterior ring
    baseline: Optional[np.ndarray] = None   # (M, 3) poses along the centerline
    incoming: List[str] = field(default_factory=list)
    outgoing: List[str] = field(default_factory=list)
    parent_token: Optional[str] = None  # roadblock of a lane
    speed_limit: Optional[float] = None

    @property
    def center(self) -> np.ndarray:
        return self.polygon.mean(axis=0)

    @property
    def radius(self) -> float:
        return float(np.linalg.norm(self.polygon - self.center, axis=-1).max())


class LocalMapAPI:
    """Array-backed map with proximity queries (coarse circumradius filter)."""

    def __init__(self, objects: Sequence[MapObjectData], map_name: str = "local"):
        self.map_name = map_name
        self._objects = list(objects)
        self._by_layer: Dict[int, List[MapObjectData]] = {}
        self._by_token: Dict[str, MapObjectData] = {}
        self._lanes_by_parent: Optional[Dict[str, List[MapObjectData]]] = None
        for obj in self._objects:
            self._by_layer.setdefault(obj.layer, []).append(obj)
            self._by_token[obj.token] = obj
        # precomputed centers/radii per layer for fast proximity filtering
        self._centers = {
            layer: np.array([o.center for o in objs]) for layer, objs in self._by_layer.items()
        }
        self._radii = {
            layer: np.array([o.radius for o in objs]) for layer, objs in self._by_layer.items()
        }

    def get_map_object(self, token: str) -> Optional[MapObjectData]:
        return self._by_token.get(token)

    def lanes_of_roadblock(self, roadblock_token: str) -> List[MapObjectData]:
        """Interior lanes of a roadblock (lanes whose parent is the roadblock),
        the `roadblock.interior_edges` of nuplan's map API."""
        if self._lanes_by_parent is None:
            by_parent: Dict[str, List[MapObjectData]] = {}
            for obj in self._objects:
                if obj.parent_token is not None:
                    by_parent.setdefault(obj.parent_token, []).append(obj)
            self._lanes_by_parent = by_parent
        return self._lanes_by_parent.get(roadblock_token, [])

    def get_distance_to_nearest_map_object(
        self, point: Sequence[float], layer: int
    ) -> Tuple[Optional[str], float]:
        """Token + distance of the nearest object of a layer (0 inside),
        mirroring `map_api.get_distance_to_nearest_map_object`."""
        objs = self._by_layer.get(layer, [])
        if not objs:
            return None, float("inf")
        p = np.asarray([point[0], point[1]], dtype=np.float64)
        # coarse order by center distance, exact ring distance on the few nearest
        order = np.argsort(np.linalg.norm(self._centers[layer] - p, axis=-1) - self._radii[layer])
        best_token, best_dist = None, float("inf")
        for idx in order[: min(len(order), 8)]:
            obj = objs[int(idx)]
            d = _point_ring_distance(p, obj.polygon)
            if d < best_dist:
                best_token, best_dist = obj.token, d
        return best_token, best_dist

    def get_proximal_map_objects(
        self, point: Sequence[float], radius: float, layers: Sequence[int]
    ) -> Dict[int, List[MapObjectData]]:
        """All objects of the given layers whose circumcircle intersects the
        query circle (superset of exact intersection, like an STRtree query)."""
        out: Dict[int, List[MapObjectData]] = {}
        p = np.asarray([point[0], point[1]], dtype=np.float64)
        for layer in layers:
            objs = self._by_layer.get(layer, [])
            if not objs:
                out[layer] = []
                continue
            dist = np.linalg.norm(self._centers[layer] - p, axis=-1)
            mask = dist <= (radius + self._radii[layer])
            out[layer] = [o for o, m in zip(objs, mask) if m]
        return out

    # ------------------------------------------------------------------ #

    def save(self, path: Path) -> None:
        import pickle

        payload = []
        for o in self._objects:
            payload.append(
                dict(token=o.token, layer=o.layer, polygon=o.polygon, baseline=o.baseline,
                     incoming=o.incoming, outgoing=o.outgoing, parent_token=o.parent_token,
                     speed_limit=o.speed_limit)
            )
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as fp:
            pickle.dump({"map_name": self.map_name, "objects": payload}, fp)

    @classmethod
    def load(cls, path: Path) -> "LocalMapAPI":
        import pickle

        with open(path, "rb") as fp:
            data = pickle.load(fp)
        objects = [MapObjectData(**o) for o in data["objects"]]
        return cls(objects, data["map_name"])


@lru_cache(maxsize=8)
def get_maps_api(maps_root: Optional[str], map_name: str) -> Optional[LocalMapAPI]:
    """Load a converted map by location name; None when unavailable."""
    if maps_root is None:
        return None
    path = Path(maps_root) / f"{map_name}.ddmap.pkl"
    if not path.exists():
        return None
    api = LocalMapAPI.load(path)
    return api
