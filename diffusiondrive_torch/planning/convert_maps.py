"""Offline converter: nuplan GPKG maps -> LocalMapAPI pickle records.

Counterpart of `diffusiondrive_tpu/planning/convert_maps.py`, onto the
port's `planning/map_api.py` and its own GeoPackage reader
(`planning/gpkg.py`: sqlite3 + WKB), so the port makes its maps without
the JAX package. The `<location>.ddmap.pkl` files it writes hold plain
dicts and numpy arrays: `planning/map_api.get_maps_api` of either package
loads them.

Layer mapping (nuplan-maps-v1.0 GPKG):
  lanes_polygons          -> LANE           (baseline from baseline_paths)
  lane_connectors         -> LANE_CONNECTOR
  lane_groups_polygons    -> ROADBLOCK
  lane_group_connectors   -> ROADBLOCK_CONNECTOR
  intersections           -> INTERSECTION
  generic_drivable_areas  -> DRIVABLE_AREA
  carpark_areas           -> CARPARK_AREA
  walkways                -> WALKWAYS
  crosswalks              -> CROSSWALK

Graph fields: lanes carry parent roadblock (lane_group_fid) and outgoing
lane-connector successors; roadblocks chain through lane_group_connectors.

The conversion is split in two halves: `rows_from_gpkg` (sqlite3 + WKB IO
-> plain row dicts with numpy geometry) feeds `build_map_objects` (pure:
fid normalization, graph building, roadblock graph derivation).

Usage:
    python -m diffusiondrive_torch.planning.convert_maps \
        --nuplan-maps-root $NUPLAN_MAPS_ROOT --output-dir $DD_MAPS_ROOT \
        [--locations us-ma-boston ...]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from diffusiondrive_torch.evaluate.observation import MapLayer
from diffusiondrive_torch.planning.map_api import LocalMapAPI, MapObjectData

logger = logging.getLogger(__name__)

MAP_LOCATIONS = ("sg-one-north", "us-ma-boston", "us-nv-las-vegas-strip", "us-pa-pittsburgh-hazelwood")

POLYGON_LAYERS = {
    "lanes_polygons": MapLayer.LANE,
    "lane_connectors": MapLayer.LANE_CONNECTOR,
    "lane_groups_polygons": MapLayer.ROADBLOCK,
    "lane_group_connectors": MapLayer.ROADBLOCK_CONNECTOR,
    "intersections": MapLayer.INTERSECTION,
    "generic_drivable_areas": MapLayer.DRIVABLE_AREA,
    "carpark_areas": MapLayer.CARPARK_AREA,
    "walkways": MapLayer.WALKWAYS,
    "crosswalks": MapLayer.CROSSWALK,
}

BASELINE_LAYER = "baseline_paths"


def baseline_poses_from_coords(xy: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """(M, 2) polyline -> (M, 3) poses; headings from segment directions."""
    if xy is None or len(xy) < 2:
        return None
    d = np.diff(xy, axis=0)
    headings = np.arctan2(d[:, 1], d[:, 0])
    headings = np.concatenate([headings, headings[-1:]])
    return np.concatenate([xy, headings[:, None]], axis=1)


# --------------------------------------------------------------------------- #
# Pure schema logic over plain row dicts
# --------------------------------------------------------------------------- #


def _fid(value) -> Optional[str]:
    """Normalize a GPKG fid (int/float/str, possibly NaN) to a string token."""
    if value is None or _isnan(value):
        return None
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return str(value)


def _isnan(value) -> bool:
    try:
        return bool(np.isnan(value))
    except (TypeError, ValueError):
        return False


def build_map_objects(
    layer_rows: Dict[str, List[dict]], location: str = "local"
) -> LocalMapAPI:
    """Pure conversion of GPKG-schema row dicts into a LocalMapAPI.

    `layer_rows[layer_name]` is a list of dicts with the GPKG columns used:
      - all polygon layers: `fid`, `polygon` ((N,2) ndarray);
      - lanes_polygons: + `lane_group_fid`, `speed_limit_mps`;
      - lane_connectors: + `lane_group_connector_fid`, `exit_lane_fid`,
        `entry_lane_fid`, `speed_limit_mps`;
      - baseline_paths: `lane_fid` or `lane_connector_fid`, `coords`
        ((M,2) ndarray polyline).
    """
    # baseline paths keyed by lane / lane-connector fid
    baselines: Dict[str, np.ndarray] = {}
    for row in layer_rows.get(BASELINE_LAYER, []):
        poses = baseline_poses_from_coords(row.get("coords"))
        if poses is None:
            continue
        for col in ("lane_fid", "lane_connector_fid"):
            token = _fid(row.get(col))
            if token is not None:
                baselines[token] = poses

    # lane connectors define the lane graph: exit_lane -> connector -> entry_lane
    lane_succ: Dict[str, List[str]] = {}
    lane_pred: Dict[str, List[str]] = {}
    for row in layer_rows.get("lane_connectors", []):
        token = _fid(row.get("fid"))
        exit_lane = _fid(row.get("exit_lane_fid"))
        entry_lane = _fid(row.get("entry_lane_fid"))
        if token is None:
            continue
        if exit_lane:
            lane_succ.setdefault(exit_lane, []).append(token)
            lane_pred.setdefault(token, []).append(exit_lane)
        if entry_lane:
            lane_succ.setdefault(token, []).append(entry_lane)
            lane_pred.setdefault(entry_lane, []).append(token)

    objects: List[MapObjectData] = []
    for layer_name, layer_id in POLYGON_LAYERS.items():
        for row in layer_rows.get(layer_name, []):
            token = _fid(row.get("fid"))
            ring = row.get("polygon")
            if ring is None or token is None:
                continue
            parent = None
            speed_limit = None
            if layer_id in (MapLayer.LANE, MapLayer.LANE_CONNECTOR):
                parent = _fid(row.get("lane_group_fid")) or _fid(row.get("lane_group_connector_fid"))
                sl = row.get("speed_limit_mps")
                speed_limit = float(sl) if sl is not None and not _isnan(sl) else None
            objects.append(
                MapObjectData(
                    token=token,
                    layer=layer_id,
                    polygon=np.asarray(ring, dtype=np.float64),
                    baseline=baselines.get(token),
                    outgoing=lane_succ.get(token, []),
                    incoming=lane_pred.get(token, []),
                    parent_token=parent,
                    speed_limit=speed_limit,
                )
            )

    # roadblock graph from lane graph: parent(succ(lane)) are successors
    by_token = {o.token: o for o in objects}
    rb_succ: Dict[str, set] = {}
    for o in objects:
        if o.layer in (MapLayer.LANE, MapLayer.LANE_CONNECTOR) and o.parent_token:
            for nxt in o.outgoing:
                nxt_obj = by_token.get(nxt)
                if nxt_obj and nxt_obj.parent_token and nxt_obj.parent_token != o.parent_token:
                    rb_succ.setdefault(o.parent_token, set()).add(nxt_obj.parent_token)
    for o in objects:
        if o.layer in (MapLayer.ROADBLOCK, MapLayer.ROADBLOCK_CONNECTOR):
            o.outgoing = sorted(rb_succ.get(o.token, set()))
    rb_pred: Dict[str, List[str]] = {}
    for src, dsts in rb_succ.items():
        for dst in dsts:
            rb_pred.setdefault(dst, []).append(src)
    for o in objects:
        if o.layer in (MapLayer.ROADBLOCK, MapLayer.ROADBLOCK_CONNECTOR):
            o.incoming = sorted(rb_pred.get(o.token, []))

    logger.info("%s: converted %d map objects", location, len(objects))
    return LocalMapAPI(objects, location)


# --------------------------------------------------------------------------- #
# GPKG IO (stdlib sqlite3 + WKB, `planning/gpkg.py`)
# --------------------------------------------------------------------------- #


def rows_from_gpkg(gpkg_path: Path) -> Dict[str, List[dict]]:
    """Read the used GPKG layers into plain row dicts with numpy geometry."""
    from diffusiondrive_torch.planning.gpkg import (
        exterior_ring,
        geometry_columns,
        line_coords,
        open_gpkg,
        read_layer,
    )

    rows: Dict[str, List[dict]] = {}
    with open_gpkg(gpkg_path) as conn:
        geom_cols = geometry_columns(conn)
        for layer_name in list(POLYGON_LAYERS) + [BASELINE_LAYER]:
            if layer_name not in geom_cols:
                logger.warning("%s: layer %s missing", gpkg_path, layer_name)
                continue
            out: List[dict] = []
            for record, geom in read_layer(conn, layer_name, geom_cols[layer_name]):
                if layer_name == BASELINE_LAYER:
                    record["coords"] = line_coords(geom)
                else:
                    record["polygon"] = exterior_ring(geom)
                out.append(record)
            rows[layer_name] = out
    return rows


def convert_location(gpkg_path: Path, location: str) -> LocalMapAPI:
    return build_map_objects(rows_from_gpkg(gpkg_path), location)


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nuplan-maps-root", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--locations", nargs="*", default=list(MAP_LOCATIONS))
    parser.add_argument("--map-version", default="nuplan-maps-v1.0")
    args = parser.parse_args(argv)

    for location in args.locations:
        # nuplan layout: <root>/<location>/<version>/map.gpkg (or 9.17.1964/..)
        candidates = sorted(Path(args.nuplan_maps_root, location).rglob("*.gpkg"))
        if not candidates:
            logger.error("no GPKG found for %s", location)
            continue
        api = convert_location(candidates[-1], location)
        out = Path(args.output_dir) / f"{location}.ddmap.pkl"
        api.save(out)
        logger.info("wrote %s", out)


if __name__ == "__main__":
    main()
