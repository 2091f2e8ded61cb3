"""Minimal pure-stdlib GeoPackage reader (sqlite3 + WKB).

Counterpart of `diffusiondrive_tpu/planning/gpkg.py`, a copy (the port
imports nothing of the JAX package). A GPKG is a SQLite database whose
feature tables carry one geometry BLOB column (GeoPackageBinary: "GP"
header + envelope + ISO WKB). The nuplan maps
(`nuplan-maps-v1.0/<location>/map.gpkg`) are plain 2D polygon/linestring
layers, so the small subset of the format they use is implemented here
directly: no geopandas/fiona/GDAL anywhere.

Format references: OGC GeoPackage 1.3 §2.1.3 (GeoPackageBinary) and
ISO 13249-3 (WKB). Only the geometry types the nuplan maps use are handled:
Point, LineString, Polygon and their Multi* / Z / M variants.
"""

from __future__ import annotations

import sqlite3
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# WKB base geometry type codes (type % 1000 strips Z/M/ZM offsets)
_POINT, _LINESTRING, _POLYGON = 1, 2, 3
_MULTIPOINT, _MULTILINESTRING, _MULTIPOLYGON, _COLLECTION = 4, 5, 6, 7

_ENVELOPE_DOUBLES = {0: 0, 1: 4, 2: 6, 3: 6, 4: 8}


class Geometry:
    """Parsed WKB geometry: a type name + flat list of (N, 2) coordinate arrays.

    - Point: one (1, 2); LineString: one (N, 2)
    - Polygon: one array per ring (exterior first)
    - Multi*: parts hold each member's arrays; `part_slices` groups rings per
      member polygon so callers can compute per-polygon areas.
    """

    def __init__(self, type_name: str, parts: List[np.ndarray],
                 part_slices: Optional[List[Tuple[int, int]]] = None):
        self.type_name = type_name
        self.parts = parts
        self.part_slices = part_slices or [(0, len(parts))]

    @property
    def is_empty(self) -> bool:
        return not self.parts or all(len(p) == 0 for p in self.parts)


def _ring_area(ring: np.ndarray) -> float:
    """Shoelace area (absolute) of a closed ring."""
    if len(ring) < 3:
        return 0.0
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def _polyline_length(xy: np.ndarray) -> float:
    if len(xy) < 2:
        return 0.0
    return float(np.linalg.norm(np.diff(xy, axis=0), axis=-1).sum())


class _WKBReader:
    def __init__(self, buf: bytes, offset: int = 0):
        self.buf = buf
        self.off = offset

    def geometry(self) -> Geometry:
        order = "<" if self.buf[self.off] == 1 else ">"
        self.off += 1
        (raw_type,) = struct.unpack_from(order + "I", self.buf, self.off)
        self.off += 4
        if raw_type & 0xE0000000:
            # EWKB encoding (not in spec GPKG, tolerated): Z/M/SRID as flag
            # bits instead of the ISO +1000/+2000 type offsets
            if raw_type & 0x20000000:  # SRID present
                self.off += 4
            base = raw_type & 0x0FFFFFFF
            ndim = 2 + bool(raw_type & 0x80000000) + bool(raw_type & 0x40000000)
        else:
            base = raw_type % 1000
            ndim = (2 + (1 if raw_type // 1000 in (1, 3) else 0)
                    + (1 if raw_type // 1000 in (2, 3) else 0))

        if base == _POINT:
            return Geometry("Point", [self._points(order, 1, ndim)])
        if base == _LINESTRING:
            return Geometry("LineString", [self._linestring(order, ndim)])
        if base == _POLYGON:
            return Geometry("Polygon", self._polygon_rings(order, ndim))
        if base in (_MULTIPOINT, _MULTILINESTRING, _MULTIPOLYGON, _COLLECTION):
            (n,) = struct.unpack_from(order + "I", self.buf, self.off)
            self.off += 4
            parts: List[np.ndarray] = []
            slices: List[Tuple[int, int]] = []
            type_name = {_MULTIPOINT: "MultiPoint", _MULTILINESTRING: "MultiLineString",
                         _MULTIPOLYGON: "MultiPolygon", _COLLECTION: "GeometryCollection"}[base]
            for _ in range(n):
                member = self.geometry()  # each member is a full nested WKB
                start = len(parts)
                parts.extend(member.parts)
                slices.append((start, len(parts)))
            return Geometry(type_name, parts, slices)
        raise ValueError(f"unsupported WKB geometry type {raw_type}")

    def _points(self, order: str, n: int, ndim: int) -> np.ndarray:
        vals = struct.unpack_from(order + "d" * (n * ndim), self.buf, self.off)
        self.off += 8 * n * ndim
        return np.asarray(vals, dtype=np.float64).reshape(n, ndim)[:, :2]

    def _linestring(self, order: str, ndim: int) -> np.ndarray:
        (n,) = struct.unpack_from(order + "I", self.buf, self.off)
        self.off += 4
        return self._points(order, n, ndim)

    def _polygon_rings(self, order: str, ndim: int) -> List[np.ndarray]:
        (nrings,) = struct.unpack_from(order + "I", self.buf, self.off)
        self.off += 4
        return [self._linestring(order, ndim) for _ in range(nrings)]


def parse_gpkg_geometry(blob: Optional[bytes]) -> Optional[Geometry]:
    """GeoPackageBinary BLOB -> Geometry (None for NULL/empty)."""
    if blob is None or len(blob) < 8 or blob[:2] != b"GP":
        return None
    flags = blob[3]
    if flags & 0x20:
        # bit 5 = ExtendedGeoPackageBinary: extension-specific payload, not
        # plain WKB — refuse loudly instead of mis-parsing
        raise ValueError("ExtendedGeoPackageBinary blobs are not supported")
    if flags & 0x10:  # bit 4 = empty-geometry flag
        return None
    envelope_doubles = _ENVELOPE_DOUBLES.get((flags >> 1) & 0x07)
    if envelope_doubles is None:
        raise ValueError(f"invalid GPKG envelope indicator in flags {flags:#x}")
    header_len = 8 + 8 * envelope_doubles
    return _WKBReader(blob, header_len).geometry()


def exterior_ring(geom: Optional[Geometry]) -> Optional[np.ndarray]:
    """Largest exterior ring of a (Multi)Polygon as (N, 2)."""
    if geom is None or geom.is_empty:
        return None
    if geom.type_name == "Polygon":
        return geom.parts[0]
    if geom.type_name == "MultiPolygon":
        best, best_area = None, -1.0
        for start, stop in geom.part_slices:
            if stop <= start:
                continue
            area = _ring_area(geom.parts[start])
            if area > best_area:
                best, best_area = geom.parts[start], area
        return best
    return None


def line_coords(geom: Optional[Geometry]) -> Optional[np.ndarray]:
    """(Multi)LineString -> (N, 2) polyline (longest member of a Multi)."""
    if geom is None or geom.is_empty:
        return None
    if geom.type_name == "LineString":
        return geom.parts[0]
    if geom.type_name == "MultiLineString":
        return max(geom.parts, key=_polyline_length)
    return None


def geometry_columns(conn: sqlite3.Connection) -> Dict[str, str]:
    """table name -> geometry column name, from gpkg_geometry_columns."""
    try:
        rows = conn.execute("SELECT table_name, column_name FROM gpkg_geometry_columns").fetchall()
    except sqlite3.OperationalError as exc:
        raise ValueError("not a GeoPackage: missing gpkg_geometry_columns") from exc
    return {t: c for t, c in rows}


def read_layer(conn: sqlite3.Connection, table: str, geom_col: str) -> Iterator[Tuple[dict, Optional[Geometry]]]:
    """Yield (attribute row dict, parsed geometry) for every feature."""
    # The table name comes from gpkg_geometry_columns inside an untrusted
    # file; escape embedded quotes so it cannot break out of the identifier.
    cur = conn.execute('SELECT * FROM "{}"'.format(table.replace('"', '""')))
    cols = [d[0] for d in cur.description]
    gi = cols.index(geom_col)
    for rec in cur:
        attrs = {c: v for i, (c, v) in enumerate(zip(cols, rec)) if i != gi}
        yield attrs, parse_gpkg_geometry(rec[gi])


def open_gpkg(path: Path) -> sqlite3.Connection:
    return sqlite3.connect(f"file:{Path(path)}?mode=ro", uri=True)
