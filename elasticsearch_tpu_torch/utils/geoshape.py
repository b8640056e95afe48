"""GeoJSON-ish shape parsing shared by the geo_shape field mapper and the
geo_shape query (ref: core/common/geo/builders/ShapeBuilder.java,
PolygonBuilder, MultiPolygonBuilder, LineStringBuilder).

Counterpart of ``elasticsearch_tpu/utils/geoshape.py``, the port's own copy.

Shapes reduce to a MULTI-RING vertex soup: concatenated per-ring closed
(or open, for lines) lat/lon runs plus a per-vertex ring id and a
per-vertex "area" flag. Relations run as exact dense tests on device
(ops/geoshape.py, kernel K18) with global EVEN-ODD parity over area
rings — which makes polygon holes (outer ring + hole rings), multipolygons
(disjunction falls out of parity + per-ring edge tests) and
line/point geometries all exact without member-by-member decomposition:

* polygon with holes → outer ring + hole rings, all area rings; a point
  inside a hole has even crossing parity, i.e. outside the shape;
* multipolygon → every member's rings; a point inside any member has
  odd parity;
* linestring / multilinestring → open runs flagged non-area (their
  edges intersect, but contribute no inside-ness);
* point / multipoint → degenerate 2-vertex rings (zero-length edge:
  boundary contact still registers as intersection);
* envelope → 4-edge ring; circle → a 32-gon ring.
"""

from __future__ import annotations

import math

from elasticsearch_tpu_torch.common.errors import QueryParsingError

CIRCLE_SEGMENTS = 32


def parse_shape_rings(shape: dict
                      ) -> tuple[list[float], list[float], list[int],
                                 list[bool]]:
    """→ (lats, lons, rid, area): concatenated rings, ``rid[i]`` the
    vertex's ring id (edges only exist between same-rid neighbours),
    ``area[i]`` True when the ring encloses area (polygon/envelope/
    circle/point rings; False for linestring runs)."""
    lats: list[float] = []
    lons: list[float] = []
    rid: list[int] = []
    area: list[bool] = []
    next_rid = [0]

    def add_ring(rl: list[float], ro: list[float], is_area: bool,
                 close: bool) -> None:
        rl, ro = list(rl), list(ro)
        if close and (rl[0] != rl[-1] or ro[0] != ro[-1]):
            rl.append(rl[0])
            ro.append(ro[0])
        r = next_rid[0]
        next_rid[0] += 1
        lats.extend(rl)
        lons.extend(ro)
        rid.extend([r] * len(rl))
        area.extend([is_area] * len(rl))

    def walk(node: dict) -> None:
        if not isinstance(node, dict) or "type" not in node:
            raise QueryParsingError(f"cannot parse shape [{node!r}]")
        stype = str(node["type"]).lower()
        coords = node.get("coordinates")
        if stype == "point":
            lon, lat = float(coords[0]), float(coords[1])
            add_ring([lat, lat], [lon, lon], True, False)
        elif stype == "multipoint":
            for p in coords:
                lon, lat = float(p[0]), float(p[1])
                add_ring([lat, lat], [lon, lon], True, False)
        elif stype == "envelope":
            # ES order: [[west, north], [east, south]]
            (w, n), (e, s) = coords
            add_ring([float(n), float(n), float(s), float(s), float(n)],
                     [float(w), float(e), float(e), float(w), float(w)],
                     True, False)
        elif stype == "polygon":
            for ring in coords:          # outer first, then holes —
                if len(ring) < 3:        # even-odd parity handles both
                    raise QueryParsingError(
                        "polygon needs at least 3 vertices")
                add_ring([float(p[1]) for p in ring],
                         [float(p[0]) for p in ring], True, True)
        elif stype == "multipolygon":
            for poly in coords:
                for ring in poly:
                    if len(ring) < 3:
                        raise QueryParsingError(
                            "polygon needs at least 3 vertices")
                    add_ring([float(p[1]) for p in ring],
                             [float(p[0]) for p in ring], True, True)
        elif stype == "linestring":
            if len(coords) < 2:
                raise QueryParsingError(
                    "linestring needs at least 2 vertices")
            add_ring([float(p[1]) for p in coords],
                     [float(p[0]) for p in coords], False, False)
        elif stype == "multilinestring":
            for line in coords:
                if len(line) < 2:
                    raise QueryParsingError(
                        "linestring needs at least 2 vertices")
                add_ring([float(p[1]) for p in line],
                         [float(p[0]) for p in line], False, False)
        elif stype == "circle":
            lon, lat = float(coords[0]), float(coords[1])
            from elasticsearch_tpu_torch.search.query_dsl import (
                parse_distance)
            radius_m = parse_distance(node.get("radius", "0m"))
            # meters → degrees (local tangent approximation)
            dlat = radius_m / 111_320.0
            dlon = radius_m / (111_320.0 *
                               max(math.cos(math.radians(lat)), 1e-6))
            rl, ro = [], []
            for i in range(CIRCLE_SEGMENTS + 1):
                a = 2.0 * math.pi * i / CIRCLE_SEGMENTS
                rl.append(lat + dlat * math.sin(a))
                ro.append(lon + dlon * math.cos(a))
            add_ring(rl, ro, True, False)
        elif stype == "geometrycollection":
            for sub in node.get("geometries", []):
                walk(sub)
        else:
            raise QueryParsingError(
                f"geo_shape type [{stype}] is not supported")

    walk(shape)
    if not lats:
        raise QueryParsingError(f"empty shape [{shape!r}]")
    return lats, lons, rid, area


def parse_shape(shape: dict) -> tuple[list[float], list[float]]:
    """Legacy single-ring view: the FIRST ring of the parsed shape
    (kept for callers that predate multi-ring support)."""
    lats, lons, rid, _ = parse_shape_rings(shape)
    n = rid.count(0)
    return lats[:n], lons[:n]
