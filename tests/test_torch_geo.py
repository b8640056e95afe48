"""The geo slice's modules against the JAX package, on the CPU.

* ``utils/geohash.py`` and ``utils/geoshape.py``: the port's copies give the
  reference's cells, neighbours, precisions and rings, and raise alike.
* ``ops/filters.py``'s geo filters (K17's plain version): geo_distance,
  geo_distance_range, geo_bounding_box (across the dateline too), the
  geohash_cell query's OR of boxes and geo_polygon, for a batch of queries
  against the JAX bodies run one query at a time; the geo decay on K17's
  distance against the reference's inline haversine.
* ``ops/geoshape.py`` (K18's plain version): the four relations on doc
  shapes made by translating templates of every shape type.

Tolerances. The JAX package computes the haversine with XLA's sin / cos /
asin, the port with PyTorch's; the two libms round differently, so f32
distances differ by up to ~1.4e-5 relative. A mask row may differ only
where the float64 distance from the same f32 coordinates lies within 3e-5
× the bound of a distance bound; for the polygon and the shapes, where an
orientation or ray-cast margin computed in float64 is under 1e-9 deg² (XLA
may contract a multiply and an add, PyTorch rounds each). Outside that band
every mask row is equal, and at most 0.1% of rows may need excusing. Decay
factors agree within rtol 1e-5 on the same distances (see the decay
test). Boxes and geohash cells are compares only: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.errors import (
    QueryParsingError as JaxQueryParsingError)
from elasticsearch_tpu.ops import filters as jax_filters
from elasticsearch_tpu.ops import functionscore as jax_fs
from elasticsearch_tpu.ops import geoshape as jax_geoshape
from elasticsearch_tpu.utils import geohash as jax_geohash
from elasticsearch_tpu.utils import geoshape as jax_geoshape_utils
from elasticsearch_tpu_torch.common.errors import QueryParsingError
from elasticsearch_tpu_torch.ops import filters, functionscore, geoshape
from elasticsearch_tpu_torch.utils import geohash
from elasticsearch_tpu_torch.utils.geoshape import parse_shape_rings

N = 10_000
DIST_BAND = 3e-5
SHAPE_BAND = 1e-9
MAX_EXCUSED = 1e-3
CENTERS = [(55.0, 7.0), (48.5, 2.2), (40.7, -74.0), (-33.9, 151.2),
           (0.0, 179.5)]

#: shape templates around (0, 0), a degree or so across, in every type the
#: mapper takes: [lon, lat] coordinates as GeoJSON writes them
TEMPLATES = [
    {"type": "polygon", "coordinates": [[[-0.5, -0.4], [0.6, -0.5],
                                         [0.7, 0.3], [0.1, 0.8],
                                         [-0.6, 0.4], [-0.5, -0.4]]]},
    {"type": "polygon", "coordinates": [
        [[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0]],
        [[-0.3, -0.3], [0.3, -0.3], [0.3, 0.3], [-0.3, 0.3], [-0.3, -0.3]]]},
    {"type": "linestring", "coordinates": [[-0.8, 0.1], [-0.2, 0.4],
                                           [0.3, -0.2], [0.9, 0.3]]},
    {"type": "point", "coordinates": [0.05, -0.05]},
    {"type": "multipoint", "coordinates": [[0.2, 0.2], [-0.4, 0.1]]},
    {"type": "envelope", "coordinates": [[-0.4, 0.3], [0.5, -0.2]]},
    {"type": "multipolygon", "coordinates": [
        [[[-0.9, -0.9], [-0.5, -0.9], [-0.5, -0.5], [-0.9, -0.9]]],
        [[[0.4, 0.4], [0.9, 0.4], [0.9, 0.9], [0.4, 0.9], [0.4, 0.4]]]]},
    {"type": "multilinestring", "coordinates": [
        [[-0.5, -0.5], [0.5, 0.5]], [[-0.5, 0.5], [0.0, 0.0]]]},
]

#: query shapes: an envelope, a circle (a 33-vertex ring) and a polygon
#: with a hole, around (55, 7)
QUERY_SHAPES = {
    "envelope": {"type": "envelope", "coordinates": [[6.0, 56.0],
                                                     [8.5, 54.2]]},
    "circle": {"type": "circle", "coordinates": [7.2, 55.1],
               "radius": "90km"},
    "hole": {"type": "polygon", "coordinates": [
        [[5.5, 53.8], [9.0, 54.0], [8.6, 56.5], [5.8, 56.2], [5.5, 53.8]],
        [[6.8, 54.8], [7.6, 54.8], [7.6, 55.4], [6.8, 55.4], [6.8, 54.8]]]},
}


def points(rng, n=N):
    """Points clustered around CENTERS (a Gaussian of 1-3°) plus a tenth
    uniform over the globe; a twentieth have no value."""
    k = rng.integers(0, len(CENTERS), n)
    c = np.asarray(CENTERS)[k]
    spread = rng.uniform(1.0, 3.0, n)
    lat = np.clip(c[:, 0] + rng.normal(0, 1, n) * spread, -90, 90)
    lon = c[:, 1] + rng.normal(0, 1, n) * spread
    lon = (lon + 180.0) % 360.0 - 180.0
    uni = rng.random(n) < 0.1
    lat[uni] = np.degrees(np.arcsin(rng.uniform(-1, 1, uni.sum())))
    lon[uni] = rng.uniform(-180, 180, uni.sum())
    exists = rng.random(n) > 0.05
    return lat.astype(np.float32), lon.astype(np.float32), exists


def translate(shape, dlat, dlon):
    """A copy of a GeoJSON-ish shape moved by (dlat, dlon)."""
    def move(c):
        if isinstance(c[0], (int, float)):
            return [c[0] + dlon, c[1] + dlat]
        return [move(x) for x in c]
    out = dict(shape)
    out["coordinates"] = move(shape["coordinates"])
    return out


def doc_shapes(rng, n, center=(55.0, 7.0), spread=2.0):
    """n shapes: the templates translated to random points around
    ``center``; a tenth of the rows hold no shape (None)."""
    out = []
    for _ in range(n):
        if rng.random() < 0.1:
            out.append(None)
            continue
        t = TEMPLATES[int(rng.integers(0, len(TEMPLATES)))]
        out.append(translate(t, center[0] + rng.normal(0, spread),
                             center[1] + rng.normal(0, spread)))
    return out


def shape_column(shapes):
    """The mapper's ring layout for a list of shapes (None: no value) →
    (lats, lons [N, V] f32, rid [N, V] i32, area [N, V] bool, nv [N] i32,
    exists [N] bool), as index/segment.py builds the column."""
    rings = [parse_shape_rings(s) if s is not None else None for s in shapes]
    v = max([2] + [len(r[0]) for r in rings if r is not None])
    n = len(shapes)
    lats = np.zeros((n, v), np.float32)
    lons = np.zeros((n, v), np.float32)
    rid = np.full((n, v), -1, np.int32)
    area = np.zeros((n, v), bool)
    nv = np.zeros(n, np.int32)
    exists = np.zeros(n, bool)
    for i, r in enumerate(rings):
        if r is None:
            continue
        rl, ro, rr, ra = r
        lats[i, :len(rl)], lons[i, :len(ro)] = rl, ro
        rid[i, :len(rr)], area[i, :len(ra)] = rr, ra
        nv[i] = len(rl) - 1
        exists[i] = True
    return lats, lons, rid, area, nv, exists


def haversine64(lat, lon, qlat, qlon):
    r = 6371008.8
    lat, lon = np.float64(lat), np.float64(lon)
    p1, p2 = np.radians(lat), np.radians(np.float64(qlat))
    a = np.sin(np.radians(lat - qlat) / 2) ** 2 + np.cos(p1) * np.cos(p2) \
        * np.sin(np.radians(lon - qlon) / 2) ** 2
    return 2 * r * np.arcsin(np.sqrt(a))


def near_bounds(d64, bounds):
    """[N] rows whose float64 distance lies within the band of a bound."""
    out = np.zeros(d64.shape, bool)
    for b in bounds:
        if b is not None and b > 0:
            out |= np.abs(d64 - b) < DIST_BAND * b
    return out


def _orient64(ax, ay, bx, by, cx, cy):
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def _ray_margin64(py, px, yi, xi, yj, xj):
    """|px - xcross| · |yj - yi| in deg², where the edge spans py."""
    den = yj - yi
    spans = (np.minimum(yi, yj) <= py) & (py <= np.maximum(yi, yj))
    with np.errstate(divide="ignore", invalid="ignore"):
        xc = (xj - xi) * (py - yi) / np.where(den == 0, 1e-30, den) + xi
        m = np.abs(px - xc) * np.abs(den)
    return np.where(spans, m, np.inf)


def shape_margin(dl, do, qlats, qlons):
    """[N] the smallest float64 orientation or ray-cast margin of any doc
    vertex or edge of each row against any query vertex or edge (deg²)."""
    dl, do = np.float64(dl), np.float64(do)
    ql, qo = np.float64(qlats), np.float64(qlons)
    m = np.full(dl.shape[0], np.inf)
    a_lat, a_lon, b_lat, b_lon = dl[:, :-1], do[:, :-1], dl[:, 1:], do[:, 1:]
    for i in range(len(ql) - 1):
        c_lat, c_lon, d_lat, d_lon = ql[i], qo[i], ql[i + 1], qo[i + 1]
        for o in (_orient64(a_lon, a_lat, b_lon, b_lat, c_lon, c_lat),
                  _orient64(a_lon, a_lat, b_lon, b_lat, d_lon, d_lat),
                  _orient64(c_lon, c_lat, d_lon, d_lat, a_lon, a_lat),
                  _orient64(c_lon, c_lat, d_lon, d_lat, b_lon, b_lat)):
            m = np.minimum(m, np.abs(o).min(axis=1))
        m = np.minimum(m, _ray_margin64(dl, do, c_lat, c_lon, d_lat,
                                        d_lon).min(axis=1))
    for j in range(len(ql)):
        m = np.minimum(m, _ray_margin64(ql[j], qo[j], a_lat, a_lon, b_lat,
                                        b_lon).min(axis=1))
    return m


def point_margin(lat, lon, ring_lats, ring_lons):
    """[N] the smallest float64 ray-cast margin of each point against the
    closed ring's edges (deg²)."""
    lat, lon = np.float64(lat), np.float64(lon)
    rl, ro = np.float64(ring_lats), np.float64(ring_lons)
    m = np.full(lat.shape, np.inf)
    for i in range(len(rl) - 1):
        m = np.minimum(m, _ray_margin64(lat, lon, rl[i], ro[i], rl[i + 1],
                                        ro[i + 1]))
    return m


def assert_masks(got, want, excusable, what):
    """Equal masks outside the band; the excused rows at most 0.1%."""
    got, want = np.asarray(got, bool), np.asarray(want, bool)
    assert got.shape == want.shape, what
    diff = got != want
    assert not (diff & ~excusable).any(), \
        f"{what}: rows differ outside the band: " \
        f"{np.argwhere(diff & ~excusable)[:5].tolist()}"
    assert diff.sum() <= MAX_EXCUSED * diff.size, \
        f"{what}: {int(diff.sum())} of {diff.size} rows excused"
    return int(diff.sum())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def cloud():
    return points(np.random.default_rng(17))


def _queries(rng, b, center=(55.0, 7.0), spread=1.0):
    return [(center[0] + rng.uniform(-spread, spread),
             center[1] + rng.uniform(-spread, spread)) for _ in range(b)]


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_geohash_matches_jax():
    rng = np.random.default_rng(3)
    for lat, lon in zip(rng.uniform(-90, 90, 200), rng.uniform(-180, 180,
                                                                200)):
        for length in (1, 4, 5, 9, 12):
            gh = geohash.geohash_encode(lat, lon, length)
            assert gh == jax_geohash.geohash_encode(lat, lon, length)
            assert geohash.geohash_decode_bbox(gh) == \
                jax_geohash.geohash_decode_bbox(gh)
            assert geohash.geohash_neighbors(gh) == \
                jax_geohash.geohash_neighbors(gh)
    for p in (1, 5, 12, 13, 0.5, 40_000, "5km", "100m", "1.5km", "7",
              " 3 ", "0.01m"):
        assert geohash.precision_to_length(p) == \
            jax_geohash.precision_to_length(p), p
    # poles and the dateline keep their neighbours in range
    for gh in ("zzzz", "0000", "b", "upbp"):
        assert geohash.geohash_neighbors(gh) == \
            jax_geohash.geohash_neighbors(gh)


@pytest.mark.parametrize("shape", TEMPLATES + list(QUERY_SHAPES.values()) + [
    {"type": "geometrycollection", "geometries": [TEMPLATES[0],
                                                  TEMPLATES[3]]},
    {"type": "polygon", "coordinates": [[[0, 0], [1, 0], [1, 1]]]},
], ids=lambda s: s["type"])
def test_parse_shape_rings_matches_jax(shape):
    assert parse_shape_rings(shape) == \
        jax_geoshape_utils.parse_shape_rings(shape)
    from elasticsearch_tpu_torch.utils.geoshape import parse_shape
    assert parse_shape(shape) == jax_geoshape_utils.parse_shape(shape)


@pytest.mark.parametrize("shape", [
    {"type": "polygon", "coordinates": [[[0, 0], [1, 1]]]},
    {"type": "linestring", "coordinates": [[0, 0]]},
    {"type": "hexagon", "coordinates": []},
    {"coordinates": [0, 0]},
    {"type": "geometrycollection", "geometries": []},
], ids=lambda s: str(s.get("type")))
def test_bad_shapes_raise_alike(shape):
    with pytest.raises(JaxQueryParsingError) as want:
        jax_geoshape_utils.parse_shape_rings(shape)
    with pytest.raises(QueryParsingError) as got:
        parse_shape_rings(shape)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# K17's plain version: the geo_point filters
# ---------------------------------------------------------------------------

def test_geo_distance_reference_case():
    """tests/test_ops.py's case: within 100 km of NYC."""
    lat = torch.tensor([40.7128, 48.8566])
    lon = torch.tensor([-74.0060, 2.3522])
    got = filters.geo_distance(lat, lon, torch.ones(2, dtype=torch.bool),
                               40.73, -73.93, 100_000.0)
    assert got.tolist() == [True, False]


def test_geo_distance_matches_jax(cloud):
    lat, lon, ex = cloud
    rng = np.random.default_rng(5)
    qs = _queries(rng, 4)
    radius = np.array([200e3, 50e3, 400e3, 1.0], np.float32)
    got = filters.geo_distance(_t(lat), _t(lon), _t(ex),
                               torch.tensor([q[0] for q in qs]),
                               torch.tensor([q[1] for q in qs]),
                               _t(radius))
    assert got.shape == (4, N)
    want, band = [], []
    for (qlat, qlon), r in zip(qs, radius):
        want.append(np.asarray(jax_filters.geo_distance(
            jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(ex),
            jnp.float32(qlat), jnp.float32(qlon), jnp.float32(r))))
        band.append(near_bounds(haversine64(
            lat, lon, np.float32(qlat), np.float32(qlon)), [float(r)]))
    assert_masks(got.numpy(), np.stack(want), np.stack(band),
                 "geo_distance")
    assert got[:3].any(dim=1).all() and not got[:3].all(dim=1).any()


def test_geo_distance_range_matches_jax(cloud):
    lat, lon, ex = cloud
    rng = np.random.default_rng(6)
    qs = _queries(rng, 4)
    bounds = np.array([[200e3, -1, 400e3, -1], [-1, 100e3, -1, 300e3],
                       [-1, -1, 250e3, -1], [150e3, -1, -1, -1]],
                      np.float32)
    cols = [torch.tensor([q[k] for q in qs]) for k in (0, 1)]
    got = filters.geo_distance_range(_t(lat), _t(lon), _t(ex), *cols,
                                     *(_t(bounds[:, j]) for j in range(4)))
    want, band = [], []
    for (qlat, qlon), bnd in zip(qs, bounds):
        want.append(np.asarray(jax_filters.geo_distance_range(
            jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(ex),
            jnp.float32(qlat), jnp.float32(qlon),
            *(jnp.float32(v) for v in bnd))))
        band.append(near_bounds(haversine64(
            lat, lon, np.float32(qlat), np.float32(qlon)),
            [float(v) for v in bnd]))
    assert_masks(got.numpy(), np.stack(want), np.stack(band),
                 "geo_distance_range")
    assert got.any(dim=1).all()


@pytest.mark.parametrize("boxes", [
    [(61.0, -0.1, 48.0, 15.0), (57.0, 5.0, 53.0, 9.0),
     (90.0, -180.0, -90.0, 180.0), (10.0, 20.0, 20.0, 30.0)],
    [(10.0, 170.0, -10.0, -170.0), (5.0, 179.0, -5.0, 179.9),
     (40.0, 178.0, -40.0, -179.0), (1.0, 0.0, -1.0, 0.0)],
], ids=["boxes", "dateline"])
def test_geo_bounding_box_matches_jax(cloud, boxes):
    lat, lon, ex = cloud
    b = np.asarray(boxes, np.float32)
    got = filters.geo_bounding_box(_t(lat), _t(lon), _t(ex),
                                   *(_t(b[:, j]) for j in range(4)))
    for q, box in enumerate(b):
        want = jax_filters.geo_bounding_box(
            jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(ex),
            *(jnp.float32(v) for v in box))
        np.testing.assert_array_equal(got[q].numpy(), np.asarray(want))
    # a point on a box edge is inside
    edge = filters.geo_bounding_box(
        torch.tensor([48.0, 61.0, 47.99]), torch.tensor([-0.1, 15.0, 3.0]),
        torch.ones(3, dtype=torch.bool), 61.0, -0.1, 48.0, 15.0)
    assert edge.tolist() == [True, True, False]


def test_geohash_cell_boxes_match_jax(cloud):
    """The geohash_cell resolver's OR of the cell and its neighbours: one
    plain-version call over [B, 9, 4] boxes against the reference's loop of
    geo_bounding_box calls."""
    lat, lon, ex = cloud
    rng = np.random.default_rng(8)
    boxes = []
    for qlat, qlon in _queries(rng, 3) + [(0.0, 179.99)]:
        gh = geohash.geohash_encode(qlat, qlon, 3)
        cells = [gh] + geohash.geohash_neighbors(gh)
        cells += [cells[-1]] * (9 - len(cells))
        bb = [geohash.geohash_decode_bbox(c) for c in cells]
        boxes.append([(hi, lo_, lo, hi_) for lo, hi, lo_, hi_ in bb])
    boxes = np.asarray(boxes, np.float32)
    got = filters.geo_boxes(_t(lat), _t(lon), _t(ex), _t(boxes))
    for q in range(len(boxes)):
        want = None
        for top, left, bottom, right in boxes[q]:
            m = jax_filters.geo_bounding_box(
                jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(ex),
                jnp.float32(top), jnp.float32(left), jnp.float32(bottom),
                jnp.float32(right))
            want = m if want is None else want | m
        np.testing.assert_array_equal(got[q].numpy(), np.asarray(want))
    assert got.any(dim=1).all()


def test_geo_polygon_matches_jax(cloud):
    lat, lon, ex = cloud
    ring = np.array([[49.0, -0.1], [48.0, 5.0], [49.0, 15.0], [60.0, 14.0],
                     [61.0, -0.1], [50.0, -10.0]], np.float32)
    rng = np.random.default_rng(9)
    off = rng.uniform(-1, 1, (4, 2)).astype(np.float32)
    vl = np.stack([ring[:, 0] + o[0] for o in off]).astype(np.float32)
    vo = np.stack([ring[:, 1] + o[1] for o in off]).astype(np.float32)
    got = filters.geo_polygon(_t(lat), _t(lon), _t(ex), _t(vl), _t(vo))
    want, band = [], []
    for q in range(4):
        want.append(np.asarray(jax_filters.geo_polygon(
            jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(ex),
            jnp.asarray(vl[q]), jnp.asarray(vo[q]))))
        band.append(point_margin(lat, lon, np.append(vl[q], vl[q][0]),
                                 np.append(vo[q], vo[q][0])) < SHAPE_BAND)
    assert_masks(got.numpy(), np.stack(want), np.stack(band), "geo_polygon")
    assert got.any(dim=1).all()
    # a point on a vertex and one on a horizontal edge decide alike
    pl = torch.tensor(vl[0][[0, 1]].tolist() + [float(vl[0][0])])
    po = torch.tensor(vo[0][[0, 1]].tolist() + [float(vo[0][0]) + 0.5])
    pe = torch.ones(3, dtype=torch.bool)
    np.testing.assert_array_equal(
        filters.geo_polygon(pl, po, pe, _t(vl[0]), _t(vo[0])).numpy(),
        np.asarray(jax_filters.geo_polygon(
            jnp.asarray(pl.numpy()), jnp.asarray(po.numpy()),
            jnp.asarray(pe.numpy()), jnp.asarray(vl[0]),
            jnp.asarray(vo[0]))))


@pytest.mark.parametrize("kind", ["gauss", "exp", "linear"])
def test_geo_decay_matches_jax(cloud, kind):
    """K17's distance mode + the port's decay against the reference's
    inline haversine (search/execute.py's geo decay) + its decay: origin 0,
    scale 100 km, offset 10 km, decay 0.5. The distances agree within the
    libms' band (3e-5 relative); on the same distances (the port's, fed to
    the JAX decay) the factors agree within rtol 1e-5, for factors in f32's
    normal range (XLA flushes subnormal results to zero). The decay is not
    held to rtol 1e-5 across the two distances: far from the origin it
    multiplies a distance's relative error many times over (gauss at 570
    km by ~40)."""
    lat, lon, ex = cloud
    olat, olon = np.float32(55.0), np.float32(7.0)
    scale, offset, decay = 100e3, 10e3, 0.5
    dist = filters.geo_distance_m(_t(lat), _t(lon), _t(ex),
                                  torch.tensor([olat]), torch.tensor([olon]))
    got = functionscore.decay(dist, _t(ex), torch.tensor([0.0]),
                              torch.tensor([scale]), torch.tensor([offset]),
                              torch.tensor([decay]), kind)[0].numpy()
    jl, jo = jnp.asarray(lat), jnp.asarray(lon)
    r = 6371008.8
    p1, p2 = jnp.radians(jl), jnp.radians(jnp.float32(olat))
    a = jnp.sin(jnp.radians(jl - olat) / 2) ** 2 + jnp.cos(p1) * \
        jnp.cos(p2) * jnp.sin(jnp.radians(jo - olon) / 2) ** 2
    jdist = np.asarray(2 * r * jnp.arcsin(jnp.sqrt(a)))
    d = dist[0].numpy()
    np.testing.assert_allclose(d, jdist, rtol=DIST_BAND)
    want = np.asarray(jax_fs.decay(jnp.asarray(d), jnp.asarray(ex),
                                   jnp.float32(0), jnp.float32(scale),
                                   jnp.float32(offset), jnp.float32(decay),
                                   kind))
    normal = np.abs(want) >= np.finfo(np.float32).tiny
    assert ((want > 0.01) & (want < 1)).sum() > 500
    np.testing.assert_allclose(got[normal], want[normal], rtol=1e-5)
    np.testing.assert_array_equal(got[~ex], 1.0)
    assert (got < 1).any() and (got > 0.1).any()


# ---------------------------------------------------------------------------
# K18's plain version: geo_shape relations
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def doc_column():
    return shape_column(doc_shapes(np.random.default_rng(21), 1500))


@pytest.mark.parametrize("relation", ["intersects", "disjoint", "within",
                                      "contains"])
@pytest.mark.parametrize("qname", ["circle", "hole"])
def test_shape_relation_matches_jax(doc_column, relation, qname):
    lats, lons, rid, area, nv, exists = doc_column
    qlats, qlons, qrid, qarea = parse_shape_rings(QUERY_SHAPES[qname])
    rng = np.random.default_rng(len(qname))
    off = rng.uniform(-1, 1, (2, 2))
    ql = np.stack([np.asarray(qlats) + o[0] for o in off]).astype(np.float32)
    qo = np.stack([np.asarray(qlons) + o[1] for o in off]).astype(np.float32)
    got = geoshape.shape_relation(
        _t(lats), _t(lons), _t(nv), _t(exists), _t(rid), _t(area), _t(ql),
        _t(qo), np.asarray(qrid, np.int32), np.asarray(qarea, bool),
        relation)
    # the reference's body under jax.vmap over the queries, as its
    # executor runs it
    ref = jax.jit(jax.vmap(
        lambda *a: jax_geoshape.shape_relation(
            *a, np.asarray(qrid, np.int32), np.asarray(qarea, bool),
            relation), in_axes=(None,) * 6 + (0, 0)))
    want = np.asarray(ref(*(jnp.asarray(a) for a in (
        lats, lons, nv, exists, rid, area, ql, qo))))
    band = np.stack([shape_margin(lats, lons, ql[q], qo[q]) < SHAPE_BAND
                     for q in range(2)])
    assert_masks(got.numpy(), want, band, f"{relation} {qname}")
    if relation in ("intersects", "disjoint"):
        assert got.any(dim=1).all()


def test_shape_relation_single_query_and_errors(doc_column):
    lats, lons, rid, area, nv, exists = doc_column
    qlats, qlons, qrid, qarea = parse_shape_rings(QUERY_SHAPES["envelope"])
    args = (_t(lats), _t(lons), _t(nv), _t(exists), _t(rid), _t(area))
    one = geoshape.shape_relation(
        *args, torch.tensor(qlats, dtype=torch.float32),
        torch.tensor(qlons, dtype=torch.float32), qrid, qarea, "intersects")
    many = geoshape.shape_relation(
        *args, torch.tensor([qlats], dtype=torch.float32),
        torch.tensor([qlons], dtype=torch.float32), qrid, qarea,
        "intersects")
    assert one.shape == (len(nv),)
    np.testing.assert_array_equal(one.numpy(), many[0].numpy())
    with pytest.raises(ValueError):
        geoshape.shape_relation(*args, torch.tensor(qlats),
                                torch.tensor(qlons), qrid, qarea, "touches")


def test_collinear_point_stays_disjoint():
    """tests/test_query_dsl3.py's collinear case: a point doc on the line
    of a distant envelope edge is disjoint; on the edge it intersects."""
    col = shape_column([{"type": "point", "coordinates": [100.0, 10.0]}])
    args = tuple(_t(a) for a in (col[0], col[1], col[4], col[5], col[2],
                                 col[3]))
    for env, inter in (([[0.0, 10.0], [1.0, 9.0]], False),
                       ([[99.0, 10.0], [101.0, 9.0]], True)):
        ql, qo, qr, qa = parse_shape_rings({"type": "envelope",
                                            "coordinates": env})
        for rel, want in (("intersects", inter), ("disjoint", not inter)):
            got = geoshape.shape_relation(
                *args, torch.tensor([ql], dtype=torch.float32),
                torch.tensor([qo], dtype=torch.float32), qr, qa, rel)
            assert bool(got[0, 0]) is want, (env, rel)
