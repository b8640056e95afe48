"""The geo slice through the port against the JAX package, on the CPU.

The same documents (body text, a ``location`` geo_point given as an
object, a "lat,lon" string or a [lon, lat] array, an ``area`` geo_shape of
every shape type, a ``rank`` and a ``tag``) go into both packages' Engine:
two shards, each in two segments, one with a deleted doc. Then:

* batches of each geo query through both ``ShardSearcher``s'
  ``query_phase_batch`` (and one request alone through ``query_phase`` with
  a geo post_filter): geo_distance, geo_bounding_box (across the dateline
  too), geo_distance_range, geo_polygon, geohash_cell with and without
  neighbours, exists on the geo field, function_score with a gauss or an
  exp decay on it (``test_torch_geo`` holds the linear decay too),
  geo_shape with each relation, and a geo query on a
  field that is not geo (no match, in both);
* the geohash_cell parser and the geo parse errors (``tests/
  test_query_dsl3.py``'s cases), the geo_shape mapper arm and its errors;
* the geo aggregations (geohash_grid with a geo_centroid sub, geo_distance
  ranges, geo_bounds, geo_centroid, and geohash_grid on a non-geo field):
  shard partials and ``controller.merge_responses`` equal;
* percolator registries over probe docs carrying a location and an area:
  geo_distance, geo_bounding_box (inside a bool) and geohash_cell
  registrations through ``percolate``, ``percolate_many`` and
  ``percolate_serial`` against the JAX ``percolate_many``; geo_shape
  registrations (the eager lane) against the JAX shape body.

Tolerances, as ``test_torch_geo``: the two packages' f32 distances differ
in the last bits (their libms), so a point within 3e-5 × the bound of a
distance bound could fall on either side; the documents here hold none
(asserted), so totals and hit lists are equal. Scores agree to rtol 1e-5
with ties swapped only at equal scores (``test_torch_slice3``'s check);
the decay's scale (1,000 km) keeps the factors' amplification of the
distances' last bits under that over the documents' extent.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from elasticsearch_tpu.cluster.state import IndexMetadata
from elasticsearch_tpu.common.errors import (
    MapperParsingError as JaxMapperParsingError)
from elasticsearch_tpu.index.device_reader import (
    device_reader_for as jax_device_reader_for)
from elasticsearch_tpu.index.engine import Engine as JaxEngine
from elasticsearch_tpu.mapping import MapperService as JaxMapperService
from elasticsearch_tpu.search import controller as jax_controller
from elasticsearch_tpu.search import percolator as jax_perc
from elasticsearch_tpu.search.phase import (
    ShardSearcher as JaxShardSearcher,
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu.search.query_dsl import parse_query as jax_parse_query
from elasticsearch_tpu.ops import geoshape as jax_geoshape
from elasticsearch_tpu.utils import geoshape as jax_geoshape_utils
from elasticsearch_tpu_torch.common.errors import (
    MapperParsingError, QueryParsingError)
from elasticsearch_tpu_torch.index.device_reader import device_reader_for
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search import controller, percolator
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)
from elasticsearch_tpu_torch.search.query_dsl import parse_query
from elasticsearch_tpu_torch.utils.geohash import geohash_encode
from test_torch_aggs import assert_same
from test_torch_geo import (DIST_BAND, QUERY_SHAPES, TEMPLATES, haversine64,
                            translate)
from test_torch_slice3 import _assert_same

RTOL = 1e-5
VOCAB = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]
MAPPING = {"properties": {
    "body": {"type": "text"},
    "location": {"type": "geo_point"},
    "area": {"type": "geo_shape"},
    "rank": {"type": "double"},
    "tag": {"type": "keyword"}}}
#: (center, share of the docs): a cluster at (55, 7), one on the dateline
CLUSTERS = [((55.0, 7.0), 0.8), ((0.0, 179.6), 0.2)]


def _docs(seed=31, n=240):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(VOCAB, int(rng.integers(1, 9)))),
             "rank": float(i % 37), "tag": f"t{i % 3}"}
        (clat, clon), _ = CLUSTERS[0 if rng.random() < 0.8 else 1]
        lat = float(np.clip(clat + rng.normal(0, 1.5), -89, 89))
        lon = float((clon + rng.normal(0, 1.5) + 180.0) % 360.0 - 180.0)
        if i % 9:
            form = i % 3
            d["location"] = {"lat": lat, "lon": lon} if form == 0 else \
                f"{lat},{lon}" if form == 1 else [lon, lat]
        if i % 7:
            t = TEMPLATES[i % len(TEMPLATES)]
            d["area"] = translate(t, clat + rng.normal(0, 1.5),
                                  clon + rng.normal(0, 1.5))
        docs.append(d)
    docs.append({"body": "alpha", "location": {"lat": 10.0, "lon": 10.0}})
    return docs


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """(jax searchers, port searchers, docs): two shards of two segments,
    the first with doc 0-8 deleted."""
    tmp = tmp_path_factory.mktemp("geo")
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    docs = _docs()
    half = len(docs) // 2
    js, ps = [], []
    for si, part in enumerate((docs[:half], docs[half:])):
        jeng, eng = JaxEngine(tmp / f"jax{si}", jms), \
            Engine(tmp / f"torch{si}", ms)
        for e in (jeng, eng):
            for i, d in enumerate(part):
                e.index(f"{si}-{i}", d)
                if i == len(part) // 2:
                    e.refresh()
            e.refresh()
            if si == 0:
                e.delete("0-8")
                e.refresh()
        js.append(JaxShardSearcher(si, jax_device_reader_for(jeng), jms))
        ps.append(ShardSearcher(si, device_reader_for(eng, device="cpu"),
                                ms))
    assert all(len(s.reader.segments) == 2 for s in ps)
    return js, ps, docs


def _points(docs):
    """(lat, lon) f32 of every doc with a location, as the columns hold."""
    out = []
    for d in docs:
        v = d.get("location")
        if v is None:
            continue
        if isinstance(v, dict):
            lat, lon = v["lat"], v["lon"]
        elif isinstance(v, str):
            lat, lon = (float(x) for x in v.split(","))
        else:
            lon, lat = v
        out.append((lat, lon))
    return np.asarray(out, np.float32)


def _centers(seed, n, center=(55.0, 7.0)):
    rng = np.random.default_rng(seed)
    return [(round(center[0] + rng.uniform(-1, 1), 4),
             round(center[1] + rng.uniform(-1, 1), 4)) for _ in range(n)]


def _bool(leaf, text="alpha beta"):
    return {"query": {"bool": {"must": [{"match": {"body": text}}],
                               "filter": [leaf]}}, "size": 20}


BATCHES = {
    "geo_distance": [_bool({"geo_distance": {
        "distance": "150km", "location": {"lat": la, "lon": lo}}})
        for la, lo in _centers(1, 5)],
    "geo_bounding_box": [_bool({"geo_bounding_box": {"location": {
        "top_left": {"lat": la + 1.5, "lon": lo - 2.0},
        "bottom_right": {"lat": la - 1.0, "lon": lo + 1.0}}}})
        for la, lo in _centers(2, 5)],
    "dateline": [_bool({"geo_bounding_box": {"location": {
        "top_left": {"lat": 2.0 + k, "lon": 179.0 - k},
        "bottom_right": {"lat": -2.0, "lon": -179.5 + k}}}})
        for k in (0.0, 0.5, 1.0)],
    "geo_distance_range": [_bool({"geo_distance_range": {
        "from": "50km", "to": "200km", "location": [lo, la]}})
        for la, lo in _centers(3, 4)],
    "geo_polygon": [_bool({"geo_polygon": {"location": {"points": [
        {"lat": la - 1, "lon": lo - 1.5}, {"lat": la - 1.2, "lon": lo + 1},
        {"lat": la + 1.3, "lon": lo + 1.4}, {"lat": la + 0.8,
                                             "lon": lo - 1.0}]}}})
        for la, lo in _centers(4, 4)],
    "geohash_cell": [_bool({"geohash_cell": {
        "location": {"lat": la, "lon": lo}, "precision": 3,
        "neighbors": True}}) for la, lo in _centers(5, 4)],
    "geohash_cell_alone": [_bool({"geohash_cell": {
        "location": geohash_encode(la, lo, 2), "precision": 2}})
        for la, lo in _centers(6, 3)],
    "exists": [_bool({"exists": {"field": "location"}}, t)
               for t in ("alpha", "beta gamma", "delta")],
    "not_geo_field": [_bool({"geo_distance": {
        "distance": "10km", "tag": "40,-70"}}), _bool({"geo_shape": {
            "tag": {"shape": QUERY_SHAPES["envelope"]}}})],
}
for _kind in ("gauss", "exp"):
    BATCHES[f"decay_{_kind}"] = [
        {"query": {"function_score": {
            "query": {"match": {"body": t}},
            "functions": [{_kind: {"location": {
                "origin": {"lat": la, "lon": lo}, "scale": "1000km",
                "offset": "10km", "decay": 0.5}}}],
            "boost_mode": "multiply"}}, "size": 20}
        for t, (la, lo) in zip(("alpha", "beta gamma", "eps"),
                               _centers(7, 3))]
#: a 0.2° envelope: the shape a doc polygon can contain
SMALL = {"type": "envelope", "coordinates": [[6.9, 55.1], [7.1, 54.9]]}
for _rel, _shape in (("intersects", QUERY_SHAPES["hole"]),
                     ("disjoint", QUERY_SHAPES["envelope"]),
                     ("within", QUERY_SHAPES["hole"]),
                     ("contains", SMALL)):
    BATCHES[f"shape_{_rel}"] = [
        {"query": {"geo_shape": {"area": {
            "shape": translate(_shape, la - 55.0, lo - 7.0),
            "relation": _rel}}}, "size": 30}
        for la, lo in _centers(8, 3)]


def _check_band(docs, bodies):
    """No document lies within the distance band of a bound of these
    requests (then the packages' last bits cannot split a mask)."""
    pts = _points(docs)
    for b in bodies:
        leaf = b["query"].get("bool", {}).get("filter", [{}])[0]
        for kind in ("geo_distance", "geo_distance_range"):
            spec = leaf.get(kind)
            if spec is None or "location" not in spec:
                continue
            q = parse_query({kind: spec})
            d = haversine64(pts[:, 0], pts[:, 1], np.float32(q.lat),
                            np.float32(q.lon))
            for bound in (getattr(q, k, None) for k in (
                    "distance_m", "gte_m", "gt_m", "lte_m", "lt_m")):
                if bound:
                    assert not (np.abs(d - bound) < DIST_BAND * bound).any()


@pytest.mark.parametrize("name", list(BATCHES))
def test_geo_batches_match_jax(shards, name):
    """One batch through shard 0 (two segments and a delete)."""
    js, ps, docs = shards
    bodies = BATCHES[name]
    _check_band(docs, bodies)
    j, p = js[0], ps[0]
    want = j.query_phase_batch([jax_parse_search_request(b) for b in bodies])
    got = p.query_phase_batch([parse_search_request(b) for b in bodies])
    assert (got is None) == (want is None)
    if want is None:
        want = [j.query_phase(jax_parse_search_request(b)) for b in bodies]
        got = [p.query_phase(parse_search_request(b)) for b in bodies]
    for g, w in zip(got, want):
        _assert_same(g, w, RTOL)
    if name != "not_geo_field":
        assert any(w.total for w in want), "nothing matched"
    else:
        assert not any(w.total for w in want)


@pytest.mark.parametrize("name", ["geo_distance", "shape_intersects"])
def test_geo_post_filter_alone_matches_jax(shards, name):
    """query_phase on its own (the per-segment path) with the geo leaf as
    a post_filter over a match."""
    js, ps, _ = shards
    body = BATCHES[name][0]
    query = body["query"]
    leaf = query["bool"]["filter"][0] if "bool" in query else query
    req = {"query": {"match": {"body": "alpha"}}, "post_filter": leaf,
           "size": 10}
    got = ps[1].query_phase(parse_search_request(req))
    _assert_same(got, js[1].query_phase(jax_parse_search_request(req)), RTOL)
    assert got.total


def test_geohash_cell_reference_case(shards):
    """tests/test_query_dsl3.py's case: the cell of (10, 10) at length 4
    with its neighbours holds the doc at (10, 10) and nothing of the
    clusters."""
    js, ps, docs = shards
    gh = geohash_encode(10.0, 10.0, 4)
    body = {"query": {"geohash_cell": {"location": {"geohash": gh},
                                       "neighbors": True}}, "size": 5}
    got = ps[1].query_phase(parse_search_request(body))
    want = js[1].query_phase(jax_parse_search_request(body))
    _assert_same(got, want, RTOL)
    assert got.total == 1
    assert ps[1].reader.doc_id(int(got.doc_ids[0])) == \
        f"1-{len(docs) - 1 - len(docs) // 2}"


@pytest.mark.parametrize("body", [
    {"geohash_cell": {"pt": {"lat": 1.0, "lon": 2.0}, "precision": 3}},
    {"geohash_cell": {"pt": [2.0, 1.0], "precision": "50km",
                      "neighbors": True}},
    {"geohash_cell": {"pt": "u0vz1", "precision": 3}},
    {"geohash_filter": {"pt": {"geohash": "u0vz1b"}, "_cache": True}},
    {"geo_distance_range": {"_cache": True, "from": "1km", "to": "2km",
                            "pin": {"lat": 1.0, "lon": 2.0}}},
], ids=["point", "array_km", "string", "filter_alias", "cache_noise"])
def test_geo_parsers_match_jax(body):
    assert parse_query(body).__dict__ == jax_parse_query(body).__dict__


@pytest.mark.parametrize("body", [
    {"geohash_cell": {"precision": 3}},
    {"geohash_cell": {"pt": {"lat": 1.0}}},
    {"geo_distance_range": {"from": "1km", "to": "2km"}},
    {"geo_polygon": {"pt": {"points": [{"lat": 0, "lon": 0},
                                       {"lat": 1, "lon": 1}]}}},
], ids=["no_field", "bad_point", "range_no_field", "short_polygon"])
def test_geo_parse_errors_match_jax(body):
    with pytest.raises(Exception) as want:
        jax_parse_query(body)
    with pytest.raises(QueryParsingError) as got:
        parse_query(body)
    assert type(want.value).__name__ == "QueryParsingError"
    assert str(got.value) == str(want.value)


def test_geo_shape_mapper_matches_jax():
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    for t in TEMPLATES + [QUERY_SHAPES["circle"]]:
        src = {"area": t}
        got = ms.document_mapper("_doc").parse("1", src).fields["area"].shape
        want = jms.document_mapper("_doc").parse("1", src).fields["area"].shape
        assert got == want
    for bad in ({"type": "polygon", "coordinates": [[[0, 0], [1, 1]]]},
                [1.0, 2.0], {"type": "blob"}):
        with pytest.raises(JaxMapperParsingError) as w:
            jms.document_mapper("_doc").parse("1", {"area": bad})
        with pytest.raises(MapperParsingError) as g:
            ms.document_mapper("_doc").parse("1", {"area": bad})
        assert str(g.value) == str(w.value)


GEO_AGGS = {
    "grid": {"geohash_grid": {"field": "location", "precision": 4},
             "aggs": {"c": {"geo_centroid": {"field": "location"}}}},
    "grid_small": {"geohash_grid": {"field": "location", "precision": "200km",
                                    "size": 3}},
    "rings": {"geo_distance": {"field": "location", "origin": "55,7",
                               "unit": "km", "ranges": [
                                   {"to": 100}, {"from": 100, "to": 200},
                                   {"from": 200, "to": 400}]}},
    "rings_m": {"geo_distance": {"field": "location",
                                 "origin": {"lat": 0.0, "lon": 179.6},
                                 "ranges": [{"to": 150000},
                                            {"from": 150000}]},
                "aggs": {"b": {"geo_bounds": {"field": "location"}}}},
    "bounds": {"geo_bounds": {"field": "location"}},
    "centroid": {"geo_centroid": {"field": "location"}},
    "not_geo": {"geohash_grid": {"field": "tag"}},
}


@pytest.mark.parametrize("query", [
    {"match": {"body": "alpha"}},
    {"geo_distance": {"distance": "400km", "location": "55,7"}},
], ids=["match", "geo_distance"])
def test_geo_aggs_match_jax(shards, query):
    js, ps, _ = shards
    body = {"query": query, "size": 3, "aggs": GEO_AGGS}
    jreq, req = jax_parse_search_request(body), parse_search_request(body)
    jres = [s.query_phase(jreq) for s in js]
    res = [s.query_phase(req) for s in ps]
    for r, jr in zip(res, jres):
        assert_same(r.agg_partials, jr.agg_partials)
    got = controller.merge_responses("idx", req, res, ps, 0.0, req.aggs)
    want = jax_controller.merge_responses("idx", jreq, jres, js, 0.0,
                                          jreq.aggs)
    assert_same(got["aggregations"], want["aggregations"])
    aggs = got["aggregations"]
    assert aggs["grid"]["buckets"] and aggs["rings"]["buckets"][0][
        "doc_count"] and aggs["centroid"]["count"]
    assert aggs["not_geo"]["buckets"] == []


# ---------------------------------------------------------------------------
# the percolator
# ---------------------------------------------------------------------------

PERC_MAPPINGS = {"_doc": MAPPING}
RELATIONS = ("intersects", "disjoint", "within", "contains")


def _registrations(n=12, seed=41):
    """geo_distance, geo_bounding_box inside a bool with a match, and
    geohash_cell with neighbours, in turn."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        la, lo = 55.0 + rng.uniform(-1.5, 1.5), 7.0 + rng.uniform(-1.5, 1.5)
        if i % 3 == 0:
            qq = {"geo_distance": {
                "distance": f"{int(rng.integers(20, 200))}km",
                "location": {"lat": la, "lon": lo}}}
        elif i % 3 == 1:
            qq = {"bool": {"must": [{"match": {"body": VOCAB[i % 8]}}],
                           "filter": [{"geo_bounding_box": {"location": {
                               "top_left": {"lat": la + 1, "lon": lo - 1},
                               "bottom_right": {"lat": la - 1,
                                                "lon": lo + 1}}}}]}}
        else:
            qq = {"geohash_cell": {"location": {"lat": la, "lon": lo},
                                   "precision": 2, "neighbors": True}}
        out[f"g{i}"] = {"query": qq, "group": f"g{i % 3}"}
    return out


def _shape_registrations(seed=43):
    """geo_shape registrations, one a relation, of an envelope or a hole
    polygon placed so each probe's area meets some of them."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, rel in enumerate(RELATIONS):
        la, lo = 55.0 + rng.uniform(-0.5, 0.5), 7.0 + rng.uniform(-0.5, 0.5)
        shape = QUERY_SHAPES["hole"] if i % 2 else QUERY_SHAPES["envelope"]
        out[f"s{i}"] = {"query": {"geo_shape": {"area": {
            "shape": translate(shape, la - 55.0, lo - 7.0),
            "relation": rel}}}}
    return out


def _probes(n=3, seed=42):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        la, lo = 55.0 + rng.uniform(-1, 1), 7.0 + rng.uniform(-1, 1)
        out.append({"body": " ".join(rng.choice(VOCAB, 4)),
                    "location": {"lat": la, "lon": lo},
                    "area": translate(TEMPLATES[(i * 3) % len(TEMPLATES)],
                                      la - 0.3, lo + 0.2)})
    return out


def _metas(name, percs):
    return (IndexMetadata(name=name, number_of_shards=1,
                          number_of_replicas=0, mappings=PERC_MAPPINGS,
                          percolators=percs, uuid="g1", version=1),
            types.SimpleNamespace(name=name, uuid="g1", settings={},
                                  mappings=PERC_MAPPINGS, percolators=percs,
                                  version=1))


def _same_matches(got, want):
    assert got["total"] == want["total"]
    assert [m["_id"] for m in got["matches"]] == \
        [m["_id"] for m in want["matches"]]
    for gm, wm in zip(got["matches"], want["matches"]):
        np.testing.assert_allclose(gm["_score"], wm["_score"], rtol=RTOL)


@pytest.fixture
def fresh_registries():
    jax_perc.clear_registries()
    percolator.clear_registries()
    yield
    jax_perc.clear_registries()
    percolator.clear_registries()


def test_geo_point_percolation_matches_jax(fresh_registries):
    """geo_point registrations ride the fused lanes (K17 on the probe's
    one-doc segment): percolate_many, percolate and percolate_serial
    against the JAX package's fused percolate_many."""
    jmeta, pmeta = _metas("geo_perc", _registrations())
    docs = _probes()
    items = [{"doc": d, "score": True} for d in docs]
    want_many = jax_perc.percolate_many(jmeta, items)
    got_many = percolator.percolate_many(pmeta, items, device="cpu")
    for d, g_many, want in zip(docs, got_many, want_many):
        for got in (g_many,
                    percolator.percolate(pmeta, d, score=True, device="cpu"),
                    percolator.percolate_serial(pmeta, d, score=True,
                                                device="cpu")):
            _same_matches(got, want)
    assert sum(w["total"] for w in want_many)
    reg = percolator.registry_for(pmeta, device="cpu")
    assert reg.stats["fallback_queries"] == 0


def test_geo_registration_on_a_field_without_points(fresh_registries):
    """A geo_distance registration on a text field (formerly refused by the
    port's registry) matches no probe, as in the JAX package."""
    percs = {"ok": {"query": {"match": {"body": "alpha"}}},
             "geo": {"query": {"bool": {"should": [{"geo_distance": {
                 "distance": "10km", "body": "40,-70"}}]}}}}
    jmeta, pmeta = _metas("geo_none", percs)
    doc = {"body": "alpha beta", "location": {"lat": 40.0, "lon": -70.0}}
    want = jax_perc.percolate(jmeta, doc, score=True)
    got = percolator.percolate(pmeta, doc, score=True, device="cpu")
    _same_matches(got, want)
    assert [m["_id"] for m in got["matches"]] == ["ok"]


def test_geo_shape_percolation_matches_jax(fresh_registries):
    """geo_shape registrations run on the eager lane (K18), as in the JAX
    package. The JAX percolator re-traces its shape body on every call (~5
    s a registration and probe on a CPU), so the expected matches come
    from the JAX body itself, jitted: ``shape_relation`` of the probe's
    rings (the JAX mapper's) against each registration's shape."""
    percs = _shape_registrations()
    _, pmeta = _metas("geo_shape_perc", percs)
    docs = _probes()
    got_many = percolator.percolate_many(
        pmeta, [{"doc": d} for d in docs], device="cpu")
    # the probes' rings as the JAX mapper makes them, one row a probe
    jms = JaxMapperService()
    jms.merge("_doc", MAPPING)
    rings = [jms.document_mapper("_doc").parse("p", d).fields["area"].shape
             for d in docs]
    v = max(len(r[0]) for r in rings)
    lats, lons = np.zeros((len(docs), v), np.float32), \
        np.zeros((len(docs), v), np.float32)
    rid, area = np.full((len(docs), v), -1, np.int32), \
        np.zeros((len(docs), v), bool)
    for i, (rl, ro, rr, ra) in enumerate(rings):
        lats[i, :len(rl)], lons[i, :len(ro)] = rl, ro
        rid[i, :len(rr)], area[i, :len(ra)] = rr, ra
    nv = np.asarray([len(r[0]) - 1 for r in rings], np.int32)
    col = tuple(jnp.asarray(a) for a in (lats, lons, nv,
                                         np.ones(len(docs), bool), rid,
                                         area))
    want = [set() for _ in docs]
    for qid, reg in percs.items():
        spec = reg["query"]["geo_shape"]["area"]
        ql, qo, qr, qa = jax_geoshape_utils.parse_shape_rings(spec["shape"])
        m = jax.jit(lambda *a: jax_geoshape.shape_relation(
            *a, np.asarray(qr, np.int32), np.asarray(qa, bool),
            spec["relation"]))(*col, jnp.asarray(ql, jnp.float32),
                               jnp.asarray(qo, jnp.float32))
        for i in np.nonzero(np.asarray(m))[0]:
            want[i].add(qid)
    hits = 0
    for d, g_many, w in zip(docs, got_many, want):
        for got in (g_many, percolator.percolate(pmeta, d, device="cpu"),
                    percolator.percolate_serial(pmeta, d, device="cpu")):
            assert {m["_id"] for m in got["matches"]} == w
        hits += len(w)
    assert 0 < hits < len(percs) * len(docs)
    reg = percolator.registry_for(pmeta, device="cpu")
    assert reg.stats["fallback_queries"] > 0
