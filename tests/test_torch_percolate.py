"""The percolator through the port against the JAX package, on the CPU.

The same registrations (bench.py's ``reg_body`` mix — a 2-term match, a term
on a keyword, a range on a double — plus sloppy ``match_phrase``, ``bool``
combinations and a ``random_score`` function, the shape-fallback lane) and
the same probe docs go through the port's ``percolate``, ``percolate_many``
and ``percolate_serial`` (``device="cpu"``: K10 and K11's plain versions)
and through the JAX package's serial oracle and one fused ``percolate_many``
call. The JAX side runs as the JAX package's own tests run it; the port's
meta is a ``SimpleNamespace`` built from the same dicts as the JAX
``IndexMetadata``.

Matched ids and totals are identical; scores agree to f32 rounding (the
fused lanes score a batch of queries with one emit, the serial oracle one
query at a time: the same arithmetic, a few ulps apart at most).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster.state import IndexMetadata
from elasticsearch_tpu.ops import percolate as jax_perc_ops
from elasticsearch_tpu.search import percolator as jax_perc
from elasticsearch_tpu_torch.common.errors import NotPortedError
from elasticsearch_tpu_torch.ops import percolate as perc_ops
from elasticsearch_tpu_torch.search import lanes, percolator

RTOL = 1e-6
VOCAB = [f"pw{i:03d}" for i in range(24)]
MAPPINGS = {"_doc": {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "cat": {"type": "keyword"},
    "rank": {"type": "double"},
    "group": {"type": "keyword"}}}}


def _registrations(n=42, seed=77):
    """bench.py's reg_body thirds, with every fourth a sloppy phrase, every
    ninth a bool combination and every thirteenth a random_score function
    (the shape-fallback lane)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        w = VOCAB[int(rng.integers(0, len(VOCAB)))]
        w2 = VOCAB[(i * 7) % len(VOCAB)]
        if i % 13 == 12:
            qq = {"function_score": {"query": {"match": {"body": w}},
                                     "functions": [{"random_score":
                                                    {"seed": 3}}]}}
        elif i % 9 == 8:
            qq = {"bool": {"must": [{"match": {"body": w}}],
                           "should": [{"match_phrase": {"body": {
                               "query": f"{w} {w2}", "slop": 2}}}],
                           "filter": [{"range": {"rank": {"gte": 20}}}]}}
        elif i % 4 == 3:
            qq = {"match_phrase": {"body": {"query": f"{w} {w2}",
                                            "slop": 1 + i % 3}}}
        elif i % 3 == 0:
            qq = {"match": {"body": f"{w} {w2}"}}
        elif i % 3 == 1:
            qq = {"term": {"cat": w}}
        else:
            qq = {"range": {"rank": {"gte": int(rng.integers(0, 90))}}}
        out[f"q{i}"] = {"query": qq, "group": f"g{i % 4}"}
    return out


def _docs(n=8, seed=78):
    rng = np.random.default_rng(seed)
    return [{"body": " ".join(VOCAB[int(j)]
                              for j in rng.integers(0, len(VOCAB), 7)),
             "cat": VOCAB[int(rng.integers(0, len(VOCAB)))],
             "rank": float(rng.integers(0, 100))} for _ in range(n)]


def _metas(percs, name="perc", uuid="u1", version=1):
    jmeta = IndexMetadata(name=name, number_of_shards=1,
                          number_of_replicas=0, mappings=MAPPINGS,
                          percolators=percs, uuid=uuid, version=version)
    pmeta = types.SimpleNamespace(name=name, uuid=uuid, settings={},
                                  mappings=MAPPINGS, percolators=percs,
                                  version=version)
    return jmeta, pmeta


#: one item per probe doc, each with its own response features
FEATURES = [
    {"score": True},
    {"sort": True, "size": 3},
    {"highlight": {"fields": {"body": {}}}, "score": True},
    {"aggs": {"by_group": {"terms": {"field": "group"}}}},
    {"reg_filter": {"term": {"group": "g1"}}, "score": True},
    {"highlight": {"fields": {"body": {"type": "postings"}}}, "size": 4},
    {"sort": True, "score": True,
     "aggs": {"by_group": {"terms": {"field": "group", "size": 2}}}},
    {"reg_filter": {"terms": {"group": ["g0", "g3"]}},
     "highlight": {"fields": {"body": {}}}},
]


@pytest.fixture(scope="module")
def setup():
    jax_perc.clear_registries()
    percolator.clear_registries()
    percs = _registrations()
    jmeta, pmeta = _metas(percs)
    docs = _docs()
    items = [dict(f, doc=d) for f, d in zip(FEATURES, docs)]
    want_many = jax_perc.percolate_many(jmeta, items)
    yield jmeta, pmeta, docs, items, want_many
    jax_perc.clear_registries()
    percolator.clear_registries()


def _assert_same(got, want):
    """Equal totals, ids, highlights and aggregations; scores to f32
    rounding."""
    assert "_exception" not in got and "_exception" not in want, (got, want)
    assert got["total"] == want["total"]
    assert [m["_id"] for m in got["matches"]] == \
        [m["_id"] for m in want["matches"]]
    for g, w in zip(got["matches"], want["matches"]):
        assert set(g) == set(w)
        if "_score" in w:
            np.testing.assert_allclose(g["_score"], w["_score"], rtol=RTOL)
        assert g.get("highlight") == w.get("highlight")
    assert got.get("aggregations") == want.get("aggregations")


def test_reduce_and_pack_bit_equal_to_jax():
    """K10's plain version against the JAX bodies on seeded [L, B, Np]
    lanes: all-false rows, dead rows, NaN and -0.0 included."""
    rng = np.random.default_rng(0)
    lanes_np = []
    for b, n in ((5, 128), (1, 128), (7, 256), (3, 8)):
        scores = rng.normal(size=(b, n)).astype(np.float32)
        mask = rng.random((b, n)) < 0.05
        live = rng.random(n) < 0.9
        mask[0] = False                        # nothing matches
        if b > 1:
            mask[1] = ~live                    # only dead rows match
        if b > 2:
            mask[2, :] = False
            mask[2, np.flatnonzero(live)[:3]] = True
            scores[2, np.flatnonzero(live)[:3]] = -0.0   # only -0.0
        if b > 3:
            hit = np.flatnonzero(live)[5]
            mask[3, hit] = True
            scores[3, hit] = np.nan            # NaN propagates
            scores[4, :] = np.nan              # ... but not from a miss
            mask[4, :] = False
            mask[4, hit] = True
            scores[4, hit] = 2.5
        lanes_np.append((scores, mask, live))
    got = perc_ops.percolate_reduce([
        (torch.from_numpy(s), torch.from_numpy(m), torch.from_numpy(lv))
        for s, m, lv in lanes_np]).numpy()
    want = np.concatenate([np.asarray(jax_perc_ops.pack_match_result_body(
        *jax_perc_ops.match_reduce_body(jnp.asarray(s),
                                        jnp.asarray(m & lv[None, :]))))
        for s, m, lv in lanes_np])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, 1]).sum() == 2
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))
    assert (np.signbit(got[:, 1]) & (got[:, 1] == 0)).sum() == 3
    g_m, g_s = perc_ops.unpack_match_result(got, 4)
    w_m, w_s = jax_perc_ops.unpack_match_result(want, 4)
    np.testing.assert_array_equal(g_m, w_m)
    np.testing.assert_array_equal(g_s.view(np.int32), w_s.view(np.int32))


def test_percolate_and_serial_match_the_jax_serial_oracle(setup):
    jmeta, pmeta, docs, _, _ = setup
    for d in docs:
        want = jax_perc.percolate_serial(jmeta, d, score=True)
        _assert_same(percolator.percolate(pmeta, d, score=True,
                                          device="cpu"), want)
        _assert_same(percolator.percolate_serial(pmeta, d, score=True,
                                                 device="cpu"), want)
    assert percolator.registry_stats("perc", "cpu")["fallback_queries"] > 0


def test_percolate_many_features_match_jax(setup):
    """size, sort, score, highlight, aggs over registration metadata and
    reg_filter, item by item against the JAX fused percolate_many; each
    item alone through ``percolate`` gives the same bits."""
    _, pmeta, _, items, want_many = setup
    got_many = percolator.percolate_many(pmeta, items, device="cpu")
    for it, got, want in zip(items, got_many, want_many):
        _assert_same(got, want)
        kw = {k: v for k, v in it.items() if k != "doc"}
        assert percolator.percolate(pmeta, it["doc"], device="cpu",
                                    **kw) == got
    assert any("highlight" in m for r in got_many for m in r["matches"])
    assert "aggregations" in got_many[3]
    # a reg_filter keeps only its group's registrations
    assert {m["_id"] for m in got_many[4]["matches"]} <= {
        qid for qid, b in pmeta.percolators.items() if b["group"] == "g1"}
    # the serial path's filter, highlight and size agree with the registry
    for it, got in zip(items, got_many):
        if "aggs" in it:
            continue
        kw = {k: v for k, v in it.items() if k != "doc"}
        ser = percolator.percolate_serial(pmeta, it["doc"], device="cpu",
                                          **kw)
        _assert_same(ser, got)


def test_percolate_many_isolates_item_errors(setup):
    _, pmeta, docs, _, _ = setup
    out = percolator.percolate_many(
        pmeta, [{"doc": docs[0]}, {"size": 2}, {"doc": docs[1]}],
        device="cpu")
    assert "_exception" not in out[0] and "_exception" not in out[2]
    assert set(out[1]) == {"_exception"}
    assert "[doc]" in str(out[1]["_exception"])
    with pytest.raises(Exception, match=r"\[doc\]"):
        percolator.percolate(pmeta, None, device="cpu")


def test_register_unregister_touches_exactly_one_bucket(setup):
    _, pmeta, docs, _, _ = setup
    percs = dict(pmeta.percolators)
    meta = types.SimpleNamespace(**{**vars(pmeta), "name": "perc_sync",
                                    "percolators": percs})
    reg = percolator.registry_for(meta, "cpu")
    gens0, inv0 = reg.bucket_generations(), reg.stats["bucket_invalidations"]
    percs2 = dict(percs, qx={"query": {"match": {"body": "pw001 pw002"}},
                             "group": "g0"})
    meta2 = types.SimpleNamespace(**{**vars(meta), "percolators": percs2,
                                     "version": 2})
    reg2 = percolator.registry_for(meta2, "cpu")
    assert reg2 is reg
    gens1 = reg.bucket_generations()
    changed = {s for s in set(gens0) | set(gens1)
               if gens0.get(s, 0) != gens1.get(s, 0)}
    assert len(changed) == 1
    assert reg.stats["bucket_invalidations"] - inv0 == 1
    meta3 = types.SimpleNamespace(**{**vars(meta), "percolators": percs,
                                     "version": 3})
    percolator.registry_for(meta3, "cpu")
    gens2 = reg.bucket_generations()
    assert {s for s in set(gens1) | set(gens2)
            if gens1.get(s, 0) != gens2.get(s, 0)} == changed
    assert reg.stats["bucket_invalidations"] - inv0 == 2
    out = percolator.percolate(meta3, {"body": "pw001 pw002"}, device="cpu")
    assert "qx" not in {m["_id"] for m in out["matches"]}
    # an unchanged metadata syncs nothing and rebuilds nothing
    st = reg.stats_dict()
    percolator.percolate(meta3, docs[0], device="cpu")
    st2 = reg.stats_dict()
    assert st2["syncs"] == st["syncs"] and st2["builds"] == 1
    assert st2["mapper_rebuilds"] == st["mapper_rebuilds"] == 1


@pytest.mark.parametrize("query", [
    {"has_child": {"type": "c", "query": {"match_all": {}}}},
    {"script_score": {"query": {"match_all": {}},
                      "script": {"source": "1"}}},
    {"function_score": {"query": {"match": {"body": "pw001"}},
                        "functions": [{"script_score": {"script": "2"}}]}},
    {"bool": {"should": [{"prefix": {"body": "pw"}}]}},
])
def test_unported_registrations_raise(query):
    percs = {"ok": {"query": {"match": {"body": "pw001"}}},
             "bad": {"query": query}}
    _, pmeta = _metas(percs, name="perc_bad")
    with pytest.raises(NotPortedError):
        percolator.percolate(pmeta, {"body": "pw001"}, device="cpu")


def test_stats_keys(setup):
    _, pmeta, docs, _, _ = setup
    percolator.percolate(pmeta, docs[0], device="cpu")
    st = percolator.registry_stats("perc", "cpu")
    assert set(st) == set(lanes.PERCOLATE_COUNTERS) | {"registered",
                                                       "shape_buckets"}
    assert set(lanes.PERCOLATE_COUNTERS) == \
        set(jax_perc.lanes.PERCOLATE_COUNTERS) - {"breaker_skips"}
    assert st["registered"] == len(pmeta.percolators)
    assert st["fused_queries"] > 0
    assert percolator.all_registry_stats()["perc"]["cpu"] == \
        percolator.registry_stats("perc", "cpu")


def test_a_phrase_longer_than_the_probe_matches_nothing():
    """A registered phrase spanning more positions than the probe doc's
    position matrix is wide matches nothing (the JAX package's shifted
    copies take no shift past the matrix: its percolate raises a shape
    error here, ROADMAP C4)."""
    percs = {"p": {"query": {"match_phrase": {"body": {
                 "query": "pw001 pw002 pw003 pw004 pw005 pw006 pw007 pw008 "
                          "pw009 pw010", "slop": 1}}}},
             "m": {"query": {"match": {"body": "pw001"}}}}
    _, pmeta = _metas(percs, name="perc_long")
    doc = {"body": "pw001 pw002 pw003"}
    for out in (percolator.percolate(pmeta, doc, device="cpu"),
                percolator.percolate_serial(pmeta, doc, device="cpu")):
        assert [m["_id"] for m in out["matches"]] == ["m"]
