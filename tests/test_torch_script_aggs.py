"""The script aggregations through the port against the JAX package, on the
CPU: two shards (the documents of ``test_torch_aggs``, split in halves)
indexed into both packages' Engine, each request through each package's
``ShardSearcher.query_phase`` and ``controller.merge_responses``.

* ``scripted_metric`` with an expression map script (K12's plain version
  over each segment's matching rows), a constant one, and the interpreted
  form (init, map, combine and reduce scripts; no reduce; a map script the
  expression grammar cannot take);
* ``bucket_script`` and ``bucket_selector`` under a histogram and a terms
  agg, a boolean selector (after ``tests/test_aggs_breadth.py``), buckets a
  script fails on (skipped), a bucket with a missing path;
* ``top_hits`` with ``script_fields`` and ``highlight``, which both
  packages accept and render neither of.

Shard partials and the reduced output must be equal (``assert_same``: sums
to 1e-5 as in ``test_torch_aggs``). Values through ``log`` agree to 1e-6
relative: XLA's CPU log and the C library's differ by an ulp.
"""

import numpy as np
import pytest

from elasticsearch_tpu.index.device_reader import (
    device_reader_for as jax_device_reader_for)
from elasticsearch_tpu.index.engine import Engine as JaxEngine
from elasticsearch_tpu.mapping import MapperService as JaxMapperService
from elasticsearch_tpu.search import controller as jax_controller
from elasticsearch_tpu.search.phase import (
    ShardSearcher as JaxShardSearcher,
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu_torch.index.device_reader import device_reader_for
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search import controller
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)
from test_torch_aggs import MAPPING, _agg_docs, assert_same

TRANSCENDENTAL_RTOL = 1e-6


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """(jax searchers, port searchers): two shards, the second with two
    segments and a delete."""
    tmp = tmp_path_factory.mktemp("script_aggs")
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    docs = _agg_docs()
    js, ps = [], []
    for si, part in enumerate((docs[:70], docs[70:])):
        jeng, eng = JaxEngine(tmp / f"jax{si}", jms), \
            Engine(tmp / f"torch{si}", ms)
        for e in (jeng, eng):
            for i, d in enumerate(part):
                e.index(f"{si}-{i}", d)
                if si and i == 40:
                    e.refresh()
            e.refresh()
            if si:
                e.delete("1-3")
                e.refresh()
        js.append(JaxShardSearcher(si, jax_device_reader_for(jeng), jms))
        ps.append(ShardSearcher(si, device_reader_for(eng, device="cpu"),
                                ms))
    return js, ps


def _hist(sub_pipes, interval=100):
    return {"histogram": {"field": "price", "interval": interval}, "aggs": {
        "p": {"sum": {"field": "price"}}, **sub_pipes}}


def _bs(paths, script):
    return {"bucket_script": {"buckets_path": paths, "script": script}}


def _sel(paths, script):
    return {"bucket_selector": {"buckets_path": paths, "script": script}}


CASES = {
    "scripted_metric_expression": ({
        "sm": {"scripted_metric": {
            "map_script": "doc['price'].value * 2 + doc['price'].empty"}},
        "sm0": {"scripted_metric": {"map_script": "1 / 3"}},
    }, 0.0),
    "scripted_metric_log_params": ({
        "sm": {"scripted_metric": {
            "map_script": "log(abs(doc['price'].value) + 1) * params.k",
            "params": {"k": 2}}},
    }, TRANSCENDENTAL_RTOL),
    "scripted_metric_interpreted": ({
        "profit": {"scripted_metric": {
            "init_script": "_agg.t = []",
            "map_script": "_agg.t.add(doc['tag'].value == 'g1' ? "
                          "doc['price'].value : -1 * doc['price'].value)",
            "combine_script": "def s = 0; for (x in _agg.t) { s += x }; "
                              "return s",
            "reduce_script": "def s = 0; for (a in _aggs) { s += a }; "
                             "return s"}},
        "parts": {"scripted_metric": {
            "init_script": "_agg.c = 0",
            "map_script": "_agg.c += 1"}},
        "lone_map": {"scripted_metric": {"map_script": "_agg.x = 1"}},
    }, 0.0),
    "bucket_script_histogram": ({
        "h": _hist({"double": _bs({"v": "p"}, "v * 2"),
                    "ratio": _bs({"v": "p", "c": "_count"},
                                 "v / c + (c > 3)"),
                    "odd": _bs({"v": "p", "c": "_count"},
                               "v / (c - 24)"),
                    "missing": _bs({"m": "nope"}, "m + 1")}),
    }, 0.0),
    "bucket_script_log": ({
        "h": _hist({"lg": _bs({"v": "p", "c": "_count"},
                              "log(abs(v) + 1) * c + min(v, 10)")}),
    }, TRANSCENDENTAL_RTOL),
    "bucket_selector": ({
        "h": _hist({"keep": _sel({"v": "p"}, "v > 500")}),
        "h2": _hist({"keep": _sel({"v": "p", "c": "_count"},
                                  "v > 5 and c >= 4")}, interval=50),
        "h3": _hist({"keep": _sel({"c": "_count"}, "_score")}),
        "h4": _hist({"keep": _sel({"v": "p"}, "sqrt(abs(v)) > 20")}),
    }, 0.0),
    "terms_pipelines": ({
        "tg": {"terms": {"field": "tag"}, "aggs": {
            "avg_p": {"avg": {"field": "price"}},
            "scaled": _bs({"a": "avg_p", "c": "_count"}, "a * c / 100"),
            "big": _sel({"c": "_count"}, "c > 20")}},
    }, 0.0),
}


def _run(shards, aggs, query=None):
    js, ps = shards
    body = {"query": query or {"match": {"t": "alpha"}}, "size": 3,
            "aggs": aggs}
    jreq, req = jax_parse_search_request(body), parse_search_request(body)
    jres = [s.query_phase(jreq) for s in js]
    res = [s.query_phase(req) for s in ps]
    return res, jres, \
        controller.merge_responses("idx", req, res, ps, 0.0, req.aggs), \
        jax_controller.merge_responses("idx", jreq, jres, js, 0.0,
                                       jreq.aggs)


@pytest.mark.parametrize("name", list(CASES))
def test_script_aggs_match_jax(shards, name):
    aggs, rtol = CASES[name]
    res, jres, got, want = _run(shards, aggs)
    for r, jr in zip(res, jres):
        assert_same(r.agg_partials, jr.agg_partials, rtol=rtol)
    assert_same(got["aggregations"], want["aggregations"], rtol=rtol)


def test_pipelines_render_what_they_should(shards):
    """The cases above are not vacuous: scripts rendered into buckets,
    skipped where they fail, and the selectors kept some buckets."""
    _, _, got, _ = _run(shards, CASES["bucket_script_histogram"][0])
    buckets = got["aggregations"]["h"]["buckets"]
    assert all("double" in b and "ratio" in b and "missing" not in b
               for b in buckets)
    assert any(b["doc_count"] == 24 for b in buckets)
    assert all(("odd" in b) == (b["doc_count"] != 24) for b in buckets)
    _, _, got, _ = _run(shards, CASES["bucket_selector"][0])
    kept = [len(got["aggregations"][h]["buckets"]) for h in
            ("h", "h2", "h3", "h4")]
    assert 0 < kept[0] < 6 and kept[1] > 0 and kept[2] == 0 and kept[3] > 0


def test_top_hits_with_script_fields_and_highlight(shards):
    aggs = {"th": {"top_hits": {
        "size": 4, "highlight": {"fields": {"t": {}}},
        "script_fields": {"x": {"script": "doc['price'].value"}}}}}
    res, jres, got, want = _run(shards, aggs, {"match": {"t": "beta"}})
    for r, jr in zip(res, jres):
        g, w = r.agg_partials["th"], jr.agg_partials["th"]
        assert [h["_id"] for h in g["hits"]] == [h["_id"] for h in w["hits"]]
        assert [set(h) for h in g["hits"]] == [set(h) for h in w["hits"]]
    gh = got["aggregations"]["th"]["hits"]
    wh = want["aggregations"]["th"]["hits"]
    assert gh["total"] == wh["total"] and len(gh["hits"]) == 4
    assert [h["_id"] for h in gh["hits"]] == [h["_id"] for h in wh["hits"]]
    np.testing.assert_allclose([h["_score"] for h in gh["hits"]],
                               [h["_score"] for h in wh["hits"]],
                               rtol=2.4e-7)
