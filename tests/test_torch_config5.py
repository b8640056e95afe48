"""BASELINE config 5's query_then_fetch through the port's coordinator
against the JAX package's, on the CPU, and a page past K2's one-block k.

* 8 shard engines in each package (about 50 documents a shard; shards 2i and
  2i + 1 hold the same documents, so equal scores tie across shards and go
  by shard order), each shard scoring with its own statistics (no DFS):
  every shard's ``query_phase`` (the batched arm, or one request at a time
  with aggregations), then each package's ``controller.merge_responses``
  (sort_docs, the fetch phase on the shards that own the page, the
  aggregation reduce). Pages at from 0, mid-list and past the end. Hits,
  totals, max_score and the reduced aggregations must be equal: scores to
  2 ulp (the BM25 arithmetic's bar, ``tests/test_torch_slice.py``), sums in
  the aggregations to the tolerances of ``tests/test_torch_aggs.py``.
* ``from + size`` = 20,100 over one segment of 23,000 docs built from numpy
  arrays in both packages: the shard's top-k at k = 20,100 (above
  ``topk.CHUNK``, where the kernel K2 sorts tiles and merges them) must
  give the JAX package's totals, ids and scores.
"""

import numpy as np
import pytest

from elasticsearch_tpu.index.device_reader import (
    device_reader_for as jax_device_reader_for)
from elasticsearch_tpu.index.engine import Engine as JaxEngine
from elasticsearch_tpu.index.segment import Segment as JaxSegment
from elasticsearch_tpu.mapping import MapperService as JaxMapperService
from elasticsearch_tpu.search import controller as jax_controller
from elasticsearch_tpu.search.phase import (
    ShardSearcher as JaxShardSearcher,
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu_torch.index.device_reader import device_reader_for
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.segment import Segment
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import topk
from elasticsearch_tpu_torch.search import controller
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)
from test_torch_aggs import assert_same

RTOL = 2.4e-7   # 2 ulp of f32
N_SHARDS = 8
MAPPING = {"properties": {"body": {"type": "text", "analyzer": "whitespace"},
                          "cat": {"type": "keyword"},
                          "rank": {"type": "double"}}}
VOCAB = [f"w{i:02d}" for i in range(10)]
AGGS = {"by_cat": {"terms": {"field": "cat", "size": 3}},
        "st": {"extended_stats": {"field": "rank"}},
        "hi": {"histogram": {"field": "rank", "interval": 5}},
        "rg": {"range": {"field": "rank", "ranges": [
            {"to": 25}, {"from": 25, "to": 75}, {"from": 75}]}},
        "vc": {"value_count": {"field": "cat"}}}


def _shard_docs(pair: int, n=50):
    """One shard pair's documents: few terms and lengths, so scores tie."""
    rng = np.random.default_rng(100 + pair)
    docs = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(VOCAB[:6 + pair],
                                         size=int(rng.integers(1, 5)))),
             "rank": float(rng.integers(0, 20)) * 5.0}
        if i % 6:
            d["cat"] = f"cat{int(rng.integers(0, 5)):02d}"
        docs.append(d)
    return docs


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """(jax searchers, port searchers), shard by shard over the same docs."""
    tmp = tmp_path_factory.mktemp("config5")
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    js, ps = [], []
    for si in range(N_SHARDS):
        jeng = JaxEngine(tmp / f"jax{si}", jms)
        eng = Engine(tmp / f"torch{si}", ms)
        for e in (jeng, eng):
            for i, d in enumerate(_shard_docs(si // 2)):
                e.index(f"{si}-{i}", d)
            e.refresh()
        js.append(JaxShardSearcher(si, jax_device_reader_for(jeng), jms))
        ps.append(ShardSearcher(si, device_reader_for(eng, device="cpu"), ms))
    return js, ps


def _search(searchers, req, merge):
    results = [s.query_phase(req) for s in searchers]
    return merge("idx", req, results, searchers, 0.0, req.aggs)


def _assert_same_response(got, want):
    assert got["hits"]["total"] == want["hits"]["total"]
    gmax, wmax = got["hits"]["max_score"], want["hits"]["max_score"]
    assert (gmax is None) == (wmax is None)
    if gmax is not None:
        np.testing.assert_allclose(gmax, wmax, rtol=RTOL)
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert [(h["_index"], h["_id"], h["_source"]) for h in gh] == \
        [(h["_index"], h["_id"], h["_source"]) for h in wh]
    np.testing.assert_allclose([h["_score"] for h in gh],
                               [h["_score"] for h in wh], rtol=RTOL)
    assert ("aggregations" in got) == ("aggregations" in want)
    if "aggregations" in got:
        assert_same(got["aggregations"], want["aggregations"])


@pytest.mark.parametrize("page", [(0, 10), (37, 25), (1000, 10)])
@pytest.mark.parametrize("with_aggs", [False, True])
def test_coordinator_merge_matches_jax(shards, page, with_aggs):
    js, ps = shards
    body = {"query": {"match": {"body": "w01 w03 w05"}}, "from": page[0],
            "size": page[1]}
    if with_aggs:
        body["aggs"] = AGGS
    want = _search(js, jax_parse_search_request(body),
                   jax_controller.merge_responses)
    got = _search(ps, parse_search_request(body), controller.merge_responses)
    _assert_same_response(got, want)
    if page[0] >= 1000:
        assert got["hits"]["hits"] == []
    if with_aggs:
        assert got["aggregations"]["vc"]["value"] > 0


def test_ties_across_shards_go_by_shard_order(shards):
    """Shards 2i and 2i + 1 hold the same docs: the top score's tie group
    holds one pair's docs, shard 2i's first, then the same docs of shard
    2i + 1, each in position order, as TopDocs.merge orders them."""
    _, ps = shards
    req = parse_search_request({"query": {"match": {"body": "w00"}},
                                "size": 200})
    res = controller.merge_responses(
        "idx", req, [s.query_phase(req) for s in ps], ps, 0.0, [])
    hits = res["hits"]["hits"]
    top = [h["_id"].split("-") for h in hits
           if h["_score"] == hits[0]["_score"]]
    shard_of = [int(si) for si, _ in top]
    first = shard_of[0]
    assert first % 2 == 0 and shard_of == sorted(shard_of) and \
        set(shard_of) == {first, first + 1}
    local = [[int(i) for s, i in top if int(s) == si]
             for si in (first, first + 1)]
    assert local[0] == local[1] == sorted(local[0])


def test_assemble_response_reduces_aggs(shards):
    """The serialized twin of the merge reduces each payload's ``aggs``."""
    _, ps = shards
    req = parse_search_request({"query": {"match": {"body": "w02"}},
                                "size": 0, "aggs": AGGS})
    results = [s.query_phase(req) for s in ps]
    payloads = [{"total": r.total, "max_score": r.max_score, "hits": [],
                 "aggs": r.agg_partials} for r in results]
    out = controller.merge_shard_payloads(req, payloads, 0.0, N_SHARDS, [])
    direct = controller.merge_responses("idx", req, results, ps, 0.0,
                                        req.aggs)
    assert out["aggregations"] == direct["aggregations"]
    assert out["hits"]["total"] == direct["hits"]["total"]


# ---------------------------------------------------------------------------
# a page past one block's k
# ---------------------------------------------------------------------------

DEEP_DOCS, DEEP_TERMS = 23_000, [f"d{i}" for i in range(8)]


def _deep_arrays():
    """One segment's packed text columns: 3 of 8 terms a doc, tf 1-2, five
    lengths, so the 4-term query matches ~93% of the docs with heavy ties."""
    rng = np.random.default_rng(20)
    n = DEEP_DOCS
    uterms = np.sort(np.argsort(rng.random((n, len(DEEP_TERMS))), axis=1)
                     [:, :3], axis=1).astype(np.int32)
    utf = rng.integers(1, 3, (n, 3)).astype(np.float32)
    doc_len = (utf.sum(axis=1) + rng.integers(0, 5, n)).astype(np.int32)
    df = np.bincount(uterms.reshape(-1), minlength=len(DEEP_TERMS))
    return uterms, utf, doc_len, df


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("deep")
    uterms, utf, doc_len, df = _deep_arrays()
    ids = [str(i) for i in range(DEEP_DOCS)]
    out = []
    for cls, eng_cls, ms_cls, reader_for, kw in (
            (JaxSegment, JaxEngine, JaxMapperService, jax_device_reader_for,
             {}),
            (Segment, Engine, MapperService, device_reader_for,
             {"device": "cpu"})):
        ms = ms_cls()
        ms.merge("_doc", {"properties": {"body": {
            "type": "text", "analyzer": "whitespace"}}})
        seg = cls.from_packed_text(
            0, "body", terms=DEEP_TERMS, tokens=None, uterms=uterms,
            utf=utf, doc_len=doc_len, df=df, num_docs=DEEP_DOCS, ids=ids)
        eng = eng_cls(tmp / cls.__module__.split(".")[0], ms)
        eng.install_segment(seg, track_versions=False)
        out.append((reader_for(eng, **kw), ms))
    (jr, jms), (pr, pms) = out
    return JaxShardSearcher(0, jr, jms), ShardSearcher(0, pr, pms)


def test_page_past_one_block_k_matches_jax(deep):
    js, ps = deep
    body = {"query": {"match": {"body": "d0 d1 d2 d3"}}, "from": 20_000,
            "size": 100}
    want = js.query_phase(jax_parse_search_request(body))
    got = ps.query_phase(parse_search_request(body))
    assert 20_100 > topk.CHUNK
    assert got.total == want.total > 20_100
    assert len(got.doc_ids) == len(want.doc_ids) == 20_100
    np.testing.assert_array_equal(got.doc_ids, np.asarray(want.doc_ids))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=RTOL, atol=0)
    # the page itself through the coordinator
    req = parse_search_request(body)
    res = controller.merge_responses("idx", req, [got], [ps], 0.0, [])
    assert [h["_id"] for h in res["hits"]["hits"]] == \
        [str(d) for d in got.doc_ids[20_000:]]
