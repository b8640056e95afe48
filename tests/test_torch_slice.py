"""The port's main path against the JAX package's, end to end on the CPU:
the same documents indexed into both packages' Engine, the same ``match``
requests through ``ShardSearcher.query_phase_batch`` and ``fetch_phase``.
Totals, ids and fetched hits must be equal, scores to 2 ulp."""

import numpy as np
import pytest

from elasticsearch_tpu.index.device_reader import (
    device_reader_for as jax_device_reader_for)
from elasticsearch_tpu.index.engine import Engine as JaxEngine
from elasticsearch_tpu.index.segment import Segment as JaxSegment
from elasticsearch_tpu.mapping import MapperService as JaxMapperService
from elasticsearch_tpu.search.phase import (
    ShardSearcher as JaxShardSearcher,
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu_torch.common.errors import (
    NotPortedError, QueryParsingError)
from elasticsearch_tpu_torch.index import carry
from elasticsearch_tpu_torch.index.device_reader import (
    DeviceReader, device_reader_for)
from elasticsearch_tpu_torch.index.engine import Engine, SearcherView
from elasticsearch_tpu_torch.index.segment import Segment
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)

RTOL = 2.4e-7   # 2 ulp of f32
MAPPING = {"properties": {"body": {"type": "text"},
                          "tag": {"type": "keyword"}}}
VOCAB = [f"w{i:02d}" for i in range(40)]

#: 8 requests in three batches of one plan signature each (the reference
#: batches only same-signature requests): OR with varied boosts and sizes
#: (one beyond the hit count), operator and, minimum_should_match
BATCHES = [
    [{"query": {"match": {"body": "w01 w02"}}, "size": 10},
     {"query": {"match": {"body": {"query": "w03 w07",
                                   "boost": 2.5}}}, "size": 5},
     {"query": {"match": {"body": "w00 w39"}}, "size": 500},
     {"query": {"match": {"body": "w11 w11"}}, "size": 3, "from": 1}],
    [{"query": {"match": {"body": {"query": "w01 w02",
                                   "operator": "and"}}}, "size": 20},
     {"query": {"match": {"body": {"query": "w05 w06",
                                   "operator": "and"}}}, "size": 7}],
    [{"query": {"match": {"body": {"query": "w01 w02 w03",
                                   "minimum_should_match": 2}}},
      "size": 15},
     {"query": {"match": {"body": {"query": "w04 w08 w09",
                                   "minimum_should_match": "67%"}}},
      "size": 9}],
]


def _docs(seed=7, n=300):
    rng = np.random.default_rng(seed)
    # Zipf-like word choice so some terms are common, some rare
    p = 1.0 / np.arange(1, len(VOCAB) + 1)
    p /= p.sum()
    return [{"body": " ".join(rng.choice(VOCAB, size=int(rng.integers(1, 16)),
                                         p=p)),
             "tag": f"t{i % 3}"} for i in range(n)]


def _engines(tmp_path, docs, mode):
    """(jax engine, port engine, jax mapper, port mapper), filled the same
    way: per-doc index with two refreshes, or one installed packed segment;
    then a delete."""
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    jeng = JaxEngine(tmp_path / "jax", jms)
    eng = Engine(tmp_path / "torch", ms)
    if mode == "index":
        for e in (jeng, eng):
            for i, d in enumerate(docs):
                e.index(str(i), d)
                if i == len(docs) // 2:
                    e.refresh()
            e.refresh()
    else:
        # one packed segment per package, built from the same columns
        from elasticsearch_tpu_torch.models.bm25 import PackedTextIndex
        texts = [d["body"] for d in docs]
        from elasticsearch_tpu_torch.analysis.analyzers import BUILTIN_ANALYZERS
        idx = PackedTextIndex.from_texts(texts, BUILTIN_ANALYZERS["standard"],
                                         pad_docs=512)
        terms = sorted(idx.terms)
        rank = {t: r for r, t in enumerate(terms)}
        remap = np.array([rank[t] for t in idx.terms], np.int32)
        uterms = np.where(idx.uterms >= 0, remap[np.maximum(idx.uterms, 0)],
                          -1).astype(np.int32)
        order = np.argsort(np.where(uterms >= 0, uterms, 1 << 30), axis=1)
        uterms = np.take_along_axis(uterms, order, 1)
        utf = np.take_along_axis(idx.utf, order, 1)
        df = np.zeros(len(terms), np.int32)
        df[remap] = idx.df[:len(terms)]
        sources = docs + [{}] * (512 - len(docs))
        ids = [str(i) for i in range(len(docs))] + [""] * (512 - len(docs))
        for e, seg_cls in ((jeng, JaxSegment), (eng, Segment)):
            e.install_segment(seg_cls.from_packed_text(
                0, "body", terms=terms, tokens=None, uterms=uterms, utf=utf,
                doc_len=idx.doc_len, df=df, num_docs=len(docs),
                ids=list(ids), sources=list(sources)))
    for e in (jeng, eng):
        e.delete("5")
        e.refresh()
    return jeng, eng, jms, ms


def _assert_same(got, want):
    assert got.total == want.total
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=RTOL, atol=0)


def _assert_hits_same(got, want):
    """Fetched hits equal, each _score to the scores' 2 ulp."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "_score"} == \
            {k: v for k, v in w.items() if k != "_score"}
        np.testing.assert_allclose(g["_score"], w["_score"], rtol=RTOL,
                                   atol=0)


@pytest.mark.parametrize("mode", ["index", "install"])
def test_query_phase_batch_and_fetch_match_jax(tmp_path, mode):
    jeng, eng, jms, ms = _engines(tmp_path, _docs(), mode)
    js = JaxShardSearcher(0, jax_device_reader_for(jeng), jms)
    reader = device_reader_for(eng, device="cpu")
    assert len(reader.segments) == (2 if mode == "index" else 1)
    ps = ShardSearcher(0, reader, ms)
    for bodies in BATCHES:
        jreqs = [jax_parse_search_request(b) for b in bodies]
        reqs = [parse_search_request(b) for b in bodies]
        want = js.query_phase_batch(jreqs)
        got = ps.query_phase_batch(reqs)
        assert want is not None and got is not None
        for req, jreq, g, w in zip(reqs, jreqs, got, want):
            _assert_same(g, w)
            positions = list(range(req.from_, len(g.doc_ids)))
            _assert_hits_same(ps.fetch_phase(req, g, "idx", positions),
                              js.fetch_phase(jreq, w, "idx", positions))
    # the deleted doc never comes back
    hit_ids = {h["_id"] for h in ps.fetch_phase(
        reqs[0], got[0], "idx", list(range(len(got[0].doc_ids))))}
    assert "5" not in hit_ids


def test_mixed_signatures_decline_like_jax(tmp_path):
    jeng, eng, jms, ms = _engines(tmp_path, _docs(n=60), "index")
    bodies = [BATCHES[0][0], BATCHES[1][0]]
    js = JaxShardSearcher(0, jax_device_reader_for(jeng), jms)
    ps = ShardSearcher(0, device_reader_for(eng, device="cpu"), ms)
    assert js.query_phase_batch([jax_parse_search_request(b)
                                 for b in bodies]) is None
    assert ps.query_phase_batch([parse_search_request(b)
                                 for b in bodies]) is None
    # ... and each request alone serves through query_phase
    for b in bodies:
        _assert_same(ps.query_phase(parse_search_request(b)),
                     js.query_phase(jax_parse_search_request(b)))


def test_carried_segment_scores_like_jax(tmp_path):
    jeng, _, jms, ms = _engines(tmp_path, _docs(seed=11, n=120), "index")
    view = jeng.acquire_searcher()
    carried = [carry.segment_from_arrays(
        "body", terms=c.terms, uterms=c.uterms, utf=c.utf,
        doc_len=c.doc_len, df=c.df, ids=list(s.ids),
        sources=list(s.sources), live=live, num_docs=s.num_docs,
        total_tokens=c.total_tokens, seg_id=s.seg_id)
        for s, live in zip(view.segments, view.live_masks)
        for c in [s.text_fields["body"]]]
    reader = DeviceReader(SearcherView([c[0] for c in carried],
                                       [c[1] for c in carried], 1),
                          device="cpu")
    ps = ShardSearcher(0, reader, ms)
    js = JaxShardSearcher(0, jax_device_reader_for(jeng), jms)
    bodies = BATCHES[0]
    want = js.query_phase_batch([jax_parse_search_request(b) for b in bodies])
    got = ps.query_phase_batch([parse_search_request(b) for b in bodies])
    for g, w in zip(got, want):
        _assert_same(g, w)


@pytest.mark.parametrize("body,error", [
    ({"query": {"prefix": {"tag": "t"}}}, QueryParsingError),
    ({"query": {"wildcard": {"tag": "t*"}}}, QueryParsingError),
    ({"query": {"match_all": {}}, "aggs": {"a": {"scripted_metric": {
        "map_script": "_agg.x = 1"}}}}, NotPortedError),
    ({"query": {"match_all": {}}, "sort": [{"tag": "asc"}]}, NotPortedError),
    ({"query": {"match": {"body": "w01"}}, "terminate_after": 5},
     NotPortedError),
])
def test_unported_request_is_refused(tmp_path, body, error):
    """What the slice does not serve is refused with a typed error, never
    served some other way."""
    _, eng, _, ms = _engines(tmp_path, _docs(n=20), "index")
    ps = ShardSearcher(0, device_reader_for(eng, device="cpu"), ms)
    with pytest.raises(error):
        ps.query_phase(parse_search_request(body))


@pytest.mark.parametrize("extra", [
    {"post_filter": {"match": {"body": "w02"}}},
    {"min_score": 2.0},
    {"search_after": [1.5, 40]},
    {"query": {"match_none": {}}},
])
def test_query_phase_one_request_matches_jax(tmp_path, extra):
    """query_phase alone: the per-segment path (post_filter, min_score,
    search_after, const-free plans) against the JAX package's."""
    jeng, eng, jms, ms = _engines(tmp_path, _docs(n=80), "index")
    body = {"query": {"match": {"body": "w01 w03"}}, "size": 30, **extra}
    js = JaxShardSearcher(0, jax_device_reader_for(jeng), jms)
    ps = ShardSearcher(0, device_reader_for(eng, device="cpu"), ms)
    _assert_same(ps.query_phase(parse_search_request(body)),
                 js.query_phase(jax_parse_search_request(body)))
