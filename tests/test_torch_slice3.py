"""BASELINE configs 2 and 3 through the port against the JAX package, end to
end on the CPU: the same documents indexed into both packages' Engine
(a text field with positions, a ``double``, a ``date`` and a ``keyword``
field), the same bool + match_phrase, filtered bool and function_score
requests through ``ShardSearcher.query_phase_batch`` and ``query_phase``.

Totals must be equal and ids equal up to exact ties. Scores agree to 4 ulp
(rtol 4.8e-7) where the op order is pinned: each clause is within 2 ulp of
the reference (XLA fuses the element-wise chain where eager PyTorch rounds
every operation) and bool adds two such clauses. Function scores that go
through ``log10``/``exp`` agree to 1e-6 relative: XLA's approximations and
the C library's differ by an ulp or two, and the boost mode multiplies that
into the query score.
"""

import numpy as np
import pytest

from elasticsearch_tpu.index.device_reader import (
    device_reader_for as jax_device_reader_for)
from elasticsearch_tpu.index.engine import Engine as JaxEngine
from elasticsearch_tpu.mapping import MapperService as JaxMapperService
from elasticsearch_tpu.search.phase import (
    ShardSearcher as JaxShardSearcher,
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu_torch.common.errors import NotPortedError
from elasticsearch_tpu_torch.index import carry
from elasticsearch_tpu_torch.index.device_reader import (
    DeviceReader, device_reader_for)
from elasticsearch_tpu_torch.index.engine import Engine, SearcherView
from elasticsearch_tpu_torch.index.segment import GeoFieldColumn
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)

PINNED_RTOL = 4.8e-7       # 4 ulp of f32: two 2-ulp clauses added
TRANSCENDENTAL_RTOL = 1e-6
MAPPING = {"properties": {"body": {"type": "text"},
                          "rank": {"type": "double"},
                          "ts": {"type": "date"},
                          "tag": {"type": "keyword"}}}
VOCAB = [f"w{i:02d}" for i in range(12)]


def _docs(seed=5, n=240):
    """A small vocabulary, so phrases recur (overlapping too); rank, tag and
    ts each missing from some docs."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(VOCAB) + 1)
    p /= p.sum()
    docs = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(
            VOCAB, size=int(rng.integers(1, 14)), p=p))}
        if i % 7:
            d["rank"] = float(np.round(rng.uniform(0.0, 100.0), 3))
        if i % 5:
            d["tag"] = f"t{i % 3}"
        if i % 4:
            d["ts"] = f"2015-01-{1 + i % 28:02d}"
        docs.append(d)
    return docs


def _engines(tmp_path, docs):
    """(jax searcher, port engine, port mapper) over the same docs indexed
    per doc with two refreshes (two segments), then a delete."""
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    jeng = JaxEngine(tmp_path / "jax", jms)
    eng = Engine(tmp_path / "torch", ms)
    for e in (jeng, eng):
        for i, d in enumerate(docs):
            e.index(str(i), d)
            if i == len(docs) // 2:
                e.refresh()
        e.refresh()
        e.delete("8")
        e.refresh()
    return JaxShardSearcher(0, jax_device_reader_for(jeng), jms), jeng, \
        eng, ms


def _phrase_body(must, phrase, size=20):
    return {"query": {"bool": {"must": [{"match": {"body": must}}],
                               "should": [{"match_phrase": {"body": phrase}}]}},
            "size": size}


def _fs_body(text, functions, score_mode="multiply", boost_mode="multiply",
             size=25, **extra):
    return {"query": {"function_score": {
        "query": {"match": {"body": text}}, "functions": functions,
        "score_mode": score_mode, "boost_mode": boost_mode, **extra}},
        "size": size}


def _fvf(modifier="log1p", factor=1.0, **kw):
    return {"field_value_factor": {"field": "rank", "modifier": modifier,
                                   "factor": factor, **kw}}


_RANKS = [d["rank"] for d in _docs()[:12] if "rank" in d]

#: batches of one plan signature each (the reference batches only those)
BATCHES = {
    "bool_phrase": ([
        _phrase_body("w00 w01", "w00 w01"),
        _phrase_body("w02 w05", "w01 w00", size=7),
        _phrase_body("w03 w03", "w00 w00", size=200),   # overlapping runs
        _phrase_body("w01 w04", "w04 zz"),              # an absent term
    ], PINNED_RTOL),
    "phrase_alone": ([
        {"query": {"match_phrase": {"body": "w00 w01"}}, "size": 30},
        {"query": {"match_phrase": {"body": {"query": "w01 w00",
                                             "boost": 2.0}}}, "size": 30},
    ], PINNED_RTOL),
    "filters": ([
        {"query": {"bool": {
            "must": [{"match": {"body": "w00 w02"}}],
            "filter": [{"term": {"tag": "t1"}},
                       {"range": {"rank": {"gte": 10, "lt": 70}}}],
            "must_not": [{"exists": {"field": "ts"}}]}}, "size": 40},
        {"query": {"bool": {
            "must": [{"match": {"body": "w01 w03"}}],
            "filter": [{"term": {"tag": "t0"}},
                       {"range": {"rank": {"gt": 0, "lte": 50.5}}}],
            "must_not": [{"exists": {"field": "ts"}}]}}, "size": 40},
    ], PINNED_RTOL),
    "filters_more": ([
        {"query": {"bool": {
            "should": [{"match": {"body": "w03 w02"}},
                       {"terms": {"tag": ["t0", "t2", "nope"]}},
                       {"range": {"tag": {"gte": "t1"}}}],
            "minimum_should_match": 2,
            "filter": [{"range": {"ts": {"gte": "2015-01-05",
                                         "lt": "2015-01-20"}}}]}},
         "size": 60},
        {"query": {"bool": {
            "should": [{"match": {"body": "w00 w07"}},
                       {"terms": {"tag": ["t1", "t1", "t0"]}},
                       {"range": {"tag": {"lt": "t2"}}}],
            "minimum_should_match": "50%",
            "filter": [{"range": {"ts": {"gt": "2015-01-10"}}}]}},
         "size": 60},
    ], PINNED_RTOL),
    "constant_score": ([
        {"query": {"constant_score": {"filter": {"term": {"tag": "t0"}}}},
         "size": 10},
        {"query": {"constant_score": {"filter": {"term": {"tag": "t2"}},
                                      "boost": 3.0}}, "size": 10},
    ], PINNED_RTOL),
    "numeric_term": ([
        {"query": {"constant_score": {"filter": {"term": {"rank": r}}}},
         "size": 10} for r in _RANKS[:2]] + [
        {"query": {"constant_score": {"filter": {"term": {"rank": 0.5}}}},
         "size": 10}], PINNED_RTOL),
    "fvf": ([
        _fs_body("w00 w03 w04 w06", [_fvf()]),
        _fs_body("w01 w02 w05 w00", [_fvf(factor=2.0)], size=300),
    ], TRANSCENDENTAL_RTOL),
    "decay_random_weight": ([
        _fs_body("w00 w05", [
            {"gauss": {"rank": {"origin": 50, "scale": 20, "decay": 0.5}}},
            {"random_score": {"seed": 7}},
            {"weight": 2.5, "filter": {"term": {"tag": "t1"}}}],
            score_mode="sum", boost_mode="sum"),
        _fs_body("w02 w03", [
            {"gauss": {"rank": {"origin": 10, "scale": 5, "offset": 2}}},
            {"random_score": {"seed": 7}},
            {"weight": 0.5, "filter": {"term": {"tag": "t2"}}}],
            score_mode="sum", boost_mode="sum"),
    ], TRANSCENDENTAL_RTOL),
    "decay_modes": ([
        _fs_body("w01 w03", [
            {"exp": {"ts": {"origin": "2015-01-15", "scale": "5d"}},
             "weight": 3.0},
            {"linear": {"rank": {"origin": 40, "scale": 30}}},
            _fvf("sqrt", 0.5, missing=4.0)],
            score_mode="avg", boost_mode="replace", max_boost=2.0),
        _fs_body("w00 w02", [
            {"exp": {"ts": {"origin": "2015-01-03", "scale": "2d"}},
             "weight": 1.0},
            {"linear": {"rank": {"origin": 90, "scale": 10}}},
            _fvf("sqrt", 2.0, missing=1.0)],
            score_mode="avg", boost_mode="replace", max_boost=9.0),
    ], TRANSCENDENTAL_RTOL),
    "first_max": ([
        _fs_body("w04 w05", [
            {"filter": {"term": {"tag": "t0"}}, "weight": 4.0},
            _fvf("ln2p")], score_mode="first", boost_mode="max",
            min_score=0.5),
        _fs_body("w06 w01", [
            {"filter": {"term": {"tag": "t1"}}, "weight": 2.0},
            _fvf("ln2p")], score_mode="first", boost_mode="max",
            min_score=1.0),
    ], TRANSCENDENTAL_RTOL),
}


def _assert_same(got, want, rtol):
    """Equal totals; the same ids up to exact ties, scores to ``rtol``."""
    assert got.total == want.total
    assert len(got.doc_ids) == len(want.doc_ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=rtol, atol=0)
    want_score = dict(zip(want.doc_ids.tolist(), want.scores.tolist()))
    cut = float(want.scores[-1]) if len(want.scores) else 0.0
    for i, (g, w) in enumerate(zip(got.doc_ids.tolist(),
                                   want.doc_ids.tolist())):
        if g == w:
            continue
        # a swap among equal scores, or a tie at the cut
        s = float(got.scores[i])
        assert abs(want_score.get(g, cut) - s) <= rtol * abs(s), \
            f"hit {i}: doc {g} (score {s}) where the reference has {w}"


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """(jax searcher, jax engine, port searcher, port mapper) over one
    shared two-segment index: the JAX package compiles each batch's plan
    once for the module."""
    js, jeng, eng, ms = _engines(tmp_path_factory.mktemp("slice3"), _docs())
    reader = device_reader_for(eng, device="cpu")
    assert len(reader.segments) == 2
    return js, jeng, ShardSearcher(0, reader, ms), ms


@pytest.mark.parametrize("name", list(BATCHES))
def test_batches_match_jax(shared, name):
    js, _, ps, _ = shared
    bodies, rtol = BATCHES[name]
    jreqs = [jax_parse_search_request(b) for b in bodies]
    reqs = [parse_search_request(b) for b in bodies]
    want = js.query_phase_batch(jreqs)
    got = ps.query_phase_batch(reqs)
    assert want is not None and got is not None, "a batch fell back"
    for g, w in zip(got, want):
        _assert_same(g, w, rtol)
    # one request alone through query_phase, with a post_filter so it takes
    # the per-segment path
    body = dict(bodies[0], post_filter={"exists": {"field": "rank"}})
    _assert_same(ps.query_phase(parse_search_request(body)),
                 js.query_phase(jax_parse_search_request(body)), rtol)


def test_mixed_signatures_serve_one_by_one(shared):
    js, _, ps, _ = shared
    bodies = [BATCHES["bool_phrase"][0][0], BATCHES["fvf"][0][0]]
    assert ps.query_phase_batch([parse_search_request(b)
                                 for b in bodies]) is None
    for b, rtol in zip(bodies, (PINNED_RTOL, TRANSCENDENTAL_RTOL)):
        _assert_same(ps.query_phase(parse_search_request(b)),
                     js.query_phase(jax_parse_search_request(b)), rtol)


def test_match_search_uploads_no_positions(tmp_path):
    """A BM25 match leaves the position matrices on the host; the first
    phrase search puts them on the device, once."""
    _, _, eng, ms = _engines(tmp_path, _docs(n=60))
    reader = device_reader_for(eng, device="cpu")
    ps = ShardSearcher(0, reader, ms)
    before = reader.device_bytes()
    assert ps.query_phase_batch([parse_search_request(
        {"query": {"match": {"body": "w00 w01"}}})]) is not None
    assert all(s.text["body"].tokens is None for s in reader.segments)
    assert reader.device_bytes() == before
    ps.query_phase_batch([parse_search_request(
        {"query": {"match_phrase": {"body": "w00 w01"}}})])
    tokens = [s.text["body"].tokens for s in reader.segments]
    assert all(t is not None for t in tokens)
    assert reader.device_bytes() == before + sum(
        t.numel() * 4 + t.shape[0] * 4 for t in tokens)
    ps.query_phase_batch([parse_search_request(
        {"query": {"match_phrase": {"body": "w02 w01"}}})])
    assert [s.text["body"].tokens for s in reader.segments] == tokens


def test_carried_segments_score_like_jax(shared):
    """Segments rebuilt in the port from the JAX package's arrays (text with
    positions, keyword and numeric columns) score configs 2 and 3 alike."""
    js, jeng, _, ms = shared
    view = jeng.acquire_searcher()
    carried = []
    for s, live in zip(view.segments, view.live_masks):
        c = s.text_fields["body"]
        carried.append(carry.segment_from_arrays(
            "body", terms=c.terms, uterms=c.uterms, utf=c.utf,
            doc_len=c.doc_len, df=c.df, tokens=c.tokens, ids=list(s.ids),
            sources=list(s.sources), live=live, num_docs=s.num_docs,
            total_tokens=c.total_tokens, seg_id=s.seg_id,
            keyword={n: (k.vocab, k.ords)
                     for n, k in s.keyword_fields.items()},
            numeric={n: (v.values, v.exists)
                     for n, v in s.numeric_fields.items()}))
    reader = DeviceReader(SearcherView([c[0] for c in carried],
                                       [c[1] for c in carried], 1),
                          device="cpu")
    ps = ShardSearcher(0, reader, ms)
    for name in ("bool_phrase", "filters", "fvf"):
        bodies, rtol = BATCHES[name]
        want = js.query_phase_batch([jax_parse_search_request(b)
                                     for b in bodies])
        got = ps.query_phase_batch([parse_search_request(b) for b in bodies])
        for g, w in zip(got, want):
            _assert_same(g, w, rtol)


@pytest.mark.parametrize("query", [
    {"exists": {"field": "loc"}},
    {"match_phrase": {"body": " ".join(["w00"] * 33)}},
    {"function_score": {"query": {"match": {"body": "w00"}}, "functions": [
        {"script_score": {"script": "_score * 2"}}]}},
    {"function_score": {"query": {"match": {"body": "w00"}}, "functions": [
        {"gauss": {"loc": {"origin": "0,0", "scale": "1km"}}}]}},
])
def test_unported_parts_are_refused(tmp_path, query):
    """Exists on a geo field, phrases above the kernel's term cap,
    script_score and geo decay raise NotPortedError, in the batch and
    alone."""
    _, _, eng, ms = _engines(tmp_path, _docs(n=30))
    view = eng.acquire_searcher()
    for seg in view.segments:     # a geo column the geo decay would read
        n = seg.padded_docs
        seg.geo_fields["loc"] = GeoFieldColumn(
            lat=np.zeros(n), lon=np.zeros(n), exists=np.ones(n, bool))
    ps = ShardSearcher(0, DeviceReader(view, device="cpu"), ms)
    req = parse_search_request({"query": query})
    with pytest.raises(NotPortedError):
        ps.query_phase_batch([req])
    with pytest.raises(NotPortedError):
        ps.query_phase(req)
