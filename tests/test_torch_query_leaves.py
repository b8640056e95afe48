"""The query leaves through the port against the JAX package, on the CPU:
``prefix`` / ``wildcard`` / ``regexp`` / ``fuzzy`` on text (K16's plain
version) and keyword fields, ``multi_match`` (best_fields with a
tie_breaker, most_fields, phrase), ``dis_max``, ``boosting``, ``common``,
``ids``, ``indices``, ``more_like_this`` and ``query_string`` /
``simple_query_string``.

The same documents go into both packages' Engine (two segments and a
deleted doc), and the same requests through both ``ShardSearcher``s:
batches through ``query_phase_batch`` (a batch the reference declines, for
differing plan signatures, the port must decline too, and then each request
goes alone through ``query_phase``), and for some the first request
alone through ``query_phase`` with a post_filter. Totals are exact, ids
equal up to exact ties, scores within 4 ulp (two 2-ulp clauses added: XLA
fuses the element-wise chain where eager PyTorch rounds each operation).
Then ``fetch_phase`` highlights of a multi_match hit, and the leaves that
stay refused. The corpus and the checks are shared with
``test_torch_span_queries`` and ``test_torch_similarity``.
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
from elasticsearch_tpu_torch.common.errors import QueryParsingError
from elasticsearch_tpu_torch.index.device_reader import device_reader_for
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)
from test_torch_slice3 import _assert_same

RTOL = 4.8e-7       # 4 ulp of f32
INDEX = "leaves"
#: words with shared prefixes and near spellings, so the multi-term
#: queries expand to several terms
VOCAB = ["apple", "apply", "ape", "apex", "banana", "band", "bandit", "bend",
         "bond", "cat", "cart", "cast", "coat", "dog", "dot", "dote", "eel",
         "else", "ever", "every"]
MAPPING = {"properties": {
    "body": {"type": "text"},
    "title": {"type": "text", "analyzer": "whitespace"},
    "tag": {"type": "keyword"},
    "rank": {"type": "double"},
    "cls": {"type": "text", "similarity": "classic"},
    "lm": {"type": "text", "similarity": "LMDirichlet"}}}


def _docs(seed=11, n=220):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(VOCAB) + 1) ** 0.8
    p /= p.sum()

    def words(lo, hi):
        return " ".join(rng.choice(VOCAB, size=int(rng.integers(lo, hi)),
                                   p=p))
    docs = []
    for i in range(n):
        d = {"body": words(2, 16), "title": words(1, 5)}
        if i % 3:
            d["cls"] = words(1, 12)
        if i % 4:
            d["lm"] = words(1, 12)
        if i % 5:
            d["tag"] = VOCAB[i % 7]
        if i % 6:
            d["rank"] = float(i % 50)
        docs.append(d)
    return docs


def _engines(tmp_path, docs=None, mapping=None):
    """(jax searcher, port searcher) over the same docs, indexed with two
    refreshes (two segments), then doc 8 deleted (where there is one)."""
    docs = _docs() if docs is None else docs
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", mapping or MAPPING)
    ms.merge("_doc", mapping or MAPPING)
    jeng = JaxEngine(tmp_path / "jax", jms)
    eng = Engine(tmp_path / "torch", ms)
    for e in (jeng, eng):
        for i, d in enumerate(docs):
            e.index(str(i), d)
            if i == len(docs) // 2:
                e.refresh()
        e.refresh()
        if len(docs) > 8:
            e.delete("8")
            e.refresh()
    js = JaxShardSearcher(0, jax_device_reader_for(jeng), jms,
                          index_name=INDEX)
    ps = ShardSearcher(0, device_reader_for(eng, device="cpu"), ms,
                       index_name=INDEX)
    return js, ps


def check_bodies(js, ps, bodies, rtol=RTOL, alone=False):
    """Both packages' query_phase_batch on ``bodies`` (declined alike, then
    one by one), and with ``alone`` the first body alone with a
    post_filter (the per-segment path)."""
    want = js.query_phase_batch([jax_parse_search_request(b)
                                 for b in bodies])
    got = ps.query_phase_batch([parse_search_request(b) for b in bodies])
    assert (got is None) == (want is None), "one package declined the batch"
    if want is None:
        want = [js.query_phase(jax_parse_search_request(b)) for b in bodies]
        got = [ps.query_phase(parse_search_request(b)) for b in bodies]
    assert any(w.total for w in want), "nothing matched"
    for g, w in zip(got, want):
        _assert_same(g, w, rtol)
    if not alone:
        return
    body = dict(bodies[0], post_filter={"exists": {"field": "body"}})
    _assert_same(ps.query_phase(parse_search_request(body)),
                 js.query_phase(jax_parse_search_request(body)), rtol)


@pytest.fixture(scope="module")
def searchers(tmp_path_factory):
    js, ps = _engines(tmp_path_factory.mktemp("leaves"))
    assert len(ps.reader.segments) == 2
    return js, ps


def _filtered(must, flt, size=30):
    return {"query": {"bool": {"must": [{"match": {"body": must}}],
                               "filter": [flt]}}, "size": size}


BATCHES = {
    "prefix_text": [_filtered("cat dog", {"prefix": {"body": p}})
                    for p in ("ap", "ban", "ca")],
    "prefix_keyword": [{"query": {"prefix": {"tag": p}}, "size": 40}
                       for p in ("ap", "b", "zz")],
    "wildcard": [_filtered("band ever", {"wildcard": {"body": w}})
                 for w in ("b?nd*", "*t", "co?t")],
    "wildcard_keyword": [{"query": {"wildcard": {"tag": "*e*"}},
                          "size": 40}],
    "regexp": [{"query": {"regexp": {"body": r}}, "size": 50}
               for r in ("do.*", "b[ae]nd", "e(l|v)e.*")],
    "fuzzy": [_filtered("apple", {"fuzzy": {"body": {
        "value": v, "fuzziness": f}}}) for v, f in (
            ("bend", 1), ("cart", "AUTO"), ("dote", 1))],
    "multi_match_best": [{"query": {"multi_match": {
        "query": t, "fields": ["body", "title^2"], "tie_breaker": 0.3}},
        "size": 25} for t in ("cat dog", "apple band", "every else")],
    "multi_match_most": [{"query": {"multi_match": {
        "query": t, "fields": ["body", "title"], "type": "most_fields"}},
        "size": 25} for t in ("cat apex", "dot")],
    "multi_match_phrase": [{"query": {"multi_match": {
        "query": t, "fields": ["body", "title"], "type": "phrase"}},
        "size": 25} for t in ("apple apply", "cat dog")],
    "dis_max": [{"query": {"dis_max": {"queries": [
        {"match": {"body": a}}, {"match": {"title": b}}],
        "tie_breaker": tb}}, "size": 30}
        for a, b, tb in (("cat", "dog", 0.4), ("apple", "apple", 0.4))],
    "dis_max_plain": [{"query": {"dis_max": {"queries": [
        {"match": {"body": "band"}}, {"term": {"tag": "band"}}]}},
        "size": 30}],
    "boosting": [{"query": {"boosting": {
        "positive": {"match": {"body": a}},
        "negative": {"match": {"title": b}}, "negative_boost": 0.2}},
        "size": 40} for a, b in (("cat dog", "dog"), ("ever", "apple"))],
    "common": [{"query": {"common": {"body": {
        "query": t, "cutoff_frequency": c}}}, "size": 30}
        for t, c in (("apple cat bandit", 0.05), ("ape else dote", 0.05))],
    "common_and": [{"query": {"common": {"body": {
        "query": "apple every bend", "cutoff_frequency": 0.1,
        "low_freq_operator": "and"}}}, "size": 30}],
    "ids": [{"query": {"ids": {"values": v}}, "size": 10}
            for v in (["3", "150", "8", "nope"], ["0", "219"])],
    "ids_in_bool": [{"query": {"bool": {
        "must": [{"match": {"body": "cat"}}],
        "must_not": [{"ids": {"values": ["1", "2", "4", "5"]}}]}},
        "size": 30}],
    "indices": [{"query": {"indices": {
        "indices": [INDEX], "query": {"match": {"body": "cat"}},
        "no_match_query": {"match": {"body": "dog"}}}}, "size": 20},
        {"query": {"indices": {
            "indices": ["other"], "query": {"match": {"body": "cat"}},
            "no_match_query": {"match": {"body": "dog"}}}}, "size": 20}],
    "more_like_this": [{"query": {"more_like_this": {
        "fields": ["body"], "like": t, "min_term_freq": 1,
        "min_doc_freq": 1, "max_query_terms": 6}}, "size": 30}
        for t in ("apple apple cat bandit", "dog dot dote ever")],
    "more_like_this_docs": [{"query": {"more_like_this": {
        "fields": ["body", "title"], "like": [{"_id": "3"}, {"_id": "120"}],
        "unlike": "cat", "min_term_freq": 1, "min_doc_freq": 2,
        "minimum_should_match": "20%"}}, "size": 30}],
    "query_string": [{"query": {"query_string": {
        "query": q, "default_field": "body"}}, "size": 30}
        for q in ("cat AND dog", "apple -band", "title:ever ap*")],
    "simple_query_string": [{"query": {"simple_query_string": {
        "query": "\"apple apply\" cat", "fields": ["body"]}}, "size": 30}],
}


#: batches also run one request alone through query_phase
ALONE = {"prefix_text", "fuzzy", "multi_match_best", "common",
         "more_like_this_docs", "query_string"}


@pytest.mark.parametrize("name", list(BATCHES))
def test_query_leaves_match_jax(searchers, name):
    js, ps = searchers
    check_bodies(js, ps, BATCHES[name], alone=name in ALONE)


def test_multi_match_highlights_match_jax(searchers):
    """fetch_phase's highlight of multi_match hits is the reference's."""
    js, ps = searchers
    body = {"query": {"multi_match": {"query": "apple cat",
                                      "fields": ["body", "title"]}},
            "size": 5, "highlight": {"fields": {"body": {}, "title": {}}}}
    jreq, req = jax_parse_search_request(body), parse_search_request(body)
    want_r, got_r = js.query_phase(jreq), ps.query_phase(req)
    _assert_same(got_r, want_r, RTOL)
    pos = list(range(len(want_r.doc_ids)))
    want = js.fetch_phase(jreq, want_r, INDEX, pos)
    got = ps.fetch_phase(req, got_r, INDEX, pos)
    assert [h.get("highlight") for h in got] == \
        [h.get("highlight") for h in want]
    assert any(h.get("highlight") for h in got)


@pytest.mark.parametrize("body", [
    {"query": {"nested": {"path": "items", "query": {"match_all": {}}}}},
    {"query": {"has_child": {"type": "c", "query": {"match_all": {}}}}},
])
def test_nested_and_join_stay_refused(searchers, body):
    """has_child stays refused; nested is served: over this index, which
    maps no nested path, it matches nothing in both packages."""
    js, ps = searchers
    if "nested" not in body["query"]:
        with pytest.raises(QueryParsingError):
            ps.query_phase(parse_search_request(body))
        return
    want = js.query_phase(jax_parse_search_request(body))
    got = ps.query_phase(parse_search_request(body))
    assert got.total == want.total == 0
    _assert_same(got, want, RTOL)


@pytest.mark.parametrize("body", [
    {"query": {"geo_distance": {"distance": "1km", "rank": "10,10"}}},
    {"query": {"geohash_cell": {"pt": {"lat": 1.0, "lon": 2.0},
                                "precision": 3}}},
], ids=["geo_distance", "geohash_cell"])
def test_geo_on_a_field_without_points_matches_jax(searchers, body):
    """A geo query on a field the segments hold no points of matches
    nothing, in both packages (formerly refused here; the geo slice's own
    tests are test_torch_geo*.py)."""
    js, ps = searchers
    want = js.query_phase(jax_parse_search_request(body))
    got = ps.query_phase(parse_search_request(body))
    _assert_same(got, want, RTOL)
    assert got.total == 0
