"""The span family through the port against the JAX package, on the CPU.

First the cases of the JAX package's own span tests
(``tests/test_query_dsl3.py``: span_or, span_first, span_not,
span_containing, span_within, span_multi, field_masking_span, the scoring
shape, and ``test_field_masking_span_cross_field``) over the same six
documents in both packages: the same ids, and the port's hits and scores
the reference's. Then batches over ``test_torch_query_leaves``'s
two-segment corpus through both ``ShardSearcher``s: flat span_near in
order and unordered (K14's plain version), span trees lowered to programs
(K13's plain version), and span leaves inside ``bool``. Totals exact, ids
equal up to exact ties, scores within 4 ulp. Then ``fetch_phase``
highlights of a span query.
"""

import pytest

from elasticsearch_tpu.search.phase import (
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu_torch.search.phase import parse_search_request
from test_torch_query_leaves import (
    INDEX, RTOL, _assert_same, _engines, check_bodies)

DSL3_MAPPING = {"properties": {"t": {"type": "text",
                                     "analyzer": "whitespace"},
                               "n": {"type": "long"}}}
DSL3_TEXTS = ["alpha beta gamma delta", "beta alpha gamma",
              "alpha gamma beta epsilon", "delta epsilon zeta",
              "alpha beta alpha beta", "gamma delta alpha"]


@pytest.fixture(scope="module")
def dsl3(tmp_path_factory):
    docs = [{"t": t, "n": i} for i, t in enumerate(DSL3_TEXTS)]
    return _engines(tmp_path_factory.mktemp("dsl3"), docs, DSL3_MAPPING)


def _both(searchers, query, size=20):
    """The query through both packages → the port's hits' _ids, in
    order."""
    js, ps = searchers
    body = {"query": query, "size": size}
    want = js.query_phase(jax_parse_search_request(body))
    got = ps.query_phase(parse_search_request(body))
    _assert_same(got, want, RTOL)
    out = []
    for gid in got.doc_ids.tolist():
        seg, local = ps.reader.resolve(int(gid))
        out.append(seg.seg.ids[local])
    return out


def _near(a, b, slop=1, in_order=True):
    return {"span_near": {"clauses": [{"span_term": {"t": a}},
                                      {"span_term": {"t": b}}],
                          "slop": slop, "in_order": in_order}}


# the ids are the JAX package's own expectations (test_query_dsl3.py)
DSL3_CASES = {
    "span_or": ({"span_or": {"clauses": [{"span_term": {"t": "zeta"}},
                                         {"span_term": {"t": "epsilon"}}]}},
                {"2", "3"}),
    "span_first": ({"span_first": {"match": {"span_term": {"t": "alpha"}},
                                   "end": 1}}, {"0", "2", "4"}),
    "span_not": ({"span_not": {
        "include": {"span_term": {"t": "beta"}},
        "exclude": _near("beta", "gamma", 0)}}, {"1", "2", "4"}),
    "span_containing": ({"span_containing": {
        "big": _near("alpha", "gamma"),
        "little": {"span_term": {"t": "beta"}}}}, {"0"}),
    "span_within": ({"span_within": {
        "big": _near("alpha", "gamma"),
        "little": {"span_term": {"t": "beta"}}}}, {"0"}),
    "span_multi": ({"span_multi": {"match": {"prefix": {"t": {
        "value": "ep"}}}}}, {"2", "3"}),
    "field_masking_span": ({"span_near": {"clauses": [
        {"span_term": {"t": "alpha"}},
        {"field_masking_span": {"query": {"span_term": {"t": "beta"}},
                                "field": "t"}}],
        "slop": 0, "in_order": True}}, {"0", "4"}),
}


@pytest.mark.parametrize("name", list(DSL3_CASES))
def test_dsl3_span_cases_match_jax(dsl3, name):
    query, ids = DSL3_CASES[name]
    assert set(_both(dsl3, query)) == ids


def test_span_scores_match_phrase_shape(dsl3):
    """Span freq feeds BM25: the doc with two occurrences ranks first."""
    got = _both(dsl3, {"span_or": {"clauses": [
        {"span_term": {"t": "alpha"}}]}})
    assert got[0] == "4"


def test_field_masking_span_cross_field(tmp_path):
    """A masked span over another field's token matrix (of another width)
    matches, alone and beside a clause of the mask field."""
    mapping = {"properties": {
        "title": {"type": "text", "analyzer": "whitespace"},
        "body": {"type": "text", "analyzer": "whitespace"}}}
    docs = [{"title": "alpha beta",
             "body": "one two three four five six seven alpha nine"},
            {"title": "beta", "body": "one two"}]
    searchers = _engines(tmp_path, docs, mapping)
    got = _both(searchers, {"span_or": {"clauses": [
        {"field_masking_span": {"query": {"span_term": {"body": "alpha"}},
                                "field": "title"}}]}})
    assert got == ["0"]
    got = _both(searchers, {"span_near": {"clauses": [
        {"span_term": {"title": "alpha"}},
        {"field_masking_span": {"query": {"span_term": {"body": "two"}},
                                "field": "title"}}],
        "slop": 0, "in_order": True}})
    assert len(got) == 1


@pytest.fixture(scope="module")
def searchers(tmp_path_factory):
    return _engines(tmp_path_factory.mktemp("spans"))


def _st(w, field="body"):
    return {"span_term": {field: w}}


def _flat(words, slop, in_order, size=30):
    return {"query": {"span_near": {"clauses": [_st(w) for w in words],
                                    "slop": slop, "in_order": in_order}},
            "size": size}


BATCHES = {
    "near_unordered": [_flat(w, 3, False) for w in (
        ("cat", "dog", "apple"), ("band", "ever", "eel"),
        ("apple", "apple", "ape"), ("cat", "zzz", "dog"))],
    "near_in_order": [_flat(w, 2, True) for w in (
        ("cat", "dog", "apple"), ("apple", "apply", "cat"),
        ("dog", "dog", "dog"))],
    "span_not_tree": [{"query": {"span_not": {
        "include": {"span_near": {"clauses": [
            {"span_or": {"clauses": [_st(a), _st(b)]}},
            {"span_multi": {"match": {"prefix": {"body": {"value": p}}}}},
            _st(c)], "slop": 4, "in_order": False}},
        "exclude": _st(d), "pre": 1, "post": 1}}, "size": 30}
        for a, b, p, c, d in (("cat", "dog", "ap", "band", "ever"),
                              ("eel", "else", "ba", "apple", "cat"))],
    "containing": [{"query": {"span_containing": {
        "big": {"span_near": {"clauses": [_st(a), _st(b)], "slop": 8,
                              "in_order": False}},
        "little": _st(c)}}, "size": 30}
        for a, b, c in (("cat", "dog", "apple"), ("band", "bend", "ever"))],
    "within": [{"query": {"span_within": {
        "big": {"span_near": {"clauses": [_st(a), _st(b)], "slop": 8,
                              "in_order": False}},
        "little": _st(c)}}, "size": 30}
        for a, b, c in (("cat", "dog", "apple"), ("band", "bend", "ever"))],
    "first_over_or": [{"query": {"span_first": {"match": {"span_or": {
        "clauses": [_st(a), _st(b)]}}, "end": 3}}, "size": 40}
        for a, b in (("cat", "dog"), ("apple", "zzz"))],
    "span_multi_wildcard": [{"query": {"span_multi": {"match": {
        "wildcard": {"body": w}}}}, "size": 40} for w in ("b*d", "do?")],
    "masking_cross_field": [{"query": {"span_near": {"clauses": [
        _st(a, "title"),
        {"field_masking_span": {"query": _st(b), "field": "title"}}],
        "slop": 2, "in_order": False}}, "size": 30}
        for a, b in (("cat", "dog"), ("apple", "band"))],
    "span_in_bool": [{"query": {"bool": {
        "must": [{"match": {"body": m}}],
        "should": [{"span_near": {"clauses": [_st(a), _st(b)], "slop": 1,
                                  "in_order": True}}]}}, "size": 30}
        for m, a, b in (("cat", "cat", "dog"), ("ever", "apple", "band"))],
    "span_term": [{"query": {"span_term": {"body": w}}, "size": 30}
                  for w in ("cat", "ape", "zzz")],
}


@pytest.mark.parametrize("name", list(BATCHES))
def test_span_batches_match_jax(searchers, name):
    js, ps = searchers
    check_bodies(js, ps, BATCHES[name],
                 alone=name in ("near_unordered", "span_not_tree"))


def test_span_highlights_match_jax(searchers):
    js, ps = searchers
    body = dict(BATCHES["near_unordered"][0], size=5,
                highlight={"fields": {"body": {}}})
    jreq, req = jax_parse_search_request(body), parse_search_request(body)
    want_r, got_r = js.query_phase(jreq), ps.query_phase(req)
    _assert_same(got_r, want_r, RTOL)
    pos = list(range(len(want_r.doc_ids)))
    want = js.fetch_phase(jreq, want_r, INDEX, pos)
    got = ps.fetch_phase(req, got_r, INDEX, pos)
    assert [h.get("highlight") for h in got] == \
        [h.get("highlight") for h in want]
