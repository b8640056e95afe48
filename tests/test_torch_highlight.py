"""The port's highlighter against the JAX package's, on the CPU.

``highlight_hit`` runs on the same stored text, mapper definitions and
queries in both packages — term, match, exact and sloppy ``match_phrase``
and ``bool`` combinations, drawn the way ``tests/test_highlight_fuzz.py``
draws them (its vocabulary, highlighter types and positional oracle) —
across the four highlighter types; the fragments must be identical. Then
``fetch_phase`` with ``highlight`` through both packages' ShardSearcher on
one corpus, and ``script_fields``, which the port still refuses.
"""

import random

import pytest

from elasticsearch_tpu.mapping import MapperService as JaxMapperService
from elasticsearch_tpu.search.highlight import (
    highlight_hit as jax_highlight_hit)
from elasticsearch_tpu.search.phase import (
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu.search.query_dsl import parse_query as jax_parse_query
from elasticsearch_tpu_torch.common.errors import NotPortedError
from elasticsearch_tpu_torch.index.device_reader import device_reader_for
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search.highlight import highlight_hit
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)
from elasticsearch_tpu_torch.search.query_dsl import parse_query
from test_highlight_fuzz import TYPES, VOCAB, marked_words, oracle_marked
from test_torch_slice3 import _docs, _engines

MAPPING = {"properties": {"t": {"type": "text", "analyzer": "whitespace"}}}


def _mappers():
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    return jms, ms


def _query(rnd):
    kind = rnd.choice(["term", "match", "phrase", "sloppy", "bool"])
    if kind == "term":
        return {"term": {"t": rnd.choice(VOCAB)}}
    if kind == "match":
        return {"match": {"t": " ".join(rnd.sample(VOCAB,
                                                   rnd.randint(1, 3)))}}
    words = " ".join(rnd.choice(VOCAB) for _ in range(rnd.randint(2, 3)))
    if kind == "phrase":
        return {"match_phrase": {"t": words}}
    if kind == "sloppy":
        return {"match_phrase": {"t": {"query": words,
                                       "slop": rnd.randint(1, 3)}}}
    return {"bool": {"must": [{"match": {"t": rnd.choice(VOCAB)}}],
                     "should": [{"match_phrase": {"t": {
                         "query": words, "slop": rnd.randint(0, 2)}}}]}}


def test_highlight_hit_matches_jax():
    rnd = random.Random(20261017)
    jms, ms = _mappers()
    texts = [" ".join(rnd.choice(VOCAB) for _ in range(rnd.randint(6, 40)))
             + rnd.choice(["", ". ruby opal", "! jade"])
             for _ in range(30)]
    n_marked = 0
    for qi in range(60):
        query = _query(rnd)
        spec = {"fields": {"t": {
            "type": TYPES[qi % len(TYPES)],
            "fragment_size": rnd.choice([30, 80, 200]),
            "number_of_fragments": rnd.choice([0, 1, 3, 10]),
            "no_match_size": rnd.choice([0, 20])}},
            "pre_tags": ["<em>"], "post_tags": ["</em>"]}
        for text in texts[qi % 5::5]:
            src = {"t": text}
            got = highlight_hit(spec, src, ms, parse_query(query))
            want = jax_highlight_hit(spec, src, jms, jax_parse_query(query))
            assert got == want, (query, spec, text)
            n_marked += len(marked_words(got.get("t", [])))
            if "match_phrase" in query and not isinstance(
                    query["match_phrase"]["t"], dict):
                # exact phrases mark only the oracle's words
                words = text.split()
                assert set(marked_words(got.get("t", []))) <= {
                    words[i].strip(".!") for i in
                    oracle_marked(text, {"match_phrase": {
                        "t": query["match_phrase"]["t"]}})}
    assert n_marked > 100


def test_fetch_phase_highlights_like_jax(tmp_path):
    js, _, eng, ms = _engines(tmp_path, _docs(n=60))
    ps = ShardSearcher(0, device_reader_for(eng, device="cpu"), ms)
    body = {"query": {"bool": {
        "must": [{"match": {"body": "w00"}}],
        "should": [{"match_phrase": {"body": {"query": "w00 w01",
                                              "slop": 1}}}]}},
        "size": 8, "highlight": {"fields": {"body": {}},
                                 "pre_tags": ["["], "post_tags": ["]"]}}
    req, jreq = parse_search_request(body), jax_parse_search_request(body)
    res, jres = ps.query_phase(req), js.query_phase(jreq)
    assert res.doc_ids.tolist() == jres.doc_ids.tolist()
    pos = list(range(len(res.doc_ids)))
    hits = ps.fetch_phase(req, res, "idx", pos)
    jhits = js.fetch_phase(jreq, jres, "idx", pos)
    assert [h["highlight"] for h in hits] == \
        [h["highlight"] for h in jhits]
    assert len(hits) == 8 and all("[w00]" in h["highlight"]["body"][0]
                                  for h in hits)
    with pytest.raises(NotPortedError):
        sreq = parse_search_request(dict(body, script_fields={
            "x": {"script": "doc['rank'].value"}}))
        ps.fetch_phase(sreq, res, "idx", pos)
