"""Nested documents through the port against the JAX package, on the CPU.

The same documents (a body text, a ``tag`` keyword, a ``rank`` double and
a nested path ``answers`` of objects with a ``user`` keyword, a ``date``,
a ``body`` text and ``votes``) go into both packages' Engine: two shards,
the first in two segments with a deleted parent, the second with a first
segment whose documents hold no answers (a segment that lacks the path).
Two parents hold 30 and 25 answers (the first is deleted), many none. Then:

* ``query_phase_batch`` with ``nested`` in each score_mode and a boost, and
  nested under ``bool`` (must, should, must_not, filter),
  ``function_score``, ``constant_score``, with no leak across objects and
  a ``match_all`` inner query (parents without objects never match);
  ``query_phase`` with a ``post_filter``, ``min_score`` and ``from``, and
  ``fetch_phase``'s hits; the shard whose first segment lacks the path;
* deleting a parent, updating one, and a flush and reopen, on a small index
  of each package (``tests/test_nested.py``'s lifecycle cases);
* the ``nested`` / ``reverse_nested`` / ``filter``-under-``nested``
  aggregations: each shard's partials, and the two shards reduced by each
  package's ``controller.merge_responses``;
* ``ops/nested.nested_reduce_plain`` against a float64 recompute in child
  order, with NaN and ±0.0; ``index/carry.nested_block_from_arrays``
  against the block the indexer builds.

Tolerances: totals and match counts are equal. Over child scores that are
exact (votes × 1.5) every score_mode's hits and scores are equal bit for
bit. Over BM25 child scores (the packages' BM25 agrees to 2 ulp, and the
JAX package scatters a sum in an order of XLA's choosing where the port
adds in child order) the scores agree to rtol 1e-6, with ids equal apart
from exact ties (``scripts/bm25_oracle.recall_with_tie_tolerance`` 1.0);
``none`` is bit-equal there too.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.device_reader import (
    device_reader_for as jax_device_reader_for)
from elasticsearch_tpu.index.engine import Engine as JaxEngine
from elasticsearch_tpu.mapping import MapperService as JaxMapperService
from elasticsearch_tpu.search import controller as jax_controller
from elasticsearch_tpu.search.phase import (
    ShardSearcher as JaxShardSearcher,
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu_torch.index.carry import nested_block_from_arrays
from elasticsearch_tpu_torch.index.device_reader import (
    DeviceReader, device_reader_for, nested_offsets)
from elasticsearch_tpu_torch.index.engine import Engine, SearcherView
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import nested as nested_ops
from elasticsearch_tpu_torch.search import controller
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)
from test_torch_aggs import assert_same

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from bm25_oracle import recall_with_tie_tolerance  # noqa: E402

SUM_RTOL = 1e-6
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]
USERS = [f"u{i}" for i in range(8)]
MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "tag": {"type": "keyword"},
    "rank": {"type": "double"},
    "answers": {"type": "nested", "properties": {
        "user": {"type": "keyword"},
        "date": {"type": "date"},
        "body": {"type": "text", "analyzer": "whitespace"},
        "votes": {"type": "long"}}}}}


def _answer(rng):
    return {"user": str(rng.choice(USERS)),
            "date": f"20{int(rng.integers(8, 17)):02d}-"
                    f"{int(rng.integers(1, 13)):02d}-15",
            "body": " ".join(rng.choice(WORDS, int(rng.integers(1, 6)))),
            "votes": int(rng.integers(-3, 20))}


def _docs(seed=12, n=96):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(WORDS, int(rng.integers(1, 7)))),
             "tag": f"t{i % 3}", "rank": float(i % 11)}
        k = {5: 30, 40: 25}.get(i) or int(rng.choice([0, 0, 1, 1, 1, 2, 3,
                                                        5]))
        if k:
            d["answers"] = [_answer(rng) for _ in range(k)]
        docs.append(d)
    return docs


def _index(e, docs, prefix, splits=(), delete=None):
    for i, d in enumerate(docs):
        e.index(f"{prefix}{i}", d)
        if i in splits:
            e.refresh()
    e.refresh()
    if delete is not None:
        e.delete(delete)
        e.refresh()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """(jax searchers, port searchers): shard 0 in two segments with parent
    "a5" (30 answers) deleted; shard 1's first segment holds no answers."""
    tmp = tmp_path_factory.mktemp("nested")
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    docs = _docs()
    bare = [{k: v for k, v in d.items() if k != "answers"} for d in docs[:8]]
    parts = ((docs[:48], "a", (20,), "a5"),
             (bare + docs[48:], "b", (len(bare) - 1,), None))
    js, ps = [], []
    for si, (part, prefix, splits, delete) in enumerate(parts):
        jeng = JaxEngine(tmp / f"jax{si}", jms)
        eng = Engine(tmp / f"torch{si}", ms)
        for e in (jeng, eng):
            _index(e, part, prefix, splits, delete)
        js.append(JaxShardSearcher(si, jax_device_reader_for(jeng), jms))
        ps.append(ShardSearcher(si, device_reader_for(eng, device="cpu"),
                                ms))
    assert [len(s.reader.segments) for s in ps] == [2, 2]
    assert not ps[1].reader.segments[0].nested
    return js, ps


def _nested(inner, mode="avg", boost=None, path="answers"):
    body = {"path": path, "score_mode": mode, "query": inner}
    if boost is not None:
        body["boost"] = boost
    return {"nested": body}


def _match(text):
    return {"match": {"answers.body": text}}


TEXTS = ["alpha beta", "gamma", "delta eps zeta", "theta alpha"]


def _assert_same(got, want, rtol=0.0):
    """Totals and hit counts equal; with ``rtol`` 0 the ids and scores bit
    for bit, else the scores to ``rtol`` and the ids up to exact ties."""
    assert got.total == want.total
    assert len(got.doc_ids) == len(want.doc_ids)
    if not rtol:
        np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
        np.testing.assert_array_equal(got.scores, want.scores)
        return
    np.testing.assert_allclose(got.scores, want.scores, rtol=rtol, atol=0)
    if len(want.doc_ids):
        scores = dict(zip(want.doc_ids.tolist(), want.scores.tolist()))
        scores.update((d, s) for d, s in zip(got.doc_ids.tolist(),
                                             got.scores.tolist())
                      if d not in scores)
        ids = sorted(scores)
        pos = {d: i for i, d in enumerate(ids)}
        all_scores = np.asarray([scores[d] for d in ids])
        assert recall_with_tie_tolerance(
            [pos[d] for d in want.doc_ids.tolist()], all_scores,
            [pos[d] for d in got.doc_ids.tolist()], len(want.doc_ids),
            tol=rtol) == 1.0


def _run_batch(j, p, bodies, rtol=SUM_RTOL):
    want = j.query_phase_batch([jax_parse_search_request(b) for b in bodies])
    got = p.query_phase_batch([parse_search_request(b) for b in bodies])
    assert (got is None) == (want is None)
    if want is None:
        want = [j.query_phase(jax_parse_search_request(b)) for b in bodies]
        got = [p.query_phase(parse_search_request(b)) for b in bodies]
    for g, w in zip(got, want):
        _assert_same(g, w, rtol)
    return want


MODES = ["none", "max", "min", "sum", "avg"]


def _votes(user, factor=1.5):
    """An inner query whose child scores are exact: the objects of ``user``
    scored votes × ``factor`` (small integers times 1.5, exact in f32, so
    every reduce of them is exact whatever the order)."""
    return {"function_score": {
        "query": {"term": {"answers.user": user}},
        "functions": [{"field_value_factor": {"field": "answers.votes",
                                              "factor": factor}}],
        "boost_mode": "replace"}}


@pytest.mark.parametrize("mode", MODES)
def test_nested_score_modes_match_jax(shards, mode):
    """Batches of nested queries in one score_mode with a boost, on shard 0
    (two segments, a deleted parent with 30 answers): over exact child
    scores every mode is bit-equal to the JAX package; over BM25 child
    scores (the packages' BM25 agrees to 2 ulp) none, sum and avg within
    SUM_RTOL (max and min over BM25 run in the compound batches)."""
    js, ps = shards
    exact = [{"query": _nested(_votes(u), mode, boost=2.0), "size": 20}
             for u in USERS[:4]]
    want = _run_batch(js[0], ps[0], exact, rtol=0.0)
    assert all(w.total for w in want)
    if mode != "none":
        assert any(len(set(w.scores.tolist())) > 2 for w in want)
    if mode in ("max", "min"):
        return                 # over BM25 scores: the compound batches
    bm25 = [{"query": _nested(_match(t), mode, boost=2.0), "size": 20}
            for t in TEXTS]
    want = _run_batch(js[0], ps[0], bm25, rtol=0.0 if mode == "none"
                      else SUM_RTOL)
    assert all(w.total for w in want)


BATCHES = {
    # one object must hold both the user and the date (no leak across the
    # objects of one parent)
    "no_leakage": [{"query": _nested({"bool": {"must": [
        {"term": {"answers.user": u}},
        {"range": {"answers.date": {"gte": "2011-01-01",
                                    "lt": "2014-01-01"}}}]}}, "none"),
        "size": 30} for u in USERS[:4]],
    "match_all_inner": [{"query": _nested({"match_all": {}}, m),
                         "size": 60} for m in ("none", "sum")],
    # nested in each of bool's four occurrences at once
    "bool": [{"query": {"bool": {
        "must": [{"match": {"body": t}}, _nested(_match(t), "max")],
        "should": [_nested(_match(t), "min")],
        "must_not": [_nested({"term": {"answers.user": "u1"}})],
        "filter": [_nested({"range": {"answers.votes": {"gte": 2}}},
                           "none")]}}, "size": 20} for t in TEXTS],
    "function_score": [{"query": {"function_score": {
        "query": _nested(_match(t), "max"),
        "functions": [{"field_value_factor": {"field": "rank",
                                              "modifier": "log1p"}}],
        "boost_mode": "multiply"}}, "size": 20} for t in TEXTS],
    "constant_score": [{"query": {"constant_score": {
        "filter": _nested(_match(t), "max"), "boost": 3.0}}, "size": 20}
        for t in TEXTS],
}


@pytest.mark.parametrize("name", list(BATCHES))
def test_nested_compound_batches_match_jax(shards, name):
    js, ps = shards
    want = _run_batch(js[0], ps[0], BATCHES[name])
    assert any(w.total for w in want)


@pytest.mark.parametrize("mode", MODES)
def test_nested_query_phase_and_fetch_match_jax(shards, mode):
    """One request through query_phase (a post_filter, min_score and from
    take the per-segment path) and fetch_phase, on both shards."""
    js, ps = shards
    body = {"query": {"bool": {"should": [
        {"match": {"body": "alpha"}},
        _nested(_match("beta gamma"), mode, boost=1.5)]}},
        "post_filter": {"term": {"tag": "t1"}}, "min_score": 0.1,
        "from": 2, "size": 10}
    jreq, req = jax_parse_search_request(body), parse_search_request(body)
    for j, p in zip(js, ps):
        want, got = j.query_phase(jreq), p.query_phase(req)
        _assert_same(got, want, SUM_RTOL)
        assert want.total
        pos = list(range(len(want.doc_ids)))
        jhits = j.fetch_phase(jreq, want, "idx", pos)
        hits = p.fetch_phase(req, got, "idx", pos)
        assert [h["_source"] for h in hits] == [h["_source"] for h in jhits]
        assert [h["_score"] for h in hits] == pytest.approx(
            [h["_score"] for h in jhits], rel=SUM_RTOL)


def test_nested_on_a_segment_without_the_path(shards):
    """Shard 1's first segment holds no answers: its rows never match, the
    second segment's do; an unknown path matches nothing anywhere."""
    js, ps = shards
    want = _run_batch(js[1], ps[1], [
        {"query": _nested(_match(t), "sum"), "size": 20} for t in TEXTS])
    assert all(w.total for w in want)
    first = ps[1].reader.segments[1].doc_base
    assert all((w.doc_ids >= first).all() for w in want)
    want = _run_batch(js[1], ps[1], [
        {"query": _nested({"match_all": {}}, path="nope"), "size": 5}])
    assert want[0].total == 0


LIFE = [{"body": "great hotel", "answers": [
            {"user": "alice", "body": "loved the pool", "votes": 5},
            {"user": "bob", "body": "noisy room", "votes": 2}]},
        {"body": "quiet inn", "answers": [
            {"user": "alice", "body": "noisy street", "votes": 2}]},
        {"body": "no answers here"}]


@pytest.mark.parametrize("step", ["delete", "update", "reopen"])
def test_nested_lifecycle_matches_jax(tmp_path, step):
    """tests/test_nested.py's lifecycle: a deleted parent's objects never
    match, an update replaces its objects, a flush and a reopen keep the
    child blocks."""
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    engines = [JaxEngine(tmp_path / "jax", jms), Engine(tmp_path / "t", ms)]
    for e in engines:
        _index(e, LIFE, "")
        if step == "delete":
            e.delete("0")
        elif step == "update":
            e.index("1", {"body": "quiet inn", "answers": [
                {"user": "carol", "body": "peaceful stay", "votes": 4}]})
        e.refresh()
        if step == "reopen":
            e.flush()
            e.close()
    if step == "reopen":
        engines = [JaxEngine(tmp_path / "jax", jms),
                   Engine(tmp_path / "t", ms)]
    j = JaxShardSearcher(0, jax_device_reader_for(engines[0]), jms)
    p = ShardSearcher(0, device_reader_for(engines[1], device="cpu"), ms)
    assert any(s.nested for s in p.reader.segments)
    want = _run_batch(j, p, [
        {"query": _nested(q, "sum"), "size": 5} for q in (
            _match("noisy"), {"term": {"answers.user": "alice"}},
            _match("peaceful"))])
    ids = [{p.reader.doc_id(int(d)) for d in w.doc_ids} for w in want]
    assert ids == {"delete": [{"1"}, {"1"}, set()],
                   "update": [{"0"}, {"0"}, {"1"}],
                   "reopen": [{"0", "1"}, {"0", "1"}, set()]}[step]
    for e in engines:
        e.close()


AGGS = {
    "n": {"nested": {"path": "answers"}, "aggs": {
        "users": {"terms": {"field": "answers.user"}, "aggs": {
            "votes": {"stats": {"field": "answers.votes"}}}},
        "years": {"date_histogram": {"field": "answers.date",
                                     "interval": "year"}, "aggs": {
            "back": {"reverse_nested": {}}}},
        "popular": {"filter": {"range": {"answers.votes": {"gte": 10}}},
                    "aggs": {"u": {"terms": {"field": "answers.user"}}}},
        "parents": {"reverse_nested": {}, "aggs": {
            "tags": {"terms": {"field": "tag"}},
            "rank": {"avg": {"field": "rank"}}}}}},
    "none": {"nested": {"path": "nope"}},
    "alone": {"reverse_nested": {}, "aggs": {"t": {"terms": {
        "field": "tag"}}}},
}
AGG_BODY = {"query": {"match": {"body": "alpha beta"}}, "size": 5,
            "aggs": AGGS}


def test_nested_aggregation_partials_match_jax(shards):
    js, ps = shards
    jreq, req = jax_parse_search_request(AGG_BODY), \
        parse_search_request(AGG_BODY)
    for j, p in zip(js, ps):
        want, got = j.query_phase(jreq), p.query_phase(req)
        assert_same(got.agg_partials, want.agg_partials)
        assert want.agg_partials["n"]["doc_count"] > 0
        assert want.agg_partials["n"]["subs"]["popular"]["doc_count"] > 0


def test_nested_aggregations_merge_like_jax(shards):
    js, ps = shards
    jreq, req = jax_parse_search_request(AGG_BODY), \
        parse_search_request(AGG_BODY)
    want = jax_controller.merge_responses(
        "idx", jreq, [j.query_phase(jreq) for j in js], js, 0.0, jreq.aggs)
    got = controller.merge_responses(
        "idx", req, [p.query_phase(req) for p in ps], ps, 0.0, req.aggs)
    assert_same(got["aggregations"], want["aggregations"])
    assert got["hits"]["total"] == want["hits"]["total"]
    n = got["aggregations"]["n"]
    assert n["doc_count"] > n["parents"]["doc_count"] > 0
    assert got["aggregations"]["none"] == {"doc_count": 0}


def _reduce64(c_scores, c_mask, live, offsets, boost, mode):
    """float64 recompute of the reduce, each parent's children in child
    order; the f32 boost and the avg divisor as the bodies take them."""
    b, n = c_scores.shape[0], len(offsets) - 1
    out = np.zeros((b, n))
    hit = np.zeros((b, n), bool)
    for q in range(b):
        for p in range(n):
            rows = [c for c in range(offsets[p], offsets[p + 1])
                    if c_mask[q, c] and live[c]]
            if not rows:
                continue
            v = c_scores[q, rows].astype(np.float64)
            hit[q, p] = True
            val = {"none": 1.0, "max": v.max(), "min": v.min(),
                   "sum": v.sum(), "avg": v.sum() / len(rows)}[mode]
            out[q, p] = val * np.float64(boost[q])
    return out, hit


@pytest.mark.parametrize("mode", MODES)
def test_nested_reduce_plain_against_float64(mode):
    """The plain body against a float64 recompute in child order: ragged
    parents (none, one, many children), dead children, B = 5."""
    rng = np.random.default_rng(3)
    counts = rng.choice([0, 0, 1, 2, 3, 7], 40)
    counts[11] = 60
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nc = int(offsets[-1]) + 5                 # 5 padding rows
    scores = rng.uniform(-2, 5, (5, nc)).astype(np.float32)
    mask = rng.random((5, nc)) < 0.6
    live = rng.random(nc) < 0.9
    boost = np.float32([1.0, 2.5, 0.5, -1.0, 3.0])
    got_s, got_m = nested_ops.nested_reduce_plain(
        torch.from_numpy(scores), torch.from_numpy(mask),
        torch.from_numpy(live), torch.from_numpy(offsets),
        torch.from_numpy(boost), mode)
    want_s, want_m = _reduce64(scores, mask, live, offsets, boost, mode)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    assert got_m.numpy()[:, counts == 0].sum() == 0
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-5)
    if mode in ("none", "max", "min"):
        # one rounding (the boost) from the float64 value
        np.testing.assert_array_equal(got_s.numpy(),
                                      want_s.astype(np.float32))


def test_nested_reduce_plain_nan_and_signed_zero():
    """A NaN among the counted children gives NaN for max and min (a dead
    child's NaN does not); among equal zeros max keeps +0.0 and min -0.0,
    in either order; the sum of a lone -0.0 is +0.0."""
    nan = float("nan")
    scores = torch.tensor([[nan, 1.0, -0.0, 0.0, 0.0, -0.0, 2.0, nan,
                            -0.0]])
    mask = torch.ones_like(scores, dtype=torch.bool)
    live = torch.tensor([True] * 7 + [False, True])
    offsets = torch.tensor([0, 2, 4, 6, 8, 9], dtype=torch.int32)
    one = torch.ones(1)

    def run(mode):
        return nested_ops.nested_reduce_plain(scores, mask, live, offsets,
                                              one, mode)[0][0]
    mx, mn, sm = run("max"), run("min"), run("sum")
    assert torch.isnan(mx[0]) and torch.isnan(mn[0]) and torch.isnan(sm[0])
    # the dead child's NaN is not counted
    assert mx[3] == 2.0 and mn[3] == 2.0 and sm[3] == 2.0
    assert mx[1] == 0.0 and not torch.signbit(mx[1])
    assert mx[2] == 0.0 and not torch.signbit(mx[2])
    assert mn[1] == 0.0 and torch.signbit(mn[1])
    assert mn[2] == 0.0 and torch.signbit(mn[2])
    assert sm[4] == 0.0 and not torch.signbit(sm[4])
    assert torch.signbit(mx[4]) and torch.signbit(mn[4])
    with pytest.raises(ValueError):
        run("total")


def test_nested_block_from_arrays_serves_like_the_indexer(tmp_path):
    """A child block rebuilt from the indexer's arrays serves the same
    results through a reader over the carried blocks."""
    ms = MapperService()
    ms.merge("_doc", MAPPING)
    eng = Engine(tmp_path / "t", ms)
    _index(eng, _docs(n=40), "c", (20,), "c3")
    view = eng.acquire_searcher()
    segs = []
    for seg in view.segments:
        blk = seg.nested_blocks["answers"]
        c = blk.segment
        t = c.text_fields["answers.body"]
        carried = nested_block_from_arrays(
            blk.parent, "answers.body", terms=t.terms, uterms=t.uterms,
            utf=t.utf, doc_len=t.doc_len, df=t.df,
            num_children=c.num_docs, total_tokens=t.total_tokens,
            tokens=t.tokens,
            keyword={"answers.user": (c.keyword_fields["answers.user"].vocab,
                                      c.keyword_fields["answers.user"].ords)},
            numeric={f: (c.numeric_fields[f].values,
                         c.numeric_fields[f].exists)
                     for f in ("answers.date", "answers.votes")})
        np.testing.assert_array_equal(
            nested_offsets(carried.parent, seg.padded_docs),
            nested_offsets(blk.parent, seg.padded_docs))
        segs.append(dataclasses.replace(
            seg, nested_blocks={"answers": carried}))
    carried_reader = DeviceReader(SearcherView(segs, view.live_masks,
                                               view.generation), "cpu")
    p0 = ShardSearcher(0, device_reader_for(eng, device="cpu"), ms)
    p1 = ShardSearcher(0, carried_reader, ms)
    for body in BATCHES["no_leakage"][:2] + [
            {"query": _nested(_match("alpha gamma"), "avg"), "size": 10}]:
        req = parse_search_request(body)
        a, b = p0.query_phase(req), p1.query_phase(req)
        assert a.total == b.total > 0
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        np.testing.assert_array_equal(a.scores, b.scores)
    with pytest.raises(ValueError):
        nested_block_from_arrays(
            np.array([1, 0, -1], np.int32), "f", terms=["a"],
            uterms=np.zeros((3, 1), np.int32), utf=np.ones((3, 1),
                                                           np.float32),
            doc_len=np.ones(3, np.int32), df=np.ones(1, np.int32),
            num_children=2)
    eng.close()
