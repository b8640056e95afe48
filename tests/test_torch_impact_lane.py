"""The impact lane through the port against the JAX package, end to end on
the CPU: one corpus (~40 whitespace terms drawn Zipf-like, a term in every
doc whose impacts quantize to 0 at 8 bits, two segments and a delete)
indexed into both packages' Engine, indices registered in both
(``jit_exec.configure_impact_plane``, ``segment_exec.configure_impact_plane``)
at 8 bits with 16-row blocks and at 16 bits with 32-row blocks, and the same
requests through ``ShardSearcher.query_phase_batch`` and ``query_phase``: the
eager arm, the block-max pruned arm (``track_total_hits: false``), a verified
``search_after`` cursor, a cross-lane cursor and the other declines that the
exact arm serves, the rescore arm, the settings' 400s, and the refusals.

The lane is integer-exact up to one f32 multiply, so its answers are held
bit for bit: scores, ids, totals and the block counters
(``impact_index_stats``). What the exact arm serves after a decline is held
as the other slices hold it: totals and ids equal up to exact ties, scores
within 1e-5 (BM25 sums in float32, a few ulps apart).
"""

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import (
    IllegalArgumentError as JaxIllegalArgumentError,
    QueryParsingError as JaxQueryParsingError)
from elasticsearch_tpu.index.device_reader import (
    device_reader_for as jax_device_reader_for)
from elasticsearch_tpu.index.engine import Engine as JaxEngine
from elasticsearch_tpu.mapping import MapperService as JaxMapperService
from elasticsearch_tpu.ops.similarity import BM25Params as JaxBM25Params
from elasticsearch_tpu.search import jit_exec
from elasticsearch_tpu.search.phase import (
    ShardSearcher as JaxShardSearcher,
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, NotPortedError, QueryParsingError)
from elasticsearch_tpu_torch.index.device_reader import device_reader_for
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops.similarity import BM25Params
from elasticsearch_tpu_torch.search import segment_exec
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)

EXACT_ATOL = 1e-5
MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "title": {"type": "text", "analyzer": "whitespace"},
    "old": {"type": "text", "analyzer": "whitespace",
            "similarity": "classic"}}}
INDICES = {
    "imp8": {"index.search.impact_plane": True,
             "index.search.impact.bits": 8,
             "index.search.impact.block_rows": 16},
    "imp16": {"index.search.impact_plane": "true",
              "index.search.impact.bits": "16",
              "index.search.impact.block_rows": 32},
}


def _words(rng, n):
    return " ".join(f"w{min(int(x), 40)}" for x in rng.zipf(1.3, n))


def _docs(seed=7, n=300):
    rng = np.random.default_rng(seed)
    return [{"body": _words(rng, int(rng.integers(3, 12))) + " common",
             "title": _words(rng, 3), "old": _words(rng, 4)}
            for _ in range(n)]


def _index(path, engine_cls, mapper_cls):
    """The docs indexed per doc with a refresh halfway (two segments), then
    a delete. → (engine, mapper)."""
    ms = mapper_cls()
    ms.merge("_doc", MAPPING)
    eng = engine_cls(path, ms)
    docs = _docs()
    for i, d in enumerate(docs):
        eng.index(str(i), d)
        if i == len(docs) // 2:
            eng.refresh()
    eng.refresh()
    eng.delete("10")
    eng.refresh()
    return eng, ms


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(jax engine, jax mapper, port engine, port mapper) over one corpus."""
    for name, settings in INDICES.items():
        jit_exec.configure_impact_plane(name, settings)
        segment_exec.configure_impact_plane(name, settings)
    tmp = tmp_path_factory.mktemp("impact")
    return (*_index(tmp / "jax", JaxEngine, JaxMapperService),
            *_index(tmp / "torch", Engine, MapperService))


def _searchers(engines, index="imp8", dfs_stats=None):
    jeng, jms, eng, ms = engines
    reader = device_reader_for(eng, device="cpu")
    assert len(reader.segments) == 2
    return (JaxShardSearcher(0, jax_device_reader_for(jeng), jms,
                             index_name=index, dfs_stats=dfs_stats),
            ShardSearcher(0, reader, ms, index_name=index,
                          dfs_stats=dfs_stats))


def _stats(index):
    """Both packages' impact_index_stats of ``index`` (its counters; the
    derived skip ratio aside)."""
    return tuple({k: v for k, v in st.items() if k != "skip_ratio"}
                 for st in (jit_exec.impact_index_stats(index),
                            segment_exec.impact_index_stats(index)))


def _reasons():
    return (dict(jit_exec.cache_stats()["impact_fallback_reasons"]),
            segment_exec.impact_fallback_reasons())


def _delta(after, before):
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def _assert_bit_equal(got, want):
    assert got.total == want.total
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
    np.testing.assert_array_equal(got.scores.view(np.int32),
                                  want.scores.view(np.int32))


def _assert_close(got, want, atol=EXACT_ATOL):
    """Equal totals; the same ids up to exact ties; scores within atol."""
    assert got.total == want.total
    assert len(got.doc_ids) == len(want.doc_ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=atol)
    want_score = dict(zip(want.doc_ids.tolist(), want.scores.tolist()))
    for i, (g, w) in enumerate(zip(got.doc_ids.tolist(),
                                   want.doc_ids.tolist())):
        if g != w:
            assert abs(want_score.get(g, -1.0) - float(got.scores[i])) <= \
                atol, f"hit {i}: doc {g} where the reference has {w}"


def _run_lane(js, ps, bodies, index):
    """The batch through both packages' query_phase_batch, then its first
    request alone through query_phase; every request must be served by the
    impact lane (its admissions count them) and agree bit for bit, the
    lane's block counters included."""
    before = _stats(index)
    jreqs = [jax_parse_search_request(b) for b in bodies]
    want = js.query_phase_batch(jreqs)
    got = ps.query_phase_batch([parse_search_request(b) for b in bodies])
    assert want is not None and got is not None
    want.append(js.query_phase(jax_parse_search_request(bodies[0])))
    got.append(ps.query_phase(parse_search_request(bodies[0])))
    for g, w in zip(got, want):
        _assert_bit_equal(g, w)
    after = _stats(index)
    d_jax, d_port = (_delta(a, b) for a, b in zip(after, before))
    assert d_port == d_jax
    assert d_port["admissions"] == len(bodies) + 1
    return got, d_port


BODIES = [{"query": {"match": {"body": "w1 w2"}}, "size": 10},
          {"query": {"match": {"body": {"query": "w3 w17 w30",
                                        "boost": 2.5}}}, "size": 25},
          {"query": {"term": {"body": "w5"}}, "size": 5, "from": 2},
          {"query": {"match": {"body": "common w2 w2"}}, "size": 40},
          {"query": {"match": {"body": "w9 zzz"}}, "size": 7}]


@pytest.mark.parametrize("index", list(INDICES))
def test_eager_and_pruned_arms_bit_equal(engines, index):
    js, ps = _searchers(engines, index)
    eager, d_eager = _run_lane(js, ps, BODIES, index)
    assert d_eager.get("blocks_skipped", 0) == 0
    pruned_bodies = [dict(b, track_total_hits=False) for b in BODIES]
    pruned, d_pruned = _run_lane(js, ps, pruned_bodies, index)
    assert d_pruned["blocks_skipped"] > 0
    for p, e in zip(pruned, eager):
        np.testing.assert_array_equal(p.doc_ids, e.doc_ids)
        np.testing.assert_array_equal(p.scores.view(np.int32),
                                      e.scores.view(np.int32))
        assert p.total <= e.total


def test_two_bm25_settings_share_one_reader(engines, tmp_path):
    """Two searchers with different BM25 k1 and b on one port reader: each
    gets its own impact column, on the host and on the device. The second
    is held against the JAX package on an engine of its own: the JAX
    package's device block cache keys a column by its engine, segment, bits
    and block rows, not by k1 and b, so on a shared reader it would hand the
    second searcher the first one's impacts."""
    js, ps = _searchers(engines, "imp16")
    ps2 = ShardSearcher(0, ps.reader, engines[3], index_name="imp16")
    ps2.ctx.bm25 = BM25Params(k1=2.0, b=0.3)
    jeng2, jms2 = _index(tmp_path / "jax", JaxEngine, JaxMapperService)
    js2 = JaxShardSearcher(0, jax_device_reader_for(jeng2), jms2,
                           index_name="imp16")
    js2.ctx.bm25 = JaxBM25Params(k1=2.0, b=0.3)
    bodies = BODIES[:2] + [dict(b, track_total_hits=False)
                           for b in BODIES[:2]]
    first, _ = _run_lane(js, ps, bodies, "imp16")
    second, _ = _run_lane(js2, ps2, bodies, "imp16")
    assert any(not np.array_equal(a.scores, b.scores)
               for a, b in zip(first, second))
    keys = {k for s in ps.reader.segments for k in s.impacts}
    assert {k[3:] for k in keys if k[:3] == ("body", 16, 32)} == \
        {(1.2, 0.75), (2.0, 0.3)}


def test_zero_quantized_term(engines):
    """``common`` is in every doc: its idf quantizes to 0 at 8 bits, so every
    doc matches at score 0, and the sweep still runs its blocks."""
    js, ps = _searchers(engines, "imp8")
    for tth in (True, False):
        got, _ = _run_lane(js, ps, [
            {"query": {"match": {"body": "common"}}, "size": 12,
             "track_total_hits": tth}], "imp8")
        assert (got[0].scores == 0).all() and len(got[0].doc_ids) == 12


def test_search_after_cursor_is_served_by_the_lane(engines):
    js, ps = _searchers(engines, "imp16")
    first, _ = _run_lane(js, ps, [
        {"query": {"match": {"body": "w2 w4"}}, "size": 6}], "imp16")
    cursor = [float(first[0].scores[-1]), int(first[0].doc_ids[-1])]
    _run_lane(js, ps, [
        {"query": {"match": {"body": "w2 w4"}}, "size": 6,
         "search_after": cursor}], "imp16")


def _run_declined(js, ps, bodies, reason):
    """The lane declines the batch under ``reason`` in both packages; the
    exact arm (the JAX package's serial path where its batch declines too)
    serves each request."""
    before = _reasons()
    want = [js.query_phase(jax_parse_search_request(b)) for b in bodies]
    got = [ps.query_phase(parse_search_request(b)) for b in bodies]
    for g, w in zip(got, want):
        _assert_close(g, w)
    d_jax, d_port = (_delta(a, b) for a, b in zip(_reasons(), before))
    assert d_port == d_jax
    assert set(d_port) == {reason}


def test_cross_lane_cursor_declines_to_the_exact_arm(engines):
    js, ps = _searchers(engines, "imp8")
    first = ps.query_phase(parse_search_request(
        {"query": {"match": {"body": "w2 w4"}}, "size": 6}))
    # a cursor this quantization did not mint (the exact scorer's float)
    cursor = [float(first.scores[-1]) + 1e-3, int(first.doc_ids[-1])]
    _run_declined(js, ps, [{"query": {"match": {"body": "w2 w4"}},
                            "size": 6, "search_after": cursor}],
                  "cross-lane-cursor")


@pytest.mark.parametrize("case", ["operator_and", "msm_2", "mixed_fields",
                                  "dfs"])
def test_declines_are_served_by_the_exact_arm(engines, case):
    dfs = None
    if case == "dfs":
        dfs = {"df": {("body", "w1"): 90, ("body", "w2"): 40},
               "doc_count": {"body": 900}, "avgdl": {"body": 8.5}}
    js, ps = _searchers(engines, "imp8", dfs_stats=dfs)
    bodies, reason = {
        "operator_and": ([{"query": {"match": {"body": {
            "query": "w1 w2", "operator": "and"}}}, "size": 8}],
            "ineligible-query"),
        "msm_2": ([{"query": {"match": {"body": {
            "query": "w1 w2 w3", "minimum_should_match": 2}}},
            "size": 8}], "ineligible-query"),
        "mixed_fields": ([{"query": {"match": {"body": "w1 w2"}}},
                          {"query": {"match": {"title": "w1 w3"}}}],
                         "mixed-fields"),
        "dfs": ([{"query": {"match": {"body": "w1 w2"}}, "size": 8}],
                "dfs-stats"),
    }[case]
    if case == "mixed_fields":
        # one batch: the lane declines it whole, and so does the exact arm
        # (two plan signatures); the caller then serves each request alone
        before = _reasons()
        assert js.query_phase_batch([jax_parse_search_request(b)
                                     for b in bodies]) is None
        assert ps.query_phase_batch([parse_search_request(b)
                                     for b in bodies]) is None
        d_jax, d_port = (_delta(a, b) for a, b in zip(_reasons(), before))
        assert d_port == d_jax == {reason: 1}
        return
    _run_declined(js, ps, bodies, reason)


def test_classic_similarity_declines_and_the_exact_arm_refuses(engines):
    """A classic-similarity field is not the lane's: both packages decline
    it; the port's exact arm does not score classic yet and refuses."""
    js, ps = _searchers(engines, "imp8")
    body = {"query": {"match": {"old": "w1 w2"}}, "size": 8}
    before = _reasons()
    js.query_phase(jax_parse_search_request(body))
    with pytest.raises(NotPortedError):
        ps.query_phase(parse_search_request(body))
    d_jax, d_port = (_delta(a, b) for a, b in zip(_reasons(), before))
    assert d_port == d_jax == {"ineligible-query": 1}


def _rescore_body(q, rq, window, mode, qw=1.0, rw=1.5, size=10, boost=1.0):
    return {"query": {"match": {"body": q}}, "size": size,
            "rescore": {"window_size": window, "query": {
                "rescore_query": {"match": {"body": {"query": rq,
                                                     "boost": boost}}},
                "query_weight": qw, "rescore_query_weight": rw,
                "score_mode": mode}}}


@pytest.mark.parametrize("index,mode", [("imp8", "total"), ("imp16", "max")])
def test_rescore_arm_bit_equal(engines, index, mode):
    js, ps = _searchers(engines, index)
    bodies = [_rescore_body("w1 w2", "w3 w4", 24, mode),
              _rescore_body("w5 w6 w7", "w1", 6, mode, qw=0.7, rw=2.0,
                            boost=1.5),
              _rescore_body("w2", "w2 w8", 3, mode, size=5),
              _rescore_body("w11 w3", "zzz", 12, mode, qw=1.0, rw=0.5)]
    _run_lane(js, ps, bodies, index)


def test_rescore_refusals_and_400s(engines):
    js, ps = _searchers(engines, "imp8")
    plain = ShardSearcher(0, ps.reader, ps.mapper_service, index_name="")
    with pytest.raises(NotPortedError):
        plain.query_phase(parse_search_request(
            _rescore_body("w1", "w2", 10, "total")))
    # the rescore query is not the lane's: no arm admits the request
    body = _rescore_body("w1", "w2", 10, "total")
    body["rescore"]["query"]["rescore_query"] = {"match": {"body": {
        "query": "w1 w2", "operator": "and"}}}
    with pytest.raises(NotPortedError):
        ps.query_phase(parse_search_request(body))
    for bad in ({"query": {"match": {"body": "w1"}},
                 "rescore": {"query": {}}},
                {"query": {"match": {"body": "w1"}},
                 "rescore": {"query": {"rescore_query": {"match_all": {}},
                                       "score_mode": "sum"}}},
                {"query": {"match": {"body": "w1"}}, "sort": ["_score"],
                 "rescore": {"query": {"rescore_query": {"match_all": {}}}}}):
        with pytest.raises(JaxQueryParsingError):
            jax_parse_search_request(bad)
        with pytest.raises(QueryParsingError):
            parse_search_request(bad)


def test_k_above_the_sweep_cap_is_refused(engines):
    """The sweep once refused k > 1024; it now serves any k. A pruned
    request at k = 1,500 (more than the corpus holds) is bit-equal to the
    JAX pruned arm, block counters included, and to the eager arm."""
    js, ps = _searchers(engines, "imp8")
    body = {"query": {"match": {"body": "w1 common"}}, "size": 1500}
    pruned, _ = _run_lane(js, ps, [dict(body, track_total_hits=False)],
                          "imp8")
    eager, _ = _run_lane(js, ps, [body], "imp8")
    assert len(eager[0].doc_ids) == eager[0].total > 0
    np.testing.assert_array_equal(pruned[0].doc_ids, eager[0].doc_ids)
    np.testing.assert_array_equal(pruned[0].scores.view(np.int32),
                                  eager[0].scores.view(np.int32))


@pytest.mark.parametrize("settings", [
    {"index.search.impact.bits": 12},
    {"index.search.impact.bits": "x"},
    {"index.search.impact.block_rows": 1000},
    {"index.search.impact.block_rows": 0},
    {"index.search.impact.max_terms": 0},
    {"index.search.impact.bits": 16, "index.search.impact.max_terms": 128},
    {"index.search.impact.max_terms": 256},
])
def test_settings_400s(settings):
    settings = {"index.search.impact_plane": True, **settings}
    with pytest.raises(JaxIllegalArgumentError) as want:
        jit_exec.configure_impact_plane("bad_settings", settings)
    with pytest.raises(IllegalArgumentError) as got:
        segment_exec.configure_impact_plane("bad_settings", settings)
    assert str(got.value) == str(want.value)
    assert segment_exec.impact_plane_config("bad_settings") is None
    segment_exec.configure_impact_plane("off", {"index.search.impact.bits":
                                                12})
    assert segment_exec.impact_plane_config("off") is None
