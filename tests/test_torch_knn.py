"""The knn lane through the port against the JAX package, end to end on the
CPU: one corpus (a text, a keyword, a dense_vector and a rank_vectors field,
docs without a vector, two segments and a delete) indexed into both
packages' Engine, the same requests through ``ShardSearcher.
query_phase_batch`` and ``query_phase``: the top-level ``knn`` section in
f32 and int8 with and without a ``filter``, hybrid fusion under RRF and the
weighted sum, the ``knn`` query leaf, rank_vectors MaxSim in f32 and int8, a
mapped field that no doc fills, and the 400s for bad requests and settings.

Totals must be equal and ids equal up to exact ties. Tolerances: cosines
2e-6 absolute (unit vectors at D = 16: the two packages sum the dot
products in other orders, a few f32 ulps); MaxSim 1e-5 absolute (a sum of
up to 5 such token maxima); RRF scores bit for bit (each fused score is a
sum of at most two exactly computed contributions, and the candidate lists
are equal); the weighted sum 1e-6 relative (a min-max normalization of
scores that agree to a few ulps).
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
from elasticsearch_tpu.search import jit_exec
from elasticsearch_tpu.search.phase import (
    ShardSearcher as JaxShardSearcher,
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, QueryParsingError)
from elasticsearch_tpu_torch.index import carry
from elasticsearch_tpu_torch.index.device_reader import (
    DeviceReader, device_reader_for)
from elasticsearch_tpu_torch.index.engine import Engine, SearcherView
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search import segment_exec
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)

COS_ATOL = 2e-6
MAXSIM_ATOL = 1e-5
WEIGHTED_RTOL = 1e-6
DIMS, TDIMS = 16, 8
MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "tag": {"type": "keyword"},
    "vec": {"type": "dense_vector", "dims": DIMS},
    "tok": {"type": "rank_vectors", "dims": TDIMS, "max_tokens": 8},
    "unused": {"type": "dense_vector", "dims": DIMS}}}
#: index name → settings, registered in both packages
INDICES = {
    "knn_f32": {},
    "knn_int8": {"index.knn.quantization": "int8"},
    "knn_weighted": {"index.search.hybrid.mode": "weighted",
                     "index.search.hybrid.lexical_weight": 0.3},
    "knn_rrf_k10": {"index.search.hybrid.rank_constant": 10},
}


def _docs(seed=11, n=260):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        d = {"body": " ".join(f"w{int(x)}" for x in
                              rng.integers(0, 9, size=int(rng.integers(1, 6)))),
             "tag": f"t{i % 3}"}
        if i % 9:
            d["vec"] = rng.standard_normal(DIMS).tolist()
        if i % 7:
            d["tok"] = rng.standard_normal(
                (int(rng.integers(1, 6)), TDIMS)).tolist()
        docs.append(d)
    return docs


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(jax engine, jax mapper, port engine, port mapper): the same docs
    indexed per doc with a refresh halfway (two segments), then a delete."""
    for name, settings in INDICES.items():
        jit_exec.configure_knn_plane(name, settings)
        segment_exec.configure_knn_plane(name, settings)
    tmp = tmp_path_factory.mktemp("knn")
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    jeng, eng = JaxEngine(tmp / "jax", jms), Engine(tmp / "torch", ms)
    docs = _docs()
    for e in (jeng, eng):
        for i, d in enumerate(docs):
            e.index(str(i), d)
            if i == len(docs) // 2:
                e.refresh()
        e.refresh()
        e.delete("10")
        e.refresh()
    return jeng, jms, eng, ms


def _searchers(engines, index="knn_f32"):
    jeng, jms, eng, ms = engines
    reader = device_reader_for(eng, device="cpu")
    assert len(reader.segments) == 2
    return (JaxShardSearcher(0, jax_device_reader_for(jeng), jms,
                             index_name=index),
            ShardSearcher(0, reader, ms, index_name=index))


def _qvec(seed, dims=DIMS):
    return np.random.default_rng(seed).standard_normal(dims).tolist()


def _qtoks(seed, t):
    return np.random.default_rng(seed).standard_normal((t, TDIMS)).tolist()


def _knn(field="vec", qv=None, seed=0, k=10, nc=50, **extra):
    return {"field": field, "query_vector": qv if qv is not None
            else _qvec(seed), "k": k, "num_candidates": nc, **extra}


def _assert_same(got, want, atol=0.0, rtol=0.0):
    """Equal totals; the same ids up to exact ties at the reference's
    tolerance; scores within it."""
    assert got.total == want.total
    assert len(got.doc_ids) == len(want.doc_ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=rtol, atol=atol)
    want_score = dict(zip(want.doc_ids.tolist(), want.scores.tolist()))
    cut = float(want.scores[-1]) if len(want.scores) else 0.0
    for i, (g, w) in enumerate(zip(got.doc_ids.tolist(),
                                   want.doc_ids.tolist())):
        if g != w:
            s = float(got.scores[i])
            assert abs(want_score.get(g, cut) - s) <= atol + rtol * abs(s), \
                f"hit {i}: doc {g} (score {s}) where the reference has {w}"


def _run_both(js, ps, bodies, atol=0.0, rtol=0.0, exact=False):
    """The batch through query_phase_batch and its first request through
    query_phase, in both packages. Where the JAX package's batch declines
    (a field no segment carries: its eager lane serves the request), its
    query_phase of each request is the reference."""
    jreqs = [jax_parse_search_request(b) for b in bodies]
    want = js.query_phase_batch(jreqs) or [js.query_phase(r) for r in jreqs]
    got = ps.query_phase_batch([parse_search_request(b) for b in bodies])
    assert got is not None, "a batch fell back"
    pairs = list(zip(got, want))
    pairs.append((ps.query_phase(parse_search_request(bodies[0])),
                  js.query_phase(jax_parse_search_request(bodies[0]))))
    for g, w in pairs:
        _assert_same(g, w, atol, rtol)
        if exact:
            np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
            np.testing.assert_array_equal(g.scores.view(np.int32),
                                          w.scores.view(np.int32))
    return got


FILTER = {"term": {"tag": "t1"}}

CASES = {
    # name: (index, bodies, atol, rtol, exact)
    "dense_f32": ("knn_f32", [
        {"knn": _knn(seed=s, k=k), "size": size}
        for s, k, size in ((1, 10, 10), (2, 30, 20), (3, 50, 100))],
        COS_ATOL, 0.0, False),
    "dense_f32_filter_boost": ("knn_f32", [
        {"knn": _knn(seed=s, filter=FILTER, boost=b), "size": 25}
        for s, b in ((4, 1.0), (5, 2.5))], COS_ATOL, 0.0, False),
    "dense_f32_small_nc": ("knn_f32", [
        {"knn": _knn(seed=s, k=5, nc=5), "from": 2, "size": 5}
        for s in (6, 7)], COS_ATOL, 0.0, False),
    "dense_int8": ("knn_int8", [
        {"knn": _knn(seed=s), "size": 10} for s in (8, 9, 10)],
        COS_ATOL, 0.0, False),
    "dense_int8_filter": ("knn_int8", [
        {"knn": _knn(seed=s, filter=[FILTER, {"match": {"body": "w1"}}]),
         "size": 40} for s in (11, 12)], COS_ATOL, 0.0, False),
    "hybrid_rrf": ("knn_f32", [
        {"query": {"match": {"body": t}}, "knn": _knn(seed=s, k=20, nc=30,
                                                      boost=b), "size": 40}
        for t, s, b in (("w1 w2", 13, 1.0), ("w3 w0", 14, 2.0),
                        ("w4 w5", 15, 0.5))], 0.0, 0.0, True),
    "hybrid_rrf_k10_filter": ("knn_rrf_k10", [
        {"query": {"match": {"body": t}}, "knn": _knn(seed=s, filter=FILTER),
         "size": 15} for t, s in (("w2 w3", 16), ("w6 w7", 17))],
        0.0, 0.0, True),
    "hybrid_weighted": ("knn_weighted", [
        {"query": {"match": {"body": t}}, "knn": _knn(seed=s, boost=b),
         "size": 30} for t, s, b in (("w1 w8", 18, 1.0), ("w4 w2", 19, 3.0))],
        0.0, WEIGHTED_RTOL, False),
    "rank_vectors_f32": ("knn_f32", [
        {"knn": _knn("tok", _qtoks(s, t), k=10, nc=40), "size": 10}
        for s, t in ((20, 3), (21, 1), (22, 5))], MAXSIM_ATOL, 0.0, False),
    "rank_vectors_int8": ("knn_int8", [
        {"knn": _knn("tok", _qtoks(s, t), k=10, nc=40,
                     filter={"term": {"tag": "t2"}}), "size": 10}
        for s, t in ((23, 4), (24, 2))], MAXSIM_ATOL, 0.0, False),
    "rank_vectors_hybrid": ("knn_f32", [
        {"query": {"match": {"body": "w3 w5"}},
         "knn": _knn("tok", _qtoks(25, 3), k=10, nc=20), "size": 20}],
        0.0, 0.0, True),
    "unfilled_field": ("knn_f32", [
        {"knn": _knn("unused", seed=26), "size": 10}], 0.0, 0.0, True),
    "unfilled_field_hybrid": ("knn_f32", [
        {"query": {"match": {"body": "w1"}}, "knn": _knn("unused", seed=27),
         "size": 10}], 0.0, 0.0, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_knn_lane_matches_jax(engines, name):
    index, bodies, atol, rtol, exact = CASES[name]
    js, ps = _searchers(engines, index)
    got = _run_both(js, ps, bodies, atol, rtol, exact)
    if name == "unfilled_field":          # no hit at all
        assert got[0].total == 0 and len(got[0].doc_ids) == 0
    elif name == "unfilled_field_hybrid":   # the lexical list alone, fused
        assert got[0].total > 0 and len(got[0].doc_ids) == 10


def test_knn_leaf_alias_matches_jax(engines):
    """The query-DSL ``knn`` leaf goes through the exact lane and reads the
    same device copy of the normalized vectors as the knn lane."""
    js, ps = _searchers(engines)
    bodies = [{"query": {"knn": {"field": "vec", "query_vector": _qvec(s),
                                 "boost": b}}, "size": 30}
              for s, b in ((30, 1.0), (31, 2.0))]
    _run_both(js, ps, bodies, COS_ATOL * 2)
    body = {"query": {"bool": {"must": [{"match": {"body": "w1"}}],
                               "should": [{"knn": {"field": "vec",
                                                   "query_vector": _qvec(32)}}]
                               }}, "size": 20}
    _run_both(js, ps, [body], COS_ATOL * 2)
    reader = ps.reader
    assert all(s.vector["vec"].vecs is not None for s in reader.segments)
    # the knn lane under f32 reuses that copy
    ps.query_phase(parse_search_request({"knn": _knn(seed=33)}))
    pack = segment_exec.vector_pack_for(
        reader, "vec", segment_exec.knn_plane_config("knn_f32"))
    assert all(p["vecs"] is s.vector["vec"].vecs
               for p, s in zip(pack.segs, reader.segments))


@pytest.mark.parametrize("field", ["vec", "tok"])
def test_device_vector_columns_match_jax_host_columns(engines, field):
    """The reader's device columns hold the JAX package's host knn columns
    bit for bit: the normalized f32 rows (tokens), and the int8 rows with
    their scale and offset, quantized over the whole padded array."""
    jeng, _, eng, _ = engines
    reader = DeviceReader(eng.acquire_searcher(), device="cpu")
    jview = jeng.acquire_searcher()
    assert len(jview.segments) == len(reader.segments)
    for jseg, dseg in zip(jview.segments, reader.segments):
        for quant in ("f32", "int8"):
            host, multi, dims = jit_exec._host_knn_column(jseg, field, quant)
            col = reader.fetch_vectors(dseg, field, quant)
            assert multi == (field == "tok") and dims == col.column.dims
            if quant == "int8":
                np.testing.assert_array_equal(col.qvecs.numpy(), host["vecs"])
                assert (col.scale, col.offset) == (host["scale"],
                                                   host["offset"])
            else:
                np.testing.assert_array_equal(col.vecs.numpy(), host["vecs"])
    assert reader.fetch_vectors(reader.segments[0], "missing", "f32") is None


def test_exists_on_dense_vector_matches_jax(engines):
    js, ps = _searchers(engines)
    _run_both(js, ps, [{"query": {"exists": {"field": "vec"}}, "size": 300},
                       {"query": {"exists": {"field": "vec", "boost": 2.0}},
                        "size": 300}])


def test_reader_holds_no_vector_matrix_until_knn(engines, tmp_path):
    """A reader that serves no knn request holds no vector matrix: only the
    [N] exists masks and token counts; the lane puts one copy per (segment,
    field, quantization) on the device at first use."""
    _, _, eng, ms = engines
    reader = DeviceReader(eng.acquire_searcher(), device="cpu")
    ps = ShardSearcher(0, reader, ms, index_name="knn_int8")
    before = reader.device_bytes()
    ps.query_phase_batch([parse_search_request(
        {"query": {"match": {"body": "w1"}}})])
    assert reader.device_bytes() == before
    for s in reader.segments:
        for col in list(s.vector.values()) + list(s.mvector.values()):
            assert col.vecs is None and col.qvecs is None
    ps.query_phase(parse_search_request({"knn": _knn(seed=40)}))
    int8 = [s.vector["vec"].qvecs for s in reader.segments]
    assert all(t is not None and t.dtype.itemsize == 1 for t in int8)
    assert all(s.vector["vec"].vecs is None for s in reader.segments)
    assert reader.device_bytes() == before + sum(t.numel() for t in int8)
    ps.query_phase(parse_search_request({"knn": _knn(seed=41)}))
    assert [s.vector["vec"].qvecs for s in reader.segments] == int8


def test_mixed_batches_serve_one_by_one(engines):
    js, ps = _searchers(engines)
    bodies = [{"knn": _knn(seed=50)}, {"query": {"match": {"body": "w1"}}},
              {"knn": _knn(seed=51, nc=60)}]
    assert ps.query_phase_batch([parse_search_request(bodies[0]),
                                 parse_search_request(bodies[1])]) is None
    assert ps.query_phase_batch([parse_search_request(bodies[0]),
                                 parse_search_request(bodies[2])]) is None
    for b in bodies:
        _assert_same(ps.query_phase(parse_search_request(b)),
                     js.query_phase(jax_parse_search_request(b)), COS_ATOL)


def test_carried_vector_columns_score_like_jax(engines):
    """Segments rebuilt in the port from the JAX package's arrays, vector
    columns included, serve the knn lane alike."""
    jeng, _, _, ms = engines
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
            vectors={n: (v.vecs, v.exists)
                     for n, v in s.vector_fields.items()},
            mvectors={n: (v.vecs, v.lens, v.exists)
                      for n, v in s.mvector_fields.items()}))
    reader = DeviceReader(SearcherView([c[0] for c in carried],
                                       [c[1] for c in carried], 1),
                          device="cpu")
    js = JaxShardSearcher(0, jax_device_reader_for(jeng), engines[1],
                          index_name="knn_int8")
    ps = ShardSearcher(0, reader, ms, index_name="knn_int8")
    for name in ("dense_int8", "rank_vectors_int8", "hybrid_rrf"):
        _, bodies, atol, rtol, _ = CASES[name]
        want = js.query_phase_batch([jax_parse_search_request(b)
                                     for b in bodies])
        got = ps.query_phase_batch([parse_search_request(b) for b in bodies])
        for g, w in zip(got, want):
            _assert_same(g, w, atol, rtol)


GOOD = {"field": "vec", "query_vector": [0.1] * DIMS}


@pytest.mark.parametrize("body", [
    {"knn": {}},
    {"knn": {"field": "vec"}},
    {"knn": {"field": "vec", "query_vector": []}},
    {"knn": {**GOOD, "k": 0}},
    {"knn": {**GOOD, "k": "x"}},
    {"knn": {**GOOD, "k": 5, "num_candidates": 4}},
    {"knn": {**GOOD, "num_candidates": 100_001}},
    {"knn": {**GOOD, "boost": 0}},
    {"knn": {**GOOD, "nope": 1}},
    {"knn": {"field": "tok", "query_vector": [[0.1], [0.1, 0.2]]}},
    {"knn": GOOD, "sort": [{"tag": "asc"}]},
    {"knn": GOOD, "aggs": {"a": {"terms": {"field": "tag"}}}},
    {"knn": GOOD, "post_filter": {"term": {"tag": "t0"}}},
    {"knn": GOOD, "min_score": 1.0},
    {"knn": GOOD, "search_after": [1.0, 2]},
    {"knn": GOOD, "terminate_after": 5},
])
def test_bad_knn_sections_are_the_same_400(body):
    with pytest.raises(JaxQueryParsingError) as want:
        jax_parse_search_request(body)
    with pytest.raises(QueryParsingError) as got:
        parse_search_request(body)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knn", [
    {"field": "body", "query_vector": [0.1] * DIMS},
    {"field": "nope", "query_vector": [0.1] * DIMS},
    {"field": "vec", "query_vector": [0.1] * (DIMS - 1)},
    {"field": "vec", "query_vector": [[0.1] * DIMS]},
    {"field": "tok", "query_vector": [0.1] * TDIMS},
    {"field": "tok", "query_vector": [[0.1] * (TDIMS + 1)]},
])
def test_knn_mapping_violations_are_the_same_400(engines, knn):
    js, ps = _searchers(engines)
    with pytest.raises(JaxQueryParsingError) as want:
        js.query_phase(jax_parse_search_request({"knn": knn}))
    for serve in (lambda r: ps.query_phase(r),
                  lambda r: ps.query_phase_batch([r])):
        with pytest.raises(QueryParsingError) as got:
            serve(parse_search_request({"knn": knn}))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("settings", [
    {"index.knn.quantization": "int4"},
    {"index.search.hybrid.mode": "max"},
    {"index.search.hybrid.rank_constant": 0},
    {"index.search.hybrid.rank_constant": "x"},
    {"index.search.hybrid.lexical_weight": 1.5},
    {"index.search.hybrid.lexical_weight": "heavy"},
])
def test_bad_knn_settings_are_the_same_400(settings):
    with pytest.raises(JaxIllegalArgumentError) as want:
        jit_exec.validate_knn_settings(settings)
    with pytest.raises(IllegalArgumentError) as got:
        segment_exec.validate_knn_settings(settings)
    assert str(got.value) == str(want.value)


def test_knn_settings_parse_like_jax():
    for settings in ({}, None, {"index.knn.quantization": "INT8",
                                "index.search.hybrid.mode": "Weighted",
                                "index.search.hybrid.rank_constant": "7",
                                "index.search.hybrid.lexical_weight": ""}):
        want = jit_exec.validate_knn_settings(settings)
        got = segment_exec.validate_knn_settings(settings)
        assert (got.quantization, got.fusion_mode, got.rank_constant,
                got.lexical_weight) == (want.quantization, want.fusion_mode,
                                        want.rank_constant,
                                        want.lexical_weight)
