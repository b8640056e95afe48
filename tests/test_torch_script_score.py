"""script_score through the port against the JAX package, end to end on the
CPU: one corpus (a text field, two ``double`` columns with missing values, a
keyword and an 8-d dense_vector, two segments and a delete) indexed into
both packages' Engine; the ``script_score`` query and ``function_score``
with a ``script_score`` function (``_score``, params, missing doc values,
``cosineSimilarity`` / ``dotProduct``) through ``ShardSearcher.
query_phase_batch`` and ``query_phase``; ``script_fields`` through
``fetch_phase`` (expressions through K12's plain version, GroovyLite per
hit); the ``template`` query.

Totals must be equal and ids equal up to exact ties. Scores within 1e-6
relative where ``log``/``log10``/``exp``/``sqrt``/``pow`` enter (XLA's CPU
approximations and the C library's differ by an ulp), 4.8e-7 where only
``+ - * /`` do (the jitted reference contracts ``a*b+c`` into an FMA, eager
torch rounds each op). Vector scripts within 2e-6 absolute (unit vectors at
D = 8: the two packages sum the dot products in other orders). Script
fields computed without libm functions are equal; with them 1e-6 relative.
"""

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import (
    QueryParsingError as JaxQueryParsingError)
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
from elasticsearch_tpu_torch.ops import script_ops
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)

PINNED_RTOL = 4.8e-7
TRANSCENDENTAL_RTOL = 1e-6
COS_ATOL = 2e-6
DIMS = 8
MAPPING = {"properties": {"body": {"type": "text"},
                          "rank": {"type": "double"},
                          "pop": {"type": "double"},
                          "tag": {"type": "keyword"},
                          "vec": {"type": "dense_vector", "dims": DIMS}}}
VOCAB = [f"w{i:02d}" for i in range(10)]


def _docs(seed=21, n=220):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(VOCAB) + 1)
    p /= p.sum()
    docs = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(
            VOCAB, size=int(rng.integers(1, 10)), p=p)),
             "tag": f"t{i % 3}"}
        if i % 6:
            d["rank"] = float(np.round(rng.uniform(0.0, 100.0), 3))
        if i % 4:
            d["pop"] = float(np.round(rng.uniform(-5.0, 50.0), 2))
        if i % 9:
            d["vec"] = rng.standard_normal(DIMS).tolist()
        docs.append(d)
    return docs


def _index(tmp, docs):
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    jeng, eng = JaxEngine(tmp / "jax", jms), Engine(tmp / "torch", ms)
    for e in (jeng, eng):
        for i, d in enumerate(docs):
            e.index(str(i), d)
            if i == len(docs) // 2:
                e.refresh()
        e.refresh()
        e.delete("7")
        e.refresh()
    return jeng, jms, eng, ms


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    jeng, jms, eng, ms = _index(tmp_path_factory.mktemp("script"), _docs())
    reader = device_reader_for(eng, device="cpu")
    assert len(reader.segments) == 2
    return (JaxShardSearcher(0, jax_device_reader_for(jeng), jms),
            ShardSearcher(0, reader, ms))


def _qvec(seed):
    return np.random.default_rng(seed).standard_normal(DIMS).tolist()


def _ss(text, source, params=None, size=25, boost=1.0):
    script = {"source": source}
    if params is not None:
        script["params"] = params
    inner = {"match": {"body": text}} if text else {"match_all": {}}
    return {"query": {"script_score": {"query": inner, "script": script,
                                       "boost": boost}}, "size": size}


def _fs(text, functions, score_mode="multiply", boost_mode="multiply",
        size=25):
    return {"query": {"function_score": {
        "query": {"match": {"body": text}}, "functions": functions,
        "score_mode": score_mode, "boost_mode": boost_mode}}, "size": size}


def _sfn(source, params=None, **extra):
    script = {"source": source}
    if params is not None:
        script["params"] = params
    return {"script_score": {"script": script}, **extra}


CONFIG3S = [{"field_value_factor": {"field": "rank", "modifier": "log1p"}},
            {"gauss": {"rank": {"origin": 50, "scale": 20}}}]

#: batches of one plan signature each: (bodies, rtol, atol)
BATCHES = {
    "query_log_params": ([
        _ss("w00 w01", "log(2 + doc['rank'].value) * params.w",
            {"w": 1.5}),
        _ss("w02 w03", "log(2 + doc['rank'].value) * params.w",
            {"w": 0.25}, size=60, boost=2.0),
    ], TRANSCENDENTAL_RTOL, 0.0),
    "query_score_arith": ([
        _ss("w01 w02", "_score * 2 + doc['pop'].value / 10 - params.k",
            {"k": 1.0}),
        _ss("w04 w00", "_score * 2 + doc['pop'].value / 10 - params.k",
            {"k": -3.5}, size=80),
    ], PINNED_RTOL, 0.0),
    "query_conditionals": ([
        _ss("w00 w07", "(doc['rank'].value if doc['rank'].value > params.t "
            "else _score) + (doc['pop'].empty + 1) * 0.5 "
            "+ max(doc['pop'].value, 0, params.t / 100) "
            "+ (1 if params.on else 0)", {"t": 40.0, "on": True}),
        _ss("w05 w06", "(doc['rank'].value if doc['rank'].value > params.t "
            "else _score) + (doc['pop'].empty + 1) * 0.5 "
            "+ max(doc['pop'].value, 0, params.t / 100) "
            "+ (1 if params.on else 0)", {"t": 75.5, "on": True},
            size=100),
    ], PINNED_RTOL, 0.0),
    "config3s": ([
        _fs("w00 w02 w05", CONFIG3S + [_sfn(
            "log(2 + doc['rank'].value) * params.w", {"w": 1.5})]),
        _fs("w01 w03 w04", CONFIG3S + [_sfn(
            "log(2 + doc['rank'].value) * params.w", {"w": 1.5})],
            size=120),
    ], TRANSCENDENTAL_RTOL, 0.0),
    "fs_script_sum_replace": ([
        _fs("w00 w01", [_sfn("sqrt(abs(doc['pop'].value)) + _score / 3"),
                        _sfn("saturation(doc['rank'].value, 10)",
                             weight=2.0, filter={"term": {"tag": "t1"}})],
            score_mode="sum", boost_mode="replace"),
        _fs("w03 w06", [_sfn("sqrt(abs(doc['pop'].value)) + _score / 3"),
                    _sfn("saturation(doc['rank'].value, 10)",
                         weight=2.0, filter={"term": {"tag": "t2"}})],
            score_mode="sum", boost_mode="replace", size=50),
    ], TRANSCENDENTAL_RTOL, 0.0),
    "config4s_cosine": ([
        _ss(None, "cosineSimilarity(params.query_vector, 'vec') + 1.0",
            {"query_vector": _qvec(1)}, size=30),
        _ss(None, "cosineSimilarity(params.query_vector, 'vec') + 1.0",
            {"query_vector": _qvec(2)}, size=30),
        _ss(None, "cosineSimilarity(params.query_vector, 'vec') + 1.0",
            {"query_vector": _qvec(3)}, size=30),
    ], 0.0, COS_ATOL),
    "dot_product": ([
        _ss("w00 w04", "dotProduct(params.qv, 'vec') * 0.5 + _score",
            {"qv": _qvec(4)}),
        _ss("w02 w05", "dotProduct(params.qv, 'vec') * 0.5 + _score",
            {"qv": _qvec(5)}, size=40),
    ], 0.0, COS_ATOL),
}


def _assert_same(got, want, rtol, atol):
    """Equal totals; the same ids up to exact ties, scores to tolerance."""
    assert got.total == want.total
    assert len(got.doc_ids) == len(want.doc_ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=rtol, atol=atol)
    want_score = dict(zip(want.doc_ids.tolist(), want.scores.tolist()))
    cut = float(want.scores[-1]) if len(want.scores) else 0.0
    for i, (g, w) in enumerate(zip(got.doc_ids.tolist(),
                                   want.doc_ids.tolist())):
        if g == w:
            continue
        s = float(got.scores[i])
        assert abs(want_score.get(g, cut) - s) <= rtol * abs(s) + 2 * atol, \
            f"hit {i}: doc {g} (score {s}) where the reference has {w}"


@pytest.mark.parametrize("name", list(BATCHES))
def test_batches_match_jax(shared, name):
    js, ps = shared
    bodies, rtol, atol = BATCHES[name]
    want = js.query_phase_batch([jax_parse_search_request(b) for b in bodies])
    launches = script_ops.SCRIPT_EVAL.launches
    got = ps.query_phase_batch([parse_search_request(b) for b in bodies])
    assert want is not None and got is not None, "a batch fell back"
    assert script_ops.SCRIPT_EVAL.launches == launches  # CPU: plain version
    for g, w in zip(got, want):
        _assert_same(g, w, rtol, atol)
    # one request alone through query_phase's per-segment path
    body = dict(bodies[0], post_filter={"exists": {"field": "pop"}})
    _assert_same(ps.query_phase(parse_search_request(body)),
                 js.query_phase(jax_parse_search_request(body)), rtol, atol)


def test_numeric_script_fetches_no_vector_column(tmp_path):
    """A numeric-only script leaves the vector matrices on the host; a
    cosine script puts them on the device."""
    _, _, eng, ms = _index(tmp_path, _docs(n=50))
    reader = device_reader_for(eng, device="cpu")
    ps = ShardSearcher(0, reader, ms)
    ps.query_phase_batch([parse_search_request(
        _ss("w00", "doc['rank'].value * 2"))])
    ps.query_phase(parse_search_request(_fs(
        "w01", [_sfn("doc['pop'].value + 1")])))
    assert all(s.vector["vec"].vecs is None for s in reader.segments)
    ps.query_phase_batch([parse_search_request(_ss(
        None, "cosineSimilarity(params.q, 'vec')", {"q": _qvec(9)}))])
    assert all(s.vector["vec"].vecs is not None for s in reader.segments)


SCRIPT_FIELDS = {
    "doubled": {"script": "doc['rank'].value * 2"},
    "with_params": {"script": {"source": "doc['pop'].value * params.f "
                                         "+ doc['pop'].empty",
                               "params": {"f": 3}}},
    "logged": {"script": {"source": "log10(doc['rank'].value + 1)"}},
    "constant": {"script": "1 / 3"},
    "branch": {"script": {"source": "def r = doc['rank'].value; "
                                    "if (r > 50) { return 'hi' } "
                                    "else { return r * 2 }"}},
    "groovy": {"script": {"lang": "groovy", "source": "doc['tag'].value"}},
    "cosine": {"script": {"source": "cosineSimilarity(params.q, 'vec')",
                          "params": {"q": _qvec(6)}}},
}


def test_script_fields_match_jax(shared):
    js, ps = shared
    body = {"query": {"match": {"body": "w00 w03"}}, "size": 15,
            "script_fields": SCRIPT_FIELDS}
    req, jreq = parse_search_request(body), jax_parse_search_request(body)
    res, jres = ps.query_phase(req), js.query_phase(jreq)
    assert res.doc_ids.tolist() == jres.doc_ids.tolist()
    pos = list(range(len(res.doc_ids)))
    hits = ps.fetch_phase(req, res, "idx", pos)
    jhits = js.fetch_phase(jreq, jres, "idx", pos)
    assert len(hits) == 15
    for h, jh in zip(hits, jhits):
        assert set(h["fields"]) == set(SCRIPT_FIELDS)
        for name in ("doubled", "with_params", "constant", "branch",
                     "groovy"):
            assert h["fields"][name] == jh["fields"][name], name
        np.testing.assert_allclose(h["fields"]["logged"],
                                   jh["fields"]["logged"],
                                   rtol=TRANSCENDENTAL_RTOL)
        np.testing.assert_allclose(h["fields"]["cosine"],
                                   jh["fields"]["cosine"], atol=COS_ATOL)


def test_script_field_with_an_unknown_lang_raises_alike(shared):
    js, ps = shared
    body = {"query": {"match": {"body": "w00"}}, "size": 2, "script_fields": {
        "x": {"script": {"lang": "nope", "source": "1"}}}}
    req, jreq = parse_search_request(body), jax_parse_search_request(body)
    res, jres = ps.query_phase(req), js.query_phase(jreq)
    with pytest.raises(JaxQueryParsingError) as jexc:
        js.fetch_phase(jreq, jres, "idx", [0])
    with pytest.raises(QueryParsingError) as exc:
        ps.fetch_phase(req, res, "idx", [0])
    assert str(exc.value) == str(jexc.value)


@pytest.mark.parametrize("template", [
    {"query": {"match": {"body": "{{word}}"}}, "params": {"word": "w02"}},
    {"inline": {"bool": {"must": [{"match": {"body": "{{a}}"}}],
                         "filter": [{"term": {"tag": "{{t}}"}}]}},
     "params": {"a": "w01 w03", "t": "t2"}},
])
def test_template_query_matches_jax(shared, template):
    js, ps = shared
    body = {"query": {"template": template}, "size": 30}
    _assert_same(ps.query_phase(parse_search_request(body)),
                 js.query_phase(jax_parse_search_request(body)),
                 PINNED_RTOL, 0.0)
