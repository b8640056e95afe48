"""The classic (TF-IDF) and LM-Dirichlet similarities through the port
against the JAX package, on the CPU.

First K15's plain versions (``classic_match_batch_plain``,
``lm_dirichlet_match_batch_plain``) against the JAX bodies
``ops/lexical.classic_match`` and ``lm_dirichlet_match``, one query at a
time, on seeded forward columns: nmatch exact, scores within 1e-6 relative
(XLA may turn ``1 / sqrt`` into its reciprocal square root and its log and
log1p approximations differ from the C library's by an ulp or two). Then
``match`` and ``term`` on fields mapped ``classic`` and ``LMDirichlet``
through both packages' ``ShardSearcher`` (``test_torch_query_leaves``'s
corpus), alone, inside ``bool`` and ``multi_match``, and with global DFS
statistics (LM Dirichlet's collection frequencies from ``dfs_stats``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import lexical as jax_lexical
from elasticsearch_tpu.search.phase import (
    ShardSearcher as JaxShardSearcher,
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu_torch.ops import lexical
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)
from test_torch_query_leaves import (
    INDEX, _assert_same, _engines, check_bodies)

RTOL = 1e-6


def _columns(rng, n=300, u=12, vocab=40):
    uterms = np.full((n, u), -1, np.int32)
    utf = np.zeros((n, u), np.float32)
    for i, c in enumerate(rng.integers(0, u + 1, size=n)):
        uterms[i, :c] = np.sort(rng.choice(vocab, size=c, replace=False))
        utf[i, :c] = rng.integers(1, 7, size=c)
    doc_len = (utf.sum(axis=1) + rng.integers(0, 3, size=n)).astype(np.int32)
    doc_len[::37] = 0
    return uterms, utf, doc_len


def test_similarity_bodies_match_jax():
    rng = np.random.default_rng(4)
    uterms, utf, doc_len = _columns(rng)
    qtids = rng.integers(-1, 40, size=(5, 4)).astype(np.int32)
    qtids[0, 3] = qtids[0, 0]                      # a repeated term
    qidf = rng.uniform(0.5, 4.0, size=qtids.shape).astype(np.float32)
    frac = rng.uniform(0.0, 0.05, size=qtids.shape).astype(np.float32)
    frac[1, 1] = 0.0                               # at the floor
    qw = rng.uniform(0.5, 2.0, size=qtids.shape).astype(np.float32)
    mu = np.array([2000.0, 50.0, 500.0, 2000.0, 10.0], np.float32)
    t = [torch.from_numpy(a) for a in (uterms, utf, doc_len)]
    cs, cn = lexical.sim_match_batch(lexical.SIM_CLASSIC, *t,
                                     torch.from_numpy(qtids),
                                     torch.from_numpy(qidf),
                                     torch.from_numpy(qw))
    ls, ln = lexical.sim_match_batch(lexical.SIM_LM_DIRICHLET, *t,
                                     torch.from_numpy(qtids),
                                     torch.from_numpy(frac),
                                     torch.from_numpy(qw),
                                     torch.from_numpy(mu))
    j = [jnp.asarray(a) for a in (uterms, utf, doc_len)]
    for q in range(5):
        ws, wn = jax_lexical.classic_match(*j, jnp.asarray(qtids[q]),
                                           jnp.asarray(qidf[q]),
                                           jnp.asarray(qw[q]))
        np.testing.assert_array_equal(cn[q].numpy(), np.asarray(wn))
        np.testing.assert_allclose(cs[q].numpy(), np.asarray(ws), rtol=RTOL)
        ws, wn = jax_lexical.lm_dirichlet_match(
            *j, jnp.asarray(qtids[q]), jnp.asarray(frac[q]),
            jnp.asarray(qw[q]), jnp.float32(mu[q]))
        np.testing.assert_array_equal(ln[q].numpy(), np.asarray(wn))
        np.testing.assert_allclose(ls[q].numpy(), np.asarray(ws), rtol=RTOL)
    assert (cn > 0).any() and (ls > 0).any()


@pytest.fixture(scope="module")
def searchers(tmp_path_factory):
    return _engines(tmp_path_factory.mktemp("sim"))


def _m(field, text, **kw):
    return {"match": {field: dict(query=text, **kw) if kw else text}}


BATCHES = {
    "classic_match": [{"query": _m("cls", t), "size": 30}
                      for t in ("cat dog", "apple band ever", "zzz cat")],
    "classic_and": [{"query": _m("cls", t, operator="and"), "size": 30}
                    for t in ("cat dog", "apple ape")],
    "classic_term": [{"query": {"term": {"cls": w}}, "size": 30}
                     for w in ("cat", "bend")],
    "lm_match": [{"query": _m("lm", t), "size": 30}
                 for t in ("cat dog", "apple band ever", "eel zzz")],
    "lm_msm": [{"query": _m("lm", t, minimum_should_match=2), "size": 30}
               for t in ("cat dog apple", "band bend bond")],
    "lm_term": [{"query": {"term": {"lm": w}}, "size": 30}
                for w in ("dog", "every")],
    "mixed_bool": [{"query": {"bool": {
        "must": [_m("body", a)], "should": [_m("cls", b), _m("lm", c)]}},
        "size": 30} for a, b, c in (("cat", "dog", "apple"),
                                    ("ever", "band", "cat"))],
    "multi_match": [{"query": {"multi_match": {
        "query": t, "fields": ["cls", "lm^2", "body"],
        "tie_breaker": 0.2}}, "size": 30} for t in ("cat dog", "apex")],
}


@pytest.mark.parametrize("name", list(BATCHES))
def test_similarity_queries_match_jax(searchers, name):
    js, ps = searchers
    check_bodies(js, ps, BATCHES[name], rtol=RTOL,
                 alone=name in ("classic_match", "lm_match"))


def test_lm_dirichlet_reads_dfs_collection_stats(searchers):
    """With global DFS statistics holding ``ctf`` and ``total_tokens``, LM
    Dirichlet's P(t|C) comes from them in both packages."""
    js, ps = searchers
    dfs = {"df": {("lm", "cat"): 40, ("lm", "dog"): 30},
           "doc_count": {"lm": 400}, "avgdl": {"lm": 7.5},
           "ctf": {("lm", "cat"): 90, ("lm", "dog"): 35},
           "total_tokens": {"lm": 3000}}
    jd = JaxShardSearcher(0, js.reader, js.mapper_service,
                          index_name=INDEX, dfs_stats=dfs)
    pd = ShardSearcher(0, ps.reader, ps.mapper_service, index_name=INDEX,
                       dfs_stats=dfs)
    body = {"query": _m("lm", "cat dog"), "size": 30}
    want = jd.query_phase(jax_parse_search_request(body))
    got = pd.query_phase(parse_search_request(body))
    _assert_same(got, want, RTOL)
    plain = ps.query_phase(parse_search_request(body))
    assert not np.array_equal(plain.scores, got.scores)
