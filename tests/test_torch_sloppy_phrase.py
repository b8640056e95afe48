"""Sloppy ``match_phrase`` through the port against the JAX package, on the
CPU.

First the plain bodies (``_sloppy_displacement``, ``sloppy_phrase_freq``,
``sloppy_phrase_score`` and K11's plain batch) against the JAX bodies of
``elasticsearch_tpu/ops/phrase.py`` on seeded position matrices: slop 1 to
4, a phrase that repeats a term, phrases that run past the row's end, and
absent terms. Then ``match_phrase`` with slop, alone and inside ``bool``,
through both packages' ``ShardSearcher.query_phase_batch`` and
``query_phase`` over one two-segment corpus with a deleted doc (the
corpus of ``test_torch_slice3``).

Masks are identical. Scores agree to rtol 1e-6: the port sums a doc's
positions in ascending order, XLA in an order of its own, and the idf sum
of the sloppy arm is an f32 device sum in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import phrase as jax_phrase
from elasticsearch_tpu.search.phase import (
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu_torch.index.device_reader import device_reader_for
from elasticsearch_tpu_torch.ops import phrase
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)
from test_torch_slice3 import _assert_same, _docs, _engines

RTOL = 1e-6
K1, B = 1.2, 0.75


def _tokens(rng, n=48, length=20, vocab=6):
    """A small vocabulary (repeats, near misses), -1 holes and short rows
    padded with -1."""
    tokens = rng.integers(0, vocab, size=(n, length)).astype(np.int32)
    tokens[rng.random((n, length)) < 0.1] = -1
    for i, cut in enumerate(rng.integers(1, length + 1, size=n)):
        tokens[i, cut:] = -1
    doc_len = (tokens >= 0).sum(axis=1).astype(np.int32)
    return tokens, doc_len


#: (qtids, deltas) per case: plain pairs and triples, a repeated term, a
#: stopword gap, a phrase whose shifts reach the matrix's last column (the
#: JAX body's shifted copies take no shift past it: its pad then changes
#: the array's width), an absent term
CASES = [
    ([1, 2], [0, 1]),
    ([3, 1, 4], [0, 1, 2]),
    ([2, 2], [0, 1]),
    ([0, 5, 0], [0, 2, 3]),
    ([1, 3], [0, 16]),
    ([4, -1], [0, 1]),
]


@pytest.mark.parametrize("slop", [1, 2, 3, 4])
def test_sloppy_bodies_match_jax(slop):
    rng = np.random.default_rng(slop)
    tokens, doc_len = _tokens(rng)
    jt = jnp.asarray(tokens)
    for qtids, deltas in CASES:
        q = torch.tensor(qtids, dtype=torch.int32)
        jq = [jnp.int32(t) for t in qtids]
        want_d = np.asarray(jax_phrase._sloppy_displacement(jt, jq, deltas,
                                                            slop))
        got_d = phrase._sloppy_displacement(torch.from_numpy(tokens), q,
                                            deltas, slop).numpy()
        np.testing.assert_array_equal(got_d <= slop, want_d <= slop)
        np.testing.assert_array_equal(np.where(got_d <= slop, got_d, 0),
                                      np.where(want_d <= slop, want_d, 0))
        want_f = np.asarray(jax_phrase.sloppy_phrase_freq(jt, jq, deltas,
                                                          slop))
        got_f = phrase.sloppy_phrase_freq(torch.from_numpy(tokens), q,
                                          deltas, slop).numpy()
        np.testing.assert_allclose(got_f, want_f, rtol=RTOL)
        idfs = rng.uniform(0.1, 3.0, size=len(qtids)).astype(np.float32)
        avgdl = np.float32(doc_len.mean())
        ws, wm = jax_phrase.sloppy_phrase_score(
            jt, jnp.asarray(doc_len), jq, deltas, slop, jnp.asarray(idfs),
            K1, B, avgdl)
        gs, gm = phrase.sloppy_phrase_score(
            torch.from_numpy(tokens), torch.from_numpy(doc_len), q, deltas,
            slop, torch.from_numpy(idfs), K1, B, torch.tensor(avgdl))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=RTOL)
    assert (got_f == 0).all()              # the absent term matches nowhere
    # past the last column nothing matches (and nothing breaks)
    far = phrase.sloppy_phrase_freq(torch.from_numpy(tokens),
                                    torch.tensor([1, 3], dtype=torch.int32),
                                    [0, 19], slop)
    assert (far == 0).all()


def test_sloppy_batch_plain_is_the_bodies_a_query_at_a_time():
    """K11's plain version (the wrapper on CPU tensors) is the one-query
    body row for row, bit for bit."""
    rng = np.random.default_rng(9)
    tokens, doc_len = _tokens(rng)
    t, dl = torch.from_numpy(tokens), torch.from_numpy(doc_len)
    qtids = torch.tensor([[1, 2, 0], [2, 2, 2], [5, -1, 1], [3, 0, 4]],
                         dtype=torch.int32)
    idfs = torch.rand(qtids.shape, generator=torch.Generator().manual_seed(1))
    avgdl = torch.full((4,), float(doc_len.mean()))
    deltas = [0, 1, 3]
    scores, mask = phrase.sloppy_phrase_score_batch(
        t, dl, qtids, deltas, 2, idfs, K1, B, avgdl,
        extent=phrase.token_extent(t))
    assert mask.any()
    for i in range(4):
        s, m = phrase.sloppy_phrase_score(t, dl, qtids[i], deltas, 2,
                                          idfs[i], K1, B, avgdl[i])
        assert torch.equal(scores[i].view(torch.int32), s.view(torch.int32))
        assert torch.equal(mask[i], m)
    # the idf sum is taken in term order, in f32
    assert phrase.idf_sum(idfs[0]) == (idfs[0, 0] + idfs[0, 1]) + idfs[0, 2]


@pytest.fixture(scope="module")
def searchers(tmp_path_factory):
    js, _, eng, ms = _engines(tmp_path_factory.mktemp("sloppy"), _docs())
    reader = device_reader_for(eng, device="cpu")
    assert len(reader.segments) == 2
    return js, ShardSearcher(0, reader, ms)


def _sloppy_body(must, text, slop, size=30, boost=1.0):
    return {"query": {"bool": {
        "must": [{"match": {"body": must}}],
        "should": [{"match_phrase": {"body": {"query": text, "slop": slop,
                                              "boost": boost}}}]}},
        "size": size}


BATCHES = {
    "bool_slop2": [_sloppy_body("w00 w01", "w00 w01", 2),
                   _sloppy_body("w02 w03", "w03 w00", 2, size=7),
                   _sloppy_body("w01 w04", "w04 w04", 2, size=200),
                   _sloppy_body("w00 w05", "w05 zz", 2, boost=3.0)],
    "alone_slop1": [{"query": {"match_phrase": {"body": {
                        "query": q, "slop": 1}}}, "size": 40}
                    for q in ("w00 w01", "w02 w00", "w01 w01")],
    "triple_slop3": [{"query": {"match_phrase": {"body": {
                         "query": q, "slop": 3}}}, "size": 25}
                     for q in ("w00 w01 w02", "w03 w00 w00")],
}


@pytest.mark.parametrize("name", list(BATCHES))
def test_sloppy_phrase_queries_match_jax(searchers, name):
    js, ps = searchers
    bodies = BATCHES[name]
    want = js.query_phase_batch([jax_parse_search_request(b)
                                 for b in bodies])
    got = ps.query_phase_batch([parse_search_request(b) for b in bodies])
    assert want is not None and got is not None, "a batch fell back"
    assert any(g.total for g in got)
    for g, w in zip(got, want):
        _assert_same(g, w, RTOL)
    body = dict(bodies[0], post_filter={"exists": {"field": "rank"}})
    _assert_same(ps.query_phase(parse_search_request(body)),
                 js.query_phase(jax_parse_search_request(body)), RTOL)
