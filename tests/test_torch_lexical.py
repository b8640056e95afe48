"""The port's BM25 scan against the JAX package's ``ops/lexical.bm25_match``.

Both packages get the same numpy inputs. ``nmatch`` must be exact; scores
agree to 2 ulp (rtol 2.4e-7), since XLA on the CPU may fuse the reference's
element-wise chain where eager PyTorch rounds each operation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import lexical as jax_lexical
from elasticsearch_tpu_torch.ops import lexical

RTOL = 2.4e-7   # 2 ulp of f32


def _segment(rng, n=96, u=8, vocab=24, zero_len_rows=(3, 17)):
    """A forward impact segment: sorted unique terms first, -1 pads after,
    some rows empty, some with doc_len 0 but terms (hand-packed data)."""
    uterms = np.full((n, u), -1, np.int32)
    utf = np.zeros((n, u), np.float32)
    doc_len = np.zeros(n, np.int32)
    for i in range(n):
        k = int(rng.integers(0, u + 1))
        terms = np.sort(rng.choice(vocab, size=k, replace=False))
        tf = rng.integers(1, 6, size=k)
        uterms[i, :k] = terms
        utf[i, :k] = tf
        doc_len[i] = int(tf.sum()) + int(rng.integers(0, 5))
    doc_len[list(zero_len_rows)] = 0
    return uterms, utf, doc_len


def _queries(rng, b=7, t=5, vocab=24):
    """Query term ids with absent terms (-1, idf 0) and repeated terms."""
    qtids = rng.integers(0, vocab + 4, size=(b, t)).astype(np.int32)
    qtids[qtids >= vocab] = -1                # absent in this segment
    qtids[0, 1] = qtids[0, 0]                 # a repeated query term
    qidf = rng.uniform(0.1, 4.0, size=(b, t)).astype(np.float32)
    qidf[qtids < 0] = 0.0
    qweight = rng.uniform(0.5, 2.0, size=(b, t)).astype(np.float32)
    avgdl = rng.uniform(0.5, 60.0, size=b).astype(np.float32)
    return qtids, qidf, qweight, avgdl


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed,k1,b", [(0, 1.2, 0.75), (1, 2.0, 0.3),
                                       (2, 0.9, 1.0)])
def test_bm25_match_batch_matches_jax_vmap(seed, k1, b):
    rng = np.random.default_rng(seed)
    uterms, utf, doc_len = _segment(rng)
    qtids, qidf, qweight, avgdl = _queries(rng)
    want_s, want_n = jax.jit(jax.vmap(
        lambda qt, qi, qw, a: jax_lexical.bm25_match(
            jnp.asarray(uterms), jnp.asarray(utf), jnp.asarray(doc_len),
            qt, qi, qw, k1, b, a)))(qtids, qidf, qweight, avgdl)
    got_s, got_n = lexical.bm25_match_batch(
        _t(uterms), _t(utf), _t(doc_len), _t(qtids), _t(qidf), _t(qweight),
        k1, b, _t(avgdl), trailing_pad=True)
    assert got_s.dtype == torch.float32 and got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", [3, 4])
def test_bm25_match_single_query_matches_jax(seed):
    rng = np.random.default_rng(seed)
    uterms, utf, doc_len = _segment(rng, n=40, u=6)
    qtids, qidf, qweight, avgdl = _queries(rng, b=1, t=3)
    want_s, want_n = jax_lexical.bm25_match(
        jnp.asarray(uterms), jnp.asarray(utf), jnp.asarray(doc_len),
        jnp.asarray(qtids[0]), jnp.asarray(qidf[0]), jnp.asarray(qweight[0]),
        1.2, 0.75, jnp.float32(avgdl[0]))
    got_s, got_n = lexical.bm25_match(
        _t(uterms), _t(utf), _t(doc_len), _t(qtids[0]), _t(qidf[0]),
        _t(qweight[0]), 1.2, 0.75, float(avgdl[0]))
    assert got_s.shape == (40,) and got_n.shape == (40,)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=RTOL, atol=0)


def test_bm25_constants_round_once_from_double():
    # (k1 + 1) and (1 - b) are formed in double, then rounded to f32, as
    # the JAX body's weakly typed Python scalars are
    k1, k1p1, omb, b = lexical.bm25_constants(1.2, 0.75)
    assert k1p1 == np.float32(2.2) and omb == np.float32(0.25)
    assert k1.dtype == np.float32 and b == np.float32(0.75)


@pytest.mark.parametrize("seed,k1,b", [(5, 1.2, 0.75), (6, 0.9, 1.0)])
def test_scores_without_nmatch_match_jax_vmap(seed, k1, b):
    """``want_nmatch=False`` (the OR plan) returns no counts and the same
    scores as the JAX ``bm25_match`` under ``vmap``."""
    rng = np.random.default_rng(seed)
    uterms, utf, doc_len = _segment(rng)
    qtids, qidf, qweight, avgdl = _queries(rng)
    want_s, _ = jax.jit(jax.vmap(
        lambda qt, qi, qw, a: jax_lexical.bm25_match(
            jnp.asarray(uterms), jnp.asarray(utf), jnp.asarray(doc_len),
            qt, qi, qw, k1, b, a)))(qtids, qidf, qweight, avgdl)
    got_s, got_n = lexical.bm25_match_batch(
        _t(uterms), _t(utf), _t(doc_len), _t(qtids), _t(qidf), _t(qweight),
        k1, b, _t(avgdl), trailing_pad=True, want_nmatch=False)
    assert got_n is None
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=RTOL, atol=0)
