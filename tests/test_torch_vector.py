"""The port's dense-vector bodies against the JAX package's, on the CPU:
``ops/vector.py`` (every function; the int8 path through K4's plain version),
the candidate-list top-k of ``ops/blockmax.py``, the hybrid fusion bodies of
``segment_exec`` and the standalone ``models/dense.py`` and
``models/hybrid.py``. Inputs are made with numpy from a seed and handed to
both packages.

Tolerances: cosines of unit vectors 2e-6 absolute (the two packages sum the
dot products in other orders: a few f32 ulps); unnormalized dots 1e-6
relative as well; top-k ids and RRF scores bit for bit
(a stable order and sums with at most one nonzero term); the weighted sum
1e-6 relative (a min-max normalization of the same scores).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.segment import (
    quantize_vectors as jax_quantize_vectors)
from elasticsearch_tpu.models import bm25 as jax_bm25
from elasticsearch_tpu.models import dense as jax_dense
from elasticsearch_tpu.models import hybrid as jax_hybrid
from elasticsearch_tpu.ops import blockmax as jax_blockmax
from elasticsearch_tpu.ops import vector as jax_vector
from elasticsearch_tpu.search import jit_exec
from elasticsearch_tpu_torch.index.segment import quantize_vectors
from elasticsearch_tpu_torch.models import bm25, dense, hybrid
from elasticsearch_tpu_torch.ops import blockmax, vector
from elasticsearch_tpu_torch.search import segment_exec

COS_ATOL = 2e-6


def _unit(rng, shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _column(seed=0, n=300, d=16):
    """Unit rows with padding (zero) rows at the end, exists holes."""
    rng = np.random.default_rng(seed)
    vecs = _unit(rng, (n, d))
    vecs[-7:] = 0.0
    exists = np.ones(n, bool)
    exists[-7:] = False
    exists[::11] = False
    return rng, vecs, exists


def test_l2_normalize_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    x[2] = 0.0
    for axis in (-1, 0):
        np.testing.assert_allclose(
            vector.l2_normalize(_t(x), axis=axis).numpy(),
            np.asarray(jax_vector.l2_normalize(jnp.asarray(x), axis=axis)),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("d", [16, 64])
def test_cosine_scores_match_jax(d):
    """f32 cosines at two widths; the reference's ``use_bf16`` option is not
    ported, so its default (False) is what both sides run."""
    rng, vecs, exists = _column(2, d=d)
    qs = rng.standard_normal((5, d)).astype(np.float32)
    got = vector.cosine_scores_batch(_t(vecs), _t(exists), _t(qs))
    want = jax_vector.cosine_scores_batch(jnp.asarray(vecs),
                                          jnp.asarray(exists),
                                          jnp.asarray(qs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=COS_ATOL,
                               rtol=0)
    for q in qs[:2]:
        got = vector.cosine_scores(_t(vecs), _t(exists), _t(q))
        want = jax_vector.cosine_scores(jnp.asarray(vecs),
                                        jnp.asarray(exists), jnp.asarray(q))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=COS_ATOL, rtol=0)


def test_dot_and_script_cosine_match_jax():
    rng, vecs, exists = _column(3)
    raw = rng.standard_normal(vecs.shape).astype(np.float32)
    q = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        vector.dot_scores(_t(raw), _t(exists), _t(q)).numpy(),
        np.asarray(jax_vector.dot_scores(jnp.asarray(raw),
                                         jnp.asarray(exists),
                                         jnp.asarray(q))),
        rtol=1e-6, atol=COS_ATOL)
    np.testing.assert_allclose(
        vector.script_cosine_scores(_t(vecs), _t(exists), _t(q)).numpy(),
        np.asarray(jax_vector.script_cosine_scores(
            jnp.asarray(vecs), jnp.asarray(exists), jnp.asarray(q))),
        rtol=0, atol=COS_ATOL)


@pytest.mark.parametrize("seed,d", [(4, 16), (5, 100)])
def test_int8_cosine_plain_matches_jax(seed, d):
    """Quantization of the padded column (padding rows included) is the
    reference's bit for bit; the int8 scores through K4's plain version
    agree to the cosine tolerance."""
    rng, vecs, exists = _column(seed, d=d)
    qcol = quantize_vectors(vecs, d)
    jcol = jax_quantize_vectors(vecs, d)
    np.testing.assert_array_equal(qcol.qvecs, jcol.qvecs)
    assert (qcol.scale, qcol.offset) == (jcol.scale, jcol.offset)
    qs = rng.standard_normal((4, d)).astype(np.float32)
    got = vector.cosine_scores_int8_batch(_t(qcol.qvecs), qcol.scale,
                                          qcol.offset, _t(exists), _t(qs))
    want = jax_vector.cosine_scores_int8_batch(
        jnp.asarray(jcol.qvecs), jnp.float32(jcol.scale),
        jnp.float32(jcol.offset), jnp.asarray(exists), jnp.asarray(qs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=COS_ATOL)
    assert bool((got[:, ~_t(exists)] == 0).all())


@pytest.mark.parametrize("k,doc_base", [(20, 0), (64, 1000), (400, 7)])
def test_filtered_topk_batch_matches_jax_with_ties(k, doc_base):
    """Scores in steps of 0.5 (many exact ties) under per-query masks: ids
    bit-identical, ties by lower doc id, padding (-inf, -1) past the
    eligible rows."""
    rng = np.random.default_rng(k)
    # + 0.0 turns -0.0 into 0.0: K2 ties -0.0 with 0.0 (Lucene's float
    # compare), lax.top_k puts 0.0 first (test_signed_zeros_tie_by_doc)
    scores = (np.round(rng.standard_normal((4, 300)) * 2) / 2 + 0.0).astype(
        np.float32)
    masks = rng.random((4, 300)) < 0.7
    masks[3] = False
    got = vector.filtered_topk_batch(_t(scores), _t(masks), k, doc_base)
    want = jax_vector.filtered_topk_batch(jnp.asarray(scores),
                                          jnp.asarray(masks), k, doc_base)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_signed_zeros_tie_by_doc():
    """-0.0 and 0.0 are one score to the port's top-k (K2 folds -0.0 onto
    0.0, as Lucene's float compare does), so they tie and go by doc id. The
    JAX package's lax.top_k orders 0.0 before -0.0 instead (ROADMAP C1);
    cosines are exactly -0.0 too rarely for this to show on the lane."""
    scores = np.asarray([[0.0, -0.0, 1.0, -0.0, 0.0, -1.0]], np.float32)
    ts, td = vector.filtered_topk_batch(_t(scores), _t(np.ones_like(
        scores, bool)), 6)
    np.testing.assert_array_equal(td.numpy(), [[2, 0, 1, 3, 4, 5]])
    _, jtd = jax_vector.filtered_topk_batch(jnp.asarray(scores),
                                            jnp.ones(scores.shape, bool), 6)
    assert np.asarray(jtd).tolist() == [[2, 0, 4, 1, 3, 5]]


def _candidates(rng, rows, n, pool=500, p_empty=0.2):
    """Candidate lists with unique global ids per row, empty slots (-inf,
    -1) and exact score ties."""
    docs = np.stack([rng.permutation(pool)[:n] for _ in range(rows)]).astype(
        np.int32)
    scores = (np.round(rng.standard_normal((rows, n)) * 3) / 3).astype(
        np.float32)
    empty = rng.random((rows, n)) < p_empty
    docs[empty] = -1
    scores[empty] = -np.inf
    return scores, docs


@pytest.mark.parametrize("n,k", [(40, 10), (40, 60), (7, 7)])
def test_topk_by_doc_matches_jax(n, k):
    rng = np.random.default_rng(n + k)
    s_a, d_a = _candidates(rng, 3, n)
    s_b, d_b = _candidates(rng, 3, n)
    got = blockmax.topk_flat_by_doc(_t(s_a), _t(d_a), k)
    got_m = blockmax.merge_topk_by_doc(_t(s_a), _t(d_a), _t(s_b), _t(d_b), k)
    for r in range(3):
        want = jax_blockmax.topk_flat_by_doc(jnp.asarray(s_a[r]),
                                             jnp.asarray(d_a[r]), k)
        want_m = jax_blockmax.merge_topk_by_doc(
            jnp.asarray(s_a[r]), jnp.asarray(d_a[r]), jnp.asarray(s_b[r]),
            jnp.asarray(d_b[r]), k)
        for g, w in ((got, want), (got_m, want_m)):
            np.testing.assert_array_equal(g[1][r].numpy(), np.asarray(w[1]))
            np.testing.assert_array_equal(g[0][r].numpy(), np.asarray(w[0]))


def _fusion_inputs(seed, b=4, c=30):
    """Two candidate lists a row, in rank order, sharing some docs, with
    empty tails."""
    rng = np.random.default_rng(seed)
    ls = -np.sort(-rng.uniform(0, 20, (b, c))).astype(np.float32)
    ds = -np.sort(-rng.uniform(-1, 1, (b, c))).astype(np.float32)
    ld = np.stack([rng.permutation(80)[:c] for _ in range(b)]).astype(
        np.int32)
    dd = np.stack([rng.permutation(80)[:c] for _ in range(b)]).astype(
        np.int32)
    ld[1, c // 2:], ls[1, c // 2:] = -1, -np.inf
    dd[2, 3:], ds[2, 3:] = -1, -np.inf
    ld[3], ls[3] = -1, -np.inf                   # no lexical candidate
    boosts = np.asarray([1.0, 2.0, 0.5, 3.0][:b], np.float32)
    return ls, ld, ds, dd, boosts


@pytest.mark.parametrize("seed,k0,k", [(6, 60, 20), (7, 1, 70), (8, 10, 5)])
def test_rrf_fusion_bit_equal_to_jax(seed, k0, k):
    args = _fusion_inputs(seed)
    got = segment_exec._rrf_fuse_body(*map(_t, args), float(k0), k)
    want = jit_exec._rrf_fuse_body(*map(jnp.asarray, args), float(k0), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,w_lex,k", [(9, 0.5, 20), (10, 0.2, 60),
                                          (11, 1.0, 10)])
def test_weighted_fusion_matches_jax(seed, w_lex, k):
    args = _fusion_inputs(seed)
    ts, td, count = segment_exec._weighted_fuse_body(*map(_t, args), w_lex,
                                                     k)
    wts, wtd, wcount = jit_exec._weighted_fuse_body(*map(jnp.asarray, args),
                                                    w_lex, k)
    np.testing.assert_array_equal(count.numpy(), np.asarray(wcount))
    np.testing.assert_allclose(ts.numpy(), np.asarray(wts), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(td.numpy(), np.asarray(wtd))


def test_dense_retriever_matches_jax():
    rng = np.random.default_rng(12)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    qs = rng.standard_normal((6, 16)).astype(np.float32)
    got = dense.DenseRetriever(vecs, num_docs=290, device="cpu").search(
        qs, k=25)
    want = jax_dense.DenseRetriever(vecs, num_docs=290).search(qs, k=25)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=COS_ATOL)
    assert (got[1] < 290).all()


@pytest.mark.parametrize("mode", ["rrf", "linear"])
def test_hybrid_retriever_matches_jax(mode):
    rng = np.random.default_rng(13)
    words = [f"w{i}" for i in range(20)]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(2, 12))))
             for _ in range(200)]
    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    queries = [" ".join(rng.choice(words, size=3)) for _ in range(4)]
    qv = rng.standard_normal((4, 16)).astype(np.float32)
    port = hybrid.HybridRetriever(
        bm25.BM25Retriever(bm25.PackedTextIndex.from_texts(texts),
                           device="cpu"),
        dense.DenseRetriever(vecs, device="cpu"), mode=mode,
        lexical_weight=0.3)
    ref = jax_hybrid.HybridRetriever(
        jax_bm25.BM25Retriever(jax_bm25.PackedTextIndex.from_texts(texts)),
        jax_dense.DenseRetriever(vecs), mode=mode, lexical_weight=0.3)
    got = port.search(queries, qv, k=15, depth=40)
    want = ref.search(queries, qv, k=15, depth=40)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)


def test_cosine_topk_batch_matches_jax():
    rng = np.random.default_rng(14)
    vecs = _unit(rng, (120, 16))
    live = rng.random(120) < 0.8
    qs = rng.standard_normal((3, 16)).astype(np.float32)
    got = dense.cosine_topk_batch(_t(vecs), _t(live), _t(qs), 30)
    want = jax_dense.cosine_topk_batch(jnp.asarray(vecs), jnp.asarray(live),
                                       jnp.asarray(qs), 30)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=COS_ATOL)
