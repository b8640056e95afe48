"""The port's standalone BM25 program against the JAX package's
``models/bm25.py``: the same packed index, the same top-k (ids equal,
scores to 2 ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.models import bm25 as jax_bm25
from elasticsearch_tpu_torch.models import bm25

RTOL = 2.4e-7   # 2 ulp of f32
WORDS = ["search", "engine", "shard", "segment", "score", "query", "merge",
         "index", "token", "device", "kernel", "batch", "match", "phrase",
         "refresh", "flush", "replica", "cluster", "node", "vector"]


def _texts(seed, n=120):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 14))))
            for _ in range(n)]


@pytest.mark.parametrize("pad_docs,max_unique", [(None, None), (160, 6)])
def test_packed_index_from_texts_matches_jax(pad_docs, max_unique):
    texts = _texts(0)
    want = jax_bm25.PackedTextIndex.from_texts(texts, pad_docs=pad_docs,
                                               max_unique=max_unique)
    got = bm25.PackedTextIndex.from_texts(texts, pad_docs=pad_docs,
                                          max_unique=max_unique)
    assert got.terms == want.terms
    for name in ("uterms", "utf", "doc_len", "live", "df"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert (got.num_docs, got.total_tokens) == (want.num_docs,
                                                want.total_tokens)


@pytest.mark.parametrize("k", [5, 200])
def test_bm25_topk_batch_matches_jax(k):
    idx = bm25.PackedTextIndex.from_texts(_texts(1), pad_docs=128)
    queries = ["search engine", "kernel batch merge", "vector vector node",
               "nothing matches this", "score"]
    retr = bm25.BM25Retriever(idx, device="cpu")
    qtids, qidf = retr.encode_queries(queries)
    want_s, want_d = jax_bm25.bm25_topk_batch(
        jnp.asarray(idx.uterms), jnp.asarray(idx.utf),
        jnp.asarray(idx.doc_len), jnp.asarray(idx.live), jnp.asarray(qtids),
        jnp.asarray(qidf), np.float32(idx.avgdl), k)
    got_s, got_d = bm25.bm25_topk_batch(
        torch.from_numpy(idx.uterms), torch.from_numpy(idx.utf),
        torch.from_numpy(idx.doc_len), torch.from_numpy(idx.live),
        torch.from_numpy(qtids), torch.from_numpy(qidf), idx.avgdl, k)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=RTOL, atol=0)


def test_retriever_search_matches_jax():
    idx = bm25.PackedTextIndex.from_texts(_texts(2))
    queries = ["segment refresh", "replica cluster node flush"]
    want_s, want_d = jax_bm25.BM25Retriever(
        jax_bm25.PackedTextIndex.from_texts(_texts(2))).search(queries, k=7)
    got_s, got_d = bm25.BM25Retriever(idx, device="cpu").search(queries,
                                                                k=7)
    np.testing.assert_array_equal(got_d, np.asarray(want_d))
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=RTOL, atol=0)
