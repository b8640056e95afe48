"""The port's DistributedBM25 against the JAX package's, on the CPU.

The same numpy-seeded texts are packed into 4 shards in both packages
(``PackedTextIndex.from_texts``). The JAX side runs one shard a device on a
4-device CPU mesh; the port one gloo rank holding all 4 shards (``spd = 4``)
— the global statistics summed over the group, K1 and K2's plain versions
per shard, the gathered candidates re-selected by position. Totals exact,
scores within f32 rounding (the idf's ``log1p`` is each library's own),
doc ids identical apart from exact ties; both against a float64 BM25 with
global statistics.
"""

import math

import jax
import numpy as np
import pytest

from elasticsearch_tpu.analysis.analyzers import (
    BUILTIN_ANALYZERS as JAX_ANALYZERS)
from elasticsearch_tpu.models.bm25 import PackedTextIndex as JaxPacked
from elasticsearch_tpu.parallel import DistributedBM25 as JaxDistributedBM25
from elasticsearch_tpu.parallel import make_mesh as jax_make_mesh
from elasticsearch_tpu_torch.analysis.analyzers import BUILTIN_ANALYZERS
from elasticsearch_tpu_torch.models.bm25 import PackedTextIndex
from elasticsearch_tpu_torch.parallel import (
    DistributedBM25, distributed_bm25_step, make_mesh)

from test_torch_mesh_engine import recall_with_tie_tolerance

RTOL = 1e-6
N_SHARDS = 4
WORDS = [f"w{i}" for i in range(40)]


def _texts(seed=21, n=180):
    rng = np.random.default_rng(seed)
    return [" ".join(WORDS[int(x) % 40] for x in rng.zipf(1.5, size=int(
        rng.integers(1, 12)))) for _ in range(n)]


def _bm25_64(texts, terms, analyzer, k1=1.2, b=0.75):
    """Float64 BM25 with global statistics; a repeated query term counts
    each time (the packed query's one slot a term)."""
    docs = [analyzer.terms(t) for t in texts]
    n = len(docs)
    avgdl = sum(len(d) for d in docs) / n
    out = np.zeros(n)
    for t in terms:
        df = sum(1 for d in docs if t in d)
        if not df:
            continue
        idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
        for i, d in enumerate(docs):
            tf = d.count(t)
            if tf:
                out[i] += idf * tf * (k1 + 1) / (
                    tf + k1 * (1 - b + b * len(d) / avgdl))
    return out


@pytest.fixture(scope="module")
def both():
    texts = _texts()
    parts = [texts[i::N_SHARDS] for i in range(N_SHARDS)]
    jan, an = JAX_ANALYZERS["standard"], BUILTIN_ANALYZERS["standard"]
    jidx = [JaxPacked.from_texts(p, jan, pad_docs=48, max_unique=12)
            for p in parts]
    idx = [PackedTextIndex.from_texts(p, an, pad_docs=48, max_unique=12)
           for p in parts]
    jd = JaxDistributedBM25(jax_make_mesh(dp=1, shard=N_SHARDS,
                                          devices=jax.devices()[:N_SHARDS]),
                            jidx, analyzer=jan)
    pd = DistributedBM25(make_mesh(device="cpu"), idx, analyzer=an)
    return texts, parts, jd, pd, an


QUERIES = ["w1 w2", "w0", "w3 w7 w9", "w39 w38", "w5 w5 w1", "nothere"]


@pytest.mark.parametrize("k", [1, 5, 30])
def test_distributed_bm25_matches_jax(both, k):
    texts, parts, jd, pd, an = both
    js, jdocs, jt = jd.search(QUERIES, k=k)
    ps, pdocs, pt = pd.search(QUERIES, k=k)
    assert pd.spd == N_SHARDS and pd.np_docs == jd.np_docs
    assert np.array_equal(pt, jt)
    np.testing.assert_allclose(ps, js, rtol=RTOL, atol=0)
    for qi, q in enumerate(QUERIES):
        ref = _bm25_64(texts, an.terms(q), an)
        # global doc → original text position (doc i went to shard i % 4)
        orig = {}
        for si, part in enumerate(parts):
            for li in range(len(part)):
                orig[si * pd.np_docs + li] = li * N_SHARDS + si
        assert int(pt[qi]) == int((ref > 0).sum())
        got = [int(d) for d in pdocs[qi] if d >= 0]
        want = [int(d) for d in jdocs[qi] if d >= 0]
        assert len(got) == len(want) == min(k, int((ref > 0).sum()))
        all_scores = {d: ref[orig[d]] for d in set(got) | set(want)}
        assert recall_with_tie_tolerance(want, all_scores, got, len(want),
                                         tol=1e-5) == 1.0
        for d, s in zip(got, ps[qi]):
            assert s == pytest.approx(ref[orig[d]], rel=1e-5)
            assert pd.resolve(d) == divmod(d, pd.np_docs)


def test_distributed_step_and_shard_count(both):
    _, _, _, pd, an = both
    assert callable(distributed_bm25_step(pd.mesh, 3))
    with pytest.raises(ValueError, match="shards != mesh shard axis"):
        DistributedBM25(make_mesh(device="cpu"), [], analyzer=an)
    assert pd.device_bytes() > 0
