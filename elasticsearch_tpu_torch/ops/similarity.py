"""Similarity: BM25 (default) and classic TF/IDF.

Reference: the similarity module (core/index/similarity/SimilarityModule.java
— BM25/default/DFR/IB/LM*) with Lucene 5.4's BM25Similarity semantics:

    idf(t)        = ln(1 + (docCount - df + 0.5) / (df + 0.5))
    tfNorm(tf, d) = tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl/avgdl))
    score(q, d)   = Σ_t idf(t) * tfNorm(tf_t,d)

idf is computed host-side from df aggregated across segments (per shard, the
Lucene default) or across shards via psum (the DFS_QUERY_THEN_FETCH mode,
core/search/dfs/DfsPhase.java:45).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class BM25Params:
    k1: float = 1.2
    b: float = 0.75


def idf(df: float, doc_count: float) -> float:
    """Lucene BM25 idf. Accepts scalars; host-side (term stats are host data)."""
    return math.log(1.0 + (doc_count - df + 0.5) / (df + 0.5))


def classic_idf(df: float, doc_count: float) -> float:
    """Lucene ClassicSimilarity (TF/IDF): 1 + ln(docCount / (df + 1))."""
    return 1.0 + math.log(doc_count / (df + 1.0))
