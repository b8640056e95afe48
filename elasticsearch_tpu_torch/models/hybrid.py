"""HybridRetriever — lexical + dense fusion.

Counterpart of ``elasticsearch_tpu/models/hybrid.py``: both legs run on the
device (:class:`BM25Retriever`, :class:`DenseRetriever`) and the fusion runs
on the host. Fusion modes: ``rrf`` (reciprocal rank fusion, k=60 default)
and ``linear`` (weighted score sum over min-max-normalized legs).
"""

from __future__ import annotations

import numpy as np

from elasticsearch_tpu_torch.models.bm25 import BM25Retriever
from elasticsearch_tpu_torch.models.dense import DenseRetriever


class HybridRetriever:
    def __init__(self, lexical: BM25Retriever, dense: DenseRetriever,
                 mode: str = "rrf", rrf_k: int = 60,
                 lexical_weight: float = 0.5):
        self.lexical = lexical
        self.dense = dense
        self.mode = mode
        self.rrf_k = rrf_k
        self.lexical_weight = lexical_weight

    def search(self, queries: list[str], query_vectors: np.ndarray,
               k: int = 10, depth: int = 100):
        ls, ld = self.lexical.search(queries, k=depth)
        ds, dd = self.dense.search(query_vectors, k=depth)
        out_scores = np.zeros((len(queries), k), np.float32)
        out_docs = np.full((len(queries), k), -1, np.int64)
        for qi in range(len(queries)):
            fused: dict[int, float] = {}
            if self.mode == "rrf":
                for rank, doc in enumerate(ld[qi]):
                    if doc >= 0:
                        fused[doc] = fused.get(doc, 0.0) + \
                            1.0 / (self.rrf_k + rank + 1)
                for rank, doc in enumerate(dd[qi]):
                    if doc >= 0:
                        fused[doc] = fused.get(doc, 0.0) + \
                            1.0 / (self.rrf_k + rank + 1)
            else:  # linear with min-max normalization per leg
                def norm(scores, docs):
                    valid = docs >= 0
                    if not valid.any():
                        return {}
                    s = scores[valid]
                    lo, hi = float(s.min()), float(s.max())
                    rng = (hi - lo) or 1.0
                    return {int(d): (float(x) - lo) / rng
                            for d, x in zip(docs[valid], s)}
                for d, s in norm(ls[qi], ld[qi]).items():
                    fused[d] = fused.get(d, 0.0) + self.lexical_weight * s
                for d, s in norm(ds[qi], dd[qi]).items():
                    fused[d] = fused.get(d, 0.0) + (1 - self.lexical_weight) * s
            ranked = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
            for j, (doc, score) in enumerate(ranked):
                out_docs[qi, j] = doc
                out_scores[qi, j] = score
        return out_scores, out_docs
