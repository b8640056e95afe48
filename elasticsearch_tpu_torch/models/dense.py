"""DenseRetriever — brute-force exact cosine kNN (BASELINE config 4).

Counterpart of ``elasticsearch_tpu/models/dense.py``: the standalone form of
the knn lane's dense scoring. The whole batch is one [Q, D] × [D, N] matrix
product (``torch.matmul`` in f32; TF32 stays off, PyTorch's default) and a
stable top-k per query (kernel K2 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.ops import topk as topk_ops
from elasticsearch_tpu_torch.ops.vector import l2_normalize


def cosine_topk_batch(vecs, live, qs, k: int):
    """vecs: [N, D] row-normalized; live: [N] bool; qs: [Q, D] →
    (scores [Q, k], docs [Q, k]), empty slots (-inf, -1)."""
    qn = l2_normalize(qs, axis=-1)
    scores = qn @ vecs.T
    return topk_ops.top_k(scores, live[None, :].expand_as(scores).contiguous(),
                          k)


class DenseRetriever:
    def __init__(self, vectors: np.ndarray, num_docs: int | None = None,
                 device=None):
        n = num_docs if num_docs is not None else vectors.shape[0]
        norms = np.linalg.norm(vectors, axis=1, keepdims=True)
        normed = (vectors / np.maximum(norms, 1e-12)).astype(np.float32)
        live = np.zeros(vectors.shape[0], bool)
        live[:n] = True
        self.device = resolve_device(device)
        self.d_vecs = torch.from_numpy(np.ascontiguousarray(normed)).to(
            self.device)
        self.d_live = torch.from_numpy(live).to(self.device)
        self.num_docs = n
        self.dims = vectors.shape[1]

    def search(self, queries: np.ndarray, k: int = 10):
        qs = torch.from_numpy(np.ascontiguousarray(
            queries, dtype=np.float32)).to(self.device)
        scores, docs = cosine_topk_batch(self.d_vecs, self.d_live, qs, k)
        return scores.cpu().numpy(), docs.cpu().numpy()
