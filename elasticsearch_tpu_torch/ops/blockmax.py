"""Top-k of candidate lists by (score desc, doc id asc).

Counterpart of the candidate-list part of ``elasticsearch_tpu/ops/blockmax.py``
(``topk_flat_by_doc``, ``merge_topk_by_doc``): the exact scorer's tie order
made explicit for candidates that arrive out of doc order — the hybrid
fusion of the knn lane reselects its fused lists through them. Two stable
sorts, doc ascending first and then score descending, so equal scores keep
doc order; ``torch.sort(stable=True)`` is stable on CUDA as on the CPU.

The impact scoring and block-max pruning bodies of that module belong to the
impact lane and are not ported yet.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")

#: sort key of an empty slot (doc id -1): after every real doc id
_PAD_DOC = 1 << 30


def topk_flat_by_doc(scores, docs, k: int):
    """Top-k of flat candidate lists by (score desc, doc id asc), batched
    over leading axes. Empty slots are (-inf, -1); lists shorter than k pad
    out. scores: [..., n] f32; docs: [..., n] int → ([..., k] f32,
    [..., k] docs)."""
    n = scores.shape[-1]
    if n < k:
        pad = [0, k - n]
        scores = torch.nn.functional.pad(scores, pad, value=NEG_INF)
        docs = torch.nn.functional.pad(docs, pad, value=-1)
    key_d = torch.where(docs >= 0, docs, _PAD_DOC)
    by_doc = torch.sort(key_d, dim=-1, stable=True).indices
    by_score = torch.sort(-torch.gather(scores, -1, by_doc), dim=-1,
                          stable=True).indices
    sel = torch.gather(by_doc, -1, by_score)[..., :k]
    ts = torch.gather(scores, -1, sel)
    return ts, torch.where(ts > NEG_INF, torch.gather(docs, -1, sel), -1)


def merge_topk_by_doc(scores_a, docs_a, scores_b, docs_b, k: int):
    """Top-k of the concatenation of two candidate lists (along the last
    axis) by (score desc, doc id asc). Empty slots: (-inf, -1)."""
    return topk_flat_by_doc(torch.cat([scores_a, scores_b], dim=-1),
                            torch.cat([docs_a, docs_b], dim=-1), k)
