"""Boolean clause combination, batched.

Counterpart of ``elasticsearch_tpu/ops/boolean.py``: Lucene's
BooleanScorer2/ConjunctionScorer docid-iterator merging becomes mask algebra
over dense per-doc vectors — conjunction is ``&``, the score of a
disjunction is ``+``, and ``minimum_should_match`` is a count threshold.
The JAX body runs one query under ``jax.vmap``; here every clause result
carries the batch as a leading axis (``[B, N]``, or ``[N]`` for a mask that
no query constant shapes, which broadcasts) and ``minimum_should_match`` is
a ``[B]`` tensor.

Scoring follows Lucene's BooleanWeight:

* must / should clauses contribute their scores (sum) — musts first, then
  shoulds, each in clause order: f32 addition does not associate, and this
  is the reference's order;
* filter / must_not contribute no score;
* a doc matches iff all musts match, no must_not matches, and at least
  ``minimum_should_match`` shoulds match.
"""

from __future__ import annotations

import torch

from elasticsearch_tpu_torch.ops import per_query


def combine_bool(shape: tuple, must: list, should: list, must_not: list,
                 filters: list, minimum_should_match, *, device=None):
    """Combine clause results into (scores [B, N] f32, mask [B, N] bool).

    ``shape`` is ``(B, N)``. Each element of must/should is a (scores,
    mask) pair; must_not/filters are masks. ``minimum_should_match`` is an
    int or a [B] tensor; with no should clause it is not read."""
    scores = torch.zeros(shape, dtype=torch.float32, device=device)
    mask = torch.ones(shape, dtype=torch.bool, device=device)
    for s, m in must:
        scores = scores + torch.where(m, s, 0.0)
        mask = mask & m
    for m in filters:
        mask = mask & m
    for m in must_not:
        mask = mask & ~m
    if should:
        should_count = torch.zeros(shape, dtype=torch.int32, device=device)
        for s, m in should:
            scores = scores + torch.where(m, s, 0.0)
            should_count = should_count + m.to(torch.int32)
        # applied unconditionally, as the reference does (msm == 0 makes the
        # predicate vacuously true)
        mask = mask & (should_count >= per_query(minimum_should_match,
                                                 device))
    return scores, mask


def constant_score(mask, boost):
    """A filter wrapped in constant_score: every matching doc scores
    ``boost`` (reference: ConstantScoreQuery). ``boost`` is a scalar or a
    [B] tensor; a [N] mask broadcasts to the batch."""
    b = per_query(boost, mask.device).to(torch.float32)
    scores = torch.where(mask, b, torch.zeros((), dtype=torch.float32,
                                              device=mask.device))
    return scores, mask.expand(scores.shape)
