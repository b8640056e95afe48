"""Structured filters over doc-values columns, batched.

Counterpart of ``elasticsearch_tpu/ops/filters.py`` (its keyword, numeric
and exists parts): term/terms/range/exists over keyword ordinals and
numeric columns — Lucene's TermQuery/TermRangeQuery/NumericRangeQuery over
doc values. Keyword vocabularies are sorted at segment build, so ordinal
compares implement lexical ranges. Numeric columns are double-double
``(hi, lo)`` f32 pairs whose lexicographic compare is exact f64 order.

Query constants are [B] tensors (one value per query of the batch) and
results are [B, N] masks; a scalar constant gives an [N] mask, as in the
reference. The geo filters are not ported yet.
"""

from __future__ import annotations

import torch

from elasticsearch_tpu_torch.common.errors import NotPortedError
from elasticsearch_tpu_torch.ops import per_query


def _any_value(ords, pred, q):
    """OR of ``pred`` over a multi-valued [N, K] ordinal column, one [B, N]
    compare per value slot (K is small), never a [B, N, K] intermediate."""
    hit = None
    for j in range(ords.shape[1]):
        h = pred(ords[:, j])
        hit = h if hit is None else (hit | h)
    if hit is None:
        return torch.zeros(torch.broadcast_shapes(q.shape, ords.shape[:1]),
                           dtype=torch.bool, device=ords.device)
    return hit


def keyword_term(ords, qord):
    """ords: [N, K] int32 (-1 pad); qord: [B] (or scalar) int32, -1 =
    absent → all False."""
    q = per_query(qord, ords.device)
    return _any_value(ords, lambda o: o == q, q) & (q >= 0)


def keyword_terms(ords, qords):
    """Any-of-set membership. qords: [B, M] (or [M]) int32, -1 pads."""
    qords = torch.as_tensor(qords, device=ords.device)
    hit = None
    for m in range(qords.shape[-1]):
        h = keyword_term(ords, qords[..., m])
        hit = h if hit is None else (hit | h)
    return hit


def keyword_ord_range(ords, lo, hi):
    """Ordinal interval [lo, hi) — backs keyword range and prefix queries.
    The host finds lo/hi by binary search over the sorted vocabulary."""
    lo_, hi_ = per_query(lo, ords.device), per_query(hi, ords.device)
    return _any_value(ords, lambda o: (o >= 0) & (o >= lo_) & (o < hi_), lo_)


def _dd_ge(hi, lo, qhi, qlo):
    """(hi, lo) double-double >= (qhi, qlo): exact f64 order in f32 ops."""
    return (hi > qhi) | ((hi == qhi) & (lo >= qlo))


def _dd_le(hi, lo, qhi, qlo):
    return (hi < qhi) | ((hi == qhi) & (lo <= qlo))


def _dd_gt(hi, lo, qhi, qlo):
    return (hi > qhi) | ((hi == qhi) & (lo > qlo))


def _dd_lt(hi, lo, qhi, qlo):
    return (hi < qhi) | ((hi == qhi) & (lo < qlo))


def numeric_range(hi, lo, exists, gte_hi, gte_lo, lte_hi, lte_lo,
                  lo_strict=None, hi_strict=None):
    """Exact numeric/date range over the double-double column. Open ends use
    ∓inf for (gte_hi, lte_hi) with 0 lo parts. Exclusive bounds pass
    lo_strict/hi_strict as 0/1 constants: strictness rides the comparison,
    not a nextafter-bumped bound, whose f64 neighbour of a small value
    underflows the f32 split back to the value itself."""
    dev = hi.device
    gh, gl, lh, ll = (per_query(x, dev)
                      for x in (gte_hi, gte_lo, lte_hi, lte_lo))
    ge = _dd_ge(hi, lo, gh, gl)
    if lo_strict is not None:
        ge = torch.where(per_query(lo_strict, dev) > 0,
                         _dd_gt(hi, lo, gh, gl), ge)
    le = _dd_le(hi, lo, lh, ll)
    if hi_strict is not None:
        le = torch.where(per_query(hi_strict, dev) > 0,
                         _dd_lt(hi, lo, lh, ll), le)
    return exists & ge & le


def numeric_term(hi, lo, exists, qhi, qlo):
    return exists & (hi == per_query(qhi, hi.device)) & \
        (lo == per_query(qlo, hi.device))


def field_exists(exists):
    return exists


def text_field_exists(doc_len):
    return doc_len > 0


def geo_distance(*args, **kwargs):
    raise NotPortedError("the geo_distance filter is not ported yet")


def geo_bounding_box(*args, **kwargs):
    raise NotPortedError("the geo_bounding_box filter is not ported yet")


def geo_distance_range(*args, **kwargs):
    raise NotPortedError("the geo_distance_range filter is not ported yet")


def geo_polygon(*args, **kwargs):
    raise NotPortedError("the geo_polygon filter is not ported yet")
