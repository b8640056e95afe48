"""Aggregation reductions over doc-values columns.

Counterpart of ``elasticsearch_tpu/ops/aggs_ops.py``. The reference builds a
per-segment collector tree that increments bucket counters doc by doc
(core/search/aggregations/Aggregator.java, AggregationPhase.java:44); here,
as in the JAX package, the reductions are masked dense ops over a segment's
columns: a terms agg counts ordinals, a histogram buckets values, metrics
are masked reductions. The eleven bodies of the JAX module keep their names
and contracts as plain PyTorch.

Two hand kernels serve the device collect of ``search/aggregations.py`` on
CUDA tensors, one launch a segment and aggregation:

* K8 ``csrc/agg_counts.cu`` — masked bucket counts in three modes:
  :func:`ord_counts` (the terms agg: :func:`ord_value_counts`),
  :func:`dd_histogram_counts` (histogram and fixed-interval date_histogram:
  :func:`histogram_counts_dd`) and :func:`dd_range_counts` (range and
  date_range: the double-double ``numeric_range`` compare of each range,
  summed — :func:`dd_range_counts_plain`);
* K9 ``csrc/agg_stats.cu`` — :func:`dd_stats`: count, the double-double
  extrema of :func:`dd_min_max`, the masked sums of hi and lo and the sum of
  squares (:func:`sum_of_squares`) in one pass, or the count alone
  (:func:`value_count`); plain version :func:`dd_stats_plain`.

The collective plane (``parallel/mesh_engine.py``) takes the terms,
histogram and metric lanes of a whole batch at once: the row-batched
entries :func:`ord_counts_rows`, :func:`dd_histogram_counts_rows` (K8) and
:func:`dd_stats_rows` (K9) count or reduce a ``[B, N]`` mask in one launch
(the JAX plane ``jax.vmap``s the one-row bodies over the batch), each row's
result the one a one-row launch gives.

On CPU tensors each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. The other bodies (per-ordinal sums, the f32
histogram and ranges, stats, cardinality, the sorted values) have no caller
on a served path and stay torch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from elasticsearch_tpu_torch.index.device_reader import dd_split
from elasticsearch_tpu_torch.ops import cuda_build
from elasticsearch_tpu_torch.ops.filters import numeric_range

INF = float("inf")

#: the dd row K9 writes (and :func:`dd_stats_plain` builds), f64 [8]
STATS_FIELDS = ("count", "min_hi", "min_lo", "max_hi", "max_lo", "sum_hi",
                "sum_lo", "sum_sq")

_ORDINAL, _HISTOGRAM, _RANGES = 0, 1, 2

AGG_COUNTS = cuda_build.CudaKernel(
    "agg_counts", "agg_counts.cu", "agg_counts_launch",
    [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])

AGG_STATS = cuda_build.CudaKernel(
    "agg_stats", "agg_stats.cu", "agg_stats_launch",
    [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])

#: the row-batched entries of K8 and K9 (the collective plane's lanes),
#: counted apart from the one-row launches
AGG_COUNTS_ROWS = cuda_build.CudaKernel(
    "agg_counts_rows", "agg_counts.cu", "agg_counts_rows_launch",
    [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])

AGG_STATS_ROWS = cuda_build.CudaKernel(
    "agg_stats_rows", "agg_stats.cu", "agg_stats_rows_launch",
    [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


# ---------------------------------------------------------------------------
# the JAX module's bodies, plain PyTorch
# ---------------------------------------------------------------------------

def _f32(v, device) -> torch.Tensor:
    """A host constant as the f32 scalar the reference's jnp.float32 is."""
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _segment_counts(idx, valid, num_segments: int):
    """segment_sum of ones at ``idx`` where ``valid`` (out-of-range ids
    dropped) → int32 [num_segments]."""
    out = torch.zeros(num_segments + 1, dtype=torch.int32, device=idx.device)
    idx = torch.where(valid, idx, num_segments).reshape(-1).to(torch.int64)
    out.index_add_(0, idx, valid.reshape(-1).to(torch.int32))
    return out[:num_segments]


def ord_value_counts(ords, mask, num_ords: int):
    """Terms-agg body: per-ordinal doc-value counts. ords: [N, K] int32 (-1
    pad); mask: [N] bool; → counts [num_ords] int32."""
    valid = (ords >= 0) & (ords < num_ords) & mask[:, None]
    return _segment_counts(ords, valid, num_ords)


def ord_metric_sums(ords, mask, metric_values, num_ords: int):
    """Per-ordinal sum of a metric column (sub-aggregation support): →
    sums [num_ords] f32."""
    valid = (ords >= 0) & (ords < num_ords) & mask[:, None]
    idx = torch.where(valid, ords, num_ords).reshape(-1).to(torch.int64)
    vals = torch.where(valid, metric_values[:, None].to(torch.float32),
                       0.0).reshape(-1)
    out = torch.zeros(num_ords + 1, dtype=torch.float32, device=ords.device)
    out.index_add_(0, idx, vals)
    return out[:num_ords]


def _bucket_of(q, num_buckets: int, in_ctx):
    """floor(q) as an int32 bucket, converted as XLA converts (NaN → 0,
    the rest saturated), kept where in context and in [0, num_buckets)."""
    f = torch.floor(q)
    f = torch.where(torch.isnan(f), 0.0, f)
    valid = in_ctx & (f >= 0) & (f < num_buckets)
    return torch.where(valid, f, 0.0).to(torch.int32), valid


def histogram_counts(values, exists, mask, base: float, interval: float,
                     num_buckets: int):
    """Histogram body: bucket i covers [base + i·interval, base +
    (i+1)·interval) → counts [num_buckets] int32."""
    dev = values.device
    q = (values - _f32(base, dev)) / _f32(interval, dev)
    idx, valid = _bucket_of(q, num_buckets, exists & mask)
    return _segment_counts(idx, valid, num_buckets)


def histogram_counts_dd(hi, lo, exists, mask, base_hi: float, base_lo: float,
                        interval: float, num_buckets: int):
    """Histogram over double-double values: bucketize the RELATIVE value
    (hi - base_hi) + (lo - base_lo), each operation rounded in f32 in the
    reference's order → counts [num_buckets] int32."""
    dev = hi.device
    rel = (hi - _f32(base_hi, dev)) + (lo - _f32(base_lo, dev))
    idx, valid = _bucket_of(rel / _f32(interval, dev), num_buckets,
                            exists & mask)
    return _segment_counts(idx, valid, num_buckets)


def range_counts(values, exists, mask, lows, highs):
    """range body: lows/highs [R] (±inf open ends), [low, high) → counts
    [R] int32 (ranges may overlap)."""
    in_ctx = (exists & mask)[:, None]
    hit = in_ctx & (values[:, None] >= lows[None, :]) & \
        (values[:, None] < highs[None, :])
    return hit.sum(dim=0, dtype=torch.int32)


def dd_min_max(hi, lo, exists, mask):
    """Exact extrema of a double-double column by lexicographic (hi, lo)
    order → (count, min_hi, min_lo, max_hi, max_lo) scalars."""
    m = exists & mask
    cnt = m.sum(dtype=torch.int32)
    mn_hi = torch.where(m, hi, INF).amin()
    mn_lo = torch.where(m & (hi == mn_hi), lo, INF).amin()
    mx_hi = torch.where(m, hi, -INF).amax()
    mx_lo = torch.where(m & (hi == mx_hi), lo, -INF).amax()
    return cnt, mn_hi, mn_lo, mx_hi, mx_lo


def stats_metrics(values, exists, mask):
    """min/max/sum/count in one pass (avg derived on the host)."""
    m = exists & mask
    cnt = m.sum(dtype=torch.int32)
    s = torch.where(m, values, 0.0).sum()
    mn = torch.where(m, values, INF).amin()
    mx = torch.where(m, values, -INF).amax()
    return cnt, s, mn, mx


def sum_of_squares(values, exists, mask):
    """extended_stats: Σv² (variance and std derived on the host)."""
    m = exists & mask
    return torch.where(m, values * values, 0.0).sum()


def value_count(exists, mask):
    return (exists & mask).sum(dtype=torch.int32)


def cardinality_ords(ords, mask, num_ords: int):
    """Distinct ordinals within this segment → (present [num_ords] bool,
    count)."""
    present = ord_value_counts(ords, mask, num_ords) > 0
    return present, present.sum(dtype=torch.int32)


def masked_sort_values(values, exists, mask, fill: float = INF):
    """Sorted live values (percentiles); fill sinks the rest to the end →
    (sorted [N], count)."""
    m = exists & mask
    return torch.sort(torch.where(m, values, fill)).values, \
        m.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# K8: masked bucket counts
# ---------------------------------------------------------------------------

def ord_counts(ords, mask, num_ords: int):
    """Per-ordinal counts of one segment's keyword column under ``mask``
    (K8, ordinal mode on CUDA): :func:`ord_value_counts`'s contract."""
    if ords.device.type == "cpu":
        return ord_value_counts(ords, mask, num_ords)
    counts = torch.empty(num_ords, dtype=torch.int32, device=ords.device)
    _counts_cuda(_ORDINAL, mask, counts, ords=ords)
    return counts


def dd_histogram_counts(hi, lo, exists, mask, base_hi: float, base_lo: float,
                        interval: float, num_buckets: int):
    """Fixed-interval bucket counts of a double-double column (K8,
    histogram mode on CUDA): :func:`histogram_counts_dd`'s contract."""
    if hi.device.type == "cpu":
        return histogram_counts_dd(hi, lo, exists, mask, base_hi, base_lo,
                                   interval, num_buckets)
    counts = torch.empty(num_buckets, dtype=torch.int32, device=hi.device)
    _counts_cuda(_HISTOGRAM, mask, counts, hi=hi, lo=lo, exists=exists,
                 consts=(float(np.float32(base_hi)),
                         float(np.float32(base_lo)),
                         float(np.float32(interval))))
    return counts


def range_bounds_dd(bounds) -> tuple[np.ndarray, np.ndarray]:
    """[(from, to)] f64 → ([R, 4] f32 (from_hi, from_lo, to_hi, to_lo) by
    the double-double split, [R] uint8: 1 where ``to`` compares strictly,
    i.e. unless it is +inf) — what :func:`dd_range_counts` takes."""
    out = np.zeros((len(bounds), 4), np.float32)
    strict = np.zeros(len(bounds), np.uint8)
    for r, (frm, to) in enumerate(bounds):
        out[r] = (*dd_split(float(frm)), *dd_split(float(to)))
        strict[r] = to != np.inf
    return out, strict


def dd_range_counts_plain(hi, lo, exists, mask, bounds, strict):
    """K8 range mode's plain version: per range the reference's
    ``numeric_range`` [from, to) compare (``to`` strict unless +inf), masked
    and summed → counts [R] int32."""
    rows = []
    for r in range(bounds.shape[0]):
        q = [bounds[r, j] for j in range(4)]
        m = numeric_range(hi, lo, exists, *q,
                          hi_strict=strict[r].to(torch.float32))
        rows.append((m & mask).sum(dtype=torch.int32))
    if not rows:
        return torch.zeros(0, dtype=torch.int32, device=hi.device)
    return torch.stack(rows)


def dd_range_counts(hi, lo, exists, mask, bounds, strict):
    """Range counts of a double-double column (K8, ranges mode on CUDA).
    bounds: [R, 4] f32 and strict: [R] uint8 from :func:`range_bounds_dd`,
    on the column's device → counts [R] int32; ranges may overlap."""
    if hi.device.type == "cpu":
        return dd_range_counts_plain(hi, lo, exists, mask, bounds, strict)
    cuda_build.check_dtype("agg_counts", "bounds", bounds, torch.float32)
    cuda_build.check_dtype("agg_counts", "strict", strict, torch.uint8)
    if bounds.dim() != 2 or bounds.shape[1] != 4 or \
            strict.shape != bounds.shape[:1]:
        raise ValueError(f"agg_counts: bounds must be [R, 4] with strict "
                         f"[R], got {tuple(bounds.shape)} and "
                         f"{tuple(strict.shape)}")
    counts = torch.empty(bounds.shape[0], dtype=torch.int32, device=hi.device)
    _counts_cuda(_RANGES, mask, counts, hi=hi, lo=lo, exists=exists,
                 bounds=bounds, strict=strict)
    return counts


def _counts_cuda(mode: int, mask, counts, *, ords=None, hi=None, lo=None,
                 exists=None, consts=(0.0, 0.0, 1.0), bounds=None,
                 strict=None) -> None:
    """K8 over a [N] mask into counts [nb], or (the row-batched entry)
    over a [B, N] mask into counts [B, nb]."""
    dev = mask.device
    n = mask.shape[-1]
    cuda_build.check_dtype("agg_counts", "mask", mask, torch.bool)
    cuda_build.check_dtype("agg_counts", "exists", exists, torch.bool)
    cuda_build.check_dtype("agg_counts", "ords", ords, torch.int32)
    for name, t in (("hi", hi), ("lo", lo)):
        cuda_build.check_dtype("agg_counts", name, t, torch.float32)
    if mode == _ORDINAL:
        if ords.dim() != 2 or ords.shape[0] != n:
            raise ValueError(f"agg_counts: ords must be [N={n}, K], got "
                             f"{tuple(ords.shape)}")
    else:
        for name, t in (("hi", hi), ("lo", lo), ("exists", exists)):
            if t.shape != (n,):
                raise ValueError(f"agg_counts: [{name}] shape "
                                 f"{tuple(t.shape)} != mask ({n},)")
    cuda_build.check_cuda("agg_counts", dev, mask=mask, exists=exists,
                          hi=hi, lo=lo, ords=ords, bounds=bounds,
                          strict=strict, counts=counts)
    p = cuda_build.ptr
    k = 1 if ords is None else ords.shape[1]
    if mask.dim() == 2:
        if counts.shape[0] != mask.shape[0]:
            raise ValueError(f"agg_counts: counts rows {counts.shape[0]} != "
                             f"mask rows {mask.shape[0]}")
        AGG_COUNTS_ROWS.launch(dev, mode, mask.shape[0], n, p(mask),
                               p(exists), p(hi), p(lo), p(ords), k, *consts,
                               p(bounds), p(strict), counts.shape[-1],
                               p(counts))
        return
    AGG_COUNTS.launch(dev, mode, n, p(mask), p(exists), p(hi), p(lo),
                      p(ords), k, *consts, p(bounds), p(strict),
                      counts.shape[0], p(counts))


# ---------------------------------------------------------------------------
# K9: masked double-double stats
# ---------------------------------------------------------------------------

def dd_stats_plain(hi, lo, exists, mask):
    """K9's plain version: the f64 [8] row of :data:`STATS_FIELDS` — the
    count, :func:`dd_min_max`'s extrema (a zero extremum as +0.0), the f32
    masked sums of hi and lo and :func:`sum_of_squares` of hi. With ``hi``
    None only the count is set (the rest 0)."""
    m = exists & mask
    if hi is None:
        row = torch.zeros(8, dtype=torch.float64, device=m.device)
        row[0] = value_count(exists, mask).to(torch.float64)
        return row
    cnt, mn_hi, mn_lo, mx_hi, mx_lo = dd_min_max(hi, lo, exists, mask)
    s_hi = torch.where(m, hi, 0.0).sum()
    s_lo = torch.where(m, lo, 0.0).sum()
    ssq = sum_of_squares(hi, exists, mask)
    # -0.0 + 0.0 is +0.0: the sign of a zero extremum is the reduction
    # order's, the value's is not
    return torch.stack([t.to(torch.float64) for t in (
        cnt, mn_hi + 0.0, mn_lo, mx_hi + 0.0, mx_lo, s_hi, s_lo, ssq)])


def dd_stats(hi, lo, exists, mask):
    """One segment's masked stats (K9 on CUDA) → f64 [8] in the order of
    :data:`STATS_FIELDS`; ``hi`` and ``lo`` None take the count alone
    (value_count)."""
    if mask.device.type == "cpu":
        return dd_stats_plain(hi, lo, exists, mask)
    dev = mask.device
    n = mask.shape[0]
    if (hi is None) != (lo is None):
        raise ValueError("agg_stats: hi and lo come together")
    for name, t in (("exists", exists), ("mask", mask)):
        cuda_build.check_dtype("agg_stats", name, t, torch.bool)
    for name, t in (("hi", hi), ("lo", lo)):
        cuda_build.check_dtype("agg_stats", name, t, torch.float32)
    for name, t in (("hi", hi), ("lo", lo), ("exists", exists)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"agg_stats: [{name}] shape {tuple(t.shape)} "
                             f"!= mask ({n},)")
    cuda_build.check_cuda("agg_stats", dev, hi=hi, lo=lo, exists=exists,
                          mask=mask)
    out = torch.empty(8, dtype=torch.float64, device=dev)
    partials = torch.empty(_STATS_SCRATCH_BYTES, dtype=torch.uint8,
                           device=dev)
    p = cuda_build.ptr
    AGG_STATS.launch(dev, n, p(hi), p(lo), p(exists), p(mask), p(partials),
                     p(out))
    return out


#: K9's launch shape (agg_stats.cu kThreads, kMaxBlocks) and its scratch
#: for the block partials, a record of at most 64 bytes each
#: (kRecordBytes), a mask row
_STATS_THREADS, _STATS_MAX_BLOCKS = 256, 264
_STATS_SCRATCH_BYTES = _STATS_MAX_BLOCKS * 64


# ---------------------------------------------------------------------------
# the row-batched entries (the collective plane's lanes)
# ---------------------------------------------------------------------------

def ord_counts_rows_plain(ords, mask, num_ords: int):
    """The row-batched ordinal mode's plain version: :func:`ord_value_counts`
    of every mask row → [B, num_ords] int32."""
    b = mask.shape[0]
    valid = (ords >= 0)[None] & (ords < num_ords)[None] & mask[:, :, None]
    rows = torch.arange(b, device=ords.device)[:, None, None]
    idx = torch.where(valid, rows * num_ords + ords[None].to(torch.int64),
                      b * num_ords)
    out = torch.zeros(b * num_ords + 1, dtype=torch.int32, device=ords.device)
    out.index_add_(0, idx.reshape(-1), valid.reshape(-1).to(torch.int32))
    return out[:b * num_ords].reshape(b, num_ords)


def ord_counts_rows(ords, mask, num_ords: int):
    """Per-ordinal counts of a keyword column under each row of a [B, N]
    mask (K8's row-batched entry on CUDA) → [B, num_ords] int32."""
    if ords.device.type == "cpu":
        return ord_counts_rows_plain(ords, mask, num_ords)
    counts = torch.empty((mask.shape[0], num_ords), dtype=torch.int32,
                         device=ords.device)
    _counts_cuda(_ORDINAL, mask, counts, ords=ords)
    return counts


def histogram_counts_dd_rows_plain(hi, lo, exists, mask, base_hi: float,
                                   base_lo: float, interval: float,
                                   num_buckets: int):
    """The row-batched histogram mode's plain version:
    :func:`histogram_counts_dd` of every mask row → [B, num_buckets]."""
    dev = hi.device
    b = mask.shape[0]
    rel = (hi - _f32(base_hi, dev)) + (lo - _f32(base_lo, dev))
    idx, valid = _bucket_of(rel / _f32(interval, dev), num_buckets,
                            exists[None, :] & mask)
    rows = torch.arange(b, device=dev)[:, None]
    flat = torch.where(valid, rows * num_buckets + idx.to(torch.int64),
                       b * num_buckets)
    out = torch.zeros(b * num_buckets + 1, dtype=torch.int32, device=dev)
    out.index_add_(0, flat.reshape(-1), valid.reshape(-1).to(torch.int32))
    return out[:b * num_buckets].reshape(b, num_buckets)


def dd_histogram_counts_rows(hi, lo, exists, mask, base_hi: float,
                             base_lo: float, interval: float,
                             num_buckets: int):
    """Fixed-interval bucket counts of a double-double column under each
    row of a [B, N] mask (K8's row-batched entry on CUDA) → [B,
    num_buckets] int32."""
    if hi.device.type == "cpu":
        return histogram_counts_dd_rows_plain(hi, lo, exists, mask, base_hi,
                                              base_lo, interval, num_buckets)
    counts = torch.empty((mask.shape[0], num_buckets), dtype=torch.int32,
                         device=hi.device)
    _counts_cuda(_HISTOGRAM, mask, counts, hi=hi, lo=lo, exists=exists,
                 consts=(float(np.float32(base_hi)),
                         float(np.float32(base_lo)),
                         float(np.float32(interval))))
    return counts


def _warp_fold(x):
    """Lane 0 of a warp's shuffle-down tree over the last axis (32 lanes):
    lane i adds lane i + 16, then i + 8, ..., 1 (agg_stats.cu warp_fold)."""
    for half in (16, 8, 4, 2, 1):
        x = x[..., :half] + x[..., half:2 * half]
    return x[..., 0]


def _k9_sum(vals):
    """Row sums of [B, N] f32 ``vals`` (rows out of context as +0.0) in
    K9's order: each of the launch's threads adds its rows in row order,
    a warp folds its threads, a block its warps, then one warp the block
    partials (agg_stats.cu). f32 throughout → [B] f32."""
    b, n = vals.shape
    blocks = min(max(-(-n // _STATS_THREADS), 1), _STATS_MAX_BLOCKS)
    stride = blocks * _STATS_THREADS
    per = max(-(-n // stride), 1)
    x = torch.zeros((b, per * stride), dtype=torch.float32,
                    device=vals.device)
    x[:, :n] = vals
    x = x.view(b, per, stride)
    acc = torch.zeros((b, stride), dtype=torch.float32, device=vals.device)
    for j in range(per):
        acc = acc + x[:, j]
    warps = _warp_fold(acc.view(b, blocks, _STATS_THREADS // 32, 32))
    parts = _warp_fold(torch.nn.functional.pad(
        warps, (0, 32 - warps.shape[-1])))                    # [B, blocks]
    lanes = -(-blocks // 32) * 32
    parts = torch.nn.functional.pad(parts, (0, lanes - blocks)).view(
        b, lanes // 32, 32)
    acc = torch.zeros((b, 32), dtype=torch.float32, device=vals.device)
    for j in range(lanes // 32):
        acc = acc + parts[:, j]
    return _warp_fold(acc)


def dd_stats_rows_plain(hi, lo, exists, mask):
    """The row-batched K9's plain version → [B, 8] f64: the count and
    :func:`dd_min_max`'s extrema of each mask row (a zero extremum as
    +0.0), and the f32 sums of hi, lo and hi² added in K9's order
    (:func:`_k9_sum`), so each row has the kernel's bits."""
    b = mask.shape[0]
    m = exists[None, :] & mask
    out = torch.zeros((b, 8), dtype=torch.float64, device=mask.device)
    out[:, 0] = m.sum(dim=1).to(torch.float64)
    if hi is None or b == 0:
        return out
    for r in range(b):
        _, mn_hi, mn_lo, mx_hi, mx_lo = dd_min_max(hi, lo, exists, mask[r])
        out[r, 1:5] = torch.stack([mn_hi + 0.0, mn_lo, mx_hi + 0.0,
                                   mx_lo]).to(torch.float64)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    for col, v in ((5, hi), (6, lo), (7, hi * hi)):
        out[:, col] = _k9_sum(torch.where(m, v[None, :], zero)).to(
            torch.float64)
    return out


def dd_stats_rows(hi, lo, exists, mask):
    """Masked stats of one column under each row of a [B, N] mask (K9's
    row-batched entry on CUDA) → [B, 8] f64 in the order of
    :data:`STATS_FIELDS`, each row the bits of a one-row launch and of
    :func:`dd_stats_rows_plain`."""
    if mask.device.type == "cpu":
        return dd_stats_rows_plain(hi, lo, exists, mask)
    dev = mask.device
    if mask.dim() != 2:
        raise ValueError(f"agg_stats: mask must be [B, N], got "
                         f"{tuple(mask.shape)}")
    rows, n = mask.shape
    if (hi is None) != (lo is None):
        raise ValueError("agg_stats: hi and lo come together")
    for name, t in (("exists", exists), ("mask", mask)):
        cuda_build.check_dtype("agg_stats", name, t, torch.bool)
    for name, t in (("hi", hi), ("lo", lo)):
        cuda_build.check_dtype("agg_stats", name, t, torch.float32)
    for name, t in (("hi", hi), ("lo", lo), ("exists", exists)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"agg_stats: [{name}] shape {tuple(t.shape)} "
                             f"!= mask rows ({n},)")
    cuda_build.check_cuda("agg_stats", dev, hi=hi, lo=lo, exists=exists,
                          mask=mask)
    out = torch.empty((rows, 8), dtype=torch.float64, device=dev)
    partials = torch.empty(max(rows, 1) * _STATS_SCRATCH_BYTES,
                           dtype=torch.uint8, device=dev)
    p = cuda_build.ptr
    AGG_STATS_ROWS.launch(dev, rows, n, p(hi), p(lo), p(exists), p(mask),
                          p(partials), p(out))
    return out
