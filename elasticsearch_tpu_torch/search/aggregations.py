"""Aggregations: parse → per-shard collect → cross-shard reduce → render.

Counterpart of ``elasticsearch_tpu/search/aggregations.py``. Reference: the
aggregation framework (core/search/aggregations/): Aggregator collector trees
per segment, ``InternalAggregation.reduce`` (InternalAggregations.java:133)
merging shard partials at the coordinator.

A shard's collect phase consumes the query's per-segment match masks, which
stay on the card. The hot shapes are collected there
(:func:`collect_device`): a terms agg over a keyword column, min / max /
sum / avg / stats / extended_stats, value_count, histogram, fixed-interval
date_histogram, range and date_range each take one launch a segment of the
hand kernels K8 (``ops/aggs_ops.ord_counts``, ``dd_histogram_counts``,
``dd_range_counts``) or K9 (``ops/aggs_ops.dd_stats``), and only bucket- or
scalar-sized results cross to the host. The shapes the JAX package keeps on
the host (sub-aggregations and pipelines, ``script``, ``missing`` or
``order`` params, calendar intervals, more than 10,000 histogram buckets, a
missing column) go to the numpy collectors over the host mask, as there;
:data:`DEVICE_AGG_STATS` counts both routes. That routing is by shape only:
an error on the card propagates. Partials are plain dicts merged by the same
reduce tree the coordinator applies across shards.

Served: terms, significant_terms, histogram, date_histogram (fixed and
calendar intervals), range, date_range, filter, filters, global, missing,
sampler, geohash_grid, geo_distance (bucket); min / max / sum / avg / stats
/ extended_stats / value_count / cardinality / percentiles /
percentile_ranks / top_hits / scripted_metric / geo_bounds / geo_centroid
(metrics); avg_bucket / max_bucket / min_bucket /
sum_bucket / cumulative_sum / derivative / moving_avg / serial_diff /
bucket_script / bucket_selector (pipeline). A scripted_metric whose map
script is an expression runs it through kernel K12 over each segment's
matching rows; one with init / combine / reduce scripts, or a map script the
expression grammar cannot take, runs GroovyLite per doc on the host, as in
the JAX package. bucket_script and bucket_selector evaluate their
expression over every bucket of the pipeline in one K12 launch on the
request's device (``reduce_aggs(..., device=)``), the Python arithmetic of
each bucket's values on the host first. A top_hits takes ``highlight`` and
``script_fields`` and renders neither, as the JAX package's collector does.
The geo aggregations are numpy collectors over the host's float64 geo
columns, as in the JAX package (geohash_grid encodes each matching point's
cell in a Python loop). The nested and reverse_nested aggregations are
numpy collectors too, as in the JAX package: a nested agg's sub-aggregations
run over the path's child rows of the matching parents (a ``filter`` under
it evaluates its query over the child segments through
``segment_exec.match_mask``), and a reverse_nested directly under it maps
the child rows back to their parents. Refused at parse time with
:class:`NotPortedError` until the module it needs is ported: children (the
join queries).
"""

from __future__ import annotations

import math
import threading
import types
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import (
    NotPortedError, QueryParsingError)
from elasticsearch_tpu_torch.common.settings import parse_time_value
from elasticsearch_tpu_torch.index.device_reader import dd_split
from elasticsearch_tpu_torch.mapping.mapper import parse_date
from elasticsearch_tpu_torch.ops import aggs_ops
from elasticsearch_tpu_torch.search import segment_exec
from elasticsearch_tpu_torch.utils.geohash import (
    geohash_encode, precision_to_length)

PIPELINE_AGGS = {"avg_bucket", "max_bucket", "min_bucket", "sum_bucket",
                 "cumulative_sum", "derivative", "moving_avg",
                 "serial_diff", "bucket_script", "bucket_selector"}

_CALENDAR = {"year": "Y", "1y": "Y", "quarter": "Q", "1q": "Q",
             "month": "M", "1M": "M", "week": "W", "1w": "W"}


def _java_decimal_format(value, pattern: str) -> str:
    """Minimal Java DecimalFormat rendering for histogram `format`
    (ref: ValueFormatter.Number.Pattern): literal prefix/suffix around a
    #/0 digit pattern; the count of '0's after '.' fixes the decimals."""
    import re as _re
    m = _re.search(r"[#0][#0,]*(?:\.([0#]+))?", pattern)
    if m is None:
        return str(value)
    decimals = len(m.group(1)) if m.group(1) else 0
    num = f"{float(value):.{decimals}f}" if decimals else \
        str(int(round(float(value))))
    return pattern[:m.start()] + num + pattern[m.end():]


@dataclass
class AggNode:
    name: str
    type: str
    params: dict
    subs: list["AggNode"] = field(default_factory=list)
    pipelines: list["AggNode"] = field(default_factory=list)


def parse_aggs(body: dict | None) -> list[AggNode]:
    out: list[AggNode] = []
    if not body:
        return out
    for name, spec in body.items():
        sub_specs = spec.get("aggs", spec.get("aggregations")) or {}
        atype = None
        params: dict = {}
        for key, val in spec.items():
            if key in ("aggs", "aggregations", "meta"):
                continue
            atype, params = key, val
        if atype is None:
            raise QueryParsingError(f"aggregation [{name}] missing type")
        _refuse_not_ported(name, atype)
        node = AggNode(name=name, type=atype, params=params or {})
        for sub in parse_aggs(sub_specs):
            (node.pipelines if sub.type in PIPELINE_AGGS else node.subs).append(sub)
        out.append(node)
    return out




#: aggregation type → the module it waits for
_NOT_PORTED = {"children": "the join queries"}


def _refuse_not_ported(name: str, atype: str) -> None:
    if atype in _NOT_PORTED:
        raise NotPortedError(f"aggregation [{name}]: [{atype}] is not ported "
                             f"yet (it needs {_NOT_PORTED[atype]})")


# ---------------------------------------------------------------------------
# device collect (K8 / K9 over the card's masks)
# ---------------------------------------------------------------------------

# how collection executed: nodes served on the device, nodes that went to
# the host collectors
DEVICE_AGG_STATS = {"device_collects": 0, "host_fallbacks": 0}
_STATS_LOCK = threading.Lock()


def note_agg_stat(key: str) -> None:
    """Count one event in DEVICE_AGG_STATS (shards collect from several
    threads)."""
    with _STATS_LOCK:
        DEVICE_AGG_STATS[key] += 1


class DeviceAggState:
    """Per-segment query masks (+ scores) on the card for aggregation
    collection.

    The device path (collect_device) reduces on the card and copies only
    bucket- and scalar-sized results; nodes it does not serve go to the
    numpy collectors, which need the full masks on the host —
    ``np_mask()`` materializes them lazily and counts doing so, so a run can
    show the device path never copied a full column."""

    def __init__(self, reader, masks_dev: list, scores_dev: list):
        self.reader = reader
        self.masks = masks_dev            # per segment [Np] bool
        self.scores_dev = scores_dev      # per segment [Np] f32
        self.host_materializations = 0
        self._np_mask = None
        self._np_scores = None

    def np_mask(self) -> np.ndarray:
        if self._np_mask is None:
            self.host_materializations += 1
            self._np_mask = torch.cat(self.masks).cpu().numpy() \
                if self.masks else np.zeros(0, bool)
        return self._np_mask

    def np_scores(self) -> np.ndarray:
        if self._np_scores is None:
            self._np_scores = torch.cat(self.scores_dev).cpu().numpy() \
                if self.scores_dev else np.zeros(0, np.float32)
        return self._np_scores


_DEVICE_METRICS = {"min", "max", "sum", "avg", "stats", "extended_stats"}
_MAX_DEVICE_HISTO_BUCKETS = 10_000


def collect_device(node: AggNode, state: DeviceAggState) -> dict | None:
    """Device collection for the hot agg shapes: one K8 or K9 launch a
    segment, only bucket / scalar results crossing to the host (ref
    collector tree: AggregationPhase.java:44). Returns None for the shapes
    the JAX package keeps on the host — script / missing / order params,
    sub-aggregations, calendar intervals, text-backed terms, a missing
    column — and the numpy collectors take over.

    Precision: sums accumulate in f32 over the (hi, lo) double-double split,
    as in the JAX package; counts, buckets and extrema are exact."""
    if node.subs or node.pipelines:
        return None
    params = node.params
    if "script" in params or "missing" in params or "order" in params:
        return None
    fname = params.get("field")
    if fname is None:
        return None
    try:
        if node.type in _DEVICE_METRICS:
            out = _d_metric(fname, state)
        elif node.type == "value_count":
            out = _d_value_count(fname, state)
        elif node.type == "terms":
            out = _d_terms(fname, state)
        elif node.type == "histogram":
            out = _d_histogram(node, fname, state)
        elif node.type == "date_histogram":
            interval = params.get("interval") or \
                params.get("calendar_interval") or params.get("fixed_interval")
            if _CALENDAR.get(str(interval)) is not None:
                return None               # calendar buckets stay host-side
            out = _d_date_histogram(node, fname, state)
        elif node.type in ("range", "date_range"):
            out = _d_range(node, fname, state,
                           is_date=node.type == "date_range")
        else:
            return None
    except _DeviceAggFallback:
        return None
    note_agg_stat("device_collects")
    return out


class _DeviceAggFallback(Exception):
    """A shape the device collect does not serve (never a card error)."""


def _d_numeric_cols(fname: str, state: DeviceAggState):
    cols = [seg.numeric.get(fname) for seg in state.reader.segments]
    if not any(c is not None for c in cols):
        raise _DeviceAggFallback
    return cols


def _d_stats(fname: str, state: DeviceAggState):
    """→ (rows [segments with the column, 8] f64 in
    ``aggs_ops.STATS_FIELDS`` order — one K9 launch a segment and ONE
    copy — and the columns)."""
    cols = _d_numeric_cols(fname, state)
    rows = [aggs_ops.dd_stats(col.hi, col.lo, col.exists, mask)
            for col, mask in zip(cols, state.masks) if col is not None]
    return torch.stack(rows).cpu().numpy(), cols


def _dd_extrema(rows: np.ndarray) -> tuple[float, float]:
    """Host reduce of per-segment dd extrema → exact f64 (min, max)."""
    live = rows[:, 0] > 0
    mins = rows[live, 1] + rows[live, 2]
    maxs = rows[live, 3] + rows[live, 4]
    return float(mins.min()), float(maxs.max())


def _d_metric(fname: str, state: DeviceAggState) -> dict:
    rows, _ = _d_stats(fname, state)
    count = int(rows[:, 0].sum())
    out = {"count": count}
    if count:
        mn, mx = _dd_extrema(rows)
        out.update(sum=float(rows[:, 5].sum() + rows[:, 6].sum()),
                   min=mn, max=mx, sum_sq=float(rows[:, 7].sum()))
    else:
        out.update(sum=0.0, min=None, max=None, sum_sq=0.0)
    return out


def _d_value_count(fname: str, state: DeviceAggState) -> dict:
    rows = []
    for seg, mask in zip(state.reader.segments, state.masks):
        ncol = seg.numeric.get(fname)
        if ncol is not None:
            rows.append(aggs_ops.dd_stats(None, None, ncol.exists, mask))
            continue
        kcol = seg.keyword.get(fname)
        if kcol is not None:
            rows.append(aggs_ops.dd_stats(
                None, None, (kcol.ords >= 0).any(dim=1), mask))
    if not rows:
        raise _DeviceAggFallback
    return {"count": int(torch.stack(rows).cpu().numpy()[:, 0].sum())}


def _d_terms(fname: str, state: DeviceAggState) -> dict:
    """Keyword terms agg: per-segment ordinal counts on the card (K8),
    copied in one transfer and union-merged on the host by term string.
    Resolution mirrors ShardAggContext.keyword_values: an analyzed text
    field wins over its .keyword multi-field and stays on the host."""
    segs = state.reader.segments
    candidates = [fname]
    if not any(seg.text.get(fname) is not None for seg in segs):
        candidates.append(f"{fname}.keyword")
    for candidate in candidates:
        cols = [seg.keyword.get(candidate) for seg in segs]
        if not any(c is not None for c in cols):
            continue
        vocabs, counts = [], []
        for col, mask in zip(cols, state.masks):
            if col is None or not col.column.vocab:
                continue
            vocabs.append(col.column.vocab)
            counts.append(aggs_ops.ord_counts(col.ords, mask,
                                              len(col.column.vocab)))
        merged: dict[str, int] = {}
        if counts:
            flat = torch.cat(counts).cpu().numpy()
            off = 0
            for vocab in vocabs:
                seg_counts = flat[off:off + len(vocab)]
                off += len(vocab)
                for oid in np.nonzero(seg_counts)[0]:
                    key = vocab[int(oid)]
                    merged[key] = merged.get(key, 0) + int(seg_counts[oid])
        buckets = {k: {"doc_count": n} for k, n in merged.items()}
        return {"buckets": _as_pairs(buckets),
                "doc_count_error_upper_bound": 0}
    raise _DeviceAggFallback        # numeric/text terms stay host-side


def _d_histogram_common(node: AggNode, fname: str, state: DeviceAggState,
                        interval: float, offset: float):
    rows, cols = _d_stats(fname, state)
    if not int(rows[:, 0].sum()):
        return []
    # dd-exact extrema → the base bucket is exact; no edge docs can land
    # below index 0 or beyond the last bucket
    lo, hi = _dd_extrema(rows)
    first = math.floor((lo - offset) / interval)
    last = math.floor((hi - offset) / interval)
    n_buckets = int(last - first + 1)
    if n_buckets > _MAX_DEVICE_HISTO_BUCKETS:
        raise _DeviceAggFallback
    base = first * interval + offset
    base_hi, base_lo = dd_split(np.float64(base))
    per_seg = [aggs_ops.dd_histogram_counts(
        col.hi, col.lo, col.exists, mask, float(base_hi), float(base_lo),
        interval, n_buckets)
        for col, mask in zip(cols, state.masks) if col is not None]
    counts = torch.stack(per_seg).cpu().numpy().sum(axis=0)
    return [(base + i * interval, int(c))
            for i, c in enumerate(counts) if c > 0]


def _d_histogram(node: AggNode, fname: str, state: DeviceAggState) -> dict:
    interval = float(node.params["interval"])
    offset = float(node.params.get("offset", 0.0))
    pairs = _d_histogram_common(node, fname, state, interval, offset)
    buckets = {float(k): {"doc_count": c} for k, c in pairs}
    return {"buckets": _as_pairs(buckets), "interval": interval,
            "min_doc_count": int(node.params.get("min_doc_count", 0))}


def _d_date_histogram(node: AggNode, fname: str,
                      state: DeviceAggState) -> dict:
    interval = node.params.get("interval") or \
        node.params.get("calendar_interval") or \
        node.params.get("fixed_interval")
    try:
        # calendar names the host path knows ('1d', 'day'...) may not be
        # fixed-parseable: those shapes go to the host collector
        ms = parse_time_value(interval) * 1000.0
    except Exception:                       # noqa: BLE001 — shape routing
        raise _DeviceAggFallback from None
    pairs = _d_histogram_common(node, fname, state, ms, 0.0)
    buckets = {int(k): {"doc_count": c} for k, c in pairs}
    return {"buckets": _as_pairs(buckets), "date": True}


def _d_range(node: AggNode, fname: str, state: DeviceAggState,
             is_date: bool) -> dict:
    """range / date_range: one K8 launch a segment counts every range by
    the double-double compare, [from, to) with ``to`` strict unless +inf
    (a nextafter-bumped bound would underflow the dd split for small
    values such as ``to: 0`` and turn exclusive into inclusive)."""
    bounds = _range_bounds(node, is_date)
    if not bounds:
        return {"buckets": [], "keyed_order": []}
    cols = _d_numeric_cols(fname, state)
    dd, strict = aggs_ops.range_bounds_dd([(lo, hi) for _, lo, hi in bounds])
    dev = state.masks[0].device
    dd, strict = torch.from_numpy(dd).to(dev), torch.from_numpy(strict).to(dev)
    per_seg = [aggs_ops.dd_range_counts(col.hi, col.lo, col.exists, mask, dd,
                                        strict)
               for col, mask in zip(cols, state.masks) if col is not None]
    counts = torch.stack(per_seg).cpu().numpy().sum(axis=0)
    buckets = {}
    for (key, lo, hi), c in zip(bounds, counts):
        buckets[key] = {"doc_count": int(c),
                        "from": None if lo == -np.inf else lo,
                        "to": None if hi == np.inf else hi}
    return {"buckets": _as_pairs(buckets),
            "keyed_order": [b[0] for b in bounds]}

# ---------------------------------------------------------------------------
# collect phase (per shard)
# ---------------------------------------------------------------------------

class ShardAggContext:
    """Host views of one shard's reader for aggregation collection."""

    def __init__(self, reader, execute_filter, scores=None, exec_ctx=None):
        self.reader = reader
        self.execute_filter = execute_filter  # (Query) → [N] np mask
        self.scores = scores                  # [N] query scores (top_hits)
        # the query ExecutionContext, when the caller has one: a filter
        # under a nested agg runs its query over the child segments with it
        self.exec_ctx = exec_ctx

    def live_mask(self) -> np.ndarray:
        """Concatenated live mask over the reader (significant_terms'
        background set, the global agg)."""
        return torch.cat([s.live for s in self.reader.segments]).cpu() \
            .numpy() if self.reader.segments else np.zeros(0, bool)

    def numeric_values(self, fname: str):
        """→ (values f64 concat over segments, exists concat)."""
        vals, exists = [], []
        for s in self.reader.segments:
            col = s.seg.numeric_fields.get(fname)
            if col is None:
                vals.append(np.zeros(s.padded_docs))
                exists.append(np.zeros(s.padded_docs, bool))
            else:
                vals.append(col.values)
                exists.append(col.exists)
        return np.concatenate(vals), np.concatenate(exists)

    def keyword_values(self, fname: str):
        """→ (ords [N,K] concat (ord remapped to per-shard union), vocab).

        Resolution order: exact keyword column → uninverted text tokens
        (the reference loads fielddata for an analyzed string, so a
        terms/significant_terms agg on it yields the ANALYZED tokens —
        IndexFieldDataService on a string field, SURVEY §2.5 fielddata) →
        `{field}.keyword` multi-field as a last resort."""
        segs = self.reader.segments
        cols = [s.seg.keyword_fields.get(fname) for s in segs]
        if any(c is not None for c in cols):
            return self._union_ords(
                [(c.vocab, c.ords) if c is not None else None
                 for c in cols])
        tcols = [s.seg.text_fields.get(fname) for s in segs]
        if any(c is not None for c in tcols):
            return self._union_ords(
                [(c.terms, c.uterms) if c is not None else None
                 for c in tcols])
        cols = [s.seg.keyword_fields.get(f"{fname}.keyword") for s in segs]
        if any(c is not None for c in cols):
            return self._union_ords(
                [(c.vocab, c.ords) if c is not None else None
                 for c in cols])
        return self._union_ords([None] * len(segs))

    def geo_values(self, fname: str):
        """→ (lat f64, lon f64, exists) concatenated over segments, from
        the host columns."""
        lats, lons, exists = [], [], []
        for s in self.reader.segments:
            col = s.seg.geo_fields.get(fname)
            if col is None:
                lats.append(np.zeros(s.padded_docs))
                lons.append(np.zeros(s.padded_docs))
                exists.append(np.zeros(s.padded_docs, bool))
            else:
                lats.append(np.asarray(col.lat, np.float64))
                lons.append(np.asarray(col.lon, np.float64))
                exists.append(np.asarray(col.exists, bool))
        return (np.concatenate(lats), np.concatenate(lons),
                np.concatenate(exists))

    def _union_ords(self, per_seg):
        """[(vocab, ords[Np,K]) | None per segment] → shard-union view."""
        union: dict[str, int] = {}
        kmax = 1
        for item in per_seg:
            if item is not None:
                vocab, ords = item
                kmax = max(kmax, ords.shape[1])
                for v in vocab:
                    union.setdefault(v, len(union))
        rows = []
        for s, item in zip(self.reader.segments, per_seg):
            if item is None:
                rows.append(np.full((s.padded_docs, kmax), -1, np.int32))
                continue
            vocab, ords = item
            remap = np.array([union[v] for v in vocab] or [0], np.int32)
            out = np.full((ords.shape[0], kmax), -1, np.int32)
            valid = ords >= 0
            out[:, :ords.shape[1]] = np.where(
                valid, remap[np.clip(ords, 0, None)], -1)
            rows.append(out)
        vocab_out = [None] * len(union)
        for v, i in union.items():
            vocab_out[i] = v
        return np.concatenate(rows), vocab_out


def collect(node: AggNode, mask: np.ndarray, ctx: ShardAggContext) -> dict:
    """→ shard partial for this agg (merged by reduce())."""
    fn = _COLLECTORS.get(node.type)
    if fn is None:
        raise QueryParsingError(f"unknown aggregation type [{node.type}]")
    return fn(node, mask, ctx)


def _collect_subs(node: AggNode, mask: np.ndarray, ctx: ShardAggContext) -> dict:
    return {sub.name: collect(sub, mask, ctx) for sub in node.subs}


def _field_numeric(node: AggNode, ctx: ShardAggContext):
    fname = node.params.get("field")
    if fname is None:
        raise QueryParsingError(f"agg [{node.name}] requires a field")
    return ctx.numeric_values(fname)


def _c_metric(node, mask, ctx):
    vals, exists = _field_numeric(node, ctx)
    m = mask & exists
    v = vals[m]
    out = {"count": int(v.size)}
    if v.size:
        out.update(sum=float(v.sum()), min=float(v.min()), max=float(v.max()),
                   sum_sq=float((v * v).sum()))
    else:
        out.update(sum=0.0, min=None, max=None, sum_sq=0.0)
    return out


def _c_value_count(node, mask, ctx):
    fname = node.params.get("field")
    ncol_vals, exists = ctx.numeric_values(fname)
    if exists.any():
        return {"count": int((mask & exists).sum())}
    ords, _ = ctx.keyword_values(fname)
    valid = (ords >= 0).any(axis=1)
    return {"count": int((mask & valid).sum())}


def _c_cardinality(node, mask, ctx):
    fname = node.params.get("field")
    ords, vocab = ctx.keyword_values(fname)
    if vocab:
        sel = ords[mask]
        present = np.unique(sel[sel >= 0])
        return {"values": [vocab[i] for i in present]}
    vals, exists = ctx.numeric_values(fname)
    return {"values": np.unique(vals[mask & exists]).tolist()}


def _c_percentiles(node, mask, ctx):
    vals, exists = _field_numeric(node, ctx)
    return {"values": vals[mask & exists].tolist(),
            "percents": node.params.get("percents",
                                        [1, 5, 25, 50, 75, 95, 99])}


def _c_top_hits(node, mask, ctx):
    size = int(node.params.get("size", 3))
    idx = np.nonzero(mask)[0]
    if ctx.scores is not None and idx.size:
        # top hits ordered by query score desc, doc asc (ES default)
        order = np.lexsort((idx, -ctx.scores[idx]))
        idx = idx[order]
    idx = idx[:size]
    hits = []
    for gid in idx:
        score = float(ctx.scores[int(gid)]) if ctx.scores is not None else None
        hits.append({"_id": ctx.reader.doc_id(int(gid)),
                     "_score": score,
                     "_source": ctx.reader.source(int(gid))})
    return {"hits": hits, "total": int(mask.sum()), "size": size}


def _c_terms(node, mask, ctx):
    fname = node.params.get("field")
    ords, vocab = ctx.keyword_values(fname)
    if vocab:
        sel = ords[mask]
        sel = sel[sel >= 0]
        counts = np.bincount(sel, minlength=len(vocab))
        buckets = {}
        present = np.nonzero(counts)[0]
        # shard_size: collect more than size for accurate cross-shard merge
        # (reference: terms agg shard_size heuristics)
        order = node.params.get("order")
        for oid in present:
            key = vocab[oid]
            b = {"doc_count": int(counts[oid])}
            if node.subs:
                bmask = mask & (ords == oid).any(axis=1)
                b["subs"] = _collect_subs(node, bmask, ctx)
            buckets[key] = b
        return {"buckets": _as_pairs(buckets),
                "doc_count_error_upper_bound": 0}
    # numeric terms
    vals, exists = ctx.numeric_values(fname)
    sel = vals[mask & exists]
    uniq, counts = np.unique(sel, return_counts=True)
    buckets = {}
    for u, c in zip(uniq, counts):
        key = int(u) if float(u).is_integer() else float(u)
        b = {"doc_count": int(c)}
        if node.subs:
            bmask = mask & exists & (vals == u)
            b["subs"] = _collect_subs(node, bmask, ctx)
        buckets[key] = b
    return {"buckets": _as_pairs(buckets),
            "doc_count_error_upper_bound": 0}


def _c_histogram(node, mask, ctx):
    vals, exists = _field_numeric(node, ctx)
    interval = float(node.params["interval"])
    offset = float(node.params.get("offset", 0.0))
    m = mask & exists
    v = vals[m]
    buckets = {}
    if v.size:
        keys = np.floor((v - offset) / interval) * interval + offset
        uniq, counts = np.unique(keys, return_counts=True)
        for u, c in zip(uniq, counts):
            b = {"doc_count": int(c)}
            if node.subs:
                kk = np.floor((vals - offset) / interval) * interval + offset
                bmask = m.copy()
                bmask[m] = False  # rebuilt below
                bmask = mask & exists & (kk == u)
                b["subs"] = _collect_subs(node, bmask, ctx)
            buckets[float(u)] = b
    return {"buckets": _as_pairs(buckets), "interval": interval,
            "min_doc_count": int(node.params.get("min_doc_count", 0))}


def _c_date_histogram(node, mask, ctx):
    vals, exists = _field_numeric(node, ctx)
    interval = node.params.get("interval") or \
        node.params.get("calendar_interval") or \
        node.params.get("fixed_interval")
    m = mask & exists
    v = vals[m]
    buckets = {}
    cal = _CALENDAR.get(str(interval))
    if cal is not None:
        if v.size:
            dt = v.astype("datetime64[ms]").astype(f"datetime64[{cal}]")
            keys = dt.astype("datetime64[ms]").astype(np.int64)
            uniq, counts = np.unique(keys, return_counts=True)
            all_dt = vals.astype("datetime64[ms]").astype(f"datetime64[{cal}]") \
                .astype("datetime64[ms]").astype(np.int64)
            for u, c in zip(uniq, counts):
                b = {"doc_count": int(c)}
                if node.subs:
                    b["subs"] = _collect_subs(
                        node, mask & exists & (all_dt == u), ctx)
                buckets[int(u)] = b
        return {"buckets": _as_pairs(buckets), "date": True}
    ms = parse_time_value(interval) * 1000.0
    if v.size:
        keys = np.floor(v / ms) * ms
        uniq, counts = np.unique(keys, return_counts=True)
        for u, c in zip(uniq, counts):
            b = {"doc_count": int(c)}
            if node.subs:
                kk = np.floor(vals / ms) * ms
                b["subs"] = _collect_subs(node, mask & exists & (kk == u), ctx)
            buckets[int(u)] = b
    return {"buckets": _as_pairs(buckets), "date": True}


def _range_bounds(node, is_date: bool):
    bounds = []
    for r in node.params.get("ranges", []):
        frm = r.get("from")
        to = r.get("to")
        if is_date:
            frm = parse_date(frm) if frm is not None else None
            to = parse_date(to) if to is not None else None
        key = r.get("key")
        if key is None:
            key = f"{frm if frm is not None else '*'}-{to if to is not None else '*'}"
        bounds.append((key, -np.inf if frm is None else float(frm),
                       np.inf if to is None else float(to)))
    return bounds


def _c_range(node, mask, ctx, is_date=False):
    vals, exists = _field_numeric(node, ctx)
    m = mask & exists
    buckets = {}
    for key, lo, hi in _range_bounds(node, is_date):
        bmask = m & (vals >= lo) & (vals < hi)
        b = {"doc_count": int(bmask.sum()), "from": None if lo == -np.inf else lo,
             "to": None if hi == np.inf else hi}
        if node.subs:
            b["subs"] = _collect_subs(node, bmask, ctx)
        buckets[key] = b
    return {"buckets": _as_pairs(buckets), "keyed_order": [b[0] for b in
                                                _range_bounds(node, is_date)]}


def _c_filter(node, mask, ctx):
    from elasticsearch_tpu_torch.search.query_dsl import parse_query
    fmask = ctx.execute_filter(parse_query(node.params))
    bmask = mask & fmask
    out = {"doc_count": int(bmask.sum())}
    if node.subs:
        out["subs"] = _collect_subs(node, bmask, ctx)
    return out


def _c_filters(node, mask, ctx):
    from elasticsearch_tpu_torch.search.query_dsl import parse_query
    buckets = {}
    specs = node.params.get("filters", {})
    items = specs.items() if isinstance(specs, dict) else \
        ((str(i), s) for i, s in enumerate(specs))
    for key, spec in items:
        fmask = ctx.execute_filter(parse_query(spec))
        bmask = mask & fmask
        b = {"doc_count": int(bmask.sum())}
        if node.subs:
            b["subs"] = _collect_subs(node, bmask, ctx)
        buckets[key] = b
    return {"buckets": _as_pairs(buckets)}


def _c_global(node, mask, ctx):
    # global agg ignores the query, but not deletes/padding: rebuild liveness
    live = ctx.live_mask() if ctx.reader.segments else mask
    out = {"doc_count": int(live.sum())}
    if node.subs:
        out["subs"] = _collect_subs(node, live, ctx)
    return out


def _c_missing(node, mask, ctx):
    fname = node.params.get("field")
    vals, exists = ctx.numeric_values(fname)
    if not exists.any():
        ords, vocab = ctx.keyword_values(fname)
        exists = (ords >= 0).any(axis=1)
    bmask = mask & ~exists
    out = {"doc_count": int(bmask.sum())}
    if node.subs:
        out["subs"] = _collect_subs(node, bmask, ctx)
    return out


def _c_significant_terms(node, mask, ctx):
    """significant_terms (ref: core/search/aggregations/bucket/significant/
    SignificantTermsAggregator + JLHScore): per-term foreground (query
    mask) and background (whole index) counts; the coordinator scores the
    merged counts."""
    fname = node.params.get("field")
    ords, vocab = ctx.keyword_values(fname)
    live = ctx.live_mask()
    if not vocab:
        return {"buckets": [], "fg_total": int((mask & live).sum()),
                "bg_total": int(live.sum())}
    fg_sel = ords[mask & live]
    bg_sel = ords[live]
    fg = np.bincount(fg_sel[fg_sel >= 0], minlength=len(vocab))
    bg = np.bincount(bg_sel[bg_sel >= 0], minlength=len(vocab))
    buckets = {}
    for oid in np.nonzero(fg)[0]:
        key = vocab[int(oid)]
        b = {"doc_count": int(fg[oid]), "bg_count": int(bg[oid])}
        if node.subs:
            bmask = mask & live & (ords == oid).any(axis=1)
            b["subs"] = _collect_subs(node, bmask, ctx)
        buckets[key] = b
    return {"buckets": _as_pairs(buckets),
            "fg_total": int((mask & live).sum()),
            "bg_total": int(live.sum())}


def _c_sampler(node, mask, ctx):
    """sampler (ref: bucket/sampler/SamplerAggregator): restrict sub-aggs
    to the shard's top `shard_size` docs by query score."""
    shard_size = int(node.params.get("shard_size", 100))
    bmask = mask
    if ctx.scores is not None and mask.sum() > shard_size:
        scores = np.where(mask, np.asarray(ctx.scores), -np.inf)
        top = np.argpartition(-scores, shard_size)[:shard_size]
        bmask = np.zeros_like(mask)
        bmask[top] = True
        bmask &= mask
    out = {"doc_count": int(bmask.sum())}
    if node.subs:
        out["subs"] = _collect_subs(node, bmask, ctx)
    return out


class _NestedCtx(ShardAggContext):
    """The child-row view of a nested agg: its segments are the path's
    child segments (segments without the path are skipped), each kept with
    its host ``parent`` column and its parent segment's first row in the
    parent context's concatenated row space."""

    def __init__(self, parent_ctx: ShardAggContext, path: str):
        self.exec_ctx = parent_ctx.exec_ctx
        # a filter under a nested agg evaluates in CHILD-row space: the
        # parent's execute_filter would mask the wrong rows
        self.execute_filter = self._child_filter
        self.scores = None
        self._blocks: list = []      # (child DeviceSegment, parent, base)
        base = 0
        for s in parent_ctx.reader.segments:
            blk = s.nested.get(path)
            if blk is not None:
                self._blocks.append((blk.child, np.asarray(
                    blk.column.parent, np.int64), base))
            base += s.padded_docs
        self._parent_rows = base
        self.reader = types.SimpleNamespace(
            segments=[c for c, _, _ in self._blocks])

    def _child_filter(self, query) -> np.ndarray:
        if self.exec_ctx is None:
            raise QueryParsingError(
                "filter aggregations under [nested] need the query "
                "execution context")
        masks = [segment_exec.match_mask(seg, self.exec_ctx, query)
                 .cpu().numpy() for seg in self.reader.segments]
        return np.concatenate(masks) if masks else np.zeros(0, bool)

    def child_mask(self, parent_mask: np.ndarray) -> np.ndarray:
        """Parent-space mask → the concatenated child-row mask (live
        children of matching parents)."""
        outs = []
        for seg, parents, base in self._blocks:
            m = np.zeros(seg.padded_docs, bool)
            idx = np.nonzero(parents >= 0)[0]
            m[idx] = parent_mask[base + parents[idx]]
            outs.append(m & seg.live.cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros(0, bool)

    def parent_mask(self, child_mask: np.ndarray) -> np.ndarray:
        """Child-row mask → parent-space mask (reverse_nested)."""
        out = np.zeros(self._parent_rows, bool)
        off = 0
        for seg, parents, base in self._blocks:
            n = seg.padded_docs
            idx = np.nonzero(child_mask[off:off + n] & (parents[:n] >= 0))[0]
            out[base + parents[idx]] = True
            off += n
        return out


def _c_nested(node, mask, ctx):
    """nested (ref: bucket/nested/NestedAggregator): the sub-aggregations
    run over the path's child rows of the matching parents; a
    reverse_nested directly under it maps those rows back to their
    parents."""
    nctx = _NestedCtx(ctx, node.params.get("path"))
    cmask = nctx.child_mask(mask)
    out = {"doc_count": int(cmask.sum())}
    if node.subs:
        out["subs"] = {}
        for sub in node.subs:
            if sub.type == "reverse_nested":
                pmask = nctx.parent_mask(cmask) & mask
                r = {"doc_count": int(pmask.sum())}
                if sub.subs:
                    r["subs"] = _collect_subs(sub, pmask, ctx)
                out["subs"][sub.name] = r
            else:
                out["subs"][sub.name] = collect(sub, cmask, nctx)
    return out


def _c_reverse_nested(node, mask, ctx):
    """reverse_nested anywhere but directly under a nested agg (which
    maps it itself): the identity bucket over the rows it is given, as in
    the JAX package."""
    out = {"doc_count": int(mask.sum())}
    if node.subs:
        out["subs"] = _collect_subs(node, mask, ctx)
    return out


def _c_geohash_grid(node, mask, ctx):
    """geohash_grid (ref: bucket/geogrid/): one bucket a cell of the
    matching points, the key encoded a row at a time on the host."""
    fname = node.params.get("field")
    length = precision_to_length(node.params.get("precision", 5))
    lat, lon, exists = ctx.geo_values(fname)
    m = mask & exists
    buckets: dict = {}
    for i in np.nonzero(m)[0]:
        key = geohash_encode(float(lat[i]), float(lon[i]), length)
        b = buckets.setdefault(key, {"doc_count": 0, "_rows": []})
        b["doc_count"] += 1
        b["_rows"].append(int(i))
    out_buckets = {}
    for key, b in buckets.items():
        entry = {"doc_count": b["doc_count"]}
        if node.subs:
            bmask = np.zeros_like(mask)
            bmask[b["_rows"]] = True
            entry["subs"] = _collect_subs(node, bmask, ctx)
        out_buckets[key] = entry
    return {"buckets": _as_pairs(out_buckets)}


def _haversine_km(lat1, lon1, lat2, lon2):
    r = 6371.0087714
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dphi = np.radians(lat2 - lat1)
    dl = np.radians(lon2 - lon1)
    a = np.sin(dphi / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return 2 * r * np.arcsin(np.sqrt(a))


def _c_geo_distance(node, mask, ctx):
    """geo_distance ranges from an origin (ref: bucket/range/geodistance/)."""
    fname = node.params.get("field")
    origin = node.params.get("origin")
    if isinstance(origin, str):
        olat, olon = (float(x) for x in origin.split(","))
    elif isinstance(origin, (list, tuple)):
        olon, olat = float(origin[0]), float(origin[1])
    else:
        olat, olon = float(origin["lat"]), float(origin["lon"])
    unit = str(node.params.get("unit", "m"))
    per_km = {"m": 1000.0, "km": 1.0, "mi": 0.621371, "yd": 1093.61}.get(
        unit, 1000.0)
    lat, lon, exists = ctx.geo_values(fname)
    dist = _haversine_km(olat, olon, lat, lon) * per_km
    m = mask & exists
    buckets = {}
    order = []
    for r in node.params.get("ranges", []):
        frm = float(r["from"]) if r.get("from") is not None else -np.inf
        to = float(r["to"]) if r.get("to") is not None else np.inf
        key = r.get("key") or (
            f"{'*' if frm == -np.inf else r.get('from')}-"
            f"{'*' if to == np.inf else r.get('to')}")
        bmask = m & (dist >= frm) & (dist < to)
        b = {"doc_count": int(bmask.sum()),
             "from": None if frm == -np.inf else frm,
             "to": None if to == np.inf else to}
        if node.subs:
            b["subs"] = _collect_subs(node, bmask, ctx)
        buckets[key] = b
        order.append(key)
    return {"buckets": _as_pairs(buckets), "keyed_order": order}


def _c_geo_bounds(node, mask, ctx):
    lat, lon, exists = ctx.geo_values(node.params.get("field"))
    m = mask & exists
    if not m.any():
        return {"count": 0}
    return {"count": int(m.sum()),
            "top": float(lat[m].max()), "bottom": float(lat[m].min()),
            "left": float(lon[m].min()), "right": float(lon[m].max())}


def _c_geo_centroid(node, mask, ctx):
    lat, lon, exists = ctx.geo_values(node.params.get("field"))
    m = mask & exists
    n = int(m.sum())
    if not n:
        return {"count": 0, "lat_sum": 0.0, "lon_sum": 0.0}
    return {"count": n, "lat_sum": float(lat[m].sum()),
            "lon_sum": float(lon[m].sum())}


def _c_percentile_ranks(node, mask, ctx):
    vals, exists = _field_numeric(node, ctx)
    m = mask & exists
    return {"values": vals[m].tolist(),
            "wanted": [float(v) for v in node.params.get("values", [])]}



class _AggDocValues:
    """`doc` binding for interpreted scripts (scripted_metric, script
    fields): doc['f'].value over one host segment's numeric / keyword
    columns, one doc at a time."""

    def __init__(self, seg):
        self.seg = seg
        self.doc = 0

    def __scriptlang_getitem__(self, field):
        return _AggFieldValue(self, field)

    __getitem__ = __scriptlang_getitem__


class _AggFieldValue:
    def __init__(self, owner: _AggDocValues, field: str):
        self.owner = owner
        self.field = field

    def _keyword_col(self):
        seg = self.owner.seg
        # analyzed strings expose doc values through their .keyword
        # subfield (the columnar analog of fielddata on text)
        return seg.keyword_fields.get(self.field) or \
            seg.keyword_fields.get(self.field + ".keyword")

    def _values(self) -> list:
        seg, i = self.owner.seg, self.owner.doc
        num = seg.numeric_fields.get(self.field)
        if num is not None:
            return [float(num.values[i])] if num.exists[i] else []
        kw = self._keyword_col()
        if kw is not None:
            return [kw.vocab[o] for o in kw.ords[i] if o >= 0]
        return []

    def __scriptlang_getattr__(self, name: str):
        vals = self._values()
        if name == "value":
            return vals[0] if vals else (
                "" if self._keyword_col() is not None else 0.0)
        if name == "values":
            return vals
        if name == "empty":
            return not vals
        from elasticsearch_tpu_torch.search.scriptlang import ScriptException
        raise ScriptException(f"no doc-value property [{name}]")

    def __scriptlang_method__(self, name: str, args):
        if name == "size":
            return len(self._values())
        if name == "isEmpty":
            return not self._values()
        if name == "getValue":
            return self.__scriptlang_getattr__("value")
        from elasticsearch_tpu_torch.search.scriptlang import ScriptException
        raise ScriptException(f"no doc-value method [{name}]")

    @property
    def value(self):
        return self.__scriptlang_getattr__("value")

    @property
    def values(self):
        return self.__scriptlang_getattr__("values")

    @property
    def empty(self):
        return self.__scriptlang_getattr__("empty")


def _wire_safe(obj):
    """Agg partials made transport-serializable (sets → lists, numpy →
    python) without changing what reduce_aggs consumes (the JAX package's
    ``search_action.wire_safe``)."""
    if isinstance(obj, dict):
        return {k: _wire_safe(v) for k, v in obj.items()}
    if isinstance(obj, (set, frozenset)):
        return sorted(str(x) for x in obj)
    if isinstance(obj, (list, tuple)):
        return [_wire_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _c_scripted_metric_interpreted(node, mask, ctx):
    """Full scripted_metric contract (ref: metrics/scripted/
    ScriptedMetricAggregator): init_script seeds `_agg`, map_script runs
    per matching doc with `doc` values, combine_script folds the shard
    state, reduce_script (reduce side) folds `_aggs`. Interpreted by
    GroovyLite on the host."""
    from elasticsearch_tpu_torch.search.script_engines import resolve_engine
    compile_fn = resolve_engine(node.params.get("lang"))
    params = dict(node.params.get("params", {}))
    agg: dict = {}
    bindings = {"_agg": agg, "params": params}
    init = node.params.get("init_script")
    if init:
        compile_fn(str(init)).run(dict(bindings))
    map_script = compile_fn(str(node.params["map_script"]))
    off = 0
    for s in ctx.reader.segments:
        n = s.padded_docs
        rows = np.nonzero(mask[off:off + n][:s.seg.num_docs])[0]
        if len(rows):
            dv = _AggDocValues(s.seg)
            b = {**bindings, "doc": dv}
            for r in rows:
                dv.doc = int(r)
                map_script.run(dict(b))
        off += n
    combine = node.params.get("combine_script")
    if combine:
        partial = compile_fn(str(combine)).run(dict(bindings))
    else:
        partial = agg
    return {"partial": _wire_safe(partial), "interpreted": True}


def _c_scripted_metric(node, mask, ctx):
    """scripted_metric (ref: metrics/scripted/): a map script the expression
    grammar takes runs through K12 over each segment's matching rows (its
    doc values the segment's f32 columns, as jnp rounds the reference's f64
    numpy columns); any init/combine/reduce phase — or a map script the
    grammar cannot compile — goes to the interpreted GroovyLite path."""
    from elasticsearch_tpu_torch.ops import script_ops
    from elasticsearch_tpu_torch.search.scripts import (
        compile_script, slot_columns)
    map_src = node.params.get("map_script")
    if map_src is None:
        raise QueryParsingError(
            "[scripted_metric] requires a map_script")
    if any(node.params.get(p) for p in
           ("init_script", "combine_script", "reduce_script")):
        return _c_scripted_metric_interpreted(node, mask, ctx)
    try:
        script = compile_script(str(map_src))
    except QueryParsingError:                # not an expression: interpret
        return _c_scripted_metric_interpreted(node, mask, ctx)
    prog = None
    values = []
    off = 0
    for s in ctx.reader.segments:
        n = s.padded_docs
        rows = np.nonzero(mask[off:off + n][:s.seg.num_docs])[0]
        off += n
        if not len(rows):
            continue
        if prog is None:
            prog = script.lower("host", node.params.get("params", {}))
            if prog.products:
                raise TypeError("a scripted_metric map script reads no "
                                "vector field")
        if prog.code is None:
            values.extend([float(np.asarray(prog.host.value))] * len(rows))
            continue
        dev = s.live.device
        out = script_ops.script_eval(
            prog.code, slot_columns(prog, s, torch.from_numpy(rows).to(dev)),
            None, [], None,
            torch.zeros((0, len(rows)), dtype=torch.int32, device=dev),
            1, len(rows))
        values.extend(float(v) for v in out[0].cpu().tolist())
    return {"values": values}


_COLLECTORS = {
    "scripted_metric": _c_scripted_metric,
    "min": _c_metric, "max": _c_metric, "sum": _c_metric, "avg": _c_metric,
    "stats": _c_metric, "extended_stats": _c_metric,
    "sampler": _c_sampler, "percentile_ranks": _c_percentile_ranks,
    "value_count": _c_value_count, "cardinality": _c_cardinality,
    "percentiles": _c_percentiles, "top_hits": _c_top_hits,
    "terms": _c_terms, "histogram": _c_histogram,
    "date_histogram": _c_date_histogram,
    "range": _c_range, "date_range": lambda n, m, c: _c_range(n, m, c, True),
    "filter": _c_filter, "filters": _c_filters,
    "global": _c_global, "missing": _c_missing,
    "significant_terms": _c_significant_terms,
    "geohash_grid": _c_geohash_grid, "geo_distance": _c_geo_distance,
    "geo_bounds": _c_geo_bounds, "geo_centroid": _c_geo_centroid,
    "nested": _c_nested, "reverse_nested": _c_reverse_nested,
}

# ---------------------------------------------------------------------------
# reduce phase (coordinator; InternalAggregations.reduce analog)
# ---------------------------------------------------------------------------

def reduce_aggs(nodes: list[AggNode], partials_per_shard: list[dict],
                device=None) -> dict:
    """Merge the shards' partials (InternalAggregations.reduce). ``device``
    is where bucket_script / bucket_selector expressions run (CUDA when
    None)."""
    out = {}
    siblings = [n for n in nodes if n.type not in PIPELINE_AGGS]
    pipelines = [n for n in nodes if n.type in PIPELINE_AGGS]
    for node in siblings:
        shard_parts = [p[node.name] for p in partials_per_shard if node.name in p]
        out[node.name] = _reduce_node(node, shard_parts, device)
    # sibling pipelines (avg/max/min/sum_bucket) consume the reduced output
    # of a multi-bucket sibling via buckets_path "agg>metric"
    for node in pipelines:
        path = node.params.get("buckets_path", "")
        head, _, rest = path.partition(">")
        buckets = out.get(head, {}).get("buckets", [])
        values = [v for v in (_bucket_path_value(b, rest or "_count")
                              for b in buckets) if v is not None]
        if node.type == "avg_bucket":
            value = sum(values) / len(values) if values else None
        elif node.type == "sum_bucket":
            value = sum(values) if values else 0.0
        elif node.type == "max_bucket":
            value = max(values) if values else None
        elif node.type == "min_bucket":
            value = min(values) if values else None
        else:
            continue  # cumulative_sum/derivative are parent pipelines
        out[node.name] = {"value": value}
    return out


def _merge_metric(parts: list[dict]) -> dict:
    count = sum(p["count"] for p in parts)
    s = sum(p["sum"] for p in parts)
    mins = [p["min"] for p in parts if p["min"] is not None]
    maxs = [p["max"] for p in parts if p["max"] is not None]
    return {"count": count, "sum": s,
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None,
            "sum_sq": sum(p.get("sum_sq", 0.0) for p in parts)}


def _as_pairs(buckets: dict) -> list:
    """Bucket map → [key, bucket] pairs. Shard partials cross the wire,
    whose codec stringifies dict KEYS (StreamOutput.write_value); carrying
    keys as list values keeps numeric histogram/terms keys typed."""
    return [[k, b] for k, b in buckets.items()]


def _bucket_dict(p: dict) -> dict:
    """Partial's buckets in either form (pairs from a shard, dict from
    older in-memory paths) → key→bucket dict with typed keys."""
    b = p.get("buckets", {})
    return dict(b) if isinstance(b, dict) else {k: v for k, v in b}


def _merge_buckets(node: AggNode, parts: list[dict], device=None) -> dict:
    pdicts = [_bucket_dict(p) for p in parts]
    merged: dict = {}
    for pd in pdicts:
        for key, b in pd.items():
            cur = merged.setdefault(key, {"doc_count": 0, "_parts": []})
            cur["doc_count"] += b["doc_count"]
            for extra in ("from", "to"):
                if extra in b:
                    cur[extra] = b[extra]
            if "subs" in b:
                cur["_parts"].append(b["subs"])
    for key, b in merged.items():
        if b.pop("_parts", None) or node.subs:
            parts_list = [pd[key].get("subs", {})
                          for pd in pdicts if key in pd]
            b["aggs"] = reduce_aggs(node.subs, [pl for pl in parts_list if pl],
                                    device)
    return merged


def _bucket_path_value(bucket: dict, path: str):
    """Resolve a buckets_path within a rendered bucket: '_count',
    'sub_agg', 'sub_agg.metric', or 'sub>leaf' (reference:
    core/search/aggregations/pipeline/BucketHelpers.java)."""
    if path == "_count":
        return bucket.get("doc_count")
    node: Any = bucket
    for part in path.replace(">", ".").split("."):
        if not isinstance(node, dict):
            return None
        node = node.get(part)
    if isinstance(node, dict):
        return node.get("value", node.get("avg"))
    return node


def _moving_avg(values: list, params: dict) -> list:
    """moving_avg models (ref: pipeline/movavg/models/): simple, linear,
    ewma, holt, holt_winters (additive, no seasonality shortcut)."""
    window = int(params.get("window", 5))
    model = str(params.get("model", "simple"))
    settings = params.get("settings", {}) or {}
    out: list = []
    for i in range(len(values)):
        win = [v for v in values[max(0, i - window + 1): i + 1]
               if v is not None]
        if not win:
            out.append(None)
            continue
        if model == "linear":
            ws = list(range(1, len(win) + 1))
            out.append(sum(w * v for w, v in zip(ws, win)) / sum(ws))
        elif model == "ewma":
            alpha = float(settings.get("alpha", 0.3))
            acc = win[0]
            for v in win[1:]:
                acc = alpha * v + (1 - alpha) * acc
            out.append(acc)
        elif model in ("holt", "holt_winters"):
            alpha = float(settings.get("alpha", 0.3))
            beta = float(settings.get("beta", 0.1))
            level, trend = win[0], 0.0
            for v in win[1:]:
                last = level
                level = alpha * v + (1 - alpha) * (level + trend)
                trend = beta * (level - last) + (1 - beta) * trend
            out.append(level + trend)
        else:
            out.append(sum(win) / len(win))
    return out


_SKIP = object()


def _pipe_values(src: str, rows: list[dict], device) -> list:
    """bucket_script / bucket_selector: the expression over each bucket's
    buckets_path values (bound as bare names) → one value a bucket, or
    ``_SKIP`` where the reference's per-bucket evaluation raises. The Python
    arithmetic of each bucket's values runs on the host; the rest is one K12
    launch over every bucket whose values have the same Python kinds."""
    from elasticsearch_tpu_torch.common.device import resolve_device
    from elasticsearch_tpu_torch.ops import script_ops
    from elasticsearch_tpu_torch.search.scripts import compile_script
    if not rows:                         # the reference compiles nothing
        return []
    script = compile_script(str(src))
    out = [_SKIP] * len(rows)
    todo = list(range(len(rows)))
    while todo:
        rep, todo = todo[0], todo[1:]
        try:
            prog = script.lower("pipeline", {}, rows[rep])
        except QueryParsingError:
            raise
        except Exception:                # noqa: BLE001 — bucket skipped
            continue
        if prog.code is None:
            fn = prog.host.fn or (lambda vs, _v=prog.host.value: _v)
            for i in [rep] + todo:
                try:
                    out[i] = fn(rows[i])
                except Exception:        # noqa: BLE001 — bucket skipped
                    pass
            return out
        kinds = prog.row_kinds(rows[rep])
        group, rest = [rep], []
        for i in todo:
            try:
                same = prog.row_kinds(rows[i]) == kinds
                if same:
                    prog.row_words([rows[i]])
            except Exception:            # noqa: BLE001 — bucket skipped
                continue
            (group if same else rest).append(i)
        todo = rest
        dev = resolve_device(device)
        words = torch.from_numpy(prog.row_words([rows[i] for i in group]))
        vals = script_ops.script_eval(prog.code, [], None, [], None,
                                      words.to(dev), 1, len(group))
        for i, v in zip(group, vals[0].cpu().tolist()):
            out[i] = v
    return out


def _pipe_script(pipe: AggNode) -> str:
    script = pipe.params.get("script", "")
    if isinstance(script, dict):
        script = script.get("inline", script.get("source", ""))
    return str(script)


def _render_pipeline(node: AggNode, buckets: list[dict], device=None) -> None:
    """Parent pipelines rendered into (or filtering) the buckets of the
    enclosing multi-bucket agg (ref: pipeline/*)."""
    for pipe in node.pipelines:
        if pipe.type in ("bucket_selector", "bucket_script"):
            paths = pipe.params.get("buckets_path", {})
            ready, rows = [], []
            for b in buckets:
                variables = {k: _bucket_path_value(b, p)
                             for k, p in paths.items()}
                if any(v is None for v in variables.values()):
                    continue
                ready.append(b)
                rows.append(variables)
            values = _pipe_values(_pipe_script(pipe), rows, device)
            if pipe.type == "bucket_selector":
                buckets[:] = [b for b, v in zip(ready, values)
                              if v is not _SKIP and v]
                continue
            for b, v in zip(ready, values):
                try:
                    if v is not _SKIP:
                        b[pipe.name] = {"value": float(v)}
                except Exception:        # noqa: BLE001 — bucket skipped
                    continue
            continue
        if pipe.type not in ("cumulative_sum", "derivative", "moving_avg",
                             "serial_diff"):
            continue
        path = pipe.params.get("buckets_path", "_count")
        values = [_bucket_path_value(b, path) for b in buckets]
        if pipe.type == "cumulative_sum":
            acc = 0.0
            for b, v in zip(buckets, values):
                acc += (v or 0.0)
                b[pipe.name] = {"value": acc}
        elif pipe.type == "derivative":
            prev = None
            for b, v in zip(buckets, values):
                if prev is not None and v is not None:
                    b[pipe.name] = {"value": v - prev}
                prev = v
        elif pipe.type == "moving_avg":
            for b, v in zip(buckets, _moving_avg(values, pipe.params)):
                if v is not None:
                    b[pipe.name] = {"value": v}
        elif pipe.type == "serial_diff":
            lag = int(pipe.params.get("lag", 1))
            for i, b in enumerate(buckets):
                if i >= lag and values[i] is not None \
                        and values[i - lag] is not None:
                    b[pipe.name] = {"value": values[i] - values[i - lag]}


def _reduce_node(node: AggNode, parts: list[dict], device=None) -> dict:
    t = node.type
    if t in ("min", "max", "sum", "avg"):
        m = _merge_metric(parts)
        if t == "avg":
            value = m["sum"] / m["count"] if m["count"] else None
        elif t == "sum":
            value = m["sum"]
        else:
            value = m[t]
        return {"value": value}
    if t == "stats" or t == "extended_stats":
        m = _merge_metric(parts)
        avg = m["sum"] / m["count"] if m["count"] else None
        out = {"count": m["count"], "min": m["min"], "max": m["max"],
               "sum": m["sum"], "avg": avg}
        if t == "extended_stats":
            if m["count"]:
                var = max(m["sum_sq"] / m["count"] - (avg or 0.0) ** 2, 0.0)
            else:
                var = None
            out.update(sum_of_squares=m["sum_sq"], variance=var,
                       std_deviation=math.sqrt(var) if var is not None else None)
        return out
    if t == "value_count":
        return {"value": sum(p["count"] for p in parts)}
    if t == "cardinality":
        values: set = set()
        for p in parts:
            values.update(map(str, p["values"]))
        return {"value": len(values)}
    if t == "percentiles":
        allv = np.sort(np.concatenate([np.asarray(p["values"], np.float64)
                                       for p in parts])) if parts else np.array([])
        percents = parts[0]["percents"] if parts else []
        vals = {}
        for pc in percents:
            vals[f"{float(pc)}"] = (float(np.percentile(allv, pc))
                                    if allv.size else None)
        return {"values": vals}
    if t == "top_hits":
        size = parts[0]["size"] if parts else 3
        hits = [h for p in parts for h in p["hits"]]
        hits.sort(key=lambda h: -(h.get("_score") or 0.0))
        return {"hits": {"total": sum(p["total"] for p in parts),
                         "hits": hits[:size]}}
    if t in ("filter", "global", "missing"):
        out = {"doc_count": sum(p["doc_count"] for p in parts)}
        sub_parts = [p["subs"] for p in parts if "subs" in p]
        if node.subs:
            out.update(reduce_aggs(node.subs, sub_parts, device))
        return out
    if t == "filters":
        merged = _merge_buckets(node, parts, device)
        return {"buckets": {k: _final_bucket(b) for k, b in merged.items()}}
    if t == "terms":
        merged = _merge_buckets(node, parts, device)
        size = int(node.params.get("size", 10) or 0) or len(merged)
        order = node.params.get("order", {"_count": "desc"})
        (okey, odir), = order.items() if isinstance(order, dict) else \
            (("_count", "desc"),)
        rev = str(odir).lower() == "desc"
        def sort_key(item):
            key, b = item
            if okey in ("_count",):
                return b["doc_count"]
            if okey in ("_term", "_key"):
                return key
            agg = b.get("aggs", {}).get(okey, {})
            return agg.get("value") or 0
        items = sorted(merged.items(), key=sort_key, reverse=rev)
        if okey == "_count":  # secondary order: term asc (ES tie-break)
            items = sorted(items, key=lambda kv: str(kv[0]))
            items = sorted(items, key=lambda kv: kv[1]["doc_count"],
                           reverse=rev)
        buckets = [{"key": k, **_final_bucket(b)} for k, b in items[:size]]
        sum_other = sum(b["doc_count"] for _, b in items[size:])
        _render_pipeline(node, buckets, device)
        return {"buckets": buckets, "sum_other_doc_count": sum_other,
                "doc_count_error_upper_bound": 0}
    if t in ("histogram", "date_histogram"):
        merged = _merge_buckets(node, parts, device)
        min_dc = int(node.params.get("min_doc_count",
                                     1 if t == "date_histogram" else 0))
        keys = sorted(merged)
        buckets = [{"key": k, **_final_bucket(merged[k])} for k in keys
                   if merged[k]["doc_count"] >= max(min_dc, 1) or min_dc == 0]
        fmt = node.params.get("format")
        if fmt and t == "histogram":
            for b in buckets:
                b["key_as_string"] = _java_decimal_format(b["key"], fmt)
        _render_pipeline(node, buckets, device)
        return {"buckets": buckets}
    if t in ("range", "date_range"):
        merged = _merge_buckets(node, parts, device)
        order = parts[0].get("keyed_order", list(merged)) if parts else []
        buckets = [{"key": k, **_final_bucket(merged[k])} for k in order
                   if k in merged]
        return {"buckets": buckets}
    if t in ("sampler", "nested", "reverse_nested"):
        total = sum(p.get("doc_count", 0) for p in parts)
        out = {"doc_count": total}
        if node.subs:
            sub_parts = [p["subs"] for p in parts if "subs" in p]
            if sub_parts:
                out.update(reduce_aggs(node.subs, sub_parts, device))
        return out
    if t in ("geohash_grid", "geo_distance"):
        merged = _merge_buckets(node, parts, device)
        if t == "geo_distance":
            order = parts[0].get("keyed_order", list(merged)) \
                if parts else []
            buckets = [{"key": k, **_final_bucket(merged[k])}
                       for k in order if k in merged]
        else:
            size = int(node.params.get("size", 10000) or 0) or len(merged)
            items = sorted(merged.items(),
                           key=lambda kv: (-kv[1]["doc_count"], kv[0]))
            buckets = [{"key": k, **_final_bucket(b)}
                       for k, b in items[:size]]
        _render_pipeline(node, buckets, device)
        return {"buckets": buckets}
    if t == "geo_bounds":
        alive = [p for p in parts if p.get("count")]
        if not alive:
            return {"bounds": None}
        return {"bounds": {
            "top_left": {"lat": max(p["top"] for p in alive),
                         "lon": min(p["left"] for p in alive)},
            "bottom_right": {"lat": min(p["bottom"] for p in alive),
                             "lon": max(p["right"] for p in alive)}}}
    if t == "geo_centroid":
        n = sum(p.get("count", 0) for p in parts)
        if not n:
            return {"count": 0}
        return {"count": n,
                "location": {
                    "lat": sum(p.get("lat_sum", 0.0) for p in parts) / n,
                    "lon": sum(p.get("lon_sum", 0.0) for p in parts) / n}}
    if t == "percentile_ranks":
        allv = np.concatenate([np.asarray(p["values"], np.float64)
                               for p in parts]) if parts else \
            np.zeros(0)
        wanted = parts[0].get("wanted", []) if parts else []
        vals = {}
        for w in wanted:
            vals[f"{float(w)}"] = (
                float(100.0 * (allv <= w).sum() / allv.size)
                if allv.size else None)
        return {"values": vals}
    if t == "scripted_metric":
        if any(p.get("interpreted") for p in parts):
            # full contract: reduce_script folds the per-shard partials
            # (`_aggs`); without one the partials list IS the value
            # (ScriptedMetricAggregator doReduce)
            from elasticsearch_tpu_torch.search.script_engines import (
                resolve_engine)
            compile_fn = resolve_engine(node.params.get("lang"))
            aggs_list = [p.get("partial") for p in parts]
            reduce_src = node.params.get("reduce_script")
            if reduce_src:
                value = compile_fn(str(reduce_src)).run(
                    {"_aggs": aggs_list,
                     "params": dict(node.params.get("params", {}))})
            else:
                value = aggs_list
            return {"value": value}
        allv = [v for p in parts for v in p.get("values", [])]
        # expression path reduces by summing map values
        return {"value": float(np.sum(allv)) if allv else 0.0}
    if t == "significant_terms":
        fg_total = sum(p.get("fg_total", 0) for p in parts)
        bg_total = sum(p.get("bg_total", 0) for p in parts)
        counts: dict = {}
        sub_parts: dict = {}
        for p in parts:
            for key, b in _bucket_dict(p).items():
                cur = counts.setdefault(key, {"doc_count": 0, "bg_count": 0})
                cur["doc_count"] += b["doc_count"]
                cur["bg_count"] += b.get("bg_count", 0)
                if "subs" in b:
                    sub_parts.setdefault(key, []).append(b["subs"])
        min_dc = int(node.params.get("min_doc_count", 3))
        size = int(node.params.get("size", 10) or 0) or len(counts)
        scored = []
        for key, b in counts.items():
            if b["doc_count"] < min_dc:
                continue
            fg_pct = b["doc_count"] / max(fg_total, 1)
            bg_pct = b["bg_count"] / max(bg_total, 1)
            # JLH (SignificanceHeuristic default): 0 unless the term is
            # MORE frequent in the foreground than in the background
            score = 0.0 if fg_pct <= bg_pct or bg_pct == 0 else \
                (fg_pct - bg_pct) * (fg_pct / bg_pct)
            if score > 0:
                scored.append((score, key, b))
        scored.sort(key=lambda x: (-x[0], str(x[1])))
        buckets = []
        for s, k, b in scored[:size]:
            bucket = {"key": k, "doc_count": b["doc_count"],
                      "score": s, "bg_count": b["bg_count"]}
            if node.subs and k in sub_parts:
                bucket.update(reduce_aggs(node.subs, sub_parts[k], device))
            buckets.append(bucket)
        return {"doc_count": fg_total, "buckets": buckets}
    raise QueryParsingError(f"cannot reduce aggregation type [{node.type}]")


def _final_bucket(b: dict) -> dict:
    out = {"doc_count": b["doc_count"]}
    for extra in ("from", "to"):
        if extra in b and b[extra] is not None:
            out[extra] = b[extra]
    if "aggs" in b:
        out.update(b["aggs"])
    return out
