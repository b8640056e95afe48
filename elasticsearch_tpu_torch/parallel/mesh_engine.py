"""The engine's collective query plane — every shard of an index in one
device pass.

Counterpart of ``elasticsearch_tpu/parallel/mesh_engine.py``. Where the
fan-out runs a query phase per shard and merges their pages on the host
(``search/controller.py``), this module runs the SAME engine artifacts —
the segments real Engines built, their live masks, the query-DSL resolve
and emit closures of ``search/execute.py`` — over all shards at once and
keeps every intermediate on the device until the page is rendered:

* every engine shard's segments are padded to common per-slot layouts
  (``_SlotLayout``) and kept on the device as per-(shard, slot) blocks
  (``_DeviceBlockCache``); a mesh rank holds a contiguous block of ``spd =
  n_shards // mesh shard axis`` shards — on one card all of them;
* term statistics are aggregated on the host over every shard (the DFS
  round, ``search/dfs.py``) when ``global_stats`` is set;
* per (shard, slot) the batch's plan runs once (``segment_exec._plan`` /
  ``_build``: kernels K1, K3 and the torch emits) and its top-k (K2) or, in
  sort mode, its arrays come back as device tensors; the metric, terms and
  histogram partials of the batch's agg mask take one row-batched launch a
  (shard, slot, lane) (K9, K8);
* per shard one selection — K20 ``sort_select`` over the sort keys (the
  ``search_after`` cursor folded in) or K2 in score order — then a local
  merge of the rank's shards, the group's ``all_gather`` of candidates,
  counts and terms lanes and ``psum`` of sums and histograms
  (``parallel/mesh.Mesh``), and a merge of the gathered candidates;
* the page, the sort values and the aggregations render on the host,
  buckets through the coordinator's ``reduce_aggs``.

Eligible request shapes, and the ``QueryParsingError`` every other shape
raises, are the reference's: score order (with a bare ``[score]`` cursor),
numeric and keyword field sorts (double-double keys; keyword ordinals lifted
to ranks in the shards' union vocabulary), ``search_after`` on a field sort,
``post_filter``, ``min_score``, and min / max / sum / avg / value_count /
stats, terms and histogram aggregations. Global doc ids number as the
reference's: ``(shard · spd + local) · shard_stride + slot_base + row``, so
ids, ties and :meth:`MeshEngineSearcher.resolve` compare directly.

Caching. Per-segment device blocks live in a module-level cache keyed by
(engine uuid, block uid, slot-layout signature, device): a refresh uploads
only newly built segments and changed live masks (a delete-only refresh
ships zero column bytes), counted in ``data_layer`` and the
``stats_sinks``. The JAX package's shape-keyed program cache
(``mesh_program_{hits,misses}``) has no counterpart: an eager torch
program compiles nothing, so nothing is cached per shape and no such
counter is kept. The breaker accounting (``breaker_service``) is not ported:
only None is accepted.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
import types
from collections import OrderedDict
from dataclasses import dataclass, replace as dc_replace

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import (
    NotPortedError, QueryParsingError)
from elasticsearch_tpu_torch.index.device_reader import (
    DeviceKeywordField, DeviceNumericField, DeviceSegment, DeviceTextField,
    TextFieldStats, dd_split, pads_trail)
from elasticsearch_tpu_torch.index.segment import (
    KeywordFieldColumn, Segment, TextFieldColumn)
from elasticsearch_tpu_torch.ops import aggs_ops, topk as topk_ops
from elasticsearch_tpu_torch.ops.phrase import token_extent
from elasticsearch_tpu_torch.ops.similarity import BM25Params
from elasticsearch_tpu_torch.parallel.mesh import Mesh
from elasticsearch_tpu_torch.search import dfs as dfs_mod
from elasticsearch_tpu_torch.search.batching import pow2_bucket
from elasticsearch_tpu_torch.search.execute import (
    ExecutionContext, stack_consts)
from elasticsearch_tpu_torch.search.phase import (
    _is_score_order, _sort_value_out, parse_search_request)
from elasticsearch_tpu_torch.search.segment_exec import (
    _build, _fetch_lazy, _plan)

_FLAGS = {
    "min_score": False, "_min_score": 0.0,
    "search_after": False, "_sa_score": 0.0, "_sa_doc": -1,
    "_doc_base": 0,
}

#: metric aggregations the plane reduces on the device: per-shard partials
#: from the query mask and numeric columns, then psum / an all_gather'd
#: lexicographic extremum over the shard axis
_MESH_METRICS = ("min", "max", "sum", "avg", "value_count", "stats")

#: histogram bucket-window cap — the whole field range must bucketize into
#: this many slots for the static-base count
_MAX_HISTO_BUCKETS = 4096

#: terms agg budget: padded_vocab × batch × shards cells gathered per agg
_MAX_TERMS_CELLS = 1 << 26

#: keyword-sort union ranks ride the merge as f32 — exact only below 2^24
_MAX_KW_SORT_VOCAB = 1 << 24

# ---------------------------------------------------------------------------
# The BLOCK layer: per-segment device-resident columns.
#
# A module-level cache of per-(shard, slot) device blocks keyed by (engine
# uuid, block uid, slot-layout signature, device). A refresh that adds one
# segment uploads ONLY that segment's padded columns (plus an empty filler
# for shards that don't reach the new slot); every other block is already
# on the device. A delete-only refresh re-uploads just the changed live
# masks (zero column bytes). Blocks are released on supersession (merge
# drops the source segments from the reader → prune), LRU eviction, or
# engine close. A text field's position matrix goes to the device only when
# a plan reads it (_TemplateReader.fetch_tokens), into the cached block.
# ---------------------------------------------------------------------------
_BLOCK_CACHE_CAP = 512
#: block_uid sentinel for the shared empty-filler block of a slot layout
#: (shards whose view has fewer segments than n_slots)
_EMPTY_UID = 0


@dataclass
class PlaneSegment(DeviceSegment):
    """One (shard, slot) block: a DeviceSegment whose tensors are padded to
    the slot layout's ``np_docs`` rows (the host segment may have fewer)."""
    np_docs: int = 0

    @property
    def padded_docs(self) -> int:
        return self.np_docs


def template_bytes(tpl: DeviceSegment) -> int:
    """Bytes of one block's tensors on its device (lazy position matrices
    included once uploaded)."""
    tensors = [tpl.live]
    for c in tpl.text.values():
        tensors += [c.uterms, c.utf, c.doc_len]
        if c.tokens is not None:
            tensors += [c.tokens, c.tok_extent]
    tensors += [c.ords for c in tpl.keyword.values()]
    for c in tpl.numeric.values():
        tensors += [c.hi, c.lo, c.exists]
    return sum(t.numel() * t.element_size() for t in tensors)


class _Block:
    __slots__ = ("key", "template", "live_np", "col_bytes", "extrema")

    def __init__(self, key, template, live_np, col_bytes, extrema):
        self.key = key
        self.template = template        # PlaneSegment (device tensors)
        self.live_np = live_np          # padded live mask (host copy)
        self.col_bytes = col_bytes      # uploaded column bytes (excl. live)
        self.extrema = extrema          # numeric field → (min, max)


class _DeviceBlockCache:
    def __init__(self, cap: int = _BLOCK_CACHE_CAP):
        self.cap = cap
        self._lru: "OrderedDict[tuple, _Block]" = OrderedDict()
        self._lock = threading.Lock()

    def fetch(self, engine_uuid: str, lay_sig: tuple, lay: "_SlotLayout",
              seg, live, doc_base: int, device: torch.device):
        """→ (template, extrema, col_up, mask_up, reused): the padded
        per-segment device block, built and uploaded on a miss, reused on a
        hit. A hit with a changed live mask re-uploads ONLY the mask (the
        delete path's zero-column-byte refresh). Byte counts are actual
        host→device transfer; ``reused`` is the resident column bytes a
        rebuild did not re-ship."""
        uid = seg.block_uid if seg is not None else _EMPTY_UID
        key = (engine_uuid, uid, lay_sig, str(device))
        live_np = _pad1(live, lay.np_docs, False) if live is not None \
            else None
        with self._lock:
            blk = self._lru.get(key)
            if blk is not None:
                self._lru.move_to_end(key)
                mask_up = 0
                if live_np is not None and \
                        not np.array_equal(blk.live_np, live_np):
                    # mask-delta refresh: re-ship ONLY the live rows
                    blk.template = dc_replace(
                        blk.template, live=torch.from_numpy(live_np).to(
                            device))
                    blk.live_np = live_np
                    mask_up = int(live_np.nbytes)
                tpl = blk.template
                if tpl.doc_base != doc_base:
                    tpl = dc_replace(tpl, doc_base=doc_base)
                return tpl, blk.extrema, 0, mask_up, blk.col_bytes
        template = _build_template(lay, seg, live, doc_base, device)
        mask_bytes = int(template.live.numel())
        col_bytes = template_bytes(template) - mask_bytes
        extrema = _segment_extrema(seg) if seg is not None else {}
        blk = _Block(key, template, _pad1(live, lay.np_docs, False)
                     if live is not None else np.zeros(lay.np_docs, bool),
                     col_bytes, extrema)
        with self._lock:
            cur = self._lru.get(key)
            if cur is not None:
                # raced duplicate build: keep the incumbent (our upload
                # still happened, so it is counted)
                self._lru.move_to_end(key)
                blk = cur
            else:
                self._lru[key] = blk
                while len(self._lru) > self.cap:
                    self._lru.popitem(last=False)
        return blk.template, blk.extrema, col_bytes, mask_bytes, 0

    def prune(self, engine_uuid: str, live_uids: set) -> int:
        """Release blocks of this engine whose segment left the reader view
        (merged away / superseded). Empty fillers and layout variants of
        LIVE segments stay (bounded by the LRU cap). → bytes released."""
        with self._lock:
            dead = [k for k in self._lru
                    if k[0] == engine_uuid and k[1] != _EMPTY_UID
                    and k[1] not in live_uids]
            gone = [self._lru.pop(k) for k in dead]
        return sum(template_bytes(b.template) for b in gone)

    def release_engine(self, engine_uuid: str) -> None:
        """Engine close: drop every block (incl. empty fillers) of this
        engine incarnation."""
        with self._lock:
            for k in [k for k in self._lru if k[0] == engine_uuid]:
                self._lru.pop(k)

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()

    def evict_cold(self, fraction: float = 0.5) -> int:
        """Drop the least-recently-used ``fraction`` of cached blocks (at
        least one). Blocks a serving searcher still holds stay alive through
        its references. → bytes released from the cache."""
        with self._lock:
            n = int(len(self._lru) * fraction) if self._lru else 0
            n = max(n, 1) if self._lru else 0
            gone = [self._lru.popitem(last=False)[1] for _ in range(n)]
        return sum(template_bytes(b.template) for b in gone)

    def keys(self) -> list:
        with self._lock:
            return list(self._lru)

    def stats(self) -> dict:
        with self._lock:
            blocks = list(self._lru.values())
        return {"entries": len(blocks),
                "resident_bytes": sum(template_bytes(b.template)
                                      for b in blocks),
                "charged_bytes": 0}


_block_cache = _DeviceBlockCache()


def clear_block_cache() -> None:
    _block_cache.clear()


def block_cache_stats() -> dict:
    return _block_cache.stats()


def block_cache_keys() -> list:
    """(engine uuid, block uid, layout sig, device) of every resident
    block."""
    return _block_cache.keys()


def evict_cold_blocks(fraction: float = 0.5) -> int:
    """Evict the coldest ``fraction`` of device blocks → bytes released."""
    return _block_cache.evict_cold(fraction)


def hook_engine_block_release(engine) -> None:
    """Install the engine-close listener that drops every cached device
    block of this engine incarnation."""
    if not getattr(engine, "_block_cache_hooked", False):
        hook = _EngineBlocksRelease(engine.engine_uuid)
        engine.__dict__.setdefault("_close_listeners",
                                   []).append(hook.release)
        engine._block_cache_hooked = True


class _EngineBlocksRelease:
    """Engine close listener (a bound method, so a listener sweep that
    prunes spent one-shots leaves it in place)."""

    __slots__ = ("engine_uuid",)

    def __init__(self, engine_uuid: str):
        self.engine_uuid = engine_uuid

    def release(self) -> None:
        _block_cache.release_engine(self.engine_uuid)


def _segment_extrema(seg) -> dict:
    """Exact per-segment f64 extrema per numeric field (exists-masked,
    live-independent — deletes never widen a bucket window)."""
    out: dict[str, tuple[float, float]] = {}
    for name, col in seg.numeric_fields.items():
        vals = col.values[col.exists[:len(col.values)]] \
            if col.exists is not None else col.values
        if vals.size == 0:
            continue
        out[name] = (float(np.min(vals)), float(np.max(vals)))
    return out


def _gather_payload(payload: dict, idx) -> dict:
    return {name: torch.gather(arr, 1, idx) for name, arr in payload.items()}


def _dd_fill(v: float) -> tuple[float, float]:
    """dd_split for fill / cursor scalars → plain floats (the residual of a
    non-finite value is 0)."""
    hi, lo = dd_split(np.float64(v))
    return float(hi), float(lo)


@dataclass(frozen=True)
class _SortSpec:
    """One static sort key: _score, a numeric doc-values field, or a
    keyword ordinal column lifted to union ranks."""
    field: str                 # "" for _score
    order: str                 # "asc" | "desc"
    fill: float                # missing fill (±inf, numeric missing, rank)
    kind: str = "numeric"      # "score" | "numeric" | "keyword"

    @property
    def is_score(self) -> bool:
        return self.kind == "score"


def _mesh_sort_spec(reqs, layouts) -> tuple:
    """Validate + extract a batch-uniform field-sort spec → tuple of
    _SortSpec; raises QueryParsingError for sorts the plane does not run
    (analyzed-text and script sorts, _doc, a custom keyword missing, specs
    that differ within the batch)."""
    raw0 = reqs[0].sort
    if any(req.sort != raw0 for req in reqs):
        raise QueryParsingError(
            "mesh engine plane requires one sort spec per batch")
    specs = []
    for spec in raw0:
        (fname, opts), = spec.items()
        order = opts.get("order", "asc")
        missing = opts.get("missing", "_last")
        if fname == "_doc":
            raise QueryParsingError(
                "mesh engine plane cannot sort by _doc (doc-id numbering "
                "is plane-local) — use the RPC fan-out path")
        if fname == "_score":
            specs.append(_SortSpec("", order, 0.0, "score"))
            continue
        in_text = any(fname in lay.text for lay in layouts)
        in_kw = any(fname in lay.keyword for lay in layouts)
        in_num = any(fname in lay.numeric for lay in layouts)
        if in_text:
            raise QueryParsingError(
                f"mesh engine plane cannot sort analyzed text "
                f"[{fname}] — use the RPC fan-out path")
        if in_kw and in_num:
            raise QueryParsingError(
                f"sort field [{fname}] maps to both numeric and keyword "
                f"columns — use the RPC fan-out path")
        if in_kw:
            if missing not in ("_last", "_first"):
                raise QueryParsingError(
                    f"keyword sort [{fname}] with a custom missing term "
                    f"stays host-side — use the RPC fan-out path")
            fill = math.inf if (missing == "_last") == (order == "asc") \
                else -math.inf
            specs.append(_SortSpec(fname, order, fill, "keyword"))
            continue
        if missing in ("_last", "_first"):
            fill = math.inf if (missing == "_last") == (order == "asc") \
                else -math.inf
        else:
            try:
                fill = float(missing)
            except (TypeError, ValueError):
                raise QueryParsingError(
                    f"sort [{fname}] has a non-numeric missing "
                    f"substitute — use the RPC fan-out path") from None
        specs.append(_SortSpec(fname, order, fill))
    return tuple(specs)


def _mesh_agg_plan(reqs, layouts, field_extrema) -> tuple:
    """Validate + extract batch-uniform agg lanes → (metric_spec,
    bucket_specs): metric_spec the (name, kind, field) tuple of the psum
    lane; bucket_specs ("terms", name, resolved_field) / ("histogram", name,
    field, interval, base, n_buckets) entries. Raises QueryParsingError for
    aggs the plane does not reduce (sub-aggs, scripts, other bucket kinds,
    specs that differ within the batch)."""
    metric_sig, bucket_sig = [], []
    for req in reqs:
        met, buck = [], []
        for node in req.aggs:
            if node.subs or node.pipelines:
                raise QueryParsingError(
                    f"mesh engine plane cannot reduce sub/pipeline aggs "
                    f"under [{node.name}] in-program — use the RPC "
                    f"fan-out path")
            if node.type in _MESH_METRICS:
                if "field" not in node.params or \
                        set(node.params) - {"field", "format"}:
                    raise QueryParsingError(
                        f"mesh engine plane cannot reduce agg "
                        f"[{node.name}:{node.type}] in-program — use the "
                        f"RPC fan-out path")
                met.append((node.name, node.type,
                            str(node.params["field"])))
            elif node.type == "terms":
                if "field" not in node.params or \
                        set(node.params) - {"field", "size", "shard_size",
                                            "order", "min_doc_count",
                                            "format"}:
                    raise QueryParsingError(
                        f"mesh engine plane terms agg [{node.name}] has "
                        f"unsupported params — use the RPC fan-out path")
                fname = str(node.params["field"])
                if any(fname in lay.text for lay in layouts):
                    raise QueryParsingError(
                        f"terms over analyzed text [{fname}] stays "
                        f"host-side — use the RPC fan-out path")
                if any(fname in lay.keyword for lay in layouts) and \
                        any(fname in lay.numeric for lay in layouts):
                    raise QueryParsingError(
                        f"terms field [{fname}] maps to both numeric and "
                        f"keyword columns — use the RPC fan-out path")
                if any(fname in lay.keyword for lay in layouts):
                    resolved = fname
                elif any(f"{fname}.keyword" in lay.keyword
                         for lay in layouts):
                    resolved = f"{fname}.keyword"
                else:
                    raise QueryParsingError(
                        f"terms agg field [{fname}] is not a keyword "
                        f"column — use the RPC fan-out path")
                buck.append(("terms", node.name, resolved))
            elif node.type == "histogram":
                if "field" not in node.params or "interval" not in \
                        node.params or \
                        set(node.params) - {"field", "interval", "offset",
                                            "min_doc_count", "format",
                                            "order"}:
                    raise QueryParsingError(
                        f"mesh engine plane histogram [{node.name}] has "
                        f"unsupported params — use the RPC fan-out path")
                fname = str(node.params["field"])
                interval = float(node.params["interval"])
                offset = float(node.params.get("offset", 0.0))
                if interval <= 0:
                    raise QueryParsingError("histogram interval must be "
                                            "positive")
                ext = field_extrema.get(fname)
                if ext is None:
                    buck.append(("histogram", node.name, fname,
                                 interval, 0.0, 0))
                    continue
                fmin, fmax = ext
                first = math.floor((fmin - offset) / interval)
                last = math.floor((fmax - offset) / interval)
                n_buckets = int(last - first + 1)
                if n_buckets > _MAX_HISTO_BUCKETS:
                    raise QueryParsingError(
                        f"histogram [{node.name}] needs {n_buckets} "
                        f"buckets > {_MAX_HISTO_BUCKETS} — use the RPC "
                        f"fan-out path")
                base = first * interval + offset
                buck.append(("histogram", node.name, fname, interval,
                             base, n_buckets))
            else:
                raise QueryParsingError(
                    f"mesh engine plane cannot reduce agg "
                    f"[{node.name}:{node.type}] in-program — use the RPC "
                    f"fan-out path")
        metric_sig.append(tuple(met))
        bucket_sig.append(tuple(buck))
    if any(s != metric_sig[0] for s in metric_sig) or \
            any(s != bucket_sig[0] for s in bucket_sig):
        raise QueryParsingError(
            "mesh engine plane requires one agg spec per batch")
    return metric_sig[0] or None, bucket_sig[0] or None


def _pad2(a: np.ndarray, rows: int, cols: int, fill) -> np.ndarray:
    out = np.full((rows, cols), fill, a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _pad1(a: np.ndarray, rows: int, fill) -> np.ndarray:
    out = np.full(rows, fill, a.dtype)
    out[:a.shape[0]] = a
    return out


@dataclass
class _SlotLayout:
    """Common padded layout of one segment slot across every shard."""
    np_docs: int
    text: dict[str, tuple[int, int]]       # field → (L, U)
    keyword: dict[str, int]                # field → K (ords width)
    kw_vocab: dict[str, int]               # field → padded vocab size
    numeric: list[str]

    def sig(self) -> tuple:
        """Hashable signature of everything that shapes the padded column
        tensors (kw_vocab shapes the terms lanes, not the tensors — it stays
        out, so a vocab-only drift does not re-upload a resident block)."""
        return (self.np_docs, tuple(sorted(self.text.items())),
                tuple(sorted(self.keyword.items())),
                tuple(self.numeric))


def _empty_segment(n: int) -> Segment:
    return Segment(seg_id=-1, num_docs=0, padded_docs=n, ids=[], sources=[],
                   text_fields={}, keyword_fields={}, numeric_fields={},
                   vector_fields={}, geo_fields={})


def _build_template(lay: _SlotLayout, seg, live, doc_base: int,
                    device: torch.device) -> PlaneSegment:
    """One shard/slot padded to the slot layout, its columns on ``device``
    and the REAL host dictionaries kept for term / ordinal resolution.
    ``seg=None`` builds the empty filler for shards whose view has fewer
    segments than n_slots. Position matrices stay on the host until a plan
    reads them (_TemplateReader.fetch_tokens)."""
    n = lay.np_docs

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    text = {}
    for name, (L, U) in lay.text.items():
        c = seg.text_fields.get(name) if seg is not None else None
        if c is None:
            c = TextFieldColumn(
                terms=[], tokens=np.full((n, L), -1, np.int32),
                uterms=np.full((n, U), -1, np.int32),
                utf=np.zeros((n, U), np.float32),
                doc_len=np.zeros(n, np.int32),
                df=np.zeros(1, np.int32), total_tokens=0)
        uterms = put(_pad2(c.uterms, n, U, -1))
        text[name] = DeviceTextField(
            uterms=uterms, utf=put(_pad2(c.utf, n, U, 0.0)),
            doc_len=put(_pad1(c.doc_len, n, 0)), column=c,
            trailing_pad=pads_trail(uterms))
    keyword = {}
    for name, kdim in lay.keyword.items():
        c = seg.keyword_fields.get(name) if seg is not None else None
        if c is None:
            c = KeywordFieldColumn(vocab=[],
                                   ords=np.full((n, kdim), -1, np.int32))
        keyword[name] = DeviceKeywordField(
            ords=put(_pad2(c.ords, n, kdim, -1)), column=c)
    numeric = {}
    for name in lay.numeric:
        c = seg.numeric_fields.get(name) if seg is not None else None
        if c is None:
            hi = np.zeros(n, np.float32)
            lo = np.zeros(n, np.float32)
            exists = np.zeros(n, bool)
        else:
            hi, lo = dd_split(c.values)
            hi, lo = _pad1(hi, n, 0.0), _pad1(lo, n, 0.0)
            exists = _pad1(c.exists, n, False)
        numeric[name] = DeviceNumericField(hi=put(hi), lo=put(lo),
                                           exists=put(exists), column=c)
    live_p = _pad1(live, n, False) if live is not None \
        else np.zeros(n, bool)
    host_seg = seg if seg is not None else _empty_segment(n)
    return PlaneSegment(seg=host_seg, live=put(live_p), doc_base=doc_base,
                        text=text, keyword=keyword, numeric=numeric,
                        np_docs=n)


class _TemplateReader:
    """Reader facade over one shard's padded templates — df / text stats
    for resolution and the DFS round, and the lazy position matrices."""

    _lock = threading.Lock()

    def __init__(self, templates, view, device=None):
        self.segments = templates          # DeviceSegment-shaped
        self._view = view
        self.device = device
        # the view is point-in-time: a field's stats are computed once
        self._text_stats: dict[str, TextFieldStats] = {}

    @property
    def num_docs(self) -> int:
        return self._view.num_docs

    def text_stats(self, field: str):
        hit = self._text_stats.get(field)
        if hit is not None:
            return hit
        doc_count = docs_with = total = 0
        for seg in self._view.segments:
            c = seg.text_fields.get(field)
            if c is not None:
                doc_count += seg.num_docs
                docs_with += int((c.doc_len[:seg.num_docs] > 0).sum())
                total += c.total_tokens
        out = TextFieldStats(doc_count, docs_with, total)
        self._text_stats[field] = out
        return out

    def df(self, field: str, term: str) -> int:
        out = 0
        for seg in self._view.segments:
            c = seg.text_fields.get(field)
            if c is not None:
                tid = c.tid(term)
                if tid >= 0:
                    out += int(c.df[tid])
        return out

    def fetch_tokens(self, seg, field: str) -> None:
        """Put ``field``'s position matrix of block ``seg``, padded to the
        block's rows, on the device once (the block keeps it)."""
        col = seg.text.get(field)
        if col is None or col.tokens is not None:
            return
        with self._lock:
            if col.tokens is None:
                tok = col.column.tokens
                L = max(tok.shape[1] if tok.ndim == 2 else 1, 1)
                padded = np.full((seg.padded_docs, L), -1, np.int32)
                padded[:tok.shape[0], :tok.shape[1]] = tok
                tokens = torch.from_numpy(padded).to(seg.live.device)
                col.tok_extent = token_extent(tokens)
                col.tokens = tokens

    def fetch_vectors(self, seg, field: str, quant: str):
        return None              # the plane packs no vector columns


class MeshEngineSearcher:
    """Executes query-DSL searches over all shards of an index in one
    device pass per batch over a ``("dp", "shard")`` mesh.

    Built from the engines' current searcher views (point-in-time segment
    sets + live masks — deletes respected); rebuild after refresh, like
    acquiring a new searcher. This mesh rank keeps its block of shards on
    its device; every rank of the group calls :meth:`search_batch` with the
    same bodies.
    """

    def __init__(self, mesh: Mesh, engines: list, mapper_service,
                 k1: float = 1.2, b: float = 0.75,
                 mapper_services: list | None = None,
                 breaker_service=None, prev: "MeshEngineSearcher" = None,
                 reuse_blocks: bool = True,
                 stats_sinks: list | None = None):
        if breaker_service is not None:
            raise NotPortedError("the collective plane's breaker "
                                 "accounting is not ported yet")
        self.mesh = mesh
        self.device = mesh.device
        self.mapper_service = mapper_service
        # multi-index batches: one mapper per engine shard (aligned with
        # `engines`) so each shard resolves against ITS index's mappings
        self._mappers = list(mapper_services) if mapper_services \
            else [mapper_service] * len(engines)
        if len(self._mappers) != len(engines):
            raise ValueError("mapper_services must align with engines")
        self.k1, self.b = k1, b
        self._bm25 = BM25Params(k1=k1, b=b)
        s_mesh = mesh.shape["shard"]
        if len(engines) % s_mesh != 0:
            raise ValueError(f"{len(engines)} engine shards not divisible "
                             f"by mesh shard axis {s_mesh}")
        s = len(engines)
        # shards-per-device blocking: each rank holds a contiguous block of
        # spd shards and merges them locally before the group's gather
        self.spd = s // s_mesh
        self.n_shards = s
        self._local = list(range(mesh.shard_index() * self.spd,
                                 (mesh.shard_index() + 1) * self.spd))
        views = [e.acquire_searcher() for e in engines]
        self._views = views
        self.n_slots = max((len(v.segments) for v in views), default=0)
        if self.n_slots == 0:
            raise ValueError("no segments — refresh the engines first")
        self._layouts = [self._slot_layout(j) for j in range(self.n_slots)]
        self.slot_bases = np.cumsum(
            [0] + [lay.np_docs for lay in self._layouts])[:-1].tolist()
        self.shard_stride = int(sum(lay.np_docs for lay in self._layouts))
        lay_sigs = tuple(lay.sig() for lay in self._layouts)
        self._lay_sigs = lay_sigs
        if reuse_blocks:
            # engine-close hook: the moment a backing engine closes, its
            # cached device blocks leave the cache
            for e in engines:
                hook_engine_block_release(e)
        # host facades of every shard's slots (layout text fields + host
        # segment): what the DFS round reads, on every rank
        self._host_slots = [
            [types.SimpleNamespace(
                text=dict(self._layouts[j].text),
                seg=v.segments[j] if j < len(v.segments)
                else _empty_segment(self._layouts[j].np_docs))
             for j in range(self.n_slots)] for v in views]
        # ---- DATA layer: this rank's per-(shard, slot) device blocks -------
        self._templates: dict[int, list] = {}
        col_up = mask_up = reused = 0
        # exact f64 extrema per numeric field over EVERY shard: histogram
        # lanes get a static bucket base
        self._field_extrema: dict[str, tuple[float, float]] = {}
        for si in range(s):
            view = views[si]
            local = si in self._local
            sink = stats_sinks[si] if stats_sinks else None
            if local:
                self._templates[si] = [None] * self.n_slots
            for j in range(self.n_slots):
                seg = view.segments[j] if j < len(view.segments) else None
                live = view.live_masks[j] if seg is not None else None
                lay = self._layouts[j]
                if not local:
                    extrema = _segment_extrema(seg) if seg is not None \
                        else {}
                    c_up = m_up = c_re = 0
                elif reuse_blocks:
                    tpl, extrema, c_up, m_up, c_re = _block_cache.fetch(
                        engines[si].engine_uuid, lay_sigs[j], lay, seg,
                        live, self.slot_bases[j], self.device)
                    self._templates[si][j] = tpl
                else:
                    tpl = _build_template(lay, seg, live, self.slot_bases[j],
                                          self.device)
                    extrema = _segment_extrema(seg) if seg is not None \
                        else {}
                    m_up = int(tpl.live.numel())
                    c_up = template_bytes(tpl) - m_up
                    c_re = 0
                    self._templates[si][j] = tpl
                col_up += c_up
                mask_up += m_up
                reused += c_re
                if sink is not None:
                    sink["bytes_uploaded"] = sink.get(
                        "bytes_uploaded", 0) + c_up + m_up
                    sink["col_bytes_uploaded"] = sink.get(
                        "col_bytes_uploaded", 0) + c_up
                    sink["mask_bytes_uploaded"] = sink.get(
                        "mask_bytes_uploaded", 0) + m_up
                    sink["bytes_reused"] = sink.get(
                        "bytes_reused", 0) + c_re
                for name, (lo, hi) in extrema.items():
                    cur = self._field_extrema.get(name)
                    self._field_extrema[name] = (lo, hi) if cur is None \
                        else (min(cur[0], lo), max(cur[1], hi))
        kind = "full" if (reused == 0 or not reuse_blocks) else \
            ("mask_only" if col_up == 0 else "incremental")
        # slots whose every block is the previous searcher's (same device
        # tensors): the counterpart of the reference reusing the previous
        # generation's stacked operand
        self._block_tokens = [tuple(self._templates[si][j].live
                                    for si in self._local)
                              for j in range(self.n_slots)]
        prev_ok = (prev is not None and prev.mesh is mesh
                   and prev.n_shards == s
                   and getattr(prev, "_lay_sigs", None) is not None)
        slots_reused = sum(
            1 for j in range(self.n_slots)
            if prev_ok and j < len(prev._block_tokens)
            and prev._lay_sigs[j] == lay_sigs[j]
            and len(prev._block_tokens[j]) == len(self._block_tokens[j])
            and all(a is b_ for a, b_ in zip(prev._block_tokens[j],
                                            self._block_tokens[j])))
        self.data_layer = {"col_bytes_uploaded": col_up,
                           "mask_bytes_uploaded": mask_up,
                           "bytes_uploaded": col_up + mask_up,
                           "bytes_reused": reused, "kind": kind,
                           "slots_reused": slots_reused}
        if stats_sinks:
            key = {"full": "full_rebuilds",
                   "incremental": "incremental_refreshes",
                   "mask_only": "mask_only_refreshes"}[kind]
            for sink in {id(sk): sk for sk in stats_sinks
                         if sk is not None}.values():
                sink[key] = sink.get(key, 0) + 1
        if reuse_blocks:
            # supersession sweep: blocks whose segment left the reader
            # (background merge, force_merge, recovered commit) leave the
            # cache now
            for si in self._local:
                _block_cache.prune(
                    engines[si].engine_uuid,
                    {g.block_uid for g in views[si].segments})
        # keyword-sort data layer: per (field, fill) union-rank columns and
        # their vocabularies, built at the first keyword sort and kept for
        # this searcher's point-in-time views (a previous searcher over the
        # same blocks hands its own over)
        same_data = prev_ok and slots_reused == self.n_slots == \
            prev.n_slots and all(
                a is b_ for a, b_ in zip(prev._views, views))
        self._kw_rank_cache: dict[tuple, tuple] = \
            dict(prev._kw_rank_cache) if same_data else {}
        self._kw_sort_vocab: dict[str, list] = \
            dict(prev._kw_sort_vocab) if same_data else {}
        self._kw_operand_cache: dict[tuple, list] = \
            dict(prev._kw_operand_cache) if same_data else {}
        # resolution and DFS readers a shard, kept with the searcher so a
        # field's statistics are computed once for its views
        self._readers = {si: _TemplateReader(self._templates[si],
                                             views[si], self.device)
                         for si in self._local}
        self._dfs_readers = [_TemplateReader(self._host_slots[si], views[si])
                             for si in range(s)]
        self.last_phases: dict[str, float] = {}

    # ---- packing ----------------------------------------------------------

    def _slot_layout(self, j: int) -> _SlotLayout:
        np_docs = 0
        text: dict[str, tuple[int, int]] = {}
        keyword: dict[str, int] = {}
        kw_vocab: dict[str, int] = {}
        numeric: set[str] = set()
        for v in self._views:
            if j >= len(v.segments):
                continue
            seg = v.segments[j]
            np_docs = max(np_docs, seg.padded_docs)
            for name, c in seg.text_fields.items():
                pl, pu = text.get(name, (0, 0))
                text[name] = (max(pl, c.tokens.shape[1]),
                              max(pu, c.uterms.shape[1]))
            for name, c in seg.keyword_fields.items():
                keyword[name] = max(keyword.get(name, 0), c.ords.shape[1])
                kw_vocab[name] = max(kw_vocab.get(name, 1), len(c.vocab))
            numeric.update(seg.numeric_fields)
            if seg.vector_fields or seg.geo_fields or seg.nested_blocks \
                    or seg.shape_fields or seg.mvector_fields:
                raise QueryParsingError(
                    "mesh engine plane does not pack vector/geo/shape/"
                    "nested fields yet — use the RPC fan-out path")
        return _SlotLayout(np_docs=max(np_docs, 8), text=text,
                           keyword=keyword, kw_vocab=kw_vocab,
                           numeric=sorted(numeric))

    def device_bytes(self) -> int:
        """Bytes of this searcher's blocks and keyword-rank columns on its
        device (lazy position matrices included once uploaded)."""
        total = sum(template_bytes(tpl) for row in self._templates.values()
                    for tpl in row)
        total += sum(t.numel() * t.element_size()
                     for ops in self._kw_operand_cache.values()
                     for per_shard in ops for t in per_shard.values())
        return total

    # ---- statistics (the DFS round, on the host) ---------------------------

    def _global_dfs(self, queries: list) -> dict:
        from elasticsearch_tpu_torch.search.query_dsl import BoolQuery
        shard_results = [dfs_mod.shard_dfs(
            self._dfs_readers[si], self._mappers[si],
            BoolQuery(must=list(queries))) for si in range(self.n_shards)]
        return dfs_mod.to_execution_stats(
            dfs_mod.aggregate_dfs(shard_results))

    # ---- keyword-sort union ranks (data layer) ----------------------------

    def _kw_sort_ranks(self, field: str, fill: float):
        """→ (ranks [S, stride] f32, union_vocab): every doc's FIRST keyword
        ordinal lifted to a rank in the cross-shard union vocabulary,
        missing docs and column-less slots at `fill`. Ranks are exact in
        f32 below 2^24 terms; larger vocabularies stay host-side."""
        key = (field, fill)
        hit = self._kw_rank_cache.get(key)
        if hit is not None:
            return hit
        values: set[str] = set()
        for v in self._views:
            for seg in v.segments:
                c = seg.keyword_fields.get(field)
                if c is not None:
                    values.update(c.vocab)
        if len(values) >= _MAX_KW_SORT_VOCAB:
            raise QueryParsingError(
                f"keyword sort [{field}] vocab exceeds the f32-exact "
                f"rank budget — use the RPC fan-out path")
        union_vocab = sorted(values)
        rank_of = {t: i for i, t in enumerate(union_vocab)}
        ranks = np.full((self.n_shards, self.shard_stride),
                        np.float32(fill), np.float32)
        for si, v in enumerate(self._views):
            for j, lay in enumerate(self._layouts):
                seg = v.segments[j] if j < len(v.segments) else None
                if seg is None:
                    continue
                c = seg.keyword_fields.get(field)
                if c is None:
                    continue
                first = c.ords[:, 0]
                have = first >= 0
                remap = np.array([rank_of[t] for t in c.vocab] or [0],
                                 np.float32)
                col = np.full(lay.np_docs, np.float32(fill), np.float32)
                col[:first.shape[0]][have] = remap[first[have]]
                base = self.slot_bases[j]
                ranks[si, base:base + lay.np_docs] = col
        self._kw_sort_vocab[field] = union_vocab
        self._kw_rank_cache[key] = (ranks, union_vocab)
        return ranks, union_vocab

    def _kw_rank_operand(self, sort_specs) -> list:
        """Per local shard, {(field, fill): the [stride] f32 device column
        of that keyword spec's union ranks} (empty when the sort has no
        keyword key)."""
        ckey = tuple((sp.field, sp.fill) for sp in (sort_specs or ())
                     if sp.kind == "keyword")
        hit = self._kw_operand_cache.get(ckey)
        if hit is not None:
            return hit
        cols = {key: self._kw_sort_ranks(*key)[0] for key in ckey}
        dev = [{key: torch.from_numpy(np.ascontiguousarray(c[si])).to(
            self.device) for key, c in cols.items()} for si in self._local]
        self._kw_operand_cache[ckey] = dev
        return dev

    # ---- the device pass ---------------------------------------------------

    def _plan_slots(self, reqs, flags_base, score_cursor, dfs_stats):
        """Resolve every (local shard, slot, query) and stack each (shard,
        slot)'s constants on the device: → {(si, j): (template, consts,
        emit, post_filter emit, refs)}. One plan signature per slot across
        the shards and the batch, as the reference requires."""
        plans = {}
        for j in range(self.n_slots):
            sig_j = None
            for si in self._local:
                tpl = self._templates[si][j]
                reader = self._readers[si]
                ctx = ExecutionContext(reader=reader,
                                       mapper_service=self._mappers[si],
                                       bm25=self._bm25, dfs_stats=dfs_stats)
                rows = []
                first = None
                for req in reqs:
                    flags_q = dict(flags_base,
                                   _min_score=float(req.min_score)
                                   if req.min_score is not None else 0.0)
                    if score_cursor:
                        # the (score, doc) continuation with no doc pivot:
                        # ids > -1 is vacuous, so the mask is the score
                        # cursor alone
                        flags_q.update(search_after=True,
                                       _sa_score=float(req.search_after[0]),
                                       _sa_doc=-1)
                    ct, emit_q, emit_pf, refs = _plan(
                        tpl, ctx, req.query, req.post_filter, flags_q)
                    if sig_j is None:
                        sig_j = ct.signature()
                    elif ct.signature() != sig_j:
                        raise QueryParsingError(
                            "mesh engine plane requires one plan signature "
                            "per batch (mixed query structures)")
                    if first is None:
                        first = (ct, emit_q, emit_pf, refs)
                    rows.append(ct.values)
                ct0, emit_q, emit_pf, refs = first
                _fetch_lazy(tpl, reader, ct0.positions_needed,
                            ct0.vectors_needed)
                plans[(si, j)] = (tpl, stack_consts(rows, self.device),
                                  emit_q, emit_pf, refs)
        return plans

    def _sort_columns(self, sp, si, li, kwsorts):
        """(hi, lo) per-doc key columns [stride] of one field spec for one
        shard, before the desc negation."""
        if sp.kind == "keyword":
            col = kwsorts[li][(sp.field, sp.fill)]
            return col, torch.zeros_like(col)
        f_hi, f_lo = _dd_fill(sp.fill)
        cols_hi, cols_lo = [], []
        for j in range(self.n_slots):
            tpl = self._templates[si][j]
            ncol = tpl.numeric.get(sp.field)
            n_j = tpl.live.shape[0]
            if ncol is None:
                # host absent-column semantics: flat +inf raw key
                cols_hi.append(torch.full((n_j,), math.inf,
                                          dtype=torch.float32,
                                          device=self.device))
                cols_lo.append(torch.zeros(n_j, dtype=torch.float32,
                                           device=self.device))
            else:
                cols_hi.append(torch.where(
                    ncol.exists, ncol.hi, torch.tensor(
                        f_hi, dtype=torch.float32, device=self.device)))
                cols_lo.append(torch.where(
                    ncol.exists, ncol.lo, torch.tensor(
                        f_lo, dtype=torch.float32, device=self.device)))
        return torch.cat(cols_hi), torch.cat(cols_lo)

    def _run(self, reqs, plans, k, sort_specs, cursors, kwsorts, agg_fields,
             bucket_specs, want_arrays):
        """The plane's local step and its collectives (the reference's
        ``step_local``), eager over this rank's shards → a dict of device
        tensors: docs, scores [B, k], shard_counts [S, B], totals [B]
        (and skeys, metrics, terms, histo)."""
        dev = self.device
        b = len(reqs)
        n_slots, stride, spd = self.n_slots, self.shard_stride, self.spd
        sort_mode = sort_specs is not None
        terms_lanes = [x for x in (bucket_specs or ()) if x[0] == "terms"]
        histo_lanes = [x for x in (bucket_specs or ())
                       if x[0] == "histogram"]
        kw_vocab = [lay.kw_vocab for lay in self._layouts]
        cand = []                    # per-shard payload dicts [B, k]
        counts_blocks = []           # per-shard [B] hit counts
        acc = {f: None for f in agg_fields}
        terms_acc = {(x[1], j): [] for x in terms_lanes
                     for j in range(n_slots)}
        histo_acc = {x[1]: None for x in histo_lanes}
        for li, si in enumerate(self._local):
            seg_scores, seg_docs = [], []
            arr_scores, arr_masks = [], []
            counts = None
            for j in range(n_slots):
                tpl, consts, emit_q, emit_pf, refs = plans[(si, j)]
                outs = _build(tpl, consts, emit_q, emit_pf, refs, k, b,
                              want_arrays=want_arrays,
                              want_topk=not sort_mode)
                if agg_fields:
                    # per-shard metric partials of the agg mask: K9's
                    # double-double row a query, folded in f32 across the
                    # slots and shards as the reference folds them
                    amask = outs["agg_mask"]
                    for f in agg_fields:
                        ncol = tpl.numeric.get(f)
                        if ncol is None:
                            continue
                        row = aggs_ops.dd_stats_rows(ncol.hi, ncol.lo,
                                                     ncol.exists, amask)
                        p = [row[:, 5].to(torch.float32),
                             row[:, 6].to(torch.float32),
                             row[:, 0].to(torch.int32)] + \
                            [row[:, c].to(torch.float32)
                             for c in (1, 2, 3, 4)]
                        if acc[f] is None:
                            acc[f] = p
                        else:
                            a0 = acc[f]
                            pick_mn = (p[3] < a0[3]) | \
                                ((p[3] == a0[3]) & (p[4] < a0[4]))
                            pick_mx = (p[5] > a0[5]) | \
                                ((p[5] == a0[5]) & (p[6] > a0[6]))
                            acc[f] = [
                                a0[0] + p[0], a0[1] + p[1], a0[2] + p[2],
                                torch.where(pick_mn, p[3], a0[3]),
                                torch.where(pick_mn, p[4], a0[4]),
                                torch.where(pick_mx, p[5], a0[5]),
                                torch.where(pick_mx, p[6], a0[6])]
                if bucket_specs:
                    amask = outs["agg_mask"]
                    for _, name, f in terms_lanes:
                        kcol = tpl.keyword.get(f)
                        v_j = kw_vocab[j].get(f, 1)
                        if kcol is None:
                            terms_acc[(name, j)].append(torch.zeros(
                                (b, v_j), dtype=torch.int32, device=dev))
                        else:
                            terms_acc[(name, j)].append(
                                aggs_ops.ord_counts_rows(kcol.ords, amask,
                                                         v_j))
                    for _, name, f, interval, base, nb in histo_lanes:
                        if nb == 0:
                            continue
                        ncol = tpl.numeric.get(f)
                        if ncol is None:
                            continue
                        bh, bl = dd_split(np.float64(base))
                        h = aggs_ops.dd_histogram_counts_rows(
                            ncol.hi, ncol.lo, ncol.exists, amask, float(bh),
                            float(bl), interval, nb)
                        histo_acc[name] = h if histo_acc[name] is None \
                            else histo_acc[name] + h
                if sort_mode:
                    arr_scores.append(outs["scores"])
                    arr_masks.append(outs["mask"])
                else:
                    docs = torch.where(outs["top_docs"] >= 0,
                                       outs["top_docs"] + self.slot_bases[j],
                                       -1)
                    seg_scores.append(outs["top_scores"])
                    seg_docs.append(docs)
                counts = outs["count"] if counts is None \
                    else counts + outs["count"]
            counts_blocks.append(counts)
            shard_off = si * stride
            if sort_mode:
                cand.append(self._shard_sorted(
                    torch.cat(arr_scores, dim=1), torch.cat(arr_masks, dim=1),
                    sort_specs, si, li, kwsorts, cursors, k, shard_off))
            else:
                scores = torch.cat(seg_scores, dim=1)
                docs = torch.cat(seg_docs, dim=1)
                kk = min(k, scores.shape[1])
                top_s, top_d, _ = topk_ops.select_top_k(
                    scores.contiguous(), kk, ids=docs.contiguous())
                top_d = torch.where(top_d >= 0, top_d + shard_off, -1)
                if kk < k:
                    top_s = torch.nn.functional.pad(top_s, (0, k - kk),
                                                    value=-math.inf)
                    top_d = torch.nn.functional.pad(top_d, (0, k - kk),
                                                    value=-1)
                cand.append({"docs": top_d, "scores": top_s})

        def merge(blocks: list, force: bool = False) -> dict:
            """Exact candidate merge: keeping k of the len(blocks)·k
            candidates loses only entries outranked by >= k better ones;
            ties keep the earlier block — blocks arrive shard-major, so
            this is the (sort key, shard, position) order of
            SearchPhaseController.sortDocs."""
            if len(blocks) == 1 and not force:
                return blocks[0]
            allp = {name: torch.cat([blk[name] for blk in blocks], dim=1)
                    for name in blocks[0]}
            if sort_mode:
                keys = []
                for i in range(len(sort_specs)):
                    keys += [allp[f"khi{i}"], allp[f"klo{i}"]]
                idx = topk_ops.sort_select(
                    keys, k, mask=allp["inval"] == 0).to(torch.int64)
                return _gather_payload(allp, idx)
            n = allp["docs"].shape[1]
            pos_ids = torch.where(
                allp["docs"] >= 0,
                torch.arange(n, dtype=torch.int32, device=dev)[None, :], -1)
            _, pos, _ = topk_ops.select_top_k(allp["scores"].contiguous(), k,
                                              ids=pos_ids.contiguous())
            got = _gather_payload(allp, pos.clamp(min=0).to(torch.int64))
            got["docs"] = torch.where(pos >= 0, got["docs"], -1)
            got["scores"] = torch.where(pos >= 0, got["scores"], -math.inf)
            return got

        local = merge(cand)
        # ---- the group's collectives: per-shard count lane + gathered merge
        counts_stack = torch.stack(counts_blocks)              # [spd, B]
        shard_counts = self.mesh.all_gather(counts_stack)      # [Sm, spd, B]
        gathered = {name: self.mesh.all_gather(arr)
                    for name, arr in local.items()}            # [Sm, B, k]
        s_ax = next(iter(gathered.values())).shape[0]
        flat = {name: arr.permute(1, 0, 2).reshape(-1, s_ax * k)
                for name, arr in gathered.items()}
        g = merge([flat], force=True)
        if sort_mode:
            g["docs"] = torch.where(g["inval"] > 0, -1, g["docs"])
            g["scores"] = torch.where(g["inval"] > 0, -math.inf, g["scores"])
        else:
            g["scores"] = torch.where(g["docs"] >= 0, g["scores"], -math.inf)
        out = {"docs": g["docs"], "scores": g["scores"],
               "shard_counts": shard_counts.reshape(-1, b),
               "totals": shard_counts.sum(dim=(0, 1))}
        if sort_mode:
            out["skeys"] = [(g[f"khi{i}"], g[f"klo{i}"])
                            for i in range(len(sort_specs))]
        if agg_fields:
            def pair_reduce(hi_v, lo_v, is_min: bool):
                # (hi, lo) extrema reduce lexicographically over a gather
                # (a min of hi alone would detach lo from its hi)
                ah = self.mesh.all_gather(hi_v)
                al = self.mesh.all_gather(lo_v)
                rh, rl = ah[0], al[0]
                for s_ in range(1, ah.shape[0]):
                    bh, bl = ah[s_], al[s_]
                    if is_min:
                        pick = (bh < rh) | ((bh == rh) & (bl < rl))
                    else:
                        pick = (bh > rh) | ((bh == rh) & (bl > rl))
                    rh = torch.where(pick, bh, rh)
                    rl = torch.where(pick, bl, rl)
                return rh, rl

            agg_out = []
            for f in agg_fields:
                a0 = acc[f]
                if a0 is None:                   # field absent
                    inf = torch.full((b,), math.inf, device=dev)
                    zero = torch.zeros(b, device=dev)
                    a0 = [zero, zero, torch.zeros(b, dtype=torch.int32,
                                                  device=dev),
                          inf, inf, -inf, -inf]
                mn_hi, mn_lo = pair_reduce(a0[3], a0[4], True)
                mx_hi, mx_lo = pair_reduce(a0[5], a0[6], False)
                agg_out.append((self.mesh.psum(a0[0]),
                                self.mesh.psum(a0[1]),
                                self.mesh.psum(a0[2]),
                                mn_hi, mn_lo, mx_hi, mx_lo))
            out["metrics"] = agg_out
        if bucket_specs:
            out["terms"] = {
                name: [self.mesh.all_gather(torch.stack(
                    terms_acc[(name, j)])).reshape(
                        self.n_shards, b, -1) for j in range(n_slots)]
                for _, name, _ in terms_lanes}     # per slot [S, B, V_j]
            histo = {}
            for _, name, f, interval, base, nb in histo_lanes:
                h = histo_acc[name]
                if h is None:
                    h = torch.zeros((b, max(nb, 1)), dtype=torch.int32,
                                    device=dev)
                histo[name] = self.mesh.psum(h)
            out["histo"] = histo
        return out

    def _shard_sorted(self, scores, mask, sort_specs, si, li, kwsorts,
                      cursors, k, shard_off) -> dict:
        """One shard's field-sort selection (K20) and its payload."""
        dev = self.device
        keys, neg, raw = [], [], []
        zero_col = None
        for i, sp in enumerate(sort_specs):
            if sp.is_score:
                if zero_col is None:
                    zero_col = torch.zeros(scores.shape[1],
                                           dtype=torch.float32, device=dev)
                hi, lo = scores, zero_col
            else:
                hi, lo = self._sort_columns(sp, si, li, kwsorts)
            keys += [hi.contiguous(), lo.contiguous()]
            raw.append((hi, lo))
            if sp.order == "desc":
                neg += [2 * i, 2 * i + 1]
        kk = min(k, scores.shape[1])
        idx = topk_ops.sort_select(keys, kk, mask=mask.contiguous(),
                                   cursor=cursors, neg=neg).to(torch.int64)
        payload = {"docs": idx.to(torch.int32),
                   "scores": torch.gather(scores, 1, idx)}
        valid = torch.gather(mask, 1, idx)
        picked = []
        for i, (sp, (hi, lo)) in enumerate(zip(sort_specs, raw)):
            pair = []
            for col in (hi, lo):
                v = torch.gather(col, 1, idx) if col.dim() == 2 else col[idx]
                pair.append(-v if sp.order == "desc" else v)
            picked.append(pair)
        if cursors is not None:
            # the cursor's strictly-after compare, at the selected entries
            gt = torch.zeros_like(valid)
            eq = torch.ones_like(valid)
            for i, (h, lo_) in enumerate(picked):
                for comp, arr in ((0, h), (1, lo_)):
                    c = cursors[:, 2 * i + comp][:, None]
                    gt = gt | (eq & (arr > c))
                    eq = eq & (arr == c)
            valid = valid & gt
        payload["inval"] = torch.where(valid, 0.0, 1.0).to(torch.float32)
        for i, (h, lo_) in enumerate(picked):
            payload[f"khi{i}"] = h
            payload[f"klo{i}"] = lo_
        payload["docs"] = torch.where(payload["inval"] > 0, -1,
                                      payload["docs"] + shard_off)
        if kk < k:
            pads = {"docs": -1, "scores": -math.inf, "inval": 1.0}
            payload = {name: torch.nn.functional.pad(
                arr, (0, k - kk), value=pads.get(name, math.inf))
                for name, arr in payload.items()}
        return payload

    def search_batch(self, bodies: list[dict], global_stats: bool = True):
        """Execute B query-DSL request bodies in one device pass → list of
        {"total", "shard_totals", "scores", "doc_ids" [, "sort_values"] [,
        "aggregations"]} with GLOBAL doc ids (resolve via :meth:`resolve`).

        ``global_stats`` selects the scoring statistics: True runs the DFS
        round over every shard (dfs_query_then_fetch — the plane's native
        mode); False scores each shard with its OWN statistics, matching
        the default fan-out's per-shard scoring.

        ``terminate_after`` / ``timeout`` do not bail here: the count lane
        gives the caller exact per-shard totals to cap."""
        if not bodies:
            return []
        t0 = time.perf_counter()
        reqs = [parse_search_request(b) for b in bodies]
        for req in reqs:
            if req.rescore:
                raise QueryParsingError(
                    "mesh engine plane does not run suggest/rescore — "
                    "route to the RPC path")
            if req.knn is not None:
                raise QueryParsingError(
                    "mesh engine plane does not run the knn section — "
                    "route to the RPC path")
        score_order = [_is_score_order(req.sort) for req in reqs]
        if any(s != score_order[0] for s in score_order):
            raise QueryParsingError(
                "mesh engine plane requires one sort mode per batch")
        sort_specs = None
        if not score_order[0]:
            sort_specs = _mesh_sort_spec(reqs, self._layouts)
        has_ms = [req.min_score is not None for req in reqs]
        if any(m != has_ms[0] for m in has_ms):
            raise QueryParsingError(
                "mesh engine plane requires uniform min_score presence")
        has_sa = [req.search_after is not None for req in reqs]
        if any(s != has_sa[0] for s in has_sa):
            raise QueryParsingError(
                "mesh engine plane requires uniform search_after presence")
        has_cursor = has_sa[0]
        score_cursor = False
        if has_cursor and sort_specs is None:
            # score-order continuation: the bare [score] cursor only; a
            # cursor with a doc-id component is numbering-relative, and an
            # EXPLICIT [{"_score": "desc"}] sort makes the fan-out ignore
            # the cursor entirely — match it by bailing
            for req in reqs:
                sa = req.search_after
                if req.sort or len(sa) != 1 or sa[0] is None or \
                        isinstance(sa[0], str):
                    raise QueryParsingError(
                        "score-order search_after cursors with a doc-id "
                        "component are numbering-relative — use the RPC "
                        "fan-out path")
            score_cursor, has_cursor = True, False
        elif has_cursor:
            for req in reqs:
                sa = req.search_after
                if len(sa) != len(sort_specs):
                    raise QueryParsingError(
                        "mesh engine plane needs a full search_after "
                        "cursor — use the RPC fan-out path")
                for v, sp in zip(sa, sort_specs):
                    if v is None or (sp.kind != "keyword"
                                     and isinstance(v, str)):
                        raise QueryParsingError(
                            "mesh engine plane needs typed search_after "
                            "cursor values — use the RPC fan-out path")
        agg_spec, bucket_specs = _mesh_agg_plan(reqs, self._layouts,
                                                self._field_extrema)
        if bucket_specs:
            for x in bucket_specs:
                if x[0] == "terms":
                    cells = sum(lay.kw_vocab.get(x[2], 1)
                                for lay in self._layouts) * \
                        len(reqs) * self.n_shards
                    if cells > _MAX_TERMS_CELLS:
                        raise QueryParsingError(
                            "terms agg vocab too large for the mesh "
                            "gather budget — use the RPC fan-out path")
        # a k BUCKET, as the reference's (each request's page is sliced
        # off on the host below)
        k = pow2_bucket(max(max(r.from_ + r.size, 1) for r in reqs))
        queries = [r.query for r in reqs]
        t_dfs = time.perf_counter()
        dfs_stats = self._global_dfs(queries) if global_stats else None
        t_plan = time.perf_counter()
        want_arrays = bool(agg_spec or bucket_specs) or \
            sort_specs is not None
        flags = dict(_FLAGS, min_score=has_ms[0])
        plans = self._plan_slots(reqs, flags, score_cursor, dfs_stats)
        # the search_after cursor: transformed (hi, lo) per spec — the key
        # space the selection sorts in
        cursors = None
        if has_cursor:
            cur_np = np.zeros((len(reqs), 2 * len(sort_specs)), np.float32)
            for bi, req in enumerate(reqs):
                for i, sp in enumerate(sort_specs):
                    if sp.kind == "keyword":
                        # a string cursor → its union rank; a term absent
                        # from the union sits between its neighbours
                        _, union = self._kw_sort_ranks(sp.field, sp.fill)
                        sval = str(req.search_after[i])
                        pos = bisect.bisect_left(union, sval)
                        if pos < len(union) and union[pos] == sval:
                            chi, clo = float(pos), 0.0
                        else:
                            chi, clo = float(pos) - 0.5, 0.0
                    else:
                        chi, clo = _dd_fill(float(req.search_after[i]))
                    if sp.order == "desc":
                        chi, clo = -chi, -clo
                    cur_np[bi, 2 * i] = chi
                    cur_np[bi, 2 * i + 1] = clo
            cursors = torch.from_numpy(cur_np).to(self.device)
        kwsorts = self._kw_rank_operand(sort_specs)
        agg_fields = sorted({f for _, _, f in agg_spec}) if agg_spec else []
        t_run = time.perf_counter()
        outs = self._run(reqs, plans, k, sort_specs, cursors, kwsorts,
                         agg_fields, bucket_specs, want_arrays)
        # the device→host copies: where the host waits on the device
        g_s = outs["scores"].cpu().numpy()
        g_d = outs["docs"].cpu().numpy()
        totals = outs["totals"].cpu().numpy()
        shard_counts = outs["shard_counts"].cpu().numpy()
        skeys = [(h.cpu().numpy(), lo.cpu().numpy())
                 for h, lo in outs["skeys"]] if sort_specs else None
        agg_np = {f: [a.cpu().numpy() for a in outs["metrics"][i]]
                  for i, f in enumerate(agg_fields)} if agg_spec else None
        terms_np = {name: [a.cpu().numpy() for a in arrs]
                    for name, arrs in outs.get("terms", {}).items()}
        histo_np = {name: a.cpu().numpy()
                    for name, a in outs.get("histo", {}).items()}
        t_render = time.perf_counter()
        out = []
        for bi, req in enumerate(reqs):
            kq = max(req.from_ + req.size, 1)
            valid = g_d[bi] >= 0
            res = {"total": int(totals[bi]),
                   "shard_totals": shard_counts[:, bi].astype(np.int64),
                   "scores": g_s[bi][valid][:kq],
                   "doc_ids": g_d[bi][valid][:kq]}
            if sort_specs:
                res["sort_values"] = self._render_sort_values(
                    sort_specs, skeys, bi, int(valid.sum()), kq)
            aggs: dict = {}
            if agg_spec:
                aggs.update(self._render_aggs(agg_spec, agg_np, bi))
            if bucket_specs:
                aggs.update(self._render_buckets(
                    req, bucket_specs, terms_np, histo_np, bi))
            if aggs:
                res["aggregations"] = aggs
            out.append(res)
        t_end = time.perf_counter()
        self.last_phases = {"parse_ms": (t_dfs - t0) * 1e3,
                            "dfs_ms": (t_plan - t_dfs) * 1e3,
                            "plan_ms": (t_run - t_plan) * 1e3,
                            "device_ms": (t_render - t_run) * 1e3,
                            "render_ms": (t_end - t_render) * 1e3}
        return out

    def _render_sort_values(self, sort_specs, skeys, bi: int, n_valid: int,
                            kq: int) -> list:
        """Transformed (hi, lo) keys → per-hit hit["sort"] values: f64
        recombine, un-negate desc (FP negation is exact), inf → None
        (phase._sort_value_out); keyword ranks map back through the union
        vocabulary (missing fills land on ±inf → None)."""
        rows = []
        for pos in range(min(n_valid, kq)):
            vals = []
            for i, sp in enumerate(sort_specs):
                hi_a, lo_a = skeys[i]
                raw = np.float64(hi_a[bi][pos]) + np.float64(lo_a[bi][pos])
                if sp.order == "desc":
                    raw = -raw
                if sp.kind == "keyword":
                    union = self._kw_sort_vocab.get(sp.field, [])
                    vals.append(
                        union[int(raw)]
                        if np.isfinite(raw) and float(raw).is_integer()
                        and 0 <= int(raw) < len(union) else None)
                else:
                    vals.append(_sort_value_out(raw))
            rows.append(vals)
        return rows

    def _render_buckets(self, req, bucket_specs, terms_np, histo_np,
                        bi: int) -> dict:
        """Gathered bucket lanes → final agg responses through the SAME
        coordinator reduce the fan-out uses (reduce_aggs), fed per-shard
        partial dicts in the device-collect wire shapes."""
        from elasticsearch_tpu_torch.search.aggregations import reduce_aggs
        nodes = {n.name: n for n in req.aggs}
        out: dict = {}
        for lane in bucket_specs:
            if lane[0] == "terms":
                _, name, f = lane
                arrs = terms_np[name]      # per slot: [S, B, V_j]
                parts = []
                for si in range(self.n_shards):
                    merged: dict[str, int] = {}
                    for j in range(self.n_slots):
                        counts = arrs[j][si, bi]
                        segs = self._views[si].segments
                        col = segs[j].keyword_fields.get(f) \
                            if j < len(segs) else None
                        if col is None:
                            continue
                        vocab = col.vocab
                        for oid in np.nonzero(counts)[0]:
                            if int(oid) >= len(vocab):
                                continue
                            key_t = vocab[int(oid)]
                            merged[key_t] = merged.get(key_t, 0) + \
                                int(counts[oid])
                    parts.append({name: {
                        "buckets": [[k_, {"doc_count": n_}]
                                    for k_, n_ in merged.items()],
                        "doc_count_error_upper_bound": 0}})
                out.update(reduce_aggs([nodes[name]], parts,
                                       device=self.device))
            else:
                _, name, f, interval, base, nb = lane
                counts = histo_np[name][bi] if nb else np.zeros(0)
                pairs = [[float(base + i * interval),
                          {"doc_count": int(c)}]
                         for i, c in enumerate(counts[:nb]) if c > 0]
                node = nodes[name]
                partial = {"buckets": pairs, "interval": interval,
                           "min_doc_count": int(node.params.get(
                               "min_doc_count", 0))}
                out.update(reduce_aggs([node], [{name: partial}],
                                       device=self.device))
        return out

    @staticmethod
    def _render_aggs(agg_spec, agg_np, bi: int) -> dict:
        """Partials → the metric agg response shapes (hi + lo recombined in
        f64, like the device reductions of aggregations.py)."""
        out: dict = {}
        for name, kind, f in agg_spec:
            s_hi, s_lo, c_, mn_hi, mn_lo, mx_hi, mx_lo = \
                (arr[bi] for arr in agg_np[f])
            c_ = int(c_)
            s_ = float(np.float64(s_hi) + np.float64(s_lo))
            mn = float(np.float64(mn_hi) + np.float64(mn_lo)) if c_ \
                else None
            mx = float(np.float64(mx_hi) + np.float64(mx_lo)) if c_ \
                else None
            avg = (s_ / c_) if c_ else None
            out[name] = {
                "min": {"value": mn}, "max": {"value": mx},
                "sum": {"value": s_}, "value_count": {"value": c_},
                "avg": {"value": avg},
                "stats": {"count": c_, "min": mn, "max": mx,
                          "sum": s_, "avg": avg},
            }[kind]
        return out

    # ---- doc id resolution ------------------------------------------------

    def resolve(self, global_doc: int) -> tuple[int, int, int]:
        """global doc id → (shard, slot, local row)."""
        si, local = divmod(int(global_doc), self.shard_stride)
        for j in reversed(range(self.n_slots)):
            if local >= self.slot_bases[j]:
                return si, j, local - self.slot_bases[j]
        raise IndexError(global_doc)

    def doc_id(self, global_doc: int) -> str:
        si, j, row = self.resolve(global_doc)
        return self._views[si].segments[j].ids[row]


def rpc_oracle(mapper_service, engines: list, body: dict, k: int,
               device=None) -> tuple[int, list]:
    """The fan-out reference the plane must match: per-shard ShardSearcher
    with globally aggregated DFS statistics, then a coordinator-ordered
    merge ((-score, shard) like TopDocs.merge). → (total_hits, [(score,
    shard, doc_id), ...][:k]). Score order only (the port's fan-out refuses
    field sort)."""
    from elasticsearch_tpu_torch.index.device_reader import DeviceReader
    from elasticsearch_tpu_torch.search.phase import ShardSearcher
    from elasticsearch_tpu_torch.search.query_dsl import parse_query
    readers = [DeviceReader(e.acquire_searcher(), device=device)
               for e in engines]
    query = parse_query(body.get("query"))
    stats = dfs_mod.to_execution_stats(dfs_mod.aggregate_dfs(
        [dfs_mod.shard_dfs(r, mapper_service, query) for r in readers]))
    req = parse_search_request(body)
    rows: list[tuple[float, int, str]] = []
    total = 0
    for si, r in enumerate(readers):
        res = ShardSearcher(si, r, mapper_service,
                            dfs_stats=stats).query_phase(req)
        total += res.total
        for pos in range(len(res.doc_ids)):
            seg, local = r.resolve(int(res.doc_ids[pos]))
            rows.append((float(res.scores[pos]), si, seg.seg.ids[local]))
    rows.sort(key=lambda x: (-x[0], x[1]))
    return total, rows[:k]
