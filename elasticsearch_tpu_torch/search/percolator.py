"""Percolator — reverse search as a batched device workload.

Counterpart of ``elasticsearch_tpu/search/percolator.py``. Reference:
core/percolator/PercolatorService.java:107 — the doc is parsed into a
one-document in-memory index (Lucene MemoryIndex) and every registered query
runs against it; registrations live in
core/index/percolator/PercolatorQueriesRegistry.java as hidden
`.percolator`-type docs. Here registrations ride the index metadata, and a
percolation runs against a scratch one-doc segment on the card.

* **Registry (persistent, per index and device)** — every registration is
  parsed and planned ONCE into a shape bucket keyed by its plan signature
  against a mapping-derived canonical one-doc segment. The registry syncs
  INCREMENTALLY against the metadata: a register or unregister touches
  exactly its shape bucket, and a percolate that finds the metadata
  unchanged rebuilds nothing. The scratch MapperService is cached, with the
  probe doc's dynamic mappers dropped after each call.
* **One launch of the reduction a call** — per probe doc, each bucket's
  members resolve against the doc's one-doc segment and group by actual
  plan signature; each (segment × group) lane runs its group's emit once
  for the whole group, and every lane of the call — of every probe doc of a
  ``percolate_many`` — is reduced to per-query (matched, score) pairs by one
  launch of kernel K10 and comes back in one device→host copy
  (``segment_exec.run_percolate_lanes``).
* **The shape-fallback lane** — a registration with a ``random_score``
  function runs per query through the eager executor on the card
  (``_eager_match``), as in the JAX package. This routes shapes by type; it
  is not a fallback from a device error, which propagates.

A registration the port cannot serve (a query type with no executor yet —
``has_child``, ``has_parent``, ``script_score``, ``geo_shape`` and the
other leaves still to port — or an unported feature such as the
``script_score`` function) raises from ``sync`` with ``NotPortedError``,
as the reference's registration raises on a parse error; it is never
dropped. Not ported: the plane breaker and the device-error rescue of the
fused lane, and the latency histograms.

Responses carry per-match scores, size + sort-by-score, highlight via the
standard highlighters on the probe doc, and aggregations over registration
metadata (the hidden-doc fields the reference's percolate aggs run on).

``meta`` is duck-typed: ``name``, ``uuid``, ``settings``, ``mappings``,
``percolators`` ({id: registration body}) and ``version``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from elasticsearch_tpu_torch.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, NotPortedError)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.device_reader import DeviceReader
from elasticsearch_tpu_torch.index.engine import SearcherView
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search import lanes, segment_exec
from elasticsearch_tpu_torch.search import query_dsl as q
from elasticsearch_tpu_torch.search.aggregations import (
    PIPELINE_AGGS, ShardAggContext, collect, parse_aggs, reduce_aggs)
from elasticsearch_tpu_torch.search.execute import (
    ConstTable, ExecutionContext, SegmentResolver)
from elasticsearch_tpu_torch.search.highlight import highlight_hit
from elasticsearch_tpu_torch.search.phase import ShardSearcher
from elasticsearch_tpu_torch.search.query_dsl import parse_query


# ---------------------------------------------------------------------------
# eligibility: which shapes ride the fused lanes
# ---------------------------------------------------------------------------

#: functions that run per query on the eager lane. The JAX package also
#: sends script_score functions and the has_child, has_parent,
#: script_score and geo_shape queries there; the port has no executor for
#: them yet, so a registration holding one is refused.
_FALLBACK_FUNCTIONS = ("random_score",)


def _subqueries(ast):
    """Every query node of ``ast``, itself first (function filters
    included)."""
    yield ast
    if not dataclasses.is_dataclass(ast):
        return
    for f in dataclasses.fields(ast):
        v = getattr(ast, f.name, None)
        if isinstance(v, q.Query):
            yield from _subqueries(v)
        elif isinstance(v, (list, tuple)):
            for el in v:
                if isinstance(el, q.Query):
                    yield from _subqueries(el)
                elif isinstance(el, q.ScoreFunction) and \
                        el.filter_query is not None:
                    yield from _subqueries(el.filter_query)


def _needs_fallback(ast) -> bool:
    return any(isinstance(node, q.FunctionScoreQuery) and any(
        f.kind in _FALLBACK_FUNCTIONS for f in node.functions)
        for node in _subqueries(ast))


def _unserved_type(ast) -> str | None:
    """The first query type in ``ast`` that the port has no executor for."""
    for node in _subqueries(ast):
        name = type(node).__name__
        if not hasattr(SegmentResolver, f"_res_{name}"):
            return name
    return None


def _synthetic_doc(mappings: dict | None) -> dict:
    """A doc holding every mapped field with a placeholder value — the
    canonical probe the registry plans registrations against to derive
    their shape bucket (field columns must EXIST for the plan to take the
    same structural branches a real probe doc takes)."""
    def fill(props: dict, out: dict) -> None:
        for name, spec in (props or {}).items():
            typ = spec.get("type")
            if "properties" in spec and typ in (None, "object"):
                fill(spec["properties"], out.setdefault(name, {}))
                continue
            if typ == "nested":
                sub: dict = {}
                fill(spec.get("properties", {}), sub)
                out[name] = [sub]
            elif typ in ("long", "integer", "short", "byte", "double",
                         "float", "half_float", "scaled_float", "date"):
                out[name] = 0
            elif typ == "boolean":
                out[name] = True
            elif typ == "geo_point":
                out[name] = {"lat": 0.0, "lon": 0.0}
            elif typ == "dense_vector":
                out[name] = [0.0] * int(spec.get("dims", 1) or 1)
            elif typ == "geo_shape":
                continue
            else:                            # text / keyword / string / ip
                out[name] = "a"
    doc: dict = {}
    for _t, m in (mappings or {}).items():
        fill(m.get("properties", {}), doc)
    return doc


class _Entry:
    """One registration: the AST parsed once plus its lane classification."""

    __slots__ = ("ast", "shape", "fallback", "body")

    def __init__(self, ast, shape, fallback: bool, body: dict):
        self.ast = ast
        self.shape = shape           # bucket key (None for fallback lane)
        self.fallback = fallback
        self.body = body


class PercolatorRegistry:
    """Per-index, per-device persistent registry of planned queries.

    Thread-safe: sync/diff and bucket maintenance run under the registry
    lock; evaluation works on snapshots taken under it."""

    def __init__(self, meta, device=None):
        self.name = meta.name
        self.uuid = meta.uuid
        self.device = resolve_device(device)
        self.stats = {k: 0 for k in lanes.PERCOLATE_COUNTERS}
        self.stats["builds"] = 1         # this construction is the first
        self.stats["time_ms"] = 0.0      # float accumulator
        self._lock = threading.RLock()
        self._snap: dict | None = None   # meta.percolators as last synced
        self._version = -1
        self._map_fp: str | None = None
        self._mapper: MapperService | None = None
        self._canon = None               # (DeviceSegment, ExecutionContext)
        self._entries: dict[str, _Entry] = {}
        self._order: list[str] = []      # registration order (response order)
        self._buckets: dict = {}         # shape → {qid: _Entry}
        self._bucket_gen: dict = {}      # shape → invalidation generation
        self._reg_env = None             # (ids, seg, searcher) over reg docs
        self._probe_dynamic: list[str] = []
        self._settings = Settings(meta.settings)

    # ---- sync (the index-metadata registration seam) -----------------------

    def sync(self, meta) -> None:
        with self._lock:
            map_fp = repr(meta.mappings)
            if self._map_fp != map_fp:
                self._rebuild_mapper(meta, map_fp)
                # shapes are planned against the mapping-derived canonical
                # segment — a mapping change re-buckets everything
                for qid in list(self._entries):
                    self._remove(qid, count=False)
                self._snap = None
            new = meta.percolators
            if self._version == meta.version and new is self._snap:
                return
            old = self._snap or {}
            if new is not old:
                added = [qid for qid in new
                         if qid not in old or new[qid] != old[qid]]
                removed = [qid for qid in old if qid not in new]
                changed = [qid for qid in added if qid in old]
                if added or removed:
                    self.stats["syncs"] += 1
                touched = set()
                for qid in removed + changed:
                    touched.add(self._remove(qid))
                for qid in added:
                    touched.add(self._add(qid, new[qid]))
                touched.discard(None)
                self.stats["bucket_invalidations"] += len(touched)
                for shape in touched:
                    self._bucket_gen[shape] = \
                        self._bucket_gen.get(shape, 0) + 1
                if added or removed:
                    self._reg_env = None     # registration-doc segment stale
            self._snap = new
            self._version = meta.version

    def _rebuild_mapper(self, meta, map_fp: str) -> None:
        self.stats["mapper_rebuilds"] += 1
        self._settings = Settings(meta.settings)
        self._mapper = _scratch_mapper(meta, self._settings)
        self._map_fp = map_fp
        # canonical one-doc env for registration-time shape planning
        try:
            parsed = self._parse_probe(_synthetic_doc(meta.mappings))
        except Exception:                # noqa: BLE001 — canonical is advisory
            parsed = self._parse_probe({})
        _seg, reader = _probe_reader(parsed, self.device)
        self._canon = (reader.segments[0],
                       ExecutionContext(reader=reader,
                                        mapper_service=self._mapper,
                                        index_name=self.name))

    def _add(self, qid: str, body: dict):
        """Parse + plan one registration; → its shape bucket key (None for
        the fallback lane). Raises for a registration the port cannot
        serve."""
        ast = parse_query((body or {}).get("query"))
        bad = _unserved_type(ast)
        if bad is not None:
            raise NotPortedError(
                f"percolator registration [{qid}]: the [{bad}] query is not "
                f"ported yet")
        shape = self._shape_of(ast)
        self.stats["adds"] += 1
        fallback = _needs_fallback(ast)
        entry = _Entry(ast, None if fallback else shape,
                       fallback or shape is None, body)
        self._entries[qid] = entry
        if qid not in self._order:
            self._order.append(qid)
        if entry.shape is not None:
            self._buckets.setdefault(entry.shape, {})[qid] = entry
        return entry.shape

    def _remove(self, qid: str, count: bool = True):
        entry = self._entries.pop(qid, None)
        if entry is None:
            return None
        if count:
            self.stats["removes"] += 1
        self._order.remove(qid)
        if entry.shape is not None:
            bucket = self._buckets.get(entry.shape)
            if bucket is not None:
                bucket.pop(qid, None)
                if not bucket:
                    del self._buckets[entry.shape]
        return entry.shape

    def _shape_of(self, ast):
        """Plan the AST once against the canonical mapping-derived segment:
        the resulting signature is the registration's shape bucket. A plan
        the canonical env cannot express lands on the fallback lane (None);
        an unported feature raises NotPortedError."""
        seg, ctx = self._canon
        try:
            ct = ConstTable()
            SegmentResolver(seg, ctx, ct).resolve(ast)
            return (ct.signature(), frozenset(ct.positions_needed),
                    frozenset(ct.vectors_needed))
        except NotPortedError:
            raise
        except Exception:                # noqa: BLE001 — fallback lane
            return None

    # ---- probe-doc environment -------------------------------------------

    def _parse_probe(self, doc: dict):
        """Parse with the CACHED scratch mapper and note any dynamically
        inferred mappers, which :meth:`_restore_probe_mappers` drops: each
        probe doc sees the inference a fresh mapper would give it."""
        dm = self._mapper.document_mapper()
        before = set(dm.mappers)
        parsed = dm.parse("_percolate_doc", doc)
        self._probe_dynamic = [k for k in dm.mappers if k not in before]
        return parsed

    def _restore_probe_mappers(self) -> None:
        dm = self._mapper.document_mapper()
        for k in self._probe_dynamic:
            dm.mappers.pop(k, None)

    # ---- registration-doc environment (filter + aggs) ---------------------

    def _registration_env(self):
        """Scratch segment over the registration METADATA docs (every field
        of a registration except the query itself), on the registry's
        device — the percolate request's `filter` and the aggs run against
        it. Cached until registrations change."""
        with self._lock:
            if self._reg_env is not None:
                return self._reg_env
            scratch = MapperService(AnalysisRegistry(self._settings))
            ids = list(self._order)
            builder = SegmentBuilder(seg_id=0)
            dm = scratch.document_mapper()
            for qid in ids:
                probe = {k: v for k, v in
                         (self._entries[qid].body or {}).items()
                         if k != "query"}
                builder.add(dm.parse(str(qid), probe))
            seg, reader = _one_segment_reader(builder, self.device)
            searcher = ShardSearcher(0, reader, scratch,
                                     index_name=self.name)
            self._reg_env = (ids, seg, searcher)
            return self._reg_env

    def _filter_qids(self, reg_filter) -> set:
        """Which registered query ids a percolate-request filter keeps."""
        ids, seg, searcher = self._registration_env()
        if not ids:
            return set()
        matched = _matched_rows(searcher, parse_query(reg_filter),
                                seg.num_docs)
        return {qid for i, qid in enumerate(ids) if matched[i]}

    def _collect_aggs(self, aggs_body: dict, matched_qids) -> dict | None:
        """Aggregations over the registration metadata of the MATCHED
        queries (PercolatorService aggs phase: buckets over the hidden
        .percolator docs that matched), by the host collectors."""
        nodes = parse_aggs(aggs_body)
        if not nodes:
            return None
        ids, seg, searcher = self._registration_env()
        mask = np.zeros(seg.padded_docs, dtype=bool)
        for i, qid in enumerate(ids):
            if qid in matched_qids:
                mask[i] = True
        ctx = ShardAggContext(searcher.reader, searcher._filter_masks_np)
        partials = {n.name: collect(n, mask, ctx) for n in nodes
                    if n.type not in PIPELINE_AGGS}
        return reduce_aggs(nodes, [partials])

    # ---- evaluation --------------------------------------------------------

    def run(self, meta, items: list[dict]) -> list[dict]:
        """Evaluate a batch of percolate requests (one per probe doc), every
        fused lane of every item reduced by one K10 launch and brought back
        in one device→host copy. → per item: a result dict, or
        {"_exception": exc} for a per-item failure (the _mpercolate
        contract; `percolate` re-raises). A device error propagates."""
        t0 = time.perf_counter()
        with self._lock:
            order = list(self._order)
            buckets = {shape: dict(members)
                       for shape, members in self._buckets.items()}
            fallback_entries = {qid: e for qid, e in self._entries.items()
                                if e.fallback}
        lane_list: list[dict] = []
        lane_owner: list[tuple[int, list[str]]] = []   # lane → (item, qids)
        per_item: list[dict] = []
        for it_idx, item in enumerate(items):
            state = {"err": None, "matched": {}}
            per_item.append(state)
            try:
                doc = item.get("doc")
                if doc is None:
                    raise IllegalArgumentError("percolate requires a [doc]")
                participating = None
                if item.get("reg_filter") is not None and order:
                    participating = self._filter_qids(item["reg_filter"])
                if not order or (participating is not None
                                 and not participating):
                    continue
                with self._lock:
                    parsed = self._parse_probe(doc)
                    try:
                        _seg, reader = _probe_reader(parsed, self.device)
                        ctx = ExecutionContext(reader=reader,
                                               mapper_service=self._mapper,
                                               index_name=self.name)
                        dseg = reader.segments[0]
                        # per bucket, resolve members against the probe
                        # segment and group by ACTUAL plan signature (a
                        # bucket may split per probe: one more lane, never
                        # a wrong answer)
                        for members in buckets.values():
                            groups: dict = {}
                            for qid, entry in members.items():
                                if participating is not None and \
                                        qid not in participating:
                                    continue
                                ct = ConstTable()
                                emit = SegmentResolver(
                                    dseg, ctx, ct).resolve(entry.ast)
                                gkey = (ct.signature(),
                                        frozenset(ct.positions_needed),
                                        frozenset(ct.vectors_needed))
                                groups.setdefault(gkey, []).append(
                                    (qid, emit, ct.values))
                            for (_sig, pos, vecs), rows in groups.items():
                                lane_list.append(
                                    segment_exec.make_percolate_lane(
                                        dseg, rows[0][1], pos, vecs,
                                        [r[2] for r in rows], reader))
                                lane_owner.append(
                                    (it_idx, [r[0] for r in rows]))
                        # the shape-fallback lane: per-query eager execution
                        fb = [(qid, e) for qid, e in fallback_entries.items()
                              if participating is None
                              or qid in participating]
                        if fb:
                            searcher = ShardSearcher(
                                0, reader, self._mapper,
                                index_name=self.name)
                            for qid, entry in fb:
                                hit, best = _eager_match(searcher, entry.ast)
                                if hit:
                                    state["matched"][qid] = best
                            with self._lock:
                                self.stats["fallback_queries"] += len(fb)
                    finally:
                        self._restore_probe_mappers()
            except Exception as e:       # noqa: BLE001 — per-item contract
                state["err"] = e
        if lane_list:
            outs = segment_exec.run_percolate_lanes(lane_list)
            for (it_idx, qids), out in zip(lane_owner, outs):
                state = per_item[it_idx]
                if out.shape[0] == 1 and len(qids) > 1:
                    out = np.broadcast_to(out, (len(qids), 2))
                for qi, qid in enumerate(qids):
                    if out[qi, 0] > 0.5:
                        state["matched"][qid] = float(out[qi, 1])
            with self._lock:
                self.stats["fused_queries"] += sum(
                    len(qids) for _, qids in lane_owner)
        results = []
        for item, state in zip(items, per_item):
            if state["err"] is not None:
                results.append({"_exception": state["err"]})
                continue
            try:
                results.append(self._render(meta, item, state, order))
            except Exception as e:       # noqa: BLE001 — per-item contract
                results.append({"_exception": e})
        dt = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            self.stats["count"] += len(items)
            self.stats["time_ms"] += dt
        return results

    def _render(self, meta, item: dict, state: dict,
                order: list[str]) -> dict:
        matched = state["matched"]
        want_score = bool(item.get("score") or item.get("sort")
                          or item.get("track_scores"))
        qids = [qid for qid in order if qid in matched]
        if item.get("sort"):
            qids.sort(key=lambda qid: -matched[qid])
        total = len(qids)
        size = item.get("size")
        if size is not None:
            qids = qids[:int(size)]
        matches = []
        for qid in qids:
            m = {"_index": meta.name, "_id": qid}
            if want_score:
                m["_score"] = matched[qid]
            if item.get("highlight"):
                entry = self._entries.get(qid)
                if entry is not None:
                    hl = highlight_hit(item["highlight"], item["doc"],
                                       self._mapper, entry.ast)
                    if hl:
                        m["highlight"] = hl
            matches.append(m)
        out = {"total": total, "matches": matches}
        if item.get("aggs"):
            aggregations = self._collect_aggs(item["aggs"], set(matched))
            if aggregations is not None:
                out["aggregations"] = aggregations
        return out

    # ---- introspection -----------------------------------------------------

    def bucket_generations(self) -> dict:
        with self._lock:
            return dict(self._bucket_gen)

    def stats_dict(self) -> dict:
        with self._lock:
            return {**{k: (round(v, 3) if isinstance(v, float) else v)
                       for k, v in self.stats.items()},
                    "registered": len(self._entries),
                    "shape_buckets": len(self._buckets)}


def _scratch_mapper(meta, settings: Settings) -> MapperService:
    """A MapperService over the index's mappings that percolation may
    extend with a probe doc's dynamic fields without touching the index."""
    scratch = MapperService(AnalysisRegistry(settings))
    for t, m in (meta.mappings or {}).items():
        scratch.merge(t, m)
    scratch.default_similarity = settings.get(
        "index.similarity.default.type")
    return scratch


def _one_segment_reader(builder: SegmentBuilder, device):
    """→ (segment, DeviceReader over it alone, every doc live)."""
    seg = builder.build()
    mask = np.zeros(seg.padded_docs, dtype=bool)
    mask[:seg.num_docs] = True
    return seg, DeviceReader(SearcherView([seg], [mask], 1), device=device)


def _probe_reader(parsed, device):
    """One-doc scratch segment + device reader for a probe document."""
    builder = SegmentBuilder(seg_id=0)
    builder.add(parsed)
    return _one_segment_reader(builder, device)


def _matched_rows(searcher: ShardSearcher, ast, n: int) -> np.ndarray:
    """The first ``n`` rows' match mask of ``ast`` over a one-segment
    searcher, on the host."""
    matched = np.zeros(n, dtype=bool)
    for _, m in searcher._execute_query(ast):
        matched |= m.cpu().numpy()[:n]
    return matched


def _eager_match(searcher: ShardSearcher, ast) -> tuple[bool, float]:
    """Per-query eager evaluation: → (matched, best matching score)."""
    best = -np.inf
    hit = False
    for s, m in searcher._execute_query(ast):
        mnp = m.cpu().numpy()
        if mnp.any():
            hit = True
            best = max(best, float(s.cpu().numpy()[mnp].max()))
    return hit, (best if np.isfinite(best) else 0.0)


# ---------------------------------------------------------------------------
# module registry cache, keyed by (index name, device)
# ---------------------------------------------------------------------------

_REGISTRIES: dict[tuple[str, torch.device], PercolatorRegistry] = {}
_REG_LOCK = threading.Lock()
_REG_CAP = 64


def registry_for(meta, device=None) -> PercolatorRegistry:
    dev = resolve_device(device)
    with _REG_LOCK:
        reg = _REGISTRIES.get((meta.name, dev))
        if reg is None or reg.uuid != meta.uuid:
            reg = PercolatorRegistry(meta, dev)
            _REGISTRIES[(meta.name, dev)] = reg
            while len(_REGISTRIES) > _REG_CAP:
                _REGISTRIES.pop(next(iter(_REGISTRIES)))
    reg.sync(meta)
    return reg


def registry_stats(name: str, device=None) -> dict | None:
    """The stats of index ``name``'s registry on ``device``; None when the
    index has never percolated there."""
    with _REG_LOCK:
        reg = _REGISTRIES.get((name, resolve_device(device)))
    return reg.stats_dict() if reg is not None else None


def all_registry_stats() -> dict:
    """{index name: {device: stats_dict}} over every live registry."""
    with _REG_LOCK:
        regs = dict(_REGISTRIES)
    out: dict = {}
    for (name, dev), reg in sorted(regs.items(), key=lambda kv: (
            kv[0][0], str(kv[0][1]))):
        out.setdefault(name, {})[str(dev)] = reg.stats_dict()
    return out


def clear_registries() -> None:
    with _REG_LOCK:
        _REGISTRIES.clear()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def percolate(meta, doc: dict, queries: dict | None = None,
              size: int | None = None, reg_filter: dict | None = None,
              score: bool = False, sort: bool = False,
              highlight: dict | None = None,
              aggs: dict | None = None, device=None) -> dict:
    """Match `doc` against `meta.percolators` (or an explicit query map) on
    ``device`` (CUDA when None).
    → {"total": N, "matches": [{"_index", "_id"[, "_score", "highlight"]}
    ...][, "aggregations"]}"""
    if queries is not None:
        # explicit query map: no registry to key on
        return percolate_serial(meta, doc, queries, size=size,
                                reg_filter=reg_filter, score=score,
                                sort=sort, highlight=highlight,
                                device=device)
    out = percolate_many(meta, [{
        "doc": doc, "size": size, "reg_filter": reg_filter,
        "score": score, "sort": sort, "highlight": highlight,
        "aggs": aggs}], device=device)[0]
    if "_exception" in out:
        raise out["_exception"]
    return out


def percolate_many(meta, items: list[dict], device=None) -> list[dict]:
    """Batch percolation (_mpercolate): every item's fused lanes are reduced
    by one K10 launch. Items: {"doc", "size", "reg_filter", "score",
    "sort", "highlight", "aggs"}. Per-item errors come back as
    {"_exception": exc}."""
    return registry_for(meta, device).run(meta, items)


def percolate_serial(meta, doc: dict, queries: dict | None = None,
                     size: int | None = None,
                     reg_filter: dict | None = None, score: bool = False,
                     sort: bool = False, highlight: dict | None = None,
                     device=None) -> dict:
    """The per-query loop: the explicit-query-map path AND the oracle the
    batched registry is checked against (the same emit closures run one
    query at a time, a fresh scratch mapper)."""
    dev = resolve_device(device)
    queries = meta.percolators if queries is None else queries
    if queries and reg_filter is not None:
        queries = _filter_registrations(meta, queries, reg_filter, dev)
    if not queries:
        return {"total": 0, "matches": []}
    scratch = _scratch_mapper(meta, Settings(meta.settings))
    parsed = scratch.document_mapper().parse("_percolate_doc", doc)
    _seg, reader = _probe_reader(parsed, dev)
    searcher = ShardSearcher(0, reader, scratch, index_name=meta.name)
    matched: dict[str, float] = {}
    asts = {}
    for qid, body in queries.items():
        ast = parse_query(body.get("query"))
        asts[qid] = ast
        hit, best = _eager_match(searcher, ast)
        if hit:
            matched[qid] = best
    want_score = bool(score or sort)
    qids = [qid for qid in queries if qid in matched]
    if sort:
        qids.sort(key=lambda qid: -matched[qid])
    total = len(qids)
    if size is not None:
        qids = qids[:int(size)]
    matches = []
    for qid in qids:
        m = {"_index": meta.name, "_id": qid}
        if want_score:
            m["_score"] = matched[qid]
        if highlight:
            hl = highlight_hit(highlight, doc, scratch, asts[qid])
            if hl:
                m["highlight"] = hl
        matches.append(m)
    return {"total": total, "matches": matches}


def _filter_registrations(meta, queries: dict, reg_filter, device) -> dict:
    """A percolate request's `filter` keeps the registered queries whose
    registration documents (every field but the query) it matches: all go
    into ONE scratch segment and the filter runs once."""
    scratch = MapperService(AnalysisRegistry(Settings(meta.settings)))
    ids = list(queries)
    builder = SegmentBuilder(seg_id=0)
    for qid in ids:
        probe = {k: v for k, v in queries[qid].items() if k != "query"}
        builder.add(scratch.document_mapper().parse(str(qid), probe))
    seg, reader = _one_segment_reader(builder, device)
    searcher = ShardSearcher(0, reader, scratch, index_name=meta.name)
    matched = _matched_rows(searcher, parse_query(reg_filter), seg.num_docs)
    return {qid: queries[qid] for i, qid in enumerate(ids) if matched[i]}
