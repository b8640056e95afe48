"""Query phase and fetch phase (per shard).

Counterpart of ``elasticsearch_tpu/search/phase.py``. Reference split:
SearchService.executeQueryPhase/executeFetchPhase
(core/search/SearchService.java:293,385-504) with QueryPhase building the
collector stack and FetchPhase materializing `_source`
(core/search/query/QueryPhase.java:99-314, core/search/fetch/FetchPhase.java:98).

The query phase walks the segments of the shard's DeviceReader on the card:
per-segment scoring and top-k, then a merge of every segment's candidates
into the shard's top-k — only k (score, doc) pairs per request leave the
device. The fetch phase resolves winning global doc ids to _id/_source and
filters the source.

This slice serves score-ordered requests (``sort`` absent or ``_score``
desc), batched through :meth:`ShardSearcher.query_phase_batch` and one at a
time through :meth:`ShardSearcher.query_phase` (which also takes
``post_filter``, ``min_score`` and ``search_after``), and the top-level
``knn`` section (dense cosine in f32 or int8, rank_vectors MaxSim, alone or
fused with a ``query`` by RRF or a weighted sum) through the knn lane of
``segment_exec``. On an index that opted into the impact lane
(``index.search.impact_plane``), a batch the lane admits is served from the
quantized impact columns, as the JAX package's planner orders its arms: the
impact → rescore arm (a batch carrying ``rescore``), then the impact arm
(eager, or the block-max sweep when no request tracks its total), then the
exact arm. An arm that declines hands the batch to the next; every arm
declines a request carrying aggregations, which :meth:`ShardSearcher.
query_phase` serves one at a time: per segment its masks stay on the card
and ``search/aggregations`` collects each agg there (kernels K8 and K9) or,
for the shapes the JAX package keeps on the host, over the host mask. The
fetch phase highlights (``search/highlight.py``). Field sort, suggest,
terminate_after, timeout, script fields and a ``rescore`` that the impact
lane does not admit are refused with :class:`NotPortedError`.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    NotPortedError, QueryParsingError)
from elasticsearch_tpu_torch.index.device_reader import DeviceReader
from elasticsearch_tpu_torch.ops import topk as topk_ops
from elasticsearch_tpu_torch.search import query_dsl as q, segment_exec
from elasticsearch_tpu_torch.search.aggregations import (
    PIPELINE_AGGS, AggNode, DeviceAggState, ShardAggContext, collect,
    collect_device, note_agg_stat, parse_aggs)
from elasticsearch_tpu_torch.search.execute import (
    ExecutionContext, impact_terms)
from elasticsearch_tpu_torch.search.highlight import highlight_hit
from elasticsearch_tpu_torch.search.query_dsl import parse_query


@dataclass
class RescoreSpec:
    """One rescore pass (QueryRescorer): re-rank the top ``window_size``
    hits by combining the primary score with a rescore-query score."""
    query: q.Query
    window_size: int = 10
    query_weight: float = 1.0
    rescore_query_weight: float = 1.0
    score_mode: str = "total"          # total | multiply | avg | max | min


@dataclass
class ParsedSearchRequest:
    query: q.Query
    from_: int = 0
    size: int = 10
    sort: list = field(default_factory=list)       # [{"field": {"order": ...}}...]
    aggs: list[AggNode] = field(default_factory=list)
    post_filter: q.Query | None = None
    min_score: float | None = None
    source_filter: Any = True                      # True | False | includes spec
    highlight: dict | None = None
    search_after: list | None = None
    track_total_hits: bool = True
    explain: bool = False
    script_fields: dict = field(default_factory=dict)
    stored_fields: list = field(default_factory=list)
    docvalue_fields: list = field(default_factory=list)
    version: bool = False                          # render _version per hit
    terminate_after: int | None = None             # per-shard collected cap
    timeout_ms: float | None = None                # per-shard time budget
    # top-level "knn" search section (dense / late-interaction lane;
    # combined with `query` → hybrid fusion)
    knn: q.KnnSection | None = None
    rescore: list[RescoreSpec] = field(default_factory=list)


def parse_search_request(body: dict | None) -> ParsedSearchRequest:
    body = body or {}
    req = ParsedSearchRequest(query=parse_query(body.get("query")))
    req.from_ = int(body.get("from", 0))
    req.size = int(body.get("size", 10))
    raw_sort = body.get("sort", [])
    if isinstance(raw_sort, (str, dict)):
        raw_sort = [raw_sort]
    for s in raw_sort:
        if isinstance(s, str):
            req.sort.append({s: {"order": "desc" if s == "_score" else "asc"}})
        else:
            req.sort.append({k: ({"order": v} if isinstance(v, str) else v)
                             for k, v in s.items()})
    if body.get("knn") is not None:
        _check_knn_combination(body, req.sort)
    if body.get("suggest"):
        raise NotPortedError("[suggest] is not ported yet")
    req.aggs = parse_aggs(body.get("aggs", body.get("aggregations")))
    if "post_filter" in body:
        req.post_filter = parse_query(body["post_filter"])
    if body.get("min_score") is not None:
        req.min_score = float(body["min_score"])
    req.source_filter = body.get("_source", True)
    req.highlight = body.get("highlight")
    req.search_after = body.get("search_after")
    req.explain = bool(body.get("explain", False))
    req.version = bool(body.get("version", False))
    req.script_fields = body.get("script_fields", {})
    raw_dvf = body.get("fielddata_fields", body.get("docvalue_fields", []))
    req.docvalue_fields = [raw_dvf] if isinstance(raw_dvf, str) \
        else list(raw_dvf)
    req.stored_fields = body.get("stored_fields", body.get("fields", []))
    if isinstance(req.stored_fields, str):
        req.stored_fields = [req.stored_fields]
    if req.stored_fields and "_source" not in body:
        # `fields` without an explicit _source suppresses the source
        # (FetchSourceContext.DO_NOT_FETCH_SOURCE unless "_source" listed)
        if "_source" in req.stored_fields:
            req.stored_fields = [f for f in req.stored_fields
                                 if f != "_source"]
        else:
            req.source_filter = False
    if body.get("terminate_after"):
        req.terminate_after = int(body["terminate_after"])
    tth = body.get("track_total_hits")
    if tth is not None and str(tth).lower() in ("false", "0"):
        req.track_total_hits = False
    if body.get("timeout") is not None:
        from elasticsearch_tpu_torch.common.settings import parse_time_value
        req.timeout_ms = parse_time_value(body["timeout"], "timeout") * 1000.0
    raw_rescore = body.get("rescore")
    if raw_rescore:
        if isinstance(raw_rescore, dict):
            raw_rescore = [raw_rescore]
        for spec in raw_rescore:
            inner = spec.get("query", {})
            if "rescore_query" not in inner:
                raise QueryParsingError("rescore requires [rescore_query]")
            mode = str(inner.get("score_mode", "total")).lower()
            if mode not in ("total", "multiply", "avg", "max", "min"):
                raise QueryParsingError(
                    f"illegal rescore score_mode [{mode}]")
            req.rescore.append(RescoreSpec(
                query=parse_query(inner["rescore_query"]),
                window_size=int(spec.get("window_size", 10)),
                query_weight=float(inner.get("query_weight", 1.0)),
                rescore_query_weight=float(
                    inner.get("rescore_query_weight", 1.0)),
                score_mode=mode))
        if req.sort:
            raise QueryParsingError(
                "rescore cannot be combined with sort (QueryRescorer "
                "re-ranks by score)")
    if body.get("knn") is not None:
        req.knn = q.parse_knn_section(body["knn"])
        req.knn.hybrid = "query" in body
    return req


def _check_knn_combination(body: dict, sort: list) -> None:
    """The knn section composes with from/size, _source/fields and its own
    ``filter``; request features that would need fused score arrays over
    the whole corpus are a 400 up front, as in the JAX package."""
    bad = [label for cond, label in (
        (bool(sort) and not _is_score_order(sort), "sort"),
        (bool(body.get("aggs") or body.get("aggregations")), "aggs"),
        ("post_filter" in body, "post_filter"),
        (body.get("min_score") is not None, "min_score"),
        (body.get("search_after") is not None, "search_after"),
        (bool(body.get("rescore")), "rescore"),
        (bool(body.get("suggest")), "suggest"),
        (bool(body.get("terminate_after")), "terminate_after"),
    ) if cond]
    if bad:
        raise QueryParsingError(
            f"[knn] cannot be combined with {bad} — use the knn section's "
            f"own [filter] for filtering")


def _is_score_order(sort: list) -> bool:
    """True iff results follow the default (_score desc) order: no sort, or
    exactly [{"_score": {"order": "desc"}}]."""
    if not sort:
        return True
    if len(sort) != 1 or "_score" not in sort[0]:
        return False
    return sort[0]["_score"].get("order", "desc") == "desc"


def _not_ported_features(req: ParsedSearchRequest) -> list[str]:
    """Request features the port's query phase does not serve yet."""
    return [label for cond, label in (
        (not _is_score_order(req.sort), "sort"),
        (req.terminate_after is not None, "terminate_after"),
        (req.timeout_ms is not None, "timeout"),
    ) if cond]


def _top_k_window(reqs: list[ParsedSearchRequest], windows=()) -> int:
    """Hits a shard collects for the batch: the largest from + size (or
    rescore window)."""
    k = max(max(req.from_ + req.size, 1) for req in reqs)
    return max([k, *windows])


@dataclass
class ShardQueryResult:
    shard_id: int
    total: int
    max_score: float | None
    # top hits as host arrays
    doc_ids: np.ndarray            # global (reader-local) doc ids
    scores: np.ndarray             # f32 scores
    sort_values: list[list] | None  # per hit, when sort-by-field
    agg_partials: dict
    reader: DeviceReader
    terminated_early: bool = False
    timed_out: bool = False


class ShardSearcher:
    """Per-shard query execution over a DeviceReader."""

    def __init__(self, shard_id: int, reader: DeviceReader, mapper_service,
                 index_name: str = "", dfs_stats: dict | None = None,
                 version_fn=None):
        self.shard_id = shard_id
        self.reader = reader
        self.mapper_service = mapper_service
        # doc_id → live version (engine.doc_version) for version:true hits
        self.version_fn = version_fn
        self.ctx = ExecutionContext(reader=reader,
                                    mapper_service=mapper_service,
                                    dfs_stats=dfs_stats,
                                    index_name=index_name or None)

    # -- query phase ---------------------------------------------------------

    def query_phase(self, req: ParsedSearchRequest) -> ShardQueryResult:
        """One score-ordered request: the batched path with B = 1 when the
        request is eligible, else one pass per segment (post_filter,
        min_score, search_after, aggregations) and a merge of their
        candidates, the aggregations collected over the pre-post_filter
        masks."""
        bad = _not_ported_features(req)
        if bad:
            raise NotPortedError(f"the query phase of {bad} is not ported "
                                 f"yet")
        if req.knn is not None:
            return self._knn_query_phase(req)
        fast = self.query_phase_batch([req])
        if fast is not None:
            return fast[0]
        if req.rescore:
            raise NotPortedError(
                "[rescore] is ported only on the impact lane: this request "
                "is not one the lane admits")
        k = _top_k_window([req])
        outs = [(seg, segment_exec.run_segment(
            seg, self.ctx, req.query, post_filter=req.post_filter,
            min_score=req.min_score,
            search_after=None if req.sort else req.search_after, k=k,
            want_arrays=bool(req.aggs)))
            for seg in self.reader.segments]
        total = int(sum(o["count"] for _, o in outs))
        # the partial-results modes that skip segments are refused above,
        # so every segment contributes its masks
        agg_partials = self._collect_aggs(
            req, [o["agg_mask"] for _, o in outs],
            [o["scores"] for _, o in outs]) if req.aggs else {}
        return self._finish_score_order(
            k, total, [o["top_scores"] for _, o in outs],
            [o["top_docs"] for _, o in outs],
            [seg.doc_base for seg, _ in outs], agg_partials)

    def query_phase_batch(self, reqs: list[ParsedSearchRequest]
                          ) -> list[ShardQueryResult] | None:
        """Batched query phase: execute B score-ordered requests as one
        scoring launch and one top-k launch per segment plus one batched
        cross-segment merge. Returns None when the batch is ineligible
        (aggs / post_filter / min_score / search_after, or a feature not
        ported) or the queries don't share one plan signature — the caller
        then falls back to per-request :meth:`query_phase`.

        Implemented as launch + drain, as in the JAX package."""
        handle = self.query_phase_batch_launch(reqs)
        if handle is None:
            return None
        return self.query_phase_batch_drain(handle)

    def query_phase_batch_launch(self, reqs: list[ParsedSearchRequest]):
        """Phase 1: eligibility screen and the device work, without waiting
        for it. → an opaque handle for :meth:`query_phase_batch_drain`, or
        None when the batch is ineligible.

        The arms in the JAX planner's tier order: an all-knn batch takes
        the knn lane (a mixed batch declines: the caller serves each request
        alone); otherwise the impact → rescore arm when a request carries
        ``rescore``, then the impact arm, then the exact arm, each arm's
        decline (None) handing the batch to the next. An error on the card
        propagates: no arm falls back on one."""
        if not reqs:
            return ("empty", [])
        if any(r.knn is not None for r in reqs):
            if not all(r.knn is not None for r in reqs):
                return None
            return self._knn_batch_launch(reqs)
        if any(r.rescore for r in reqs):
            handle = self._rescore_batch_launch(reqs)
            if handle is not None:
                return handle
        handle = self._impact_batch_launch(reqs)
        if handle is not None:
            return handle
        return self._exact_batch_launch(reqs)

    def _exact_batch_launch(self, reqs: list):
        """The exact batched arm: eligibility screen + one reader batch."""
        for req in reqs:
            if _not_ported_features(req) or req.aggs \
                    or req.post_filter is not None \
                    or req.min_score is not None \
                    or req.search_after is not None or req.rescore:
                return None
        k = _top_k_window(reqs)
        if not self.reader.segments:
            return ("empty", reqs)
        # doc ids and counts survive the packed f32 layout exactly only
        # below 2^24
        pack = self.reader.max_doc < (1 << 24)
        out = segment_exec.run_reader_batch(
            self.reader.segments, self.ctx, [req.query for req in reqs],
            k=k, pack=pack)
        if out is None:                   # mixed plan signatures
            return None
        return ("device", reqs, k, pack, out)

    # -- the impact lane (index.search.impact_plane) --------------------------

    def _impact_batch_launch(self, reqs: list):
        """The impact arm: serve the batch from the quantized impact columns
        (segment_exec.run_impact_batch), by the block-max sweep when no
        request tracks its total (run_impact_pruned). → a drain handle, or
        None when the index did not opt in or the batch is not the lane's;
        a decline is counted under its reason
        (segment_exec.note_impact_fallback)."""
        cfg = segment_exec.impact_plane_config(self.ctx.index_name)
        if cfg is None or not self.reader.segments:
            return None
        decline = segment_exec.note_impact_fallback
        if self.ctx.dfs_stats is not None:
            # impacts bake the reader's idf; DFS statistics would score
            # with another
            decline("dfs-stats")
            return None
        specs = []
        for req in reqs:
            if (_not_ported_features(req) or req.aggs
                    or req.post_filter is not None
                    or req.min_score is not None or req.rescore
                    or req.explain):
                decline("ineligible-shape")
                return None
            if req.search_after is not None and \
                    len(req.search_after) not in (1, 2):
                decline("ineligible-cursor")
                return None
            spec = impact_terms(req.query, self.mapper_service,
                                max_terms=cfg.max_terms)
            if spec is None:
                decline("ineligible-query")
                return None
            specs.append(spec)
        pack = self._impact_pack(cfg, {f for f, _, _ in specs})
        if pack is None:
            return None
        k = _top_k_window(reqs)
        term_lists = [terms for _, terms, _ in specs]
        boosts = [boost for _, _, boost in specs]
        prune = cfg.prune and all(req.track_total_hits is False
                                  for req in reqs)
        # the continuation compares QUANTIZED scores: a cursor the exact
        # scorer (or another quantization) minted would skip or repeat hits
        cursors = []
        for req, terms, boost in zip(reqs, term_lists, boosts):
            if req.search_after is None:
                cursors.append(None)
                continue
            cur = segment_exec.verify_impact_cursor(pack, terms, boost,
                                                    req.search_after)
            if cur is None:
                decline("cross-lane-cursor")
                return None
            cursors.append(cur)
        prune = prune and pack.can_prune     # block tables over budget
        run = segment_exec.run_impact_pruned if prune \
            else segment_exec.run_impact_batch
        packed = self.reader.max_doc < (1 << 24)
        out = run(pack, term_lists, boosts, cursors, k=k, packed=packed)
        return ("impact", reqs, k, packed, out, prune, pack.total_blocks)

    def _impact_pack(self, cfg, fields: set, admit: bool = True):
        """The screen both impact arms end with: their queries on one field
        (else the decline ``mixed-fields``), then, when ``admit``, that
        field's impact pack for this searcher's BM25 (else
        ``no-impact-columns``). → the pack, or None."""
        if len(fields) != 1:
            segment_exec.note_impact_fallback("mixed-fields")
            return None
        if not admit:
            return None
        pack = segment_exec.impact_pack_for(
            self.reader, next(iter(fields)), cfg, k1=self.ctx.bm25.k1,
            b=self.ctx.bm25.b)
        if pack is None:
            segment_exec.note_impact_fallback("no-impact-columns")
        return pack

    def _rescore_batch_launch(self, reqs: list):
        """The impact → rescore arm (segment_exec.run_impact_rescore): the
        eager impact arm's candidates, their rescore-query scores and the
        window combine and re-sort, all on the device. Admission: the index
        opted into the impact lane; every request carries exactly one
        rescore pass, with one score_mode for the batch; the query and the
        rescore query are impact-scorable on one field; no cursor. → a
        drain handle or None (the impact and exact arms then screen the
        batch, and both decline a rescore)."""
        cfg = segment_exec.impact_plane_config(self.ctx.index_name)
        if cfg is None or not self.reader.segments or \
                self.ctx.dfs_stats is not None:
            return None
        specs, specs2, windows, qws, rws, modes = [], [], [], [], [], []
        for req in reqs:
            if (len(req.rescore) != 1 or req.aggs
                    or _not_ported_features(req)
                    or req.post_filter is not None
                    or req.min_score is not None or req.explain
                    or req.search_after is not None):
                return None
            rs = req.rescore[0]
            spec = impact_terms(req.query, self.mapper_service,
                                max_terms=cfg.max_terms)
            spec2 = impact_terms(rs.query, self.mapper_service,
                                 max_terms=cfg.max_terms)
            if spec is None or spec2 is None:
                segment_exec.note_impact_fallback("ineligible-query")
                return None
            specs.append(spec)
            specs2.append(spec2)
            windows.append(int(rs.window_size))
            qws.append(float(rs.query_weight))
            rws.append(float(rs.rescore_query_weight))
            modes.append(rs.score_mode)
        # one score_mode a batch, screened after the field as the
        # reference does
        pack = self._impact_pack(
            cfg, {f for f, _, _ in specs} | {f for f, _, _ in specs2},
            admit=len(set(modes)) == 1)
        if pack is None:
            return None
        k = _top_k_window(reqs, windows)
        packed = self.reader.max_doc < (1 << 24)
        out = segment_exec.run_impact_rescore(
            pack, [t for _, t, _ in specs], [bo for _, _, bo in specs],
            [t for _, t, _ in specs2], [bo for _, _, bo in specs2],
            windows, qws, rws, modes[0], k=k, packed=packed)
        return ("rescore", reqs, k, packed, out, False, pack.total_blocks)

    # -- dense / late-interaction lane (top-level "knn" section) ------------

    def _validate_knn(self, knn: q.KnnSection) -> None:
        """Mapping validation: the field must be mapped dense_vector (flat
        query_vector) or rank_vectors (list of vectors), and the query's
        dims must match the mapping — a 400 before any device work."""
        fm = self.mapper_service.field_mapper(knn.field)
        kind = getattr(fm, "kind", None)
        if fm is None or kind not in ("vector", "mvector"):
            raise QueryParsingError(
                f"[knn] field [{knn.field}] is not mapped as "
                f"dense_vector or rank_vectors")
        if knn.multi and kind != "mvector":
            raise QueryParsingError(
                f"[knn] field [{knn.field}] is dense_vector but "
                f"query_vector is a list of vectors — flat [dims] "
                f"expected")
        if not knn.multi and kind != "vector":
            raise QueryParsingError(
                f"[knn] field [{knn.field}] is rank_vectors — "
                f"query_vector must be a list of [dims] token vectors")
        dims = int(getattr(fm, "dims", 0))
        qdims = len(knn.query_vector[0]) if knn.multi \
            else len(knn.query_vector)
        if qdims != dims:
            raise QueryParsingError(
                f"[knn] query_vector dims [{qdims}] != mapped dims "
                f"[{dims}] of field [{knn.field}]")

    @staticmethod
    def _knn_limit(req: ParsedSearchRequest) -> int:
        """Hits a knn request may return: the from/size window, capped by
        the section's k for pure knn (k IS "how many neighbors"); hybrid
        windows read from the fused list."""
        lim = max(req.from_ + req.size, 1)
        return lim if req.knn.hybrid else min(lim, req.knn.k)

    def _knn_batch_launch(self, reqs: list):
        """The knn lane: B knn / hybrid requests through
        segment_exec.run_knn_hybrid_batch. → a drain handle, or None when
        the batch does not share one shape or plan signature (the caller
        serves each request alone). Mapping violations raise
        QueryParsingError."""
        for r in reqs:
            self._validate_knn(r.knn)
        if any(_not_ported_features(r) or r.aggs for r in reqs):
            return None
        if not self.reader.segments:
            return ("empty", reqs)
        knns = [r.knn for r in reqs]
        if len({(kn.field, kn.hybrid, kn.multi, kn.num_candidates)
                for kn in knns}) != 1:
            return None
        cfg = segment_exec.knn_plane_config(self.ctx.index_name)
        k = max(self._knn_limit(r) for r in reqs)
        pack = segment_exec.vector_pack_for(self.reader, knns[0].field, cfg)
        if pack is None and not knns[0].hybrid:
            # mapped, but no segment carries a vector: no hit, total 0
            return ("empty", reqs)
        if pack is not None and pack.multi != knns[0].multi:
            return None
        packed = self.reader.max_doc < (1 << 24)   # as the exact arm
        out = segment_exec.run_knn_hybrid_batch(
            self.reader, self.ctx, reqs, pack, cfg, k=k,
            num_candidates=knns[0].num_candidates, packed=packed)
        if out is None:                   # mixed plan signatures
            return None
        return ("knn", reqs, k, packed, out)

    def _knn_query_phase(self, req: ParsedSearchRequest) -> ShardQueryResult:
        """One knn / hybrid request: the knn lane with B = 1."""
        handle = self._knn_batch_launch([req])
        if handle is None:
            raise NotPortedError("the eager knn lane is not ported: this "
                                 "request's shape has no knn-lane program")
        return self.query_phase_batch_drain(handle)[0]

    def query_phase_batch_drain(self, handle) -> list[ShardQueryResult]:
        """Phase 2: wait for the launched batch's results on the host (one
        device→host copy when packed) and build per-request results."""
        tag, reqs = handle[0], handle[1]
        if tag == "empty":
            return [ShardQueryResult(self.shard_id, 0, None,
                                     np.zeros(0, np.int32),
                                     np.zeros(0, np.float32), None, {},
                                     self.reader) for _ in reqs]
        k, pack, out = handle[2], handle[3], handle[4]
        if pack:
            host = out.cpu().numpy()
            ms, md, totals = topk_ops.unpack_batch_result(host, k)
        else:
            host = {name: v.cpu().numpy() for name, v in out.items()}
            ms, md, totals = (host["top_scores"], host["top_docs"],
                              host["count"])
        if tag in ("impact", "rescore"):
            pruned, total_blocks = handle[5], handle[6]
            if pruned:
                scored, skipped = (
                    int(host[:, 2 * k + 1 + i].sum()) if pack
                    else int(host[name].sum())
                    for i, name in enumerate(("blocks_scored",
                                              "blocks_skipped")))
            else:
                # the eager arm (and the rescore arm's first stage) scores
                # every block
                scored, skipped = total_blocks * len(reqs), 0
            segment_exec.note_impact_served(self.ctx.index_name, len(reqs),
                                            scored, skipped)
        if tag == "knn":
            return [self._result(bi, ms, md, totals, self._knn_limit(req))
                    for bi, req in enumerate(reqs)]
        return [self._result(bi, ms, md, totals, max(req.from_ + req.size, 1))
                for bi, req in enumerate(reqs)]

    def _result(self, bi: int, ms, md, totals, kq: int) -> ShardQueryResult:
        """Row ``bi`` of a drained batch, cut to its first ``kq`` hits."""
        valid = md[bi] >= 0
        s_, d_ = ms[bi][valid][:kq], md[bi][valid][:kq]
        return ShardQueryResult(
            self.shard_id, int(totals[bi]), float(s_[0]) if s_.size else None,
            d_.astype(np.int32), s_.astype(np.float32), None, {}, self.reader)

    def _finish_score_order(self, k: int, total: int, seg_scores: list,
                            seg_docs: list, bases: list,
                            agg_partials: dict) -> ShardQueryResult:
        """Device merge of per-segment top-k → shard result."""
        if seg_scores:
            ms, md = topk_ops.merge_top_k_batch_body(
                [s[None] for s in seg_scores], [d[None] for d in seg_docs],
                k, bases)
            ms, md = ms[0].cpu().numpy(), md[0].cpu().numpy()
            valid = md >= 0
            ms, md = ms[valid], md[valid]
        else:
            ms, md = np.zeros(0, np.float32), np.zeros(0, np.int32)
        max_sc = float(ms[0]) if ms.size else None
        return ShardQueryResult(self.shard_id, total, max_sc, md, ms, None,
                                agg_partials, self.reader)

    # -- aggregations --------------------------------------------------------

    def _collect_aggs(self, req: ParsedSearchRequest, masks: list,
                      scores: list) -> dict:
        """Run the top-level agg collectors over the (pre-post_filter)
        masks. ``masks`` / ``scores`` are per-segment tensors on the reader's
        device: the device path (collect_device) reduces there and copies
        only bucket / scalar results; the shapes it does not serve go to the
        numpy collectors, which materialize the host mask once, lazily."""
        state = DeviceAggState(self.reader, masks, scores)
        out = {}
        np_ctx = None
        for node in req.aggs:
            if node.type in PIPELINE_AGGS:
                continue
            partial = collect_device(node, state)
            if partial is None:
                note_agg_stat("host_fallbacks")
                if np_ctx is None:
                    np_ctx = ShardAggContext(
                        self.reader, self._filter_masks_np,
                        scores=state.np_scores())
                partial = collect(node, state.np_mask(), np_ctx)
            out[node.name] = partial
        return out

    def _filter_masks_np(self, query: q.Query) -> np.ndarray:
        """Filter-context mask of ``query`` over the reader (live rows),
        computed on each call: the JAX package memoizes it per reader as
        Lucene's filter cache does (IndicesQueryCache.java:48); the port
        leaves that out until a workload repeats filter aggs."""
        masks = [segment_exec.match_mask(seg, self.ctx, query)
                 for seg in self.reader.segments]
        return np.concatenate([m.cpu().numpy() for m in masks]) \
            if masks else np.zeros(0, bool)

    def _execute_query(self, query: q.Query) -> list:
        """→ one (scores [Np] f32, mask [Np] bool) pair a segment, the mask
        live rows only, each query run alone (the JAX package's eager
        per-segment execute; join queries are refused, so there is no join
        rewrite)."""
        return [segment_exec.execute(seg, self.ctx, query)
                for seg in self.reader.segments]

    # -- fetch phase ---------------------------------------------------------

    def fetch_phase(self, req: ParsedSearchRequest, result: ShardQueryResult,
                    index_name: str, positions: list[int]) -> list[dict]:
        from elasticsearch_tpu_torch.index.engine import _segment_meta
        if req.script_fields:
            raise NotPortedError("[script_fields] is not ported yet")
        meta_wanted = [f for f in req.stored_fields
                       if f in ("_routing", "_parent", "_timestamp", "_ttl")]
        hits = []
        for pos in positions:
            gid = int(result.doc_ids[pos])
            seg, local = self.reader.resolve(gid)
            src = seg.seg.sources[local]
            meta = _segment_meta(seg.seg, local) or {}
            emit_score = result.sort_values is None or any(
                "_score" in spec for spec in req.sort)
            hit = {
                "_index": index_name,
                "_type": meta.get("_type", "_doc"),
                "_id": seg.seg.ids[local],
                "_score": (float(result.scores[pos]) if emit_score else None),
            }
            if req.version:
                # point-in-time version from the segment's _version column;
                # the live map is only a fallback
                v = meta.get("_version")
                if v is None and self.version_fn is not None:
                    v = self.version_fn(hit["_id"])
                if v is not None:
                    hit["_version"] = v
            for f in meta_wanted:
                if meta.get(f) is not None:
                    hit[f] = meta[f]
            if result.sort_values is not None:
                hit["sort"] = result.sort_values[pos]
            filtered = _filter_source(src, req.source_filter)
            if filtered is not None:
                hit["_source"] = filtered
            if req.highlight:
                hl = highlight_hit(req.highlight, src, self.mapper_service,
                                   req.query)
                if hl:
                    hit["highlight"] = hl
            if req.stored_fields or req.docvalue_fields:
                fields = {}
                for f in list(req.stored_fields) + list(
                        req.docvalue_fields):
                    v = src.get(f)
                    if v is None and "." in f:   # dotted path into objects
                        node = src
                        for part in f.split("."):
                            node = node.get(part) \
                                if isinstance(node, dict) else None
                            if node is None:
                                break
                        v = node
                    if v is not None and not isinstance(v, dict):
                        fields[f] = v if isinstance(v, list) else [v]
                if fields:
                    hit["fields"] = fields
            hits.append(hit)
        return hits


def _filter_source(src: dict, spec) -> dict | None:
    """_source filtering with DOTTED-PATH globs (ref:
    FetchSourceContext/XContentMapValues.filter): an include pattern
    matching an object path keeps the whole subtree; patterns reach into
    nested objects ("obj.inner.field", "obj.*")."""
    if spec is True:
        return src
    if spec is False:
        return None
    if isinstance(spec, str):
        spec = [spec]
    if isinstance(spec, list):
        includes, excludes = spec, []
    else:
        includes = spec.get("includes", spec.get("include", []))
        excludes = spec.get("excludes", spec.get("exclude", []))
        if isinstance(includes, str):
            includes = [includes]
        if isinstance(excludes, str):
            excludes = [excludes]
    if not includes and not excludes:
        return src

    def prefixes(path: str) -> list[str]:
        parts = path.split(".")
        return [".".join(parts[:i + 1]) for i in range(len(parts))]

    def included(path: str) -> bool:
        if not includes:
            return True
        return any(fnmatch.fnmatch(p, pat)
                   for pat in includes for p in prefixes(path))

    def deeper_include(path: str) -> bool:
        """An include pattern may target something BELOW this object."""
        return any(pat.startswith(path + ".") or
                   fnmatch.fnmatch(path, ".".join(
                       pat.split(".")[:len(path.split("."))]))
                   for pat in includes)

    def excluded(path: str) -> bool:
        return any(fnmatch.fnmatch(p, pat)
                   for pat in excludes for p in prefixes(path))

    def filter_value(v, path: str):
        """→ (keep, filtered value) for one field value at `path` —
        arrays of objects filter element-wise."""
        if isinstance(v, dict):
            if included(path):
                return True, (walk(v, path) if excludes else v)
            if includes and deeper_include(path):
                sub = walk(v, path)
                return bool(sub), sub
            return False, None
        if isinstance(v, list) and any(isinstance(el, dict) for el in v):
            out = []
            for el in v:
                if isinstance(el, dict):
                    keep, sub = filter_value(el, path)
                    if keep:
                        out.append(sub)
                elif included(path):
                    out.append(el)
            return bool(out), out
        return included(path), v

    def walk(obj: dict, prefix: str) -> dict:
        out = {}
        for k, v in obj.items():
            path = f"{prefix}.{k}" if prefix else k
            if excluded(path):
                continue
            keep, sub = filter_value(v, path)
            if keep:
                out[k] = sub
        return out

    return walk(src, "")
