"""Batched query execution over a reader's segments.

Counterpart of ``elasticsearch_tpu/search/jit_exec.py`` (``_plan``,
``_build``, ``run_segment``, ``_plan_segment_batch``, ``run_reader_batch``).
The JAX package compiles one fused XLA program per (plan, layout) and runs a
batch under ``jax.vmap``; this port runs eagerly — nothing here is jitted
and there is no program cache — with the batch written out as a leading
axis:

1. **plan** — host resolve of every query against every segment
   (execute.SegmentResolver) into a ConstTable and emit closures; queries of
   one batch must share one plan signature. The text fields whose position
   matrix the plan reads (``ConstTable.positions_needed``: phrase queries)
   are put on the device now, once per reader (as the JAX package's
   ``seg_flatten`` fetches its lazy columns); no other plan uploads them.
2. **stack** — the batch's constants go to the device stacked ``[B, ...]``,
   one host→device copy per dtype (execute.stack_consts).
3. **run** — per segment, ONE scoring launch for the whole batch (kernel K1
   for a BM25 match) and ONE top-k launch (kernel K2); then ONE K2 launch
   merges the segments' candidates, concatenated in segment order after
   each segment's ``doc_base`` is added (TopDocs.merge's tie order), and the
   result packs into one ``[B, 2k+1]`` tensor for a single device→host copy.

The knn lane (the knn section of ``jit_exec.py``) serves the top-level
``knn`` section: per segment the vector column is scored for the batch (a
dense f32 cosine is one ``torch.matmul``; int8 is kernel K4, rank_vectors
MaxSim kernel K5), masked by exists ∧ live ∧ the section's ``filter``, and
its top ``num_candidates`` kept (K2); the segments' candidates merge (K2),
and a request that also carries a ``query`` fuses the two candidate lists
by RRF or a weighted sum (:func:`run_knn_hybrid_batch`). The vector columns
go to the device at first use, one copy per (segment, field, quantization)
(``DeviceReader.fetch_vectors``).

The impact lane (the impact section of ``jit_exec.py``) serves an index that
opted in (``index.search.impact_plane``) from quantized impact columns built
on the host (``index/segment.build_impact_column``) and put on the device at
first use (``DeviceReader.fetch_impacts``): the eager arm scores every row
(kernel K6, then K2), the pruned arm sweeps the row blocks in descending
bound order and skips those that cannot reach the running k-th score (kernel
K7), and the rescore arm re-ranks the eager arm's window by a second impact
query (:func:`run_impact_batch`, :func:`run_impact_pruned`,
:func:`run_impact_rescore`).

The percolate lanes (the percolate section of ``jit_exec.py``) serve
``search/percolator``: a lane is one probe doc's one-doc segment × one group
of registered queries that share a plan signature. Each lane's constants go
to the device stacked once and its emit runs once for the whole group
(``[B_l, Np]`` scores and mask); then ONE launch of kernel K10 reduces every
lane of the call to its per-query (flag, score) pairs, and ONE device→host
copy brings them back (:func:`run_percolate_lanes`).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.index.device_reader import DeviceSegment
from elasticsearch_tpu_torch.index.segment import (
    IMPACT_BITS, IMPACT_BLOCK_ROWS, build_impact_column)
from elasticsearch_tpu_torch.ops import blockmax as blockmax_ops
from elasticsearch_tpu_torch.ops import maxsim as maxsim_ops
from elasticsearch_tpu_torch.ops import percolate as percolate_ops
from elasticsearch_tpu_torch.ops import topk as topk_ops
from elasticsearch_tpu_torch.ops import vector as vector_ops
from elasticsearch_tpu_torch.search.execute import (
    ConstTable, EmitCtx, ExecutionContext, SegmentResolver, stack_consts)


def _plan(seg: DeviceSegment, ctx: ExecutionContext, query, post_filter,
          flags):
    """Host resolve → (ConstTable, emit_q, emit_pf mask-emit, flag refs)."""
    ct = ConstTable()
    resolver = SegmentResolver(seg, ctx, ct)
    emit_q = resolver.resolve(query)
    emit_pf = resolver.resolve_mask(post_filter) \
        if post_filter is not None else None
    refs = {}
    if flags["min_score"]:
        refs["min_score"] = ct.add(flags["_min_score"], np.float32)
    if flags["search_after"]:
        refs["sa_score"] = ct.add(flags["_sa_score"], np.float32)
        refs["sa_doc"] = ct.add(flags["_sa_doc"], np.int32)
        refs["doc_base"] = ct.add(flags["_doc_base"], np.int32)
    return ct, emit_q, emit_pf, refs


def _fetch_lazy(seg: DeviceSegment, reader, positions, vectors) -> None:
    """Put the position matrices and normalized vector matrices a plan
    reads (its ConstTable's ``positions_needed`` and ``vectors_needed``) on
    the device (a no-op once the reader holds them)."""
    for field in sorted(positions):
        reader.fetch_tokens(seg, field)
    for field in sorted(vectors):
        reader.fetch_vectors(seg, field, "f32")


def _build(view: DeviceSegment, consts, emit_q, emit_pf, refs, k: int,
           batch: int, want_arrays: bool = False) -> dict:
    """The batch body: emit + phase post-processing + top-k → {"count",
    "top_scores", "top_docs"}, each with a leading batch axis; top_docs are
    segment-local. ``want_arrays`` adds the aggregations' inputs: "scores",
    "mask" (after post_filter and the cursor) and "agg_mask" (after
    min_score, before post_filter — ES computes aggs on the main query's
    result)."""
    em = EmitCtx(view, consts, batch)
    scores, mask = emit_q(em)
    mask = mask & view.live[None, :]
    if "min_score" in refs:
        mask = mask & (scores >= em.get(refs["min_score"])[:, None])
    if emit_pf is not None:
        mask_post = mask & emit_pf(em)
    else:
        mask_post = mask
    if "sa_score" in refs:
        last_score = em.get(refs["sa_score"])[:, None]
        last_doc = em.get(refs["sa_doc"])[:, None]
        ids = torch.arange(view.padded_docs, dtype=torch.int32,
                           device=em.device)[None, :] + \
            em.get(refs["doc_base"])[:, None]
        cont = (scores < last_score) | ((scores == last_score) &
                                        (ids > last_doc))
        mask_post = mask_post & cont
    ts, td = topk_ops.top_k(scores, mask_post, min(k, view.padded_docs), 0)
    outs = {"count": topk_ops.count_matches(mask_post), "top_scores": ts,
            "top_docs": td}
    if want_arrays:
        outs.update(scores=scores, mask=mask_post, agg_mask=mask)
    return outs


def run_segment(seg: DeviceSegment, ctx: ExecutionContext, query,
                *, k: int, post_filter=None, min_score=None,
                search_after=None, want_arrays: bool = False) -> dict:
    """Execute one query against one segment → {"count", "top_scores",
    "top_docs"[, "scores", "mask", "agg_mask"]} as device tensors without a
    batch axis; top_docs are segment-local (caller adds seg.doc_base)."""
    flags = {
        "min_score": min_score is not None,
        "_min_score": 0.0 if min_score is None else float(min_score),
        "search_after": search_after is not None,
        "_sa_score": 0.0 if search_after is None
        else float(search_after[0]),
        "_sa_doc": -1 if (search_after is None or len(search_after) < 2)
        else int(search_after[1]),
        "_doc_base": seg.doc_base,
    }
    ct, emit_q, emit_pf, refs = _plan(seg, ctx, query, post_filter, flags)
    _fetch_lazy(seg, ctx.reader, ct.positions_needed, ct.vectors_needed)
    consts = stack_consts([ct.values], ctx.reader.device) \
        if ct.values else []
    outs = _build(seg, consts, emit_q, emit_pf, refs, int(k), 1,
                  want_arrays)
    return {name: v[0] for name, v in outs.items()}


def execute(seg: DeviceSegment, ctx: ExecutionContext, query):
    """One query against one segment at batch 1 → (scores [Np] f32, mask
    [Np] bool) on the segment's device, the mask live rows only (the
    counterpart of the JAX package's ``SegmentExecutor.execute(query)``
    with the caller's live mask)."""
    ct = ConstTable()
    emit = SegmentResolver(seg, ctx, ct).resolve(query)
    _fetch_lazy(seg, ctx.reader, ct.positions_needed, ct.vectors_needed)
    consts = stack_consts([ct.values], ctx.reader.device) \
        if ct.values else []
    scores, mask = emit(EmitCtx(seg, consts, 1))
    return scores[0], (mask & seg.live[None, :])[0]


def match_mask(seg: DeviceSegment, ctx: ExecutionContext, query):
    """The filter-context match mask of ``query`` over one segment, live
    rows only → [Np] bool on the segment's device (the counterpart of the
    JAX package's ``SegmentExecutor.match_mask(query) & seg.live``)."""
    return execute(seg, ctx, query)[1]


def _plan_segment_batch(seg: DeviceSegment, ctx: ExecutionContext,
                        queries: list, k: int) -> dict | None:
    """Plan a batch of same-signature queries against one segment and stack
    their constants on the device. Returns None when the queries do not
    share one plan signature or the shared plan has no constants (callers
    fall back to per-query execution)."""
    if not queries:
        return None
    flags = {"min_score": False, "search_after": False}
    sig0 = emit0 = refs0 = ct0 = None
    consts_rows: list[list[np.ndarray]] = []
    for query in queries:
        ct, emit_q, _, refs = _plan(seg, ctx, query, None, flags)
        if sig0 is None:
            sig0, emit0, refs0, ct0 = ct.signature(), emit_q, refs, ct
        elif ct.signature() != sig0:
            return None
        consts_rows.append(ct.values)
    if not consts_rows[0]:
        # const-free plans (match_none / absent-field zeros): the per-query
        # path serves these (rare) shapes
        return None
    _fetch_lazy(seg, ctx.reader, ct0.positions_needed,
                ct0.vectors_needed)
    return {"seg": seg, "emit": emit0, "refs": refs0, "k": int(k),
            "consts": stack_consts(consts_rows, ctx.reader.device)}


def run_reader_batch(segments: list, ctx: ExecutionContext, queries: list,
                     *, k: int, pack: bool):
    """The whole reader's batched query phase: per segment one scoring
    launch and one top-k launch for the batch, then one merge launch over
    every segment's candidates, the hit-count sum, and (with ``pack``) the
    ``[B, 2k+1]`` packed result.

    Returns the packed ``[B, 2k+1]`` f32 tensor (``pack=True``; exact only
    while doc ids and counts stay below 2**24 — the caller checks max_doc),
    or ``{"top_scores", "top_docs", "count"}`` tensors. None when any
    segment's queries do not share one plan signature (caller falls back to
    per-query execution).
    """
    if not queries or not segments:
        return None
    plans = []
    for seg in segments:
        plan = _plan_segment_batch(seg, ctx, queries, k)
        if plan is None:
            return None
        plans.append(plan)
    b = len(queries)
    ts_list, td_list = [], []
    counts = None
    for plan in plans:
        outs = _build(plan["seg"], plan["consts"], plan["emit"], None,
                      plan["refs"], plan["k"], b)
        ts_list.append(outs["top_scores"])
        td_list.append(outs["top_docs"])
        counts = outs["count"] if counts is None else counts + outs["count"]
    bases = [int(seg.doc_base) for seg in segments]
    top_s, top_d = topk_ops.merge_top_k_batch_body(ts_list, td_list, int(k),
                                                   bases)
    if pack:
        return topk_ops.pack_batch_result_body(top_s, top_d, counts)
    return {"top_scores": top_s, "top_docs": top_d, "count": counts}


# --------------------------------------------------------------------------
# The knn / hybrid lane: the top-level ``knn`` search section (dense cosine
# over a dense_vector field, f32 or int8, or MaxSim over a rank_vectors
# field), optionally fused with a lexical query by RRF or a weighted sum.
# Counterpart of the knn section of jit_exec.py.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class KnnPlaneConfig:
    """Per-index knn-lane knobs (``index.knn.*`` / ``index.search.hybrid.*``
    settings). The ``knn`` search section itself is the opt-in."""
    quantization: str = "f32"      # f32 | int8
    fusion_mode: str = "rrf"       # rrf | weighted
    rank_constant: int = 60        # RRF k
    lexical_weight: float = 0.5    # weighted-sum lexical leg weight


#: index name → config (indices without an entry use the defaults)
_knn_configs: dict[str, KnnPlaneConfig] = {}


def validate_knn_settings(settings) -> KnnPlaneConfig:
    """Validate the ``index.knn.*`` / ``index.search.hybrid.*`` knobs,
    raising the create-index-time 400 (IllegalArgumentError) on a bad
    value."""
    get = settings.get if settings is not None else (lambda *_: None)
    quant = str(get("index.knn.quantization", "f32") or "f32").lower()
    if quant not in ("f32", "int8"):
        raise IllegalArgumentError(
            f"index.knn.quantization must be f32 or int8, got [{quant}]")
    mode = str(get("index.search.hybrid.mode", "rrf") or "rrf").lower()
    if mode not in ("rrf", "weighted"):
        raise IllegalArgumentError(
            f"index.search.hybrid.mode must be rrf or weighted, "
            f"got [{mode}]")
    raw_k0 = get("index.search.hybrid.rank_constant", 60)
    try:
        k0 = int(60 if raw_k0 is None or raw_k0 == "" else raw_k0)
    except (TypeError, ValueError):
        raise IllegalArgumentError(
            f"index.search.hybrid.rank_constant must be an integer, "
            f"got [{raw_k0}]") from None
    if k0 < 1:
        raise IllegalArgumentError(
            f"index.search.hybrid.rank_constant must be >= 1, got {k0}")
    raw_w = get("index.search.hybrid.lexical_weight", 0.5)
    try:
        w = float(0.5 if raw_w is None or raw_w == "" else raw_w)
    except (TypeError, ValueError):
        raise IllegalArgumentError(
            f"index.search.hybrid.lexical_weight must be a number, "
            f"got [{raw_w}]") from None
    if not 0.0 <= w <= 1.0:
        raise IllegalArgumentError(
            f"index.search.hybrid.lexical_weight must be in [0, 1], "
            f"got {w}")
    return KnnPlaneConfig(quantization=quant, fusion_mode=mode,
                          rank_constant=k0, lexical_weight=w)


def configure_knn_plane(index_name: str, settings=None) -> None:
    """Register an index's knn-lane config from its settings."""
    _knn_configs[index_name] = validate_knn_settings(settings)


def knn_plane_config(index_name: str | None) -> KnnPlaneConfig:
    if index_name is None:
        return KnnPlaneConfig()
    return _knn_configs.get(index_name) or KnnPlaneConfig()


class _VectorPack:
    """A reader's knn columns for a (field, quantization): per segment the
    device vector array (f32, or int8 with its scale/offset snapshot) and
    masks, aligned 1:1 with the reader's segments (None for segments
    without the field)."""

    __slots__ = ("quant", "multi", "dims", "segs")

    def __init__(self, quant):
        self.quant = quant
        self.multi = False
        self.dims = 0
        self.segs = []          # per reader segment: dict | None

    def score_bound(self, qn) -> float:
        """Worst per-segment quantization score bound for one normalized
        query (0.0 under f32) — the int8 recall envelope: each component
        moves by at most scale/2, so a score by ``scale/2 · Σ|q|`` (summed
        over every query token for MaxSim)."""
        if self.quant != "int8":
            return 0.0
        qsum = float(np.abs(np.asarray(qn, np.float64)).sum())
        return max((s["scale"] * 0.5 * qsum for s in self.segs
                    if s is not None), default=0.0)


def vector_pack_for(reader, field: str,
                    cfg: KnnPlaneConfig) -> _VectorPack | None:
    """The knn pack of ``field`` under the config's quantization, over the
    reader's lazy device columns (:meth:`DeviceReader.fetch_vectors` puts
    each on the device once). None when no segment carries the field."""
    pack = _VectorPack(cfg.quantization)
    for dseg in reader.segments:
        col = reader.fetch_vectors(dseg, field, cfg.quantization)
        if col is None:
            pack.segs.append(None)
            continue
        pack.multi = field in dseg.mvector
        pack.dims = col.column.dims
        int8 = cfg.quantization == "int8"
        pack.segs.append({
            "vecs": col.qvecs if int8 else col.vecs,
            "exists": col.exists, "live": dseg.live,
            "lens": col.lens if pack.multi else None,
            "scale": col.scale if int8 else 1.0,
            "offset": col.offset if int8 else 0.0,
            "doc_base": int(dseg.doc_base)})
    if all(s is None for s in pack.segs):
        return None
    return pack


#: sort key of an empty candidate slot when partners are looked up
_NO_DOC = 1 << 62


def _fuse_lists(r_l, ld, r_d, dd, k: int):
    """Sum each doc's contributions from the two candidate lists and take
    the fused top-k by (score desc, doc asc).

    r_l / r_d: [B, C] f32 per-list contributions (0 on empty slots); ld / dd:
    [B, C] global doc ids (-1 empty), each list's ids unique. A doc in both
    lists gets ``r_l + r_d`` once, on its lexical slot; the knn slot goes
    empty. Each lexical candidate's partner comes from a sorted copy of the
    knn ids (``searchsorted``), never from a [B, C, C] comparison, and every
    sum has at most one nonzero term, so the fused scores are the reference's
    bit for bit. → (scores [B, k], docs [B, k], fused candidates [B])."""
    b, c = dd.shape
    key_d = torch.where(dd >= 0, dd.to(torch.int64), _NO_DOC)
    sorted_d, order = torch.sort(key_d, dim=1)
    key_l = ld.to(torch.int64).contiguous()
    pos = torch.searchsorted(sorted_d, key_l).clamp(max=c - 1)
    found = (ld >= 0) & (torch.gather(sorted_d, 1, pos) == key_l)
    partner = torch.gather(order, 1, pos)
    f_l = r_l + torch.where(found, torch.gather(r_d, 1, partner), 0.0)
    # each knn slot takes its lexical partner's contribution; the slots of
    # unmatched lexical candidates all land in a spare column, dropped
    slot = torch.where(found, partner, c)
    back = torch.zeros((b, c + 1), dtype=torch.float32, device=dd.device)
    back.scatter_(1, slot, torch.where(found, r_l, 0.0))
    dup = torch.zeros((b, c + 1), dtype=torch.bool, device=dd.device)
    dup.scatter_(1, slot, found)
    f_d = r_d + back[:, :c]
    dup_d = dup[:, :c]
    valid_l = ld >= 0
    keep_d = (dd >= 0) & ~dup_d
    s_l = torch.where(valid_l, f_l, float("-inf"))
    s_d = torch.where(keep_d, f_d, float("-inf"))
    count = valid_l.sum(dim=1, dtype=torch.int32) + \
        keep_d.sum(dim=1, dtype=torch.int32)
    ts, td = blockmax_ops.merge_topk_by_doc(s_l, ld, s_d, dd, k)
    return ts, td, count


def _rrf_fuse_body(ls, ld, ds, dd, boosts, k0: float, k: int):
    """Reciprocal-rank fusion of two candidate rankings.

    ls/ld: lexical (scores, GLOBAL doc ids) [B, C]; ds/dd: knn lane [B, C];
    boosts: [B] knn contribution multiplier. A doc's fused score is the f32
    sum of its per-list ``1/(k0 + rank + 1)`` contributions (the knn one
    times the boost). → (scores [B, k], docs [B, k], count [B])."""
    c = ld.shape[1]
    dev = ld.device
    rk = 1.0 / (torch.tensor(float(k0), dtype=torch.float32, device=dev)
                + torch.arange(c, dtype=torch.float32, device=dev) + 1.0)
    r_l = torch.where(ld >= 0, rk[None, :], 0.0)
    r_d = torch.where(dd >= 0, rk[None, :] * boosts[:, None], 0.0)
    return _fuse_lists(r_l, ld, r_d, dd, k)


def _weighted_fuse_body(ls, ld, ds, dd, boosts, w_lex: float, k: int):
    """Weighted-sum fusion: each list min-max-normalizes its candidate
    scores (the models/hybrid.py linear mode), then ``w·lex +
    (1-w)·boost·knn`` sums per doc. → (scores [B, k], docs [B, k],
    count [B])."""
    def norm(s, valid):
        lo = torch.where(valid, s, float("inf")).amin(dim=1, keepdim=True)
        hi = torch.where(valid, s, float("-inf")).amax(dim=1, keepdim=True)
        rng = hi - lo
        rng = torch.where((rng > 0) & torch.isfinite(rng), rng, 1.0)
        lo = torch.where(torch.isfinite(lo), lo, 0.0)
        return torch.where(valid, (s - lo) / rng, 0.0)
    w = torch.tensor(float(w_lex), dtype=torch.float32, device=ld.device)
    r_l = w * norm(ls, ld >= 0)
    r_d = (1.0 - w) * boosts[:, None] * norm(ds, dd >= 0)
    return _fuse_lists(r_l, ld, r_d, dd, k)


def _plan_knn_segment(dseg: DeviceSegment, ctx: ExecutionContext,
                      reqs: list) -> dict | None:
    """Resolve one segment's per-request lexical query (hybrid) and knn
    filter into emit closures and stacked constants. → plan dict, or None
    when the requests do not share one plan signature."""
    sig0 = emit_q0 = emit_f0 = ct0 = None
    consts_rows = []
    for req in reqs:
        ct = ConstTable()
        resolver = SegmentResolver(dseg, ctx, ct)
        knn = req.knn
        emit_q = resolver.resolve(req.query) if knn.hybrid else None
        emit_f = resolver.resolve_mask(knn.filter) \
            if knn.filter is not None else None
        ct.static("knn-lane", knn.hybrid, knn.filter is not None)
        if sig0 is None:
            sig0, emit_q0, emit_f0, ct0 = ct.signature(), emit_q, emit_f, ct
        elif ct.signature() != sig0:
            return None
        consts_rows.append(ct.values)
    _fetch_lazy(dseg, ctx.reader, ct0.positions_needed,
                ct0.vectors_needed)
    consts = stack_consts(consts_rows, ctx.reader.device) \
        if consts_rows[0] else []
    return {"seg": dseg, "emit_q": emit_q0, "emit_f": emit_f0,
            "consts": consts}


def _knn_query_inputs(reqs: list, pack: _VectorPack, device):
    """The batch's query vectors, normalized on the host in numpy f32 as
    ``v / max(|v|, 1e-12)``. → (qv, qmask | None). Dense: qv [B, D] f32.
    rank_vectors: qv [B, Qt, D] with per-token normalization, zero tokens
    past each query's own, and qmask [B, Qt] (Qt: the batch's longest
    query)."""
    rows = [req.knn for req in reqs]
    if not pack.multi:
        qv = np.zeros((len(rows), pack.dims), np.float32)
        for i, kn in enumerate(rows):
            v = np.asarray(kn.query_vector, np.float32)
            qv[i] = v / max(float(np.linalg.norm(v)), 1e-12)
        return torch.from_numpy(qv).to(device), None
    qt = max(len(kn.query_vector) for kn in rows)
    qv = np.zeros((len(rows), qt, pack.dims), np.float32)
    qmask = np.zeros((len(rows), qt), bool)
    for i, kn in enumerate(rows):
        m = np.asarray(kn.query_vector, np.float32)
        norms = np.linalg.norm(m, axis=1, keepdims=True)
        qv[i, :m.shape[0]] = m / np.maximum(norms, 1e-12)
        qmask[i, :m.shape[0]] = True
    return torch.from_numpy(qv).to(device), torch.from_numpy(qmask).to(device)


def _knn_segment_scores(pack: _VectorPack, s: dict, qv, qmask):
    """One segment's [B, N] knn scores: dense cosine (torch.matmul, f32),
    int8 cosine (K4), or MaxSim over f32 or int8 tokens (K5)."""
    if pack.multi and pack.quant == "int8":
        return maxsim_ops.maxsim_scores_int8_batch_body(
            s["vecs"], s["scale"], s["offset"], s["lens"], qv, qmask)
    if pack.multi:
        return maxsim_ops.maxsim_scores_batch_body(s["vecs"], s["lens"], qv,
                                                   qmask)
    if pack.quant == "int8":
        return vector_ops.cosine_scores_int8_batch(
            s["vecs"], s["scale"], s["offset"], s["exists"], qv)
    return torch.where(s["exists"][None, :], qv @ s["vecs"].T, 0.0)


def run_knn_hybrid_batch(reader, ctx: ExecutionContext, reqs: list,
                         pack: _VectorPack | None, cfg: KnnPlaneConfig, *,
                         k: int, num_candidates: int, packed: bool):
    """B knn (or hybrid lexical + knn) requests over the whole reader.

    Per segment: the knn lane scores the vector column, masked by exists ∧
    live ∧ the request's ``filter``, and keeps its top ``num_candidates``
    (K2); a hybrid request's lexical query scores the same segment through
    the emit closures and keeps its own top ``num_candidates``. Each lane's
    candidates merge across segments (K2), and hybrid requests fuse the two
    rankings by RRF (``rank_constant``) or a weighted sum. ``pack`` is None
    only for a hybrid batch on a field no segment carries: its knn list is
    empty and the lexical list alone is fused.

    Returns, on the reader's device, the packed ``[B, 2k+1]`` f32 tensor
    (``packed=True``; exact only while doc ids and counts stay below 2**24,
    as for :func:`run_reader_batch`) or {"top_scores" [B, k], "top_docs"
    [B, k], "count" [B]}; None when the batch's plans do not share one
    signature (callers serve each request alone)."""
    segments = reader.segments
    if not segments or not reqs:
        return None
    hybrid = reqs[0].knn.hybrid
    b = len(reqs)
    c = int(num_candidates)
    dev = reader.device
    plans = []
    if hybrid or any(r.knn.filter is not None for r in reqs):
        for dseg in segments:
            plan = _plan_knn_segment(dseg, ctx, reqs)
            if plan is None:
                return None
            plans.append(plan)
    boosts = torch.tensor([r.knn.boost for r in reqs], dtype=torch.float32,
                          device=dev)
    # ---- per-segment lexical candidates and filter masks ----------------
    lex_ts, lex_td = [], []
    fmasks = [None] * len(segments)
    for i, plan in enumerate(plans):
        view = plan["seg"]
        em = EmitCtx(view, plan["consts"], b)
        if plan["emit_q"] is not None:
            scores, mask = plan["emit_q"](em)
            ts, td = topk_ops.top_k(scores, mask & view.live[None, :],
                                    min(c, view.padded_docs), 0)
            lex_ts.append(ts)
            lex_td.append(td)
        if plan["emit_f"] is not None:
            fmasks[i] = plan["emit_f"](em)
    # ---- per-segment knn candidates --------------------------------------
    knn_ts, knn_td, vec_bases = [], [], []
    knn_counts = torch.zeros(b, dtype=torch.int32, device=dev)
    if pack is not None:
        qv, qmask = _knn_query_inputs(reqs, pack, dev)
        for i, s in enumerate(pack.segs):
            if s is None:
                continue
            scores = _knn_segment_scores(pack, s, qv, qmask)
            if not hybrid:
                # knn-only: the section boost scales the reported scores
                # (rank-preserving: boost > 0 is validated)
                scores = scores * boosts[:, None]
            elig = (s["exists"] & s["live"])[None, :]
            masks = elig.expand(b, -1) if fmasks[i] is None \
                else elig & fmasks[i]
            ts, td = vector_ops.filtered_topk_batch(
                scores, masks, min(c, elig.shape[1]), 0)
            knn_ts.append(ts)
            knn_td.append(td)
            vec_bases.append(s["doc_base"])
            knn_counts = knn_counts + masks.sum(dim=1, dtype=torch.int32)
    if knn_ts:
        ds, dd = topk_ops.merge_top_k_batch_body(knn_ts, knn_td, c,
                                                 vec_bases)
    else:
        ds = torch.full((b, c), float("-inf"), device=dev)
        dd = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    if not hybrid:
        ts, td, count = ds[:, :k], dd[:, :k], knn_counts
    else:
        ls, ld = topk_ops.merge_top_k_batch_body(
            lex_ts, lex_td, c, [int(seg.doc_base) for seg in segments])
        if cfg.fusion_mode == "weighted":
            ts, td, count = _weighted_fuse_body(
                ls, ld, ds, dd, boosts, float(cfg.lexical_weight), k)
        else:
            ts, td, count = _rrf_fuse_body(ls, ld, ds, dd, boosts,
                                           float(cfg.rank_constant), k)
    if packed:
        return topk_ops.pack_batch_result_body(ts, td, count)
    return {"top_scores": ts, "top_docs": td, "count": count}


# --------------------------------------------------------------------------
# The impact lane: opt-in per index (``index.search.impact_plane``). Requests
# score from the quantized impact columns (index/segment.py ImpactColumn):
# eagerly over every row (kernel K6, then K2), or, when no request of the
# batch tracks its total, by the block-max sweep (kernel K7) that skips the
# row blocks whose bound cannot reach the running k-th score. The rescore arm
# runs the eager arm as its first stage, then scores the candidates against
# the rescore query and re-sorts the window, all on the device. Counterpart
# of the impact section of jit_exec.py; the mesh form is not ported.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ImpactPlaneConfig:
    """Per-index impact-lane knobs (``index.search.impact.*`` settings)."""
    bits: int = 8
    block_rows: int = 2048
    prune: bool = True          # the block-max sweep when totals untracked
    max_terms: int = 64         # the terms a query may carry


#: index name → config for indices that opted in (absent: lane off)
_impact_configs: dict[str, ImpactPlaneConfig] = {}
_impact_lock = threading.Lock()
#: decline reason → count
_impact_fallback_reasons: dict[str, int] = {}
#: index name → {"admissions", "blocks_scored", "blocks_skipped"}
_impact_index_stats: dict[str, dict] = {}


def validate_impact_settings(settings) -> tuple:
    """Validate the ``index.search.impact.*`` knobs, raising the
    create-index-time 400 (IllegalArgumentError) on a bad value.
    → (bits, block_rows, max_terms)."""
    get = settings.get if settings is not None else (lambda *_: None)

    def setting(name, default):
        raw = get(name, default)
        try:
            return int(default if raw is None or raw == "" else raw)
        except (TypeError, ValueError):
            raise IllegalArgumentError(
                f"{name} must be an integer, got [{raw}]") from None

    bits = setting("index.search.impact.bits", IMPACT_BITS)
    if bits not in (8, 16):
        raise IllegalArgumentError(
            f"index.search.impact.bits must be 8 or 16, got {bits}")
    block_rows = setting("index.search.impact.block_rows", IMPACT_BLOCK_ROWS)
    if block_rows <= 0 or block_rows & (block_rows - 1):
        raise IllegalArgumentError(
            "index.search.impact.block_rows must be a power of two, "
            f"got {block_rows}")
    max_terms = setting("index.search.impact.max_terms", 64)
    if max_terms < 1:
        raise IllegalArgumentError(
            f"index.search.impact.max_terms must be >= 1, got {max_terms}")
    # the JAX body's packed (Σq·256 + matches) sum stays inside int32: T ≤
    # 255 matches in a byte, and 16-bit impacts need T·65535·256 < 2³¹
    cap = 127 if bits == 16 else 255
    if max_terms > cap:
        raise IllegalArgumentError(
            f"index.search.impact.max_terms must be <= {cap} at {bits}-bit "
            f"impacts, got {max_terms}")
    return bits, block_rows, max_terms


def configure_impact_plane(index_name: str, settings=None) -> None:
    """Register (or, with the setting off, clear) an index's impact-lane
    config from its settings; bad values raise (validate_impact_settings)."""
    get = settings.get if settings is not None else (lambda *_: None)
    raw = get("index.search.impact_plane", "false")
    if str(raw).lower() not in ("true", "1"):
        _impact_configs.pop(index_name, None)
        return
    bits, block_rows, max_terms = validate_impact_settings(settings)
    _impact_configs[index_name] = ImpactPlaneConfig(
        bits=bits, block_rows=block_rows, max_terms=max_terms,
        prune=str(get("index.search.impact.prune", "true")).lower()
        in ("true", "1"))


def impact_plane_config(index_name: str | None) -> ImpactPlaneConfig | None:
    if index_name is None:
        return None
    return _impact_configs.get(index_name)


def note_impact_fallback(reason: str) -> None:
    """One impact-lane decline (the batch goes on to the next arm)."""
    with _impact_lock:
        _impact_fallback_reasons[reason] = \
            _impact_fallback_reasons.get(reason, 0) + 1


def impact_fallback_reasons() -> dict:
    with _impact_lock:
        return dict(_impact_fallback_reasons)


def note_impact_served(index_name: str | None, n_requests: int,
                       blocks_scored: int, blocks_skipped: int) -> None:
    """``n_requests`` served by the impact lane and the blocks its sweep
    scored and skipped (the eager arm scores every block)."""
    if not index_name:
        return
    with _impact_lock:
        bucket = _impact_index_stats.setdefault(
            index_name, {"admissions": 0, "blocks_scored": 0,
                         "blocks_skipped": 0})
        bucket["admissions"] += n_requests
        bucket["blocks_scored"] += int(blocks_scored)
        bucket["blocks_skipped"] += int(blocks_skipped)


def impact_index_stats(index_name: str) -> dict:
    """One index's impact-lane rollup (zeros when never admitted)."""
    with _impact_lock:
        bucket = dict(_impact_index_stats.get(index_name, {}))
    out = {"admissions": bucket.get("admissions", 0),
           "blocks_scored": bucket.get("blocks_scored", 0),
           "blocks_skipped": bucket.get("blocks_skipped", 0)}
    total = out["blocks_scored"] + out["blocks_skipped"]
    out["skip_ratio"] = round(out["blocks_skipped"] / total, 4) \
        if total else 0.0
    return out


class _ImpactPack:
    """A reader's impact columns for one (field, config, k1, b): per segment
    carrying the field, its device tensors (uterms, live, qimp, block_max)
    and host column, plus each segment's dequant scale as an f32 tensor."""

    __slots__ = ("field", "cfg", "segs", "can_prune",
                 "total_blocks", "bound_per_term", "scales")

    def __init__(self, field, cfg):
        self.field = field
        self.cfg = cfg
        self.segs = []
        self.can_prune = True
        self.total_blocks = 0
        self.bound_per_term = 0.0
        self.scales = None      # [S] f32 on the reader's device


def _impact_global_df(reader, field: str, col) -> np.ndarray:
    """Reader-global df for one segment's term dictionary: its own df plus
    every sibling segment's df of the same term, merged through the sorted
    term dictionaries."""
    df = np.asarray(col.df, np.int64).copy()
    if not col.terms:
        return df
    terms = np.asarray(col.terms)
    for other in reader.segments:
        ocol = other.seg.text_fields.get(field)
        if ocol is None or ocol is col or not ocol.terms:
            continue
        oterms = np.asarray(ocol.terms)
        pos = np.minimum(np.searchsorted(oterms, terms), len(oterms) - 1)
        hit = oterms[pos] == terms
        df[hit] += np.asarray(ocol.df, np.int64)[pos[hit]]
    return df


def _host_impact_column(reader, dseg: DeviceSegment, field: str,
                        cfg: ImpactPlaneConfig, k1: float, b: float,
                        doc_count: int, avgdl: float):
    """The host quantized column of one segment, cached ON the immutable
    host Segment (reader swaps keep it). A cached column is reused while the
    reader's statistics have drifted less than one quantization step from
    its snapshot; beyond that the segment requantizes (a new
    ``quant_gen``)."""
    host = dseg.seg
    col = host.text_fields.get(field)
    if col is None:
        return None
    cache = host.__dict__.setdefault("_impact_cache", {})
    ckey = (field, cfg.bits, cfg.block_rows, float(k1), float(b))
    icol = cache.get(ckey)
    if icol is not None:
        if icol.drift_bound(doc_count, avgdl) <= icol.scale:
            return icol
        quant_gen = icol.quant_gen + 1
    else:
        quant_gen = 0
    icol = build_impact_column(
        col, df=_impact_global_df(reader, field, col), doc_count=doc_count,
        avgdl=avgdl, k1=k1, b=b, bits=cfg.bits, block_rows=cfg.block_rows,
        quant_gen=quant_gen)
    cache[ckey] = icol
    return icol


def impact_pack_for(reader, field: str, cfg: ImpactPlaneConfig,
                    k1: float = 1.2, b: float = 0.75) -> _ImpactPack | None:
    """The impact pack of ``field`` for this reader, built at first use and
    cached on the reader: each segment's host column (built, or reused from
    the host segment) goes to the device once (DeviceReader.fetch_impacts).
    None when no segment carries the field."""
    packs = reader.__dict__.setdefault("_impact_packs", {})
    pkey = (field, cfg.bits, cfg.block_rows, float(k1), float(b))
    pack = packs.get(pkey)
    if pack is not None:
        return pack
    st = reader.text_stats(field)
    if st.docs_with_field <= 0:
        return None
    pack = _ImpactPack(field, cfg)
    for dseg in reader.segments:
        icol = _host_impact_column(reader, dseg, field, cfg, k1, b,
                                   st.doc_count, st.avgdl)
        if icol is None:
            continue
        dev = reader.fetch_impacts(dseg, field, icol)
        text = dseg.text[field]
        n_blocks = icol.qimp.shape[0] // icol.block_rows
        pack.segs.append({
            "uterms": text.uterms, "trailing_pad": text.trailing_pad,
            "live": dseg.live, "qimp": dev.qimp, "block_max": dev.block_max,
            "scale": float(icol.scale), "col": icol,
            "host": dseg.seg.text_fields[field],
            "np_docs": int(icol.qimp.shape[0]),
            "doc_base": int(dseg.doc_base), "n_blocks": int(n_blocks)})
        pack.total_blocks += int(n_blocks)
        pack.bound_per_term = max(pack.bound_per_term, icol.bound_per_term)
        if dev.block_max is None:
            pack.can_prune = False
    if not pack.segs:
        return None
    pack.scales = torch.tensor([s["scale"] for s in pack.segs],
                               dtype=torch.float32, device=reader.device)
    packs[pkey] = pack
    return pack


def verify_impact_cursor(pack: _ImpactPack, terms: list, boost: float,
                         search_after) -> tuple | None:
    """Admit a score-order ``search_after`` cursor to the impact lane only
    when this quantization produced it: the cursor doc's quantized score,
    rebuilt on the host from the pack's columns in the lane's arithmetic
    (the integer sum, then ``f32(qsum) · (f32(scale) · f32(boost))``), must
    equal the cursor score bit for bit as f32. A cursor of the exact scorer
    (or of another quantization generation) essentially never does; a
    score-only cursor carries nothing to check. → (score, doc) for the
    continuation, or None (the batch declines: ``cross-lane-cursor``)."""
    if len(search_after) != 2:
        return None
    doc = int(search_after[1])
    want = np.float32(float(search_after[0]))
    for s in pack.segs:
        base = s["doc_base"]
        if not base <= doc < base + s["np_docs"]:
            continue
        row = doc - base
        ut = np.asarray(s["host"].uterms[row])
        qi = s["col"].qimp[row].astype(np.int64)
        qsum = 0
        for term in terms:
            tid = s["host"].tid(term)
            if tid >= 0:
                qsum += int(qi[ut == tid].sum())
        scale_boost = np.float32(np.float32(s["scale"]) * np.float32(boost))
        got = np.float32(np.float32(qsum) * scale_boost)
        return (float(want), doc) if got == want else None
    return None


def _impact_query_inputs(pack: _ImpactPack, term_lists: list, boosts: list,
                         cursors: list, device):
    """The batch's per-segment term ids ([B, T] int32, -1 for a term the
    segment lacks and past a query's own terms), boosts [B] f32 and cursors
    (cs [B] f32, +inf for none; cd [B] int32, -1)."""
    b = len(term_lists)
    t = max(max(len(terms) for terms in term_lists), 1)
    qtids = []
    for s in pack.segs:
        arr = np.full((b, t), -1, np.int32)
        for bi, terms in enumerate(term_lists):
            for ti, term in enumerate(terms):
                arr[bi, ti] = s["host"].tid(term)
        qtids.append(torch.from_numpy(arr).to(device))
    cs = np.asarray([np.float32(c[0]) if c is not None else np.float32(np.inf)
                     for c in cursors], np.float32)
    cd = np.asarray([c[1] if c is not None else -1 for c in cursors],
                    np.int32)
    return (qtids, torch.tensor(boosts, dtype=torch.float32, device=device),
            torch.from_numpy(cs).to(device), torch.from_numpy(cd).to(device))


def _eager_reader_topk(pack: _ImpactPack, qtids, boosts, cs, cd, k: int):
    """The eager arm over the reader: per segment K6 then K2, then the
    cross-segment merge (K2). → (top_scores [B, k], top_docs [B, k] global,
    count [B])."""
    ts_list, td_list = [], []
    counts = None
    for i, s in enumerate(pack.segs):
        ts, td, cnt = blockmax_ops.eager_segment_topk(
            s["uterms"], s["qimp"], s["live"], qtids[i],
            pack.scales[i] * boosts, k, s["doc_base"], cs, cd,
            trailing_pad=s["trailing_pad"])
        ts_list.append(ts)
        td_list.append(td)
        counts = cnt if counts is None else counts + cnt
    top_s, top_d = topk_ops.merge_top_k_batch_body(
        ts_list, td_list, k, [s["doc_base"] for s in pack.segs])
    return top_s, top_d, counts


def _impact_result(out: dict, packed: bool):
    """The lane's result as it leaves for the drain: with ``packed`` one
    ``[B, 2k+1]`` f32 tensor (scores ‖ doc ids ‖ count, as the exact arm
    packs it) with the sweep's block counters as two more columns when the
    arm swept; else the dict."""
    if not packed:
        return out
    cols = [topk_ops.pack_batch_result_body(out["top_scores"],
                                            out["top_docs"], out["count"])]
    cols += [out[name].to(torch.float32)[:, None]
             for name in ("blocks_scored", "blocks_skipped") if name in out]
    return torch.cat(cols, dim=1)


def run_impact_batch(pack: _ImpactPack, term_lists: list, boosts: list,
                     cursors: list, *, k: int, packed: bool = False):
    """Eager quantized-impact scoring of B queries over the whole reader:
    per segment one K6 launch for the batch and one K2 top-k, then the K2
    merge. → {"top_scores", "top_docs", "count"} (exact hit counts: the
    match mask is the exact scorer's OR mask), or packed (_impact_result)."""
    dev = pack.scales.device
    qtids, boosts_t, cs, cd = _impact_query_inputs(pack, term_lists, boosts,
                                                   cursors, dev)
    ts, td, count = _eager_reader_topk(pack, qtids, boosts_t, cs, cd, int(k))
    return _impact_result({"top_scores": ts, "top_docs": td, "count": count},
                          packed)


def run_impact_pruned(pack: _ImpactPack, term_lists: list, boosts: list,
                      cursors: list, *, k: int, packed: bool = False):
    """Block-max pruned top-k of B queries: per segment, in segment order,
    the block bounds and the sweep order (torch ops) and one K7 launch,
    the running top-k carried across segments so earlier segments prune
    later ones. Adds per-query ``blocks_scored`` / ``blocks_skipped``;
    ``count`` counts the matches in SCORED blocks only (the lane admits the
    sweep only when no request tracks its total)."""
    if not pack.can_prune:
        raise ValueError("pack has segments without block maxima")
    dev = pack.scales.device
    qtids, boosts_t, cs, cd = _impact_query_inputs(pack, term_lists, boosts,
                                                   cursors, dev)
    carry = blockmax_ops.pruned_carry_init(len(term_lists), int(k), dev)
    for i, s in enumerate(pack.segs):
        carry = blockmax_ops.pruned_segment_topk(
            carry, s["uterms"], s["qimp"], s["live"], s["block_max"],
            qtids[i], pack.scales[i] * boosts_t, int(k), s["doc_base"], cs,
            cd, trailing_pad=s["trailing_pad"])
    ts, td, scored, skipped, matched = carry
    return _impact_result({"top_scores": ts, "top_docs": td,
                           "count": matched, "blocks_scored": scored,
                           "blocks_skipped": skipped}, packed)


def run_impact_rescore(pack: _ImpactPack, term_lists: list, boosts: list,
                       sec_term_lists: list, sec_boosts: list, windows: list,
                       qws: list, rws: list, score_mode: str, *, k: int,
                       packed: bool = False):
    """The impact → rescore arm: the eager arm's top-k (k already widened to
    the largest window) as candidates; each segment scores the candidates
    that live in it against the rescore query's terms (a row gather and the
    impact sum), summed across segments; then QueryRescorer's window combine
    and re-sort (blockmax.rescore_window, the reference's f32 op order).
    Both stages score in the quantized domain."""
    dev = pack.scales.device
    b = len(term_lists)
    none = [None] * b
    qtids, boosts_t, cs, cd = _impact_query_inputs(pack, term_lists, boosts,
                                                   none, dev)
    qtids2, boosts2_t, _, _ = _impact_query_inputs(pack, sec_term_lists,
                                                   sec_boosts, none, dev)
    top_s, top_d, counts = _eager_reader_topk(pack, qtids, boosts_t, cs, cd,
                                              int(k))
    sec = torch.zeros(top_s.shape, dtype=torch.float32, device=dev)
    hit = torch.zeros(top_s.shape, dtype=torch.bool, device=dev)
    for i, s in enumerate(pack.segs):
        qsum, h = blockmax_ops.rescore_gather(s["uterms"], s["qimp"], top_d,
                                              qtids2[i], s["doc_base"])
        sec = sec + qsum.to(torch.float32) * \
            (pack.scales[i] * boosts2_t)[:, None]
        hit = hit | h
    new_s, new_d = blockmax_ops.rescore_window(
        top_s, top_d, sec, hit,
        torch.tensor(windows, dtype=torch.int32, device=dev),
        torch.tensor(qws, dtype=torch.float32, device=dev),
        torch.tensor(rws, dtype=torch.float32, device=dev), score_mode)
    return _impact_result({"top_scores": new_s, "top_docs": new_d,
                           "count": counts}, packed)


# ---------------------------------------------------------------------------
# the percolate lanes
# ---------------------------------------------------------------------------

def make_percolate_lane(seg: DeviceSegment, emit, pos_for: frozenset,
                        vecs_for: frozenset, consts_rows: list,
                        reader) -> dict:
    """One percolate lane = (one probe segment × one same-signature query
    group): the emit closure of the group's first plan, every member's
    constants (all of one plan signature: the caller groups by actual
    signature), the text fields whose positions and the vector fields whose
    rows the plan reads, and the probe's reader (which puts those on the
    device). The JAX package also keys its compiled program by the
    signature and BM25's k1 and b; the port compiles nothing."""
    return {"seg": seg, "emit": emit, "pos": pos_for, "vecs": vecs_for,
            "consts_rows": consts_rows, "reader": reader}


def run_percolate_lanes(lanes: list) -> list:
    """Evaluate percolate lanes with one emit a lane and ONE K10 launch and
    ONE device→host copy for all of them (the JAX package's one-fetch
    discipline). Per lane: its constants stacked on the device once
    (:func:`execute.stack_consts`), its group's emit run once with the
    batch axis written out (``EmitCtx(seg, consts, B)`` → ``[B, Np]``
    scores and mask); a const-free lane (the match_none shapes: every member
    is the same plan) runs at batch 1 and the caller broadcasts its row.
    K10 reduces each row over ``mask & live`` to (matched, best).

    The JAX package pads each lane's batch to a power of two and caches one
    compiled program per lane key (its ``percolate_program_hits`` /
    ``misses`` counters); the port runs eagerly and keeps no program cache,
    so it pads nothing and has no such counters.

    → one [b, 2] f32 numpy array per lane (column 0: the match flag,
    column 1: the score); a const-free lane's is [1, 2]. A device error
    propagates."""
    if not lanes:
        return []
    parts = []
    for lane in lanes:
        seg, reader = lane["seg"], lane["reader"]
        _fetch_lazy(seg, reader, lane["pos"], lane["vecs"])
        rows = lane["consts_rows"]
        if rows[0]:
            consts, batch = stack_consts(rows, reader.device), len(rows)
        else:
            consts, batch = [], 1
        scores, mask = lane["emit"](EmitCtx(seg, consts, batch))
        parts.append((scores.contiguous(), mask.contiguous(), seg.live))
    packed = percolate_ops.percolate_reduce(parts).cpu().numpy()
    out, off = [], 0
    for scores, _, _ in parts:
        out.append(packed[off:off + scores.shape[0]])
        off += scores.shape[0]
    return out
