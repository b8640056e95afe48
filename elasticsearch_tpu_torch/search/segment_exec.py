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
"""

from __future__ import annotations

import numpy as np
import torch

from elasticsearch_tpu_torch.index.device_reader import DeviceSegment
from elasticsearch_tpu_torch.ops import topk as topk_ops
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


def _fetch_positions(seg: DeviceSegment, ctx: ExecutionContext,
                     ct: ConstTable) -> None:
    """Put the position matrices the plan reads on the device (a no-op once
    the reader holds them)."""
    for field in sorted(ct.positions_needed):
        ctx.reader.fetch_tokens(seg, field)


def _build(view: DeviceSegment, consts, emit_q, emit_pf, refs, k: int,
           batch: int) -> dict:
    """The batch body: emit + phase post-processing + top-k → {"count",
    "top_scores", "top_docs"}, each with a leading batch axis; top_docs are
    segment-local."""
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
    return {"count": topk_ops.count_matches(mask_post), "top_scores": ts,
            "top_docs": td}


def run_segment(seg: DeviceSegment, ctx: ExecutionContext, query,
                *, k: int, post_filter=None, min_score=None,
                search_after=None) -> dict:
    """Execute one query against one segment → {"count", "top_scores",
    "top_docs"} as device tensors without a batch axis; top_docs are
    segment-local (caller adds seg.doc_base)."""
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
    _fetch_positions(seg, ctx, ct)
    consts = stack_consts([ct.values], ctx.reader.device) \
        if ct.values else []
    outs = _build(seg, consts, emit_q, emit_pf, refs, int(k), 1)
    return {name: v[0] for name, v in outs.items()}


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
    _fetch_positions(seg, ctx, ct0)
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
