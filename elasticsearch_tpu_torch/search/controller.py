"""SearchPhaseController — cross-shard reduce at the coordinator.

Counterpart of ``elasticsearch_tpu/search/controller.py``, with the
aggregation reduce (``search/aggregations.reduce_aggs``) and without the
suggest reduce (not ported yet: a request carrying ``suggest`` is refused
at parse time).

Reference: core/search/controller/SearchPhaseController.java —
``sortDocs`` (:165, TopDocs.merge semantics), ``fillDocIdsToLoad`` (:289),
final ``merge`` (:300-431) assembling hits + reducing aggregations.

Shard results arrive as host arrays (k entries per shard); the merge is a
numpy stable sort in shard order, reproducing the (score desc, shard index,
position) merge order of the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from elasticsearch_tpu_torch.search.aggregations import reduce_aggs
from elasticsearch_tpu_torch.search.phase import ParsedSearchRequest, ShardQueryResult


@dataclass
class MergedHitRef:
    shard_idx: int      # position in the results list
    position: int       # hit position within that shard's result
    score: float | None
    sort_values: list | None


def sort_docs(results: list[ShardQueryResult],
              req: ParsedSearchRequest) -> list[MergedHitRef]:
    """Merge per-shard rankings → global [from, from+size) slice."""
    refs: list[MergedHitRef] = []
    for si, r in enumerate(results):
        for pos in range(len(r.doc_ids)):
            refs.append(MergedHitRef(
                shard_idx=si, position=pos,
                score=float(r.scores[pos]) if r.sort_values is None else None,
                sort_values=r.sort_values[pos] if r.sort_values is not None
                else None))
    if not refs:
        return []
    keyfn = _hit_comparator(req)
    refs.sort(key=lambda r: keyfn((r.sort_values, r.score, r.shard_idx,
                                   r.position)))
    return refs[req.from_: req.from_ + req.size]


def _hit_comparator(req: ParsedSearchRequest):
    """Ordering over (sort_values | score, shard_idx, position) tuples —
    shared by the in-process and the serialized (distributed) merges."""
    import functools
    orders = [(list(spec.values())[0].get("order", "asc")) == "desc"
              for spec in req.sort]
    missing_first = [(list(spec.values())[0].get("missing", "_last"))
                     == "_first" for spec in req.sort]

    def cmp_entries(a, b) -> int:
        # entry: (sort_values|None, score|None, shard_idx, position)
        if a[0] is not None:
            for va, vb, desc, mfirst in zip(a[0], b[0], orders,
                                            missing_first):
                if va == vb:
                    continue
                if va is None:
                    return -1 if mfirst else 1
                if vb is None:
                    return 1 if mfirst else -1
                if isinstance(va, str) or isinstance(vb, str):
                    va, vb = str(va), str(vb)
                c = 1 if va > vb else -1
                return -c if desc else c
            return -1 if (a[2], a[3]) < (b[2], b[3]) else 1
        sa = a[1] if a[1] is not None else -np.inf
        sb = b[1] if b[1] is not None else -np.inf
        if sa != sb:
            return -1 if sa > sb else 1
        return -1 if (a[2], a[3]) < (b[2], b[3]) else 1

    return functools.cmp_to_key(cmp_entries)


def attach_phase_took(response: dict, phases: dict, task=None) -> dict:
    """Surface the coordinator's phase trace ({"query": ms, "fetch": ms,
    "reduce": ms}) as the response's ``took`` breakdown and record the
    spans on the coordinating task (the per-request twin of the
    nodes-stats phase rollup)."""
    response["took_breakdown"] = {k: int(v) for k, v in phases.items()}
    if task is not None:
        for name, ms in phases.items():
            task.add_span(name, ms)
    return response


def assemble_response(req: ParsedSearchRequest, payloads: list[dict],
                      hits_out: list[dict], took_ms: float,
                      total_shards: int, failures: list[dict],
                      successful: int | None = None) -> dict:
    """Final response assembly shared by both distributed execution
    models (SearchPhaseController.merge :300-431): totals, max_score
    gating, shard accounting, agg/suggest reduction — over pre-merged
    page hits."""
    total = sum(p["total"] for p in payloads)
    max_scores = [p["max_score"] for p in payloads
                  if p.get("max_score") is not None]
    max_score = max(max_scores) if max_scores and req.size > 0 \
        and not req.sort else None
    shards = {"total": total_shards,
              "successful": len(payloads) if successful is None
              else successful,
              "skipped": 0, "failed": len(failures)}
    if failures:
        shards["failures"] = failures
    response = {
        "took": int(took_ms),
        "timed_out": any(p.get("timed_out") for p in payloads),
        "_shards": shards,
        "hits": {
            "total": total,
            "max_score": max_score,
            "hits": hits_out,
        },
    }
    if any(p.get("terminated_early") for p in payloads):
        response["terminated_early"] = True
    if req.aggs:
        response["aggregations"] = reduce_aggs(
            req.aggs, [p["aggs"] for p in payloads])
    return response


def merge_shard_payloads(req: ParsedSearchRequest, payloads: list[dict],
                         took_ms: float, total_shards: int,
                         failures: list[dict]) -> dict:
    """Reduce serialized per-shard query+fetch payloads
    ({total, max_score, hits, aggs}) arriving over the transport — the
    distributed twin of :func:`merge_responses`
    (SearchPhaseController.merge :300-431)."""
    entries = []
    for si, p in enumerate(payloads):
        for pos, hit in enumerate(p["hits"]):
            entries.append((hit.get("sort") if req.sort else None,
                            hit.get("_score"), si, pos, hit))
    keyfn = _hit_comparator(req)
    entries.sort(key=lambda e: keyfn((e[0], e[1], e[2], e[3])))
    page = entries[req.from_: req.from_ + req.size]
    return assemble_response(req, payloads, [e[4] for e in page], took_ms,
                             total_shards, failures)


def merge_responses(index_name: str | list, req: ParsedSearchRequest,
                    results: list[ShardQueryResult], searchers,
                    took_ms: float, agg_nodes) -> dict:
    """`index_name` is one name, or one name PER SEARCHER — the
    collective plane's multi-index batches merge shards of several
    indices in one result list and each hit must render its owner."""
    names = list(index_name) if isinstance(index_name, (list, tuple)) \
        else [index_name] * len(searchers)
    page = sort_docs(results, req)
    # fetch phase only on shards owning winning docs (fillDocIdsToLoad)
    by_shard: dict[int, list[int]] = {}
    for ref in page:
        by_shard.setdefault(ref.shard_idx, []).append(ref.position)
    fetched: dict[tuple[int, int], dict] = {}
    for si, positions in by_shard.items():
        hits = searchers[si].fetch_phase(req, results[si], names[si],
                                         positions)
        for pos, hit in zip(positions, hits):
            fetched[(si, pos)] = hit
    hits_out = [fetched[(ref.shard_idx, ref.position)] for ref in page]

    total = sum(r.total for r in results)
    max_scores = [r.max_score for r in results if r.max_score is not None]
    max_score = max(max_scores) if max_scores and req.size > 0 and not req.sort \
        else None

    response = {
        "took": int(took_ms),
        "timed_out": any(r.timed_out for r in results),
        "_shards": {"total": len(results), "successful": len(results),
                    "skipped": 0, "failed": 0},
        "hits": {
            "total": total,
            "max_score": max_score,
            "hits": hits_out,
        },
    }
    if any(r.terminated_early for r in results):
        response["terminated_early"] = True
    if agg_nodes:
        response["aggregations"] = reduce_aggs(
            agg_nodes, [r.agg_partials for r in results],
            device=searchers[0].reader.device if searchers else None)
    return response
