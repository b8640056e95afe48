"""Query execution: AST → (scores, mask) per device segment, for a batch.

Counterpart of ``elasticsearch_tpu/search/execute.py`` — the analog of
Lucene's Query.createWeight/scorer split as driven by QueryPhase.execute
(core/search/query/QueryPhase.java:99-314), in two phases:

* **resolve** (:class:`SegmentResolver`) — host-side "createWeight": walk
  the AST resolving per-segment constants (term ids from the segment term
  dictionary, idf from reader-aggregated df) into a :class:`ConstTable`,
  and return an *emit closure*. Resolution is dictionary lookups only.
* **emit** — the "scorer": torch ops and kernels over the segment's columns
  for a whole BATCH of same-signature queries at once. The JAX package runs
  one query's emit under ``jax.vmap``; here the per-query constants are
  stacked on a leading batch axis (``EmitCtx.get`` returns ``[B, ...]``)
  and every emit returns ``(scores [B, N] f32, mask [B, N] bool)``.

This slice of the port serves the ``match`` query with BM25 scoring (the
``msm1`` shortcut included), ``match_all`` and ``match_none``. Every other
query type is refused with ``QueryParsingError("no executor for query type
[...]")``, as the reference refuses an unknown type — never a fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import NotPortedError, QueryParsingError
from elasticsearch_tpu_torch.index.device_reader import DeviceReader, DeviceSegment
from elasticsearch_tpu_torch.ops import lexical
from elasticsearch_tpu_torch.ops.similarity import BM25Params, idf as bm25_idf
from elasticsearch_tpu_torch.search import query_dsl as q


class ConstTable:
    """A query plan's dynamic constants + structural signature.

    ``add`` registers a constant and returns its index (a *const ref*);
    emit closures fetch it back through ``EmitCtx.get`` — by index, so the
    scheme is insensitive to evaluation order. ``static`` records anything
    that changes the plan's structure (field names, clause counts,
    modifiers...) into the signature. Queries with one signature run as
    one batch.
    """

    __slots__ = ("values", "sig")

    def __init__(self):
        self.values: list[np.ndarray] = []
        self.sig: list = []

    def add(self, v, dtype=None) -> int:
        arr = np.asarray(v, dtype=dtype)
        self.values.append(arr)
        self.sig.append(("c", arr.shape, str(arr.dtype)))
        return len(self.values) - 1

    def static(self, *tokens) -> None:
        self.sig.append(tokens)

    def signature(self) -> tuple:
        return tuple(self.sig)


def stack_consts(consts_rows: list[list[np.ndarray]],
                 device: torch.device) -> list[torch.Tensor]:
    """B queries' ConstTable values (one signature) → one ``[B, *shape]``
    tensor per constant on ``device``. Constants of one dtype travel in ONE
    host→device copy; each tensor is a contiguous view of it."""
    b = len(consts_rows)
    by_dtype: dict[np.dtype, list[int]] = {}
    for i, v in enumerate(consts_rows[0]):
        by_dtype.setdefault(v.dtype, []).append(i)
    out: list[torch.Tensor | None] = [None] * len(consts_rows[0])
    for dtype, idxs in by_dtype.items():
        blocks = [np.stack([row[i] for row in consts_rows]).astype(
            dtype, copy=False).reshape(-1) for i in idxs]
        flat = torch.from_numpy(np.concatenate(blocks)).to(device)
        off = 0
        for i, blk in zip(idxs, blocks):
            out[i] = flat[off:off + blk.size].view(
                b, *consts_rows[0][i].shape)
            off += blk.size
    return out


class EmitCtx:
    """Hands emit closures their segment and the batch's stacked
    constants (``get(ref)`` → ``[B, *shape]`` tensor)."""

    __slots__ = ("seg", "consts", "n", "batch")

    def __init__(self, seg: DeviceSegment, consts: list[torch.Tensor],
                 batch: int):
        self.seg = seg
        self.consts = consts
        self.n = seg.padded_docs
        self.batch = batch

    def get(self, ref: int) -> torch.Tensor:
        return self.consts[ref]

    @property
    def device(self) -> torch.device:
        return self.seg.live.device


# emit closure: EmitCtx → (scores [B, N] f32, mask [B, N] bool)
Emit = Callable[[EmitCtx], tuple]


@dataclass
class ExecutionContext:
    reader: DeviceReader
    mapper_service: Any
    bm25: BM25Params = BM25Params()
    # Optional global term statistics (DFS_QUERY_THEN_FETCH,
    # core/search/dfs/DfsPhase.java:45): {"df": {(field, term): int},
    # "doc_count": {field: int}, "avgdl": {field: float}}. When set, idf
    # and avgdl come from here instead of the shard-local reader.
    dfs_stats: dict | None = None


class SegmentResolver:
    """Host-side "createWeight": resolves query ASTs against one segment's
    dictionaries into emit closures + a ConstTable."""

    def __init__(self, seg: DeviceSegment, ctx: ExecutionContext,
                 ct: ConstTable | None = None):
        self.seg = seg
        self.ctx = ctx
        self.ct = ct if ct is not None else ConstTable()
        self.n = seg.padded_docs
        self.c = self.ct.add
        self.sig = self.ct.static

    # ------------------------------------------------------------------ util

    def _analyzer_for(self, field: str, override: str | None):
        ms = self.ctx.mapper_service
        if override:
            return ms.analysis.get(override)
        fm = ms.field_mapper(field)
        if fm is not None and getattr(fm, "kind", None) == "text":
            return fm.search_analyzer
        return ms.analysis.get("standard")

    def _similarity_for(self, field: str) -> str:
        """Per-field similarity module (BM25 / classic / lm_dirichlet),
        from the field mapping's `similarity` or the index default."""
        fm = self.ctx.mapper_service.field_mapper(field)
        sim = None
        if fm is not None:
            sim = fm.params.get("similarity")
        if sim is None:
            sim = getattr(self.ctx.mapper_service, "default_similarity",
                          None)
        sim = str(sim or "BM25").lower()
        if sim in ("default", "classic", "tfidf", "tf/idf"):
            return "classic"
        if sim in ("lmdirichlet", "lm_dirichlet"):
            return "lm_dirichlet"
        return "bm25"

    def _zeros(self) -> Emit:
        self.sig("zeros")
        return lambda em: (
            torch.zeros((em.batch, em.n), dtype=torch.float32,
                        device=em.device),
            torch.zeros((em.batch, em.n), dtype=torch.bool, device=em.device))

    def _all(self, boost: float) -> Emit:
        r_boost = self.c(boost, np.float32)
        return lambda em: (
            torch.ones((em.batch, em.n), dtype=torch.float32,
                       device=em.device) * em.get(r_boost)[:, None],
            torch.ones((em.batch, em.n), dtype=torch.bool, device=em.device))

    def _term_stats(self, field: str, term: str) -> tuple[int, int]:
        """→ (df, doc_count), from global DFS statistics when present
        (aggregateDfs, core/search/controller/SearchPhaseController.java:105)
        else from the shard-local reader."""
        dfs = self.ctx.dfs_stats
        if dfs is not None and (field, term) in dfs["df"]:
            doc_count = dfs["doc_count"].get(field)
            if doc_count is None:
                doc_count = max(self.ctx.reader.text_stats(field).doc_count,
                                1)
            return int(dfs["df"][(field, term)]), max(int(doc_count), 1)
        st = self.ctx.reader.text_stats(field)
        return self.ctx.reader.df(field, term), max(st.doc_count, 1)

    def _avgdl(self, field: str) -> float:
        dfs = self.ctx.dfs_stats
        if dfs is not None and field in dfs.get("avgdl", {}):
            return max(float(dfs["avgdl"][field]), 1e-9)
        return max(self.ctx.reader.text_stats(field).avgdl, 1e-9)

    # ------------------------------------------------------------- dispatch

    def resolve(self, query: q.Query) -> Emit:
        """→ emit closure producing (scores [B, N] f32, mask [B, N] bool);
        live-mask applied by the caller."""
        method = getattr(self, f"_res_{type(query).__name__}", None)
        if method is None:
            raise QueryParsingError(
                f"no executor for query type [{type(query).__name__}]")
        self.sig(type(query).__name__, getattr(query, "field", None))
        return method(query)

    def resolve_mask(self, query: q.Query) -> Callable[[EmitCtx], Any]:
        emit = self.resolve(query)
        return lambda em: emit(em)[1]

    # ----------------------------------------------------------------- leafs

    def _res_MatchAllQuery(self, query: q.MatchAllQuery) -> Emit:
        return self._all(query.boost)

    def _res_MatchNoneQuery(self, query: q.MatchNoneQuery) -> Emit:
        return self._zeros()

    def _match_terms(self, field: str, terms: list[str]):
        """Resolve analyzed terms to per-segment ids + idf (reader or DFS
        stats)."""
        col = self.seg.text.get(field)
        if col is None:
            return None
        tids, idfs = [], []
        for t in terms:
            tid = col.column.tid(t)
            df, doc_count = self._term_stats(field, t)
            tids.append(tid)
            idfs.append(bm25_idf(df, doc_count) if df > 0 else 0.0)
        return tids, idfs

    def _res_MatchQuery(self, query: q.MatchQuery) -> Emit:
        field = query.field
        if field in ("*", "_all"):
            # all-fields match: OR over every text field present in the
            # segment — iteration order is part of the plan signature
            self.sig("all-fields", tuple(self.seg.text))
            subs = [self.resolve(q.MatchQuery(
                field=f, text=query.text, operator=query.operator,
                boost=query.boost)) for f in self.seg.text]
            if not subs:
                return self._zeros()

            def emit_all(em):
                scores = mask = None
                for sub in subs:
                    s, m = sub(em)
                    scores = s if scores is None else torch.maximum(scores, s)
                    mask = m if mask is None else (mask | m)
                return scores, mask
            return emit_all
        if self.seg.text.get(field) is None and (
                field in self.seg.keyword or field in self.seg.numeric):
            # match on keyword/numeric doc values == exact term (ES behavior)
            return self.resolve(q.TermQuery(
                field=field, value=query.text, boost=query.boost))
        analyzer = self._analyzer_for(field, query.analyzer)
        terms = [t.term for t in analyzer.analyze(query.text)]
        if not terms:
            return self._zeros()
        resolved = self._match_terms(field, terms)
        if resolved is None:
            return self._zeros()
        tids, idfs = resolved
        if query.operator == "and":
            required = len(terms)
        elif query.minimum_should_match is not None:
            required = _resolve_msm(query.minimum_should_match, len(terms))
        else:
            required = 1
        similarity = self._similarity_for(field)
        if similarity != "bm25":
            raise NotPortedError(
                f"the [{similarity}] similarity is not ported yet")
        r_tids = self.c(tids, np.int32)
        r_idfs = self.c(idfs, np.float32)
        r_avgdl = self.c(self._avgdl(field), np.float32)
        # required == 1 (the default OR semantics): a doc matches iff any
        # query term hits, and every present term has idf > 0, so
        # mask ≡ scores > 0. The guard is the term's LOCAL df: a term this
        # segment holds but whose (DFS) idf is 0 would score its matches 0
        # and the shortcut would drop them — count nmatch in that case.
        col_df = np.asarray(self.seg.text[field].column.df)
        all_idf_pos = all(
            idf > 0 or tid < 0 or col_df[tid] == 0
            for tid, idf in zip(tids, idfs))
        msm1 = required == 1 and all_idf_pos
        self.sig("msm1" if msm1 else "msm")
        r_req = None if msm1 else self.c(required, np.int32)
        r_boost = self.c(query.boost, np.float32)
        p = self.ctx.bm25

        def emit(em):
            col = em.seg.text[field]
            qtids = em.get(r_tids)
            # OR semantics reads no nmatch: the kernel then writes none, as
            # XLA drops the reference's unused output
            scores, nmatch = lexical.bm25_match_batch(
                col.uterms, col.utf, col.doc_len, qtids, em.get(r_idfs),
                torch.ones(qtids.shape, dtype=torch.float32,
                           device=em.device),
                p.k1, p.b, em.get(r_avgdl), trailing_pad=col.trailing_pad,
                want_nmatch=not msm1)
            boost = em.get(r_boost)[:, None]
            if msm1:
                # OR semantics: the bm25 sum is already 0 on non-matching
                # docs, so the mask is just scores > 0
                return scores * boost, scores > 0
            mask = nmatch >= em.get(r_req)[:, None]
            return torch.where(mask, scores * boost, 0.0), mask
        return emit


def _resolve_msm(msm, num_clauses: int) -> int:
    """minimum_should_match: int, negative int, or percentage string."""
    if isinstance(msm, int):
        return msm if msm >= 0 else max(num_clauses + msm, 0)
    s = str(msm).strip()
    if s.endswith("%"):
        pct = float(s[:-1])
        val = int(num_clauses * pct / 100.0) if pct >= 0 \
            else num_clauses - int(num_clauses * -pct / 100.0)
        return max(val, 0)
    return int(s)
