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

The port serves ``match`` with BM25 scoring (the ``msm1`` shortcut
included), ``match_all``, ``match_none``, ``match_phrase`` (kernel K3 exact,
kernel K11 with slop), ``bool``, ``constant_score``, ``term``, ``terms``,
``range``, ``exists`` on keyword, numeric, text and dense_vector fields, the
``knn`` leaf (cosine over a dense_vector field, the alias of the top-level
``knn`` section that ``segment_exec``'s knn lane serves) and
``function_score`` with weight, random_score, field_value_factor,
numeric/date decay and script_score functions, and the ``script_score``
query (the script lowered by ``search/scripts.py`` and run by kernel K12,
``ops/script_ops.script_eval``; ``cosineSimilarity`` / ``dotProduct`` one
``torch.matmul`` a segment). Every
other query type is refused with ``QueryParsingError("no executor for query
type [...]")``, as the reference refuses an unknown type, and a feature of a
served type that is not ported yet (geo decay) raises ``NotPortedError`` —
never a fallback.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import NotPortedError, QueryParsingError
from elasticsearch_tpu_torch.index.device_reader import (
    DeviceReader, DeviceSegment, dd_split)
from elasticsearch_tpu_torch.common.settings import parse_time_value
from elasticsearch_tpu_torch.mapping.mapper import (
    KIND_NUMERIC, cidr_range, ip_to_long, parse_date)
from elasticsearch_tpu_torch.ops import boolean as bool_ops
from elasticsearch_tpu_torch.ops import filters as filter_ops
from elasticsearch_tpu_torch.ops import functionscore as fs_ops
from elasticsearch_tpu_torch.ops import lexical
from elasticsearch_tpu_torch.ops import phrase as phrase_ops
from elasticsearch_tpu_torch.ops import script_ops
from elasticsearch_tpu_torch.ops import vector as vector_ops
from elasticsearch_tpu_torch.ops.similarity import BM25Params, idf as bm25_idf
from elasticsearch_tpu_torch.search import query_dsl as q
from elasticsearch_tpu_torch.search.scripts import compile_script, slot_columns


class ConstTable:
    """A query plan's dynamic constants + structural signature.

    ``add`` registers a constant and returns its index (a *const ref*);
    emit closures fetch it back through ``EmitCtx.get`` — by index, so the
    scheme is insensitive to evaluation order. ``static`` records anything
    that changes the plan's structure (field names, clause counts,
    modifiers, phrase deltas...) into the signature. Queries with one
    signature run as one batch.
    """

    __slots__ = ("values", "sig", "positions_needed", "vectors_needed")

    def __init__(self):
        self.values: list[np.ndarray] = []
        self.sig: list = []
        # text fields whose POSITION matrix ([N, L] tokens) the plan reads
        # (phrase scoring); segment_exec puts those on the device before the
        # plan runs, and no other plan makes the reader upload them
        self.positions_needed: set = set()
        # dense_vector fields whose normalized [N, D] matrix the plan reads
        # (the knn leaf); put on the device the same way
        self.vectors_needed: set = set()

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
    # the shard's index name: the knn and impact lanes read their settings
    # by it (segment_exec.knn_plane_config, impact_plane_config)
    index_name: str | None = None


def impact_terms(query: "q.Query", mapper_service,
                 max_terms: int = 64) -> tuple | None:
    """Impact-lane eligibility: can this query be scored from the quantized
    per-(term, doc) impact columns alone?

    The precomputed impacts bake idf·tfNorm for default-BM25 OR-semantics
    term scoring — the disjunctive match / term shapes on a text field and
    nothing else. → (field, analyzed terms, boost) when eligible, None
    otherwise (operators, msm, other similarities, negative boosts and
    every other shape stay on the exact scorer). Mapping only: no segment
    is read."""
    t = type(query).__name__
    if t == "TermQuery":
        fm = mapper_service.field_mapper(query.field)
        if fm is None or getattr(fm, "kind", None) != "text":
            return None
        # term on a text field scores like a single-term match through the
        # keyword analyzer (the _res_TermQuery rewrite)
        query = q.MatchQuery(field=query.field, text=str(query.value),
                             analyzer="keyword", boost=query.boost)
        t = "MatchQuery"
    if t != "MatchQuery":
        return None
    field = query.field
    if field in ("*", "_all"):
        return None
    fm = mapper_service.field_mapper(field)
    if fm is None or getattr(fm, "kind", None) != "text":
        return None
    sim = fm.params.get("similarity") or \
        getattr(mapper_service, "default_similarity", None)
    if str(sim or "BM25").lower() not in ("bm25",):
        return None
    if query.operator == "and" or \
            query.minimum_should_match not in (None, 1):
        return None
    if not (query.boost >= 0):            # a negative boost flips the order:
        return None                       # the block bounds would invert
    if query.analyzer:
        analyzer = mapper_service.analysis.get(query.analyzer)
    else:
        analyzer = fm.search_analyzer
    if analyzer is None:
        return None
    terms = [tok.term for tok in analyzer.analyze(query.text)]
    if not terms or len(terms) > max_terms:
        return None
    return field, terms, float(query.boost)


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

    def _numeric_value(self, field: str, value):
        fm = self.ctx.mapper_service.field_mapper(field)
        if fm is not None and fm.type == "date" and not isinstance(
                value, (int, float)):
            return parse_date(value)
        if fm is not None and fm.type == "ip" and isinstance(value, str):
            return float(ip_to_long(value))
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        return float(value)

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

    def _res_MatchPhraseQuery(self, query: q.MatchPhraseQuery) -> Emit:
        field = query.field
        analyzer = self._analyzer_for(field, query.analyzer)
        toks = analyzer.analyze(query.text)
        if not toks:
            return self._zeros()
        if len(toks) == 1:
            return self.resolve(q.MatchQuery(
                field=field, text=query.text, analyzer=query.analyzer,
                boost=query.boost))
        col = self.seg.text.get(field)
        if col is not None and not col.column.has_positions:
            raise QueryParsingError(
                f"field [{field}] was not indexed with positions — "
                f"phrase queries need index_options [positions]")
        resolved = self._match_terms(field, [t.term for t in toks])
        if resolved is None:
            return self._zeros()
        tids, idfs = resolved
        deltas = [t.position - toks[0].position for t in toks]
        slop = query.slop
        if len(deltas) > phrase_ops.MAX_TERMS:
            raise NotPortedError(
                f"a phrase of [{len(deltas)}] terms is above the port's "
                f"limit [{phrase_ops.MAX_TERMS}]")
        self.sig("phrase", tuple(deltas), slop)
        self.ct.positions_needed.add(field)
        p = self.ctx.bm25
        r_tids = self.c(tids, np.int32)
        if slop > 0:
            # the sloppy arm sums the f32 idfs on the device, in term order
            r_idf = self.c(idfs, np.float32)
        else:
            # Σ idf in Python doubles, cast once (the reference's order)
            r_idf = self.c(sum(idfs), np.float32)
        r_avgdl = self.c(self._avgdl(field), np.float32)
        r_boost = self.c(query.boost, np.float32)

        def emit(em):
            col = em.seg.text[field]
            if slop > 0:
                scores, mask = phrase_ops.sloppy_phrase_score_batch(
                    col.tokens, col.doc_len, em.get(r_tids), deltas, slop,
                    em.get(r_idf), p.k1, p.b, em.get(r_avgdl),
                    extent=col.tok_extent)
            else:
                scores, mask = phrase_ops.phrase_score_batch(
                    col.tokens, col.doc_len, em.get(r_tids), deltas,
                    em.get(r_idf), p.k1, p.b, em.get(r_avgdl),
                    extent=col.tok_extent)
            return scores * em.get(r_boost)[:, None], mask
        return emit

    def _keyword_or_text_term_mask(self, field: str, value):
        """→ mask emit for an exact term on keyword/numeric/text columns."""
        fm = self.ctx.mapper_service.field_mapper(field)
        kcol = self.seg.keyword.get(field)
        if kcol is not None:
            self.sig("term-kw", field)
            r_ord = self.c(kcol.column.ord(str(value)), np.int32)
            return lambda em: filter_ops.keyword_term(
                em.seg.keyword[field].ords, em.get(r_ord))
        ncol = self.seg.numeric.get(field)
        if ncol is not None or (fm is not None and fm.kind == KIND_NUMERIC):
            if ncol is None:
                self.sig("term-none", field)
                return _no_docs
            self.sig("term-num", field)
            hi, lo = dd_split(self._numeric_value(field, value))
            r_hi = self.c(hi, np.float32)
            r_lo = self.c(lo, np.float32)

            def emit(em):
                col = em.seg.numeric[field]
                return filter_ops.numeric_term(col.hi, col.lo, col.exists,
                                               em.get(r_hi), em.get(r_lo))
            return emit
        tcol = self.seg.text.get(field)
        if tcol is not None:
            self.sig("term-text", field)
            r_tid = self.c(tcol.column.tid(str(value)), np.int32)
            return lambda em: lexical.term_filter(
                em.seg.text[field].uterms, em.get(r_tid))
        self.sig("term-none", field)
        return _no_docs

    def _constant_mask_emit(self, mask_emit, boost: float) -> Emit:
        r_boost = self.c(boost, np.float32)
        return lambda em: bool_ops.constant_score(mask_emit(em),
                                                  em.get(r_boost))

    def _res_TermQuery(self, query: q.TermQuery) -> Emit:
        # term on text fields scores BM25 like a single-term match (Lucene
        # TermQuery); on keyword/numeric doc values it is constant-score.
        fm = self.ctx.mapper_service.field_mapper(query.field)
        if fm is not None and fm.type == "ip" and \
                isinstance(query.value, str) and "/" in query.value:
            # CIDR term → numeric interval (IpFieldMapper termQuery)
            lo, hi = cidr_range(query.value)
            return self.resolve(q.RangeQuery(field=query.field, gte=lo,
                                             lte=hi, boost=query.boost))
        tcol = self.seg.text.get(query.field)
        if tcol is not None and self.seg.keyword.get(query.field) is None:
            return self.resolve(q.MatchQuery(
                field=query.field, text=str(query.value), analyzer="keyword",
                boost=query.boost))
        return self._constant_mask_emit(
            self._keyword_or_text_term_mask(query.field, query.value),
            query.boost)

    def _res_TermsQuery(self, query: q.TermsQuery) -> Emit:
        field = query.field
        kcol = self.seg.keyword.get(field)
        r_boost = self.c(query.boost, np.float32)
        if kcol is not None:
            self.sig("terms-kw", field)
            qords = [kcol.column.ord(str(v)) for v in query.values]
            r_ords = self.c(qords or [-1], np.int32)
            return lambda em: bool_ops.constant_score(
                filter_ops.keyword_terms(em.seg.keyword[field].ords,
                                         em.get(r_ords)), em.get(r_boost))
        self.sig("terms-any", field, len(query.values))
        mask_emits = [self._keyword_or_text_term_mask(field, v)
                      for v in query.values]

        def emit(em):
            mask = _no_docs(em)
            for me in mask_emits:
                mask = mask | me(em)
            return bool_ops.constant_score(mask, em.get(r_boost))
        return emit

    def _res_RangeQuery(self, query: q.RangeQuery) -> Emit:
        field = query.field
        r_boost = self.c(query.boost, np.float32)
        ncol = self.seg.numeric.get(field)
        if ncol is not None:
            # gte/gt (and lte/lt) apply independently; the effective bound is
            # the tightest. Exclusivity is a comparison-strictness flag, not
            # a nextafter-bumped value, whose f64 neighbour of a small bound
            # underflows the f32 split (gt:0 would become gte:0).
            lo_v, lo_strict = -np.inf, False
            if query.gte is not None:
                lo_v = np.float64(self._numeric_value(field, query.gte))
            if query.gt is not None:
                g = np.float64(self._numeric_value(field, query.gt))
                if g >= lo_v:
                    lo_v, lo_strict = g, True
            hi_v, hi_strict = np.inf, False
            if query.lte is not None:
                hi_v = np.float64(self._numeric_value(field, query.lte))
            if query.lt is not None:
                l_ = np.float64(self._numeric_value(field, query.lt))
                if l_ <= hi_v:
                    hi_v, hi_strict = l_, True
            self.sig("range-num", field)
            ghi, glo = dd_split(lo_v)
            lhi, llo = dd_split(hi_v)
            r_ghi = self.c(ghi, np.float32)
            r_glo = self.c(glo, np.float32)
            r_lhi = self.c(lhi, np.float32)
            r_llo = self.c(llo, np.float32)
            r_gx = self.c(np.float32(1.0 if lo_strict else 0.0))
            r_lx = self.c(np.float32(1.0 if hi_strict else 0.0))

            def emit(em):
                col = em.seg.numeric[field]
                mask = filter_ops.numeric_range(
                    col.hi, col.lo, col.exists,
                    em.get(r_ghi), em.get(r_glo),
                    em.get(r_lhi), em.get(r_llo),
                    lo_strict=em.get(r_gx), hi_strict=em.get(r_lx))
                return bool_ops.constant_score(mask, em.get(r_boost))
            return emit
        kcol = self.seg.keyword.get(field)
        if kcol is not None:
            self.sig("range-kw", field)
            vocab = kcol.column.vocab
            lo_ord, hi_ord = 0, len(vocab)
            # the tightest of the given bounds, as in the numeric branch;
            # ordinal intervals make gt/lt exact without strictness flags
            if query.gte is not None:
                lo_ord = max(lo_ord, bisect.bisect_left(vocab, str(query.gte)))
            if query.gt is not None:
                lo_ord = max(lo_ord, bisect.bisect_right(vocab, str(query.gt)))
            if query.lte is not None:
                hi_ord = min(hi_ord,
                             bisect.bisect_right(vocab, str(query.lte)))
            if query.lt is not None:
                hi_ord = min(hi_ord, bisect.bisect_left(vocab, str(query.lt)))
            r_lo = self.c(lo_ord, np.int32)
            r_hi = self.c(hi_ord, np.int32)
            return lambda em: bool_ops.constant_score(
                filter_ops.keyword_ord_range(em.seg.keyword[field].ords,
                                             em.get(r_lo), em.get(r_hi)),
                em.get(r_boost))
        return self._zeros()

    def _res_ExistsQuery(self, query: q.ExistsQuery) -> Emit:
        f = query.field
        if f in self.seg.seg.geo_fields:
            raise NotPortedError(
                f"[exists] on the geo field [{f}] is not ported yet")
        r_boost = self.c(query.boost, np.float32)
        if f in self.seg.numeric:
            self.sig("exists", "num", f)
            mask_emit = lambda em: filter_ops.field_exists(  # noqa: E731
                em.seg.numeric[f].exists)
        elif f in self.seg.keyword:
            self.sig("exists", "kw", f)
            mask_emit = lambda em: (                          # noqa: E731
                em.seg.keyword[f].ords >= 0).any(dim=1)
        elif f in self.seg.text:
            self.sig("exists", "text", f)
            mask_emit = lambda em: filter_ops.text_field_exists(  # noqa: E731
                em.seg.text[f].doc_len)
        elif f in self.seg.vector:
            self.sig("exists", "vec", f)   # reads only the [N] exists mask
            mask_emit = lambda em: filter_ops.field_exists(  # noqa: E731
                em.seg.vector[f].exists)
        else:
            self.sig("exists", "none", f)
            mask_emit = _no_docs
        return lambda em: bool_ops.constant_score(mask_emit(em),
                                                  em.get(r_boost))

    def _res_KnnQuery(self, query: q.KnnQuery) -> Emit:
        """The query-DSL ``knn`` leaf: ``(cosine + 1) · boost`` on every doc
        with a vector, 0 and no match elsewhere. It reads the field's
        normalized f32 matrix, the copy the knn lane reads too."""
        field = query.field
        if self.seg.vector.get(field) is None:
            return self._zeros()
        self.ct.vectors_needed.add(field)
        r_qv = self.c(query.query_vector, np.float32)
        r_boost = self.c(query.boost, np.float32)

        def emit(em):
            col = em.seg.vector[field]
            scores = vector_ops.cosine_scores_batch(col.vecs, col.exists,
                                                    em.get(r_qv))
            return ((scores + 1.0) * em.get(r_boost)[:, None]
                    * col.exists.to(torch.float32)[None, :],
                    col.exists.expand(em.batch, em.n))
        return emit

    # ------------------------------------------------------------- compound

    def _res_BoolQuery(self, query: q.BoolQuery) -> Emit:
        self.sig("bool", len(query.must), len(query.should),
                 len(query.must_not), len(query.filter))
        must = [self.resolve(sub) for sub in query.must]
        should = [self.resolve(sub) for sub in query.should]
        must_not = [self.resolve_mask(sub) for sub in query.must_not]
        filters = [self.resolve_mask(sub) for sub in query.filter]
        if query.minimum_should_match is not None:
            msm = _resolve_msm(query.minimum_should_match, len(query.should))
        else:
            msm = 1 if (query.should and not query.must and not query.filter) \
                else 0
        r_msm = self.c(msm, np.int32) if should else None
        r_boost = self.c(query.boost, np.float32)

        def emit(em):
            scores, mask = bool_ops.combine_bool(
                (em.batch, em.n),
                [e(em) for e in must], [e(em) for e in should],
                [e(em) for e in must_not], [e(em) for e in filters],
                em.get(r_msm) if r_msm is not None else 0,
                device=em.device)
            return scores * em.get(r_boost)[:, None], mask
        return emit

    def _res_ConstantScoreQuery(self, query: q.ConstantScoreQuery) -> Emit:
        return self._constant_mask_emit(
            self.resolve_mask(query.filter_query), query.boost)

    def _res_FunctionScoreQuery(self, query: q.FunctionScoreQuery) -> Emit:
        self.sig("function_score", query.score_mode, query.boost_mode,
                 query.max_boost is not None, query.min_score is not None,
                 tuple((fn.kind, fn.weight is not None,
                        fn.filter_query is not None)
                       for fn in query.functions))
        base_emit = self.resolve(query.query or q.MatchAllQuery())
        fn_emits = []
        for fn in query.functions:
            factor_emit = self._function_factor(fn)
            if fn.weight is not None and fn.kind != "weight":
                r_w = self.c(fn.weight, np.float32)
                factor_emit = (lambda fe, rw: lambda em, s:
                               fe(em, s) * em.get(rw)[:, None])(factor_emit,
                                                                r_w)
            fmask_emit = self.resolve_mask(fn.filter_query) \
                if fn.filter_query else None
            r_wsum = self.c(fn.weight if fn.weight is not None else 1.0,
                            np.float32)
            fn_emits.append((factor_emit, fmask_emit, r_wsum))
        score_mode, boost_mode = query.score_mode, query.boost_mode
        r_max_boost = None if query.max_boost is None \
            else self.c(query.max_boost, np.float32)
        r_min_score = None if query.min_score is None \
            else self.c(query.min_score, np.float32)
        r_boost = self.c(query.boost, np.float32)

        def emit(em):
            base_scores, base_mask = base_emit(em)
            factors, masks, weights = [], [], []
            for factor_emit, fmask_emit, r_wsum in fn_emits:
                factors.append(factor_emit(em, base_scores))
                masks.append(fmask_emit(em) if fmask_emit is not None
                             else torch.ones(em.n, dtype=torch.bool,
                                             device=em.device))
                weights.append(em.get(r_wsum))
            combined = fs_ops.combine_functions(factors, masks, score_mode,
                                                weights=weights)
            if combined is None:
                scores = base_scores
            else:
                mb = None if r_max_boost is None else em.get(r_max_boost)
                scores = fs_ops.apply_boost_mode(base_scores, combined,
                                                 boost_mode, mb)
            mask = base_mask
            if r_min_score is not None:
                mask = mask & (scores >= em.get(r_min_score)[:, None])
            return scores * em.get(r_boost)[:, None], mask
        return emit

    def _function_factor(self, fn: q.ScoreFunction):
        """→ factor emit: (em, base_scores) → [B, N] f32."""
        params = fn.params
        if fn.kind == "weight":
            r_w = self.c(fn.weight or 1.0, np.float32)
            return lambda em, s: fs_ops.weight_factor(em.n, em.get(r_w))
        if fn.kind == "random_score":
            seed = int(params.get("seed", 0))
            self.sig("random", seed)
            r_base = self.c(self.seg.doc_base, np.int64)
            return lambda em, s: fs_ops.random_score(em.n, seed,
                                                     em.get(r_base))
        if fn.kind == "field_value_factor":
            fname = params["field"]
            ncol = self.seg.numeric.get(fname)
            if ncol is None:
                self.sig("fvf-missing", fname)
                r_missing = self.c(params.get("missing", 1.0), np.float32)
                return lambda em, s: (
                    torch.ones((1, em.n), dtype=torch.float32,
                               device=em.device)
                    * em.get(r_missing)[:, None])
            modifier = params.get("modifier", "none")
            missing = params.get("missing")
            self.sig("fvf", fname, modifier, missing is None)
            r_factor = self.c(float(params.get("factor", 1.0)), np.float32)
            r_missing = None if missing is None \
                else self.c(float(missing), np.float32)

            def factor_emit(em, s):
                col = em.seg.numeric[fname]
                return fs_ops.field_value_factor(
                    col.hi, col.exists, factor=em.get(r_factor),
                    modifier=modifier,
                    missing=None if r_missing is None else em.get(r_missing))
            return factor_emit
        if fn.kind in ("gauss", "exp", "linear"):
            return self._decay_factor(fn, params)
        if fn.kind == "script_score":
            script = params.get("script", params)
            if isinstance(script, dict):
                src = script.get("source", script.get("inline", ""))
                sparams = script.get("params", {})
            else:
                src, sparams = str(script), {}
            return self._script_factor(src, sparams)
        raise QueryParsingError(f"unknown score function [{fn.kind}]")

    def _decay_factor(self, fn: q.ScoreFunction, params: dict):
        fname, spec = next(iter(params.items()))
        kind = fn.kind
        origin = spec.get("origin")
        fm = self.ctx.mapper_service.field_mapper(fname)
        if fname in self.seg.seg.geo_fields:
            raise NotPortedError(f"[{kind}] decay on the geo field "
                                 f"[{fname}] is not ported yet")
        ncol = self.seg.numeric.get(fname)
        if ncol is None:
            self.sig("decay-missing", fname)
            return lambda em, s: torch.ones((em.batch, em.n),
                                            dtype=torch.float32,
                                            device=em.device)
        self.sig("decay", fname, kind)
        if fm is not None and fm.type == "date":
            origin_v = parse_date(origin) if origin is not None else 0.0
            scale = parse_time_value(spec["scale"]) * 1000.0
            offset = parse_time_value(spec.get("offset", 0)) * 1000.0
        else:
            origin_v = float(origin if origin is not None else 0.0)
            scale = float(spec["scale"])
            offset = float(spec.get("offset", 0))
        r_origin = self.c(origin_v, np.float32)
        r_scale = self.c(scale, np.float32)
        r_offset = self.c(offset, np.float32)
        r_decay = self.c(float(spec.get("decay", 0.5)), np.float32)

        def factor_emit(em, s):
            col = em.seg.numeric[fname]
            return fs_ops.decay(col.hi, col.exists, em.get(r_origin),
                                em.get(r_scale), em.get(r_offset),
                                em.get(r_decay), kind)
        return factor_emit

    def _feed_script_params(self, params: dict) -> dict:
        """Numeric script params become per-query f32 constants, list
        params per-query f32 vectors ``[B, D]``; bools, strings and anything
        else are structural (in the plan signature, folded into the
        program). → {key: const ref} for the numeric and list params."""
        refs = {}
        for key in sorted(params):
            v = params[key]
            if isinstance(v, bool) or isinstance(v, str):
                self.sig("sparam", key, v)
            elif isinstance(v, (int, float)):
                self.sig("sparam", key, "num")
                refs[key] = self.c(float(v), np.float32)
            elif isinstance(v, (list, tuple)):
                self.sig("sparam", key, "vec", len(v))
                refs[key] = self.c(np.asarray(v, np.float32))
            else:
                self.sig("sparam", key, repr(v))
        return refs

    def _script_factor(self, source: str, params: dict):
        """→ (em, base_scores) → [B, N] f32 evaluating the sandboxed script:
        the lowered program through K12, its vector products one matmul a
        product slot."""
        self.sig("script", source)
        refs = self._feed_script_params(params)
        compiled = compile_script(source)
        vf = compiled.vector_fields()
        # a non-literal field argument means "could be any of them"
        self.ct.vectors_needed.update(
            self.seg.vector if vf is None else vf)
        prog = compiled.lower("query", params)

        def factor_emit(em, scores):
            products = []
            for cosine, query, fld in prog.products:
                vcol = em.seg.vector.get(fld)
                if vcol is None or vcol.vecs is None:
                    raise QueryParsingError(f"no vector field [{fld}]")
                qv = em.get(refs[query.key])
                if cosine:
                    qv = qv / torch.sqrt((qv * qv).sum(dim=-1, keepdim=True)
                                         + 1e-12)
                products.append((torch.matmul(qv, vcol.vecs.T).contiguous(),
                                 vcol.exists))
            pvals = torch.stack([em.get(refs[k]) for k in prog.params],
                                dim=1) if prog.params else None
            return script_ops.script_eval(
                prog.code, slot_columns(prog, em.seg),
                scores.expand(em.batch, em.n).contiguous()
                if prog.code.uses_score else None,
                products, pvals,
                torch.zeros((0, em.n), dtype=torch.int32, device=em.device),
                em.batch, em.n)
        return factor_emit

    def _res_ScriptScoreQuery(self, query: q.ScriptScoreQuery) -> Emit:
        base_emit = self.resolve(query.query or q.MatchAllQuery())
        factor_emit = self._script_factor(query.script, query.params)
        r_boost = self.c(query.boost, np.float32)

        def emit(em):
            base_scores, base_mask = base_emit(em)
            scores = factor_emit(em, base_scores)
            return torch.where(base_mask, scores * em.get(r_boost)[:, None],
                               0.0), base_mask
        return emit


def _no_docs(em) -> torch.Tensor:
    """The mask of a clause that matches nothing: [B, N] False."""
    return torch.zeros((em.batch, em.n), dtype=torch.bool, device=em.device)


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
