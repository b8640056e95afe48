"""DFS phase — global term statistics for dfs_query_then_fetch.

Reference: core/search/dfs/DfsPhase.java:45 collects each shard's term and
collection statistics for the query's terms; the coordinator aggregates
them (aggregateDfs, core/search/controller/SearchPhaseController.java:
105-154) and the query phase then scores every shard with the SAME global
idf/avgdl — so multi-shard results are bit-identical to a single-shard
index over the same corpus.

Here the shard side walks the query AST host-side (the same analysis the
resolver performs), returns df per (field, term) plus per-field collection
stats, and the merged statistics flow into resolution through
``ExecutionContext.dfs_stats`` (execute.SegmentResolver._term_stats).
The collective plane (parallel/mesh_engine.py) runs this round on the
host over every shard before its device pass; ``parallel/distributed.py``
sums the df vectors over the process group instead.

Counterpart of ``elasticsearch_tpu/search/dfs.py``, copied whole.
"""

from __future__ import annotations

from elasticsearch_tpu_torch.search import query_dsl as q

# wire key separator: (field, term) → "field\x00term" (JSON-safe)
_SEP = "\x00"


def _analyzer_for(mapper_service, field: str, override: str | None):
    if override:
        return mapper_service.analysis.get(override)
    fm = mapper_service.field_mapper(field)
    if fm is not None and getattr(fm, "kind", None) == "text":
        return fm.search_analyzer
    return mapper_service.analysis.get("standard")


def collect_terms(query: q.Query, text_fields: set[str],
                  mapper_service, reader=None) -> set[tuple[str, str]]:
    """→ {(field, term)} — every analyzed term whose idf affects scoring.

    Mirrors the resolver's analysis exactly (same analyzers, same
    all-fields expansion) so the DFS round covers precisely the statistics
    the query phase will look up. ``reader`` (optional) resolves
    more_like_this liked-document sources.
    """
    out: set[tuple[str, str]] = set()

    def fields_of(f: str) -> list[str]:
        return sorted(text_fields) if f in ("*", "_all") else [f]

    def analyze_into(f: str, text: str, analyzer_override=None):
        an = _analyzer_for(mapper_service, f, analyzer_override)
        out.update((f, tok.term) for tok in an.analyze(text))

    def walk(node: q.Query | None):
        if node is None:
            return
        t = type(node).__name__
        if t in ("MatchQuery", "MatchPhraseQuery"):
            for f in fields_of(node.field):
                analyze_into(f, node.text, node.analyzer)
        elif t == "MultiMatchQuery":
            for fspec in node.fields:
                for f in fields_of(fspec.partition("^")[0]):
                    analyze_into(f, node.text)
        elif t == "CommonTermsQuery":
            for f in fields_of(node.field):
                analyze_into(f, node.text, node.analyzer)
        elif t in ("TermQuery", "SpanTermQuery"):
            if node.field in text_fields:
                # resolver scores text terms via a keyword-analyzed match
                out.add((node.field, str(getattr(node, "value"))))
        elif t == "SpanNearQuery":
            for c in node.clauses:
                walk(c)
        elif t == "MoreLikeThisQuery":
            fields = node.fields or sorted(text_fields)
            texts_by_field = {f: list(node.like_texts) for f in fields}
            if reader is not None and node.like_docs:
                wanted = {str(s.get("_id", "")) for s in node.like_docs}
                for seg in reader.segments:
                    host = getattr(seg, "seg", seg)
                    for local, hid in enumerate(
                            host.ids[:host.num_docs]):
                        if hid in wanted:
                            src = host.sources[local]
                            for f in fields:
                                if isinstance(src.get(f), str):
                                    texts_by_field[f].append(src[f])
            # all candidate terms — the resolver's df-based selection then
            # reads GLOBAL stats, so coverage must precede selection
            for f, texts in texts_by_field.items():
                for text in texts:
                    analyze_into(f, text)
        elif t == "NestedQuery":
            walk(node.query)
        elif t == "DisMaxQuery":
            for sub in node.queries:
                walk(sub)
        elif t == "BoostingQuery":
            walk(node.positive)
            walk(node.negative)
        elif t == "BoolQuery":
            for sub in (*node.must, *node.should, *node.must_not,
                        *node.filter):
                walk(sub)
        elif t == "ConstantScoreQuery":
            walk(node.filter_query)
        elif t == "FunctionScoreQuery":
            walk(node.query)
            for fn in node.functions:
                walk(fn.filter_query)
        elif t == "ScriptScoreQuery":
            walk(node.query)
        # other leaf types (range/terms/prefix/...) are constant-score:
        # no idf in their scores
    walk(query)
    return out


def shard_dfs(reader, mapper_service, query: q.Query) -> dict:
    """Shard-side DFS collection (DfsPhase.execute analog) → wire-safe
    {"df": {"field\\x00term": n}, "fields": {field: [doc_count,
    docs_with_field, total_tokens]}}."""
    text_fields = set()
    for seg in reader.segments:
        text_fields.update(seg.text)
    terms = collect_terms(query, text_fields, mapper_service, reader=reader)
    df = {f"{f}{_SEP}{t}": reader.df(f, t) for f, t in terms}
    # collection term frequencies ride along for LM-family similarities
    # (P(t|C) must be GLOBAL under dfs_query_then_fetch, like idf)
    ctf = {}
    for f, t in terms:
        total = 0.0
        for seg in reader.segments:
            col = seg.seg.text_fields.get(f)
            if col is None:
                continue
            tid = col.tid(t)
            if tid >= 0:
                total += col.ctf(tid)
        ctf[f"{f}{_SEP}{t}"] = total
    fields = {}
    for f in {f for f, _ in terms}:
        st = reader.text_stats(f)
        fields[f] = [st.doc_count, st.docs_with_field, st.total_tokens]
    return {"df": df, "ctf": ctf, "fields": fields}


def aggregate_dfs(shard_results: list[dict]) -> dict:
    """Coordinator reduce (aggregateDfs analog) → the wire form passed to
    every shard's query phase."""
    df: dict[str, int] = {}
    ctf: dict[str, float] = {}
    fields: dict[str, list[int]] = {}
    for r in shard_results:
        for key, n in r.get("df", {}).items():
            df[key] = df.get(key, 0) + int(n)
        for key, n in r.get("ctf", {}).items():
            ctf[key] = ctf.get(key, 0.0) + float(n)
        for f, (dc, dwf, tt) in r.get("fields", {}).items():
            cur = fields.setdefault(f, [0, 0, 0])
            cur[0] += int(dc)
            cur[1] += int(dwf)
            cur[2] += int(tt)
    return {"df": df, "ctf": ctf, "fields": fields}


def to_execution_stats(wire: dict | None) -> dict | None:
    """Wire form → ExecutionContext.dfs_stats ({(field, term): df},
    per-field doc_count and avgdl)."""
    if not wire:
        return None
    df = {}
    for key, n in wire.get("df", {}).items():
        f, _, t = key.partition(_SEP)
        df[(f, t)] = int(n)
    ctf = {}
    for key, n in wire.get("ctf", {}).items():
        f, _, t = key.partition(_SEP)
        ctf[(f, t)] = float(n)
    doc_count = {}
    avgdl = {}
    total_tokens = {}
    for f, (dc, dwf, tt) in wire.get("fields", {}).items():
        doc_count[f] = int(dc)
        avgdl[f] = tt / max(dwf, 1)
        total_tokens[f] = int(tt)
    return {"df": df, "ctf": ctf, "doc_count": doc_count, "avgdl": avgdl,
            "total_tokens": total_tokens}
