"""Highlighting — plain and passage highlighters, phrase-accurate.

Counterpart of ``elasticsearch_tpu/search/highlight.py``, host-only (it
runs at fetch time on the final hits, and in the percolator on the probe
doc). Reference: core/search/highlight/ — HighlightPhase drives the plain
highlighter (QueryScorer over re-analyzed text), PostingsHighlighter
(passage scoring from postings offsets) or FastVectorHighlighter
(term-vector phrase-accurate fragments). All are phrase-accurate: a
match_phrase "quick fox" only highlights "quick" adjacent to "fox", never
stray occurrences.

* query **units** are extracted per field — single terms and positional
  units (phrases / span-near chains with slop + order);
* the stored text is analyzed once into position/offset-annotated tokens;
  positional units match against token POSITIONS, so phrase highlighting
  marks only real phrase occurrences (a sloppy phrase within its window);
* ``type: plain`` (default) wraps matches and emits char-window
  fragments; ``type: postings`` / ``fvh`` / ``unified`` build
  sentence-broken PASSAGES, score them (unit weight × occurrence count),
  keep the top ``number_of_fragments`` and emit them in document order,
  with ``no_match_size`` returning the leading passage when nothing
  matched (PostingsHighlighter semantics).
"""

from __future__ import annotations

import re

from elasticsearch_tpu_torch.search import query_dsl as q


# ---------------------------------------------------------------------------
# query unit extraction
# ---------------------------------------------------------------------------

class _Units:
    """Extracted per-field highlight units."""

    def __init__(self):
        self.terms: set[str] = set()
        # (terms tuple, slop, in_order)
        self.phrases: list[tuple[tuple[str, ...], int, bool]] = []

    def empty(self) -> bool:
        return not self.terms and not self.phrases


def _analyzer_for(field: str, mapper_service, override: str | None = None,
                  for_index: bool = False):
    """``for_index=True`` → the INDEX analyzer (stored doc text must be
    re-analyzed the way it was indexed — an edge_ngram index analyzer
    with a standard search analyzer only highlights if the doc side
    produces the ngrams the query terms are); False → the search
    analyzer (query text)."""
    if override:
        a = mapper_service.analysis.get(override)
        if a is not None:
            return a
    fm = mapper_service.field_mapper(field)
    if fm is not None and getattr(fm, "kind", None) == "text":
        return fm.analyzer if for_index else fm.search_analyzer
    return mapper_service.analysis.get("standard")


def _span_terms(node, field: str) -> list[str] | None:
    """Flatten a span clause into its term sequence for `field` (None =
    not this field / unsupported shape, skip)."""
    if isinstance(node, q.SpanTermQuery):
        return [str(node.value).lower()] if node.field == field or \
            field == "*" else None
    if isinstance(node, q.FieldMaskingSpanQuery):
        return _span_terms(node.query, field)
    if isinstance(node, q.SpanFirstQuery):
        return _span_terms(node.match, field)
    return None


def _extract_units(query, field: str, mapper_service) -> _Units:
    units = _Units()

    def walk(node):
        if isinstance(node, q.MatchQuery):
            if node.field == field or field == "*":
                analyzer = _analyzer_for(node.field, mapper_service,
                                         node.analyzer)
                units.terms.update(
                    t.term for t in analyzer.analyze(node.text))
        elif isinstance(node, q.MatchPhraseQuery):
            if node.field == field or field == "*":
                analyzer = _analyzer_for(node.field, mapper_service,
                                         node.analyzer)
                terms = tuple(t.term
                              for t in analyzer.analyze(node.text))
                if len(terms) == 1:
                    units.terms.add(terms[0])
                elif terms:
                    units.phrases.append((terms, int(node.slop), True))
        elif isinstance(node, q.TermQuery):
            if node.field == field or field == "*":
                units.terms.add(str(node.value).lower())
        elif isinstance(node, q.TermsQuery):
            if node.field == field or field == "*":
                units.terms.update(str(v).lower() for v in node.values)
        elif isinstance(node, q.CommonTermsQuery):
            if node.field == field or field == "*":
                analyzer = _analyzer_for(node.field, mapper_service)
                units.terms.update(
                    t.term for t in analyzer.analyze(node.text))
        elif isinstance(node, q.MultiMatchQuery):
            for fspec in node.fields:
                fname = fspec.split("^")[0]
                if fname == field or field == "*":
                    analyzer = _analyzer_for(fname, mapper_service)
                    units.terms.update(
                        t.term for t in analyzer.analyze(node.text))
        elif isinstance(node, q.SpanNearQuery):
            seq: list[str] = []
            ok = True
            for cl in node.clauses:
                ts = _span_terms(cl, field)
                if ts is None:
                    ok = False
                    break
                seq.extend(ts)
            if ok and seq:
                if len(seq) == 1:
                    units.terms.add(seq[0])
                else:
                    units.phrases.append((tuple(seq), int(node.slop),
                                          bool(node.in_order)))
        elif isinstance(node, (q.SpanTermQuery, q.SpanFirstQuery,
                               q.FieldMaskingSpanQuery)):
            ts = _span_terms(node, field)
            if ts:
                units.terms.update(ts)
        elif isinstance(node, q.SpanOrQuery):
            for cl in node.clauses:
                walk(cl)
        elif isinstance(node, q.SpanNotQuery):
            walk(node.include)
        elif isinstance(node, (q.SpanContainingQuery, q.SpanWithinQuery)):
            walk(node.big)
            walk(node.little)
        elif isinstance(node, q.BoolQuery):
            for sub in (*node.must, *node.should, *node.filter):
                walk(sub)
        elif isinstance(node, q.DisMaxQuery):
            for sub in node.queries:
                walk(sub)
        elif isinstance(node, q.BoostingQuery):
            walk(node.positive)
        elif isinstance(node, q.FunctionScoreQuery):
            walk(node.query)
        elif isinstance(node, q.ConstantScoreQuery):
            walk(node.filter_query)
        elif isinstance(node, q.ScriptScoreQuery):
            walk(node.query)

    walk(query)
    units.terms.discard("")
    return units


# ---------------------------------------------------------------------------
# match finding (positional — phrase-accurate)
# ---------------------------------------------------------------------------

def _find_match_spans(tokens, units: _Units) -> list[tuple[int, int, int]]:
    """→ [(start_offset, end_offset, weight)] of real matches.

    Single terms match every occurrence at weight 1. Positional units
    match only token runs that satisfy the phrase/span semantics
    (adjacency for slop 0; width ≤ len+slop windows otherwise, order
    respected when in_order) at weight len(unit) — the specificity
    weighting of PassageScorer."""
    spans: list[tuple[int, int, int]] = []
    for t in tokens:
        if t.term in units.terms:
            spans.append((t.start_offset, t.end_offset, 1))
    if units.phrases:
        by_term: dict[str, list] = {}
        for t in tokens:
            by_term.setdefault(t.term, []).append(t)
        for terms, slop, in_order in units.phrases:
            occs = [by_term.get(term) for term in terms]
            if any(not o for o in occs):
                continue
            w = len(terms)
            if slop == 0 and in_order:
                # exact adjacency on positions
                for t0 in occs[0]:
                    run = [t0]
                    p = t0.position
                    ok = True
                    for nxt in occs[1:]:
                        p += 1
                        hit = next((t for t in nxt if t.position == p),
                                   None)
                        if hit is None:
                            ok = False
                            break
                        run.append(hit)
                    if ok:
                        for t in run:
                            spans.append((t.start_offset, t.end_offset,
                                          w))
            else:
                # sloppy window: pick one occurrence per clause inside a
                # window of width ≤ len+slop (order enforced if asked) —
                # greedy earliest-window sweep, the NearSpans discipline
                spans.extend(
                    (t.start_offset, t.end_offset, w)
                    for t in _sloppy_matches(occs, slop, in_order))
    return spans


def _sloppy_matches(occs: list, slop: int, in_order: bool) -> list:
    width = len(occs) + slop
    out = []
    for t0 in occs[0]:
        lo = t0.position
        chosen = [t0]
        ok = True
        prev = t0.position
        for nxt in occs[1:]:
            if in_order:
                cands = [t for t in nxt
                         if prev < t.position <= lo + width - 1]
            else:
                # a later clause's term may PRECEDE the anchor by up to
                # the full window (the final wmax-wmin check enforces
                # exactness) — bounding at lo - slop would miss
                # "quick fox" for span_near [fox, quick] slop 0
                cands = [t for t in nxt
                         if lo - (len(occs) - 1 + slop) <= t.position
                         <= lo + width - 1
                         and all(t.position != c.position
                                 for c in chosen)]
            if not cands:
                ok = False
                break
            hit = min(cands, key=lambda t: t.position)
            chosen.append(hit)
            prev = hit.position
        if ok:
            wmin = min(t.position for t in chosen)
            wmax = max(t.position for t in chosen)
            if wmax - wmin <= len(occs) - 1 + slop:
                out.extend(chosen)
    return out


def _merge_spans(spans: list[tuple[int, int, int]]
                 ) -> list[tuple[int, int, int]]:
    if not spans:
        return []
    spans.sort(key=lambda s: (s[0], -s[1]))
    merged = [spans[0]]
    for s, e, w in spans[1:]:
        ls, le, lw = merged[-1]
        if s <= le:
            merged[-1] = (ls, max(e, le), max(w, lw))
        else:
            merged.append((s, e, w))
    return merged


# ---------------------------------------------------------------------------
# plain highlighter (char-window fragments; now phrase-accurate)
# ---------------------------------------------------------------------------

def highlight_field(text: str, units: _Units, analyzer,
                    pre_tag: str, post_tag: str,
                    fragment_size: int,
                    number_of_fragments: int) -> list[str]:
    if units.empty():
        return []
    tokens = analyzer.analyze(text)
    merged = _merge_spans(_find_match_spans(tokens, units))
    if not merged:
        return []
    if number_of_fragments == 0:
        out = []
        last = 0
        for s, e, _ in merged:
            out.append(text[last:s])
            out.append(pre_tag + text[s:e] + post_tag)
            last = e
        out.append(text[last:])
        return ["".join(out)]
    # cluster nearby matches into one window each, then wrap EVERY
    # match inside the window (a phrase's second term must not appear
    # bare beside its highlighted first term)
    clusters: list[list[tuple[int, int, int]]] = [[merged[0]]]
    for sp in merged[1:]:
        if sp[0] - clusters[-1][0][0] <= fragment_size:
            clusters[-1].append(sp)
        else:
            clusters.append([sp])
    fragments = []
    for cluster in clusters[:number_of_fragments]:
        cs, ce = cluster[0][0], cluster[-1][1]
        lo = max(0, cs - fragment_size // 2)
        hi = min(len(text), ce + fragment_size // 2)
        out = []
        last = lo
        for s, e, _ in cluster:
            out.append(text[last:s])
            out.append(pre_tag + text[s:e] + post_tag)
            last = e
        out.append(text[last:hi])
        fragments.append("".join(out))
    return fragments


# ---------------------------------------------------------------------------
# postings-class highlighter (passage scoring + best fragments)
# ---------------------------------------------------------------------------

_SENTENCE_BREAK = re.compile(r"(?<=[.!?。！？\n])\s*")


def _passages(text: str, max_len: int) -> list[tuple[int, int]]:
    """Sentence-broken passages, long sentences split at max_len —
    Java BreakIterator.getSentenceInstance behavior approximated."""
    out = []
    start = 0
    for m in _SENTENCE_BREAK.finditer(text):
        end = m.end()
        if end > start:
            out.append((start, end))
            start = end
    if start < len(text):
        out.append((start, len(text)))
    split: list[tuple[int, int]] = []
    for s, e in out:
        while e - s > max_len * 2:
            cut = text.rfind(" ", s, s + max_len)
            cut = cut if cut > s else s + max_len
            split.append((s, cut))
            s = cut
        split.append((s, e))
    return split


def _snap_bounds_to_spans(bounds: list[tuple[int, int]],
                          merged: list[tuple[int, int, int]]
                          ) -> list[tuple[int, int]]:
    """A sentence break falling INSIDE a match span (the '.' of a
    whitespace-analyzed token like "3.5") must not split the span
    across passages — it would fail containment in both and silently
    drop the highlight. Snap such boundaries to the span end."""
    if len(bounds) < 2 or not merged:
        return bounds
    start, endall = bounds[0][0], bounds[-1][1]
    out = []
    for b in (b_s for b_s, _ in bounds[1:]):
        for s, e, _ in merged:
            if s < b < e:
                b = e
                break
        b = min(b, endall)
        if b > start:
            out.append((start, b))
            start = b
    if start < endall:
        out.append((start, endall))
    return out


def highlight_field_passages(text: str, units: _Units, analyzer,
                             pre_tag: str, post_tag: str,
                             fragment_size: int,
                             number_of_fragments: int,
                             no_match_size: int = 0) -> list[str]:
    tokens = analyzer.analyze(text)
    merged = _merge_spans(_find_match_spans(tokens, units)) \
        if not units.empty() else []
    if not merged:
        if no_match_size > 0 and text:
            bounds = _passages(text, max(fragment_size, 1))
            s, e = bounds[0]
            return [text[s:min(e, s + no_match_size)]]
        return []
    bounds = _snap_bounds_to_spans(
        _passages(text, max(fragment_size, 1)), merged)
    scored = []
    for pi, (ps, pe) in enumerate(bounds):
        inside = [(s, e, w) for s, e, w in merged
                  if s >= ps and e <= pe]
        if not inside:
            continue
        # PassageScorer discipline: unit weight × count, longer
        # passages slightly penalized so tight matches win ties
        score = sum(w for _, _, w in inside) * \
            (1.0 + 1.0 / (1.0 + (pe - ps) / max(fragment_size, 1)))
        scored.append((score, pi, ps, pe, inside))
    scored.sort(key=lambda x: (-x[0], x[1]))
    top = sorted(scored[:max(number_of_fragments, 1)],
                 key=lambda x: x[1])          # document order
    frags = []
    for _, _, ps, pe, inside in top:
        out = []
        last = ps
        for s, e, _ in inside:
            out.append(text[last:s])
            out.append(pre_tag + text[s:e] + post_tag)
            last = e
        out.append(text[last:pe])
        frags.append("".join(out).strip())
    return frags


# ---------------------------------------------------------------------------
# fetch-phase entry
# ---------------------------------------------------------------------------

_PASSAGE_TYPES = ("postings", "fvh", "fast-vector-highlighter", "unified")


def highlight_hit(spec: dict, source: dict, mapper_service, query) -> dict:
    pre = (spec.get("pre_tags") or ["<em>"])[0]
    post = (spec.get("post_tags") or ["</em>"])[0]
    out = {}
    for fname, fspec in (spec.get("fields") or {}).items():
        fspec = fspec or {}
        fragment_size = int(fspec.get("fragment_size",
                                      spec.get("fragment_size", 100)))
        nfrags = int(fspec.get("number_of_fragments",
                               spec.get("number_of_fragments", 5)))
        htype = str(fspec.get("type", spec.get("type", "plain")))
        no_match = int(fspec.get("no_match_size",
                                 spec.get("no_match_size", 0)))
        value = _get_path(source, fname)
        if value is None:
            continue
        analyzer = _analyzer_for(fname, mapper_service, for_index=True)
        units = _extract_units(query, fname, mapper_service)
        values = value if isinstance(value, list) else [value]
        frags: list[str] = []
        for v in values:
            if htype in _PASSAGE_TYPES:
                frags.extend(highlight_field_passages(
                    str(v), units, analyzer, pre, post, fragment_size,
                    nfrags, no_match_size=no_match))
            else:
                frags.extend(highlight_field(
                    str(v), units, analyzer, pre, post, fragment_size,
                    nfrags))
        if frags:
            out[fname] = frags[:nfrags] if nfrags > 0 else frags
    return out


def _get_path(source: dict, path: str):
    node = source
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node
