"""Query DSL: ES query JSON → typed query AST.

The reference registers ~50 Parser+Builder pairs (core/index/query/, 115
files; entry IndexQueryParserService.java). Here each query type is a
dataclass node; :func:`parse_query` maps the JSON body onto the AST, and the
executor (execute.py) lowers the AST to device kernels per segment.

Supported (reference parser in parens): match_all, match_none, match
(MatchQueryParser), match_phrase (+slop), multi_match, term/terms
(TermQueryParser/TermsQueryParser), range (RangeQueryParser), exists, prefix,
wildcard, regexp, fuzzy, ids, bool (BoolQueryParser), constant_score,
function_score (FunctionScoreQueryParser: field_value_factor, weight,
random_score, script_score, gauss/exp/linear decay), script_score, knn
(no 2015 equivalent — dense-vector path, BASELINE config 4), geo_distance,
geo_bounding_box, simple_query_string/query_string (reduced grammar),
dis_max, boosting, common, template, has_child/has_parent, nested, type,
more_like_this, missing, the full span algebra (span_term/near/or/not/
first/containing/within/multi + field_masking_span — min-end interval
maps, ops/spans.py), geo_polygon, geo_distance_range, geohash_cell,
geo_shape (vertex-ring relations, ops/geoshape.py), indices, and the 2.x
compat wrappers (not, and, or, filtered, limit, wrapper).
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import field as dc_field
from typing import Any

from elasticsearch_tpu_torch.common.errors import NotPortedError, QueryParsingError


@dataclass
class Query:
    boost: float = 1.0


@dataclass
class MatchAllQuery(Query):
    pass


@dataclass
class MatchNoneQuery(Query):
    pass


@dataclass
class MatchQuery(Query):
    field: str = ""
    text: str = ""
    operator: str = "or"              # or | and
    minimum_should_match: int | str | None = None
    analyzer: str | None = None


@dataclass
class MatchPhraseQuery(Query):
    field: str = ""
    text: str = ""
    slop: int = 0
    analyzer: str | None = None


@dataclass
class MultiMatchQuery(Query):
    fields: list[str] = dc_field(default_factory=list)   # may carry ^boost
    text: str = ""
    type: str = "best_fields"         # best_fields | most_fields | phrase
    operator: str = "or"
    tie_breaker: float = 0.0


@dataclass
class TermQuery(Query):
    field: str = ""
    value: Any = None


@dataclass
class TermsQuery(Query):
    field: str = ""
    values: list = dc_field(default_factory=list)


@dataclass
class RangeQuery(Query):
    field: str = ""
    gte: Any = None
    gt: Any = None
    lte: Any = None
    lt: Any = None


@dataclass
class ExistsQuery(Query):
    field: str = ""


@dataclass
class PrefixQuery(Query):
    field: str = ""
    value: str = ""


@dataclass
class WildcardQuery(Query):
    field: str = ""
    pattern: str = ""


@dataclass
class RegexpQuery(Query):
    field: str = ""
    pattern: str = ""


@dataclass
class FuzzyQuery(Query):
    field: str = ""
    value: str = ""
    fuzziness: int | str = "AUTO"


@dataclass
class IdsQuery(Query):
    values: list[str] = dc_field(default_factory=list)


@dataclass
class BoolQuery(Query):
    must: list[Query] = dc_field(default_factory=list)
    should: list[Query] = dc_field(default_factory=list)
    must_not: list[Query] = dc_field(default_factory=list)
    filter: list[Query] = dc_field(default_factory=list)
    minimum_should_match: int | str | None = None


@dataclass
class ConstantScoreQuery(Query):
    filter_query: Query | None = None


@dataclass
class DisMaxQuery(Query):
    """ref: core/index/query/DisMaxQueryParser.java — score = best
    sub-query + tie_breaker × the rest."""
    queries: list[Query] = dc_field(default_factory=list)
    tie_breaker: float = 0.0


@dataclass
class BoostingQuery(Query):
    """ref: core/index/query/BoostingQueryParser.java — positive matches,
    demoted (× negative_boost) when the negative query also matches."""
    positive: Query | None = None
    negative: Query | None = None
    negative_boost: float = 0.5


@dataclass
class CommonTermsQuery(Query):
    """ref: core/index/query/CommonTermsQueryParser.java — terms split by
    document frequency: low-freq terms gate the match, high-freq terms
    only contribute score."""
    field: str = ""
    text: str = ""
    cutoff_frequency: float = 0.01     # ≥1 → absolute df threshold
    low_freq_operator: str = "or"
    high_freq_operator: str = "or"
    minimum_should_match_low: int | str | None = None
    minimum_should_match_high: int | str | None = None
    analyzer: str | None = None


@dataclass
class SpanTermQuery(Query):
    """ref: core/index/query/SpanTermQueryParser.java."""
    field: str = ""
    value: str = ""


@dataclass
class SpanNearQuery(Query):
    """ref: core/index/query/SpanNearQueryParser.java — clauses must
    target one field; matches spans of width ≤ clauses+slop."""
    clauses: list[Query] = dc_field(default_factory=list)
    slop: int = 0
    in_order: bool = True


@dataclass
class SpanOrQuery(Query):
    """ref: core/index/query/SpanOrQueryParser.java — union of clause
    span sets."""
    clauses: list[Query] = dc_field(default_factory=list)


@dataclass
class SpanNotQuery(Query):
    """ref: core/index/query/SpanNotQueryParser.java — include spans not
    overlapping any exclude span (pre/post widen the kill window)."""
    include: Query | None = None
    exclude: Query | None = None
    pre: int = 0
    post: int = 0


@dataclass
class SpanFirstQuery(Query):
    """ref: core/index/query/SpanFirstQueryParser.java — match spans
    ending at position ≤ ``end``."""
    match: Query | None = None
    end: int = 0


@dataclass
class SpanContainingQuery(Query):
    """ref: core/index/query/SpanContainingQueryParser.java — spans of
    ``big`` that contain a ``little`` span."""
    big: Query | None = None
    little: Query | None = None


@dataclass
class SpanWithinQuery(Query):
    """ref: core/index/query/SpanWithinQueryParser.java — spans of
    ``little`` that lie inside a ``big`` span."""
    big: Query | None = None
    little: Query | None = None


@dataclass
class SpanMultiQuery(Query):
    """ref: core/index/query/SpanMultiTermQueryParser.java — a multi-term
    query (prefix/wildcard/regexp/fuzzy) as a span: expands against the
    segment term dictionary into a position-set leaf."""
    match: Query | None = None


@dataclass
class FieldMaskingSpanQuery(Query):
    """ref: core/index/query/FieldMaskingSpanQueryParser.java — report the
    inner span under another field name so cross-field span composition
    is allowed (positions evaluated on the INNER field's token matrix)."""
    query: Query | None = None
    field: str = ""


@dataclass
class HasChildQuery(Query):
    """ref: core/index/query/HasChildQueryParser.java — parents whose
    children (docs of `type`, joined via the _parent metadata column)
    match the inner query."""
    type: str = ""
    query: Query | None = None
    score_mode: str = "none"       # none|min|max|sum|avg
    min_children: int = 0
    max_children: int = 0          # 0 = unbounded


@dataclass
class HasParentQuery(Query):
    """ref: core/index/query/HasParentQueryParser.java — children whose
    parent doc (of `parent_type`) matches the inner query."""
    parent_type: str = ""
    query: Query | None = None
    score_mode: str = "none"       # none|score


@dataclass
class ParentIdsQuery(Query):
    """INTERNAL: the shard-local rewrite target of has_child/has_parent —
    match docs whose `field` value (_id or _parent) is a key of
    `id_scores`, scoring each doc with its mapped value (the host-side
    join result; cf. the reference's ParentIdsQuery)."""
    field: str = "_id"
    id_scores: dict = dc_field(default_factory=dict)


@dataclass
class NestedQuery(Query):
    """ref: core/index/query/NestedQueryParser.java — the inner query runs
    over a path's nested objects; a parent matches when any of its objects
    does, scored per score_mode."""
    path: str = ""
    query: Query | None = None
    score_mode: str = "avg"            # avg | sum | max | min | none


@dataclass
class MoreLikeThisQuery(Query):
    """ref: core/index/query/MoreLikeThisQueryParser.java — select the
    like-input's most significant terms (tf·idf) and match on them."""
    fields: list[str] = dc_field(default_factory=list)
    like_texts: list[str] = dc_field(default_factory=list)
    like_docs: list[dict] = dc_field(default_factory=list)  # {"_id": ...}
    # `unlike` inputs: their terms are REMOVED from the selected set
    unlike_texts: list[str] = dc_field(default_factory=list)
    unlike_docs: list[dict] = dc_field(default_factory=list)
    max_query_terms: int = 25
    min_term_freq: int = 2
    min_doc_freq: int = 5
    minimum_should_match: int | str | None = "30%"
    include: bool = False              # include the liked docs themselves
    # ids to exclude from results even when their text arrived pre-fetched
    # (the coordinator rewrites like-docs into like-texts + _exclude_ids —
    # search_action.rewrite_mlt_likes; the reference fetches liked docs at
    # the coordinator too, MoreLikeThisQueryParser + TransportMltAction)
    exclude_ids: list[str] = dc_field(default_factory=list)


@dataclass
class ScoreFunction:
    kind: str                          # field_value_factor | weight | random_score
    #                                  # | script_score | gauss | exp | linear
    params: dict = dc_field(default_factory=dict)
    filter_query: Query | None = None
    weight: float | None = None


@dataclass
class FunctionScoreQuery(Query):
    query: Query | None = None
    functions: list[ScoreFunction] = dc_field(default_factory=list)
    score_mode: str = "multiply"
    boost_mode: str = "multiply"
    max_boost: float | None = None
    min_score: float | None = None


@dataclass
class ScriptScoreQuery(Query):
    query: Query | None = None
    script: str = ""
    params: dict = dc_field(default_factory=dict)


@dataclass
class KnnQuery(Query):
    """Query-DSL leaf form (back-compat alias of the top-level ``knn``
    search section): scores every vector-carrying doc by cosine through
    the generic compiled path. New callers should use the top-level
    section (:class:`KnnSection`), which rides the dedicated knn lane
    with candidate oversampling, filters and hybrid fusion."""
    field: str = ""
    query_vector: list[float] = dc_field(default_factory=list)
    num_candidates: int | None = None


#: num_candidates ceiling (the ES bound) — a request past it is a 400
MAX_NUM_CANDIDATES = 10_000


@dataclass
class KnnSection:
    """The TOP-LEVEL ``"knn"`` search section (field, query_vector, k,
    num_candidates, filter, boost), combinable with a ``"query"`` clause
    for hybrid BM25+vector fusion. ``query_vector`` is a flat [D] list
    for ``dense_vector`` fields or a [T, D] list-of-lists for
    ``rank_vectors`` (late-interaction MaxSim). Search is EXACT
    (brute-force scoring of every live vector): ``num_candidates`` is
    the per-shard candidate depth each lane feeds into filtering and
    hybrid fusion — unlike ANN engines it never trades recall, it only
    bounds the fusion/merge width."""
    field: str = ""
    query_vector: list = dc_field(default_factory=list)
    k: int = 10
    num_candidates: int = 100
    filter: Query | None = None
    boost: float = 1.0
    multi: bool = False        # [T, D] late-interaction query
    hybrid: bool = False       # request also carries a "query" clause


def parse_knn_section(body) -> KnnSection:
    """Parse + validate the top-level ``knn`` section. Violations raise
    :class:`QueryParsingError` (the 400 the REST layer maps) at parse
    time — before any device work."""
    if not isinstance(body, dict):
        raise QueryParsingError("[knn] must be an object")
    field = body.get("field")
    if not field:
        raise QueryParsingError("[knn] requires [field]")
    qv = body.get("query_vector")
    if not isinstance(qv, list) or not qv:
        raise QueryParsingError(
            "[knn] requires a non-empty [query_vector]")
    multi = isinstance(qv[0], (list, tuple))
    if multi:
        dims = len(qv[0])
        for row in qv:
            if not isinstance(row, (list, tuple)) or len(row) != dims \
                    or not row:
                raise QueryParsingError(
                    "[knn] multi-vector query_vector rows must all "
                    "share one dimension")
        qv = [[float(x) for x in row] for row in qv]
    else:
        qv = [float(x) for x in qv]
    try:
        k = int(body.get("k", 10))
    except (TypeError, ValueError):
        raise QueryParsingError(
            f"[knn] k must be an integer, got [{body.get('k')}]") \
            from None
    if k < 1:
        raise QueryParsingError(f"[knn] k must be >= 1, got {k}")
    raw_nc = body.get("num_candidates", max(k, 100))
    try:
        nc = int(raw_nc)
    except (TypeError, ValueError):
        raise QueryParsingError(
            f"[knn] num_candidates must be an integer, got [{raw_nc}]") \
            from None
    if nc < k:
        raise QueryParsingError(
            f"[knn] num_candidates [{nc}] must be >= k [{k}]")
    if nc > MAX_NUM_CANDIDATES:
        raise QueryParsingError(
            f"[knn] num_candidates [{nc}] must be <= "
            f"{MAX_NUM_CANDIDATES}")
    boost = float(body.get("boost", 1.0))
    if boost <= 0:
        raise QueryParsingError(
            f"[knn] boost must be > 0, got {boost}")
    filt = None
    if body.get("filter") is not None:
        raw_f = body["filter"]
        if isinstance(raw_f, list):     # ES accepts a list of filters
            filt = BoolQuery(filter=[parse_query(f) for f in raw_f])
        else:
            filt = parse_query(raw_f)
    unknown = set(body) - {"field", "query_vector", "k",
                           "num_candidates", "filter", "boost"}
    if unknown:
        raise QueryParsingError(
            f"[knn] unknown parameter(s) {sorted(unknown)}")
    return KnnSection(field=str(field), query_vector=qv, k=k,
                      num_candidates=nc, filter=filt, boost=boost,
                      multi=multi)


@dataclass
class GeoDistanceQuery(Query):
    field: str = ""
    lat: float = 0.0
    lon: float = 0.0
    distance_m: float = 0.0


@dataclass
class GeoBoundingBoxQuery(Query):
    field: str = ""
    top: float = 0.0
    left: float = 0.0
    bottom: float = 0.0
    right: float = 0.0


@dataclass
class GeoPolygonQuery(Query):
    """ref: core/index/query/GeoPolygonQueryParser.java — point-in-polygon
    via even-odd ray casting over the vertex ring."""
    field: str = ""
    lats: list[float] = dc_field(default_factory=list)
    lons: list[float] = dc_field(default_factory=list)


@dataclass
class GeoDistanceRangeQuery(Query):
    """ref: core/index/query/GeoDistanceRangeQueryParser.java — annulus:
    from ≤ distance(point, origin) ≤ to."""
    field: str = ""
    lat: float = 0.0
    lon: float = 0.0
    gte_m: float | None = None
    gt_m: float | None = None
    lte_m: float | None = None
    lt_m: float | None = None


@dataclass
class GeohashCellQuery(Query):
    """ref: core/index/query/GeohashCellQuery.java — docs whose point
    falls in a geohash cell (plus the 8 neighbors when asked)."""
    field: str = ""
    geohash: str = ""
    neighbors: bool = False


@dataclass
class GeoShapeQuery(Query):
    """ref: core/index/query/GeoShapeQueryParser.java — spatial relation
    between each doc's indexed shape and the query shape."""
    field: str = ""
    shape: dict = dc_field(default_factory=dict)   # GeoJSON-ish body
    relation: str = "intersects"   # intersects | disjoint | within | contains


@dataclass
class IndicesQuery(Query):
    """ref: core/index/query/IndicesQueryParser.java — per-shard: run
    ``query`` when the shard's index is listed, else ``no_match_query``."""
    indices: list[str] = dc_field(default_factory=list)
    query: Query | None = None
    no_match_query: Query | None = None   # None = match_all (the default)


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

_DISTANCE_UNITS = {"m": 1.0, "km": 1000.0, "mi": 1609.344, "yd": 0.9144,
                   "ft": 0.3048, "cm": 0.01, "mm": 0.001, "nmi": 1852.0}


def parse_distance(v: Any) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip().lower()
    for unit in sorted(_DISTANCE_UNITS, key=len, reverse=True):
        if s.endswith(unit):
            return float(s[: -len(unit)]) * _DISTANCE_UNITS[unit]
    return float(s)


def _field_body(body: dict, qtype: str) -> tuple[str, Any]:
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError(f"[{qtype}] query expects a single field")
    return next(iter(body.items()))


def _parse_msm(v) -> int | str | None:
    return v


def span_effective_fields(node: Query | None) -> set[str]:
    """The field(s) a span query's positions come from, AFTER masking:
    field_masking_span reports its mask field (that is its purpose —
    FieldMaskingSpanQueryParser), so validation that all clauses agree on
    one field treats masked clauses as the masked name."""
    if node is None:
        return set()
    t = type(node).__name__
    if t == "SpanTermQuery":
        return {node.field}
    if t == "FieldMaskingSpanQuery":
        return {node.field}
    if t == "SpanMultiQuery":
        f = getattr(node.match, "field", None)
        return {f} if f else set()
    if t in ("SpanOrQuery", "SpanNearQuery"):
        out: set[str] = set()
        for c in node.clauses:
            out |= span_effective_fields(c)
        return out
    if t == "SpanNotQuery":
        return span_effective_fields(node.include) | \
            span_effective_fields(node.exclude)
    if t == "SpanFirstQuery":
        return span_effective_fields(node.match)
    if t in ("SpanContainingQuery", "SpanWithinQuery"):
        return span_effective_fields(node.big) | \
            span_effective_fields(node.little)
    return set()


# Plugin-registered query parsers ({name: fn(body) -> Query}) — the SPI seam
# the reference exposes via IndicesQueriesModule/onModule(IndicesQueriesModule)
# (query parsers registered by plugins). PluginsService.apply_node_start fills
# this; parse_query falls back to it after the built-in arms.
EXTRA_PARSERS: dict[str, Any] = {}


def parse_query(body: dict | None) -> Query:  # noqa: C901 — one arm per query type
    if body is None or body == {}:
        return MatchAllQuery()
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError(
            f"query must contain exactly one top-level type, got {list(body or {})}")
    qtype, qbody = next(iter(body.items()))

    if qtype == "match_all":
        return MatchAllQuery(boost=float(qbody.get("boost", 1.0)))
    if qtype == "match_none":
        return MatchNoneQuery()

    if qtype == "match":
        fname, spec = _field_body(qbody, "match")
        if isinstance(spec, dict):
            return MatchQuery(
                field=fname, text=str(spec.get("query", "")),
                operator=str(spec.get("operator", "or")).lower(),
                minimum_should_match=_parse_msm(spec.get("minimum_should_match")),
                analyzer=spec.get("analyzer"),
                boost=float(spec.get("boost", 1.0)))
        return MatchQuery(field=fname, text=str(spec))

    if qtype in ("match_phrase", "text_phrase"):
        fname, spec = _field_body(qbody, qtype)
        if isinstance(spec, dict):
            return MatchPhraseQuery(field=fname, text=str(spec.get("query", "")),
                                    slop=int(spec.get("slop", 0)),
                                    analyzer=spec.get("analyzer"),
                                    boost=float(spec.get("boost", 1.0)))
        return MatchPhraseQuery(field=fname, text=str(spec))

    if qtype == "multi_match":
        return MultiMatchQuery(
            fields=list(qbody.get("fields", [])), text=str(qbody.get("query", "")),
            type=qbody.get("type", "best_fields"),
            operator=str(qbody.get("operator", "or")).lower(),
            tie_breaker=float(qbody.get("tie_breaker", 0.0)),
            boost=float(qbody.get("boost", 1.0)))

    if qtype in ("term", "terms") and isinstance(qbody, dict) \
            and len(qbody) == 1 and next(iter(qbody)) in ("_id", "_uid"):
        # the _id/_uid metadata field resolves through the ids query
        # (ref: core/index/mapper/internal/IdFieldMapper termQuery)
        _f, spec = next(iter(qbody.items()))
        vals = spec.get("value", spec.get("values")) \
            if isinstance(spec, dict) else spec
        vals = vals if isinstance(vals, list) else [vals]
        return IdsQuery(values=[str(v) for v in vals])

    if qtype == "term":
        fname, spec = _field_body(qbody, "term")
        if isinstance(spec, dict):
            return TermQuery(field=fname, value=spec.get("value"),
                             boost=float(spec.get("boost", 1.0)))
        return TermQuery(field=fname, value=spec)

    if qtype == "terms":
        items = {k: v for k, v in qbody.items() if k != "boost"}
        fname, values = _field_body(items, "terms")
        return TermsQuery(field=fname, values=list(values),
                          boost=float(qbody.get("boost", 1.0)))

    if qtype == "range":
        fname, spec = _field_body(qbody, "range")
        if not isinstance(spec, dict):
            raise QueryParsingError("[range] expects an object of bounds")
        # gt/gte (and lt/lte) share ONE bound slot, last key in body
        # order wins — the reference's RangeQueryParser assigns from/
        # includeLower per parsed key IN BODY ORDER, so a later gt
        # overwrites an earlier gte entirely and include_lower/
        # include_upper (the 2.x flag spellings) also apply at their
        # position ("from" leaves the inclusivity flag untouched)
        lo = hi = None
        lo_incl = hi_incl = True
        for kk, vv in spec.items():
            if kk == "from":
                lo = vv
            elif kk == "gte":
                lo, lo_incl = vv, True
            elif kk == "gt":
                lo, lo_incl = vv, False
            elif kk == "include_lower":
                lo_incl = bool(vv)
            elif kk == "to":
                hi = vv
            elif kk == "lte":
                hi, hi_incl = vv, True
            elif kk == "lt":
                hi, hi_incl = vv, False
            elif kk == "include_upper":
                hi_incl = bool(vv)
        return RangeQuery(field=fname,
                          gte=lo if lo_incl else None,
                          gt=None if lo_incl else lo,
                          lte=hi if hi_incl else None,
                          lt=None if hi_incl else hi,
                          boost=float(spec.get("boost", 1.0)))

    if qtype == "exists":
        return ExistsQuery(field=qbody["field"])
    if qtype == "missing":  # ES 2.x: missing == must_not exists
        return BoolQuery(must_not=[ExistsQuery(field=qbody["field"])])

    if qtype == "prefix":
        fname, spec = _field_body(qbody, "prefix")
        if isinstance(spec, dict):
            return PrefixQuery(field=fname, value=str(spec.get("value", "")),
                               boost=float(spec.get("boost", 1.0)))
        return PrefixQuery(field=fname, value=str(spec))

    if qtype == "wildcard":
        fname, spec = _field_body(qbody, "wildcard")
        if isinstance(spec, dict):
            return WildcardQuery(field=fname,
                                 pattern=str(spec.get("value", spec.get("wildcard", ""))),
                                 boost=float(spec.get("boost", 1.0)))
        return WildcardQuery(field=fname, pattern=str(spec))

    if qtype == "regexp":
        fname, spec = _field_body(qbody, "regexp")
        if isinstance(spec, dict):
            return RegexpQuery(field=fname, pattern=str(spec.get("value", "")),
                               boost=float(spec.get("boost", 1.0)))
        return RegexpQuery(field=fname, pattern=str(spec))

    if qtype == "fuzzy":
        fname, spec = _field_body(qbody, "fuzzy")
        if isinstance(spec, dict):
            return FuzzyQuery(field=fname, value=str(spec.get("value", "")),
                              fuzziness=spec.get("fuzziness", "AUTO"),
                              boost=float(spec.get("boost", 1.0)))
        return FuzzyQuery(field=fname, value=str(spec))

    if qtype == "ids":
        return IdsQuery(values=[str(v) for v in qbody.get("values", [])])

    if qtype == "bool":
        def as_list(v):
            if v is None:
                return []
            return v if isinstance(v, list) else [v]
        return BoolQuery(
            must=[parse_query(q) for q in as_list(qbody.get("must"))],
            should=[parse_query(q) for q in as_list(qbody.get("should"))],
            must_not=[parse_query(q) for q in as_list(qbody.get("must_not"))],
            filter=[parse_query(q) for q in as_list(qbody.get("filter"))],
            minimum_should_match=_parse_msm(qbody.get("minimum_should_match")),
            boost=float(qbody.get("boost", 1.0)))

    if qtype == "constant_score":
        return ConstantScoreQuery(
            filter_query=parse_query(qbody.get("filter", qbody.get("query"))),
            boost=float(qbody.get("boost", 1.0)))

    if qtype == "dis_max":
        return DisMaxQuery(
            queries=[parse_query(sub) for sub in qbody.get("queries", [])],
            tie_breaker=float(qbody.get("tie_breaker", 0.0)),
            boost=float(qbody.get("boost", 1.0)))

    if qtype == "boosting":
        if "positive" not in qbody or "negative" not in qbody:
            raise QueryParsingError(
                "[boosting] query requires 'positive' and 'negative'")
        return BoostingQuery(
            positive=parse_query(qbody["positive"]),
            negative=parse_query(qbody["negative"]),
            negative_boost=float(qbody.get("negative_boost", 0.5)),
            boost=float(qbody.get("boost", 1.0)))

    if qtype == "common":
        fname, spec = _field_body(qbody, "common")
        if not isinstance(spec, dict):
            spec = {"query": spec}
        msm = spec.get("minimum_should_match")
        msm_low = msm_high = None
        if isinstance(msm, dict):
            msm_low = _parse_msm(msm.get("low_freq"))
            msm_high = _parse_msm(msm.get("high_freq"))
        else:
            msm_low = _parse_msm(msm)
        return CommonTermsQuery(
            field=fname, text=str(spec.get("query", "")),
            cutoff_frequency=float(spec.get("cutoff_frequency", 0.01)),
            low_freq_operator=str(spec.get("low_freq_operator",
                                           "or")).lower(),
            high_freq_operator=str(spec.get("high_freq_operator",
                                            "or")).lower(),
            minimum_should_match_low=msm_low,
            minimum_should_match_high=msm_high,
            analyzer=spec.get("analyzer"),
            boost=float(spec.get("boost", 1.0)))

    if qtype == "span_term":
        fname, spec = _field_body(qbody, "span_term")
        if isinstance(spec, dict):
            return SpanTermQuery(field=fname,
                                 value=str(spec.get("value",
                                                    spec.get("term", ""))),
                                 boost=float(spec.get("boost", 1.0)))
        return SpanTermQuery(field=fname, value=str(spec))

    if qtype == "span_near":
        clauses = [parse_query(c) for c in qbody.get("clauses", [])]
        if not clauses:
            raise QueryParsingError("[span_near] requires clauses")
        span_types = (SpanTermQuery, SpanNearQuery, SpanOrQuery,
                      SpanNotQuery, SpanFirstQuery, SpanContainingQuery,
                      SpanWithinQuery, SpanMultiQuery,
                      FieldMaskingSpanQuery)
        for c in clauses:
            if not isinstance(c, span_types):
                raise QueryParsingError(
                    "[span_near] clauses must be span queries")
        fields = set()
        for c in clauses:
            fields |= span_effective_fields(c)
        if len(fields) > 1:
            raise QueryParsingError(
                "[span_near] clauses must target one field "
                "(use field_masking_span to combine fields)")
        return SpanNearQuery(clauses=clauses,
                             slop=int(qbody.get("slop", 0)),
                             in_order=bool(qbody.get("in_order", True)),
                             boost=float(qbody.get("boost", 1.0)))

    if qtype == "template":
        # template QUERY (ref: core/index/query/TemplateQueryParser.java):
        # render the mustache body to a query dict, then parse it
        raise NotPortedError("the [template] query is not ported yet")

    if qtype == "has_child":
        if "type" not in qbody or "query" not in qbody:
            raise QueryParsingError("[has_child] requires 'type' and "
                                    "'query'")
        sm = str(qbody.get("score_mode", "none")).lower()
        if sm == "total":                  # 2.x alias
            sm = "sum"
        return HasChildQuery(type=str(qbody["type"]),
                             query=parse_query(qbody["query"]),
                             score_mode=sm,
                             min_children=int(qbody.get("min_children", 0)),
                             max_children=int(qbody.get("max_children", 0)),
                             boost=float(qbody.get("boost", 1.0)))

    if qtype == "has_parent":
        ptype = qbody.get("parent_type", qbody.get("type"))
        if ptype is None or "query" not in qbody:
            raise QueryParsingError("[has_parent] requires 'parent_type' "
                                    "and 'query'")
        sm = str(qbody.get("score_mode", "none")).lower()
        return HasParentQuery(parent_type=str(ptype),
                              query=parse_query(qbody["query"]),
                              score_mode=sm,
                              boost=float(qbody.get("boost", 1.0)))

    if qtype == "type":
        # {"type": {"value": t}} filters by the _type metadata column
        # (ref: TypeQueryParser)
        return TermQuery(field="_type", value=str(qbody.get("value", "")))

    if qtype == "nested":
        if "path" not in qbody or "query" not in qbody:
            raise QueryParsingError("[nested] requires 'path' and 'query'")
        score_mode = str(qbody.get("score_mode", "avg")).lower()
        if score_mode == "total":          # 2.x alias
            score_mode = "sum"
        if score_mode not in ("avg", "sum", "max", "min", "none"):
            raise QueryParsingError(
                f"illegal score_mode for nested query [{score_mode}]")
        return NestedQuery(path=str(qbody["path"]),
                           query=parse_query(qbody["query"]),
                           score_mode=score_mode,
                           boost=float(qbody.get("boost", 1.0)))

    if qtype in ("more_like_this", "mlt"):
        like_texts: list[str] = []
        like_docs: list[dict] = []
        raw_like = qbody.get("like", qbody.get("like_text"))
        for item in (raw_like if isinstance(raw_like, list)
                     else [raw_like] if raw_like is not None else []):
            if isinstance(item, dict):
                like_docs.append(item)
            else:
                like_texts.append(str(item))
        for did in qbody.get("ids", []) or []:
            like_docs.append(did if isinstance(did, dict) else {"_id": did})
        for item in qbody.get("docs", []) or []:
            if isinstance(item, dict) and "doc" in item:
                # artificial document: its string values are like-texts
                like_texts.extend(str(v) for v in item["doc"].values()
                                  if isinstance(v, str))
            else:
                like_docs.append(item if isinstance(item, dict)
                                 else {"_id": item})
        unlike_texts: list[str] = []
        unlike_docs: list[dict] = []
        raw_unlike = qbody.get("unlike")
        for item in (raw_unlike if isinstance(raw_unlike, list)
                     else [raw_unlike] if raw_unlike is not None else []):
            if isinstance(item, dict) and "doc" in item:
                unlike_texts.extend(str(v) for v in item["doc"].values()
                                    if isinstance(v, str))
            elif isinstance(item, dict):
                unlike_docs.append(item)
            else:
                unlike_texts.append(str(item))
        if not like_texts and not like_docs:
            raise QueryParsingError(
                "[more_like_this] requires 'like' text or docs")
        fields = qbody.get("fields", [])
        return MoreLikeThisQuery(
            fields=list(fields),
            like_texts=like_texts, like_docs=like_docs,
            unlike_texts=unlike_texts, unlike_docs=unlike_docs,
            exclude_ids=[str(x) for x in qbody.get("_exclude_ids", [])],
            max_query_terms=int(qbody.get("max_query_terms", 25)),
            min_term_freq=int(qbody.get("min_term_freq", 2)),
            min_doc_freq=int(qbody.get("min_doc_freq", 5)),
            minimum_should_match=_parse_msm(
                qbody.get("minimum_should_match", "30%")),
            include=bool(qbody.get("include", False)),
            boost=float(qbody.get("boost", 1.0)))

    if qtype == "function_score":
        functions = []
        raw_fns = qbody.get("functions")
        if raw_fns is None:
            raw_fns = [ {k: v for k, v in qbody.items()
                         if k in ("field_value_factor", "script_score", "weight",
                                  "random_score", "gauss", "exp", "linear")} ]
        for fdef in raw_fns:
            fq = parse_query(fdef["filter"]) if "filter" in fdef else None
            weight = fdef.get("weight")
            kind, params = None, {}
            for key in ("field_value_factor", "script_score", "random_score",
                        "gauss", "exp", "linear"):
                if key in fdef:
                    kind = key
                    params = fdef[key]
                    break
            if kind is None:
                if weight is None:
                    raise QueryParsingError("function_score function without type")
                kind = "weight"
            functions.append(ScoreFunction(kind=kind, params=params,
                                           filter_query=fq,
                                           weight=None if weight is None
                                           else float(weight)))
        return FunctionScoreQuery(
            query=parse_query(qbody.get("query")),
            functions=functions,
            score_mode=qbody.get("score_mode", "multiply"),
            boost_mode=qbody.get("boost_mode", "multiply"),
            max_boost=(None if qbody.get("max_boost") is None
                       else float(qbody["max_boost"])),
            min_score=(None if qbody.get("min_score") is None
                       else float(qbody["min_score"])),
            boost=float(qbody.get("boost", 1.0)))

    if qtype == "script_score":
        script = qbody.get("script", {})
        if isinstance(script, dict):
            src = script.get("source", script.get("inline", ""))
            params = script.get("params", {})
        else:
            src, params = str(script), {}
        return ScriptScoreQuery(query=parse_query(qbody.get("query")),
                                script=src, params=params,
                                boost=float(qbody.get("boost", 1.0)))

    if qtype == "knn":
        return KnnQuery(field=qbody["field"],
                        query_vector=list(qbody["query_vector"]),
                        num_candidates=qbody.get("num_candidates"),
                        boost=float(qbody.get("boost", 1.0)))

    if qtype == "geo_distance":
        dist = parse_distance(qbody.get("distance"))
        point_items = {k: v for k, v in qbody.items() if k != "distance"}
        fname, point = next(iter(point_items.items()))
        if isinstance(point, dict):
            lat, lon = float(point["lat"]), float(point["lon"])
        elif isinstance(point, (list, tuple)):
            lon, lat = float(point[0]), float(point[1])
        else:
            lat, lon = (float(x) for x in str(point).split(","))
        return GeoDistanceQuery(field=fname, lat=lat, lon=lon, distance_m=dist)

    if qtype == "geo_bounding_box":
        fname, box = next(iter(qbody.items()))
        tl, br = box["top_left"], box["bottom_right"]
        return GeoBoundingBoxQuery(field=fname,
                                   top=float(tl["lat"]), left=float(tl["lon"]),
                                   bottom=float(br["lat"]), right=float(br["lon"]))

    if qtype in ("query_string", "simple_query_string"):
        raise NotPortedError(f"the [{qtype}] query is not ported yet")

    # ---- span algebra (SpanOr/Not/First/Containing/Within/MultiTerm,
    # FieldMaskingSpan parsers under core/index/query/) -------------------
    if qtype == "span_or":
        clauses = [parse_query(c) for c in qbody.get("clauses", [])]
        if not clauses:
            raise QueryParsingError("[span_or] requires 'clauses'")
        fields = set()
        for c in clauses:
            fields |= span_effective_fields(c)
        if len(fields) > 1:
            raise QueryParsingError(
                "[span_or] clauses must target one field "
                "(use field_masking_span to combine fields)")
        return SpanOrQuery(clauses=clauses,
                           boost=float(qbody.get("boost", 1.0)))
    if qtype == "span_not":
        if "include" not in qbody or "exclude" not in qbody:
            raise QueryParsingError(
                "[span_not] requires 'include' and 'exclude'")
        dist = int(qbody.get("dist", 0))
        return SpanNotQuery(include=parse_query(qbody["include"]),
                            exclude=parse_query(qbody["exclude"]),
                            pre=int(qbody.get("pre", dist)),
                            post=int(qbody.get("post", dist)),
                            boost=float(qbody.get("boost", 1.0)))
    if qtype == "span_first":
        if "match" not in qbody:
            raise QueryParsingError("[span_first] requires 'match'")
        return SpanFirstQuery(match=parse_query(qbody["match"]),
                              end=int(qbody.get("end", 0)),
                              boost=float(qbody.get("boost", 1.0)))
    if qtype in ("span_containing", "span_within"):
        if "big" not in qbody or "little" not in qbody:
            raise QueryParsingError(
                f"[{qtype}] requires 'big' and 'little'")
        cls = SpanContainingQuery if qtype == "span_containing" \
            else SpanWithinQuery
        return cls(big=parse_query(qbody["big"]),
                   little=parse_query(qbody["little"]),
                   boost=float(qbody.get("boost", 1.0)))
    if qtype == "span_multi":
        if "match" not in qbody:
            raise QueryParsingError("[span_multi] requires 'match'")
        return SpanMultiQuery(match=parse_query(qbody["match"]),
                              boost=float(qbody.get("boost", 1.0)))
    if qtype == "field_masking_span":
        if "query" not in qbody or "field" not in qbody:
            raise QueryParsingError(
                "[field_masking_span] requires 'query' and 'field'")
        return FieldMaskingSpanQuery(query=parse_query(qbody["query"]),
                                     field=str(qbody["field"]),
                                     boost=float(qbody.get("boost", 1.0)))

    # ---- geo long tail --------------------------------------------------
    if qtype == "geo_polygon":
        fname, spec = _field_body(qbody, "geo_polygon")
        lats, lons = [], []
        for p in spec.get("points", []):
            if isinstance(p, dict):
                lats.append(float(p["lat"]))
                lons.append(float(p["lon"]))
            elif isinstance(p, (list, tuple)):
                lons.append(float(p[0]))
                lats.append(float(p[1]))
            else:
                la, lo = (float(x) for x in str(p).split(","))
                lats.append(la)
                lons.append(lo)
        if len(lats) < 3:
            raise QueryParsingError(
                "[geo_polygon] requires at least 3 points")
        return GeoPolygonQuery(field=fname, lats=lats, lons=lons)
    if qtype == "geo_distance_range":
        keys = {"from", "to", "gte", "gt", "lte", "lt", "include_lower",
                "include_upper", "unit", "distance_type", "boost",
                "_name", "validation_method", "optimize_bbox"}
        point_items = {k: v for k, v in qbody.items()
                       if k not in keys and not k.startswith("_")}
        if not point_items:
            raise QueryParsingError(
                "[geo_distance_range] requires a geo_point field")
        fname, point = next(iter(point_items.items()))
        if isinstance(point, dict):
            lat, lon = float(point["lat"]), float(point["lon"])
        elif isinstance(point, (list, tuple)):
            lon, lat = float(point[0]), float(point[1])
        else:
            lat, lon = (float(x) for x in str(point).split(","))
        inc_lo = bool(qbody.get("include_lower", True))
        inc_hi = bool(qbody.get("include_upper", True))
        lo = qbody.get("gte", qbody.get("from"))
        lo_x = qbody.get("gt")
        hi = qbody.get("lte", qbody.get("to"))
        hi_x = qbody.get("lt")
        if lo is not None and not inc_lo:
            lo, lo_x = None, lo
        if hi is not None and not inc_hi:
            hi, hi_x = None, hi
        return GeoDistanceRangeQuery(
            field=fname, lat=lat, lon=lon,
            gte_m=None if lo is None else parse_distance(lo),
            gt_m=None if lo_x is None else parse_distance(lo_x),
            lte_m=None if hi is None else parse_distance(hi),
            lt_m=None if hi_x is None else parse_distance(hi_x))
    if qtype in ("geohash_cell", "geohash_filter"):
        raise NotPortedError(f"the [{qtype}] query is not ported yet")
    if qtype == "geo_shape":
        fname, spec = _field_body(qbody, "geo_shape")
        shape = spec.get("shape")
        if shape is None:
            raise QueryParsingError(
                "[geo_shape] requires an inline 'shape' "
                "(indexed-shape lookup is resolved by the caller)")
        return GeoShapeQuery(field=fname, shape=dict(shape),
                             relation=str(spec.get("relation",
                                                   "intersects")).lower())

    # ---- compatibility / wrapper types ----------------------------------
    if qtype == "indices":
        idx = qbody.get("indices", qbody.get("index"))
        if idx is None or "query" not in qbody:
            raise QueryParsingError(
                "[indices] requires 'indices' and 'query'")
        nmq = qbody.get("no_match_query", "all")
        if nmq == "all":
            no_match = None
        elif nmq == "none":
            no_match = MatchNoneQuery()
        else:
            no_match = parse_query(nmq)
        return IndicesQuery(
            indices=[idx] if isinstance(idx, str) else [str(i) for i in idx],
            query=parse_query(qbody["query"]), no_match_query=no_match)
    if qtype == "not":
        # ref: NotQueryParser — matches docs NOT matching the inner query
        # (accepts the bare, {"query": ...} and 1.x {"filter": ...} forms)
        inner = qbody
        if isinstance(qbody, dict):
            inner = qbody.get("query", qbody.get("filter", qbody))
        return BoolQuery(must=[MatchAllQuery()],
                         must_not=[parse_query(inner)])
    if qtype == "and":
        clauses = qbody.get("filters", qbody) if isinstance(qbody, dict) \
            else qbody
        return BoolQuery(filter=[parse_query(c) for c in clauses])
    if qtype == "or":
        clauses = qbody.get("filters", qbody) if isinstance(qbody, dict) \
            else qbody
        return BoolQuery(should=[parse_query(c) for c in clauses],
                         minimum_should_match=1)
    if qtype == "filtered":
        # 2.x compat (FilteredQueryParser): query scored, filter as mask
        out = BoolQuery(must=[parse_query(qbody.get("query"))])
        if qbody.get("filter") is not None:
            out.filter = [parse_query(qbody["filter"])]
        return out
    if qtype == "limit":
        # deprecated in 2.x: parses and matches everything (LimitQueryParser)
        return MatchAllQuery()
    if qtype == "wrapper":
        import base64
        import json as _json
        raw = qbody.get("query") if isinstance(qbody, dict) else qbody
        try:
            decoded = _json.loads(base64.b64decode(raw))
        except Exception as e:
            raise QueryParsingError(f"[wrapper] bad base64 query: {e}")
        return parse_query(decoded)

    extra = EXTRA_PARSERS.get(qtype)
    if extra is not None:
        return extra(qbody)

    raise QueryParsingError(f"unknown query type [{qtype}]")
