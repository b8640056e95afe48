"""query_string / simple_query_string — reduced Lucene query grammar.

A copy of ``elasticsearch_tpu/search/query_string.py`` (the port imports
nothing of the JAX package). Reference: QueryStringQueryParser / SimpleQueryStringParser
(core/index/query/). Supported grammar subset:

    term term2              → OR of match terms (default_operator applies)
    "a phrase"              → match_phrase
    field:term              → match on that field
    field:"a phrase"        → phrase on that field
    +term / -term           → must / must_not
    term AND term2          → must
    term OR term2           → should
    NOT term                → must_not
    field:[a TO b]          → range (inclusive); {a TO b} exclusive

Parsed into the same AST the structured DSL uses.
"""

from __future__ import annotations

import re

from elasticsearch_tpu_torch.common.errors import QueryParsingError
from elasticsearch_tpu_torch.search.query_dsl import (
    BoolQuery, MatchAllQuery, MatchPhraseQuery, MatchQuery, Query,
    RangeQuery, WildcardQuery)

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<op>AND|OR|NOT)\b
      | (?P<mod>[+-])?
        (?:(?P<field>[\w.*]+):)?
        (?:
            "(?P<phrase>[^"]*)"
          | (?P<rng>[\[{][^\]}]*\s+TO\s+[^\]}]*[\]}])
          | (?P<term>[^\s"]+)
        )
    )""", re.VERBOSE)


def _leaf(field: str | None, phrase: str | None, rng: str | None,
          term: str | None, default_field: str,
          analyzer: str | None = None,
          lowercase_expanded: bool = True) -> Query:
    f = field or default_field
    if phrase is not None:
        return MatchPhraseQuery(field=f, text=phrase, analyzer=analyzer)
    if term and ("*" in term or "?" in term):
        # expanded (wildcard) terms bypass analysis; Lucene's
        # lowercase_expanded_terms (default true) lowercases the pattern
        pat = term.lower() if lowercase_expanded else term
        return WildcardQuery(field=f, pattern=pat)
    if rng is not None:
        inc_lo, inc_hi = rng[0] == "[", rng[-1] == "]"
        lo, hi = re.split(r"\s+TO\s+", rng[1:-1].strip())
        def parse_bound(s):
            if s == "*":
                return None
            try:
                return float(s)
            except ValueError:
                return s
        q = RangeQuery(field=f)
        if inc_lo:
            q.gte = parse_bound(lo)
        else:
            q.gt = parse_bound(lo)
        if inc_hi:
            q.lte = parse_bound(hi)
        else:
            q.lt = parse_bound(hi)
        return q
    return MatchQuery(field=f, text=term or "", analyzer=analyzer)


def parse_query_string(qbody: dict) -> Query:
    qs = str(qbody.get("query", ""))
    default_field = qbody.get("default_field", qbody.get("fields", ["*"])[0]
                              if qbody.get("fields") else "*")
    if default_field.endswith("^0") or "^" in default_field:
        default_field = default_field.split("^")[0]
    default_op = str(qbody.get("default_operator", "or")).lower()
    analyzer = qbody.get("analyzer")
    lowercase_expanded = qbody.get("lowercase_expanded_terms", True)
    if isinstance(lowercase_expanded, str):
        lowercase_expanded = lowercase_expanded.lower() != "false"

    must: list[Query] = []
    should: list[Query] = []
    must_not: list[Query] = []
    pending_op: str | None = None
    negate_next = False

    pos = 0
    any_token = False
    while pos < len(qs):
        m = _TOKEN_RE.match(qs, pos)
        if not m or m.end() == pos:
            break
        pos = m.end()
        if m.group("op"):
            op = m.group("op")
            if op == "NOT":
                negate_next = True
            else:
                pending_op = op
            continue
        any_token = True
        leaf = _leaf(m.group("field"), m.group("phrase"), m.group("rng"),
                     m.group("term"), default_field, analyzer,
                     lowercase_expanded)
        mod = m.group("mod")
        if negate_next or mod == "-":
            must_not.append(leaf)
            negate_next = False
        elif mod == "+" or pending_op == "AND" or \
                (pending_op is None and default_op == "and"):
            # AND binds the previous should-clause too (approximation of
            # Lucene precedence: a AND b → both must)
            if pending_op == "AND" and should:
                must.append(should.pop())
            must.append(leaf)
        else:
            should.append(leaf)
        pending_op = None

    if not any_token:
        if qs.strip():
            raise QueryParsingError(f"could not parse query_string [{qs}]")
        return MatchAllQuery()
    if len(should) == 1 and not must and not must_not:
        return should[0]
    return BoolQuery(must=must, should=should, must_not=must_not)
