"""Mapping: JSON documents → typed, indexable field values.

The reference's mapper (core/index/mapper/MapperService.java,
DocumentMapper.java) turns a JSON source into Lucene fields, infers mappings
dynamically for unseen fields, and merges mapping updates. Ours turns JSON
into **columnar segment inputs**:

* ``text``      → analyzed token stream (positions kept) → token matrix rows
* ``keyword``   → exact values → ordinal doc-values column (also ES 2.x
                  ``string`` with ``index: not_analyzed``)
* numerics/date/boolean → float64 doc-values column + exists bitmap
* ``dense_vector`` → fixed-dim float32 row in the vector matrix
* ``geo_point`` → (lat, lon) pair of float64 columns

Metadata fields (_id, _source, _routing, _version) are handled by the engine,
matching the reference's internal mappers (core/index/mapper/internal/).
"""

from __future__ import annotations

import datetime as _dt
import numbers
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from json import dumps as _json_dumps

from elasticsearch_tpu_torch.utils.murmur3 import hash128_x64_h1

from elasticsearch_tpu_torch.analysis import AnalysisRegistry, Token
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, MapperParsingError, NotPortedError)
from elasticsearch_tpu_torch.common.settings import parse_bool

# Field kinds the segment builder understands.
KIND_TEXT = "text"
KIND_KEYWORD = "keyword"
KIND_NUMERIC = "numeric"   # long/integer/short/byte/double/float/date/boolean
KIND_VECTOR = "vector"
KIND_MVECTOR = "mvector"   # rank_vectors: per-doc [T, D] token matrices
KIND_GEO = "geo"
KIND_SHAPE = "shape"

#: dense_vector / rank_vectors dims ceiling — bounds the per-doc row the
#: MXU matmuls over (and the create-request 400 for absurd mappings)
MAX_VECTOR_DIMS = 4096
#: rank_vectors token cap ceiling (per-doc [T, D] matrices are padded to
#: the mapping's max_tokens, so T is HBM — keep it bounded)
MAX_RANK_VECTOR_TOKENS = 512
DEFAULT_RANK_VECTOR_TOKENS = 32

NUMERIC_TYPES = {"long", "integer", "short", "byte", "double", "float",
                 "half_float", "date", "boolean", "murmur3", "ip",
                 "token_count"}
KIND_BINARY = "binary"


def ip_to_long(v) -> int:
    """Dotted-quad IPv4 → long, the reference's IpFieldMapper.ipToLong
    (core/index/mapper/ip/IpFieldMapper.java) — indexed as a numeric
    doc value so ranges and CIDR terms are ordinary numeric intervals."""
    parts = str(v).split(".")
    if len(parts) != 4:
        raise MapperParsingError(f"failed to parse ip [{v}]")
    out = 0
    for p in parts:
        try:
            b = int(p)
        except ValueError:
            raise MapperParsingError(f"failed to parse ip [{v}]") \
                from None
        if not 0 <= b <= 255:
            raise MapperParsingError(f"failed to parse ip [{v}]")
        out = (out << 8) | b
    return out


def cidr_range(v: str) -> tuple[int, int]:
    """'a.b.c.d/n' → (network, broadcast) longs."""
    addr, _, bits = str(v).partition("/")
    try:
        n = int(bits)
    except ValueError:
        raise MapperParsingError(f"invalid CIDR mask [{v}]") from None
    if not 0 <= n <= 32:
        raise MapperParsingError(f"invalid CIDR mask [{v}]")
    base = ip_to_long(addr)
    mask = ((1 << 32) - 1) ^ ((1 << (32 - n)) - 1)
    lo = base & mask
    return lo, lo | ((1 << (32 - n)) - 1)

POSITION_INCREMENT_GAP = 16


def _vector_dims(name: str, ftype: str, params) -> int:
    """Validate a vector mapping's ``dims`` at CREATE time with the
    400-typed error idiom (store.type / impact settings): a bad value
    must fail the create/mapping request, never surface later as a
    score-time shape error."""
    raw = params.get("dims", 0)
    try:
        dims = int(raw)
    except (TypeError, ValueError):
        raise IllegalArgumentError(
            f"{ftype} field [{name}] dims must be an integer, "
            f"got [{raw}]") from None
    if dims <= 0:
        raise MapperParsingError(f"{ftype} field [{name}] requires dims")
    if dims > MAX_VECTOR_DIMS:
        raise IllegalArgumentError(
            f"{ftype} field [{name}] dims must be <= {MAX_VECTOR_DIMS}, "
            f"got {dims}")
    return dims


def completion_context_value(cfg: dict, raw) -> str:
    """One context dimension's value → its index key component."""
    if cfg.get("type") == "geo":
        raise NotPortedError("geo completion contexts are not ported yet")
    return str(raw)


def completion_context_keys(cfg: dict, provided: dict,
                            path_values: dict | None = None) -> list[str]:
    """Context config + per-value context → the key prefixes an input is
    indexed under (one per combination; ref: ContextMapping.parseContext).
    A `path` dimension with no resolved value yet yields a placeholder the
    DocumentMapper post-pass replaces from the doc source."""
    dims: list[list[str]] = []
    for name in sorted(cfg):
        c = cfg[name] or {}
        raw = provided.get(name)
        if raw is None and path_values and name in path_values:
            raw = path_values[name]
        if raw is None and c.get("path"):
            dims.append([f"\x00PATH:{name}"])
            continue
        if raw is None:
            raw = c.get("default", "")
        vals = raw if isinstance(raw, list) else [raw]
        dims.append([completion_context_value(c, v) for v in vals])
    keys = [""]
    for vals in dims:
        keys = [f"{k}\x1d{v}" if k else str(v)
                for k in keys for v in vals]
    return keys


def parse_date(value: Any) -> float:
    """→ epoch millis (float). Accepts epoch millis, ISO-8601, yyyy-MM-dd."""
    if isinstance(value, bool):
        raise MapperParsingError(f"cannot parse date from boolean [{value}]")
    if isinstance(value, numbers.Number):
        return float(value)
    s = str(value)
    for parser in (
        lambda v: _dt.datetime.fromisoformat(v.replace("Z", "+00:00")),
        lambda v: _dt.datetime.strptime(v, "%Y-%m-%d"),
        lambda v: _dt.datetime.strptime(v, "%Y-%m-%d %H:%M:%S"),
    ):
        try:
            dt = parser(s)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=_dt.timezone.utc)
            return dt.timestamp() * 1000.0
        except ValueError:
            continue
    try:
        return float(s)  # epoch millis as string
    except ValueError:
        raise MapperParsingError(f"failed to parse date field [{value}]") from None


@dataclass
class ParsedField:
    name: str
    kind: str
    tokens: list[Token] = field(default_factory=list)      # KIND_TEXT
    keywords: list[str] = field(default_factory=list)       # KIND_KEYWORD
    numerics: list[float] = field(default_factory=list)     # KIND_NUMERIC
    vector: np.ndarray | None = None                        # KIND_VECTOR
    mvector: np.ndarray | None = None                       # KIND_MVECTOR [T, D]
    geo: tuple[float, float] | None = None                  # KIND_GEO (lat, lon)
    # KIND_SHAPE: (lats, lons) closed vertex ring (utils/geoshape)
    shape: tuple[list[float], list[float]] | None = None


@dataclass
class ParsedDocument:
    doc_id: str
    source: dict
    fields: dict[str, ParsedField]
    routing: str | None = None
    # nested path → one field-dict per nested object (each becomes a row
    # of the segment's child block; ref: ObjectMapper Nested,
    # core/index/mapper/object/ObjectMapper.java — nested objects are
    # separate hidden docs adjacent to their parent)
    nested: dict[str, list[dict[str, ParsedField]]] = field(
        default_factory=dict)


class FieldMapper:
    """One field's mapping entry."""

    def __init__(self, name: str, ftype: str, params: Mapping[str, Any],
                 analysis: AnalysisRegistry):
        self.name = name
        self.type = ftype
        self.params = dict(params)
        # ES 2.x "string" splits into text vs keyword on index: not_analyzed
        # (reference: core/index/mapper/core/StringFieldMapper.java).
        if ftype == "string":
            self.type = "keyword" if params.get("index") == "not_analyzed" else "text"
        elif ftype == "multi_field":
            # pre-1.0 multi_field syntax (still accepted in 2.x): the
            # sub-field named like the field is the main mapping
            main = (params.get("fields") or {}).get(name.split(".")[-1], {})
            self.type = "keyword" if main.get("index") == "not_analyzed" \
                else "text"
        if self.type == "text":
            self.kind = KIND_TEXT
            self.analyzer = analysis.get(params.get("analyzer", "standard"))
            self.search_analyzer = analysis.get(
                params.get("search_analyzer", params.get("analyzer", "standard")))
        elif self.type in ("keyword", "completion"):
            # completion (suggest) inputs are stored as exact values; the
            # suggester prefix-scans the sorted vocab, standing in for the
            # reference's FST-backed CompletionFieldMapper
            self.kind = KIND_KEYWORD
            # context suggester config (ContextMappings, 2.x "context" on
            # completion fields): {name: {type: category|geo, default?,
            # path?, precision?}}
            self.context_config = params.get("context") \
                if self.type == "completion" else None
        elif self.type in NUMERIC_TYPES:
            self.kind = KIND_NUMERIC
            if self.type == "token_count":
                # TokenCountFieldMapper: analyze the string, index the
                # token count as a numeric doc value
                self.analyzer = analysis.get(
                    params.get("analyzer", "standard"))
        elif self.type == "binary":
            # BinaryFieldMapper: stored in _source only (not indexed, no
            # doc values by default — matches the reference's defaults)
            self.kind = KIND_BINARY
        elif self.type == "dense_vector":
            self.kind = KIND_VECTOR
            self.dims = _vector_dims(name, "dense_vector", params)
        elif self.type == "rank_vectors":
            # multi-vector late-interaction mapping: each doc carries a
            # [T, D] token matrix (ColBERT-style), padded/bucketed like
            # the uterms columns; scored by the fused MaxSim kernel
            # (ops/maxsim.py) through the top-level `knn` search section
            self.kind = KIND_MVECTOR
            self.dims = _vector_dims(name, "rank_vectors", params)
            raw_mt = params.get("max_tokens", DEFAULT_RANK_VECTOR_TOKENS)
            try:
                self.max_tokens = int(raw_mt)
            except (TypeError, ValueError):
                raise IllegalArgumentError(
                    f"rank_vectors field [{name}] max_tokens must be an "
                    f"integer, got [{raw_mt}]") from None
            if not 1 <= self.max_tokens <= MAX_RANK_VECTOR_TOKENS:
                raise IllegalArgumentError(
                    f"rank_vectors field [{name}] max_tokens must be in "
                    f"[1, {MAX_RANK_VECTOR_TOKENS}], got {self.max_tokens}")
        elif self.type == "geo_point":
            self.kind = KIND_GEO
        elif self.type == "geo_shape":
            self.kind = KIND_SHAPE
        else:
            raise MapperParsingError(f"no handler for type [{ftype}] on field [{name}]")
        # Multi-fields: {"fields": {"raw": {"type": "keyword"}}}
        self.sub_fields: dict[str, FieldMapper] = {}
        for sub_name, sub_def in params.get("fields", {}).items():
            self.sub_fields[sub_name] = FieldMapper(
                f"{name}.{sub_name}", sub_def.get("type", "keyword"), sub_def, analysis)

    def to_dict(self) -> dict:
        # render the type the mapping was PUT with (2.x "string" stays
        # "string" even though it resolved to text/keyword internally;
        # legacy multi_field renders as string like the reference upgrade)
        rendered = self.params.get("type", self.type)
        if rendered == "multi_field":
            rendered = "string"
        out = {"type": rendered,
               **{k: v for k, v in self.params.items()
                  if k not in ("type", "fields")}}
        if self.sub_fields:
            out["fields"] = {n.split(".")[-1]: m.to_dict()
                             for n, m in self.sub_fields.items()}
        return out

    # ---- value parsing ----------------------------------------------------

    def parse_value(self, value: Any) -> ParsedField:
        pf = ParsedField(self.name, self.kind)
        if self.kind in (KIND_VECTOR, KIND_MVECTOR):
            values = [value]
        elif self.kind == KIND_GEO and isinstance(value, (list, tuple)) \
                and len(value) == 2 and all(isinstance(x, numbers.Number)
                                            for x in value):
            values = [value]  # flat GeoJSON pair [lon, lat], not a multi-value
        elif isinstance(value, list):
            values = value
        else:
            values = [value]
        if self.kind == KIND_TEXT:
            position = 0
            for v in values:
                if v is None:
                    continue
                toks = self.analyzer.analyze(str(v))
                # Position gap between array elements blocks phrase matches
                # across elements (Lucene's position_increment_gap, default
                # 100 there; 16 here because the segment layout is
                # position-indexed and slots are memory).
                for t in toks:
                    pf.tokens.append(Token(t.term, t.position + position,
                                           t.start_offset, t.end_offset))
                if toks:
                    position += toks[-1].position + POSITION_INCREMENT_GAP
        elif self.kind == KIND_KEYWORD:
            if self.type == "completion":
                # completion accepts "text", ["a","b"], or
                # {"input": [...], "weight": N} (CompletionFieldMapper
                # parse shapes); weights degrade to doc frequency here
                flat: list[str] = []
                for v in values:
                    inputs: list[str]
                    provided_ctx: dict = {}
                    if isinstance(v, dict):
                        inp = v.get("input", [])
                        inputs = [inp] if isinstance(inp, str) else \
                            [str(x) for x in inp]
                        provided_ctx = v.get("context") or {}
                    elif v is not None:
                        inputs = [str(v)]
                    else:
                        continue
                    cfg = getattr(self, "context_config", None)
                    # match keys are lowercased (CompletionFieldMapper's
                    # default "simple" index analyzer); the original text
                    # rides after \x1e for display
                    encoded = [f"{i.lower()}\x1e{i}" for i in inputs]
                    if cfg:
                        keys = completion_context_keys(cfg, provided_ctx)
                        flat.extend(f"{key}\x1f{e}" for key in keys
                                    for e in encoded)
                    else:
                        flat.extend(encoded)
                pf.keywords = flat
            else:
                pf.keywords = [str(v) for v in values if v is not None]
        elif self.kind == KIND_NUMERIC:
            for v in values:
                if v is None:
                    continue
                if self.type == "date":
                    pf.numerics.append(parse_date(v))
                elif self.type == "boolean":
                    try:
                        pf.numerics.append(1.0 if parse_bool(v, self.name) else 0.0)
                    except IllegalArgumentError:
                        raise MapperParsingError(
                            f"failed to parse [{self.name}] value [{v}] as boolean"
                        ) from None
                elif self.type == "ip":
                    if isinstance(v, (int, float)):
                        pf.numerics.append(float(v))
                    else:
                        pf.numerics.append(float(ip_to_long(v)))
                elif self.type == "token_count":
                    pf.numerics.append(
                        float(len(self.analyzer.analyze(str(v)))))
                elif self.type == "murmur3":
                    # mapper-murmur3 plugin: index hash128(value).h1 as a
                    # long doc-value (Murmur3FieldMapper.java:137) — feeds
                    # cardinality aggs on pre-hashed values. f64 storage
                    # keeps 53 of the 64 bits; collisions stay negligible
                    # for distinct-count purposes
                    pf.numerics.append(
                        float(hash128_x64_h1(str(v).encode("utf-8"))))
                else:
                    try:
                        pf.numerics.append(float(v))
                    except (TypeError, ValueError):
                        raise MapperParsingError(
                            f"failed to parse [{self.name}] value [{v}] as {self.type}"
                        ) from None
        elif self.kind == KIND_VECTOR:
            arr = np.asarray(value, dtype=np.float32)
            if arr.shape != (self.dims,):
                raise MapperParsingError(
                    f"dense_vector [{self.name}] expects dims [{self.dims}], "
                    f"got shape {arr.shape}")
            pf.vector = arr
        elif self.kind == KIND_MVECTOR:
            try:
                arr = np.asarray(value, dtype=np.float32)
            except (TypeError, ValueError):
                raise MapperParsingError(
                    f"rank_vectors [{self.name}] expects a list of "
                    f"[{self.dims}]-dim vectors") from None
            if arr.ndim == 1:              # one token: [D] → [1, D]
                arr = arr[None, :]
            if arr.ndim != 2 or arr.shape[1] != self.dims or \
                    arr.shape[0] == 0:
                raise MapperParsingError(
                    f"rank_vectors [{self.name}] expects [T, {self.dims}] "
                    f"token vectors, got shape {arr.shape}")
            # token cap is a mapping contract like text max_tokens:
            # overflow truncates (index-time), never errors
            pf.mvector = arr[:self.max_tokens]
        elif self.kind == KIND_SHAPE:
            raise NotPortedError(
                f"geo_shape field [{self.name}] is not ported yet")
        elif self.kind == KIND_GEO:
            v = values[0]
            if isinstance(v, dict):
                pf.geo = (float(v["lat"]), float(v["lon"]))
            elif isinstance(v, str):
                lat, lon = v.split(",")
                pf.geo = (float(lat), float(lon))
            elif isinstance(v, (list, tuple)):  # GeoJSON order [lon, lat]
                pf.geo = (float(v[1]), float(v[0]))
            else:
                raise MapperParsingError(f"cannot parse geo_point [{value}]")
        return pf


def validate_vector_mappings(mappings: Mapping[str, Any]) -> None:
    """Create-index-time validation of vector field mappings (the
    store.type / impact-settings idiom): dims bounds and rank_vectors
    token caps must fail the CREATE REQUEST with the 400-typed error —
    the cluster-state applier swallows exceptions, so a bad mapping
    validated only there would silently produce a broken index."""
    def walk(props: Mapping[str, Any]) -> None:
        for name, fdef in (props or {}).items():
            if not isinstance(fdef, Mapping):
                continue
            ftype = fdef.get("type")
            if ftype in ("dense_vector", "rank_vectors"):
                # constructing the mapper runs the full validation
                FieldMapper(name, ftype, fdef, _VALIDATION_ANALYSIS)
            if "properties" in fdef:
                walk(fdef["properties"])
    for _type, m in (mappings or {}).items():
        if isinstance(m, Mapping):
            walk(m.get("properties", {}))


class _LazyAnalysis:
    """Deferred AnalysisRegistry for the validation probe (vector
    mappings never touch analyzers, so none is ever built)."""

    def get(self, name):
        return AnalysisRegistry().get(name)


_VALIDATION_ANALYSIS = _LazyAnalysis()


class DocumentMapper:
    """Per-type document mapping (reference: DocumentMapper.java)."""

    def __init__(self, type_name: str, mapping_def: Mapping[str, Any],
                 analysis: AnalysisRegistry, dynamic: bool = True):
        self.type_name = type_name
        self.analysis = analysis
        self.root: dict[str, Any] = dict(mapping_def)
        self.dynamic = {"true": True, "false": False, "strict": "strict"}.get(
            str(mapping_def.get("dynamic", dynamic)).lower(), True)
        self.mappers: dict[str, FieldMapper] = {}
        # paths mapped {"type": "nested"} — their objects index as child
        # rows (segment nested blocks), not flattened parent fields
        self.nested_paths: set[str] = set()
        # metadata-field configs (ref: core/index/mapper/internal/
        # {Parent,Timestamp,TTL}FieldMapper): _parent joins this type to a
        # parent type; _timestamp/_ttl stamp per-doc numeric columns
        p = mapping_def.get("_parent") or {}
        self.parent_type: str | None = p.get("type")
        def _on(v):
            return str(v).lower() in ("true", "1", "yes", "on")
        ts = mapping_def.get("_timestamp") or {}
        self.timestamp_enabled = _on(ts.get("enabled", "false"))
        self.timestamp_default: str | None = ts.get("default")
        ttl = mapping_def.get("_ttl") or {}
        self.ttl_enabled = _on(ttl.get("enabled", "false"))
        self.ttl_default: str | None = ttl.get("default")
        # mapper-size plugin: {"_size": {"enabled": true}} indexes the
        # source byte length as a long doc-value under _size
        # (plugins/mapper-size/.../SizeFieldMapper.java)
        self.size_enabled = _on((mapping_def.get("_size") or {})
                                .get("enabled", "false"))
        self._build(mapping_def.get("properties", {}), prefix="")

    def _build(self, properties: Mapping[str, Any], prefix: str,
               in_nested: bool = False) -> None:
        for name, fdef in properties.items():
            full = f"{prefix}{name}"
            if fdef.get("type") == "nested":
                if in_nested:
                    # reject up front: a silently-dropped inner block would
                    # make data unsearchable with no error
                    raise MapperParsingError(
                        f"nested field [{full}] inside a nested field is "
                        f"not supported")
                self.nested_paths.add(full)
                self._build(fdef.get("properties", {}), prefix=f"{full}.",
                            in_nested=True)
                continue
            if "properties" in fdef and "type" not in fdef:   # object field
                self._build(fdef["properties"], prefix=f"{full}.",
                            in_nested=in_nested)
                continue
            self.add_mapper(FieldMapper(full, fdef.get("type", "text"), fdef,
                                        self.analysis))

    def add_mapper(self, mapper: FieldMapper) -> None:
        self.mappers[mapper.name] = mapper
        for sub in mapper.sub_fields.values():
            self.mappers[sub.name] = sub

    # ---- dynamic mapping inference (DocumentParser dynamic templates) -----

    def _infer(self, name: str, value: Any) -> FieldMapper | None:
        if value is None:
            return None
        if isinstance(value, list):
            if not value:
                return None
            value = value[0]
        if isinstance(value, bool):
            ftype = "boolean"
        elif isinstance(value, int):
            ftype = "long"
        elif isinstance(value, float):
            ftype = "double"
        elif isinstance(value, str):
            # date detection mirrors the reference's dynamic date formats
            try:
                parse_date(value)
                is_date = any(c in value for c in "-:T") and value[:4].isdigit()
            except MapperParsingError:
                is_date = False
            ftype = "date" if is_date else "text"
        else:
            return None
        params = {"type": ftype}
        if ftype == "text":
            # dynamic strings get a .keyword sub-field (modern ES default)
            params["fields"] = {"keyword": {"type": "keyword"}}
        return FieldMapper(name, ftype, params, self.analysis)

    # ---- parse ------------------------------------------------------------

    def parse(self, doc_id: str, source: Mapping[str, Any],
              routing: str | None = None,
              meta: Mapping[str, Any] | None = None) -> ParsedDocument:
        fields: dict[str, ParsedField] = {}
        nested: dict[str, list[dict[str, ParsedField]]] = {}
        new_mappers: list[FieldMapper] = []
        self._parse_object(source, "", fields, new_mappers, nested)
        for m in new_mappers:        # dynamic mapping update
            self.add_mapper(m)
        # resolve completion-context `path` placeholders from the doc
        # source (ContextMapping path references another field's value)
        for fname, pf in fields.items():
            if not pf.keywords or "\x00PATH:" not in "".join(pf.keywords):
                continue
            fm = self.mappers.get(fname)
            cfg = getattr(fm, "context_config", None) or {}
            resolved = []
            for key in pf.keywords:
                for name, c in cfg.items():
                    ph = f"\x00PATH:{name}"
                    if ph in key:
                        raw = source.get(c.get("path", ""))
                        if raw is None:
                            raw = c.get("default", "")
                        key = key.replace(
                            ph, completion_context_value(c, raw))
                resolved.append(key)
            pf.keywords = resolved
        if meta:
            # metadata fields index as ordinary columns under their
            # reserved names — _type/_parent keyword, _timestamp/_ttl
            # numeric — so type filters, parent joins, and TTL sweeps are
            # plain device queries (the reference's internal field mappers
            # do the same with Lucene fields)
            for key in ("_type", "_parent", "_routing"):
                v = meta.get(key)
                if v is not None:
                    fields[key] = ParsedField(name=key, kind="keyword",
                                              keywords=[str(v)])
            for key in ("_timestamp", "_ttl", "_version"):
                v = meta.get(key)
                if v is not None:
                    fields[key] = ParsedField(name=key, kind="numeric",
                                              numerics=[float(v)])
        if self.size_enabled:
            # the REST layer threads the on-the-wire source length in as
            # meta._source_bytes (what SizeFieldMapper measures); embedded
            # callers without raw bytes fall back to a compact UTF-8
            # re-serialization (ensure_ascii would inflate non-ASCII ~3x)
            raw_len = (meta or {}).get("_source_bytes")
            fields["_size"] = ParsedField(
                name="_size", kind="numeric",
                numerics=[float(raw_len if raw_len is not None else
                                len(_json_dumps(
                                    source, separators=(",", ":"),
                                    ensure_ascii=False).encode("utf-8")))])
        return ParsedDocument(doc_id=doc_id, source=dict(source), fields=fields,
                              routing=routing, nested=nested)

    def _parse_object(self, obj: Mapping[str, Any], prefix: str,
                      out: dict[str, ParsedField],
                      new_mappers: list[FieldMapper],
                      nested: dict[str, list[dict[str, ParsedField]]]
                      | None = None) -> None:
        for key, value in obj.items():
            full = f"{prefix}{key}"
            if nested is not None and full in self.nested_paths:
                objs = value if isinstance(value, list) else [value]
                rows = nested.setdefault(full, [])
                for sub in objs:
                    if not isinstance(sub, Mapping):
                        raise MapperParsingError(
                            f"nested field [{full}] expects objects")
                    row: dict[str, ParsedField] = {}
                    self._parse_object(sub, f"{full}.", row, new_mappers,
                                       nested=None)
                    rows.append(row)
                continue
            if isinstance(value, Mapping) and full not in self.mappers:
                self._parse_object(value, f"{full}.", out, new_mappers,
                                   nested)
                continue
            mapper = self.mappers.get(full)
            if mapper is None:
                if self.dynamic == "strict":
                    raise MapperParsingError(
                        f"mapping set to strict, dynamic introduction of [{full}] "
                        f"within [{self.type_name}] is not allowed")
                if not self.dynamic:
                    continue
                mapper = self._infer(full, value)
                if mapper is None:
                    continue
                new_mappers.append(mapper)
            out[full] = mapper.parse_value(value)
            for sub in mapper.sub_fields.values():
                out[sub.name] = sub.parse_value(value)

    def mapping_dict(self) -> dict:
        props: dict[str, Any] = {}
        for path in sorted(self.nested_paths):
            node = props
            parts = path.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {}).setdefault("properties", {})
            node[parts[-1]] = {"type": "nested"}
        for name, m in self.mappers.items():
            if "." in name and name.rsplit(".", 1)[0] in self.mappers:
                continue  # sub-field, rendered inside parent
            node = props
            parts = name.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {}).setdefault("properties", {})
            node[parts[-1]] = m.to_dict()
        # an empty mapping renders as {} (the reference omits `properties`)
        return {"properties": props} if props else {}


class MapperService:
    """Per-index mapping registry + merge (reference: MapperService.java).

    ES 2.x is multi-type; modern ES is single-type. We accept any type name
    but default to ``_doc``.
    """

    DEFAULT_TYPE = "_doc"

    def __init__(self, analysis: AnalysisRegistry | None = None):
        self.analysis = analysis or AnalysisRegistry()
        self.mappers: dict[str, DocumentMapper] = {}

    def merge(self, type_name: str, mapping_def: Mapping[str, Any]) -> DocumentMapper:
        existing = self.mappers.get(type_name)
        if existing is None:
            dm = DocumentMapper(type_name, mapping_def, self.analysis)
            self.mappers[type_name] = dm
            return dm
        # merge: new fields added; conflicting type changes rejected;
        # object fields (properties w/o type) recurse like DocumentMapper._build
        self._merge_properties(existing, mapping_def.get("properties", {}), "")
        return existing

    def _merge_properties(self, existing: DocumentMapper,
                          properties: Mapping[str, Any], prefix: str) -> None:
        for name, fdef in properties.items():
            full = f"{prefix}{name}"
            if fdef.get("type") == "nested":
                if any(full.startswith(f"{p}.") for p in
                       existing.nested_paths):
                    raise MapperParsingError(
                        f"nested field [{full}] inside a nested field is "
                        f"not supported")
                existing.nested_paths.add(full)
                self._merge_properties(existing, fdef.get("properties", {}),
                                       f"{full}.")
                continue
            if "properties" in fdef and "type" not in fdef:   # object field
                self._merge_properties(existing, fdef["properties"], f"{full}.")
                continue
            old = existing.mappers.get(full)
            new = FieldMapper(full, fdef.get("type", "text"), fdef, self.analysis)
            if old is not None and old.type != new.type:
                raise IllegalArgumentError(
                    f"mapper [{full}] cannot be changed from type "
                    f"[{old.type}] to [{new.type}]")
            existing.add_mapper(new)

    def document_mapper(self, type_name: str | None = None) -> DocumentMapper:
        tname = type_name or self.DEFAULT_TYPE
        if tname not in self.mappers:
            if type_name is None and len(self.mappers) == 1:
                # untyped op against an index mapped with ONE custom type:
                # that type IS the document mapping (single-type
                # semantics — the 2.x type name is a surface label here)
                return next(iter(self.mappers.values()))
            self.mappers[tname] = DocumentMapper(tname, {}, self.analysis)
        return self.mappers[tname]

    def field_mapper(self, field_name: str) -> FieldMapper | None:
        for dm in self.mappers.values():
            if field_name in dm.mappers:
                return dm.mappers[field_name]
        return None

    def mapping_dict(self) -> dict:
        return {t: dm.mapping_dict() for t, dm in self.mappers.items()}
