"""DeviceReader — an engine reader view packed into tensors on the card.

Counterpart of ``elasticsearch_tpu/index/device_reader.py``: the analog of
acquiring an NRT searcher (IndexShard.acquireSearcher,
core/index/shard/IndexShard.java:707) — an immutable point-in-time set of
segments whose scoring columns are uploaded once per refresh generation;
queries then run on the device until the final top-k docs come back for
fetch.

Text (forward impact), keyword, numeric and live columns become tensors on
the reader's device when the reader is made. A text field's position matrix
(``tokens``, what phrase queries read) goes to the device LAZILY, the first
time a plan names the field in ``positions_needed``
(:meth:`DeviceReader.fetch_tokens`), and stays cached on the reader, as the
JAX package does (``jit_exec._fetch``): a BM25 ``match`` never reads it, so
a reader that serves only those never holds it. A vector field's matrix
(``dense_vector`` [N, D], ``rank_vectors`` [N, T, D]) is lazy the same way:
the knn lane and the ``knn`` query leaf put it on the device at first use,
one copy per (segment, field, quantization) (:meth:`DeviceReader.
fetch_vectors`), L2-normalized (f32) or also int8-quantized on the host on
the way, with no host copy kept; its [N] ``exists`` mask (and a
rank_vectors field's token counts) go with the reader, as in the JAX
package. An impact-lane index's quantized columns (``ImpactColumn``: the
impacts and the block maxima) go to the device the same way, at the lane's
first request, one copy per (segment, field, bits, block rows, quantization
generation) (:meth:`DeviceReader.fetch_impacts`). A geo_point column (lat and
lon cast to f32, as the JAX package casts them, and exists) and a geo_shape
column (the vertex rings ``lats`` / ``lons`` [N, V] f32, ``rid`` [N, V] i32,
``area`` [N, V] bool, ``nv`` [N] i32 and exists) go to the device the same
way, at the first plan that reads the field (:meth:`DeviceReader.fetch_geo`,
:meth:`DeviceReader.fetch_shape`, called by the geo resolvers), one copy per
(segment, field). A nested path's child rows (``NestedBlock``) are packed
with the segment as a segment of their own (:class:`DeviceNestedBlock`: the
child :class:`DeviceSegment`, whose live mask folds in the parent's, the
child → parent join ``parent`` [Nc] i32 and its CSR view ``offsets`` [N+1]
i32, each parent's children in child order); the child's lazy columns go
to the device at first use on the child's own DeviceSegment, as the
parent's do. Every child block is built with ``seg_id`` 0, so nothing here
keys a cache by ``seg_id``.

Also aggregates per-field corpus statistics across segments host-side
(doc counts, Σ field length, per-term df on demand) — what Lucene exposes as
CollectionStatistics/TermStatistics for query-time IDF.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.index.engine import SearcherView
from elasticsearch_tpu_torch.index.segment import Segment, quantize_vectors
from elasticsearch_tpu_torch.ops.phrase import token_extent


@dataclass
class DeviceTextField:
    uterms: torch.Tensor       # [Np, U] i32
    utf: torch.Tensor          # [Np, U] f32
    doc_len: torch.Tensor      # [Np] i32
    column: Any                # host TextFieldColumn (term dict, df)
    # every row holds its terms first and -1 pads after (checked at upload):
    # lets the scoring kernel stop a row at its first pad
    trailing_pad: bool = False
    # the position matrix, uploaded on first use (DeviceReader.fetch_tokens):
    tokens: torch.Tensor | None = None      # [Np, L] i32, -1 holes
    # each row's last position holding a term, plus 1 (ops/phrase.
    # token_extent): the phrase kernel reads a row only that far, and a -1
    # hole inside the row stays a position
    tok_extent: torch.Tensor | None = None  # [Np] i32


@dataclass
class DeviceKeywordField:
    ords: torch.Tensor         # [Np, K] i32
    column: Any                # host KeywordFieldColumn (vocab)


@dataclass
class DeviceNumericField:
    """Numeric doc values as a double-double split: ``hi = f32(v)``,
    ``lo = f32(v - hi)`` — lexicographic compare on (hi, lo) reproduces
    exact f64 ordering, as in the JAX package."""
    hi: torch.Tensor           # [Np] f32
    lo: torch.Tensor           # [Np] f32
    exists: torch.Tensor       # [Np] bool
    column: Any


def dd_split(v: np.ndarray | float) -> tuple[np.ndarray, np.ndarray]:
    hi = np.float32(v)
    with np.errstate(invalid="ignore"):
        lo = np.float32(np.float64(v) - np.float64(hi))
    # ±inf bounds: inf - inf = nan would poison comparisons; lo 0 keeps the
    # (hi, lo) pair correctly ordered.
    lo = np.where(np.isfinite(np.float64(v)), lo, np.float32(0.0)) \
        if isinstance(v, np.ndarray) else \
        (lo if np.isfinite(v) else np.float32(0.0))
    return hi, lo


def _normalized(vecs: np.ndarray) -> np.ndarray:
    """Each row (rank_vectors: each token) over its L2 norm, in numpy f32 —
    the JAX package's ``jit_exec._host_knn_column`` arithmetic."""
    norms = np.linalg.norm(vecs, axis=-1, keepdims=True)
    return np.ascontiguousarray(
        (vecs / np.maximum(norms, 1e-12)).astype(np.float32))


@dataclass
class DeviceVectorField:
    """A dense_vector column: ``exists`` with the reader; the L2-normalized
    f32 rows (``vecs``, cosine = dot) and their int8 quantization
    (``qvecs``, ``v ≈ q·scale + offset``) each put on the device at first
    use (:meth:`DeviceReader.fetch_vectors`)."""
    exists: torch.Tensor                   # [Np] bool
    column: Any                            # host VectorFieldColumn
    vecs: torch.Tensor | None = None       # [Np, D] f32
    qvecs: torch.Tensor | None = None      # [Np, D] int8
    scale: float = 1.0                     # qvecs' snapshot, set with it
    offset: float = 0.0


@dataclass
class DeviceMultiVectorField(DeviceVectorField):
    """A rank_vectors column: as a dense_vector one, with per-token
    normalized [Np, T, D] token matrices, and ``lens`` (each doc's real
    token rows) with the reader."""
    lens: torch.Tensor | None = None       # [Np] i32 real token rows


@dataclass
class DeviceGeoField:
    """A geo_point column, put on the device at first use
    (:meth:`DeviceReader.fetch_geo`); the host column keeps float64."""
    column: Any                            # host GeoFieldColumn
    lat: torch.Tensor | None = None        # [Np] f32
    lon: torch.Tensor | None = None        # [Np] f32
    exists: torch.Tensor | None = None     # [Np] bool


@dataclass
class DeviceShapeField:
    """A geo_shape column of vertex rings (utils/geoshape), put on the
    device at first use (:meth:`DeviceReader.fetch_shape`)."""
    column: Any                            # host ShapeFieldColumn
    lats: torch.Tensor | None = None       # [Np, V] f32 concatenated rings
    lons: torch.Tensor | None = None       # [Np, V] f32
    rid: torch.Tensor | None = None        # [Np, V] i32 ring id (-1 pad)
    area: torch.Tensor | None = None       # [Np, V] bool ring encloses area
    nv: torch.Tensor | None = None         # [Np] i32 edge slots
    exists: torch.Tensor | None = None     # [Np] bool


@dataclass
class DeviceImpacts:
    """One segment's impact column on the device: the quantized impacts
    ``qimp`` [Np, U] (uint8 / uint16, the layout of ``uterms``) and the block
    maxima [NB, V] (None when the host build dropped them over budget), of
    one quantization generation."""
    quant_gen: int
    qimp: torch.Tensor
    block_max: torch.Tensor | None


@dataclass
class DeviceNestedBlock:
    """A nested path's child rows on the device: the child segment packed
    like any segment (its ``live`` folds the parent's live mask in, so the
    children of a deleted parent never match), the child → parent join
    ``parent`` [Nc] i32 (-1 pad) and its CSR view ``offsets`` [N+1] i32
    (parent p's children are rows offsets[p] .. offsets[p+1], in child
    order: indexing appends them in parent order, so ``parent`` is
    non-decreasing over the real rows). ``column`` is the host block."""
    child: "DeviceSegment"
    parent: torch.Tensor            # [Nc] i32, -1 pad
    offsets: torch.Tensor           # [N + 1] i32
    column: Any                     # host NestedBlock


def nested_offsets(parent: np.ndarray, n_parents: int) -> np.ndarray:
    """The CSR offsets [n_parents + 1] i32 of a child → parent join whose
    real rows (parent >= 0) come first, in non-decreasing parent order."""
    parent = np.asarray(parent)
    real = int((parent >= 0).sum())
    head = parent[:real]
    if (head < 0).any() or (np.diff(head) < 0).any():
        raise ValueError("nested block: the child rows are not grouped by "
                         "parent in parent order")
    if real and int(head[-1]) >= n_parents:
        raise ValueError(f"nested block: parent row {int(head[-1])} past "
                         f"the segment's {n_parents} rows")
    return np.searchsorted(head, np.arange(n_parents + 1),
                           side="left").astype(np.int32)


@dataclass
class DeviceSegment:
    seg: Segment
    live: torch.Tensor              # [Np] bool (padding & deletes False)
    doc_base: int                   # global doc id of row 0 within the reader
    text: dict[str, DeviceTextField]
    keyword: dict[str, DeviceKeywordField]
    numeric: dict[str, DeviceNumericField]
    vector: dict[str, DeviceVectorField] = field(default_factory=dict)
    mvector: dict[str, DeviceMultiVectorField] = field(default_factory=dict)
    # the impact lane's quantized columns, put on the device at first use
    # (DeviceReader.fetch_impacts): (field, bits, block_rows, k1, b) →
    # DeviceImpacts
    impacts: dict = field(default_factory=dict)
    # geo_point and geo_shape columns, their tensors put on the device at
    # first use (DeviceReader.fetch_geo / fetch_shape)
    geo: dict[str, DeviceGeoField] = field(default_factory=dict)
    shape: dict[str, DeviceShapeField] = field(default_factory=dict)
    # nested path → its child rows (packed with the segment)
    nested: dict[str, DeviceNestedBlock] = field(default_factory=dict)

    @property
    def padded_docs(self) -> int:
        return self.seg.padded_docs


@dataclass
class TextFieldStats:
    doc_count: int          # docs in reader (incl. not-yet-merged deletes)
    docs_with_field: int
    total_tokens: int

    @property
    def avgdl(self) -> float:
        return self.total_tokens / max(self.docs_with_field, 1)


def pads_trail(uterms: torch.Tensor) -> bool:
    """True when no row of a [N, U] term matrix has a term after a pad."""
    if uterms.shape[0] == 0 or uterms.shape[1] < 2:
        return True
    real = uterms >= 0
    return not bool((real[:, 1:] & ~real[:, :-1]).any())


class DeviceReader:
    def __init__(self, view: SearcherView, device=None):
        """Pack every segment of ``view`` onto ``device`` (CUDA when None;
        raises when no card is present)."""
        self.device = resolve_device(device)
        self.generation = view.generation
        self.segments: list[DeviceSegment] = []
        self._text_stats: dict[str, TextFieldStats] = {}
        self._lazy_lock = threading.Lock()
        doc_base = 0
        for seg, live in zip(view.segments, view.live_masks):
            self.segments.append(self._pack_segment(seg, live, doc_base))
            doc_base += seg.padded_docs
        self.max_doc = doc_base
        self._collect_stats(view)

    # ---- packing ----------------------------------------------------------

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _pack_segment(self, seg: Segment, live: np.ndarray,
                      doc_base: int) -> DeviceSegment:
        put = self._put
        text = {}
        for name, c in seg.text_fields.items():
            uterms = put(c.uterms)
            text[name] = DeviceTextField(
                uterms=uterms, utf=put(c.utf),
                doc_len=put(c.doc_len), column=c,
                trailing_pad=pads_trail(uterms))
        keyword = {name: DeviceKeywordField(ords=put(c.ords), column=c)
                   for name, c in seg.keyword_fields.items()}
        numeric = {}
        for name, c in seg.numeric_fields.items():
            hi, lo = dd_split(c.values)
            numeric[name] = DeviceNumericField(
                hi=put(hi), lo=put(lo), exists=put(c.exists), column=c)
        vector = {name: DeviceVectorField(exists=put(c.exists), column=c)
                  for name, c in seg.vector_fields.items()}
        mvector = {name: DeviceMultiVectorField(
            lens=put(c.lens), exists=put(c.exists), column=c)
            for name, c in seg.mvector_fields.items()}
        return DeviceSegment(
            seg=seg, live=put(live), doc_base=doc_base, text=text,
            keyword=keyword, numeric=numeric, vector=vector, mvector=mvector,
            geo={name: DeviceGeoField(column=c)
                 for name, c in seg.geo_fields.items()},
            shape={name: DeviceShapeField(column=c)
                   for name, c in seg.shape_fields.items()},
            nested={path: self.pack_nested(blk, live)
                    for path, blk in seg.nested_blocks.items()})

    def pack_nested(self, blk, live: np.ndarray) -> DeviceNestedBlock:
        """Pack one host NestedBlock of a segment whose live mask is
        ``live``: the child rows as a segment of their own (doc_base 0),
        their live mask the parent's at each real row (children of deleted
        parents never match, as Lucene deletes a parent's hidden nested docs
        with it), ``parent`` and its CSR offsets."""
        live = np.asarray(live, dtype=bool)
        parent = np.asarray(blk.parent, dtype=np.int32)
        valid = parent >= 0
        child_live = np.zeros(blk.segment.padded_docs, bool)
        child_live[valid] = live[parent[valid]]
        return DeviceNestedBlock(
            child=self._pack_segment(blk.segment, child_live, 0),
            parent=self._put(parent),
            offsets=self._put(nested_offsets(parent, len(live))),
            column=blk)

    def fetch_tokens(self, seg: DeviceSegment, field: str) -> None:
        """Put ``field``'s position matrix of ``seg`` (and each row's
        extent) on the device, once per reader; a later call finds it
        cached. A field the segment lacks is left alone."""
        col = seg.text.get(field)
        if col is None or col.tokens is not None:
            return
        with self._lazy_lock:
            if col.tokens is None:
                tokens = self._put(col.column.tokens)
                col.tok_extent = token_extent(tokens)
                col.tokens = tokens

    def fetch_vectors(self, seg: DeviceSegment, field: str,
                      quant: str) -> DeviceVectorField | None:
        """Put ``field``'s vector matrix of ``seg`` on the device under
        ``quant`` once per reader: ``"f32"`` fills ``vecs`` with the rows
        (rank_vectors: the tokens) L2-normalized as ``v / max(|v|, 1e-12)``;
        ``"int8"`` fills ``qvecs``, ``scale`` and ``offset`` with the int8
        quantization of those normalized rows over the whole padded array,
        padding rows included, as the JAX package quantizes it. The host
        arrays made on the way are dropped. → the column, or None when the
        segment lacks the field."""
        col = seg.vector.get(field) or seg.mvector.get(field)
        if col is None:
            return None
        with self._lazy_lock:
            if quant == "int8" and col.qvecs is None:
                qcol = quantize_vectors(_normalized(col.column.vecs),
                                        col.column.dims)
                col.scale, col.offset = qcol.scale, qcol.offset
                col.qvecs = self._put(qcol.qvecs)
            elif quant != "int8" and col.vecs is None:
                col.vecs = self._put(_normalized(col.column.vecs))
        return col

    def fetch_impacts(self, seg: DeviceSegment, field: str,
                      icol) -> DeviceImpacts:
        """Put the impact column ``icol`` (index/segment.ImpactColumn) of
        ``seg``'s ``field`` on the device: one copy per (segment, field,
        bits, block rows, BM25 k1 and b, quantization generation) — the key
        of the host column it uploads. A later call with the same
        generation finds it; a new generation (the statistics drifted and
        the host column was requantized) replaces the old copy."""
        key = (field, icol.bits, icol.block_rows, float(icol.k1),
               float(icol.b))
        with self._lazy_lock:
            cur = seg.impacts.get(key)
            if cur is None or cur.quant_gen != icol.quant_gen:
                cur = DeviceImpacts(
                    quant_gen=icol.quant_gen, qimp=self._put(icol.qimp),
                    block_max=None if icol.block_max is None
                    else self._put(icol.block_max))
                seg.impacts[key] = cur
        return cur

    def fetch_geo(self, seg: DeviceSegment,
                  field: str) -> DeviceGeoField | None:
        """Put ``field``'s geo_point column of ``seg`` on the device once
        per reader, lat and lon cast to f32. → the column, or None when the
        segment lacks the field."""
        col = seg.geo.get(field)
        if col is None:
            return None
        with self._lazy_lock:
            if col.lat is None:
                c = col.column
                col.lon = self._put(c.lon.astype(np.float32))
                col.exists = self._put(c.exists)
                col.lat = self._put(c.lat.astype(np.float32))
        return col

    def fetch_shape(self, seg: DeviceSegment,
                    field: str) -> DeviceShapeField | None:
        """Put ``field``'s geo_shape rings of ``seg`` on the device once
        per reader. → the column, or None when the segment lacks the
        field."""
        col = seg.shape.get(field)
        if col is None:
            return None
        with self._lazy_lock:
            if col.lats is None:
                c = col.column
                col.lons, col.rid, col.area, col.nv, col.exists = (
                    self._put(a) for a in (c.lons, c.rid, c.area, c.nv,
                                           c.exists))
                col.lats = self._put(c.lats)
        return col

    def device_bytes(self) -> int:
        """Bytes of the tensors this reader placed on its device (nested
        child blocks included)."""
        return sum(self._segment_bytes(s) for s in self.segments)

    def _segment_bytes(self, s: DeviceSegment) -> int:
        total = sum(self._segment_bytes(blk.child)
                    for blk in s.nested.values())
        tensors = [s.live]
        for blk in s.nested.values():
            tensors += [blk.parent, blk.offsets]
        for c in s.text.values():
            tensors += [c.uterms, c.utf, c.doc_len]
            if c.tokens is not None:
                tensors += [c.tokens, c.tok_extent]
        tensors += [c.ords for c in s.keyword.values()]
        for c in s.numeric.values():
            tensors += [c.hi, c.lo, c.exists]
        for c in s.vector.values():
            tensors += [t for t in (c.exists, c.vecs, c.qvecs)
                        if t is not None]
        for c in s.mvector.values():
            tensors += [t for t in (c.lens, c.exists, c.vecs, c.qvecs)
                        if t is not None]
        for c in s.impacts.values():
            tensors += [t for t in (c.qimp, c.block_max) if t is not None]
        for c in s.geo.values():
            tensors += [t for t in (c.lat, c.lon, c.exists)
                        if t is not None]
        for c in s.shape.values():
            tensors += [t for t in (c.lats, c.lons, c.rid, c.area, c.nv,
                                    c.exists) if t is not None]
        total += sum(t.numel() * t.element_size() for t in tensors)
        return total

    def _collect_stats(self, view: SearcherView) -> None:
        for seg in view.segments:
            self._collect_seg_stats(seg)

    def _collect_seg_stats(self, seg: Segment) -> None:
        for name, c in seg.text_fields.items():
            st = self._text_stats.setdefault(name, TextFieldStats(0, 0, 0))
            st.doc_count += seg.num_docs
            st.docs_with_field += int((c.doc_len[:seg.num_docs] > 0).sum())
            st.total_tokens += c.total_tokens
        for blk in seg.nested_blocks.values():
            # nested child fields get their own stats over CHILD rows (the
            # reference's nested docs likewise contribute their own
            # field statistics)
            self._collect_seg_stats(blk.segment)

    # ---- stats (CollectionStatistics / TermStatistics analog) -------------

    @property
    def num_docs(self) -> int:
        return sum(s.seg.num_docs for s in self.segments)

    def text_stats(self, field: str) -> TextFieldStats:
        return self._text_stats.get(field, TextFieldStats(self.num_docs, 0, 0))

    def df(self, field: str, term: str) -> int:
        """Doc frequency aggregated across this reader's segments
        (including nested child blocks — their fields are path-prefixed,
        so names never collide with parent fields)."""
        def seg_df(seg: Segment) -> int:
            out = 0
            col = seg.text_fields.get(field)
            if col is not None:
                tid = col.tid(term)
                if tid >= 0:
                    out += int(col.df[tid])
            for blk in seg.nested_blocks.values():
                out += seg_df(blk.segment)
            return out
        return sum(seg_df(s.seg) for s in self.segments)

    # ---- doc id resolution -------------------------------------------------

    def resolve(self, global_doc: int) -> tuple[DeviceSegment, int]:
        """global doc id → (device segment, local row)."""
        for s in self.segments:
            if s.doc_base <= global_doc < s.doc_base + s.padded_docs:
                return s, global_doc - s.doc_base
        raise IndexError(f"doc {global_doc} out of range")

    def doc_id(self, global_doc: int) -> str:
        s, local = self.resolve(global_doc)
        return s.seg.ids[local]

    def source(self, global_doc: int) -> dict:
        s, local = self.resolve(global_doc)
        return s.seg.sources[local]


def device_reader_for(engine, view: SearcherView | None = None,
                      device=None) -> DeviceReader:
    """Reader cache per refresh generation and device — columns upload once
    per refresh, like Lucene's per-commit reader reuse. The cache lives ON
    the engine object so its tensors are released with the engine."""
    dev = resolve_device(device)
    if view is None:
        view = engine.acquire_searcher()
    lock = engine.__dict__.setdefault("_device_reader_lock",
                                      threading.Lock())
    with lock:
        cached = getattr(engine, "_device_reader_cache", None)
        if cached is not None and cached.generation == view.generation \
                and cached.device == dev:
            return cached
        cached = DeviceReader(view, device=dev)
        engine._device_reader_cache = cached
        return cached


def release_device_reader(engine) -> None:
    """Drop the engine's cached reader (called from Engine.close) so its
    tensors are freed with the engine."""
    lock = engine.__dict__.setdefault("_device_reader_lock",
                                      threading.Lock())
    with lock:
        engine._device_reader_cache = None
