"""Carry one index's state from the JAX package into this port.

A segment of either package is plain host data: sorted term dictionary,
forward impact columns, position matrix, doc-frequency table, keyword
ordinals with their sorted vocabulary, numeric doc values, dense and
multi-vector (rank_vectors) columns, geo_point and geo_shape columns, ids,
sources, and the reader's live mask beside it. :func:`segment_from_arrays`
rebuilds the port's :class:`Segment` from those arrays — numpy and lists
only, nothing of the JAX package — so both packages can score the very same
index.
:func:`impact_column_from_arrays` does the same for an impact column (the
impact lane's quantized impacts and block maxima), and
:func:`install_impact_column` puts one in a port segment's impact cache, so
both packages' impact lanes can run on the very same column.
:func:`nested_block_from_arrays` builds a nested path's child block (its
child segment and the child → parent join) from arrays the same way, with
no per-object mapper pass.
"""

from __future__ import annotations

import numpy as np

from elasticsearch_tpu_torch.index.segment import (
    GeoFieldColumn, ImpactColumn, KeywordFieldColumn, MultiVectorFieldColumn,
    NestedBlock, NumericFieldColumn, Segment, ShapeFieldColumn,
    VectorFieldColumn)


def segment_from_arrays(field: str, *, terms: list[str], uterms: np.ndarray,
                        utf: np.ndarray, doc_len: np.ndarray, df: np.ndarray,
                        ids: list[str], sources: list[dict],
                        live: np.ndarray, num_docs: int,
                        total_tokens: int | None = None,
                        tokens: np.ndarray | None = None,
                        keyword: dict | None = None,
                        numeric: dict | None = None,
                        vectors: dict | None = None,
                        mvectors: dict | None = None,
                        geo: dict | None = None,
                        shape: dict | None = None,
                        seg_id: int = 0) -> tuple[Segment, np.ndarray]:
    """→ (single-text-field Segment, its [padded] bool live mask).

    ``terms`` is the segment's sorted dictionary (term id = rank);
    ``uterms``/``utf`` are [padded, U]; ``doc_len`` is [padded]; rows at and
    beyond ``num_docs`` are padding; ``ids`` and ``sources`` cover at least
    the real rows; ``tokens`` (position matrix) may be None, which indexes
    without positions. ``keyword`` maps a field to ``(sorted vocab, [padded,
    K] int32 ords)``, ``numeric`` a field to ``([padded] float64 values,
    [padded] bool exists)``, ``vectors`` a dense_vector field to ``([padded,
    D] float32 vectors, [padded] bool exists)`` and ``mvectors`` a
    rank_vectors field to ``([padded, T, D] float32 token matrices, [padded]
    int32 token counts, [padded] bool exists)``, ``geo`` a geo_point field
    to ``([padded] float64 lat, [padded] float64 lon, [padded] bool
    exists)`` and ``shape`` a geo_shape field to ``([padded, V] float32
    lats, [padded, V] float32 lons, [padded, V] int32 ring ids, [padded, V]
    bool area flags, [padded] int32 edge slots, [padded] bool exists)``."""
    padded = int(uterms.shape[0])
    live = np.asarray(live, dtype=bool)
    if live.shape != (padded,) or not \
            num_docs <= min(len(ids), len(sources)) <= padded:
        raise ValueError(
            f"carried segment disagrees on row count: {padded} rows, live "
            f"{live.shape}, {len(ids)} ids, {len(sources)} sources")
    seg = Segment.from_packed_text(
        seg_id, field, terms=list(terms), tokens=tokens,
        uterms=np.asarray(uterms), utf=np.asarray(utf),
        doc_len=np.asarray(doc_len), df=np.asarray(df), num_docs=num_docs,
        total_tokens=total_tokens, ids=list(ids), sources=list(sources))
    for name, (vocab, ords) in (keyword or {}).items():
        seg.keyword_fields[name] = KeywordFieldColumn(
            vocab=list(vocab), ords=_rows(ords, np.int32, padded, name))
    for name, (values, exists) in (numeric or {}).items():
        seg.numeric_fields[name] = NumericFieldColumn(
            values=_rows(values, np.float64, padded, name),
            exists=_rows(exists, bool, padded, name))
    for name, (vecs, exists) in (vectors or {}).items():
        vecs = _rows(vecs, np.float32, padded, name)
        exists = _rows(exists, bool, padded, name)
        # a column no doc fills has dims 0, as indexing makes it
        seg.vector_fields[name] = VectorFieldColumn(
            vecs=vecs, exists=exists,
            dims=int(vecs.shape[1]) if exists.any() else 0)
    for name, (vecs, lens, exists) in (mvectors or {}).items():
        vecs = _rows(vecs, np.float32, padded, name)
        exists = _rows(exists, bool, padded, name)
        seg.mvector_fields[name] = MultiVectorFieldColumn(
            vecs=vecs, lens=_rows(lens, np.int32, padded, name),
            exists=exists, dims=int(vecs.shape[2]) if exists.any() else 0)
    for name, (lat, lon, exists) in (geo or {}).items():
        seg.geo_fields[name] = GeoFieldColumn(
            lat=_rows(lat, np.float64, padded, name),
            lon=_rows(lon, np.float64, padded, name),
            exists=_rows(exists, bool, padded, name))
    for name, (lats, lons, rid, area, nv, exists) in (shape or {}).items():
        seg.shape_fields[name] = ShapeFieldColumn(
            lats=_rows(lats, np.float32, padded, name),
            lons=_rows(lons, np.float32, padded, name),
            nv=_rows(nv, np.int32, padded, name),
            exists=_rows(exists, bool, padded, name),
            rid=_rows(rid, np.int32, padded, name),
            area=_rows(area, bool, padded, name))
    return seg, live.copy()


def nested_block_from_arrays(parent: np.ndarray, field: str, *,
                             terms: list[str], uterms: np.ndarray,
                             utf: np.ndarray, doc_len: np.ndarray,
                             df: np.ndarray, num_children: int,
                             total_tokens: int | None = None,
                             tokens: np.ndarray | None = None,
                             keyword: dict | None = None,
                             numeric: dict | None = None,
                             geo: dict | None = None) -> NestedBlock:
    """→ a nested path's NestedBlock: a child segment with the text field
    ``field`` (and the ``keyword`` / ``numeric`` / ``geo`` columns, as
    :func:`segment_from_arrays` takes them), every column [padded] rows,
    and ``parent`` [padded] int32: the parent row of each of the first
    ``num_children`` rows, non-decreasing (a parent's objects are adjacent
    rows, in the parents' order, as indexing appends them), then -1. Field
    names carry the path (``answers.body``), as the mapper names them."""
    padded = int(uterms.shape[0])
    parent = _rows(parent, np.int32, padded, "parent")
    head = parent[:num_children]
    if (head < 0).any() or (np.diff(head) < 0).any() or \
            (parent[num_children:] != -1).any():
        raise ValueError("nested block: parent must hold the first "
                         "num_children rows' parents in non-decreasing order "
                         "and -1 after")
    seg, _ = segment_from_arrays(
        field, terms=terms, uterms=uterms, utf=utf, doc_len=doc_len, df=df,
        ids=[""] * padded, sources=[{}] * padded,
        live=np.arange(padded) < num_children, num_docs=num_children,
        total_tokens=total_tokens, tokens=tokens, keyword=keyword,
        numeric=numeric, geo=geo)
    return NestedBlock(segment=seg, parent=parent)


def impact_column_from_arrays(*, qimp: np.ndarray,
                              block_max: np.ndarray | None, scale: float,
                              bits: int, block_rows: int, doc_count: int,
                              avgdl: float, k1: float, b: float,
                              quant_gen: int = 0) -> ImpactColumn:
    """→ the port's ImpactColumn holding a column's arrays: ``qimp`` [Np, U]
    and ``block_max`` [NB, V] (None: over budget) in the dtype of ``bits``,
    and its quantization snapshot."""
    dtype = {8: np.uint8, 16: np.uint16}[int(bits)]
    return ImpactColumn(
        qimp=np.ascontiguousarray(qimp, dtype=dtype),
        block_max=None if block_max is None
        else np.ascontiguousarray(block_max, dtype=dtype),
        scale=float(scale), bits=int(bits), block_rows=int(block_rows),
        doc_count=int(doc_count), avgdl=float(avgdl), k1=float(k1),
        b=float(b), quant_gen=int(quant_gen))


def install_impact_column(seg: Segment, field: str, icol: ImpactColumn, *,
                          block_rows: int) -> None:
    """Put ``icol`` in ``seg``'s impact cache as the column of ``field``
    under an index configured with ``block_rows`` (the config's, which the
    column's own may undercut on a small segment): the impact lane then
    scores with it instead of building its own."""
    if icol.qimp.shape != seg.text_fields[field].uterms.shape:
        raise ValueError(
            f"impact column {icol.qimp.shape} does not match the segment's "
            f"[{field}] rows {seg.text_fields[field].uterms.shape}")
    cache = seg.__dict__.setdefault("_impact_cache", {})
    cache[(field, icol.bits, int(block_rows), icol.k1, icol.b)] = icol


def _rows(a, dtype, padded: int, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.shape[0] != padded:
        raise ValueError(f"carried column [{name}] has {a.shape[0]} rows, "
                         f"the segment {padded}")
    return a

