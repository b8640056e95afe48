"""Carry one index's state from the JAX package into this port.

A segment of either package is plain host data: sorted term dictionary,
forward impact columns, position matrix, doc-frequency table, keyword
ordinals with their sorted vocabulary, numeric doc values, dense and
multi-vector (rank_vectors) columns, ids, sources, and the reader's live
mask beside it. :func:`segment_from_arrays` rebuilds
the port's :class:`Segment` from those arrays — numpy and lists only, nothing of the
JAX package — so both packages can score the very same index.
"""

from __future__ import annotations

import numpy as np

from elasticsearch_tpu_torch.index.segment import (
    KeywordFieldColumn, MultiVectorFieldColumn, NumericFieldColumn, Segment,
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
    int32 token counts, [padded] bool exists)``."""
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
    return seg, live.copy()


def _rows(a, dtype, padded: int, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.shape[0] != padded:
        raise ValueError(f"carried column [{name}] has {a.shape[0]} rows, "
                         f"the segment {padded}")
    return a

