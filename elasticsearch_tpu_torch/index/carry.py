"""Carry one index's state from the JAX package into this port.

A segment of either package is plain host data: sorted term dictionary,
forward impact columns, doc-frequency table, ids, sources, and the reader's
live mask beside it. :func:`segment_from_arrays` rebuilds the port's
:class:`Segment` from those arrays — numpy and lists only, nothing of the
JAX package — so both packages can score the very same index.
"""

from __future__ import annotations

import numpy as np

from elasticsearch_tpu_torch.index.segment import Segment


def segment_from_arrays(field: str, *, terms: list[str], uterms: np.ndarray,
                        utf: np.ndarray, doc_len: np.ndarray, df: np.ndarray,
                        ids: list[str], sources: list[dict],
                        live: np.ndarray, num_docs: int,
                        total_tokens: int | None = None,
                        tokens: np.ndarray | None = None,
                        seg_id: int = 0) -> tuple[Segment, np.ndarray]:
    """→ (single-text-field Segment, its [padded] bool live mask).

    ``terms`` is the segment's sorted dictionary (term id = rank);
    ``uterms``/``utf`` are [padded, U]; ``doc_len`` is [padded]; rows at and
    beyond ``num_docs`` are padding; ``ids`` and ``sources`` cover at least
    the real rows; ``tokens`` (position matrix) may be None, which indexes
    without positions."""
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
    return seg, live.copy()

