"""Lexical (BM25) scoring over the forward impact index.

Counterpart of ``elasticsearch_tpu/ops/lexical.py``: every doc row's
unique-term array is compared against the query terms — a dense [N, U]×[T]
compare/reduce with exact BM25 scores. On a CUDA tensor the batched scan is
kernel K1 (``csrc/bm25_scan.cu``), one launch for a whole batch of queries;
on a CPU tensor it is :func:`bm25_match_batch_plain`, the same arithmetic in
plain PyTorch, which the CPU tests hold against the JAX package and the card
holds K1 against bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import cuda_build

BM25_SCAN = cuda_build.CudaKernel(
    "bm25_scan", "bm25_scan.cu", "bm25_scan_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p])


def bm25_constants(k1: float, b: float) -> tuple:
    """(k1, k1 + 1, 1 - b, b) as float32, each rounded once from the Python
    double — what the JAX body's weakly typed Python scalars become."""
    return (np.float32(k1), np.float32(k1 + 1.0), np.float32(1.0 - b),
            np.float32(b))


def bm25_match_batch(uterms, utf, doc_len, qtids, qidf, qweight, k1, b,
                     avgdl, *, trailing_pad: bool = False,
                     want_nmatch: bool = True):
    """Score a batch of (multi-term, OR-semantics) match queries against one
    segment: the batched form of the JAX package's ``bm25_match`` under
    ``jax.vmap``.

    Args:
      uterms:  [N, U] int32  unique term ids per doc (-1 pad)
      utf:     [N, U] f32    term frequency of each unique term
      doc_len: [N]    int32  field length per doc
      qtids:   [B, T] int32  per-segment term ids of query terms (-1 = absent)
      qidf:    [B, T] f32    idf per query term (0 for absent/padding)
      qweight: [B, T] f32    per-term boost (match queries use 1.0)
      k1, b:   BM25 params (Python floats)
      avgdl:   [B]    f32    average field length per query
      trailing_pad: every row holds its terms first and -1 pads after (the
               segment builder's layout); lets K1 stop a row at its first
               pad. Results are the same either way.
      want_nmatch: False when the caller does not read ``nmatch`` (the OR
               plan's mask is ``scores > 0``): it is then neither computed
               nor written, and None stands in its place.

    Returns:
      scores: [B, N] f32  Σ_t idf_t · w_t · tfNorm(tf_t,d)
      nmatch: [B, N] i32  number of query terms hitting each doc, or None
    """
    if uterms.device.type == "cpu":
        return bm25_match_batch_plain(uterms, utf, doc_len, qtids, qidf,
                                      qweight, k1, b, avgdl,
                                      want_nmatch=want_nmatch)
    return _bm25_scan_cuda(uterms, utf, doc_len, qtids, qidf, qweight, k1, b,
                           avgdl, trailing_pad, want_nmatch)


def bm25_match(uterms, utf, doc_len, qtids, qidf, qweight, k1, b, avgdl):
    """One query ([T] term arrays, scalar avgdl) → (scores [N], nmatch [N]);
    the signature of the JAX package's ``bm25_match``."""
    avg = torch.as_tensor(avgdl, dtype=torch.float32,
                          device=uterms.device).reshape(1)
    scores, nmatch = bm25_match_batch(uterms, utf, doc_len, qtids[None],
                                      qidf[None], qweight[None], k1, b, avg)
    return scores[0], nmatch[0]


def term_filter(uterms, qtid):
    """Pure term-presence mask (filter context: no scoring).

    uterms: [N, U] int32; qtid: [B] (or scalar) int32, -1 = absent → all
    False. → [B, N] (or [N]) bool, one [N, U] compare per query: a
    [B, N, U] intermediate would not fit at real sizes."""
    q = torch.as_tensor(qtid, device=uterms.device)
    if q.dim() == 0:
        return ((uterms == q) & (q >= 0)).any(dim=1)
    return torch.stack([term_filter(uterms, t) for t in q]) if len(q) else \
        torch.zeros((0, uterms.shape[0]), dtype=torch.bool,
                    device=uterms.device)


def bm25_match_batch_plain(uterms, utf, doc_len, qtids, qidf, qweight, k1, b,
                           avgdl, *, want_nmatch: bool = True):
    """K1's plain PyTorch version: the JAX body's operations in its order,
    one query at a time (a [B, N, U] intermediate would not fit at real
    sizes). ``nmatch`` is None unless ``want_nmatch``."""
    dev = uterms.device
    k1_, k1p1, omb, b_ = (torch.tensor(c, device=dev)
                          for c in bm25_constants(k1, b))
    n = uterms.shape[0]
    n_queries, n_terms = qtids.shape
    dl = doc_len.to(torch.float32)
    out_scores = torch.empty((n_queries, n), dtype=torch.float32, device=dev)
    out_nmatch = torch.empty((n_queries, n), dtype=torch.int32, device=dev) \
        if want_nmatch else None
    for q in range(n_queries):
        norm = k1_ * (omb + b_ * dl / avgdl[q])                       # [N]
        tf_norm = utf * k1p1 / (utf + norm[:, None])                 # [N, U]
        scores = torch.zeros(n, dtype=torch.float32, device=dev)
        nmatch = torch.zeros(n, dtype=torch.int32, device=dev)
        for t in range(n_terms):
            tid = qtids[q, t]
            hit = (uterms == tid) & (tid >= 0)                       # [N, U]
            any_hit = hit.any(dim=1)
            # a select, not tf_norm * hit: the compiled reference selects,
            # so a pad cell's 0/0 (norm 0: b = 1, dl = 0) poisons nothing
            scores = scores + qidf[q, t] * qweight[q, t] * torch.where(
                any_hit, torch.where(hit, tf_norm, 0.0).sum(dim=1), 0.0)
            nmatch = nmatch + any_hit.to(torch.int32)
        out_scores[q] = scores
        if want_nmatch:
            out_nmatch[q] = nmatch
    return out_scores, out_nmatch


def _bm25_scan_cuda(uterms, utf, doc_len, qtids, qidf, qweight, k1, b, avgdl,
                    trailing_pad: bool, want_nmatch: bool):
    dev = uterms.device
    n, u = uterms.shape
    n_queries, n_terms = qtids.shape
    for arg, t, dt in (("uterms", uterms, torch.int32),
                       ("utf", utf, torch.float32),
                       ("doc_len", doc_len, torch.int32),
                       ("qtids", qtids, torch.int32),
                       ("qidf", qidf, torch.float32),
                       ("qweight", qweight, torch.float32),
                       ("avgdl", avgdl, torch.float32)):
        cuda_build.check_dtype("bm25_scan", arg, t, dt)
    if utf.shape != (n, u) or doc_len.shape != (n,) or \
            qidf.shape != (n_queries, n_terms) or \
            qweight.shape != (n_queries, n_terms) or \
            avgdl.shape != (n_queries,):
        raise ValueError(
            f"bm25_scan: shapes disagree: uterms {tuple(uterms.shape)}, "
            f"utf {tuple(utf.shape)}, doc_len {tuple(doc_len.shape)}, "
            f"qtids {tuple(qtids.shape)}, qidf {tuple(qidf.shape)}, "
            f"qweight {tuple(qweight.shape)}, avgdl {tuple(avgdl.shape)}")
    cuda_build.check_cuda("bm25_scan", dev, uterms=uterms, utf=utf,
                          doc_len=doc_len, qtids=qtids, qidf=qidf,
                          qweight=qweight, avgdl=avgdl)
    scores = torch.empty((n_queries, n), dtype=torch.float32, device=dev)
    nmatch = torch.empty((n_queries, n), dtype=torch.int32, device=dev) \
        if want_nmatch else None
    if n == 0 or n_queries == 0:
        return scores, nmatch
    if n_terms == 0 or u == 0:          # no term can hit: nothing to scan
        scores.zero_()
        return scores, None if nmatch is None else nmatch.zero_()
    k1_, k1p1, omb, b_ = bm25_constants(k1, b)
    p = cuda_build.ptr
    BM25_SCAN.launch(dev, p(uterms), p(utf), p(doc_len), n, u, p(qtids),
                     p(qidf), p(qweight), p(avgdl), n_queries, n_terms,
                     float(k1_), float(k1p1), float(omb), float(b_),
                     int(bool(trailing_pad)), p(scores), p(nmatch))
    return scores, nmatch
