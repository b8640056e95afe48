"""Exact-phrase matching over the position-indexed token matrix.

Counterpart of ``elasticsearch_tpu/ops/phrase.py`` (its exact part).
Lucene's ExactPhraseScorer walks the position postings of every phrase term
in lockstep; here ``tokens[doc, p]`` is the term id at position ``p`` (-1
holes), so an occurrence starting at ``p`` is

    AND_k  tokens[:, p + delta_k] == qtid_k

with the query's position gaps (stopwords the analyzer removed) in
``deltas``, as ES match_phrase does.

The JAX body compares shifted copies of ``tokens[N, L]`` under ``jax.vmap``,
which XLA fuses without building the [B, N, L] compare. On a CUDA tensor
the batched form is kernel K3 (``csrc/phrase_scan.cu``): one launch scores
a whole batch against one segment, reading each row of positions once. On
a CPU tensor it is :func:`phrase_score_batch_plain`, the reference's
arithmetic one query at a time with [N, L] temporaries, which the CPU tests
hold against the JAX package and the card holds K3 against bit for bit.

Sloppy phrases (``slop > 0``) and unordered span-near are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from elasticsearch_tpu_torch.common.errors import NotPortedError
from elasticsearch_tpu_torch.ops import cuda_build
from elasticsearch_tpu_torch.ops.lexical import bm25_constants

#: most terms a phrase may have on K3 (its per-launch delta table)
MAX_TERMS = 32

#: the reference's out-of-row fill for a shifted position: matches no term
_FILL = -(2 ** 31) + 1

PHRASE_SCAN = cuda_build.CudaKernel(
    "phrase_scan", "phrase_scan.cu", "phrase_scan_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
     ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
     ctypes.c_void_p])


def token_extent(tokens: torch.Tensor, rows: int = 1 << 16) -> torch.Tensor:
    """Each row's extent: its last position holding a term (>= 0), plus 1;
    0 for a row with none. Positions at or beyond it never match, and a -1
    hole before it stays a position. Computed in slices of ``rows`` rows so
    no [N, L] temporary of the whole matrix is made."""
    n, length = tokens.shape
    out = torch.empty(n, dtype=torch.int32, device=tokens.device)
    pos = torch.arange(1, length + 1, dtype=torch.int32,
                       device=tokens.device)
    for lo in range(0, n, rows):
        blk = tokens[lo:lo + rows]
        out[lo:lo + rows] = torch.where(blk >= 0, pos, 0).amax(dim=1) \
            if length else 0
    return out


def _shift_left(tokens, d: int):
    """tokens[:, p] → tokens[:, p + d]; out of range = a fill no term id
    equals."""
    if d == 0:
        return tokens
    n, length = tokens.shape
    out = torch.full_like(tokens, _FILL)
    if d < length:
        out[:, :length - d] = tokens[:, d:]
    return out


def phrase_freq(tokens, qtids, deltas: list[int]):
    """Phrase frequency per doc of one query.

    tokens: [N, L] int32 (-1 holes); qtids: [T] int32 per-segment term ids
    (-1 = absent → freq 0 everywhere); deltas: T static ints, each term's
    position offset from the first. → freq [N] f32."""
    window = None
    for k, d in enumerate(deltas):
        tid = qtids[k]
        hit = (_shift_left(tokens, d) == tid) & (tid >= 0)     # [N, L]
        window = hit if window is None else (window & hit)
    return window.sum(dim=1).to(torch.float32)


def freq_score(freq, doc_len, sum_idf, k1, b, avgdl):
    """BM25 over a positional frequency (tf = freq, idf = Σ idf of the
    phrase's terms, as Lucene's PhraseWeight builds its stats), with the
    reference's order of operations. → (scores [N] f32, mask [N] bool)."""
    dev = freq.device
    k1_, k1p1, omb, b_ = (torch.tensor(c, device=dev)
                          for c in bm25_constants(k1, b))
    norm = k1_ * (omb + b_ * doc_len.to(torch.float32) / avgdl)
    tf_norm = freq * k1p1 / (freq + norm)
    mask = freq > 0
    return torch.where(mask, sum_idf * tf_norm, 0.0), mask


def phrase_score(tokens, doc_len, qtids, deltas: list[int], sum_idf, k1, b,
                 avgdl):
    """BM25 phrase scoring of one query: tf = phrase frequency, idf = Σ
    idf(term). → (scores [N] f32, mask [N] bool)."""
    return freq_score(phrase_freq(tokens, qtids, deltas), doc_len, sum_idf,
                      k1, b, avgdl)


def phrase_score_batch(tokens, doc_len, qtids, deltas, sum_idf, k1, b, avgdl,
                       *, extent):
    """Score a batch of exact phrases (one shared ``deltas``) against one
    segment: the batched form of the JAX package's ``phrase_score``.

    Args:
      tokens:  [N, L] int32  position-indexed term ids (-1 holes)
      doc_len: [N]    int32  field length per doc
      qtids:   [B, T] int32  per-segment term ids (-1 = absent)
      deltas:  T non-negative ints, each term's offset from the first
      sum_idf: [B]    f32    Σ idf of each phrase's terms (summed on the
                             host in doubles, cast once)
      k1, b:   BM25 params (Python floats)
      avgdl:   [B]    f32
      extent:  [N]    int32  each row's extent (:func:`token_extent`); the
                             kernel reads a row only that far

    Returns (scores [B, N] f32, mask [B, N] bool).
    """
    deltas = [int(d) for d in deltas]
    if len(deltas) > MAX_TERMS:
        raise NotPortedError(
            f"a phrase of [{len(deltas)}] terms is above the port's limit "
            f"[{MAX_TERMS}]")
    if tokens.device.type == "cpu":
        return phrase_score_batch_plain(tokens, doc_len, qtids, deltas,
                                        sum_idf, k1, b, avgdl)
    return _phrase_scan_cuda(tokens, doc_len, qtids, deltas, sum_idf, k1, b,
                             avgdl, extent)


def phrase_score_batch_plain(tokens, doc_len, qtids, deltas, sum_idf, k1, b,
                             avgdl):
    """K3's plain PyTorch version: the reference's arithmetic per query with
    [N, L] temporaries (the shifted copies are made once for the batch);
    never a [B, N, L] intermediate."""
    dev = tokens.device
    n = tokens.shape[0]
    n_queries = qtids.shape[0]
    shifted = {d: _shift_left(tokens, d) for d in set(deltas)}
    scores = torch.empty((n_queries, n), dtype=torch.float32, device=dev)
    mask = torch.empty((n_queries, n), dtype=torch.bool, device=dev)
    for q in range(n_queries):
        window = None
        for k, d in enumerate(deltas):
            tid = qtids[q, k]
            hit = (shifted[d] == tid) & (tid >= 0)
            window = hit if window is None else (window & hit)
        freq = window.sum(dim=1).to(torch.float32)
        scores[q], mask[q] = freq_score(freq, doc_len, sum_idf[q], k1, b,
                                        avgdl[q])
    return scores, mask


def sloppy_phrase_score(*args, **kwargs):
    raise NotPortedError("sloppy phrase queries (slop > 0) are not ported "
                         "yet")


def span_near_freq_unordered(*args, **kwargs):
    raise NotPortedError("unordered span_near is not ported yet")


def _phrase_scan_cuda(tokens, doc_len, qtids, deltas, sum_idf, k1, b, avgdl,
                      extent):
    dev = tokens.device
    n, length = tokens.shape
    n_queries, n_terms = qtids.shape
    for arg, t, dt in (("tokens", tokens, torch.int32),
                       ("extent", extent, torch.int32),
                       ("doc_len", doc_len, torch.int32),
                       ("qtids", qtids, torch.int32),
                       ("sum_idf", sum_idf, torch.float32),
                       ("avgdl", avgdl, torch.float32)):
        cuda_build.check_dtype("phrase_scan", arg, t, dt)
    if extent.shape != (n,) or doc_len.shape != (n,) or \
            len(deltas) != n_terms or sum_idf.shape != (n_queries,) or \
            avgdl.shape != (n_queries,) or min(deltas, default=0) < 0:
        raise ValueError(
            f"phrase_scan: shapes disagree: tokens {tuple(tokens.shape)}, "
            f"extent {tuple(extent.shape)}, doc_len {tuple(doc_len.shape)}, "
            f"qtids {tuple(qtids.shape)}, deltas {deltas}, sum_idf "
            f"{tuple(sum_idf.shape)}, avgdl {tuple(avgdl.shape)}")
    cuda_build.check_cuda("phrase_scan", dev, tokens=tokens, extent=extent,
                          doc_len=doc_len, qtids=qtids, sum_idf=sum_idf,
                          avgdl=avgdl)
    scores = torch.empty((n_queries, n), dtype=torch.float32, device=dev)
    mask = torch.empty((n_queries, n), dtype=torch.bool, device=dev)
    if n == 0 or n_queries == 0:
        return scores, mask
    if n_terms == 0 or length == 0:      # nothing can match
        return scores.zero_(), mask.zero_()
    k1_, k1p1, omb, b_ = bm25_constants(k1, b)
    host_deltas = (ctypes.c_int * n_terms)(*deltas)
    p = cuda_build.ptr
    PHRASE_SCAN.launch(dev, p(tokens), p(extent), p(doc_len), n, length,
                       p(qtids), n_queries, n_terms,
                       ctypes.addressof(host_deltas), p(sum_idf), p(avgdl),
                       float(k1_), float(k1p1), float(omb), float(b_),
                       p(scores), p(mask))
    return scores, mask
