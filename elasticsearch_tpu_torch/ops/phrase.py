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

Sloppy phrases (``slop > 0``) follow the JAX package's in-order, anchored
semantics (:func:`_sloppy_displacement`): on a CUDA tensor the batch is
kernel K11 (``csrc/sloppy_phrase.cu``, :func:`sloppy_phrase_score_batch`),
the same row scan as K3; on a CPU tensor it is
:func:`sloppy_phrase_score_batch_plain`. Both sum a doc's positions in
ascending order, so they agree bit for bit. The span_near bodies
(``sloppy_phrase_count``, unordered span-near) come with the span queries.
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

SLOPPY_PHRASE_SCAN = cuda_build.CudaKernel(
    "sloppy_phrase_scan", "sloppy_phrase.cu", "sloppy_phrase_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
     ctypes.c_void_p, ctypes.c_void_p])


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


def _sloppy_displacement(tokens, qtids, deltas: list[int], slop: int):
    """→ [N, L] int32: the total displacement of the in-order match anchored
    at each start position, or ``slop + 1`` where there is none within the
    slop (the JAX body marks those with a 1e9 sentinel; either way > slop
    means no match). Term 0 sits at its own position (shift 0); each later
    term takes its NEAREST admissible position, the smallest shift in
    [0, slop]. As in the JAX package, out-of-order matches are not found and
    a phrase repeating a term may map two query terms onto one position.

    tokens: [N, L] int32 (-1 holes); qtids: [T] int32 (-1 = absent: no
    match); deltas: T static ints."""
    def const(v):
        return torch.tensor(v, dtype=torch.int32, device=tokens.device)
    miss = const(slop + 1)
    total = None
    for i, d in enumerate(deltas):
        tid = qtids[i]
        best = None
        for s in ((0,) if i == 0 else range(slop + 1)):
            hit = (_shift_left(tokens, d + s) == tid) & (tid >= 0)
            cand = torch.where(hit, const(s), miss)
            best = cand if best is None else torch.minimum(best, cand)
        total = best if total is None else torch.minimum(total + best, miss)
    return total


def sloppy_phrase_freq(tokens, qtids, deltas: list[int], slop: int):
    """Proximity-weighted sloppy phrase frequency (Lucene
    SloppyPhraseScorer.sloppyFreq for in-order matches): each match at
    total displacement d adds ``1 / (1 + d)``, the positions summed in
    ascending order (as K11 sums them). → freq [N] f32."""
    total = _sloppy_displacement(tokens, qtids, deltas, slop)
    contrib = torch.where(total <= slop,
                          1.0 / (1.0 + total.to(torch.float32)), 0.0)
    freq = torch.zeros(tokens.shape[0], dtype=torch.float32,
                       device=tokens.device)
    for p in range(contrib.shape[1]):
        freq = freq + contrib[:, p]
    return freq


def idf_sum(idfs):
    """[..., T] f32 → Σ idf over the last axis, in term order, in f32 (the
    sloppy arm's device sum)."""
    out = idfs[..., 0]
    for t in range(1, idfs.shape[-1]):
        out = out + idfs[..., t]
    return out


def sloppy_phrase_score(tokens, doc_len, qtids, deltas: list[int], slop: int,
                        idfs, k1, b, avgdl):
    """BM25 over the sloppy frequency of one query (tf = sloppyFreq, idf =
    Σ idf of the phrase's terms summed in f32). → (scores [N] f32, mask [N]
    bool)."""
    freq = sloppy_phrase_freq(tokens, qtids, deltas, slop)
    return freq_score(freq, doc_len, idf_sum(idfs), k1, b, avgdl)


def sloppy_phrase_score_batch(tokens, doc_len, qtids, deltas, slop: int,
                              idfs, k1, b, avgdl, *, extent):
    """Score a batch of sloppy phrases (one shared ``deltas`` and ``slop``)
    against one segment: the batched form of the JAX package's
    ``sloppy_phrase_score``.

    Args as :func:`phrase_score_batch`, but ``slop`` (>= 0) and ``idfs``
    [B, T] f32, each phrase's per-term idf (summed on the card, in term
    order). Returns (scores [B, N] f32, mask [B, N] bool)."""
    deltas = [int(d) for d in deltas]
    if len(deltas) > MAX_TERMS:
        raise NotPortedError(
            f"a phrase of [{len(deltas)}] terms is above the port's limit "
            f"[{MAX_TERMS}]")
    if tokens.device.type == "cpu":
        return sloppy_phrase_score_batch_plain(tokens, doc_len, qtids,
                                               deltas, slop, idfs, k1, b,
                                               avgdl)
    return _sloppy_phrase_cuda(tokens, doc_len, qtids, deltas, int(slop),
                               idfs, k1, b, avgdl, extent)


def sloppy_phrase_score_batch_plain(tokens, doc_len, qtids, deltas, slop,
                                    idfs, k1, b, avgdl):
    """K11's plain version: :func:`sloppy_phrase_score` one query at a time
    with [N, L] temporaries; never a [B, N, L] intermediate."""
    n = tokens.shape[0]
    n_queries = qtids.shape[0]
    scores = torch.empty((n_queries, n), dtype=torch.float32,
                         device=tokens.device)
    mask = torch.empty((n_queries, n), dtype=torch.bool, device=tokens.device)
    for q in range(n_queries):
        scores[q], mask[q] = sloppy_phrase_score(
            tokens, doc_len, qtids[q], deltas, slop, idfs[q], k1, b,
            avgdl[q])
    return scores, mask


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


def _sloppy_phrase_cuda(tokens, doc_len, qtids, deltas, slop, idfs, k1, b,
                        avgdl, extent):
    dev = tokens.device
    n, length = tokens.shape
    n_queries, n_terms = qtids.shape
    for arg, t, dt in (("tokens", tokens, torch.int32),
                       ("extent", extent, torch.int32),
                       ("doc_len", doc_len, torch.int32),
                       ("qtids", qtids, torch.int32),
                       ("idfs", idfs, torch.float32),
                       ("avgdl", avgdl, torch.float32)):
        cuda_build.check_dtype("sloppy_phrase_scan", arg, t, dt)
    if extent.shape != (n,) or doc_len.shape != (n,) or \
            len(deltas) != n_terms or idfs.shape != qtids.shape or \
            avgdl.shape != (n_queries,) or min(deltas, default=0) < 0 or \
            slop < 0:
        raise ValueError(
            f"sloppy_phrase_scan: shapes disagree: tokens "
            f"{tuple(tokens.shape)}, extent {tuple(extent.shape)}, doc_len "
            f"{tuple(doc_len.shape)}, qtids {tuple(qtids.shape)}, deltas "
            f"{deltas}, slop {slop}, idfs {tuple(idfs.shape)}, avgdl "
            f"{tuple(avgdl.shape)}")
    cuda_build.check_cuda("sloppy_phrase_scan", dev, tokens=tokens,
                          extent=extent, doc_len=doc_len, qtids=qtids,
                          idfs=idfs, avgdl=avgdl)
    scores = torch.empty((n_queries, n), dtype=torch.float32, device=dev)
    mask = torch.empty((n_queries, n), dtype=torch.bool, device=dev)
    if n == 0 or n_queries == 0:
        return scores, mask
    if n_terms == 0 or length == 0:      # nothing can match
        return scores.zero_(), mask.zero_()
    k1_, k1p1, omb, b_ = bm25_constants(k1, b)
    host_deltas = (ctypes.c_int * n_terms)(*deltas)
    p = cuda_build.ptr
    SLOPPY_PHRASE_SCAN.launch(
        dev, p(tokens), p(extent), p(doc_len), n, length, p(qtids),
        n_queries, n_terms, ctypes.addressof(host_deltas), slop, p(idfs),
        p(avgdl), float(k1_), float(k1p1), float(omb), float(b_), p(scores),
        p(mask))
    return scores, mask
