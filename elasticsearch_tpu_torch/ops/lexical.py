"""Lexical scoring over the forward impact index.

Counterpart of ``elasticsearch_tpu/ops/lexical.py``: every doc row's
unique-term array is compared against the query terms — a dense [N, U]×[T]
compare/reduce with exact BM25 scores. On a CUDA tensor the batched scan is
kernel K1 (``csrc/bm25_scan.cu``), one launch for a whole batch of queries;
on a CPU tensor it is :func:`bm25_match_batch_plain`, the same arithmetic in
plain PyTorch, which the CPU tests hold against the JAX package and the card
holds K1 against bit for bit.

The classic (TF-IDF) and LM-Dirichlet similarities (the reference's
``classic_match`` and ``lm_dirichlet_match``) are K15, the same scan with
another per-term formula (``csrc/bm25_scan.cu``'s ``sim_scan_launch``,
:func:`sim_match_batch`), and :func:`term_set_scan` — does a row hold any
term of each query's expanded set (prefix / wildcard / regexp / fuzzy on a
text field) — is K16 (``csrc/term_set_scan.cu``).
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


SIM_SCAN = cuda_build.CudaKernel(
    "sim_scan", "bm25_scan.cu", "sim_scan_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

TERM_SET_SCAN = cuda_build.CudaKernel(
    "term_set_scan", "term_set_scan.cu", "term_set_scan_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p])

#: the similarities K15 computes (its ``sim`` argument)
SIM_CLASSIC = 1
SIM_LM_DIRICHLET = 2

#: LM Dirichlet's floor of P(t|C), as the reference's weakly typed 1e-12
#: becomes in f32
LM_FRAC_FLOOR = float(np.float32(1e-12))

#: the plain set compare takes this many set terms at a time
_SET_CHUNK = 8


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


# ---------------------------------------------------------------------------
# K15: the classic and LM-Dirichlet similarities
# ---------------------------------------------------------------------------

def _hit_tf(uterms, utf, tid):
    """→ (any_hit [N] bool, tf [N] f32) of one query term over the rows."""
    hit = (uterms == tid) & (tid >= 0)
    return hit.any(dim=1), torch.where(hit, utf, 0.0).sum(dim=1)


def classic_match_batch_plain(uterms, utf, doc_len, qtids, qidf, qweight):
    """Classic TF-IDF (Lucene TFIDFSimilarity, the 2.x "default"):
    Σ_t qweight · idf² · √tf / √dl over the terms each row holds, in the
    reference's order, one query at a time; ``qidf`` is the classic idf
    (1 + ln(N / (df + 1))). → (scores [B, N] f32, nmatch [B, N] i32)."""
    dev = uterms.device
    n = uterms.shape[0]
    n_queries, n_terms = qtids.shape
    dl = doc_len.to(torch.float32)
    inv_norm = torch.where(doc_len > 0, 1.0 / torch.sqrt(dl), 0.0)
    out_s = torch.empty((n_queries, n), dtype=torch.float32, device=dev)
    out_n = torch.empty((n_queries, n), dtype=torch.int32, device=dev)
    for q in range(n_queries):
        scores = torch.zeros(n, dtype=torch.float32, device=dev)
        nmatch = torch.zeros(n, dtype=torch.int32, device=dev)
        for t in range(n_terms):
            any_hit, tf = _hit_tf(uterms, utf, qtids[q, t])
            scores = scores + qweight[q, t] * (qidf[q, t] * qidf[q, t]) * \
                torch.where(any_hit, torch.sqrt(tf) * inv_norm, 0.0)
            nmatch = nmatch + any_hit.to(torch.int32)
        out_s[q], out_n[q] = scores, nmatch
    return out_s, out_n


def lm_dirichlet_match_batch_plain(uterms, utf, doc_len, qtids, qctf_frac,
                                   qweight, mu):
    """LM Dirichlet smoothing (Lucene LMDirichletSimilarity): per matched
    term max(log(1 + tf / (μ·P(t|C))) + log(μ / (dl + μ)), 0) · qweight,
    summed in term order, one query at a time; ``qctf_frac`` is each term's
    collection frequency over the collection's tokens, ``mu`` [B] f32.
    → (scores [B, N] f32, nmatch [B, N] i32)."""
    dev = uterms.device
    n = uterms.shape[0]
    n_queries, n_terms = qtids.shape
    dl = doc_len.to(torch.float32)
    out_s = torch.empty((n_queries, n), dtype=torch.float32, device=dev)
    out_n = torch.empty((n_queries, n), dtype=torch.int32, device=dev)
    for q in range(n_queries):
        m = mu[q]
        norm = torch.log(m / (dl + m))                                # [N]
        scores = torch.zeros(n, dtype=torch.float32, device=dev)
        nmatch = torch.zeros(n, dtype=torch.int32, device=dev)
        for t in range(n_terms):
            any_hit, tf = _hit_tf(uterms, utf, qtids[q, t])
            term_score = torch.log1p(
                tf / (m * torch.clamp_min(qctf_frac[q, t], LM_FRAC_FLOOR))) \
                + norm
            scores = scores + qweight[q, t] * torch.where(
                any_hit, torch.clamp_min(term_score, 0.0), 0.0)
            nmatch = nmatch + any_hit.to(torch.int32)
        out_s[q], out_n[q] = scores, nmatch
    return out_s, out_n


def sim_match_batch(sim: int, uterms, utf, doc_len, qtids, qa, qweight,
                    mu=None, *, trailing_pad: bool = False):
    """A batch of match queries under the classic (``SIM_CLASSIC``: ``qa``
    the classic idf) or LM-Dirichlet (``SIM_LM_DIRICHLET``: ``qa`` P(t|C),
    ``mu`` [B] f32) similarity against one segment. Shapes as
    :func:`bm25_match_batch`; ``nmatch`` is always computed (the mask is
    ``nmatch >= required``). → (scores [B, N] f32, nmatch [B, N] i32)."""
    if sim not in (SIM_CLASSIC, SIM_LM_DIRICHLET):
        raise ValueError(f"unknown similarity [{sim}]")
    if uterms.device.type == "cpu":
        if sim == SIM_CLASSIC:
            return classic_match_batch_plain(uterms, utf, doc_len, qtids, qa,
                                             qweight)
        return lm_dirichlet_match_batch_plain(uterms, utf, doc_len, qtids,
                                              qa, qweight, mu)
    return _sim_scan_cuda(sim, uterms, utf, doc_len, qtids, qa, qweight, mu,
                          trailing_pad)


def _sim_scan_cuda(sim, uterms, utf, doc_len, qtids, qa, qweight, mu,
                   trailing_pad):
    dev = uterms.device
    n, u = uterms.shape
    n_queries, n_terms = qtids.shape
    if sim == SIM_LM_DIRICHLET:
        if mu is None or mu.shape != (n_queries,):
            raise ValueError("sim_scan: LM Dirichlet needs mu [B]")
        cuda_build.check_dtype("sim_scan", "mu", mu, torch.float32)
    for arg, t, dt in (("uterms", uterms, torch.int32),
                       ("utf", utf, torch.float32),
                       ("doc_len", doc_len, torch.int32),
                       ("qtids", qtids, torch.int32),
                       ("qa", qa, torch.float32),
                       ("qweight", qweight, torch.float32)):
        cuda_build.check_dtype("sim_scan", arg, t, dt)
    if utf.shape != (n, u) or doc_len.shape != (n,) or \
            qa.shape != (n_queries, n_terms) or \
            qweight.shape != (n_queries, n_terms):
        raise ValueError(
            f"sim_scan: shapes disagree: uterms {tuple(uterms.shape)}, "
            f"utf {tuple(utf.shape)}, doc_len {tuple(doc_len.shape)}, "
            f"qtids {tuple(qtids.shape)}, qa {tuple(qa.shape)}, "
            f"qweight {tuple(qweight.shape)}")
    mu_ = mu if sim == SIM_LM_DIRICHLET else None
    cuda_build.check_cuda("sim_scan", dev, uterms=uterms, utf=utf,
                          doc_len=doc_len, qtids=qtids, qa=qa,
                          qweight=qweight, mu=mu_)
    scores = torch.empty((n_queries, n), dtype=torch.float32, device=dev)
    nmatch = torch.empty((n_queries, n), dtype=torch.int32, device=dev)
    if n == 0 or n_queries == 0:
        return scores, nmatch
    if n_terms == 0 or u == 0:          # no term can hit: nothing to scan
        return scores.zero_(), nmatch.zero_()
    p = cuda_build.ptr
    SIM_SCAN.launch(dev, p(uterms), p(utf), p(doc_len), n, u, p(qtids),
                    p(qa), p(qweight), p(mu_), n_queries, n_terms, int(sim),
                    LM_FRAC_FLOOR, int(bool(trailing_pad)), p(scores),
                    p(nmatch))
    return scores, nmatch


# ---------------------------------------------------------------------------
# K16: term-set membership over the rows
# ---------------------------------------------------------------------------

def term_set_index(tids):
    """The batch's term sets as K13 and K16 read them: ``tids`` [B, T]
    int32 (-1 pads) → (keys [K] int32, the sorted union of the batch's ids;
    bits [K, G] int64, bit ``q % 64`` of ``bits[k, q // 64]`` set when
    query ``q``'s set holds ``keys[k]``; G = ceil(B / 64))."""
    dev = tids.device
    n_queries, n_terms = tids.shape
    groups = (n_queries + 63) // 64
    flat = tids.reshape(-1)
    keep = flat >= 0
    qidx = torch.arange(n_queries, dtype=torch.int64,
                        device=dev).repeat_interleave(n_terms)[keep]
    keys, inv = torch.unique(flat[keep], sorted=True, return_inverse=True)
    pairs = torch.unique(inv.to(torch.int64) * n_queries + qidx)
    key_i, q_i = pairs // n_queries, pairs % n_queries
    bits = torch.zeros((keys.shape[0], groups), dtype=torch.int64,
                       device=dev)
    # distinct bits of one word: adding them is or-ing them
    bits.view(-1).index_add_(0, key_i * groups + q_i // 64,
                             torch.bitwise_left_shift(torch.ones_like(q_i),
                                                      q_i % 64))
    return keys.to(torch.int32).contiguous(), bits


def term_set_scan(uterms, tids, *, trailing_pad: bool = False):
    """Does row ``d`` hold any term of query ``q``'s set? — the text arm of
    the reference's ``_vocab_scan_mask`` (``(uterms[:, :, None] == tids)
    .any((1, 2))``) for a batch.

    uterms: [N, U] int32 (-1 pads); tids: [B, T] int32 (-1 pads, T a power
    of two). → [B, N] bool."""
    if uterms.device.type == "cpu":
        return term_set_scan_plain(uterms, tids)
    return _term_set_scan_cuda(uterms, tids, trailing_pad)


def term_set_hits(cells, tids):
    """[N, W] bool: the cell holds one of ``tids`` ([T], -1 pads), compared
    a few set terms at a time (never an [N, W, T] intermediate). ``cells``
    is a row's unique terms (K16) or its positions (K13's term_set leaf)."""
    hit = torch.zeros(cells.shape, dtype=torch.bool, device=cells.device)
    for lo in range(0, tids.shape[0], _SET_CHUNK):
        chunk = tids[lo:lo + _SET_CHUNK]
        hit |= ((cells[:, :, None] == chunk[None, None, :])
                & (chunk[None, None, :] >= 0)).any(dim=2)
    return hit


def term_set_scan_plain(uterms, tids):
    """K16's plain version: the reference's compare, one query at a time."""
    if tids.shape[0] == 0:
        return torch.zeros((0, uterms.shape[0]), dtype=torch.bool,
                           device=uterms.device)
    return torch.stack([term_set_hits(uterms, t).any(dim=1) for t in tids])


def _term_set_scan_cuda(uterms, tids, trailing_pad):
    dev = uterms.device
    n, u = uterms.shape
    n_queries = tids.shape[0]
    cuda_build.check_dtype("term_set_scan", "uterms", uterms, torch.int32)
    cuda_build.check_dtype("term_set_scan", "tids", tids, torch.int32)
    if tids.dim() != 2:
        raise ValueError(f"term_set_scan: tids must be [B, T], got "
                         f"{tuple(tids.shape)}")
    cuda_build.check_cuda("term_set_scan", dev, uterms=uterms, tids=tids)
    out = torch.empty((n_queries, n), dtype=torch.bool, device=dev)
    if n == 0 or n_queries == 0:
        return out
    keys, bits = term_set_index(tids)
    if u == 0 or keys.shape[0] == 0:    # no set term: nothing to scan
        return out.zero_()
    p = cuda_build.ptr
    TERM_SET_SCAN.launch(dev, p(uterms), n, u, p(keys), keys.shape[0],
                         p(bits), bits.shape[1], n_queries,
                         int(bool(trailing_pad)), p(out))
    return out
