"""Top-k selection and cross-segment merge.

Counterpart of ``elasticsearch_tpu/ops/topk.py``. Lucene's
TopScoreDocCollector heap (core/search/query/QueryPhase.java:196) and the
coordinator's TopDocs.merge (SearchPhaseController.java:165-268) both need
the (score desc, doc asc) order. The JAX package gets it from the stability
of ``lax.top_k``; ``torch.topk`` promises no order for ties on CUDA, so the
port selects with its own stable kernel K2 (``csrc/topk.cu``) on CUDA
tensors and with :func:`select_top_k_plain` (a stable sort) on CPU tensors.
K2 cuts a row longer than :data:`CHUNK` entries over many blocks, each
sending on its chunk's top-k candidates, and one block per row then selects
among them; a row of at most :data:`CHUNK` entries takes one block. A k
above :data:`CHUNK` (a deep page: ``from + size`` past 16384) selects the
row's k best candidates into a buffer in device memory (many blocks a row
split the candidates at the bin of the k-th key, one block resolves that
bin), sorts it in :data:`TILE`-key tiles, a block a tile, and merges the
tiles pairwise, so K2 takes any k, as ``lax.top_k`` does. Within a segment position order is doc order; across
segments concatenated in segment order it is TopDocs.merge's order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import cuda_build

NEG_INF = float("-inf")

#: entries per K2 block. A block stages its chunk in shared memory as 4-byte
#: words (64 KiB, beside a 16 KiB histogram: two blocks per SM), so a row of
#: 2^20 docs is read once by 64 blocks and a batch of 64 such rows fills the
#: card's 132 SMs many times over. A row of at most CHUNK entries (the
#: cross-segment merge, [B, segments x k]) is one chunk: its single block
#: selects, sorts and writes, with no candidate buffer and no second launch.
#: It is also the largest k one block sorts in shared memory (16384 × 8 B =
#: 128 KB of the H100's 227 KB).
CHUNK = 16384
#: keys a block sorts for k above CHUNK (kTile in csrc/topk.cu): small
#: enough that a deep page's tiles sort on many SMs at once
TILE = 2048

TOPK = cuda_build.CudaKernel(
    "stable_topk", "topk.cu", "topk_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p])


def select_top_k(scores, k: int, mask=None, ids=None):
    """Stable masked top-k per row.

    Args:
      scores: [R, M] f32
      k:      results per row (k ≥ 1; rows shorter than k pad)
      mask:   [R, M] bool or None (all set)
      ids:    [R, M] int32 or None — the id each entry reports; None means
              its position 0..M-1

    An entry is eligible when its mask is set, its score is above -inf and
    its id is ≥ 0. Returns (top_scores [R, k] f32, top_ids [R, k] int32,
    count [R] int32 of eligible entries): the k best eligible entries by
    (score desc, position asc), padded with (-inf, -1).
    """
    if k < 1:
        raise ValueError(f"top-k: k must be at least 1, got {k}")
    if scores.device.type == "cpu":
        return select_top_k_plain(scores, k, mask, ids)
    return _topk_cuda(scores, k, mask, ids)


def select_top_k_plain(scores, k: int, mask=None, ids=None):
    """K2's plain PyTorch version: a stable descending sort."""
    rows, m = scores.shape
    eligible = scores > NEG_INF
    if mask is not None:
        eligible = eligible & mask
    if ids is not None:
        eligible = eligible & (ids >= 0)
    count = eligible.sum(dim=1, dtype=torch.int32)
    masked = torch.where(eligible, scores, NEG_INF)
    kk = min(k, m)
    order = torch.sort(masked, dim=1, descending=True,
                       stable=True).indices[:, :kk]
    top_scores = torch.gather(masked, 1, order)
    valid = top_scores > NEG_INF
    picked = order.to(torch.int32) if ids is None \
        else torch.gather(ids, 1, order)
    top_ids = torch.where(valid, picked, -1)
    top_scores = torch.where(valid, top_scores, NEG_INF)
    if kk < k:
        top_scores = torch.nn.functional.pad(top_scores, (0, k - kk),
                                             value=NEG_INF)
        top_ids = torch.nn.functional.pad(top_ids, (0, k - kk), value=-1)
    return top_scores, top_ids, count


def _topk_cuda(scores, k: int, mask, ids):
    dev = scores.device
    if scores.dim() != 2:
        raise ValueError(f"stable_topk: scores must be [R, M], got "
                         f"{tuple(scores.shape)}")
    rows, m = scores.shape
    cuda_build.check_dtype("stable_topk", "scores", scores, torch.float32)
    cuda_build.check_dtype("stable_topk", "mask", mask, torch.bool)
    cuda_build.check_dtype("stable_topk", "ids", ids, torch.int32)
    for arg, t in (("mask", mask), ("ids", ids)):
        if t is not None and t.shape != scores.shape:
            raise ValueError(f"stable_topk: [{arg}] shape {tuple(t.shape)} "
                             f"!= scores {tuple(scores.shape)}")
    if m >= 1 << 31:
        raise ValueError(f"stable_topk: rows of {m} entries exceed int32")
    cuda_build.check_cuda("stable_topk", dev, scores=scores, mask=mask,
                          ids=ids)
    top_scores = torch.empty((rows, k), dtype=torch.float32, device=dev)
    top_ids = torch.empty((rows, k), dtype=torch.int32, device=dev)
    count = torch.empty((rows,), dtype=torch.int32, device=dev)
    if rows == 0:
        return top_scores, top_ids, count
    if m == 0:
        return top_scores.fill_(NEG_INF), top_ids.fill_(-1), count.zero_()
    # the sort buffer: a power of two, at least a warp's 32 keys
    kpad = max(32, 1 << (min(k, m) - 1).bit_length())
    chunks = -(-m // CHUNK)
    cand = state = runs = None
    if chunks > 1:
        # each chunk's candidates (its top-k and the rest of its k-th key's
        # radix bin: at most 2k keys), and per row the keys used and the
        # histogram of the keys' top 12 bits — on the caller's stream
        cand = torch.empty((rows, chunks * min(2 * k, CHUNK)),
                           dtype=torch.int64, device=dev)
        state = torch.zeros((rows, 4 + 4096), dtype=torch.int32, device=dev)
        if k > CHUNK:
            # every eligible key, then the boundary bin's keys; the row's k
            # best keys, sorted in TILE-key tiles and merged pairwise between
            # the two halves of runs
            cand = torch.empty((2, rows, chunks * CHUNK), dtype=torch.int64,
                               device=dev)
            runs = torch.empty((2, rows, -(-k // TILE) * TILE),
                               dtype=torch.int64, device=dev)
    p = cuda_build.ptr
    TOPK.launch(dev, p(scores), p(mask), p(ids), rows, m, k, kpad, CHUNK,
                p(cand), p(state), p(runs), p(top_scores), p(top_ids),
                p(count))
    return top_scores, top_ids, count


def top_k(scores, mask, k: int, doc_base: int = 0):
    """Per-segment top-k over the last axis.

    Args:
      scores: [..., N] f32; mask: [..., N] bool (padding/deleted/filtered-out
      rows False); k: results per row; doc_base: global doc id of row 0.

    Returns (top_scores [..., k] f32, top_docs [..., k] int32 global ids);
    empty slots have score -inf and doc id -1.
    """
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    ts, td, _ = select_top_k(scores.reshape(-1, n), k,
                             mask=mask.reshape(-1, n))
    if doc_base:
        td = torch.where(td >= 0, td + doc_base, -1)
    return ts.reshape(*lead, k), td.reshape(*lead, k)


def merge_top_k_batch_body(scores_list, docs_list, k: int, bases):
    """Batched cross-segment merge: per-segment ``([B, k_s], [B, k_s])``
    rankings (segment-LOCAL doc ids) → global ``([B, k], [B, k])``, each
    segment's ids shifted by its base and the candidates concatenated in
    segment order, so position order is TopDocs.merge's tie order."""
    docs = torch.cat([torch.where(d >= 0, d + int(b), -1)
                      for d, b in zip(docs_list, bases)], dim=1)
    scores = torch.cat(list(scores_list), dim=1)
    ts, td, _ = select_top_k(scores, k, ids=docs.to(torch.int32))
    return ts, td


def pack_batch_result_body(top_scores, top_docs, counts):
    """Pack a batched merge result into ONE f32 tensor ``[B, 2k+1]``
    (scores ‖ doc ids ‖ count) so the host needs a single device→host copy
    per batch. Doc ids and counts are exact in f32 below 2**24; callers must
    use the unpacked path beyond that."""
    return torch.cat([top_scores, top_docs.to(torch.float32),
                      counts.to(torch.float32)[:, None]], dim=1)


def unpack_batch_result(packed: np.ndarray, k: int):
    """Host-side inverse of :func:`pack_batch_result_body` →
    (scores [B,k] f32, docs [B,k] i32, counts [B] i64)."""
    scores = packed[:, :k]
    docs = packed[:, k:2 * k].astype(np.int32)
    counts = packed[:, 2 * k].astype(np.int64)
    return scores, docs, counts


def count_matches(mask):
    """Total hits per row (the search response's hits.total)."""
    return mask.sum(dim=-1, dtype=torch.int32)
