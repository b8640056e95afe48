"""Impact-ordered scoring, block-max pruning, the rescore stage, and the
top-k of candidate lists by (score desc, doc id asc).

Counterpart of ``elasticsearch_tpu/ops/blockmax.py``. The impact lane scores
from a precomputed quantized column (``index/segment.py`` ``ImpactColumn``):
per (doc, slot) the integer ``qimp[d, u]`` stands for the BM25 contribution
of the slot's term, so a query's score is an exact integer sum over the
slots holding its terms, dequantized with ONE f32 multiply by the segment's
scale times the query's boost.

Two hand kernels carry the lane on CUDA tensors:

* K6 ``csrc/impact_scan.cu`` (:func:`impact_scores_batch`) scores a batch of
  queries against one segment, every row: the eager arm, then K2's top-k;
* K7 ``csrc/blockmax_sweep.cu`` (:func:`blockmax_sweep`) sweeps one
  segment's row blocks per query in descending upper-bound order, skipping
  every block whose bound cannot reach the running k-th score, and merges
  the rows of each block it scores into the running top-k: the pruned arm,
  for any k (the running top-k in shared memory up to :data:`K7_SMEM_K`,
  in a global scratch buffer past it).

On CPU tensors each wrapper runs its plain PyTorch version beside it
(:func:`impact_scores_batch_plain`, :func:`blockmax_sweep_plain`), the JAX
bodies' arithmetic in their order, which the CPU tests hold against the JAX
package and the card holds each kernel against bit for bit. The rest of the
lane (block bounds, the sweep order, the rescore gather and window) is torch
ops. 16-bit impacts are ``torch.uint16``, which the CPU's gather and
index_select do not take: the bodies widen to int32 first, or read the
column through an ``int16`` view and mask the widened value back.

``topk_flat_by_doc`` / ``merge_topk_by_doc`` make the exact scorer's tie
order explicit for candidates that arrive out of doc order — the hybrid
fusion of the knn lane and the plain sweep reselect through them. Two stable
sorts, doc ascending first and then score descending, so equal scores keep
doc order; ``torch.sort(stable=True)`` is stable on CUDA as on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from elasticsearch_tpu_torch.ops import cuda_build
from elasticsearch_tpu_torch.ops import topk as topk_ops

NEG_INF = float("-inf")

#: sort key of an empty slot (doc id -1): after every real doc id
_PAD_DOC = 1 << 30

#: term-batch width of the plain score and bound reductions, as in the JAX
#: package (integer sums: the chunking changes no bit)
_TERM_BATCH = 8

#: rows a plain impact scan compares at once (bounds its [rows, U, 8]
#: intermediate; an integer sum, so the cut changes no bit)
_ROW_CHUNK = 1 << 16

#: largest k whose running top-k K7 keeps in shared memory (2·k 64-bit
#: keys a thread block); a larger k keeps it in a global scratch buffer
#: per thread block, which the wrapper allocates
K7_SMEM_K = 12288

#: the most thread blocks K7 gives one query (its cluster size)
_K7_MAX_CLUSTER = 8

#: the validated term caps (``validate_impact_settings``): the packed
#: Σq·256 + matches of the JAX body stays inside int32 up to these
_MAX_TERMS = {8: 255, 16: 127}

IMPACT_SCAN = cuda_build.CudaKernel(
    "impact_scan", "impact_scan.cu", "impact_scan_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

BLOCKMAX_SWEEP = cuda_build.CudaKernel(
    "blockmax_sweep", "blockmax_sweep.cu", "blockmax_sweep_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p])


def impact_bits(qimp: torch.Tensor) -> int:
    if qimp.dtype == torch.uint8:
        return 8
    if qimp.dtype == torch.uint16:
        return 16
    raise TypeError(f"impact columns are uint8 or uint16, got {qimp.dtype}")


def _check_terms(qimp, qtids) -> None:
    cap = _MAX_TERMS[impact_bits(qimp)]
    if qtids.shape[-1] > cap:
        raise ValueError(
            f"impact scan: {qtids.shape[-1]} query terms exceed the cap "
            f"{cap} of {impact_bits(qimp)}-bit impacts")


def take_rows(qimp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``qimp[idx]`` widened to int32; a uint16 column is read through an
    int16 view (the CPU does not index uint16) and masked back."""
    if qimp.dtype == torch.uint16:
        return qimp.view(torch.int16)[idx].to(torch.int32) & 0xFFFF
    return qimp[idx].to(torch.int32)


# ---------------------------------------------------------------------------
# plain bodies (the JAX package's arithmetic)
# ---------------------------------------------------------------------------

def impact_scores(uterms, qimp, qtids):
    """Quantized scoring of queries against impact rows — the JAX body.

    uterms: [..., N, U] int32 (-1 pad); qimp: [..., N, U] uint8/uint16 (or
    already widened to int32); qtids: [..., T] int32 (-1 absent/pad), with
    the leading axes of uterms (none, or one per query).

    → (qsum [..., N] int32 — Σ of the matched quantized impacts; anyhit
    [..., N] bool). Each matched slot adds ``(q << 8) | 1``: the high bits
    carry Σq and the low byte the match count, in one reduction per chunk of
    :data:`_TERM_BATCH` terms, as the JAX body does."""
    enc = (qimp.to(torch.int32) << 8) + 1
    acc = torch.zeros(uterms.shape[:-1], dtype=torch.int32,
                      device=uterms.device)
    for lo in range(0, qtids.shape[-1], _TERM_BATCH):
        chunk = qtids[..., lo:lo + _TERM_BATCH]             # [..., C]
        chunk = chunk.unsqueeze(-2).unsqueeze(-2)           # [..., 1, 1, C]
        hit = (uterms.unsqueeze(-1) == chunk) & (chunk >= 0)
        acc = acc + torch.where(hit, enc.unsqueeze(-1), 0).sum(
            dim=(-2, -1), dtype=torch.int32)
    return acc >> 8, (acc & 0xFF) > 0


def _cursor_valid(sf, gids, cs, cd):
    """The score-order search_after continuation: ``sf < cs`` or a tie on
    ``cs`` past the cursor's doc (cs = +inf, cd = -1 for no cursor)."""
    return (sf < cs) | ((sf == cs) & (gids > cd))


def impact_scores_batch_plain(uterms, qimp, qtids, scale_boost, live, cs, cd,
                              doc_base: int = 0):
    """K6's plain PyTorch version: the JAX package's compare-and-sum in term
    chunks, one query at a time and rows in chunks of :data:`_ROW_CHUNK`,
    then ``sf = f32(qsum) · scale_boost`` and ``valid = anyhit ∧ live ∧
    cursor``. → (scores [B, N] f32, valid [B, N] bool)."""
    n = uterms.shape[0]
    b = qtids.shape[0]
    dev = uterms.device
    scores = torch.empty((b, n), dtype=torch.float32, device=dev)
    valid = torch.empty((b, n), dtype=torch.bool, device=dev)
    gids = torch.arange(n, dtype=torch.int32, device=dev) + int(doc_base)
    for q in range(b):
        for lo in range(0, n, _ROW_CHUNK):
            hi = min(lo + _ROW_CHUNK, n)
            qsum, anyhit = impact_scores(uterms[lo:hi], qimp[lo:hi], qtids[q])
            sf = qsum.to(torch.float32) * scale_boost[q]
            scores[q, lo:hi] = sf
            valid[q, lo:hi] = anyhit & live[lo:hi] & _cursor_valid(
                sf, gids[lo:hi], cs[q], cd[q])
    return scores, valid


def block_bounds(block_max, qtids):
    """Per-block integer upper bounds of a batch: Σ over each query's terms
    of ``block_max[:, t]``, in chunks of :data:`_TERM_BATCH` terms as the JAX
    body reduces them. block_max: [NB, V] uint8/uint16; qtids: [B, T]
    int32 (-1 absent). → [B, NB] int32. ``ub > 0`` exactly when some query
    term occurs in the block (present cells hold at least 1)."""
    nb = block_max.shape[0]
    b, t = qtids.shape
    ub = torch.zeros((b, nb), dtype=torch.int32, device=block_max.device)
    cols = block_max.t()                                    # [V, NB] view
    for lo in range(0, t, _TERM_BATCH):
        chunk = qtids[:, lo:lo + _TERM_BATCH]               # [B, C]
        vals = take_rows(cols, chunk.clamp(min=0).reshape(-1)).reshape(
            b, chunk.shape[1], nb)                          # [B, C, NB]
        ub = ub + torch.where((chunk >= 0)[:, :, None], vals, 0).sum(
            dim=1, dtype=torch.int32)
    return ub


def sweep_order(ub_i, scale_boost):
    """The sweep's inputs from the integer bounds: ``ub_f = f32(ub_i) ·
    scale_boost`` and the blocks in descending ``ub_f`` order, ties by block
    id (a stable sort, as ``jnp.argsort(-ub_f)`` is). → (ub_f [B, NB] f32,
    order [B, NB] int32)."""
    ub_f = ub_i.to(torch.float32) * scale_boost[:, None]
    order = torch.sort(-ub_f, dim=1, stable=True).indices
    return ub_f, order.to(torch.int32)


def pruned_carry_init(b: int, k: int, device):
    """A fresh cross-segment carry for :func:`blockmax_sweep`: (ts [B, k]
    f32 -inf, td [B, k] int32 -1, scored, skipped, matched [B] int32 0)."""
    zeros = torch.zeros(b, dtype=torch.int32, device=device)
    return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=device),
            torch.full((b, k), -1, dtype=torch.int32, device=device),
            zeros, zeros.clone(), zeros.clone())


def blockmax_sweep_plain(carry, uterms, qimp, live, ub_i, ub_f, order, qtids,
                         scale_boost, cs, cd, k: int, doc_base: int = 0):
    """K7's plain PyTorch version: the JAX package's ``lax.scan`` over the
    blocks as a Python loop, a query at a time. A block runs iff ``ub_i > 0``
    and ``ub_f >= θ`` (θ = the running k-th score, -inf until k are held);
    its rows score as :func:`impact_scores` does and their valid ones merge
    into the running top-k through :func:`merge_topk_by_doc`. → the new
    carry (the input is not changed)."""
    ts, td, scored, skipped, matched = (c.clone() for c in carry)
    n = uterms.shape[0]
    nb = ub_i.shape[1]
    r = n // nb
    dev = uterms.device
    rows = torch.arange(r, dtype=torch.int32, device=dev)
    ub_i_h, ub_f_h = ub_i.cpu(), ub_f.cpu()
    order_h = order.cpu()
    for q in range(qtids.shape[0]):
        n_scored = n_skipped = n_matched = 0
        q_ts, q_td = ts[q], td[q]
        for j in range(nb):
            bi = int(order_h[q, j])
            theta = float(q_ts[k - 1])
            if not (int(ub_i_h[q, bi]) > 0 and float(ub_f_h[q, bi]) >= theta):
                n_skipped += 1
                continue
            sl = slice(bi * r, (bi + 1) * r)
            qsum, anyhit = impact_scores(uterms[sl], qimp[sl], qtids[q])
            sf = qsum.to(torch.float32) * scale_boost[q]
            docs = rows + (bi * r + int(doc_base))
            valid = anyhit & live[sl] & _cursor_valid(sf, docs, cs[q], cd[q])
            q_ts, q_td = merge_topk_by_doc(
                q_ts, q_td, torch.where(valid, sf, NEG_INF),
                torch.where(valid, docs, -1), k)
            n_scored += 1
            n_matched += int(valid.sum())
        ts[q], td[q] = q_ts, q_td
        scored[q] += n_scored
        skipped[q] += n_skipped
        matched[q] += n_matched
    return ts, td, scored, skipped, matched


# ---------------------------------------------------------------------------
# kernel wrappers: the plain version on a CPU tensor, the kernel on a CUDA one
# ---------------------------------------------------------------------------

def impact_scores_batch(uterms, qimp, qtids, scale_boost, live, cs, cd,
                        doc_base: int = 0, *, trailing_pad: bool = False):
    """Score a batch of impact queries against one segment (K6 on CUDA).

    Args:
      uterms: [N, U] int32 unique term ids per row (-1 pad)
      qimp:   [N, U] uint8 / uint16 quantized impacts
      qtids:  [B, T] int32 per-segment term ids (-1 absent / pad)
      scale_boost, cs: [B] f32 — dequant scale × boost; cursor score
      cd:     [B] int32 cursor doc (global id; -1 and cs = +inf: none)
      live:   [N] bool; doc_base: global id of row 0
      trailing_pad: every row holds its terms first and -1 pads after;
              lets K6 stop a row at its first pad. Results are the same.

    Returns (scores [B, N] f32 ``f32(Σq) · scale_boost``, valid [B, N] bool
    ``anyhit ∧ live ∧ cursor``). Refuses more terms than the bit width's
    validated cap."""
    _check_terms(qimp, qtids)
    if uterms.device.type == "cpu":
        return impact_scores_batch_plain(uterms, qimp, qtids, scale_boost,
                                         live, cs, cd, doc_base)
    return _impact_scan_cuda(uterms, qimp, qtids, scale_boost, live, cs, cd,
                             doc_base, trailing_pad)


def blockmax_sweep(carry, uterms, qimp, live, ub_i, ub_f, order, qtids,
                   scale_boost, cs, cd, k: int, doc_base: int = 0, *,
                   trailing_pad: bool = False):
    """One segment's block-max sweep for a batch of queries (K7 on CUDA),
    threading the running top-k ``carry`` = (ts [B, k] f32, td [B, k] int32
    global ids, scored, skipped, matched [B] int32) across segments.

    ``ub_i`` [B, NB] int32 and ``ub_f`` [B, NB] f32 are each block's bounds
    (:func:`block_bounds`, :func:`sweep_order`), ``order`` [B, NB] int32 the
    visiting order; the N rows split into NB blocks of N / NB. The sweep is
    sequential per query — each block's run test reads the k-th score the
    blocks before it left — so its counters are the JAX package's. → the
    new carry. Any k."""
    _check_terms(qimp, qtids)
    if uterms.device.type == "cpu":
        return blockmax_sweep_plain(carry, uterms, qimp, live, ub_i, ub_f,
                                    order, qtids, scale_boost, cs, cd, k,
                                    doc_base)
    return _blockmax_sweep_cuda(carry, uterms, qimp, live, ub_i, ub_f, order,
                                qtids, scale_boost, cs, cd, k, doc_base,
                                trailing_pad)


def _check_segment(name, uterms, qimp, live, qtids, b_args) -> None:
    n, u = uterms.shape
    cuda_build.check_dtype(name, "uterms", uterms, torch.int32)
    cuda_build.check_dtype(name, "live", live, torch.bool)
    cuda_build.check_dtype(name, "qtids", qtids, torch.int32)
    impact_bits(qimp)
    b = qtids.shape[0]
    if qimp.shape != (n, u) or live.shape != (n,) or qtids.dim() != 2:
        raise ValueError(
            f"{name}: shapes disagree: uterms {tuple(uterms.shape)}, qimp "
            f"{tuple(qimp.shape)}, live {tuple(live.shape)}, qtids "
            f"{tuple(qtids.shape)}")
    for arg, t, dt in b_args:
        cuda_build.check_dtype(name, arg, t, dt)
        if t.shape[0] != b:
            raise ValueError(f"{name}: [{arg}] has {t.shape[0]} rows, the "
                             f"batch {b}")


def _impact_scan_cuda(uterms, qimp, qtids, scale_boost, live, cs, cd,
                      doc_base, trailing_pad):
    dev = uterms.device
    _check_segment("impact_scan", uterms, qimp, live, qtids,
                   (("scale_boost", scale_boost, torch.float32),
                    ("cs", cs, torch.float32), ("cd", cd, torch.int32)))
    cuda_build.check_cuda("impact_scan", dev, uterms=uterms, qimp=qimp,
                          live=live, qtids=qtids, scale_boost=scale_boost,
                          cs=cs, cd=cd)
    n, u = uterms.shape
    b, t = qtids.shape
    scores = torch.empty((b, n), dtype=torch.float32, device=dev)
    valid = torch.empty((b, n), dtype=torch.bool, device=dev)
    if n == 0 or b == 0:
        return scores, valid
    if t == 0 or u == 0:                 # no term can hit: no row is valid
        return scores.zero_().mul_(scale_boost[:, None]), valid.zero_()
    p = cuda_build.ptr
    IMPACT_SCAN.launch(dev, p(uterms), p(qimp), impact_bits(qimp), p(live),
                       n, u, p(qtids), b, t, p(scale_boost), p(cs), p(cd),
                       int(doc_base), int(bool(trailing_pad)), p(scores),
                       p(valid))
    return scores, valid


def _blockmax_sweep_cuda(carry, uterms, qimp, live, ub_i, ub_f, order, qtids,
                         scale_boost, cs, cd, k, doc_base, trailing_pad):
    dev = uterms.device
    ts, td, scored, skipped, matched = (c.clone() for c in carry)
    b = qtids.shape[0]
    _check_segment("blockmax_sweep", uterms, qimp, live, qtids,
                   (("ub_i", ub_i, torch.int32), ("ub_f", ub_f, torch.float32),
                    ("order", order, torch.int32),
                    ("scale_boost", scale_boost, torch.float32),
                    ("cs", cs, torch.float32), ("cd", cd, torch.int32),
                    ("ts", ts, torch.float32), ("td", td, torch.int32),
                    ("scored", scored, torch.int32),
                    ("skipped", skipped, torch.int32),
                    ("matched", matched, torch.int32)))
    n, u = uterms.shape
    nb = ub_i.shape[1]
    if ub_f.shape != ub_i.shape or order.shape != ub_i.shape or nb < 1 or \
            n % nb or ts.shape != (b, k) or td.shape != (b, k) or k < 1:
        raise ValueError(
            f"blockmax_sweep: {n} rows do not split into the bounds' "
            f"{tuple(ub_i.shape)} blocks, or the carry {tuple(ts.shape)} is "
            f"not [{b}, {k}] (ub_f {tuple(ub_f.shape)}, order "
            f"{tuple(order.shape)})")
    cuda_build.check_cuda("blockmax_sweep", dev, uterms=uterms, qimp=qimp,
                          live=live, ub_i=ub_i, ub_f=ub_f, order=order,
                          qtids=qtids, scale_boost=scale_boost, cs=cs, cd=cd,
                          ts=ts, td=td, scored=scored, skipped=skipped,
                          matched=matched)
    if b == 0 or n == 0:
        return ts, td, scored, skipped, matched
    # past K7_SMEM_K each thread block keeps its running top-k and merge
    # buffer (2·k keys) in its own slice of this buffer
    scratch = torch.empty(b * _K7_MAX_CLUSTER * 2 * k, dtype=torch.int64,
                          device=dev) if k > K7_SMEM_K else None
    p = cuda_build.ptr
    BLOCKMAX_SWEEP.launch(
        dev, p(uterms), p(qimp), impact_bits(qimp), p(live), n, u, nb,
        p(ub_i), p(ub_f), p(order), p(qtids), b, qtids.shape[1],
        p(scale_boost), p(cs), p(cd), k, int(doc_base),
        int(bool(trailing_pad)), p(ts), p(td), p(scored), p(skipped),
        p(matched), p(scratch))
    return ts, td, scored, skipped, matched


# ---------------------------------------------------------------------------
# the two arms of one segment
# ---------------------------------------------------------------------------

def eager_segment_topk(uterms, qimp, live, qtids, scale_boost, k: int,
                       doc_base: int, cs, cd, *, trailing_pad: bool = False):
    """A batch × one segment, full impact scoring (K6) then the stable
    masked top-k (K2). → (top_scores [B, k'] f32, top_docs [B, k']
    segment-LOCAL int32, count [B] int32), k' = min(k, N)."""
    sf, valid = impact_scores_batch(uterms, qimp, qtids, scale_boost, live,
                                    cs, cd, doc_base,
                                    trailing_pad=trailing_pad)
    return topk_ops.select_top_k(sf, min(k, uterms.shape[0]), mask=valid)


def pruned_segment_topk(carry, uterms, qimp, live, block_max, qtids,
                        scale_boost, k: int, doc_base: int, cs, cd, *,
                        trailing_pad: bool = False):
    """A batch's block-max sweep over one segment: the bounds and the sweep
    order (torch ops), then K7. → the new carry."""
    ub_i = block_bounds(block_max, qtids)
    ub_f, order = sweep_order(ub_i, scale_boost)
    return blockmax_sweep(carry, uterms, qimp, live, ub_i, ub_f, order, qtids,
                          scale_boost, cs, cd, k, doc_base,
                          trailing_pad=trailing_pad)


# ---------------------------------------------------------------------------
# the rescore stage: secondary scores of candidates, the window combine
# ---------------------------------------------------------------------------

def rescore_gather(uterms, qimp, docs, qtids, doc_base: int):
    """Secondary impact scoring of candidate GLOBAL doc ids against one
    segment's columns. docs: [B, W] int32 (-1 empty); qtids: [B, T].
    → (qsum [B, W] int32, zero outside the segment; hit [B, W] bool,
    matched and in the segment): summed over segments they compose the
    reader-wide secondary score, every doc living in one segment."""
    n = uterms.shape[0]
    local = docs - int(doc_base)
    in_seg = (docs >= 0) & (local >= 0) & (local < n)
    idx = local.clamp(0, n - 1).to(torch.int64)
    qsum, anyhit = impact_scores(uterms[idx], take_rows(qimp, idx), qtids)
    return torch.where(in_seg, qsum, 0), anyhit & in_seg


def _stable_argsort(key, dim=-1):
    return torch.sort(key, dim=dim, stable=True).indices


def rescore_window(scores, docs, sec, sec_hit, window, qw, rw, mode: str):
    """QueryRescorer's window combine and re-sort for a batch, the JAX
    body's float32 op order (``phase._apply_rescore``'s): ``prim =
    score·qw``; a matched window doc combines ``prim`` with ``sec·rw`` by
    ``mode``; an unmatched one keeps ``prim``; only the window re-sorts
    (score desc, doc asc) and the tail keeps its primary scores and order.

    scores/docs: [B, K] primary top-k (score desc, -1 padded); sec: [B, K]
    f32 secondary scores; sec_hit: [B, K] bool; window: [B] int32; qw, rw:
    [B] f32. Each product and sum is its own op, so nothing contracts into
    an FMA. The re-sort is the JAX body's lexsort (window before tail; the
    window by -score, the tail by position; then doc) as three stable
    sorts, where -0.0 and 0.0 tie as they do in the JAX body.
    → (scores [B, K], docs [B, K])."""
    k = scores.shape[1]
    pos = torch.arange(k, dtype=torch.int32, device=scores.device)
    n_valid = (docs >= 0).sum(dim=1, dtype=torch.int32)
    wi = torch.minimum(window, n_valid)
    in_w = pos[None, :] < wi[:, None]
    prim = torch.where(docs >= 0, scores * qw[:, None], scores)
    sec_w = torch.where(in_w, sec * rw[:, None], sec)
    if mode == "total":
        comb = prim + sec_w
    elif mode == "multiply":
        comb = prim * sec_w
    elif mode == "avg":
        comb = (prim + sec_w) / 2.0
    elif mode == "max":
        comb = torch.maximum(prim, sec_w)
    elif mode == "min":
        comb = torch.minimum(prim, sec_w)
    else:
        raise ValueError(f"illegal rescore score_mode [{mode}]")
    comb = torch.where(sec_hit, comb, prim)
    new_s = torch.where(in_w, comb, scores)
    group = (~in_w).to(torch.int32)
    mainkey = torch.where(in_w, -new_s, pos.to(torch.float32)[None, :])
    tiebreak = torch.where(in_w, docs, 0)
    order = _stable_argsort(tiebreak)
    order = torch.gather(order, 1, _stable_argsort(
        torch.gather(mainkey, 1, order)))
    order = torch.gather(order, 1, _stable_argsort(
        torch.gather(group, 1, order)))
    return torch.gather(new_s, 1, order), torch.gather(docs, 1, order)


# ---------------------------------------------------------------------------
# top-k of candidate lists by (score desc, doc id asc)
# ---------------------------------------------------------------------------

def topk_flat_by_doc(scores, docs, k: int):
    """Top-k of flat candidate lists by (score desc, doc id asc), batched
    over leading axes. Empty slots are (-inf, -1); lists shorter than k pad
    out. scores: [..., n] f32; docs: [..., n] int → ([..., k] f32,
    [..., k] docs)."""
    n = scores.shape[-1]
    if n < k:
        pad = [0, k - n]
        scores = torch.nn.functional.pad(scores, pad, value=NEG_INF)
        docs = torch.nn.functional.pad(docs, pad, value=-1)
    key_d = torch.where(docs >= 0, docs, _PAD_DOC)
    by_doc = torch.sort(key_d, dim=-1, stable=True).indices
    by_score = torch.sort(-torch.gather(scores, -1, by_doc), dim=-1,
                          stable=True).indices
    sel = torch.gather(by_doc, -1, by_score)[..., :k]
    ts = torch.gather(scores, -1, sel)
    return ts, torch.where(ts > NEG_INF, torch.gather(docs, -1, sel), -1)


def merge_topk_by_doc(scores_a, docs_a, scores_b, docs_b, k: int):
    """Top-k of the concatenation of two candidate lists (along the last
    axis) by (score desc, doc id asc). Empty slots: (-inf, -1)."""
    return topk_flat_by_doc(torch.cat([scores_a, scores_b], dim=-1),
                            torch.cat([docs_a, docs_b], dim=-1), k)
