"""MaxSim — late-interaction scoring over multi-vector columns.

Counterpart of ``elasticsearch_tpu/ops/maxsim.py``. ColBERT-style late
interaction scores a document by summing, per query token, the best
similarity against any document token: ``score(q, d) = Σ_i max_j q_i · d_j``.
Token vectors are L2-normalized at pack time, so a token dot is a cosine.
Padded doc tokens (``j >= lens[n]``) never win the max; padded query tokens
(``qmask`` False) add nothing; a doc with no tokens scores 0.

The batched bodies are kernel K5 (``csrc/maxsim.cu``, one source for f32 and
int8 tokens, with an entry point and a launch counter for each:
:data:`MAXSIM` and :data:`MAXSIM_INT8`) on a CUDA tensor: the [B·Qt, N·T] similarity never reaches
device memory, only the [B, N] scores. On a CPU tensor they are the
``*_plain`` versions, the reference's arithmetic over chunks of
:data:`PLAIN_CHUNK_DOCS` docs (so the plain version also runs at the card's
shapes, for the comparison), with the sum over query tokens taken in
ascending order, as K5 takes it. The single-query bodies are the batched
ones with B = 1.
"""

from __future__ import annotations

import ctypes

import torch

from elasticsearch_tpu_torch.ops import cuda_build

#: docs per chunk of the plain versions: [B·Qt, chunk·T] f32 similarities
#: (537 MB at B = 64, Qt = 32, T = 32)
PLAIN_CHUNK_DOCS = 2048

#: K5's two instantiations, one entry point and one launch counter each
MAXSIM = cuda_build.CudaKernel(
    "maxsim", "maxsim.cu", "maxsim_f32_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p])
MAXSIM_INT8 = cuda_build.CudaKernel(
    "maxsim_int8", "maxsim.cu", "maxsim_int8_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def maxsim_scores_body(toks, lens, q, qmask):
    """MaxSim of ONE query against every doc of a segment.

    toks: [N, T, D] f32 (row-normalized tokens, zero padding); lens: [N]
    int32 real token counts; q: [Qt, D] f32 (normalized); qmask: [Qt] bool.
    → scores [N] f32."""
    return maxsim_scores_batch_body(toks, lens, q[None], qmask[None])[0]


def maxsim_scores_batch_body(toks, lens, qs, qmasks):
    """B queries × one segment → [B, N] f32 (qs: [B, Qt, D], qmasks: [B, Qt])."""
    if toks.device.type == "cpu":
        return maxsim_scores_batch_body_plain(toks, lens, qs, qmasks)
    return _maxsim_cuda(toks, lens, qs, qmasks, None, 1.0, 0.0)


def maxsim_scores_int8_body(qtoks, scale: float, offset: float, lens, q,
                            qmask):
    """MaxSim of ONE query over an int8-quantized token column."""
    return maxsim_scores_int8_batch_body(qtoks, scale, offset, lens, q[None],
                                         qmask[None])[0]


def maxsim_scores_int8_batch_body(qtoks, scale: float, offset: float, lens,
                                  qs, qmasks):
    """Batched MaxSim over int8 tokens (``v ≈ q·scale + offset`` per
    component): the max runs on the raw dots, and the affine correction —
    constant over the doc-token axis, scale ≥ 0 — applies to each per-token
    maximum: ``max·scale + offset·Σq``."""
    qsums = qs.sum(dim=2)
    if qtoks.device.type == "cpu":
        return maxsim_scores_int8_batch_body_plain(qtoks, scale, offset,
                                                   lens, qs, qmasks, qsums)
    return _maxsim_cuda(qtoks, lens, qs, qmasks, qsums, scale, offset)


def _maxsim_plain(toks, lens, qs, qmasks, correct):
    """The plain body: per chunk of docs, the [B·Qt, chunk·T] dots, the
    masked max over each doc's tokens, ``correct`` on the finite maxima and
    0 for the others (no tokens), then the masked sum over query tokens in
    ascending order."""
    n, t, d = toks.shape
    b, qt, _ = qs.shape
    out = torch.zeros((b, n), dtype=torch.float32, device=toks.device)
    flat_q = qs.reshape(b * qt, d)
    pos = torch.arange(t, device=toks.device)
    qm = qmasks.to(torch.float32)
    for lo in range(0, n, PLAIN_CHUNK_DOCS):
        hi = min(lo + PLAIN_CHUNK_DOCS, n)
        chunk = toks[lo:hi].to(torch.float32).reshape((hi - lo) * t, d)
        sim = (flat_q @ chunk.T).reshape(b, qt, hi - lo, t)
        valid = pos[None, :] < lens[lo:hi, None]
        sim = torch.where(valid[None, None], sim, float("-inf"))
        m = sim.amax(dim=3)                               # [B, Qt, chunk]
        tokmax = torch.where(torch.isfinite(m), correct(m), 0.0)
        acc = torch.zeros((b, hi - lo), dtype=torch.float32,
                          device=toks.device)
        for i in range(qt):
            acc = acc + tokmax[:, i] * qm[:, i, None]
        out[:, lo:hi] = acc
    return out


def maxsim_scores_batch_body_plain(toks, lens, qs, qmasks):
    """K5's plain PyTorch version, f32 tokens."""
    return _maxsim_plain(toks, lens, qs, qmasks, lambda m: m)


def maxsim_scores_int8_batch_body_plain(qtoks, scale: float, offset: float,
                                        lens, qs, qmasks, qsums):
    """K5's plain PyTorch version, int8 tokens: ``qsums`` [B, Qt] are the
    query tokens' component sums."""
    corr = float(offset) * qsums[:, :, None]
    return _maxsim_plain(qtoks, lens, qs, qmasks,
                         lambda m: m * float(scale) + corr)


def _maxsim_cuda(toks, lens, qs, qmasks, qsums, scale, offset):
    dev = toks.device
    is_int8 = qsums is not None
    if toks.dim() != 3 or qs.dim() != 3:
        raise ValueError(f"maxsim: toks and qs must be 3-D, got "
                         f"{tuple(toks.shape)} and {tuple(qs.shape)}")
    n, t, d = toks.shape
    b, qt, dq = qs.shape
    checks = [("toks", toks, torch.int8 if is_int8 else torch.float32),
              ("lens", lens, torch.int32), ("qs", qs, torch.float32),
              ("qmasks", qmasks, torch.bool)]
    if is_int8:
        checks.append(("qsums", qsums, torch.float32))
    for arg, tensor, dt in checks:
        cuda_build.check_dtype("maxsim", arg, tensor, dt)
    if dq != d or lens.shape != (n,) or qmasks.shape != (b, qt) or (
            is_int8 and qsums.shape != (b, qt)):
        raise ValueError(
            f"maxsim: shapes disagree: toks {tuple(toks.shape)}, lens "
            f"{tuple(lens.shape)}, qs {tuple(qs.shape)}, qmasks "
            f"{tuple(qmasks.shape)}")
    if n * t >= 1 << 31 or b * qt >= 1 << 31 or d == 0:
        raise ValueError(f"maxsim: [{b}, {qt}, {n}, {t}, {d}] is outside "
                         f"the kernel's grid")
    qs, qmasks = qs.contiguous(), qmasks.contiguous()
    if is_int8:
        qsums = qsums.contiguous()
    cuda_build.check_cuda("maxsim", dev, toks=toks, lens=lens, qs=qs,
                          qmasks=qmasks, qsums=qsums)
    out = torch.zeros((b, n), dtype=torch.float32, device=dev)
    if b == 0 or n == 0 or t == 0 or qt == 0:
        return out        # no doc tokens or no query tokens: every score 0
    p = cuda_build.ptr
    if is_int8:
        MAXSIM_INT8.launch(dev, p(toks), p(lens), p(qs), p(qmasks), p(qsums),
                           n, t, d, b, qt, float(scale), float(offset),
                           p(out))
    else:
        MAXSIM.launch(dev, p(toks), p(lens), p(qs), p(qmasks), n, t, d, b,
                      qt, p(out))
    return out
