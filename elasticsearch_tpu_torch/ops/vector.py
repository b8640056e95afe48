"""Dense-vector scoring — brute-force exact kNN.

Counterpart of ``elasticsearch_tpu/ops/vector.py``. Vectors are [N, D]
matrices, L2-normalized at pack time, so a cosine is a dot product and a
batch of queries is one matrix product. The f32 products go to
``torch.matmul`` (the JAX package left them to XLA outside any kernel): full
f32, never TF32 — the port leaves ``torch.backends.cuda.matmul.allow_tf32``
and the float32 matmul precision at PyTorch's defaults (False, "highest").

The int8 path (``index.knn.quantization: int8``) is kernel K4
(``csrc/int8_cosine.cu``) on a CUDA tensor: it reads the int8 column once
per batch and never writes a float copy of it. On a CPU tensor it is
:func:`cosine_scores_int8_batch_plain`, the reference's arithmetic, which the
CPU tests hold against the JAX package and the card holds K4 against.

Every product here is f32: the reference's ``use_bf16`` option, which no
caller sets, is not ported (bf16 input rounding visibly reorders near-tie
cosine rankings).
"""

from __future__ import annotations

import ctypes

import torch

from elasticsearch_tpu_torch.ops import cuda_build
from elasticsearch_tpu_torch.ops import topk as topk_ops

INT8_COSINE = cuda_build.CudaKernel(
    "int8_cosine", "int8_cosine.cu", "int8_cosine_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_float, ctypes.c_void_p])


def l2_normalize(x, axis=-1, eps=1e-12):
    return x / torch.sqrt((x * x).sum(dim=axis, keepdim=True) + eps)


def cosine_scores(vecs, exists, q):
    """Cosine similarity of one query vector against all docs.

    vecs: [N, D] f32 (pre-normalized at pack time); q: [D] f32.
    Returns scores[N] f32 in [-1, 1]; non-existent rows score 0.
    """
    return torch.where(exists, vecs @ l2_normalize(q), 0.0)


def cosine_scores_batch(vecs, exists, qs):
    """qs: [Q, D] → scores [Q, N]: one matrix product for the batch."""
    qn = l2_normalize(qs, axis=-1)
    return torch.where(exists[None, :], qn @ vecs.T, 0.0)


def dot_scores(vecs, exists, q):
    return torch.where(exists, vecs @ q, 0.0)


def cosine_scores_int8_batch(qvecs, scale: float, offset: float, exists, qs):
    """Batched cosine over an int8-quantized column.

    qvecs: [N, D] int8 with ``v ≈ q·scale + offset`` per component (the
    segment's scale/offset snapshot); exists: [N] bool; qs: [Q, D] f32
    (normalized again here, as the reference does). The dequantized dot
    expands to ``scale·(qint·qn) + offset·Σqn``. → scores [Q, N] f32;
    non-existent rows score 0. K4 on a CUDA tensor, the plain version on a
    CPU tensor."""
    qn = l2_normalize(qs, axis=-1)
    qsum = qn.sum(dim=-1)
    if qvecs.device.type == "cpu":
        return cosine_scores_int8_batch_plain(qvecs, scale, offset, exists,
                                              qn, qsum)
    return _int8_cosine_cuda(qvecs, scale, offset, exists, qn, qsum)


def cosine_scores_int8_batch_plain(qvecs, scale: float, offset: float,
                                   exists, qn, qsum):
    """K4's plain PyTorch version: ``(qn @ float(qvecs).T) * scale + offset
    * qsum`` then the exists select, in the reference's order. Writes a
    float copy of the whole column first."""
    s = (qn @ qvecs.to(torch.float32).T) * float(scale) \
        + float(offset) * qsum[:, None]
    return torch.where(exists[None, :], s, 0.0)


def _int8_cosine_cuda(qvecs, scale, offset, exists, qn, qsum):
    dev = qvecs.device
    if qvecs.dim() != 2 or qn.dim() != 2:
        raise ValueError(f"int8_cosine: qvecs and qn must be 2-D, got "
                         f"{tuple(qvecs.shape)} and {tuple(qn.shape)}")
    n, d = qvecs.shape
    b = qn.shape[0]
    for arg, t, dt in (("qvecs", qvecs, torch.int8), ("qn", qn, torch.float32),
                       ("qsum", qsum, torch.float32),
                       ("exists", exists, torch.bool)):
        cuda_build.check_dtype("int8_cosine", arg, t, dt)
    if qn.shape[1] != d or qsum.shape != (b,) or exists.shape != (n,):
        raise ValueError(
            f"int8_cosine: shapes disagree: qvecs {tuple(qvecs.shape)}, qn "
            f"{tuple(qn.shape)}, qsum {tuple(qsum.shape)}, exists "
            f"{tuple(exists.shape)}")
    if n >= 1 << 31 or b > 64 * 65535 or d == 0:
        raise ValueError(f"int8_cosine: [{b}, {n}, {d}] is outside the "
                         f"kernel's grid")
    qn, qsum = qn.contiguous(), qsum.contiguous()
    cuda_build.check_cuda("int8_cosine", dev, qvecs=qvecs, qn=qn, qsum=qsum,
                          exists=exists)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b == 0 or n == 0:
        return out
    p = cuda_build.ptr
    INT8_COSINE.launch(dev, p(qvecs), p(qn), p(qsum), p(exists), n, d, b,
                       float(scale), float(offset), p(out))
    return out


def filtered_topk_batch(scores, masks, k: int, doc_base: int = 0):
    """Batched filtered-kNN candidate selection: per-query top-k over
    pre-computed score rows with per-query eligibility masks (exists ∧
    live ∧ knn-filter) — the candidate-oversample step of the knn lane
    (``num_candidates`` rows per segment survive to the merge). Stable:
    ties → lower doc id (kernel K2 on a CUDA tensor).

    scores: [B, N] f32; masks: [B, N] bool → ([B, k] f32, [B, k] i32),
    padded with (-inf, -1) past the eligible rows."""
    ts, td, _ = topk_ops.select_top_k(scores, k, mask=masks.contiguous())
    if doc_base:
        td = torch.where(td >= 0, td + doc_base, -1)
    return ts, td


def script_cosine_scores(vecs, exists, q):
    """`script_score: cosineSimilarity(params.query_vector, 'field') + 1.0`
    — the ES idiom for non-negative cosine ranking (BASELINE config 4)."""
    return torch.where(exists, cosine_scores(vecs, exists, q) + 1.0, 0.0)
