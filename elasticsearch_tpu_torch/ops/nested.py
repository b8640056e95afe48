"""The nested query's child → parent reduce, batched.

Counterpart of the emit of ``elasticsearch_tpu/search/execute.py``'s
``_res_NestedQuery``: the inner query scores a path's child rows, and each
parent row takes what its children give it. For query b and parent p the
children c of p (rows ``offsets[p] .. offsets[p+1]`` of the child segment,
in child order) count when ``c_mask[b, c] & child_live[c]``; then

* ``matched[b, p]`` — any child counts;
* ``scores[b, p]`` — by ``score_mode``: ``none`` 1.0, ``max`` / ``min`` the
  extreme of the counted children's scores, ``sum`` their sum, ``avg`` the
  sum over max(count, 1); times ``boost[b]`` where matched, 0.0 elsewhere.

The JAX package scatters the children onto their parents inline
(``.at[idx].max`` / ``.min`` / ``.add``). Here the join comes as the CSR
``offsets`` [N+1] i32 of the block's ``parent`` column
(``index/device_reader.nested_offsets``), and the reduce has two bodies:

* :func:`nested_reduce_plain`, plain torch ops: it walks every parent's
  children in child order (a step a child rank, over the parents that have
  a child of that rank), so a sum is the left-to-right sum of the children;
* on CUDA tensors kernel K19 (``csrc/nested_reduce.cu``): one thread a
  (query, parent) walks the same rows in the same order, so every mode comes
  out bit-identical to the plain version run on the card.

Both propagate a NaN among the counted scores of ``max`` and ``min`` (as
XLA's scatter max and min do), and among equal extremes ``max`` keeps +0.0
over -0.0 and ``min`` keeps -0.0 over +0.0, whatever the order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import cuda_build

#: score_mode → the kernel's mode code
MODES = {"none": 0, "max": 1, "min": 2, "sum": 3, "avg": 4}

NESTED_REDUCE = cuda_build.CudaKernel(
    "nested_reduce", "nested_reduce.cu", "nested_reduce_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p])


def nested_reduce_plain(c_scores, c_mask, child_live, offsets, boost,
                        score_mode: str):
    """K19's plain version: → (scores [B, N] f32, matched [B, N] bool).

    ``c_scores`` [B, Nc] f32 and ``c_mask`` [B, Nc] bool are the inner
    query's child rows, ``child_live`` [Nc] bool, ``offsets`` [N+1] i32 the
    parents' child ranges, ``boost`` [B] f32. Parents are taken in
    descending child count, so the parents with a j-th child are a prefix at
    step j; each step folds that child into its parent's running value."""
    mode = _mode(score_mode)
    b = c_scores.shape[0]
    n = offsets.shape[0] - 1
    dev = c_scores.device
    off = offsets.to(torch.int64)
    counts = off[1:] - off[:-1]
    order = torch.argsort(counts, descending=True, stable=True)
    start = off[:-1][order]
    desc = counts[order].cpu().numpy()
    ok_all = c_mask & child_live[None, :]
    matched = torch.zeros((b, n), dtype=torch.bool, device=dev)
    nan = torch.zeros((b, n), dtype=torch.bool, device=dev)
    cnt = torch.zeros((b, n), dtype=torch.float32, device=dev)
    init = {1: float("-inf"), 2: float("inf")}.get(mode, 0.0)
    acc = torch.full((b, n), init, dtype=torch.float32, device=dev)
    for j in range(int(desc[0]) if n else 0):
        m = int(np.searchsorted(-desc, -j, side="left"))
        rows = start[:m] + j
        ok = ok_all[:, rows]
        matched[:, :m] |= ok
        if mode == 0:
            continue
        v = c_scores[:, rows]
        a = acc[:, :m]
        if mode in (1, 2):
            nan[:, :m] |= ok & torch.isnan(v)
            if mode == 1:
                better = (v > a) | ((v == a) & ~torch.signbit(v))
            else:
                better = (v < a) | ((v == a) & torch.signbit(v))
            acc[:, :m] = torch.where(ok & better, v, a)
        else:
            acc[:, :m] = a + torch.where(ok, v, 0.0)
            cnt[:, :m] += ok.to(torch.float32)
    if mode == 0:
        red = torch.ones((b, n), dtype=torch.float32, device=dev)
    elif mode in (1, 2):
        red = torch.where(nan, float("nan"), acc)
    elif mode == 3:
        red = acc
    else:
        red = acc / torch.clamp(cnt, min=1.0)
    res = torch.where(matched, red * boost[:, None], 0.0)
    scores = torch.empty_like(res)
    hit = torch.empty_like(matched)
    scores[:, order] = res
    hit[:, order] = matched
    return scores, hit


def nested_reduce(c_scores, c_mask, child_live, offsets, boost,
                  score_mode: str):
    """Reduce a nested clause's child rows onto the parents: → (scores
    [B, N] f32, matched [B, N] bool) on the inputs' device. A CPU device
    runs :func:`nested_reduce_plain`; a CUDA device launches K19 once."""
    if c_scores.device.type == "cpu":
        return nested_reduce_plain(c_scores, c_mask, child_live, offsets,
                                   boost, score_mode)
    return _nested_reduce_cuda(c_scores, c_mask, child_live, offsets, boost,
                               _mode(score_mode), c_scores.device)


def _mode(score_mode: str) -> int:
    if score_mode not in MODES:
        raise ValueError(f"unknown nested score_mode [{score_mode}]")
    return MODES[score_mode]


def _nested_reduce_cuda(c_scores, c_mask, child_live, offsets, boost, mode,
                        dev):
    name = "nested_reduce"
    for arg, t, dtype in (("c_scores", c_scores, torch.float32),
                          ("c_mask", c_mask, torch.bool),
                          ("child_live", child_live, torch.bool),
                          ("offsets", offsets, torch.int32),
                          ("boost", boost, torch.float32)):
        cuda_build.check_dtype(name, arg, t, dtype)
    b, nc = c_scores.shape
    n = offsets.shape[0] - 1
    if c_mask.shape != (b, nc) or child_live.shape != (nc,) or \
            boost.shape != (b,) or offsets.dim() != 1 or n < 0:
        raise ValueError(
            f"{name}: shapes disagree: c_scores {tuple(c_scores.shape)}, "
            f"c_mask {tuple(c_mask.shape)}, child_live "
            f"{tuple(child_live.shape)}, offsets {tuple(offsets.shape)}, "
            f"boost {tuple(boost.shape)}")
    c_scores, c_mask, boost = (c_scores.contiguous(), c_mask.contiguous(),
                               boost.contiguous())
    cuda_build.check_cuda(name, dev, c_scores=c_scores, c_mask=c_mask,
                          child_live=child_live, offsets=offsets,
                          boost=boost)
    scores = torch.empty((b, n), dtype=torch.float32, device=dev)
    matched = torch.empty((b, n), dtype=torch.bool, device=dev)
    if b == 0 or n == 0:
        return scores, matched
    NESTED_REDUCE.launch(dev, c_scores.data_ptr(), c_mask.data_ptr(),
                         child_live.data_ptr(), offsets.data_ptr(),
                         boost.data_ptr(), b, nc, n, mode,
                         scores.data_ptr(), matched.data_ptr())
    return scores, matched
