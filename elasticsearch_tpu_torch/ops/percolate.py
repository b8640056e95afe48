"""Masked many-query match reduction — the percolation kernel.

Counterpart of ``elasticsearch_tpu/ops/percolate.py``. Percolation inverts
the search workload: B registered queries score ONE probe document (a
one-doc segment padded to the row bucket). Each query gives per-row
(scores, mask); what the caller needs per QUERY is only (matched?, the
probe doc's score). Reducing that on the card keeps the device→host copy at
O(B) scalars instead of O(B·Np) rows, and a whole percolate call comes back
as one small packed array.

The JAX package reduces each lane inside its fused program
(``match_reduce_body`` then ``pack_match_result_body``). Here the bodies
keep their names and contracts as plain PyTorch, and on CUDA tensors
:func:`percolate_reduce` is kernel K10 (``csrc/percolate_reduce.cu``): ONE
launch reduces every lane of a percolate call (each lane a
``[B_l, Np]`` score and mask pair and its segment's live mask) into one
``[ΣB_l, 2]`` f32 tensor at the lanes' offsets. On CPU tensors it is
:func:`percolate_reduce_plain`, the JAX bodies applied lane by lane.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import cuda_build

PERCOLATE_REDUCE = cuda_build.CudaKernel(
    "percolate_reduce", "percolate_reduce.cu", "percolate_reduce_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])


def match_reduce_body(scores, mask):
    """[..., Np] (scores f32, mask bool) → (matched bool, best f32) with the
    trailing row axis reduced: matched = any row matches, best = the max
    matching score (0.0 when nothing matched). A NaN among the matching
    scores makes best NaN, as ``jnp.max`` propagates it; among matching
    zeros +0.0 wins over -0.0 (a row matching only at -0.0 keeps -0.0). The
    mask must already be live-masked so padding rows never match."""
    matched = mask.any(dim=-1)
    masked = torch.where(mask, scores, float("-inf"))
    best = masked.amax(dim=-1)
    pos_zero = (mask & (scores == 0) & ~torch.signbit(scores)).any(dim=-1)
    best = torch.where((best == 0) & pos_zero, 0.0, best)
    best = torch.where(matched, best, 0.0)
    return matched, best.to(torch.float32)


def pack_match_result_body(matched, best):
    """[B] matched bool + [B] best f32 → ONE [B, 2] f32 tensor (column 0:
    the 0/1 match flag, column 1: the score)."""
    return torch.stack([matched.to(torch.float32), best], dim=-1)


def unpack_match_result(packed, b: int):
    """Host side of :func:`pack_match_result_body`: → (matched [b] bool,
    scores [b] f32), dropping rows past ``b``."""
    arr = np.asarray(packed)
    return arr[:b, 0] > 0.5, arr[:b, 1].astype(np.float32)


def percolate_reduce_plain(lanes) -> torch.Tensor:
    """K10's plain version: each lane's ``(scores [B_l, Np], mask [B_l, Np],
    live [Np])`` reduced by :func:`match_reduce_body` over ``mask & live``
    and packed, the lanes' rows stacked in order → [ΣB_l, 2] f32."""
    packs = [pack_match_result_body(*match_reduce_body(s, m & live[None, :]))
             for s, m, live in lanes]
    if not packs:
        return torch.zeros((0, 2), dtype=torch.float32)
    return torch.cat(packs)


def percolate_reduce(lanes) -> torch.Tensor:
    """Reduce every lane of a percolate call to its per-query (flag, best)
    pair in one pass: → [ΣB_l, 2] f32 on the lanes' device, lane l's rows at
    the offset Σ_{j<l} B_j.

    ``lanes``: a list of ``(scores [B_l, Np_l] f32, mask [B_l, Np_l] bool,
    live [Np_l] bool)``, all on one device. A CPU device runs
    :func:`percolate_reduce_plain`; a CUDA device launches K10 once."""
    if not lanes:
        return torch.zeros((0, 2), dtype=torch.float32)
    dev = lanes[0][0].device
    if dev.type == "cpu":
        return percolate_reduce_plain(lanes)
    return _percolate_reduce_cuda(lanes, dev)


def _percolate_reduce_cuda(lanes, dev) -> torch.Tensor:
    table = []     # a lane's record: scores, mask, live, rows, Np, offset
    total = 0
    for i, (scores, mask, live) in enumerate(lanes):
        name = f"lane {i}"
        cuda_build.check_dtype("percolate_reduce", f"{name} scores", scores,
                               torch.float32)
        cuda_build.check_dtype("percolate_reduce", f"{name} mask", mask,
                               torch.bool)
        cuda_build.check_dtype("percolate_reduce", f"{name} live", live,
                               torch.bool)
        if scores.dim() != 2 or mask.shape != scores.shape or \
                live.shape != (scores.shape[1],):
            raise ValueError(
                f"percolate_reduce: {name}: shapes disagree: scores "
                f"{tuple(scores.shape)}, mask {tuple(mask.shape)}, live "
                f"{tuple(live.shape)}")
        cuda_build.check_cuda("percolate_reduce", dev, scores=scores,
                              mask=mask, live=live)
        rows, width = scores.shape
        table.append([scores.data_ptr(), mask.data_ptr(), live.data_ptr(),
                      rows, width, total])
        total += rows
    out = torch.empty((total, 2), dtype=torch.float32, device=dev)
    if total == 0:
        return out
    # one host→device copy of the lanes' records
    dev_table = torch.tensor(table, dtype=torch.int64).to(dev)
    PERCOLATE_REDUCE.launch(dev, dev_table.data_ptr(), len(table), total,
                            out.data_ptr())
    return out
