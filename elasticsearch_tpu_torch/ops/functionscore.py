"""function_score evaluation over doc-values columns, batched.

Counterpart of ``elasticsearch_tpu/ops/functionscore.py`` (reference:
core/index/query/functionscore/* executed via
core/common/lucene/search/function/{FunctionScoreQuery,
FiltersFunctionScoreQuery, FieldValueFactorFunction}; BASELINE.md config
3). Each function maps a doc-values column to a per-doc factor; score_mode
combines several functions and boost_mode combines them with the query
score — element-wise torch ops. Function parameters are [B] tensors (one
value per query of the batch) and factors are [B, N]; a scalar parameter
gives an [N] factor, as in the reference.
"""

from __future__ import annotations

import torch

from elasticsearch_tpu_torch.ops import per_query as _q
from elasticsearch_tpu_torch.utils.murmur3 import murmur3_hash32

_U32 = 0xFFFFFFFF


def field_value_factor(values, exists, factor=1.0, modifier: str = "none",
                       missing=None):
    """FieldValueFactorFunction.java: modifier(factor * value); a doc
    without a value takes ``missing`` (0 when none is given)."""
    dev = values.device
    fill = 0.0 if missing is None else _q(missing, dev).to(torch.float32)
    v = torch.where(exists, values, fill).to(torch.float32) * \
        _q(factor, dev).to(torch.float32)
    if modifier == "none":
        return v
    if modifier == "log":
        return torch.log10(v)
    if modifier == "log1p":
        return torch.log10(v + 1.0)
    if modifier == "log2p":
        return torch.log10(v + 2.0)
    if modifier == "ln":
        return torch.log(v)
    if modifier == "ln1p":
        return torch.log1p(v)
    if modifier == "ln2p":
        return torch.log(v + 2.0)
    if modifier == "square":
        return v * v
    if modifier == "sqrt":
        return torch.sqrt(v)
    if modifier == "reciprocal":
        return 1.0 / v
    raise ValueError(f"unknown field_value_factor modifier [{modifier}]")


def decay(values, exists, origin, scale, offset, decay_value, kind: str):
    """gauss/exp/linear decay (DecayFunctionParser.java), every parameter in
    the value's own units (numbers, millis for dates), in f32 like the
    reference's traced constants."""
    dev = values.device
    origin, scale, offset, decay_value = (
        _q(x, dev).to(torch.float32)
        for x in (origin, scale, offset, decay_value))
    dist = torch.clamp_min(torch.abs(values - origin) - offset, 0.0)
    if kind == "gauss":
        sigma2 = -(scale * scale) / (2.0 * torch.log(decay_value))
        out = torch.exp(-(dist * dist) / (2.0 * sigma2))
    elif kind == "exp":
        lam = torch.log(decay_value) / scale
        out = torch.exp(lam * dist)
    elif kind == "linear":
        s = scale / (1.0 - decay_value)
        out = torch.clamp_min((s - dist) / s, 0.0)
    else:
        raise ValueError(f"unknown decay function [{kind}]")
    return torch.where(exists, out.to(torch.float32), 1.0)


def _mul_u32(a, c: int):
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit constant
    ``c``, in int64 without overflow: c is split into 16-bit halves, so no
    partial product reaches 2^49. (torch's uint32 arithmetic is thin.)"""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def random_score(n: int, seed: int, doc_base=0):
    """RandomScoreFunction: deterministic per (seed, doc id), the
    reference's uint32 mixing emulated in int64 with ``& 0xFFFFFFFF`` so it
    matches bit for bit. ``doc_base`` is a [B] tensor (→ [B, N]) or an int
    (→ [N])."""
    base = torch.as_tensor(doc_base, dtype=torch.int64)
    dev = base.device
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    ids = (ids + (base[:, None] if base.dim() == 1 else base)) & _U32
    h = (_mul_u32(ids, 0xCC9E2D51) +
         (murmur3_hash32(str(seed)) & _U32)) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return h.to(torch.float32) / torch.tensor(2.0 ** 32, dtype=torch.float32,
                                              device=dev)


def weight_factor(n: int, weight):
    """A constant factor: [B, N] for a [B] weight, [N] for a scalar."""
    w = _q(weight).to(torch.float32)
    return w.expand(w.shape[:-1] + (n,) if w.dim() else (n,))


def combine_functions(factors: list, masks: list, score_mode: str,
                      weights: list | None = None):
    """score_mode over per-function factors (function filters pre-applied
    as masks). A doc matched by NO function keeps the combined factor at
    1.0 in every mode (FiltersFunctionScoreQuery.innerScore starts from 1.0
    and its per-mode guards leave it when nothing matched). ``weights``
    (per-function [B] or scalars, default 1) feed avg's weighted
    denominator."""
    if not factors:
        return None
    dev = factors[0].device
    if score_mode == "first":
        # the first MATCHING function wins, not the first listed one
        out = torch.ones_like(factors[0])
        chosen = torch.zeros(factors[0].shape, dtype=torch.bool, device=dev)
        for f, m in zip(factors, masks):
            take = m & ~chosen
            out = torch.where(take, f, out)
            chosen = chosen | m
        return out
    if score_mode == "multiply":
        out = None
        for f, m in zip(factors, masks):
            f = torch.where(m, f, 1.0)
            out = f if out is None else out * f
        return out
    if score_mode in ("sum", "avg"):
        tot = wsum = None
        ws = weights if weights is not None else [1.0] * len(factors)
        for f, m, w in zip(factors, masks, ws):
            f = torch.where(m, f, 0.0)
            c = torch.where(m, _q(w, dev).to(torch.float32), 0.0)
            tot = f if tot is None else tot + f
            wsum = c if wsum is None else wsum + c
        out = tot if score_mode == "sum" else \
            tot / torch.clamp_min(wsum, 1e-9)
        return torch.where(wsum > 0, out, 1.0)
    if score_mode in ("max", "min"):
        red = torch.maximum if score_mode == "max" else torch.minimum
        fill = float("-inf") if score_mode == "max" else float("inf")
        out = any_m = None
        for f, m in zip(factors, masks):
            f = torch.where(m, f, fill)
            out = f if out is None else red(out, f)
            any_m = m if any_m is None else (any_m | m)
        # 1.0 only where NO function matched: a matched function that yields
        # ±inf keeps it
        return torch.where(any_m, out, 1.0)
    raise ValueError(f"unknown score_mode [{score_mode}]")


def apply_boost_mode(query_scores, factor, boost_mode: str, max_boost=None):
    """boost_mode combines the query score with the function factor
    (FunctionScoreQuery.java)."""
    if max_boost is not None:
        factor = torch.minimum(
            factor, _q(max_boost, factor.device).to(torch.float32))
    if boost_mode == "multiply":
        return query_scores * factor
    if boost_mode == "replace":
        return factor
    if boost_mode == "sum":
        return query_scores + factor
    if boost_mode == "avg":
        return (query_scores + factor) / 2.0
    if boost_mode == "max":
        return torch.maximum(query_scores, factor)
    if boost_mode == "min":
        return torch.minimum(query_scores, factor)
    raise ValueError(f"unknown boost_mode [{boost_mode}]")
