"""Span algebra over the position-indexed token matrix.

Counterpart of ``elasticsearch_tpu/ops/spans.py``. Lucene's span queries
enumerate (start, end) position intervals per doc and combine them (or /
not / first / near / containing / within). The representation is the
**min-end map**: for every start position ``p`` of a doc, ``ends[doc, p]``
holds the SMALLEST end of a span starting at ``p`` (``INF`` when no span
starts there). Every span the algebra makes ends after it starts
(``ends[p] > p``), which the O(L) forms of ``containing_ends``,
``within_ends`` and ``not_ends`` below rely on.

The JAX package's ``containing_ends`` and ``within_ends`` loop over all L
shifts (O(L²) a row); here they are one suffix-min and one prefix-max scan,
and ``not_ends`` is one prefix-max scan where the reference takes two
prefix sums over ``coverage`` — equal for every map with ``end > start``,
which the CPU tests check against the JAX bodies on random maps.

A span query tree is lowered to a :class:`SpanProgram`: a short postfix
program over a stack of maps, ending in ``span_freq`` and the BM25
``freq_score``. On a CUDA tensor :func:`span_program_score_batch` is kernel
K13 (``csrc/span_program.cu``), one launch for a batch of same-signature
queries; on a CPU tensor it is :func:`span_program_score_batch_plain`, which
runs the program with the functions of this module one query at a time.
Both count integers and round the ``freq_score`` epilogue one operation at
a time in the reference's order, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from elasticsearch_tpu_torch.common.errors import NotPortedError
from elasticsearch_tpu_torch.ops import cuda_build
from elasticsearch_tpu_torch.ops.lexical import (
    bm25_constants, term_set_hits, term_set_index)
from elasticsearch_tpu_torch.ops.phrase import freq_score

INF = 1 << 30


def _pos(ends) -> torch.Tensor:
    return torch.arange(ends.shape[1], dtype=torch.int32,
                        device=ends.device)[None, :]


def _inf(t) -> torch.Tensor:
    return torch.tensor(INF, dtype=torch.int32, device=t.device)


def term_ends(tokens, tid):
    """[N, L] token matrix + scalar term id → min-end map (unit spans)."""
    return torch.where((tokens == tid) & (tid >= 0), _pos(tokens) + 1,
                       _inf(tokens))


def term_set_ends(tokens, tids):
    """Unit spans at positions whose token is in ``tids`` ([T], -1 pad) —
    the span_multi rewrite (SpanMultiTermQueryWrapper)."""
    return torch.where(term_set_hits(tokens, tids), _pos(tokens) + 1,
                       _inf(tokens))


def pad_ends(ends, length: int):
    """Pad the position axis to a common width (no spans start in
    padding)."""
    if ends.shape[1] == length:
        return ends
    out = torch.full((ends.shape[0], length), INF, dtype=torch.int32,
                     device=ends.device)
    out[:, :ends.shape[1]] = ends
    return out


def or_ends(ends_list):
    """Union of span sets — min of min-ends per start (SpanOrQuery)."""
    out = ends_list[0]
    for e in ends_list[1:]:
        out = torch.minimum(out, e)
    return out


def first_ends(ends, end: int):
    """Spans ending at position ≤ ``end`` (SpanFirstQuery)."""
    return torch.where(ends <= end, ends, _inf(ends))


def _suffix_min(x):
    return torch.flip(torch.cummin(torch.flip(x, [1]), dim=1).values, [1])


def _first_start_from(ends):
    """F[q] = earliest start ≥ q with a span (else INF) — suffix min of
    start positions."""
    return _suffix_min(torch.where(ends < INF, _pos(ends), _inf(ends)))


def _take(a, idx):
    return torch.gather(a, 1, idx.to(torch.int64))


def near_unordered_ends(ends_list, slop: int):
    """Unordered near over span clauses (SpanNearQuery in_order=false,
    NearSpansUnordered): a window starts at ``p`` when some clause's span
    starts exactly at p and EVERY clause has a span inside the window,
    (window_end − window_start) − Σ span widths ≤ slop; each clause takes
    its earliest span starting ≥ p."""
    length = ends_list[0].shape[1]
    pos = _pos(ends_list[0])
    inf = _inf(ends_list[0])
    window_end = None
    total_len = torch.zeros_like(ends_list[0])
    anchored = torch.zeros(ends_list[0].shape, dtype=torch.bool,
                           device=pos.device)
    valid = torch.ones(ends_list[0].shape, dtype=torch.bool,
                       device=pos.device)
    for ek in ends_list:
        sk = _first_start_from(ek)           # earliest start ≥ p
        e_at = torch.where(sk < INF, _take(ek, sk.clamp(0, length - 1)),
                           inf)
        valid = valid & (sk < INF)
        anchored = anchored | (ek < INF)     # a span starts AT p
        window_end = e_at if window_end is None \
            else torch.maximum(window_end, e_at)
        total_len = total_len + torch.where(sk < INF, e_at - sk, 0)
    ok = valid & anchored & (window_end - pos - total_len <= slop)
    return torch.where(ok, window_end, inf)


def near_ordered_ends(ends_list, slop: int):
    """Ordered near over span clauses: chains each clause's EARLIEST start
    ≥ the previous clause's end, total inter-span gap ≤ slop (SpanNearQuery
    in_order)."""
    length = ends_list[0].shape[1]
    inf = _inf(ends_list[0])
    cur_end = ends_list[0]
    valid = cur_end < INF
    total_gap = torch.zeros_like(cur_end)
    for ek in ends_list[1:]:
        fk = _first_start_from(ek)
        in_range = valid & (cur_end < length)
        start_k = torch.where(in_range,
                              _take(fk, cur_end.clamp(0, length - 1)), inf)
        end_k = _take(ek, start_k.clamp(0, length - 1))
        valid = in_range & (start_k < INF)
        total_gap = total_gap + torch.where(valid, start_k - cur_end, 0)
        cur_end = torch.where(valid, end_k, inf)
    return torch.where(valid & (total_gap <= slop), cur_end, inf)


def coverage(ends):
    """[N, L] bool — positions covered by ANY span of the set (+1 at starts,
    −1 at ends, prefix sum > 0)."""
    n, length = ends.shape
    has = (ends < INF).to(torch.int32)
    delta = torch.zeros((n, length + 1), dtype=torch.int32,
                        device=ends.device)
    delta[:, :length] += has
    end_idx = torch.where(ends < INF, ends, 0).clamp(0, length)
    delta.scatter_add_(1, end_idx.to(torch.int64), -has)
    return torch.cumsum(delta, dim=1, dtype=torch.int32)[:, :length] > 0


def _prefix_max_ends(ends):
    """M[:, y] = the largest end of a span starting before ``y`` (−1 when
    none), for y in [0, L]."""
    n = ends.shape[0]
    pm = torch.cummax(torch.where(ends < INF, ends, -1), dim=1).values
    return torch.cat([torch.full((n, 1), -1, dtype=torch.int32,
                                 device=ends.device), pm], dim=1)


def not_ends(inc, exc, pre: int, post: int):
    """Include spans whose window [start−pre, end+post) does not touch any
    exclude span (SpanNotQuery). The reference asks whether a position of
    the window is covered by an exclude span; with ``end > start`` that is
    whether some exclude span starts before the window's end and ends after
    its start, one prefix max."""
    length = inc.shape[1]
    w0 = (_pos(inc) - pre).clamp(0, length)
    w1 = (torch.where(inc < INF, inc, 0) + post).clamp(0, length)
    reach = _take(_prefix_max_ends(exc), w1)
    covered = (w0 < w1) & (reach > w0)
    return torch.where((inc < INF) & ~covered, inc, _inf(inc))


def containing_ends(big, little):
    """Spans of ``big`` containing at least one ``little`` span
    (SpanContainingQuery): big [p, e) contains little [s, e') when
    p ≤ s < e and e' ≤ e. With e' > s, that is: the smallest little end
    among starts ≥ p is ≤ e (a suffix min)."""
    sm = _suffix_min(little)
    return torch.where((big < INF) & (sm <= big), big, _inf(big))


def within_ends(little, big):
    """Spans of ``little`` lying inside some ``big`` span
    (SpanWithinQuery): little at q with end l is inside big [s, e) when
    s ≤ q and e ≥ l — the largest big end among starts ≤ q is ≥ l (a
    prefix max)."""
    pm = torch.cummax(torch.where(big < INF, big, -1), dim=1).values
    return torch.where((little < INF) & (pm >= little), little,
                       _inf(little))


def span_freq(ends):
    """Span frequency per doc = number of starts with a span."""
    return (ends < INF).sum(dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# the lowered program
# ---------------------------------------------------------------------------

#: opcodes of a span program: (op, a, b, c)
OP_TERM = 0         # a: field index, b: term slot  → push term_ends
OP_TERM_SET = 1     # a: field index, b: set index  → push term_set_ends
OP_OR = 2           # a: n                          → pop n, push or_ends
OP_FIRST = 3        # a: end                        → first_ends on the top
OP_NEAR = 4         # a: n, b: slop, c: in_order    → pop n, push near
OP_NOT = 5          # a: pre, b: post               → pop exc, inc; push
OP_CONTAINING = 6   #                               → pop little, big; push
OP_WITHIN = 7       #                               → pop little, big; push

#: K13's limits (csrc/span_program.cu)
MAX_OPS = 64
MAX_FIELDS = 4
MAX_SETS = 8


@dataclass(frozen=True)
class SpanProgram:
    """A span query tree in postfix: ``code`` is a tuple of (op, a, b, c)
    instructions, ``fields`` the text fields whose token matrices the leaves
    read (by index), ``n_terms`` the term slots and ``n_sets`` the term
    sets, ``depth`` the deepest stack the program builds."""
    code: tuple
    fields: tuple
    n_terms: int
    n_sets: int
    depth: int


def program_depth(code) -> int:
    depth = top = 0
    for op, a, _b, _c in code:
        if op in (OP_TERM, OP_TERM_SET):
            top += 1
        elif op in (OP_OR, OP_NEAR):
            top -= a - 1
        elif op in (OP_NOT, OP_CONTAINING, OP_WITHIN):
            top -= 1
        depth = max(depth, top)
    if top != 1:
        raise ValueError(f"span program leaves {top} maps on its stack")
    return depth


def op_widths(code, widths: list[int]) -> list[int]:
    """Each instruction's map width: a leaf's is its field's L, a
    combinator's the widest of its operands', as the reference pads them."""
    stack, out = [], []
    for op, a, _b, _c in code:
        if op in (OP_TERM, OP_TERM_SET):
            w = widths[a]
        elif op in (OP_OR, OP_NEAR):
            w = max(stack[-a:])
            del stack[-a:]
        elif op in (OP_NOT, OP_CONTAINING, OP_WITHIN):
            w = max(stack[-2:])
            del stack[-2:]
        else:
            w = stack.pop()
        stack.append(w)
        out.append(w)
    return out


def span_program_freq(program: SpanProgram, tokens: list, tids, sets: list):
    """Run ``program`` for ONE query: ``tokens`` the [N, L_f] matrices by
    field index, ``tids`` [n_terms] int32, ``sets`` [T_j] int32 each (-1
    pads). → span freq [N] f32."""
    stack = []
    for op, a, b, c in program.code:
        if op == OP_TERM:
            stack.append(term_ends(tokens[a], tids[b]))
        elif op == OP_TERM_SET:
            stack.append(term_set_ends(tokens[a], sets[b]))
        elif op in (OP_OR, OP_NEAR):
            maps = stack[-a:]
            del stack[-a:]
            width = max(m.shape[1] for m in maps)
            maps = [pad_ends(m, width) for m in maps]
            if op == OP_OR:
                stack.append(or_ends(maps))
            else:
                near = near_ordered_ends if c else near_unordered_ends
                stack.append(near(maps, b))
        elif op == OP_FIRST:
            stack.append(first_ends(stack.pop(), a))
        else:
            second = stack.pop()
            first = stack.pop()
            width = max(first.shape[1], second.shape[1])
            first, second = pad_ends(first, width), pad_ends(second, width)
            if op == OP_NOT:
                stack.append(not_ends(first, second, a, b))
            elif op == OP_CONTAINING:
                stack.append(containing_ends(first, second))
            else:
                stack.append(within_ends(second, first))
    return span_freq(stack[-1])


SPAN_PROGRAM = cuda_build.CudaKernel(
    "span_program", "span_program.cu", "span_program_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])


def span_program_score_batch(program: SpanProgram, tokens: list,
                             extents: list, doc_len, tids, sets: list,
                             sum_idf, k1, b, avgdl):
    """Score a batch of same-signature span queries against one segment:
    each query's span frequency under ``program``, then BM25 over it
    (``freq_score``: tf = spans per doc, idf = the query's Σ idf).

    Args:
      program: the lowered :class:`SpanProgram` (shared by the batch)
      tokens:  [N, L_f] int32 position matrices, by field index (-1 holes)
      extents: [N] int32 each, the rows' extents (``phrase.token_extent``)
      doc_len: [N] int32 the scoring field's lengths
      tids:    [B, n_terms] int32 term ids (-1 = absent: no spans)
      sets:    [B, T_j] int32 each, the term sets' ids (-1 pads)
      sum_idf, avgdl: [B] f32
    Returns (scores [B, N] f32, mask [B, N] bool)."""
    if tokens[0].device.type == "cpu":
        return span_program_score_batch_plain(program, tokens, doc_len, tids,
                                              sets, sum_idf, k1, b, avgdl)
    return _span_program_cuda(program, tokens, extents, doc_len, tids, sets,
                              sum_idf, k1, b, avgdl)


def span_program_score_batch_plain(program: SpanProgram, tokens: list,
                                   doc_len, tids, sets: list, sum_idf, k1, b,
                                   avgdl):
    """K13's plain version: :func:`span_program_freq` and ``freq_score``
    one query at a time."""
    n = doc_len.shape[0]
    n_queries = tids.shape[0]
    dev = doc_len.device
    scores = torch.empty((n_queries, n), dtype=torch.float32, device=dev)
    mask = torch.empty((n_queries, n), dtype=torch.bool, device=dev)
    for q in range(n_queries):
        freq = span_program_freq(program, tokens, tids[q],
                                 [s[q] for s in sets])
        scores[q], mask[q] = freq_score(freq, doc_len, sum_idf[q], k1, b,
                                        avgdl[q])
    return scores, mask


def _span_program_cuda(program, tokens, extents, doc_len, tids, sets,
                       sum_idf, k1, b, avgdl):
    dev = doc_len.device
    n = doc_len.shape[0]
    n_queries = tids.shape[0]
    if len(program.code) > MAX_OPS or len(tokens) > MAX_FIELDS or \
            len(sets) > MAX_SETS:
        raise NotPortedError(
            f"span_program: a program of {len(program.code)} ops over "
            f"{len(tokens)} fields and {len(sets)} term sets is above K13's "
            f"limits ({MAX_OPS}, {MAX_FIELDS}, {MAX_SETS})")
    if len(extents) != len(tokens) or tids.shape != (n_queries,
                                                     program.n_terms) or \
            len(sets) != program.n_sets or sum_idf.shape != (n_queries,) \
            or avgdl.shape != (n_queries,) or doc_len.shape != (n,) or \
            any(t.shape[0] != n or e.shape != (n,)
                for t, e in zip(tokens, extents)) or \
            any(s.dim() != 2 or s.shape[0] != n_queries for s in sets):
        raise ValueError("span_program: shapes disagree")
    for arg, t, dt in (("doc_len", doc_len, torch.int32),
                       ("tids", tids, torch.int32),
                       ("sum_idf", sum_idf, torch.float32),
                       ("avgdl", avgdl, torch.float32)):
        cuda_build.check_dtype("span_program", arg, t, dt)
    for t, e in zip(tokens, extents):
        cuda_build.check_dtype("span_program", "tokens", t, torch.int32)
        cuda_build.check_dtype("span_program", "extent", e, torch.int32)
        cuda_build.check_cuda("span_program", dev, tokens=t, extent=e)
    cuda_build.check_cuda("span_program", dev, doc_len=doc_len, tids=tids,
                          sum_idf=sum_idf, avgdl=avgdl)
    scores = torch.empty((n_queries, n), dtype=torch.float32, device=dev)
    mask = torch.empty((n_queries, n), dtype=torch.bool, device=dev)
    if n == 0 or n_queries == 0:
        return scores, mask
    widths = [int(t.shape[1]) for t in tokens]
    op_w = op_widths(program.code, widths)
    code = (ctypes.c_int * (5 * len(program.code)))(*[
        v for ins, w in zip(program.code, op_w) for v in (*ins, w)])
    fields = (ctypes.c_longlong * (3 * len(tokens)))(*[
        v for t, e, w in zip(tokens, extents, widths)
        for v in (t.data_ptr(), e.data_ptr(), w)])
    # each term set: the sorted union of the batch's ids and a query bit
    # mask per id and 64-query group (ops/lexical.term_set_index)
    keys, bits, offs = [], [], []
    off = 0
    for s in sets:
        cuda_build.check_dtype("span_program", "sets", s, torch.int32)
        k_, b_ = term_set_index(s.contiguous())
        keys.append(k_)
        bits.append(b_)
        offs += [off, k_.shape[0]]
        off += k_.shape[0]
    groups = (n_queries + 63) // 64
    set_keys = torch.cat(keys) if keys else \
        torch.zeros(1, dtype=torch.int32, device=dev)
    set_bits = torch.cat(bits) if bits else \
        torch.zeros((1, groups), dtype=torch.int64, device=dev)
    set_offs = (ctypes.c_int * max(len(offs), 2))(*(offs or [0, 0]))
    k1_, k1p1, omb, b_ = bm25_constants(k1, b)
    p = cuda_build.ptr
    SPAN_PROGRAM.launch(
        dev, ctypes.addressof(code), ctypes.addressof(fields),
        len(program.code), len(tokens), p(doc_len), n, n_queries,
        program.depth, p(tids.contiguous()), program.n_terms,
        p(set_keys), p(set_bits.contiguous()), ctypes.addressof(set_offs),
        len(sets), p(sum_idf), p(avgdl), groups, float(k1_), float(k1p1),
        float(omb), float(b_), p(scores), p(mask))
    return scores, mask
