#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--docs N] [--batches 8] [--batch 64] [--k 1000]

Phases, each printing its own lines; any failure exits nonzero and prints
no result line:

1. card   — nvidia-smi's name and power limit, torch's device name/count;
            no CUDA device → exit 2.
2. build  — nvcc builds every kernel of the path from ``csrc/`` (all at once)
            and reports registers and shared memory per kernel.
3. data   — an MS-MARCO-shaped corpus (log-normal lengths, median 50, Zipf
            1.07 over a 500k vocabulary, up to 224 unique terms a doc; the
            generator of bench.py, seed 1234), installed as 2^20-row
            segments in the port's Engine and packed onto the card.
4. kernels — each kernel against its plain PyTorch version at the shapes the
            main path gives it (K1 bit for bit; K2 ids and scores equal,
            also on tie-heavy scores), timed with CUDA events beside its
            plain version, a library call where one exists, and its bound.
5. main path — launch counters set to 0, then batches of ``match`` requests
            through ShardSearcher.query_phase_batch and a fetch_phase; the
            first batch held against an independent float64 CPU scoring
            (exact hit counts, scores, tie-tolerant recall 1.0); each kernel
            of the path must have launched.
6. profile — one more batch under torch.profiler: device time by kernel,
            the device's busy share of the batch, and the host planning
            time of the batch on its own.

The last lines are one JSON object of per-kernel numbers, the nvidia-smi
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory and f32 outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

K1_SOURCE = "elasticsearch_tpu_torch/csrc/bm25_scan.cu"
K2_SOURCE = "elasticsearch_tpu_torch/csrc/topk.cu"
K1_REPLACES = "elasticsearch_tpu/ops/lexical.py:16"
K2_REPLACES = "elasticsearch_tpu/ops/topk.py:27"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------------------
# corpus: bench.py's generator (make_corpus realistic=True, make_queries),
# without the position matrix, which this path does not read
# --------------------------------------------------------------------------

def make_corpus(rng, n_docs: int, vocab: int, max_unique: int,
                chunk: int = 1_000_000):
    lens = np.clip(rng.lognormal(np.log(50.0), 0.45, n_docs),
                   10, 224).astype(np.int32)
    L = int(lens.max())
    U = max_unique
    uterms = np.full((n_docs, U), -1, np.int32)
    utf = np.zeros((n_docs, U), np.float32)
    df = np.zeros(vocab, np.int64)
    w = np.arange(1, vocab, dtype=np.float64) ** -1.07
    cdf = np.cumsum(w / w.sum())
    for lo in range(0, n_docs, chunk):
        hi = min(lo + chunk, n_docs)
        n = hi - lo
        tk = (np.searchsorted(cdf, rng.random((n, L))) + 1).astype(np.int32)
        tk = np.where(np.arange(L)[None, :] < lens[lo:hi, None], tk, -1)
        order = np.argsort(tk, axis=1, kind="stable")
        st = np.take_along_axis(tk, order, axis=1)
        del tk, order
        new = np.ones_like(st, dtype=bool)
        new[:, 1:] = st[:, 1:] != st[:, :-1]
        new &= st >= 0
        uidx = np.cumsum(new, axis=1) - 1
        rows = np.broadcast_to(np.arange(lo, hi)[:, None], (n, L))
        valid = (st >= 0) & (uidx < U)
        np.add.at(utf, (rows[valid], uidx[valid]), 1.0)
        first = new & valid
        uterms[rows[first], uidx[first]] = st[first]
        np.add.at(df, uterms[lo:hi][uterms[lo:hi] >= 0], 1)
    used = int(np.argmax((uterms >= 0).any(axis=0)[::-1]))
    u_eff = U - used if (uterms >= 0).any() else 1
    return (np.ascontiguousarray(uterms[:, :u_eff]),
            np.ascontiguousarray(utf[:, :u_eff]), lens, df)


def make_queries(rng, n_queries: int, terms: int, df):
    present = np.nonzero(df > 0)[0]
    w = df[present].astype(np.float64)
    w /= w.sum()
    return rng.choice(present, size=(n_queries, terms), p=w).astype(np.int32)


# --------------------------------------------------------------------------
# independent CPU scoring (float64, straight from the BM25 formula)
# --------------------------------------------------------------------------

def cpu_scores(uterms, utf, lens, df, qtids, k1=1.2, b=0.75):
    """float64 BM25 of every doc for each query row of ``qtids``, from
    postings gathered for the queried terms only."""
    n_docs = uterms.shape[0]
    avgdl = float(lens.sum()) / n_docs
    norm = k1 * (1.0 - b + b * lens.astype(np.float64) / avgdl)
    wanted = np.unique(qtids)
    queried = np.zeros(int(uterms.max()) + 2, bool)   # index -1: pads
    queried[wanted] = True
    rows, cols = np.nonzero(queried[uterms])
    t = uterms[rows, cols]
    tf = utf[rows, cols].astype(np.float64)
    order = np.argsort(t, kind="stable")
    t, rows, tf = t[order], rows[order], tf[order]
    starts = np.searchsorted(t, wanted)
    ends = np.searchsorted(t, wanted, side="right")
    post = {int(w): (rows[s:e], tf[s:e])
            for w, s, e in zip(wanted, starts, ends)}
    out = []
    for q in qtids:
        s = np.zeros(n_docs, np.float64)
        for term in q:
            d, f = post[int(term)]
            idf = np.log1p((n_docs - df[term] + 0.5) / (df[term] + 0.5))
            s[d] += idf * f * (k1 + 1.0) / (f + norm[d])
        out.append(s)
    return out


def tie_tolerant_recall(cpu, engine_ids, k, tol=1e-4) -> float:
    """Recall@k of the engine's ids against the CPU top-k; an engine hit
    outside the CPU top-k counts when its CPU score equals the CPU k-th
    score within ``tol`` (equal scores are interchangeable at the cut)."""
    n_match = int((cpu > 0).sum())
    kk = min(k, n_match)
    if kk == 0:
        return 1.0 if len(engine_ids) == 0 else 0.0
    top = np.lexsort((np.arange(len(cpu)), -cpu))[:kk]
    kth = cpu[top[-1]]
    top_set = set(top.tolist())
    hits = sum(1 for d in engine_ids
               if d in top_set or abs(cpu[d] - kth) <= tol)
    return hits / kk


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(t) -> int:
    return t.numel() * t.element_size()


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_card(torch):
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this script runs on an NVIDIA "
              "GPU", file=sys.stderr, flush=True)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"card: {smi_line} | torch: {name}, {count} device(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return smi_line, name, count


def phase_build():
    from elasticsearch_tpu_torch.ops import cuda_build
    sources = [Path(K1_SOURCE).name, Path(K2_SOURCE).name]
    t0 = time.perf_counter()
    built = cuda_build.build_libraries(sources)
    log(f"build: {len(sources)} sources in "
        f"{time.perf_counter() - t0:.2f} s wall (nvcc -gencode "
        f"arch=compute_90a,code={cuda_build.ARCH} -O3 -Xptxas -v)")
    for source, info in built.items():
        log(f"build: {source}: {info['seconds']:.2f} s -> "
            f"{info['path'].name}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "entry function" \
                    in line:
                log(f"build:   {line.strip()}")
    log("build: dynamic shared memory per block: bm25_scan the batch's "
        "term table, a stamp and a value per table slot and an 8-row "
        "output run per warp (42.25 KiB at B = 64, T = 4 without nmatch, "
        "60.25 KiB with); topk stage 1 80 KiB per 16384-entry chunk (a "
        "single-chunk row 4*M B + 32 KiB + 8*next_pow2(min(k, M)) B), "
        "stage 2 the 227 KiB a block may take, its boundary-bin list "
        "getting what the histogram and the sort buffer leave")


def phase_data(args):
    from elasticsearch_tpu_torch.index.device_reader import device_reader_for
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.index.segment import (
        Segment, doc_count_bucket)
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search.phase import ShardSearcher
    import tempfile
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    uterms, utf, lens, df = make_corpus(rng, args.docs, args.vocab, 224)
    n_queries = args.batches * args.batch
    qtids = make_queries(rng, n_queries, args.terms, df)
    log(f"data: {args.docs} docs, U={uterms.shape[1]}, "
        f"avgdl={lens.mean():.3f}, mean unique terms "
        f"{(uterms >= 0).sum(axis=1).mean():.3f}, {n_queries} queries x "
        f"{args.terms} terms, built on the host in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    w = len(str(args.vocab - 1))
    term_names = [f"t{i:0{w}d}" for i in range(args.vocab)]
    ms = MapperService()
    ms.merge("_doc", {"properties": {
        "body": {"type": "text", "analyzer": "whitespace"}}})
    eng = Engine(Path(tempfile.mkdtemp(prefix="chip_smoke_")), ms)
    seg_rows = 1 << 20
    for lo in range(0, args.docs, seg_rows):
        hi = min(lo + seg_rows, args.docs)
        rows = hi - lo
        np_rows = doc_count_bucket(rows)

        def padrows(a, fill):
            out = np.full((np_rows,) + a.shape[1:], fill, a.dtype)
            out[:rows] = a[lo:hi]
            return out
        seg_df = np.zeros(args.vocab, np.int64)
        seg_ut = uterms[lo:hi]
        np.add.at(seg_df, seg_ut[seg_ut >= 0], 1)
        eng.install_segment(Segment.from_packed_text(
            0, "body", terms=term_names, tokens=None,
            uterms=padrows(uterms, -1), utf=padrows(utf, 0.0),
            doc_len=padrows(lens, 0), df=seg_df, num_docs=rows,
            ids=[str(lo + i) for i in range(rows)] +
            [""] * (np_rows - rows)), track_versions=False)
    reader = device_reader_for(eng)
    searcher = ShardSearcher(0, reader, ms)
    log(f"data: {len(reader.segments)} segment(s) installed and packed on "
        f"{reader.device} in {time.perf_counter() - t0:.1f} s; reader "
        f"device bytes {reader.device_bytes()}")
    texts = [" ".join(term_names[t] for t in row) for row in qtids]
    return {"uterms": uterms, "utf": utf, "lens": lens, "df": df,
            "qtids": qtids, "texts": texts, "engine": eng,
            "reader": reader, "searcher": searcher}


def smi_sample() -> str:
    """The card's SM clock (now / max), power draw and temperature."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip() \
        if out.returncode == 0 and out.stdout.strip() else "not read"


def timed(torch, name: str, fn, reps: int, warmup: int = 1) -> float:
    """time_ms with nvidia-smi sampled just before and after the loop."""
    before = smi_sample()
    ms = time_ms(torch, fn, reps, warmup)
    log(f"timing {name}: {ms:.4f} ms | nvidia-smi clocks.sm, clocks.max.sm, "
        f"power.draw, temperature before [{before}] after [{smi_sample()}]")
    return ms


def k1_work(torch, uterms, doc_len, tids, avgdl, hits: int):
    """K1's least work for this run's data, outputs aside: each row read up
    to its first pad, utf only where a queried term sits, doc_len and the
    query constants once → (bytes read, flops: 4 per (query, doc) for the
    length norm and 5 per hit)."""
    n, u = uterms.shape
    cells_read = int(torch.clamp((uterms >= 0).sum(dim=1) + 1, max=u).sum())
    utf_read = int(torch.isin(uterms, tids.unique()).sum())
    read = (cells_read * 4 + utf_read * 4 + nbytes(doc_len)
            + 3 * nbytes(tids) + nbytes(avgdl))
    return read, 4 * tids.shape[0] * n + 5 * hits


def check_k1(torch, lexical, args, trailing_pad, what):
    """K1 against its plain version, with and without nmatch."""
    got_s, got_n = lexical.bm25_match_batch(*args, trailing_pad=trailing_pad)
    want_s, want_n = lexical.bm25_match_batch_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got_n, want_n), f"K1 nmatch differs from its plain "
          f"version ({what})")
    check(torch.equal(got_s.view(torch.int32), want_s.view(torch.int32)),
          f"K1 scores are not bit-identical to its plain version ({what})")
    only_s, only_n = lexical.bm25_match_batch(
        *args, trailing_pad=trailing_pad, want_nmatch=False)
    torch.cuda.synchronize()
    check(only_n is None and torch.equal(only_s.view(torch.int32),
                                         want_s.view(torch.int32)),
          f"K1 without nmatch is not bit-identical to its plain version "
          f"({what})")
    return got_s, got_n, float((got_s - want_s).nan_to_num(0.0).abs().max())


def check_k2(torch, topk, scores, k, what, mask=None, ids=None):
    res = topk.select_top_k(scores, k, mask=mask, ids=ids)
    ref = topk.select_top_k_plain(scores, k, mask=mask, ids=ids)
    torch.cuda.synchronize()
    check(all(torch.equal(a, c) for a, c in zip(res, ref)),
          f"K2 differs from its plain version on {what}")
    return res, float((res[0] - ref[0]).nan_to_num(0.0).abs().max())


def phase_kernels(torch, args, data) -> list[dict]:
    from elasticsearch_tpu_torch.ops import lexical, topk
    from elasticsearch_tpu_torch.search import query_dsl
    from elasticsearch_tpu_torch.search.segment_exec import (
        _plan_segment_batch)
    searcher, reader = data["searcher"], data["reader"]
    seg = reader.segments[0]
    col = seg.text["body"]
    k = args.k
    queries = [query_dsl.parse_query({"match": {"body": t}})
               for t in data["texts"][:args.batch]]
    # the main path's K1 inputs for one segment and one batch
    plan = _plan_segment_batch(seg, searcher.ctx, queries, k)
    tids, idfs, avgdl, _boost = plan["consts"]
    ones = torch.ones(tids.shape, dtype=torch.float32, device=tids.device)
    p = searcher.ctx.bm25
    k1_args = (col.uterms, col.utf, col.doc_len, tids, idfs, ones, p.k1,
               p.b, avgdl)
    n, u = col.uterms.shape
    bsz, t = tids.shape

    # ---- K1 at the main path's shape, with and without nmatch ----------
    got_s, got_n, k1_err = check_k1(torch, lexical, k1_args,
                                    col.trailing_pad, "main path's shape")
    k1_ms = timed(torch, "K1 without nmatch", lambda: lexical.bm25_match_batch(
        *k1_args, trailing_pad=col.trailing_pad, want_nmatch=False), reps=20)
    k1_n_ms = timed(torch, "K1 with nmatch", lambda: lexical.bm25_match_batch(
        *k1_args, trailing_pad=col.trailing_pad), reps=20)
    k1_plain_ms = timed(
        torch, "K1 plain", lambda: lexical.bm25_match_batch_plain(
            *k1_args, want_nmatch=False), reps=2, warmup=0)
    k1_read, k1_flops = k1_work(torch, col.uterms, col.doc_len, tids,
                                avgdl, int(got_n.sum()))
    # the main path writes [B, N] scores; with nmatch [B, N] counts as well
    k1_bytes = k1_read + nbytes(got_s)
    k1n_bytes = k1_bytes + nbytes(got_n)
    k1_b, k1_by = bound(k1_bytes, k1_flops)
    k1n_b, _ = bound(k1n_bytes, k1_flops)
    log(f"K1 bm25_scan [B={bsz}, N={n}, U={u}, T={t}]: bit-identical to "
        f"plain with and without nmatch; kernel_ms={k1_ms:.4f} (with nmatch "
        f"{k1_n_ms:.4f}) plain_ms={k1_plain_ms:.4f} bound_ms={k1_b:.4f} "
        f"({k1_by}: {k1_bytes} B, {k1_flops} flop; with nmatch "
        f"{k1n_b:.4f}, {k1n_bytes} B) library_ms=null")

    # ---- K1 at an odd shape: B = 65, T = 40, N off the tile --------------
    rng = np.random.default_rng(args.seed + 1)
    n_odd = min(n, 100_003)
    o_tids = torch.from_numpy(make_queries(rng, 65, 40, data["df"])).to(
        tids.device)
    o_tids[0, -1] = o_tids[0, 0]
    o_tids[1, 3] = -1
    o_idf = torch.from_numpy(rng.uniform(0.1, 9.0, (65, 40)).astype(
        np.float32)).to(tids.device)
    o_args = (col.uterms[:n_odd], col.utf[:n_odd], col.doc_len[:n_odd],
              o_tids, o_idf, torch.ones_like(o_idf), p.k1, p.b,
              avgdl[:1].expand(65).contiguous())
    check_k1(torch, lexical, o_args, col.trailing_pad,
             f"odd shape B=65, N={n_odd}, T=40")
    log(f"K1 bm25_scan [B=65, N={n_odd}, U={u}, T=40]: bit-identical to "
        f"plain with and without nmatch")

    # ---- K2, one segment's top-k -----------------------------------------
    mask = (got_s > 0) & seg.live[None, :]
    res, err_a = check_k2(torch, topk, got_s, k, "the segment top-k",
                          mask=mask)
    ties = torch.round(got_s * 2) / 2
    res_t, err_b = check_k2(torch, topk, ties, k, "tie-heavy scores",
                            mask=mask)
    n_tied = int(mask.sum()) - int(torch.unique(ties[mask]).numel())
    # odd shape: rows off the chunk size, one tied run across a chunk
    # boundary, a wholly masked chunk
    c = topk.CHUNK
    m_odd = 3 * c + 5
    odd = got_s[:3, :m_odd].clone()
    odd[:, c - 700:c + 1500] = odd.max()
    odd_mask = mask[:3, :m_odd].clone()
    odd_mask[:, 2 * c:3 * c] = False
    _, err_c = check_k2(torch, topk, odd, k, "a tied run across a chunk "
                        "boundary", mask=odd_mask)
    k2_err = max(err_a, err_b, err_c)
    masked = torch.where(mask, got_s, float("-inf"))
    k2_ms = timed(torch, "K2 segment", lambda: topk.select_top_k(
        got_s, k, mask=mask), reps=20)
    k2_plain_ms = timed(
        torch, "K2 segment plain", lambda: topk.select_top_k_plain(
            got_s, k, mask=mask), reps=3)
    k2_lib_ms = timed(torch, "K2 segment torch.topk", lambda: torch.topk(
        masked, k, dim=1), reps=20)
    k2_bytes = nbytes(got_s) + nbytes(mask) + nbytes(res[0]) + \
        nbytes(res[1]) + nbytes(res[2])
    k2_bound, k2_by = bound(k2_bytes, got_s.numel())
    log(f"K2 stable_topk segment [R={bsz}, M={n}, k={k}]: equal to plain "
        f"(also on tie-heavy scores, {n_tied} tied entries, and on [3, "
        f"{m_odd}] with a tied run across a chunk boundary); "
        f"kernel_ms={k2_ms:.4f} plain_ms={k2_plain_ms:.4f} "
        f"library_ms={k2_lib_ms:.4f} (torch.topk, tie order undefined) "
        f"bound_ms={k2_bound:.4f} ({k2_by}: {k2_bytes} B)")

    # ---- K2, the cross-segment merge over 2 x k candidates ---------------
    seg2 = reader.segments[1] if len(reader.segments) > 1 else seg
    cand_s, cand_d = [res[0]], [res[1]]
    if seg2 is not seg:
        plan2 = _plan_segment_batch(seg2, searcher.ctx, queries, k)
        c2 = seg2.text["body"]
        s2, _ = lexical.bm25_match_batch(
            c2.uterms, c2.utf, c2.doc_len, plan2["consts"][0],
            plan2["consts"][1], ones, p.k1, p.b, plan2["consts"][2],
            trailing_pad=c2.trailing_pad, want_nmatch=False)
        r2 = topk.select_top_k(s2, k, mask=(s2 > 0) & seg2.live[None, :])
        cand_s.append(r2[0])
        cand_d.append(torch.where(r2[1] >= 0, r2[1] + seg2.doc_base, -1))
    else:
        cand_s.append(res_t[0])
        cand_d.append(res_t[1])
    m_scores = torch.cat(cand_s, dim=1).contiguous()
    m_ids = torch.cat(cand_d, dim=1).to(torch.int32).contiguous()
    mres, m_err = check_k2(torch, topk, m_scores, k, "the merge", ids=m_ids)
    m_masked = torch.where(m_ids >= 0, m_scores, float("-inf"))
    merge = {
        "shape": list(m_scores.shape),
        "ms": timed(torch, "K2 merge", lambda: topk.select_top_k(
            m_scores, k, ids=m_ids), reps=50),
        "plain_ms": timed(
            torch, "K2 merge plain", lambda: topk.select_top_k_plain(
                m_scores, k, ids=m_ids), reps=20),
        "library_ms": timed(torch, "K2 merge torch.topk", lambda: torch.topk(
            m_masked, k, dim=1), reps=50),
        "max_abs_err": m_err,
    }
    m_bytes = nbytes(m_scores) + nbytes(m_ids) + nbytes(mres[0]) + \
        nbytes(mres[1]) + nbytes(mres[2])
    merge["bound_ms"], merge["bound_by"] = bound(m_bytes, m_scores.numel())
    log(f"K2 stable_topk merge [R={bsz}, M={m_scores.shape[1]}, k={k}]: "
        f"equal to plain; kernel_ms={merge['ms']:.4f} "
        f"plain_ms={merge['plain_ms']:.4f} "
        f"library_ms={merge['library_ms']:.4f} "
        f"bound_ms={merge['bound_ms']:.4f}")
    return [
        {"name": "bm25_scan", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": 0, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_b,
         "bound_by": k1_by, "library_ms": None,
         "shape": {"B": bsz, "N": n, "U": u, "T": t, "nmatch": False},
         "with_nmatch": {"ms": k1_n_ms, "bound_ms": k1n_b}},
        {"name": "stable_topk", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": 0, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms,
         "shape": {"R": bsz, "M": n, "k": k}, "merge": merge},
    ]


def phase_main_path(torch, args, data, kernels, name, smi_line):
    from elasticsearch_tpu_torch.ops import lexical, topk
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    searcher, reader = data["searcher"], data["reader"]
    reqs = [parse_search_request({"query": {"match": {"body": t}},
                                  "size": args.k}) for t in data["texts"]]
    batches = [reqs[i * args.batch:(i + 1) * args.batch]
               for i in range(args.batches)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lexical.BM25_SCAN.launches = 0
    topk.TOPK.launches = 0
    results, per_batch = [], []
    t_all = time.perf_counter()
    for batch in batches:
        t0 = time.perf_counter()
        out = searcher.query_phase_batch(batch)
        per_batch.append((time.perf_counter() - t0) * 1e3)
        check(out is not None, "query_phase_batch declined the batch")
        results.append(out)
    wall = time.perf_counter() - t_all
    launches = {"bm25_scan": lexical.BM25_SCAN.launches,
                "stable_topk": topk.TOPK.launches}
    peak = torch.cuda.max_memory_allocated()
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    log(f"main path: launches {launches} over {args.batches} batches of "
        f"{args.batch} on {len(reader.segments)} segment(s)")
    for kern in kernels:
        check(kern["launches"] > 0,
              f"kernel {kern['name']} was not launched on the main path")
    qps = args.batches * args.batch / wall
    log(f"main path: {qps:.2f} queries/s, p50 "
        f"{statistics.median(per_batch):.3f} ms per batch of {args.batch} "
        f"(batches: {', '.join(f'{x:.3f}' for x in per_batch)} ms), peak "
        f"device memory {peak} B, reader device bytes "
        f"{reader.device_bytes()} B — on {name} ({smi_line})")

    # fetch the top 10 hits of one request
    r0 = results[0][0]
    hits = searcher.fetch_phase(batches[0][0], r0, "msmarco",
                                list(range(min(10, len(r0.doc_ids)))))
    gid_to_orig = np.full(reader.max_doc, -1, np.int64)
    for dseg in reader.segments:
        nr = dseg.seg.num_docs
        first = int(dseg.seg.ids[0])
        gid_to_orig[dseg.doc_base:dseg.doc_base + nr] = np.arange(
            first, first + nr)
    for pos, hit in enumerate(hits):
        check(hit["_id"] == str(gid_to_orig[r0.doc_ids[pos]]),
              f"fetch_phase hit {pos} has _id {hit['_id']}")
        check(hit["_score"] == float(r0.scores[pos]),
              f"fetch_phase hit {pos} score differs from the query phase")
    log(f"fetch_phase: top {len(hits)} hits of request 0: "
        f"{[(h['_id'], round(h['_score'], 4)) for h in hits[:3]]} ...")

    # first batch against the independent float64 CPU scoring
    t0 = time.perf_counter()
    cpu = cpu_scores(data["uterms"], data["utf"], data["lens"], data["df"],
                     data["qtids"][:args.batch])
    recalls = []
    for qi, (res, s64) in enumerate(zip(results[0], cpu)):
        n_match = int((s64 > 0).sum())
        check(res.total == n_match,
              f"query {qi}: total {res.total} != CPU matches {n_match}")
        orig = gid_to_orig[np.asarray(res.doc_ids, np.int64)]
        check(len(orig) == min(args.k, n_match) and (orig >= 0).all(),
              f"query {qi}: {len(orig)} hits for {n_match} matches")
        check(np.allclose(res.scores, s64[orig], rtol=1e-5, atol=1e-5),
              f"query {qi}: scores disagree with the CPU scoring")
        recalls.append(tie_tolerant_recall(s64, orig, args.k))
    recall = float(np.mean(recalls))
    log(f"main path: first batch vs independent float64 CPU scoring "
        f"({time.perf_counter() - t0:.1f} s): totals exact, scores within "
        f"1e-5, tie-tolerant recall@{args.k} = {recall}")
    check(recall == 1.0, f"recall {recall} != 1.0")


def phase_profile(torch, args, data) -> None:
    from torch.profiler import ProfilerActivity, profile
    from elasticsearch_tpu_torch.search import query_dsl, segment_exec
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    searcher, reader = data["searcher"], data["reader"]
    texts = data["texts"][:args.batch]
    batch = [parse_search_request({"query": {"match": {"body": t}},
                                   "size": args.k}) for t in texts]
    # host-only planning of the batch (resolve every query on every
    # segment), no device work
    queries = [query_dsl.parse_query({"match": {"body": t}}) for t in texts]
    flags = {"min_score": False, "search_after": False}
    t0 = time.perf_counter()
    for seg in reader.segments:
        for query in queries:
            segment_exec._plan(seg, searcher.ctx, query, None, flags)
    plan_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        check(searcher.query_phase_batch(batch) is not None,
              "query_phase_batch declined the profiled batch")
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side rows only: an aten op's row repeats its kernels' time
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        log(f"profile: torch.profiler reported no device time (batch wall "
            f"{wall_ms:.3f} ms, host planning alone {plan_ms:.3f} ms); the "
            f"busy share is not measured")
        return
    log(f"profile: one batch of {args.batch}: wall {wall_ms:.3f} ms, device "
        f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), host "
        f"planning alone {plan_ms:.3f} ms")
    for dev_ms, count, key in rows[:8]:
        log(f"profile:   {dev_ms:9.3f} ms  x{count:<4d} {key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1 << 21,
                    help="corpus size; MS-MARCO has 8,841,823 passages")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--terms", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=500_000)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)

    import torch
    try:
        smi_line, name, count = phase_card(torch)
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        phase_build()
        data = phase_data(args)
        kernels = phase_kernels(torch, args, data)
        phase_main_path(torch, args, data, kernels, name, smi_line)
        phase_profile(torch, args, data)
    except Exception as e:                  # noqa: BLE001 — report, then fail
        traceback.print_exc()
        print(f"[chip_smoke] FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
