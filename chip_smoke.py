#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--docs N] [--batches 8] [--batch 64] [--k 1000]

Phases, each printing its own lines; any failure exits nonzero and prints
no result line:

1. card   — nvidia-smi's name and power limit, torch's device name/count;
            no CUDA device → exit 2.
2. build  — nvcc builds every kernel of the paths from ``csrc/`` (all at
            once) and reports registers and shared memory per kernel.
3. data   — an MS-MARCO-shaped corpus (log-normal lengths, median 50, Zipf
            1.07 over a 500k vocabulary, up to 224 unique terms a doc, its
            position matrix; the generator of bench.py, seed 1234) with a
            ``double`` column ``rank`` uniform in [0, 100), installed as
            2^20-row segments in the port's Engine and packed onto the card
            (the position matrix stays on the host until a phrase needs it).
4. kernels — K1 and K2 against their plain PyTorch versions at the shapes
            the main path gives them (K1 bit for bit; K2 ids and scores
            equal, also on tie-heavy scores), timed with CUDA events beside
            the plain version, a library call where one exists, and the
            bound.
5. config 1 — BASELINE config 1, the main path: launch counters set to 0,
            batches of ``match`` requests through
            ShardSearcher.query_phase_batch and a fetch_phase; the first
            batch held against an independent float64 CPU scoring (exact
            hit counts, scores, tie-tolerant recall 1.0); K1 and K2 must
            have launched, and no position matrix was uploaded.
6. phrase kernel — the first phrase plan puts the position matrices on the
            card; K3 against its plain version bit for bit at the shape
            config 2 gives it and at odd shapes, timed like K1 and K2.
7. config 2 — bool (must: match) + should: match_phrase of a real adjacent
            pair, batches through query_phase_batch; K1, K2 and K3 must have
            launched; the first queries against a float64 CPU scoring with
            a numpy phrase count.
8. config 3 — function_score field_value_factor (log1p) over the match, and
            one batch adding a gauss decay under score_mode multiply;
            checked the same way.
9. profile — one batch of each config under torch.profiler (after one
            unrecorded warm-up run of it): device time by kernel, the
            device's busy share of the batch, the host planning time of the
            batch on its own; and the element-wise bool and function_score
            ops timed alone at the batch's shape.
10. int8 kernel — K4 against its plain version on the int8 column of a
            segment (the config-4 corpus, 768-d) and at an odd shape, timed
            beside the plain version, torch.matmul on a float copy of the
            column, and the bound.
11. config 4 — BASELINE config 4: top-level knn over the 768-d unit
            vectors (f32: torch.matmul + K2), then the same reader through a
            searcher of an index set to ``index.knn.quantization: int8``
            (K4 + K2); the first queries against float64 cosines (int8:
            float64 dots with the dequantized rows, and each hit within the
            quantization bound of its cosine).
12. hybrid — the rag request shape: the 4-term match plus the knn section
            fused by RRF (and one untimed batch of the weighted sum), held
            against a numpy fusion of float64 legs.
13. MaxSim — a rank_vectors index (262,144 docs in two segments, 128-d,
            32 tokens a doc at most, 32-token queries): K5 against its plain
            version (f32 and int8 tokens, the main and odd shapes), then
            batches through query_phase_batch in f32 and int8, against a
            float64 MaxSim.
14. profile — one batch of config 4 (f32, int8), hybrid and MaxSim under
            torch.profiler: cuBLAS, K2, K4, K5, other element-wise ops.
15. impact kernels — an index over config 1's reader set to
            ``index.search.impact_plane`` (16-bit impacts, 8192-row blocks,
            bench.py's impact_pruning settings); its host quantization and
            upload timed as set-up; K6 against its plain version bit for bit
            at the eager shape and at odd shapes (8 and 16 bits, a term
            quantized to 0, a cursor, dead rows), K7 against its plain
            version (top-k and block counters) at the pruned shape with a
            carry across the segments and at odd ones (k = 1, k above the
            matches, every block skipped), each timed beside its plain
            version and its bound.
16. impact eager — config 1's requests on the impact index (K6 + K2):
            the first queries bit-equal to a numpy recompute from the host
            impacts, totals equal to the float64 match counts, every hit
            within the quantization bound of its BM25 score.
17. impact pruned — bench.py's impact_pruning requests (3 rare terms, k =
            10, track_total_hits false, batches of 32): the block-max sweep
            (K7) bit-identical to the eager arm, its block counters
            reconciled batch by batch, the skip ratio beside bench.py's
            predicted occupied fraction.
18. impact rescore — bench.py's planner_fusion request shape (a 2-term
            match rescored by a 2-term match, window 24): the impact ->
            rescore arm bit-equal to a numpy recompute.
19. profile — one eager and one pruned impact batch under torch.profiler,
            with the lane's host planning alone.
20. K2 past one block's k — after the MaxSim index and the impact columns
            are released: K2 at k = 20,000 and 65,536 over 2^20-entry rows
            against its plain version (tie-heavy scores, explicit ids), timed
            at k = 20,000.
21. config 5 set-up — BASELINE config 5's corpus (bench.py:1116-1210): the
            corpus cut into 8 single-segment shards of 2^18 docs, one Engine
            and ShardSearcher each, with ``rank`` and bench.py's 16-value
            ``cat`` keyword column; the checked requests scored in float64
            on every shard with its own df and avgdl.
22. agg kernels — K8 (ordinal, histogram and ranges modes) and K9 against
            their plain versions on shard 0 under a request's mask (cat, the
            rank histogram at interval 5, bench-style ranges) and at odd
            shapes (N = 100,003, a 50,000-ord vocabulary, epoch-millis dates
            at 1h with docs on the edges, a ``to: 0`` range, an empty mask),
            timed beside the plain versions, their bounds and torch.bincount.
23. config 5 — pages at from 500, size 500 of the 4-term match, the shards
            run concurrently (query_phase_batch), then per request
            controller.merge_responses; held against the float64 per-shard
            scoring merged in the coordinator's order.
24. config 5 + aggs — size 10 with a terms agg over cat, extended_stats,
            histogram, range and value_count over rank, through query_phase
            on each shard and merge_responses' reduce; K8 and K9 launched,
            no host collector, no host mask; held against numpy. Then one
            page at from 20,000 (every shard's K2 at k = 20,100), untimed.
25. profile — one config-5 batch and one agg batch under torch.profiler,
            with the host planning and the coordinator's merge.
26. percolate kernels — K10 against its plain version on ragged lanes (up
            to B = 10,000 x Np = 128; NaN, -0.0, empty and dead rows) and
            K1 and K3 at a percolate lane's shape (B = 4,096 x N = 128)
            against theirs, each timed beside its bound (K10 beside
            torch.amax).
27. percolate — bench.py's registry (bench.py:1498-1531: seed 77, 200
            words, reg_body's thirds, 12 probe docs of 6 words) at 1,000
            and 10,000 registrations: a percolate per probe, then one
            percolate_many of the 12; every registration's flag and score
            on the first probes against a float64 recompute over the
            one-doc index, probe 0 against percolate_serial; each call's
            ms split into host resolve, the lanes and their card span, with
            its launches and device→host reads.
28. percolate, full features — a second registry of 10,000 (a quarter
            sloppy match_phrase, a quarter bool, a group field) through one
            percolate_many with score, sort, size, highlight, a terms agg
            over group and a reg_filter, against the float64 recompute and
            percolate_serial.
29. sloppy phrase — K11 against its plain version on config 2's position
            matrix at slop 1, 2 and 3 and at odd shapes, timed beside K3;
            config 2's bool + match_phrase with slop 2 through
            query_phase_batch against a float64 recompute; the highlighter
            over the fetched hits of one batch.
30. K7 past 1,024 (runs after phase 19, on the impact index) — the pruned
            arm at k = 1,025, 10,000 and 20,000 bit-identical to the eager
            arm; K7 against its plain version and timed at k = 10,000.
31. profile — one percolate_many under torch.profiler: host planning
            against card time.

The last lines are one JSON object of per-kernel numbers, the nvidia-smi
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory and f32 outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# queries of configs 2 and 3 held against the float64 CPU scoring
CHECK_QUERIES = 8

K1_SOURCE = "elasticsearch_tpu_torch/csrc/bm25_scan.cu"
K2_SOURCE = "elasticsearch_tpu_torch/csrc/topk.cu"
K3_SOURCE = "elasticsearch_tpu_torch/csrc/phrase_scan.cu"
K4_SOURCE = "elasticsearch_tpu_torch/csrc/int8_cosine.cu"
K5_SOURCE = "elasticsearch_tpu_torch/csrc/maxsim.cu"
K6_SOURCE = "elasticsearch_tpu_torch/csrc/impact_scan.cu"
K7_SOURCE = "elasticsearch_tpu_torch/csrc/blockmax_sweep.cu"
K8_SOURCE = "elasticsearch_tpu_torch/csrc/agg_counts.cu"
K9_SOURCE = "elasticsearch_tpu_torch/csrc/agg_stats.cu"
K10_SOURCE = "elasticsearch_tpu_torch/csrc/percolate_reduce.cu"
K11_SOURCE = "elasticsearch_tpu_torch/csrc/sloppy_phrase.cu"
K1_REPLACES = "elasticsearch_tpu/ops/lexical.py:16"
K2_REPLACES = "elasticsearch_tpu/ops/topk.py:27"
K3_REPLACES = "elasticsearch_tpu/ops/phrase.py:59"
K4_REPLACES = "elasticsearch_tpu/ops/vector.py:52"
K5_REPLACES = "elasticsearch_tpu/ops/maxsim.py:67"
K5_INT8_REPLACES = "elasticsearch_tpu/ops/maxsim.py:136"
K6_REPLACES = "elasticsearch_tpu/ops/blockmax.py:54"
K7_REPLACES = "elasticsearch_tpu/ops/blockmax.py:152"
K8_REPLACES = "elasticsearch_tpu/ops/aggs_ops.py:18"
K9_REPLACES = "elasticsearch_tpu/ops/aggs_ops.py:79"
K10_REPLACES = "elasticsearch_tpu/ops/percolate.py:19"
K11_REPLACES = "elasticsearch_tpu/ops/phrase.py:72"
# config 4 (bench.py:703-717): 768-d unit vectors, k = num_candidates = 100
VEC_DIMS = 768
KNN_K = 100
# the rank_vectors index: ColBERT-shaped (128-d tokens, the mapping's
# default max_tokens 32), two 2^17-row segments so the merge runs
MAXSIM_DIMS = 128
MAXSIM_TOKENS = 32
MAXSIM_CHECK_QUERIES = 4
# config 5 (bench.py:1116-1210, 1286-1291): 8 shards, a page at from 500 of
# size 500 (every shard's top-1000), 4 batches; with aggs 2 batches of
# size-10 requests; the requests held against float64; the deep page
C5_SHARDS = 8
C5_CATS = [f"cat{i:02d}" for i in range(16)]
C5_FROM, C5_SIZE, C5_BATCHES, C5_AGG_BATCHES, C5_CHECK = 500, 500, 4, 2, 8
C5_AGGS = {"by_cat": {"terms": {"field": "cat", "size": 8}},
           "st": {"extended_stats": {"field": "rank"}},
           "hi": {"histogram": {"field": "rank", "interval": 5}},
           "rg": {"range": {"field": "rank", "ranges": [
               {"to": 25}, {"from": 25, "to": 75}, {"from": 75}]}},
           "vc": {"value_count": {"field": "cat"}}}
DEEP_FROM, DEEP_SIZE = 20_000, 100
# index names whose knn-lane settings the smoke registers
INT8_INDEX = "smoke_knn_int8"
WEIGHTED_INDEX = "smoke_knn_weighted"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class GcPauses:
    """Wall time of the interpreter's full (generation 2) garbage
    collections: with millions of host objects (segment ids and sources)
    one pass takes a visible share of a batch, in whatever phase allocates
    when it comes due."""

    def __init__(self):
        self.count, self.ms, self._t0 = 0, 0.0, None
        gc.callbacks.append(self._callback)

    def _callback(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.count += 1
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self._t0 = None

    def take(self) -> str:
        """The passes since the last call, as text, and start counting
        anew."""
        out = f"{self.count} full GC pass(es), {self.ms:.1f} ms"
        self.count, self.ms = 0, 0.0
        return out


GC = GcPauses()


# --------------------------------------------------------------------------
# corpus: bench.py's generator (make_corpus realistic=True, make_queries)
# --------------------------------------------------------------------------

def make_corpus(rng, n_docs: int, vocab: int, max_unique: int,
                chunk: int = 1_000_000):
    lens = np.clip(rng.lognormal(np.log(50.0), 0.45, n_docs),
                   10, 224).astype(np.int32)
    L = int(lens.max())
    U = max_unique
    tokens = np.empty((n_docs, L), np.int32)
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
        tokens[lo:hi] = tk
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
            np.ascontiguousarray(utf[:, :u_eff]), lens, df, tokens)


def make_queries(rng, n_queries: int, terms: int, df):
    present = np.nonzero(df > 0)[0]
    w = df[present].astype(np.float64)
    w /= w.sum()
    return rng.choice(present, size=(n_queries, terms), p=w).astype(np.int32)


# --------------------------------------------------------------------------
# independent CPU scoring (float64, straight from the BM25 formula)
# --------------------------------------------------------------------------

def postings(uterms, utf, wanted):
    """{term: (rows, tf)} for each term of ``wanted``, gathered in one pass
    over the forward columns."""
    wanted = np.unique(wanted)
    queried = np.zeros(int(uterms.max()) + 2, bool)   # index -1: pads
    queried[wanted] = True
    rows, cols = np.nonzero(queried[uterms])
    t = uterms[rows, cols]
    tf = utf[rows, cols].astype(np.float64)
    order = np.argsort(t, kind="stable")
    t, rows, tf = t[order], rows[order], tf[order]
    starts = np.searchsorted(t, wanted)
    ends = np.searchsorted(t, wanted, side="right")
    return {int(w): (rows[s:e], tf[s:e])
            for w, s, e in zip(wanted, starts, ends)}


def cpu_idf(df, term, n_docs):
    return np.log1p((n_docs - df[term] + 0.5) / (df[term] + 0.5))


def cpu_scores(uterms, utf, lens, df, qtids, k1=1.2, b=0.75):
    """float64 BM25 of every doc for each query row of ``qtids``, from
    postings gathered for the queried terms only."""
    n_docs = uterms.shape[0]
    avgdl = float(lens.sum()) / n_docs
    norm = k1 * (1.0 - b + b * lens.astype(np.float64) / avgdl)
    post = postings(uterms, utf, qtids)
    out = []
    for q in qtids:
        s = np.zeros(n_docs, np.float64)
        for term in q:
            d, f = post[int(term)]
            s[d] += cpu_idf(df, term, n_docs) * f * (k1 + 1.0) / (f + norm[d])
        out.append(s)
    return out


def pair_freq(t, a, b_, slop=0):
    """float64 frequency of the two-term phrase (a, b_) in each position row
    of ``t``: each start position p holding a whose b_ sits at p + 1 + s for
    a smallest s <= slop adds 1 / (1 + s) (overlapping occurrences each
    count; slop 0 counts exact adjacencies)."""
    n, length = t.shape
    best = np.full((n, length), slop + 1, np.int16)     # slop + 1: no match
    for s in range(slop, -1, -1):
        if 1 + s < length:
            hit = (t[:, :length - 1 - s] == a) & (t[:, 1 + s:] == b_)
            best[:, :length - 1 - s][hit] = s
    weight = np.append(1.0 / (1.0 + np.arange(slop + 1)), 0.0)
    return weight[best].sum(axis=1)


def cpu_phrase_scores(tokens, uterms, utf, lens, df, pairs, k1=1.2, b=0.75,
                      slop=0):
    """float64 BM25 of the two-term phrase (a, b) with ``slop`` for each
    pair: the phrase frequency counted with numpy (:func:`pair_freq`) on the
    position rows of the docs that hold both terms, tf = that frequency,
    idf = idf(a) + idf(b)."""
    n_docs = tokens.shape[0]
    avgdl = float(lens.sum()) / n_docs
    post = postings(uterms, utf, np.asarray(pairs).reshape(-1))
    out = []
    for a, b_ in pairs:
        rows = np.intersect1d(post[int(a)][0], post[int(b_)][0])
        t = tokens[rows]
        freq = pair_freq(t, a, b_, slop)
        norm = k1 * (1.0 - b + b * lens[rows].astype(np.float64) / avgdl)
        s = np.zeros(n_docs, np.float64)
        s[rows] = np.where(freq > 0, (cpu_idf(df, a, n_docs) +
                                      cpu_idf(df, b_, n_docs)) * freq *
                           (k1 + 1.0) / (freq + norm), 0.0)
        out.append(s)
    return out


def tie_tolerant_recall(cpu, engine_ids, k, tol=1e-4, matched=None) -> float:
    """Recall@k of the engine's ids against the CPU top-k of the matching
    docs (``matched``, default: score > 0); an engine hit outside the CPU
    top-k counts when its CPU score equals the CPU k-th score within
    ``tol`` (equal scores are interchangeable at the cut)."""
    if matched is None:
        matched = cpu > 0
    n_match = int(matched.sum())
    kk = min(k, n_match)
    if kk == 0:
        return 1.0 if len(engine_ids) == 0 else 0.0
    ranked = np.where(matched, cpu, -np.inf)
    top = np.lexsort((np.arange(len(cpu)), -ranked))[:kk]
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
    sources = [Path(src).name for src in (K1_SOURCE, K2_SOURCE, K3_SOURCE,
                                          K4_SOURCE, K5_SOURCE, K6_SOURCE,
                                          K7_SOURCE, K8_SOURCE, K9_SOURCE,
                                          K10_SOURCE, K11_SOURCE)]
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
        "getting what the histogram and the sort buffer leave; phrase_scan "
        "the first-term table and the batch's terms, and per warp the first "
        "96 positions of each row of its 8-row run and a count per (query, "
        "row) (44.375 KiB at B = 64, T = 2); int8_cosine 24 KiB static (a "
        "32-deep step of 64 queries and 128 docs as floats); maxsim "
        "83.5 KiB (a 16-deep step of 128 query-token rows and 128 "
        "doc-token columns, the 128 x 132 tile of dots, running max, sums "
        "and token counts); impact_scan the batch's term table, per query "
        "its scale x boost and cursor, and per warp a stamp and an impact "
        "per table slot and an 8-row output run (about 47 KiB at B = 64, "
        "T = 4); blockmax_sweep 25 KiB static (a 2048-key candidate list, "
        "1024 entries of the visiting order and bounds, the query's terms; "
        "its candidate lists read across the cluster) and 16 B x k dynamic "
        "(the running top-k and its merge buffer) up to k = 12,288, a "
        "global scratch slice a thread block past it; agg_counts a 4-byte "
        "count a bucket (up to 12,288 buckets, else global atomics); "
        "agg_stats 288 B static; percolate_reduce none (a warp a query "
        "row); sloppy_phrase_scan K3's layout and table, an f32 "
        "sum per (query, row) (45.875 KiB at B = 64, T = 2)")


def phrase_pairs(rng, tokens, lens, n):
    """bench.py's config-2 phrases: a real adjacent pair of terms from a
    random doc, ``n`` times."""
    pairs = np.empty((n, 2), np.int32)
    for i in range(n):
        d = int(rng.integers(0, tokens.shape[0]))
        pos = int(rng.integers(0, max(int(lens[d]) - 1, 1)))
        a, b = int(tokens[d, pos]), int(tokens[d, pos + 1])
        if a < 0 or b < 0:
            a, b = int(tokens[d, 0]), int(tokens[d, 1])
        pairs[i] = a, b
    return pairs


def phase_data(args):
    from elasticsearch_tpu_torch.index.device_reader import device_reader_for
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.index.segment import (
        NumericFieldColumn, Segment, VectorFieldColumn, doc_count_bucket)
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search.phase import ShardSearcher
    import tempfile
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    uterms, utf, lens, df, tokens = make_corpus(rng, args.docs, args.vocab,
                                                224)
    n_queries = args.batches * args.batch
    qtids = make_queries(rng, n_queries, args.terms, df)
    # configs 2 and 3 draw from CHILD generators: a draw from the seeded
    # stream would move config 1's corpus and queries
    rank = np.random.default_rng([args.seed, 1]).random(args.docs) * 100.0
    n_cfg = args.cfg_batches * args.batch
    pairs = phrase_pairs(np.random.default_rng([args.seed, 2]), tokens, lens,
                         n_cfg)
    # config 4 and the hybrid leg: 768-d unit vectors (bench.py's), drawn
    # from child generators as well
    vgen = np.random.default_rng([args.seed, 4])
    qv4 = unit_rows(np.random.default_rng([args.seed, 5]), (n_cfg, VEC_DIMS))
    qvh = unit_rows(np.random.default_rng([args.seed, 6]), (n_cfg, VEC_DIMS))
    log(f"data: {args.docs} docs, U={uterms.shape[1]}, L={tokens.shape[1]}, "
        f"avgdl={lens.mean():.3f}, mean unique terms "
        f"{(uterms >= 0).sum(axis=1).mean():.3f}, {n_queries} queries x "
        f"{args.terms} terms, {n_cfg} phrase pairs, built on the host in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    w = len(str(args.vocab - 1))
    term_names = [f"t{i:0{w}d}" for i in range(args.vocab)]
    ms = MapperService()
    ms.merge("_doc", {"properties": {
        "body": {"type": "text", "analyzer": "whitespace"},
        "rank": {"type": "double"},
        "vec": {"type": "dense_vector", "dims": VEC_DIMS}}})
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
        seg = Segment.from_packed_text(
            0, "body", terms=term_names, tokens=padrows(tokens, -1),
            uterms=padrows(uterms, -1), utf=padrows(utf, 0.0),
            doc_len=padrows(lens, 0), df=seg_df, num_docs=rows,
            ids=[str(lo + i) for i in range(rows)] +
            [""] * (np_rows - rows))
        seg.numeric_fields["rank"] = NumericFieldColumn(
            values=padrows(rank, 0.0),
            exists=padrows(np.ones(args.docs, bool), False))
        vecs = np.zeros((np_rows, VEC_DIMS), np.float32)
        vgen.standard_normal(dtype=np.float32, out=vecs[:rows])
        vecs[:rows] /= np.linalg.norm(vecs[:rows], axis=1, keepdims=True)
        seg.vector_fields["vec"] = VectorFieldColumn(
            vecs=vecs, exists=padrows(np.ones(args.docs, bool), False),
            dims=VEC_DIMS)
        eng.install_segment(seg, track_versions=False)
    reader = device_reader_for(eng)
    searcher = ShardSearcher(0, reader, ms)
    log(f"data: {len(reader.segments)} segment(s) installed and packed on "
        f"{reader.device} in {time.perf_counter() - t0:.1f} s, with a "
        f"{VEC_DIMS}-d unit vector a doc; {reader_bytes(reader)}; host "
        f"memory: {host_memory()}")
    texts = [" ".join(term_names[t] for t in row) for row in qtids]
    return {"uterms": uterms, "utf": utf, "lens": lens, "df": df,
            "tokens": tokens, "rank": rank, "pairs": pairs,
            "qtids": qtids, "texts": texts, "term_names": term_names,
            "qv4": qv4, "qvh": qvh, "mapper": ms,
            "engine": eng, "reader": reader, "searcher": searcher}


def unit_rows(rng, shape) -> np.ndarray:
    """Standard normal rows scaled to unit length, float32 (bench.py's
    query vectors)."""
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def host_memory() -> str:
    """The host's memory as ``free -g`` gives it, on one line."""
    out = subprocess.run(["free", "-g"], capture_output=True, text=True,
                         timeout=60)
    return " | ".join(" ".join(line.split())
                      for line in out.stdout.splitlines()[:2]) \
        if out.returncode == 0 else "not read"


def reader_bytes(reader) -> str:
    """The reader's device bytes, split into the text and live columns
    (what config 1 reads), the rank column, the position matrices, the
    vector columns' exists masks and token counts, the vector matrices
    (f32 and int8), and the impact lane's columns and block tables."""
    total = reader.device_bytes()
    rank = sum(nbytes(c.hi) + nbytes(c.lo) + nbytes(c.exists)
               for s in reader.segments for c in s.numeric.values())
    tokens = sum(nbytes(c.tokens) + nbytes(c.tok_extent)
                 for s in reader.segments for c in s.text.values()
                 if c.tokens is not None)
    cols = [c for s in reader.segments
            for c in list(s.vector.values()) + list(s.mvector.values())]
    masks = sum(nbytes(c.exists) + (nbytes(c.lens) if hasattr(c, "lens")
                                    else 0) for c in cols)
    f32 = sum(nbytes(c.vecs) for c in cols if c.vecs is not None)
    int8 = sum(nbytes(c.qvecs) for c in cols if c.qvecs is not None)
    impacts = sum(nbytes(t) for s in reader.segments
                  for c in s.impacts.values()
                  for t in (c.qimp, c.block_max) if t is not None)
    return (f"reader device bytes {total} (text and live columns "
            f"{total - rank - tokens - masks - f32 - int8 - impacts}, rank "
            f"column {rank}, position matrices {tokens}, vector exists/lens "
            f"{masks}, vector matrices f32 {f32}, int8 {int8}, impact "
            f"columns and block tables {impacts})")


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


def path_kernels():
    """The launch counter of every hand kernel, by its name in the kernels
    line (K5's f32 and int8 instantiations have one each)."""
    from elasticsearch_tpu_torch.ops import (
        aggs_ops, blockmax, lexical, maxsim, percolate, phrase, topk, vector)
    return {"bm25_scan": lexical.BM25_SCAN, "stable_topk": topk.TOPK,
            "phrase_scan": phrase.PHRASE_SCAN,
            "sloppy_phrase_scan": phrase.SLOPPY_PHRASE_SCAN,
            "percolate_reduce": percolate.PERCOLATE_REDUCE,
            "int8_cosine": vector.INT8_COSINE, "maxsim": maxsim.MAXSIM,
            "maxsim_int8": maxsim.MAXSIM_INT8,
            "impact_scan": blockmax.IMPACT_SCAN,
            "blockmax_sweep": blockmax.BLOCKMAX_SWEEP,
            "agg_counts": aggs_ops.AGG_COUNTS,
            "agg_stats": aggs_ops.AGG_STATS}


def drive(torch, searcher, batches):
    """Every launch counter set to 0, the batches through
    ShardSearcher.query_phase_batch, the counters read just after. → (results,
    per-batch ms, wall s, launches, peak device bytes)."""
    counters = path_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    GC.take()
    for kern in counters.values():
        kern.launches = 0
    results, per_batch = [], []
    t_all = time.perf_counter()
    for batch in batches:
        t0 = time.perf_counter()
        out = searcher.query_phase_batch(batch)
        per_batch.append((time.perf_counter() - t0) * 1e3)
        check(out is not None, "query_phase_batch declined a batch (it "
              "would fall back to one request at a time)")
        results.append(out)
    wall = time.perf_counter() - t_all
    launches = {name: kern.launches for name, kern in counters.items()}
    return results, per_batch, wall, launches, torch.cuda.max_memory_allocated()


def report(label, args, data, batches, per_batch, wall, launches, peak,
           name, smi_line, needed) -> dict:
    for kname in needed:
        check(launches[kname] > 0,
              f"{label}: kernel {kname} was not launched on its path")
    n = sum(len(b) for b in batches)
    qps = n / wall
    p50 = statistics.median(per_batch)
    log(f"{label}: launches {launches} over {len(batches)} batches of "
        f"{len(batches[0])} on {len(data['reader'].segments)} segment(s)")
    log(f"{label}: {qps:.2f} queries/s, p50 {p50:.3f} ms per batch of "
        f"{len(batches[0])} (batches: {', '.join(f'{x:.3f}' for x in per_batch)} "
        f"ms), peak device memory {peak} B, {reader_bytes(data['reader'])}; "
        f"{GC.take()} in the batches — on {name} ({smi_line})")
    return {"qps": qps, "p50_ms": p50, "peak_bytes": peak,
            "launches": launches}


def gid_to_orig(reader) -> np.ndarray:
    """Reader-global doc id → the corpus row it was made from."""
    out = np.full(reader.max_doc, -1, np.int64)
    for dseg in reader.segments:
        nr = dseg.seg.num_docs
        first = int(dseg.seg.ids[0])
        out[dseg.doc_base:dseg.doc_base + nr] = np.arange(first, first + nr)
    return out


def check_vs_cpu(label, args, results, cpu, matched, orig_of, k=None,
                 rtol=1e-5, atol=1e-5, tie_tol=1e-4) -> float:
    """Each result against its float64 CPU scoring: totals exact, the hit
    count, scores within ``atol`` (+ ``rtol``), tie-tolerant recall@k = 1.0
    (k: ``args.k`` unless given)."""
    k = k or args.k
    recalls = []
    for qi, (res, s64, m64) in enumerate(zip(results, cpu, matched)):
        n_match = int(m64.sum())
        check(res.total == n_match,
              f"{label} query {qi}: total {res.total} != CPU matches "
              f"{n_match}")
        orig = orig_of[np.asarray(res.doc_ids, np.int64)]
        check(len(orig) == min(k, n_match) and (orig >= 0).all(),
              f"{label} query {qi}: {len(orig)} hits for {n_match} matches")
        check(bool(m64[orig].all()),
              f"{label} query {qi}: a hit the CPU scoring does not match")
        check(np.allclose(res.scores, s64[orig], rtol=rtol, atol=atol),
              f"{label} query {qi}: scores disagree with the CPU scoring")
        recalls.append(tie_tolerant_recall(s64, orig, k, tol=tie_tol,
                                           matched=m64))
    recall = float(np.mean(recalls))
    check(recall == 1.0, f"{label}: recall {recall} != 1.0")
    return recall


def phase_main_path(torch, args, data, kernels, name, smi_line) -> dict:
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    searcher, reader = data["searcher"], data["reader"]
    reqs = [parse_search_request({"query": {"match": {"body": t}},
                                  "size": args.k}) for t in data["texts"]]
    batches = [reqs[i * args.batch:(i + 1) * args.batch]
               for i in range(args.batches)]
    results, per_batch, wall, launches, peak = drive(torch, searcher,
                                                     batches)
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    stats = report("config 1 (match)", args, data, batches, per_batch, wall,
                   launches, peak, name, smi_line,
                   ("bm25_scan", "stable_topk"))
    check(launches["phrase_scan"] == 0 and all(
        c.tokens is None for s in reader.segments for c in s.text.values()),
        "config 1 put a position matrix on the card")
    check(all(c.vecs is None and c.qvecs is None for s in reader.segments
              for c in s.vector.values()),
          "config 1 put a vector matrix on the card")

    # fetch the top 10 hits of one request
    r0 = results[0][0]
    hits = searcher.fetch_phase(batches[0][0], r0, "msmarco",
                                list(range(min(10, len(r0.doc_ids)))))
    orig_of = gid_to_orig(reader)
    for pos, hit in enumerate(hits):
        check(hit["_id"] == str(orig_of[r0.doc_ids[pos]]),
              f"fetch_phase hit {pos} has _id {hit['_id']}")
        check(hit["_score"] == float(r0.scores[pos]),
              f"fetch_phase hit {pos} score differs from the query phase")
    log(f"fetch_phase: top {len(hits)} hits of request 0: "
        f"{[(h['_id'], round(h['_score'], 4)) for h in hits[:3]]} ...")

    # first batch against the independent float64 CPU scoring
    t0 = time.perf_counter()
    cpu = cpu_scores(data["uterms"], data["utf"], data["lens"], data["df"],
                     data["qtids"][:args.batch])
    recall = check_vs_cpu("config 1", args, results[0], cpu,
                          [s > 0 for s in cpu], orig_of)
    log(f"config 1: first batch vs independent float64 CPU scoring "
        f"({time.perf_counter() - t0:.1f} s): totals exact, scores within "
        f"1e-5, tie-tolerant recall@{args.k} = {recall}")
    return stats


def phase_phrase_kernel(torch, args, data) -> dict:
    """The first phrase plan uploads the position matrices; then K3 against
    its plain version at the shape config 2 gives it and at odd shapes."""
    from elasticsearch_tpu_torch.ops import phrase
    from elasticsearch_tpu_torch.search import query_dsl
    from elasticsearch_tpu_torch.search.segment_exec import (
        _plan_segment_batch)
    searcher, reader = data["searcher"], data["reader"]
    tn = data["term_names"]
    queries = [query_dsl.parse_query({"match_phrase": {
        "body": f"{tn[a]} {tn[b]}"}}) for a, b in data["pairs"][:args.batch]]
    before = reader_bytes(reader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plans = [_plan_segment_batch(seg, searcher.ctx, queries, args.k)
             for seg in reader.segments]
    torch.cuda.synchronize()
    log(f"phrase kernel: the first phrase plans put the position matrices "
        f"on the card in {time.perf_counter() - t0:.2f} s; before: {before}; "
        f"after: {reader_bytes(reader)}")
    seg, plan = reader.segments[0], plans[0]
    col = seg.text["body"]
    tids, sum_idf, avgdl, _boost = plan["consts"]
    p = searcher.ctx.bm25
    deltas = (0, 1)
    k3_args = (col.tokens, col.doc_len, tids, deltas, sum_idf, p.k1, p.b,
               avgdl)
    n, length = col.tokens.shape
    bsz, t = tids.shape

    def check_k3(args_, extent, what):
        got_s, got_m = phrase.phrase_score_batch(*args_, extent=extent)
        want_s, want_m = phrase.phrase_score_batch_plain(*args_)
        torch.cuda.synchronize()
        check(torch.equal(got_m, want_m),
              f"K3 mask differs from its plain version ({what})")
        check(torch.equal(got_s.view(torch.int32), want_s.view(torch.int32)),
              f"K3 scores are not bit-identical to its plain version "
              f"({what})")
        check(bool(got_m.any()), f"K3 found no phrase at all ({what})")
        return got_s, got_m

    got_s, got_m = check_k3(k3_args, col.tok_extent, "config 2's shape")
    k3_ms = timed(torch, "K3", lambda: phrase.phrase_score_batch(
        *k3_args, extent=col.tok_extent), reps=20)
    k3_plain_ms = timed(torch, "K3 plain", lambda:
                        phrase.phrase_score_batch_plain(*k3_args), reps=2,
                        warmup=0)
    # least work for this run's data: each row up to its extent, the
    # extents, lengths and query constants once, [B, N] scores and mask
    # written; 8 flops per (query, doc) with a phrase, a probe per position
    ext_sum = int(col.tok_extent.sum())
    hits = int(got_m.sum())
    k3_bytes = (4 * ext_sum + nbytes(col.tok_extent) + nbytes(col.doc_len)
                + nbytes(tids) + nbytes(sum_idf) + nbytes(avgdl)
                + nbytes(got_s) + nbytes(got_m))
    k3_ops = 8 * hits + ext_sum
    k3_b, k3_by = bound(k3_bytes, k3_ops)
    log(f"K3 phrase_scan [B={bsz}, N={n}, L={length}, T={t}, deltas "
        f"{deltas}]: bit-identical to plain ({hits} (query, doc) pairs with "
        f"a phrase); kernel_ms={k3_ms:.4f} plain_ms={k3_plain_ms:.4f} "
        f"bound_ms={k3_b:.4f} ({k3_by}: {k3_bytes} B, {k3_ops} ops; rows "
        f"read to their extent, mean {ext_sum / n:.3f} positions) "
        f"library_ms=null")

    # ---- odd shapes: B = 3, N off the 8-row run, holes inside rows -------
    rng = np.random.default_rng([args.seed, 3])
    n_odd = min(n, 100_003)
    tok = col.tokens[:n_odd].clone()
    lens = col.doc_len[:n_odd]
    holes = torch.arange(0, n_odd, 5, device=tok.device)
    tok[holes, (lens[holes] // 2).long()] = -1
    ext = phrase.token_extent(tok)
    host = tok[:64].cpu().numpy()
    # a row without a hole holding at least 12 positions
    r = next(i for i in range(64)
             if i % 5 and int((host[i] >= 0).sum()) >= 12)
    row = host[r]
    ln = int((row >= 0).sum())
    cases = {
        (0,): np.array([[row[3]], [-1], [row[0]]], np.int32),
        (0, 1, 3, 4, 6): np.array([
            [row[d] for d in (0, 1, 3, 4, 6)],                   # a real one
            [row[2]] * 5,                                        # repeated
            [row[min(ln - 4 + d, ln - 1)] for d in (0, 1, 3, 4, 6)],  # past
        ], np.int32),
    }
    for odd_deltas, odd_tids in cases.items():
        qt = torch.from_numpy(odd_tids).to(tok.device)
        si = torch.from_numpy(rng.uniform(0.5, 9.0, 3).astype(
            np.float32)).to(tok.device)
        av = avgdl[:3].clone()
        check_k3((tok, lens, qt, odd_deltas, si, p.k1, p.b, av), ext,
                 f"odd shape B=3, N={n_odd}, T={len(odd_deltas)}")
        log(f"K3 phrase_scan [B=3, N={n_odd}, L={length}, T="
            f"{len(odd_deltas)}, deltas {odd_deltas}, holes in every fifth "
            f"row, an absent, a repeated and a past-the-end phrase]: "
            f"bit-identical to plain")
    err = float((got_s - phrase.phrase_score_batch_plain(*k3_args)[0])
                .abs().max())
    return {"name": "phrase_scan", "route": "cuda", "source": K3_SOURCE,
            "replaces": K3_REPLACES, "launches": 0, "max_abs_err": err,
            "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_b,
            "bound_by": k3_by, "library_ms": None,
            "library_null": "no single torch call: a compare of shifted "
                            "position rows, a count, then BM25",
            "shape": {"B": bsz, "N": n, "L": length, "T": t,
                      "deltas": list(deltas)}}


def config2_bodies(args, data) -> list[dict]:
    """bench.py's config 2: must = a match on the query's first two terms,
    should = a match_phrase of a real adjacent pair."""
    tn = data["term_names"]
    n_cfg = args.cfg_batches * args.batch
    return [{"query": {"bool": {
        "must": [{"match": {"body": f"{tn[m[0]]} {tn[m[1]]}"}}],
        "should": [{"match_phrase": {"body": f"{tn[a]} {tn[b]}"}}]}},
        "size": args.k}
        for m, (a, b) in zip(data["qtids"][:n_cfg, :2], data["pairs"])]


def config3_bodies(args, data, decay: bool = False) -> list[dict]:
    """bench.py's config 3: function_score field_value_factor on rank
    (log1p, factor 1, boost_mode multiply) over the 4-term match; with
    ``decay`` a gauss decay on rank joins it under score_mode multiply."""
    functions = [{"field_value_factor": {"field": "rank",
                                         "modifier": "log1p",
                                         "factor": 1.0}}]
    if decay:
        functions.append({"gauss": {"rank": {"origin": 50, "scale": 20}}})
    return [{"query": {"function_score": {
        "query": {"match": {"body": t}}, "functions": functions,
        "score_mode": "multiply", "boost_mode": "multiply"}},
        "size": args.k}
        for t in data["texts"][:args.cfg_batches * args.batch]]


def batches_of(args, bodies):
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    reqs = [parse_search_request(b) for b in bodies]
    return [reqs[i:i + args.batch] for i in range(0, len(reqs), args.batch)]


def phase_config2(torch, args, data, name, smi_line) -> dict:
    batches = batches_of(args, config2_bodies(args, data))
    results, per_batch, wall, launches, peak = drive(
        torch, data["searcher"], batches)
    stats = report("config 2 (bool + match_phrase)", args, data, batches,
                   per_batch, wall, launches, peak, name, smi_line,
                   ("bm25_scan", "stable_topk", "phrase_scan"))
    nq = CHECK_QUERIES
    t0 = time.perf_counter()
    must = cpu_scores(data["uterms"], data["utf"], data["lens"], data["df"],
                      data["qtids"][:nq, :2])
    phr = cpu_phrase_scores(data["tokens"], data["uterms"], data["utf"],
                            data["lens"], data["df"], data["pairs"][:nq])
    matched = [m > 0 for m in must]
    cpu = [np.where(m, s + ph, 0.0) for m, s, ph in zip(matched, must, phr)]
    recall = check_vs_cpu("config 2", args, results[0][:nq], cpu, matched,
                          gid_to_orig(data["reader"]))
    n_phrase = [int(((ph > 0) & m).sum()) for ph, m in zip(phr, matched)]
    check(sum(n_phrase) > 0, "config 2: no checked query has a matched doc "
          "that holds its phrase, so the check does not cover K3")
    log(f"config 2: first {nq} queries vs independent float64 CPU scoring "
        f"with a numpy phrase count ({time.perf_counter() - t0:.1f} s; "
        f"matched docs with the phrase: {n_phrase}): totals exact, scores "
        f"within 1e-5, tie-tolerant recall@{args.k} = {recall}")
    return stats


def phase_config3(torch, args, data, name, smi_line) -> dict:
    batches = batches_of(args, config3_bodies(args, data))
    results, per_batch, wall, launches, peak = drive(
        torch, data["searcher"], batches)
    stats = report("config 3 (function_score)", args, data, batches,
                   per_batch, wall, launches, peak, name, smi_line,
                   ("bm25_scan", "stable_topk"))
    nq = CHECK_QUERIES
    t0 = time.perf_counter()
    bm25 = cpu_scores(data["uterms"], data["utf"], data["lens"], data["df"],
                      data["qtids"][:nq])
    rank = data["rank"]
    fvf = np.log10(rank + 1.0)
    matched = [s > 0 for s in bm25]
    orig_of = gid_to_orig(data["reader"])
    recall = check_vs_cpu("config 3", args, results[0][:nq],
                          [s * fvf for s in bm25], matched, orig_of)
    # one untimed batch with a second function: gauss decay on rank
    decay_batch = batches_of(args, config3_bodies(args, data, decay=True))[0]
    res_g = data["searcher"].query_phase_batch(decay_batch)
    check(res_g is not None, "config 3 with gauss decay fell back")
    sigma2 = -(20.0 ** 2) / (2.0 * np.log(0.5))
    gauss = np.exp(-np.maximum(np.abs(rank - 50.0), 0.0) ** 2 /
                   (2.0 * sigma2))
    recall_g = check_vs_cpu("config 3 + gauss", args, res_g[:nq],
                            [s * fvf * gauss for s in bm25], matched,
                            orig_of)
    log(f"config 3: first {nq} queries vs independent float64 CPU scoring "
        f"({time.perf_counter() - t0:.1f} s): totals exact, scores within "
        f"1e-5, tie-tolerant recall@{args.k} = {recall}; with a gauss "
        f"decay under score_mode multiply (one untimed batch): the same, "
        f"recall {recall_g}")
    return stats


def phase_profile(torch, args, data, label, bodies, searcher=None,
                  plan=None) -> dict:
    """One batch under torch.profiler (after an unrecorded warm-up run of
    it): device time by kernel, the busy share of the batch, and the host
    planning of the batch alone (a pure knn request plans no query; the
    impact lane's planning is ``plan``, called with the batch)."""
    from elasticsearch_tpu_torch.search import query_dsl, segment_exec
    searcher = searcher or data["searcher"]
    reader = searcher.reader
    batch = batches_of(args, bodies[:args.batch])[0]
    # host-only planning of the batch (resolve every query on every
    # segment), no device work
    queries = [query_dsl.parse_query(b["query"]) for b in bodies[:args.batch]
               if "query" in b]
    flags = {"min_score": False, "search_after": False}
    GC.take()
    t0 = time.perf_counter()
    if plan is not None:
        plan(batch)
    else:
        for seg in reader.segments:
            for query in queries:
                segment_exec._plan(seg, searcher.ctx, query, None, flags)
    plan_ms = (time.perf_counter() - t0) * 1e3
    return profile_batch(torch, label, lambda: check(
        searcher.query_phase_batch(batch) is not None,
        f"query_phase_batch declined the profiled {label} batch"),
        plan_ms, GC.take(), len(batch))


def profile_batch(torch, label, run, plan_ms, plan_gc, size,
                  extra=None) -> dict:
    """``run`` (one batch of ``size`` requests) twice under torch.profiler,
    the first unrecorded: device time by kernel, the busy share of the
    batch; ``extra()`` adds to the line."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # the batch twice: a warm-up step the profiler does not record (its own
    # start-up cost lands there), then the recorded step
    recorded = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                  active=1),
                 on_trace_ready=lambda p: recorded.append(
                     p.key_averages())) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            wall_ms = (time.perf_counter() - t0) * 1e3
            batch_gc = GC.take()
            prof.step()
    check(len(recorded) == 1, f"the profiler recorded {len(recorded)} "
          f"steps of the {label} batch, not 1")
    rows = []
    for ev in recorded[0]:
        # device-side rows only: an aten op's row repeats its kernels' time,
        # and the step's own annotation spans them all
        if not str(getattr(ev, "device_type", "")).endswith("CUDA") or \
                ev.key.startswith("ProfilerStep"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        log(f"profile {label}: torch.profiler reported no device time (batch "
            f"wall {wall_ms:.3f} ms, host planning alone {plan_ms:.3f} ms); "
            f"the busy share is not measured; GC: planning {plan_gc}, "
            f"batch {batch_gc}")
        return {"wall_ms": wall_ms, "plan_ms": plan_ms, "busy_ms": None}
    by_kernel = {"K1": ("bm25_scan_kernel",),
                 "K2": ("chunk_topk_kernel", "merge_candidates_kernel",
                        "split_candidates_kernel", "select_run_kernel",
                        "sort_tiles_kernel", "merge_runs_kernel",
                        "write_run_kernel"),
                 "K3": ("phrase_scan_kernel",),
                 "K4": ("int8_cosine_kernel",), "K5": ("maxsim_kernel",),
                 "K6": ("impact_scan_kernel",),
                 "K7": ("blockmax_sweep_kernel",),
                 "K8": ("agg_counts_kernel",),
                 "K9": ("agg_stats_partial_kernel", "agg_stats_final_kernel"),
                 "K10": ("percolate_reduce_kernel",),
                 "K11": ("sloppy_phrase_kernel",),
                 "cuBLAS": ("gemm", "xmma", "cutlass")}
    parts = {}
    for kname, keys in by_kernel.items():
        sel = [r for r in rows if any(k in r[2] for k in keys)]
        parts[kname] = (sum(r[0] for r in sel), sum(r[1] for r in sel))
    other = busy_ms - sum(v[0] for v in parts.values())
    log(f"profile {label}: one batch of {size}: wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"host planning alone {plan_ms:.3f} ms; "
        + ", ".join(f"{k} {v[0]:.3f} ms ({v[1]} kernels)"
                    for k, v in parts.items())
        + f", element-wise and copies {other:.3f} ms; GC: planning "
        f"{plan_gc}, recorded batch {batch_gc}"
        + (extra() if extra is not None else ""))
    for dev_ms, count, key in rows[:8]:
        log(f"profile:   {dev_ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "plan_ms": plan_ms, "busy_ms": busy_ms,
            "parts": parts}


def phase_elementwise(torch, args, data) -> None:
    """The element-wise bodies of configs 2 and 3 timed alone at the batch's
    shape on one segment: combine_bool (one must, one should) and the
    function_score ops (field_value_factor log1p, apply_boost_mode)."""
    from elasticsearch_tpu_torch.ops import boolean, functionscore
    seg = data["reader"].segments[0]
    n = seg.padded_docs
    dev = seg.live.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    s1, s2 = (torch.rand((args.batch, n), generator=gen, device=dev)
              for _ in range(2))
    m1, m2 = s1 > 0.5, s2 > 0.99
    msm = torch.zeros(args.batch, dtype=torch.int32, device=dev)
    col = seg.numeric["rank"]
    ones = torch.ones(args.batch, device=dev)
    bool_ms = timed(torch, "combine_bool", lambda: boolean.combine_bool(
        (args.batch, n), [(s1, m1)], [(s2, m2)], [], [], msm, device=dev),
        reps=10)
    fs_ms = timed(torch, "field_value_factor + apply_boost_mode", lambda:
                  functionscore.apply_boost_mode(
                      s1, functionscore.field_value_factor(
                          col.hi, col.exists, ones, "log1p"), "multiply"),
                  reps=10)
    log(f"element-wise [B={args.batch}, N={n}]: combine_bool (1 must, 1 "
        f"should) {bool_ms:.4f} ms; field_value_factor log1p + "
        f"apply_boost_mode multiply {fs_ms:.4f} ms (per segment)")


# --------------------------------------------------------------------------
# config 4, hybrid and MaxSim: the knn lane
# --------------------------------------------------------------------------

def segment_rows(reader):
    """(corpus row of the segment's first doc, real rows) per segment."""
    return [(int(s.seg.ids[0]), s.seg.num_docs) for s in reader.segments]


def cosines64(reader, field, qs, chunk=1 << 17) -> np.ndarray:
    """float64 cosine of each query row of ``qs`` against every corpus row,
    from the segments' own (host) vectors normalized in float64. → [Q, N]
    indexed by corpus row."""
    q = qs.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    n = sum(rows for _, rows in segment_rows(reader))
    out = np.empty((len(q), n))
    for dseg, (first, rows) in zip(reader.segments, segment_rows(reader)):
        vecs = dseg.seg.vector_fields[field].vecs
        for lo in range(0, rows, chunk):
            hi = min(lo + chunk, rows)
            v = vecs[lo:hi].astype(np.float64)
            v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
            out[:, first + lo:first + hi] = q @ v.T
    return out


def dequant_dots64(pack, reader, qs, chunk=1 << 17) -> np.ndarray:
    """float64 dots of each (normalized) query with the dequantized int8
    rows ``q·scale + offset`` of each segment. → [Q, N] by corpus row."""
    q = qs.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    n = sum(rows for _, rows in segment_rows(reader))
    out = np.empty((len(q), n))
    for s, (first, rows) in zip(pack.segs, segment_rows(reader)):
        for lo in range(0, rows, chunk):
            hi = min(lo + chunk, rows)
            v = s["vecs"][lo:hi].cpu().numpy().astype(np.float64) \
                * s["scale"] + s["offset"]
            out[:, first + lo:first + hi] = q @ v.T
    return out


def register_knn_indices() -> None:
    """Register the int8 index's knn settings (``index.knn.quantization:
    int8``, as bench.py:824-828 does) and the weighted-fusion index's."""
    from elasticsearch_tpu_torch.search import segment_exec
    segment_exec.configure_knn_plane(INT8_INDEX,
                                     {"index.knn.quantization": "int8"})
    segment_exec.configure_knn_plane(WEIGHTED_INDEX,
                                     {"index.search.hybrid.mode": "weighted"})


def knn_bodies(qvs, texts=None) -> list[dict]:
    """bench.py's config-4 requests (k = num_candidates = 100), with a
    ``match`` of the query's terms beside the knn section when ``texts``
    (the rag_hybrid leg)."""
    out = []
    for i, v in enumerate(qvs):
        body = {"knn": {"field": "vec", "query_vector": v.tolist(),
                        "k": KNN_K, "num_candidates": KNN_K},
                "size": KNN_K}
        if texts is not None:
            body["query"] = {"match": {"body": texts[i]}}
        out.append(body)
    return out


def phase_int8_kernel(torch, args, data) -> dict:
    """K4 against its plain version on segment 0's int8 column at the
    config-4 batch's shape, and at an odd shape."""
    from elasticsearch_tpu_torch.index.segment import quantize_vectors
    from elasticsearch_tpu_torch.ops import vector
    reader = data["reader"]
    seg = reader.segments[0]
    t0 = time.perf_counter()
    col = reader.fetch_vectors(seg, "vec", "int8")
    torch.cuda.synchronize()
    log(f"int8 kernel: segment 0's column normalized, quantized on the host "
        f"and put on the card in {time.perf_counter() - t0:.2f} s (scale "
        f"{col.scale!r}, offset {col.offset!r})")
    qv, ex = col.qvecs, col.exists
    scale, offset = col.scale, col.offset
    qs = torch.from_numpy(data["qv4"][:args.batch]).to(qv.device)
    qn = vector.l2_normalize(qs)
    qsum = qn.sum(dim=-1)
    got = vector.cosine_scores_int8_batch(qv, scale, offset, ex, qs)
    want = vector.cosine_scores_int8_batch_plain(qv, scale, offset, ex, qn,
                                                 qsum)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= 1e-5, f"K4 differs from its plain version by {err}")
    k4_ms = timed(torch, "K4", lambda: vector.cosine_scores_int8_batch(
        qv, scale, offset, ex, qs), reps=10)
    plain_ms = timed(torch, "K4 plain", lambda:
                     vector.cosine_scores_int8_batch_plain(
                         qv, scale, offset, ex, qn, qsum), reps=3)
    qf = qv.float()            # the library call's float copy, made once
    lib_ms = timed(torch, "K4 torch.matmul on a float copy", lambda:
                   torch.matmul(qn, qf.T), reps=10)
    del qf
    n, d = qv.shape
    b = qs.shape[0]
    k4_bytes = nbytes(qv) + nbytes(ex) + nbytes(qn) + nbytes(qsum) + \
        nbytes(got)
    k4_b, k4_by = bound(k4_bytes, 2 * b * n * d)
    log(f"K4 int8_cosine [B={b}, N={n}, D={d}]: max |K4 - plain| = {err} "
        f"(<= 1e-5); kernel_ms={k4_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} (torch.matmul on a float copy of the "
        f"column) bound_ms={k4_b:.4f} ({k4_by}: {2 * b * n * d} flop, "
        f"{k4_bytes} B)")
    # odd shape: B = 3, N = 100,003, D = 100, holes every fifth row
    rng = np.random.default_rng([args.seed, 8])
    n_odd, d_odd = 100_003, 100
    qcol = quantize_vectors(unit_rows(rng, (n_odd, d_odd)), d_odd)
    o_qv = torch.from_numpy(qcol.qvecs).to(qv.device)
    o_ex = torch.ones(n_odd, dtype=torch.bool, device=qv.device)
    o_ex[::5] = False
    o_qs = torch.from_numpy(rng.standard_normal((3, d_odd)).astype(
        np.float32)).to(qv.device)
    o_qn = vector.l2_normalize(o_qs)
    o_got = vector.cosine_scores_int8_batch(o_qv, qcol.scale, qcol.offset,
                                            o_ex, o_qs)
    o_want = vector.cosine_scores_int8_batch_plain(
        o_qv, qcol.scale, qcol.offset, o_ex, o_qn, o_qn.sum(dim=-1))
    torch.cuda.synchronize()
    o_err = float((o_got - o_want).abs().max())
    check(o_err <= 1e-5 and bool((o_got[:, ~o_ex] == 0).all()),
          f"K4 differs from its plain version at the odd shape ({o_err})")
    log(f"K4 int8_cosine [B=3, N={n_odd}, D={d_odd}, exists holes every "
        f"fifth row]: max |K4 - plain| = {o_err} (<= 1e-5)")
    return {"name": "int8_cosine", "route": "cuda", "source": K4_SOURCE,
            "replaces": K4_REPLACES, "launches": 0, "max_abs_err": err,
            "ms": k4_ms, "plain_ms": plain_ms, "bound_ms": k4_b,
            "bound_by": k4_by, "library_ms": lib_ms,
            "shape": {"B": b, "N": n, "D": d}}


def phase_config4(torch, args, data, name, smi_line) -> tuple[dict, dict]:
    """BASELINE config 4 through query_phase_batch: f32 (torch.matmul) and,
    through a searcher of the int8 index over the same reader, int8 (K4)."""
    from elasticsearch_tpu_torch.search import segment_exec
    from elasticsearch_tpu_torch.search.phase import ShardSearcher
    check(not torch.backends.cuda.matmul.allow_tf32 and
          torch.get_float32_matmul_precision() == "highest",
          "TF32 is on for float32 matrix products")
    reader = data["reader"]
    register_knn_indices()
    # set-up, untimed: the first knn request of each quantization
    # normalizes or quantizes the column on the host and puts it on the card
    for cfg in (segment_exec.knn_plane_config(None),
                segment_exec.knn_plane_config(INT8_INDEX)):
        t0 = time.perf_counter()
        segment_exec.vector_pack_for(reader, "vec", cfg)
        torch.cuda.synchronize()
        log(f"config 4: the {cfg.quantization} column's set-up on the host "
            f"and upload (the first {cfg.quantization} request's, untimed) "
            f"took {time.perf_counter() - t0:.2f} s; {reader_bytes(reader)}")
    batches = batches_of(args, knn_bodies(data["qv4"]))
    results, per_batch, wall, launches, peak = drive(
        torch, data["searcher"], batches)
    stats = report("config 4 (knn, f32)", args, data, batches, per_batch,
                   wall, launches, peak, name, smi_line, ("stable_topk",))
    check(launches["int8_cosine"] == 0, "config 4 f32 launched K4")
    s8 = ShardSearcher(0, reader, data["mapper"], index_name=INT8_INDEX)
    data["searcher_int8"] = s8
    res8, per8, wall8, launch8, peak8 = drive(torch, s8, batches)
    stats8 = report("config 4 (knn, int8)", args, data, batches, per8,
                    wall8, launch8, peak8, name, smi_line,
                    ("int8_cosine", "stable_topk"))
    # the first queries against float64 cosines / dequantized dots
    nq = CHECK_QUERIES
    t0 = time.perf_counter()
    orig_of = gid_to_orig(reader)
    # every doc has a vector: the total is the corpus
    everyone = [np.ones(len(data["lens"]), bool)] * nq
    total = len(data["lens"])
    cos = cosines64(reader, "vec", data["qv4"][:nq])
    recall = check_vs_cpu("config 4 f32", args, results[0][:nq], cos,
                          everyone, orig_of, k=KNN_K, rtol=0, tie_tol=1e-5)
    pack = segment_exec.vector_pack_for(
        reader, "vec", segment_exec.knn_plane_config(INT8_INDEX))
    deq = dequant_dots64(pack, reader, data["qv4"][:nq])
    recall8 = check_vs_cpu("config 4 int8", args, res8[0][:nq], deq,
                           everyone, orig_of, k=KNN_K, rtol=0, tie_tol=1e-5)
    worst = 0.0
    for qi, res in enumerate(res8[0][:nq]):
        qn = data["qv4"][qi] / np.linalg.norm(data["qv4"][qi])
        envelope = pack.score_bound(qn) + 1e-5
        dev = np.abs(res.scores - cos[qi][orig_of[res.doc_ids]]).max()
        worst = max(worst, float(dev) / envelope)
        check(dev <= envelope, f"config 4 int8 query {qi}: a hit is "
              f"{dev} from its cosine, above the bound {envelope}")
    # bench.py's int8-vs-f32 recall@10, as information
    n32 = min(32, len(results[0]) * len(results))
    f_top = [r.doc_ids[:10] for b in results for r in b][:n32]
    i_top = [r.doc_ids[:10] for b in res8 for r in b][:n32]
    overlap = sum(len(set(f.tolist()) & set(i.tolist()))
                  for f, i in zip(f_top, i_top)) / sum(len(f) for f in f_top)
    log(f"config 4: first {nq} queries vs float64 ({time.perf_counter() - t0:.1f}"
        f" s): totals {total}, scores within 1e-5, tie-tolerant "
        f"recall@{KNN_K} f32 {recall}, int8 {recall8} (against the "
        f"dequantized rows); int8 hits within the quantization bound of "
        f"their cosine (worst at {worst:.3f} of it); int8-vs-f32 recall@10 "
        f"over {n32} queries: {overlap:.4f}")
    return stats, stats8


def fused_reference(lex, matched, cos, c, k0, mode, w_lex=0.5, tol=1e-5):
    """numpy fusion of float64 legs for one query: each leg's top ``c`` by
    (score desc, corpus row asc) over its eligible rows. → (expected score
    by row, expected order, ambiguous rows, union size, boundary
    ambiguities)."""
    legs = []
    for s, elig in ((lex, matched), (cos, np.ones(len(cos), bool))):
        rows = np.nonzero(elig)[0]
        top = rows[np.lexsort((rows, -s[rows]))[:c + 1]]
        sc = s[top]
        near = np.zeros(len(top), bool)
        # a near tie may swap between float64 and the card's f32; an exact
        # one (the same inputs) is broken by row in both
        step = np.abs(np.diff(sc))
        gaps = (step <= tol) & (step > 0)
        near[:-1] |= gaps
        near[1:] |= gaps
        boundary = len(top) > c and bool(near[c - 1])
        legs.append((top[:c], sc[:c], set(top[near].tolist()), boundary))
    fused = {}
    if mode == "rrf":
        for top, _, _, _ in legs:
            for r, row in enumerate(top):
                contrib = np.float32(1.0) / np.float32(k0 + r + 1)
                fused[int(row)] = np.float32(fused.get(int(row), 0.0)
                                             + contrib)
    else:
        for (top, sc, _, _), w in zip(legs, (w_lex, 1.0 - w_lex)):
            lo, hi = sc.min(), sc.max()
            rng_ = hi - lo if hi > lo else 1.0
            for row, v in zip(top, (sc - lo) / rng_):
                fused[int(row)] = fused.get(int(row), 0.0) + w * v
    order = sorted(fused, key=lambda row: (-fused[row], row))
    ambiguous = legs[0][2] | legs[1][2]
    return fused, order, ambiguous, len(fused), \
        int(legs[0][3]) + int(legs[1][3])


def check_fused(label, results, lexs, matched, coss, orig_of, mode,
                k0=60, w_lex=0.5) -> None:
    """Fused results against the numpy fusion of float64 legs, tie-tolerant
    at each leg's 100th candidate: a hit whose rank in a leg is not set by
    a near tie carries exactly (RRF) or within 1e-5 (weighted) the expected
    score; every expected top-k row above the k-th score that no near tie
    touches is a hit; the total is the legs' union up to the boundary
    ambiguities."""
    atol = 0.0 if mode == "rrf" else 1e-5
    for qi, res in enumerate(results):
        fused, order, amb, union, slack = fused_reference(
            lexs[qi], matched[qi], coss[qi], KNN_K, k0, mode, w_lex)
        check(abs(res.total - union) <= slack, f"{label} query {qi}: total "
              f"{res.total}, the legs' union {union} (slack {slack})")
        rows = orig_of[np.asarray(res.doc_ids, np.int64)]
        check(abs(len(rows) - min(KNN_K, union)) <= slack,
              f"{label} query {qi}: {len(rows)} hits")
        for row, score in zip(rows.tolist(), res.scores.tolist()):
            if row in amb:
                continue
            check(row in fused and abs(score - fused[row]) <= atol,
                  f"{label} query {qi}: row {row} scores {score}, expected "
                  f"{fused.get(row)}")
        kth = fused[order[min(KNN_K, len(order)) - 1]]
        got = set(rows.tolist())
        for row in order[:KNN_K]:
            if row not in amb and fused[row] > kth + atol:
                check(row in got, f"{label} query {qi}: expected row {row} "
                      f"(score {fused[row]}) is not a hit")


def phase_hybrid(torch, args, data, name, smi_line) -> dict:
    """The rag_hybrid request shape (bench.py:735-740): the 4-term match and
    the knn section, fused by RRF, then one untimed batch under the
    weighted sum."""
    from elasticsearch_tpu_torch.search.phase import ShardSearcher
    bodies = knn_bodies(data["qvh"], data["texts"])
    batches = batches_of(args, bodies)
    results, per_batch, wall, launches, peak = drive(
        torch, data["searcher"], batches)
    stats = report("hybrid (match + knn, RRF)", args, data, batches,
                   per_batch, wall, launches, peak, name, smi_line,
                   ("bm25_scan", "stable_topk"))
    sw = ShardSearcher(0, data["reader"], data["mapper"],
                       index_name=WEIGHTED_INDEX)
    res_w = sw.query_phase_batch(batches[0])
    check(res_w is not None, "the weighted hybrid batch fell back")
    nq = CHECK_QUERIES
    t0 = time.perf_counter()
    lex = cpu_scores(data["uterms"], data["utf"], data["lens"], data["df"],
                     data["qtids"][:nq])
    cos = cosines64(data["reader"], "vec", data["qvh"][:nq])
    orig_of = gid_to_orig(data["reader"])
    matched = [s > 0 for s in lex]
    check_fused("hybrid RRF", results[0][:nq], lex, matched, cos, orig_of,
                "rrf")
    check_fused("hybrid weighted", res_w[:nq], lex, matched, cos, orig_of,
                "weighted")
    log(f"hybrid: first {nq} queries vs a numpy fusion of float64 legs "
        f"({time.perf_counter() - t0:.1f} s): RRF scores exact and the "
        f"weighted sum within 1e-5 outside near ties at a leg's "
        f"{KNN_K}th candidate, totals and tie-tolerant recall@{KNN_K} "
        f"hold")
    return stats


def phase_maxsim_data(args) -> dict:
    """A rank_vectors index: 2 x 2^17 docs (``--maxsim-docs``) with 8-32
    tokens of 128-d standard normal components (normalized per token by the
    lane), and 32-token queries, from a child generator."""
    from elasticsearch_tpu_torch.index.device_reader import device_reader_for
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.index.segment import (
        MultiVectorFieldColumn, Segment)
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search.phase import ShardSearcher
    import tempfile
    rng = np.random.default_rng([args.seed, 7])
    t0 = time.perf_counter()
    ms = MapperService()
    ms.merge("_doc", {"properties": {
        "body": {"type": "text", "analyzer": "whitespace"},
        "tok": {"type": "rank_vectors", "dims": MAXSIM_DIMS,
                "max_tokens": MAXSIM_TOKENS}}})
    eng = Engine(Path(tempfile.mkdtemp(prefix="chip_smoke_maxsim_")), ms)
    rows = args.maxsim_docs // 2
    for si in range(2):
        toks = np.zeros((rows, MAXSIM_TOKENS, MAXSIM_DIMS), np.float32)
        rng.standard_normal(dtype=np.float32, out=toks)
        lens = rng.integers(8, MAXSIM_TOKENS + 1, size=rows).astype(np.int32)
        toks[np.arange(MAXSIM_TOKENS)[None, :] >= lens[:, None]] = 0.0
        seg = Segment.from_packed_text(
            0, "body", terms=["x"], tokens=None,
            uterms=np.zeros((rows, 1), np.int32),
            utf=np.ones((rows, 1), np.float32),
            doc_len=np.ones(rows, np.int32),
            df=np.asarray([rows], np.int64), num_docs=rows,
            ids=[str(si * rows + i) for i in range(rows)])
        seg.mvector_fields["tok"] = MultiVectorFieldColumn(
            vecs=toks, lens=lens, exists=np.ones(rows, bool),
            dims=MAXSIM_DIMS)
        eng.install_segment(seg, track_versions=False)
    n_q = args.maxsim_batches * args.batch
    queries = rng.standard_normal((n_q, MAXSIM_TOKENS, MAXSIM_DIMS)).astype(
        np.float32)
    reader = device_reader_for(eng)
    log(f"MaxSim data: {2 * rows} docs in 2 segments, T={MAXSIM_TOKENS}, "
        f"D={MAXSIM_DIMS}, {n_q} queries of {MAXSIM_TOKENS} tokens, built "
        f"in {time.perf_counter() - t0:.1f} s; {reader_bytes(reader)}; host "
        f"memory: {host_memory()}")
    return {"engine": eng, "reader": reader, "mapper": ms,
            "queries": queries,
            "searcher": ShardSearcher(0, reader, ms),
            "searcher_int8": ShardSearcher(0, reader, ms,
                                           index_name=INT8_INDEX)}


def maxsim_bodies(queries) -> list[dict]:
    return [{"knn": {"field": "tok", "query_vector": q.tolist(),
                     "k": KNN_K, "num_candidates": KNN_K}, "size": KNN_K}
            for q in queries]


def phase_maxsim_kernel(torch, args, mdata) -> list[dict]:
    """K5 (f32 and int8 tokens) against its plain version at the shape the
    MaxSim path gives it and at odd shapes."""
    from elasticsearch_tpu_torch.index.segment import quantize_vectors
    from elasticsearch_tpu_torch.ops import maxsim
    reader = mdata["reader"]
    seg = reader.segments[0]
    lens = seg.mvector["tok"].lens
    dev = lens.device
    q = mdata["queries"][:args.batch]
    qn = q / np.maximum(np.linalg.norm(q, axis=2, keepdims=True), 1e-12)
    qs = torch.from_numpy(qn).to(dev)
    qm = torch.ones(qs.shape[:2], dtype=torch.bool, device=dev)
    qsums = qs.sum(dim=2)
    out = []
    for quant, replaces in (("f32", K5_REPLACES), ("int8", K5_INT8_REPLACES)):
        col = reader.fetch_vectors(seg, "tok", quant)
        tk = col.qvecs if quant == "int8" else col.vecs
        sc, off = col.scale, col.offset
        if quant == "int8":
            run = lambda: maxsim.maxsim_scores_int8_batch_body(  # noqa: E731
                tk, sc, off, lens, qs, qm)
            plain = lambda: maxsim.maxsim_scores_int8_batch_body_plain(  # noqa: E731
                tk, sc, off, lens, qs, qm, qsums)
        else:
            run = lambda: maxsim.maxsim_scores_batch_body(  # noqa: E731
                tk, lens, qs, qm)
            plain = lambda: maxsim.maxsim_scores_batch_body_plain(  # noqa: E731
                tk, lens, qs, qm)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= 1e-5, f"K5 {quant} differs from its plain version by "
              f"{err}")
        ms_ = timed(torch, f"K5 {quant}", run, reps=3)
        plain_ms = timed(torch, f"K5 {quant} plain", plain, reps=1)
        n, t, d = tk.shape
        b, qt = qm.shape
        flops = 2 * b * qt * n * t * d
        k5_bytes = nbytes(tk) + nbytes(lens) + nbytes(qs) + nbytes(qm) + \
            nbytes(got) + (nbytes(qsums) if quant == "int8" else 0)
        k5_b, k5_by = bound(k5_bytes, flops)
        log(f"K5 maxsim {quant} [B={b}, Qt={qt}, N={n}, T={t}, D={d}]: max "
            f"|K5 - plain| = {err} (<= 1e-5); kernel_ms={ms_:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={k5_b:.4f} ({k5_by}: {flops} "
            f"flop, {k5_bytes} B) library_ms=null (no single torch call "
            f"computes a masked max-then-sum of dots)")
        out.append({"name": "maxsim" if quant == "f32" else "maxsim_int8",
                    "route": "cuda", "source": K5_SOURCE,
                    "replaces": replaces, "launches": 0,
                    "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
                    "bound_ms": k5_b, "bound_by": k5_by, "library_ms": None,
                    "library_null": "no single torch call computes a masked "
                                    "max-then-sum of dots",
                    "shape": {"B": b, "Qt": qt, "N": n, "T": t, "D": d}})
    # odd shapes: B = 3, N = 10,007, T = 5, D = 100, Qt = 3 with a qmask
    # hole, some docs without tokens
    rng = np.random.default_rng([args.seed, 9])
    n_o, t_o, d_o, qt_o = 10_007, 5, 100, 3
    toks = unit_rows(rng, (n_o, t_o, d_o))
    o_lens = rng.integers(0, t_o + 1, size=n_o).astype(np.int32)
    o_lens[:5] = 0
    toks[np.arange(t_o)[None, :] >= o_lens[:, None]] = 0.0
    o_qs = torch.from_numpy(unit_rows(rng, (3, qt_o, d_o))).to(dev)
    o_qm = torch.ones((3, qt_o), dtype=torch.bool, device=dev)
    o_qm[0, 1] = False
    o_qm[2, 0] = False
    lens_t = torch.from_numpy(o_lens).to(dev)
    f_t = torch.from_numpy(toks).to(dev)
    qcol = quantize_vectors(toks, d_o)
    i_t = torch.from_numpy(qcol.qvecs).to(dev)
    pairs = (
        (maxsim.maxsim_scores_batch_body(f_t, lens_t, o_qs, o_qm),
         maxsim.maxsim_scores_batch_body_plain(f_t, lens_t, o_qs, o_qm)),
        (maxsim.maxsim_scores_int8_batch_body(i_t, qcol.scale, qcol.offset,
                                              lens_t, o_qs, o_qm),
         maxsim.maxsim_scores_int8_batch_body_plain(
             i_t, qcol.scale, qcol.offset, lens_t, o_qs, o_qm,
             o_qs.sum(dim=2))))
    torch.cuda.synchronize()
    for (g, w), quant in zip(pairs, ("f32", "int8")):
        e = float((g - w).abs().max())
        check(e <= 1e-5 and bool((g[:, :5] == 0).all()),
              f"K5 {quant} differs from its plain version at the odd shape "
              f"({e})")
        log(f"K5 maxsim {quant} [B=3, Qt=3 with qmask holes, N={n_o}, "
            f"T={t_o}, D={d_o}, docs without tokens]: max |K5 - plain| = "
            f"{e} (<= 1e-5)")
    return out


def maxsim64(reader, pack, queries, int8: bool, chunk=8192) -> np.ndarray:
    """float64 MaxSim of each query against every corpus row: per-token
    normalized float64 tokens (int8: the dequantized tokens ``q·scale +
    offset``), the max over each doc's real tokens, summed over the query's
    tokens. → [Q, N] by corpus row."""
    q = queries.astype(np.float64)
    q /= np.maximum(np.linalg.norm(q, axis=2, keepdims=True), 1e-12)
    qt = q.shape[1]
    flat_q = q.reshape(-1, q.shape[2])
    n = sum(rows for _, rows in segment_rows(reader))
    out = np.empty((len(q), n))
    for dseg, s, (first, rows) in zip(reader.segments, pack.segs,
                                      segment_rows(reader)):
        col = dseg.seg.mvector_fields["tok"]
        t = col.vecs.shape[1]
        for lo in range(0, rows, chunk):
            hi = min(lo + chunk, rows)
            if int8:
                v = s["vecs"][lo:hi].cpu().numpy().astype(np.float64) \
                    * s["scale"] + s["offset"]
            else:
                v = col.vecs[lo:hi].astype(np.float64)
                v /= np.maximum(np.linalg.norm(v, axis=2, keepdims=True),
                                1e-12)
            sim = (v.reshape(-1, v.shape[2]) @ flat_q.T).reshape(
                hi - lo, t, len(q), qt)
            pad = np.arange(t)[None, :] >= col.lens[lo:hi, None]
            sim[pad] = -np.inf
            out[:, first + lo:first + hi] = sim.max(axis=1).sum(axis=2).T
    return out


def phase_maxsim(torch, args, mdata, name, smi_line) -> tuple[dict, dict]:
    """rank_vectors MaxSim batches through query_phase_batch, f32 tokens then
    int8, the first queries against float64 MaxSim."""
    from elasticsearch_tpu_torch.search import segment_exec
    for index in (None, INT8_INDEX):      # set-up, untimed, as for config 4
        t0 = time.perf_counter()
        cfg = segment_exec.knn_plane_config(index)
        segment_exec.vector_pack_for(mdata["reader"], "tok", cfg)
        torch.cuda.synchronize()
        log(f"MaxSim: the {cfg.quantization} token column's set-up and "
            f"upload took {time.perf_counter() - t0:.2f} s")
    batches = batches_of(args, maxsim_bodies(mdata["queries"]))
    out = []
    for label, searcher, int8 in (
            ("MaxSim (rank_vectors, f32)", mdata["searcher"], False),
            ("MaxSim (rank_vectors, int8)", mdata["searcher_int8"], True)):
        results, per_batch, wall, launches, peak = drive(torch, searcher,
                                                         batches)
        k5, other = ("maxsim_int8", "maxsim") if int8 \
            else ("maxsim", "maxsim_int8")
        stats = report(label, args, mdata, batches, per_batch, wall,
                       launches, peak, name, smi_line, (k5, "stable_topk"))
        check(launches[other] == 0,
              f"{label}: K5's {other} instantiation ran {launches[other]} "
              f"times on the {k5} path")
        nq = MAXSIM_CHECK_QUERIES
        t0 = time.perf_counter()
        pack = segment_exec.vector_pack_for(
            mdata["reader"], "tok",
            segment_exec.knn_plane_config(INT8_INDEX if int8 else None))
        s64 = maxsim64(mdata["reader"], pack, mdata["queries"][:nq], int8)
        recall = check_vs_cpu(
            label, args, results[0][:nq], s64,
            [np.ones(s64.shape[1], bool)] * nq, gid_to_orig(mdata["reader"]),
            k=KNN_K, rtol=0, atol=1e-4)
        log(f"{label}: first {nq} queries vs float64 MaxSim "
            f"({time.perf_counter() - t0:.1f} s): totals exact, scores "
            f"within 1e-4, tie-tolerant recall@{KNN_K} = {recall}")
        out.append(stats)
    return out[0], out[1]


# --------------------------------------------------------------------------
# the impact lane: quantized eager impacts (K6), the block-max sweep (K7) and
# the impact -> rescore arm, on config 1's reader
# --------------------------------------------------------------------------

# bench.py's impact_pruning leg at 16 bits (bench.py:1757). 8192-row blocks:
# the block table of a 2^20-row segment over the 500,000-term dictionary
# stays within IMPACT_BLOCK_BUDGET = 2^26 cells (128 blocks); at the default
# 2048 rows it would not (512 blocks) and pruning would decline
IMPACT_INDEX = "smoke_impact"
IMPACT_SETTINGS = {"index.search.impact_plane": True,
                   "index.search.impact.bits": 16,
                   "index.search.impact.block_rows": 8192}
# the impact_pruning leg's requests (bench.py:1746-1765): 3 terms with df
# in [2e-5 N, 2e-4 N], size 10, batches of 32, 4 batches
PRUNED_TERMS, PRUNED_K, PRUNED_BATCH, PRUNED_BATCHES = 3, 10, 32, 4
# the planner_fusion leg's requests (bench.py:2207-2218): a 2-term match
# rescored by a 2-term match, window 24, weights 1.0 and 1.5, total;
# size 10, two batches of 16
RESCORE_WINDOW, RESCORE_QW, RESCORE_RW = 24, 1.0, 1.5
RESCORE_BATCH, RESCORE_BATCHES = 16, 2


def phase_impact_setup(torch, args, data) -> None:
    """Register the impact index, build its pack (the host quantization of
    both segments and their upload: set-up, timed apart) and draw the
    pruned and rescore phases' requests from child generators."""
    from elasticsearch_tpu_torch.search import segment_exec
    from elasticsearch_tpu_torch.search.phase import ShardSearcher
    reader = data["reader"]
    segment_exec.configure_impact_plane(IMPACT_INDEX, IMPACT_SETTINGS)
    searcher = ShardSearcher(0, reader, data["mapper"],
                             index_name=IMPACT_INDEX)
    cfg = segment_exec.impact_plane_config(IMPACT_INDEX)
    t0 = time.perf_counter()
    pack = segment_exec.impact_pack_for(reader, "body", cfg,
                                        k1=searcher.ctx.bm25.k1,
                                        b=searcher.ctx.bm25.b)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(pack is not None and pack.can_prune,
          "the impact pack has no block tables: pruning would decline")
    tables = sum(nbytes(s["block_max"]) for s in pack.segs)
    qimp = sum(nbytes(s["qimp"]) for s in pack.segs)
    log(f"impact: {len(pack.segs)} segment(s), V = "
        f"{[int(s['block_max'].shape[1]) for s in pack.segs]}, n_blocks = "
        f"{[s['n_blocks'] for s in pack.segs]} of {cfg.block_rows} rows, "
        f"block tables {tables} B, qimp {qimp} B ({cfg.bits}-bit), scales "
        f"{[s['scale'] for s in pack.segs]}, bound_per_term "
        f"{pack.bound_per_term}; host quantization and upload {setup_s:.2f} "
        f"s (set-up, untimed); {reader_bytes(reader)}; host memory: "
        f"{host_memory()}")
    n_docs, df = len(data["lens"]), data["df"]
    lo_df = max(2, int(2e-5 * n_docs))
    hi_df = max(lo_df + 2, int(2e-4 * n_docs))
    cand = np.nonzero((df >= lo_df) & (df <= hi_df))[0]
    if cand.size < PRUNED_TERMS:            # as bench.py falls back
        cand = np.nonzero(df > 0)[0]
    data.update(
        impact_searcher=searcher, impact_pack=pack,
        q_pruned=np.random.default_rng([args.seed, 7]).choice(
            cand, size=(PRUNED_BATCHES * PRUNED_BATCH, PRUNED_TERMS)).astype(
                np.int32),
        q_rescore=make_queries(np.random.default_rng([args.seed, 8]),
                               RESCORE_BATCHES * RESCORE_BATCH, 4, df),
        impact_df_band=(lo_df, hi_df))


def impact_inputs(torch, data, rows):
    """A batch's per-segment term ids, boosts (1.0) and no cursor, as the
    lane makes them, from corpus term-id rows."""
    from elasticsearch_tpu_torch.search import segment_exec
    pack = data["impact_pack"]
    names = data["term_names"]
    term_lists = [[names[t] for t in row] for row in rows]
    return segment_exec._impact_query_inputs(
        pack, term_lists, [1.0] * len(rows), [None] * len(rows),
        pack.scales.device)


def scan_bytes(torch, uterms, tids) -> int:
    """Bytes a row scan must read: each row's term ids up to its first pad
    (one pad cell past the last term), and the 2-byte impact of every cell
    holding a term of the batch."""
    n, u = uterms.shape
    cells = int(torch.clamp((uterms >= 0).sum(dim=1) + 1, max=u).sum())
    hits = int(torch.isin(uterms, tids[tids >= 0].unique()).sum())
    return cells * 4 + hits * 2


def check_k6(torch, blockmax, a, trailing_pad, what):
    got = blockmax.impact_scores_batch(*a, trailing_pad=trailing_pad)
    want = blockmax.impact_scores_batch_plain(*a)
    torch.cuda.synchronize()
    check(torch.equal(got[1], want[1]), f"K6 valid differs from its plain "
          f"version ({what})")
    check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
          f"K6 scores are not bit-identical to its plain version ({what})")
    return got


def check_k7(torch, blockmax, carry, seg_args, what):
    got = blockmax.blockmax_sweep(carry, *seg_args, trailing_pad=True)
    want = blockmax.blockmax_sweep_plain(carry, *seg_args)
    torch.cuda.synchronize()
    for name, g, w in zip(("top scores", "top docs", "scored", "skipped",
                           "matched"), got, want):
        check(torch.equal(g.view(torch.int32), w.view(torch.int32)),
              f"K7 {name} differ from its plain version ({what})")
    return got


def sweep_args(torch, blockmax, s, qtids, sb, k, cs=None, cd=None):
    """K7's arguments for one segment: the bounds and the sweep order
    (torch ops), no cursor unless given."""
    qtids = qtids.contiguous()
    b = qtids.shape[0]
    dev = qtids.device
    cs = torch.full((b,), float("inf"), device=dev) if cs is None else cs
    cd = torch.full((b,), -1, dtype=torch.int32, device=dev) \
        if cd is None else cd
    ub_i = blockmax.block_bounds(s["block_max"], qtids)
    ub_f, order = blockmax.sweep_order(ub_i, sb)
    return (s["uterms"], s["qimp"], s["live"], ub_i, ub_f, order, qtids, sb,
            cs, cd, k, s["doc_base"])


def sweep_work(torch, s, seg_args, carry, out):
    """The least work of one K7 launch on this run's data. The blocks a
    query scores are the first ``scored`` of its order with ``ub_i > 0``:
    the run test fails for good at the first block whose bound is below θ
    (the order is by descending bound and θ only rises). Bytes: the union
    of the batch's scored blocks, each read once (each row's term ids up to
    its first pad, the impacts and live bytes of its rows that hold a
    batch term), plus the bounds, the order and the carry, read and
    written. Operations: a compare of every scanned cell with each of the
    query's terms, over the (query, block) pairs scored.
    → (bytes, compares, blocks in the union)."""
    uterms = s["uterms"]
    n, u = uterms.shape
    ub_i, ub_f, order, qtids = seg_args[3], seg_args[4], seg_args[5], \
        seg_args[6]
    nb = ub_i.shape[1]
    r = n // nb
    present = torch.gather(ub_i, 1, order.long()) > 0
    n_scored = out[2] - carry[2]
    runs = present & (torch.cumsum(present.int(), dim=1) <=
                      n_scored[:, None])
    check(int(runs.sum()) == int(n_scored.sum()),
          "K7 scored more blocks than its order holds with a bound")
    q_idx, j_idx = torch.nonzero(runs, as_tuple=True)
    blocks = order.long()[q_idx, j_idx]
    cells = torch.clamp((uterms >= 0).sum(dim=1) + 1, max=u)
    hit = torch.isin(uterms, qtids[qtids >= 0].unique())
    per_block = (cells * 4 + hit.sum(dim=1) * 2 + hit.any(dim=1)).view(
        nb, r).sum(dim=1)
    union = blocks.unique()
    n_terms = (qtids >= 0).sum(dim=1)
    ops = int((cells.view(nb, r).sum(dim=1)[blocks] * n_terms[q_idx]).sum())
    small = sum(nbytes(x) for x in (ub_i, ub_f, order, qtids)) + \
        2 * sum(nbytes(x) for x in carry)
    return int(per_block[union].sum()) + small, ops, int(union.numel())


def phase_impact_kernels(torch, args, data) -> list[dict]:
    """K6 and K7 against their plain versions at the shapes the impact
    phases give them and at odd shapes, timed beside the plain versions and
    their bounds."""
    from elasticsearch_tpu_torch.ops import blockmax
    pack = data["impact_pack"]
    s0, s1 = pack.segs[0], pack.segs[-1]
    # ---- K6 at the eager shape: config 1's first batch on segment 0 ------
    qtids, boosts, cs, cd = impact_inputs(torch, data,
                                          data["qtids"][:args.batch])
    sb = pack.scales[0] * boosts
    a6 = (s0["uterms"], s0["qimp"], qtids[0], sb, s0["live"], cs, cd,
          s0["doc_base"])
    got6 = check_k6(torch, blockmax, a6, s0["trailing_pad"],
                    "the eager shape")
    n, u = s0["uterms"].shape
    bsz, t = qtids[0].shape
    k6_ms = timed(torch, "K6", lambda: blockmax.impact_scores_batch(
        *a6, trailing_pad=s0["trailing_pad"]), reps=20)
    k6_plain_ms = timed(torch, "K6 plain",
                        lambda: blockmax.impact_scores_batch_plain(*a6),
                        reps=1, warmup=0)
    k6_bytes = scan_bytes(torch, s0["uterms"], qtids[0]) + \
        nbytes(s0["live"]) + nbytes(got6[0]) + nbytes(got6[1])
    k6_bound, k6_by = bound(k6_bytes, 2 * bsz * n)
    log(f"K6 impact_scan [B={bsz}, N={n}, U={u}, T={t}, 16-bit]: "
        f"bit-identical to plain; kernel_ms={k6_ms:.4f} "
        f"plain_ms={k6_plain_ms:.4f} bound_ms={k6_bound:.4f} ({k6_by}: "
        f"{k6_bytes} B) library_ms=null")
    # ---- K6 at odd shapes: B = 3, N = 100,003, T = 5, 8 and 16 bits ------
    rng = np.random.default_rng([args.seed, 9])
    n_odd = min(n, 100_003)
    dev = qtids[0].device
    o_rows = make_queries(rng, 3, 5, data["df"])
    o_tids = impact_inputs(torch, data, o_rows)[0][0]
    o_tids[1, 4] = -1
    o_tids[2, 3] = o_tids[2, 0]
    zero_t = int(o_tids[0, 0])          # a term whose impacts are all 0
    ut = s0["uterms"][:n_odd]
    q32 = s0["qimp"][:n_odd].to(torch.int32)
    q32[ut == zero_t] = 0
    live = s0["live"][:n_odd].clone()
    live[::7] = False
    o_sb = torch.tensor([0.37, 1.5, 0.02], device=dev) * pack.scales[0]
    inf = torch.full((3,), float("inf"), device=dev)
    none = torch.full((3,), -1, dtype=torch.int32, device=dev)
    for bits, qo in ((16, q32.to(torch.uint16)),
                     (8, (q32 >> 8).to(torch.uint8))):
        sf, valid = blockmax.impact_scores_batch_plain(
            ut, qo, o_tids, o_sb, live, inf, none, s0["doc_base"])
        o_cs, o_cd = inf.clone(), none.clone()
        hits = torch.nonzero(valid[1]).flatten()
        check(hits.numel() > 2, "the odd K6 query has no hits")
        mid = int(hits[hits.numel() // 2])
        o_cs[1], o_cd[1] = sf[1, mid], mid + s0["doc_base"]
        for pad in (True, False):
            check_k6(torch, blockmax, (ut, qo, o_tids, o_sb, live, o_cs,
                                       o_cd, s0["doc_base"]), pad,
                     f"B=3, N={n_odd}, T=5, {bits}-bit, trailing_pad={pad}")
    log(f"K6 impact_scan [B=3, N={n_odd}, T=5]: bit-identical to plain at 8 "
        f"and 16 bits, with and without the first-pad stop, with a term "
        f"whose impacts are all 0, a cursor and dead rows")
    # ---- K7 at the pruned shape: the first pruned batch, both segments ---
    k = PRUNED_K
    p_tids, p_boosts, _, _ = impact_inputs(torch, data,
                                           data["q_pruned"][:PRUNED_BATCH])
    carry = blockmax.pruned_carry_init(PRUNED_BATCH, k, dev)
    seg_args = [sweep_args(torch, blockmax, s, p_tids[i],
                           pack.scales[i] * p_boosts, k)
                for i, s in enumerate(pack.segs)]
    first = check_k7(torch, blockmax, carry, seg_args[0],
                     "the pruned shape, segment 0")
    out = check_k7(torch, blockmax, first, seg_args[-1],
                   "the pruned shape, a carry from segment 0")
    scored0 = int(first[2].sum())
    k7_ms = timed(torch, "K7", lambda: blockmax.blockmax_sweep(
        carry, *seg_args[0], trailing_pad=True), reps=10)
    k7_plain_ms = timed(torch, "K7 plain", lambda: blockmax.blockmax_sweep_plain(
        carry, *seg_args[0]), reps=1, warmup=0)
    # the launch lasts as long as its longest sweep: the query that scores
    # the most blocks, timed alone
    per_q = sorted(first[2].tolist())
    heavy = int(torch.argmax(first[2]))
    alone = tuple(x[heavy:heavy + 1] if 3 <= i <= 9 else x
                  for i, x in enumerate(seg_args[0]))
    carry1 = blockmax.pruned_carry_init(1, k, dev)
    k7_heavy_ms = timed(torch, "K7 heaviest query alone",
                        lambda: blockmax.blockmax_sweep(
                            carry1, *alone, trailing_pad=True), reps=10)
    n_blocks = s0["n_blocks"]
    k7_bytes, k7_ops, union = sweep_work(torch, s0, seg_args[0], carry,
                                         first)
    k7_bound, k7_by = bound(k7_bytes, k7_ops)
    log(f"K7 blockmax_sweep [B={PRUNED_BATCH}, N={n}, {n_blocks} blocks of "
        f"{n // n_blocks} rows, T={PRUNED_TERMS}, k={k}]: equal to plain "
        f"(top-k, scored, skipped, matched), segment 0 and with its carry "
        f"into segment {len(pack.segs) - 1}; segment 0 scored {scored0} and "
        f"skipped {int(first[3].sum())} blocks of {PRUNED_BATCH * n_blocks} "
        f"(a query: min {per_q[0]}, median {per_q[len(per_q) // 2]}, max "
        f"{per_q[-1]}; the max alone {k7_heavy_ms:.4f} ms); "
        f"kernel_ms={k7_ms:.4f} plain_ms={k7_plain_ms:.4f} "
        f"bound_ms={k7_bound:.4f} ({k7_by}: {k7_bytes} B and {k7_ops} "
        f"compares over the {union} distinct blocks some query scored) "
        f"library_ms=null")
    # ---- K7 at odd shapes ----------------------------------------------
    one = [sweep_args(torch, blockmax, s, p_tids[i][:, :1],
                      pack.scales[i] * p_boosts, 1000)
           for i, s in enumerate(pack.segs)]
    wide = check_k7(torch, blockmax, blockmax.pruned_carry_init(
        PRUNED_BATCH, 1000, dev), one[0], "k = 1000, one rare term a query")
    check_k7(torch, blockmax, wide, one[-1], "k = 1000 with a carry")
    check(bool((wide[1][:, -1] == -1).all()),
          "the k above the matches case has a full top-k")
    check_k7(torch, blockmax, blockmax.pruned_carry_init(PRUNED_BATCH, 1,
                                                         dev),
             sweep_args(torch, blockmax, s0, p_tids[0],
                        pack.scales[0] * p_boosts, 1), "k = 1")
    high = (torch.full((PRUNED_BATCH, k), 1e9, device=dev), out[1].clone(),
            out[2].clone(), out[3].clone(), out[4].clone())
    skip = check_k7(torch, blockmax, high, seg_args[0], "every block skipped")
    check(bool((skip[3] - high[3] == n_blocks).all()),
          "a carry no block can reach did not skip every block")
    log(f"K7 blockmax_sweep odd shapes: equal to plain at k = 1000 over one "
        f"rare term (above every query's matches) with a carry, k = 1, and "
        f"a carry that skips every block")
    return [
        {"name": "impact_scan", "route": "cuda", "source": K6_SOURCE,
         "replaces": K6_REPLACES, "launches": 0, "max_abs_err": 0.0,
         "ms": k6_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound,
         "bound_by": k6_by, "library_ms": None,
         "library_null": "no single torch call: a compare of every cell "
                         "with the query terms, then a masked integer sum",
         "shape": {"B": bsz, "N": n, "U": u, "T": t, "bits": 16}},
        {"name": "blockmax_sweep", "route": "cuda", "source": K7_SOURCE,
         "replaces": K7_REPLACES, "launches": 0, "max_abs_err": 0.0,
         "ms": k7_ms, "plain_ms": k7_plain_ms, "bound_ms": k7_bound,
         "bound_by": k7_by, "library_ms": None,
         "library_null": "no single torch call: a data-dependent sweep "
                         "whose block skips read the running k-th score",
         "shape": {"B": PRUNED_BATCH, "N": n, "blocks": n_blocks,
                   "T": PRUNED_TERMS, "k": k, "blocks_scored": scored0,
                   "blocks_union": union,
                   "blocks_a_query": [per_q[0], per_q[len(per_q) // 2],
                                      per_q[-1]],
                   "heaviest_alone_ms": k7_heavy_ms}},
    ]


def impact_postings(uterms, qimp, wanted):
    """{term: (rows, impacts)} of one segment for each term of ``wanted``,
    gathered in one pass over its forward columns."""
    wanted = np.unique(wanted)
    queried = np.zeros(max(int(uterms.max()), int(wanted.max())) + 2, bool)
    queried[wanted] = True
    rows, cols = np.nonzero(queried[uterms])
    t = uterms[rows, cols]
    q = qimp[rows, cols].astype(np.int64)
    order = np.argsort(t, kind="stable")
    t, rows, q = t[order], rows[order], q[order]
    starts = np.searchsorted(t, wanted)
    ends = np.searchsorted(t, wanted, side="right")
    return {int(w): (rows[s:e], q[s:e]) for w, s, e in zip(wanted, starts,
                                                          ends)}


def segment_postings(data, rows):
    """[(pack segment, its real rows, impact postings of the terms of
    ``rows``)] — the host impacts are the pack's columns, the term ids the
    corpus's (every segment holds the whole dictionary; segments are full
    2^20-row ones but the last, so a segment's base is its first corpus
    row)."""
    out = []
    for s in data["impact_pack"].segs:
        lo = s["doc_base"]
        ut = data["uterms"][lo:lo + s["np_docs"]]
        out.append((s, ut.shape[0], impact_postings(
            ut, s["col"].qimp[:ut.shape[0]], np.asarray(rows).reshape(-1))))
    return out


def impact_oracle(data, rows, k):
    """An independent numpy recompute of the eager arm for each query (corpus
    term-id rows, boost 1): per segment the integer sum of the host column's
    impacts of the query's terms, ``f32(qsum) * (f32(scale) * f32(1.0))``,
    the match mask; the top k by (score desc, doc asc) over global ids.
    → [(global ids, f32 scores, total)]."""
    seg_post = segment_postings(data, rows)
    out = []
    for row in rows:
        sc, gid, total = [], [], 0
        for s, nr, post in seg_post:
            qsum = np.zeros(nr, np.int64)
            hit = np.zeros(nr, bool)
            for term in row:
                r_, q_ = post[int(term)]
                qsum[r_] += q_
                hit[r_] = True
            sb = np.float32(np.float32(s["scale"]) * np.float32(1.0))
            sf = qsum.astype(np.float32) * sb
            d = np.nonzero(hit)[0]
            total += d.size
            sc.append(sf[d])
            gid.append(d + s["doc_base"])
        sc, gid = np.concatenate(sc), np.concatenate(gid)
        top = np.lexsort((gid, -sc))[:k]
        out.append((gid[top], sc[top], total))
    return out


def check_impact_exact(label, results, oracle):
    for qi, (res, (ids, scores, total)) in enumerate(zip(results, oracle)):
        check(res.total == total, f"{label} query {qi}: total {res.total} "
              f"!= the recompute's {total}")
        check(np.array_equal(res.doc_ids, ids),
              f"{label} query {qi}: ids differ from the numpy recompute")
        check(np.array_equal(res.scores.view(np.int32),
                             scores.astype(np.float32).view(np.int32)),
              f"{label} query {qi}: scores are not bit-equal to the numpy "
              f"recompute")


def impact_bodies(data, rows, size, **extra):
    names = data["term_names"]
    return [{"query": {"match": {"body": " ".join(names[t] for t in row)}},
             "size": size, **extra} for row in rows]


def phase_impact_eager(torch, args, data, name, smi_line) -> dict:
    """Config 1's requests on the impact index: the eager arm (K6 + K2)."""
    searcher, pack = data["impact_searcher"], data["impact_pack"]
    batches = batches_of(args, impact_bodies(
        data, data["qtids"][:args.batches * args.batch], args.k))
    results, per_batch, wall, launches, peak = drive(torch, searcher,
                                                     batches)
    stats = report("impact eager", args, data, batches, per_batch, wall,
                   launches, peak, name, smi_line,
                   ("impact_scan", "stable_topk"))
    check(launches["blockmax_sweep"] == 0 and launches["bm25_scan"] == 0,
          "the eager impact arm launched K7 or K1")
    nq = CHECK_QUERIES
    t0 = time.perf_counter()
    oracle = impact_oracle(data, data["qtids"][:nq], args.k)
    check_impact_exact("impact eager", results[0][:nq], oracle)
    # against the float64 BM25: exact totals, every hit within the
    # quantization bound, a top-k member up to it (bench.py:1851-1877)
    cpu = cpu_scores(data["uterms"], data["utf"], data["lens"], data["df"],
                     data["qtids"][:nq])
    orig_of = gid_to_orig(data["reader"])
    tol = pack.bound_per_term * args.terms + 1e-4
    worst = 0.0
    for qi, (res, s64) in enumerate(zip(results[0][:nq], cpu)):
        matched = s64 > 0
        check(res.total == int(matched.sum()), f"impact eager query {qi}: "
              f"total {res.total} != CPU matches {int(matched.sum())}")
        orig = orig_of[np.asarray(res.doc_ids, np.int64)]
        dev = np.abs(res.scores.astype(np.float64) - s64[orig])
        worst = max(worst, float(dev.max()) if dev.size else 0.0)
        check(bool((dev <= tol).all()), f"impact eager query {qi}: a hit "
              f"is {dev.max()} from its BM25 score, above {tol}")
        kk = min(args.k, int(matched.sum()))
        kth = np.partition(np.where(matched, s64, -np.inf), -kk)[-kk]
        check(bool((s64[orig] >= kth - tol).all()), f"impact eager query "
              f"{qi}: a hit is not a top-{args.k} member up to the bound")
    log(f"impact eager: first {nq} queries bit-equal to a numpy recompute "
        f"from the host impacts (ids, scores, totals); totals equal to the "
        f"float64 match counts; every hit within {worst:.6f} of its float64 "
        f"BM25 (bound {tol:.6f}) and a top-{args.k} member up to it "
        f"({time.perf_counter() - t0:.1f} s)")
    return stats


def phase_impact_pruned(torch, args, data, name, smi_line) -> dict:
    """bench.py's impact_pruning requests: the block-max sweep (K7), held
    bit for bit against the eager arm on the same requests with totals
    tracked, its block counters reconciled batch by batch."""
    from elasticsearch_tpu_torch.search import segment_exec
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    searcher, pack = data["impact_searcher"], data["impact_pack"]
    rows = data["q_pruned"]

    def batches(**extra):
        reqs = [parse_search_request(b) for b in impact_bodies(
            data, rows, PRUNED_K, **extra)]
        return [reqs[i:i + PRUNED_BATCH]
                for i in range(0, len(reqs), PRUNED_BATCH)]
    pruned_b = batches(track_total_hits=False)
    results, per_batch, wall, launches, peak = drive(torch, searcher,
                                                     pruned_b)
    stats = report("impact pruned", args, data, pruned_b, per_batch, wall,
                   launches, peak, name, smi_line, ("blockmax_sweep",))
    check(launches["impact_scan"] == 0 and launches["bm25_scan"] == 0,
          "the pruned impact arm launched K6 or K1")
    eager_b = batches()
    eager, per_eager, _, launches_e, _ = drive(torch, searcher, eager_b)
    check(launches_e["impact_scan"] > 0 and launches_e["blockmax_sweep"] == 0,
          "the eager arm on the pruned requests did not take K6")
    for bi, (pr, ea) in enumerate(zip(results, eager)):
        for qi, (p, e) in enumerate(zip(pr, ea)):
            check(np.array_equal(p.doc_ids, e.doc_ids) and np.array_equal(
                p.scores.view(np.int32), e.scores.view(np.int32)),
                f"impact pruned batch {bi} query {qi}: not bit-identical "
                f"to the eager arm")
    scored = skipped = 0
    for bi, batch in enumerate(pruned_b):
        st0 = segment_exec.impact_index_stats(IMPACT_INDEX)
        check(searcher.query_phase_batch(batch) is not None,
              "the pruned batch declined")
        st1 = segment_exec.impact_index_stats(IMPACT_INDEX)
        d_sc = st1["blocks_scored"] - st0["blocks_scored"]
        d_sk = st1["blocks_skipped"] - st0["blocks_skipped"]
        check(d_sc + d_sk == len(batch) * pack.total_blocks,
              f"impact pruned batch {bi}: scored {d_sc} + skipped {d_sk} "
              f"!= {len(batch)} x {pack.total_blocks} blocks")
        scored += d_sc
        skipped += d_sk
    n_docs, df = len(data["lens"]), data["df"]
    r = n_docs // pack.total_blocks
    p_t = 1.0 - (1.0 - df[rows].astype(np.float64) / n_docs) ** r
    pred_occ = float(np.mean(1.0 - np.prod(1.0 - p_t, axis=1)))
    stats.update(skip_ratio=skipped / (scored + skipped),
                 predicted_occupied_frac=pred_occ,
                 eager_p50_ms=statistics.median(per_eager))
    log(f"impact pruned: {PRUNED_BATCHES} batches of {PRUNED_BATCH} x "
        f"{PRUNED_TERMS} terms with df in {data['impact_df_band']}, k = "
        f"{PRUNED_K}: top-k bit-identical to the eager arm; blocks scored "
        f"{scored} + skipped {skipped} = batch x {pack.total_blocks} in "
        f"every batch; skip ratio {stats['skip_ratio']:.4f}, bench.py's "
        f"predicted_occupied_frac {pred_occ:.4f}; ms a batch: pruned p50 "
        f"{stats['p50_ms']:.3f} (batches {', '.join(f'{x:.3f}' for x in per_batch)}),"
        f" eager p50 {stats['eager_p50_ms']:.3f} (batches "
        f"{', '.join(f'{x:.3f}' for x in per_eager)})")
    return stats


def rescore_oracle(data, rows, size):
    """The rescore arm recomputed in numpy: the eager oracle's top
    max(size, window) by the first two terms, each candidate's impact sum
    of the last two in its segment, the window combine in the JAX body's
    f32 order and the window re-sort; cut to ``size``."""
    prim = impact_oracle(data, [r[:2] for r in rows],
                         max(size, RESCORE_WINDOW))
    sec_post = segment_postings(data, [r[2:] for r in rows])
    qw, rw = np.float32(RESCORE_QW), np.float32(RESCORE_RW)
    out = []
    for row, (ids, s, total) in zip(rows, prim):
        sec = np.zeros(len(ids), np.float32)
        hit = np.zeros(len(ids), bool)
        for s_, nr, post in sec_post:
            local = ids - s_["doc_base"]
            inside = (local >= 0) & (local < nr)
            qsum = np.zeros(len(ids), np.int64)
            h = np.zeros(len(ids), bool)
            for term in row[2:]:
                r_, q_ = post[int(term)]        # rows ascending
                if not r_.size:
                    continue
                pos = np.minimum(np.searchsorted(r_, local), r_.size - 1)
                found = inside & (r_[pos] == local)
                qsum[found] += q_[pos[found]]
                h |= found
            sb = np.float32(np.float32(s_["scale"]) * np.float32(1.0))
            sec = sec + np.where(inside, qsum.astype(np.float32) * sb,
                                 np.float32(0.0)).astype(np.float32)
            hit |= h & inside
        w = min(RESCORE_WINDOW, len(ids))
        prim_s = (s * qw).astype(np.float32)
        comb = np.where(hit, (prim_s + (sec * rw).astype(np.float32))
                        .astype(np.float32), prim_s)
        new_w = comb[:w]
        order = np.lexsort((ids[:w], -new_w))
        new_ids = np.concatenate([ids[:w][order], ids[w:]])
        new_s = np.concatenate([new_w[order], s[w:]]).astype(np.float32)
        out.append((new_ids[:size], new_s[:size], total))
    return out


def phase_impact_rescore(torch, args, data, name, smi_line) -> dict:
    """bench.py's planner_fusion request shape on this corpus: the impact ->
    rescore arm, held bit for bit against a numpy recompute."""
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    names = data["term_names"]
    rows = data["q_rescore"]
    size = 10
    bodies = [{"query": {"match": {"body": f"{names[r[0]]} {names[r[1]]}"}},
               "size": size,
               "rescore": {"window_size": RESCORE_WINDOW, "query": {
                   "rescore_query": {"match": {
                       "body": f"{names[r[2]]} {names[r[3]]}"}},
                   "query_weight": RESCORE_QW,
                   "rescore_query_weight": RESCORE_RW,
                   "score_mode": "total"}}} for r in rows]
    reqs = [parse_search_request(b) for b in bodies]
    batches = [reqs[i:i + RESCORE_BATCH]
               for i in range(0, len(reqs), RESCORE_BATCH)]
    results, per_batch, wall, launches, peak = drive(
        torch, data["impact_searcher"], batches)
    stats = report("impact rescore", args, data, batches, per_batch, wall,
                   launches, peak, name, smi_line,
                   ("impact_scan", "stable_topk"))
    check(launches["blockmax_sweep"] == 0 and launches["bm25_scan"] == 0,
          "the rescore arm launched K7 or K1")
    t0 = time.perf_counter()
    want = rescore_oracle(data, rows, size)
    check_impact_exact("impact rescore", [r for b in results for r in b],
                       want)
    log(f"impact rescore: {len(rows)} requests (window {RESCORE_WINDOW}, "
        f"weights {RESCORE_QW} / {RESCORE_RW}, total) bit-equal to a numpy "
        f"recompute: the eager top-{max(size, RESCORE_WINDOW)}, the "
        f"secondary impact sums, the f32 window combine and re-sort "
        f"({time.perf_counter() - t0:.1f} s)")
    return stats


def impact_plan(torch, data, pruned: bool):
    """The impact lane's host planning of a batch: the eligibility screen
    (impact_terms), the per-segment term ids and constants, and for the
    sweep the block bounds and the order (device work, synchronized)."""
    from elasticsearch_tpu_torch.ops import blockmax
    from elasticsearch_tpu_torch.search import segment_exec
    from elasticsearch_tpu_torch.search.execute import impact_terms
    searcher, pack = data["impact_searcher"], data["impact_pack"]

    def plan(batch):
        specs = [impact_terms(r.query, searcher.mapper_service)
                 for r in batch]
        qtids, boosts, _, _ = segment_exec._impact_query_inputs(
            pack, [s[1] for s in specs], [s[2] for s in specs],
            [None] * len(batch), pack.scales.device)
        if pruned:
            for i, s in enumerate(pack.segs):
                ub_i = blockmax.block_bounds(s["block_max"], qtids[i])
                blockmax.sweep_order(ub_i, pack.scales[i] * boosts)
        torch.cuda.synchronize()
    return plan


# --------------------------------------------------------------------------
# BASELINE config 5: 8-shard query_then_fetch through the coordinator, with
# aggregations (K8, K9), and a page past one block's k (K2)
# --------------------------------------------------------------------------

def release_lane_state(torch, data, mdata) -> None:
    """Drop the MaxSim index and the impact lane's device columns before the
    8-shard corpus goes on the card, so it holds one extra corpus copy at
    most."""
    mdata.clear()
    for key in ("impact_searcher", "impact_pack"):
        data.pop(key, None)
    for seg in data["reader"].segments:
        seg.impacts.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"released the MaxSim index and the impact columns: "
        f"{torch.cuda.memory_allocated()} B allocated on the card; "
        f"{reader_bytes(data['reader'])}")


def phase_config5_setup(torch, args, data) -> dict:
    """bench.py's config-5 corpus (bench.py:1116-1210): the smoke's corpus
    cut into 8 contiguous single-segment shards, one Engine and
    ShardSearcher a shard, each segment with the ``rank`` column and
    bench.py's ``cat`` keyword column (16 values from a generator of its
    own, bench.py:552-554); then the float64 scoring of the checked
    requests on every shard with the shard's own df and avgdl
    (query_then_fetch: no DFS)."""
    from elasticsearch_tpu_torch.index.device_reader import (
        dd_split, device_reader_for)
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.index.segment import (
        KeywordFieldColumn, NumericFieldColumn, Segment, doc_count_bucket)
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search.phase import ShardSearcher
    import tempfile
    n_docs = len(data["lens"])
    per_shard = -(-n_docs // C5_SHARDS)
    cat = np.random.default_rng(4242).integers(0, 16, n_docs).astype(
        np.int32)
    ms = MapperService()
    ms.merge("_doc", {"properties": {
        "body": {"type": "text", "analyzer": "whitespace"},
        "rank": {"type": "double"}, "cat": {"type": "keyword"}}})
    t0 = time.perf_counter()
    shards = []
    for si in range(C5_SHARDS):
        lo = si * per_shard
        hi = min(lo + per_shard, n_docs)
        rows = hi - lo
        np_rows = doc_count_bucket(rows)

        def spad(a, fill):
            out = np.full((np_rows,) + a.shape[1:], fill, a.dtype)
            out[:rows] = a[lo:hi]
            return out
        sut = data["uterms"][lo:hi]
        seg_df = np.zeros(len(data["df"]), np.int64)
        np.add.at(seg_df, sut[sut >= 0], 1)
        seg = Segment.from_packed_text(
            0, "body", terms=data["term_names"], tokens=None,
            uterms=spad(data["uterms"], -1), utf=spad(data["utf"], 0.0),
            doc_len=spad(data["lens"], 0), df=seg_df, num_docs=rows,
            ids=[str(lo + i) for i in range(rows)] + [""] * (np_rows - rows))
        seg.numeric_fields["rank"] = NumericFieldColumn(
            values=spad(data["rank"], 0.0),
            exists=spad(np.ones(n_docs, bool), False))
        seg.keyword_fields["cat"] = KeywordFieldColumn(
            vocab=list(C5_CATS), ords=spad(cat[:, None], -1))
        eng = Engine(Path(tempfile.mkdtemp(prefix="chip_smoke_s5_")), ms)
        eng.install_segment(seg, track_versions=False)
        shards.append({"lo": lo, "hi": hi, "df": seg_df, "engine": eng,
                       "searcher": ShardSearcher(
                           si, device_reader_for(eng), ms)})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = data["qtids"][:C5_CHECK]
    cpu = [cpu_scores(data["uterms"][sh["lo"]:sh["hi"]],
                      data["utf"][sh["lo"]:sh["hi"]],
                      data["lens"][sh["lo"]:sh["hi"]], sh["df"], rows)
           for sh in shards]
    rank_hi, rank_lo = dd_split(data["rank"])
    log(f"config 5: {C5_SHARDS} single-segment shards of {per_shard} docs "
        f"(cat: {len(C5_CATS)} values) packed on the card in {setup_s:.1f} "
        f"s; shard 0 {reader_bytes(shards[0]['searcher'].reader)}; "
        f"{torch.cuda.memory_allocated()} B allocated on the card; float64 "
        f"per-shard scoring of {C5_CHECK} requests in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"shards": shards, "per_shard": per_shard, "cat": cat,
            "pool": ThreadPoolExecutor(C5_SHARDS),
            # per checked request, per shard: (float64 scores, matched)
            "cpu": [[(c[qi], c[qi] > 0) for c in cpu]
                    for qi in range(len(rows))],
            "rank": data["rank"], "rank_hi": rank_hi, "rank_lo": rank_lo}


def c5_searchers(c5):
    return [s["searcher"] for s in c5["shards"]]


def c5_reqs(data, n, **body):
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    return [parse_search_request({"query": {"match": {"body": t}}, **body})
            for t in data["texts"][:n]]


def c5_batch(c5, batch):
    """One batch through config 5: every shard's query phase, the shards run
    concurrently as bench.py runs them (a thread pool; without aggs the
    batched arm, with aggs query_phase one request at a time, as the
    reference serves aggs), then per request the coordinator's
    merge_responses (sort_docs, the fetch phase on the shards owning the
    page, the aggregation reduce). → (responses, host merge ms)."""
    from elasticsearch_tpu_torch.search.controller import merge_responses
    searchers = c5_searchers(c5)
    if batch[0].aggs:
        per_shard = list(c5["pool"].map(
            lambda s: [s.query_phase(r) for r in batch], searchers))
    else:
        per_shard = list(c5["pool"].map(
            lambda s: s.query_phase_batch(batch), searchers))
    check(all(r is not None for r in per_shard),
          "a config-5 shard declined the batch")
    t0 = time.perf_counter()
    out = [merge_responses("msmarco", req, [r[qi] for r in per_shard],
                           searchers, 0.0, req.aggs)
           for qi, req in enumerate(batch)]
    return out, (time.perf_counter() - t0) * 1e3


def c5_drive(torch, c5, batches):
    """Every launch counter set to 0, the batches through c5_batch, the
    counters read just after. → (responses, batch ms, merge ms, wall s,
    launches)."""
    counters = path_kernels()
    torch.cuda.synchronize()
    GC.take()
    for kern in counters.values():
        kern.launches = 0
    results, per_batch, merge_ms = [], [], []
    t_all = time.perf_counter()
    for batch in batches:
        t0 = time.perf_counter()
        out, m_ms = c5_batch(c5, batch)
        per_batch.append((time.perf_counter() - t0) * 1e3)
        merge_ms.append(m_ms)
        results.append(out)
    wall = time.perf_counter() - t_all
    launches = {name: kern.launches for name, kern in counters.items()}
    return results, per_batch, merge_ms, wall, launches


def check_c5_page(label, c5, resp, qi, frm, size, k_shard, tol=1e-5):
    """A merged page against the float64 per-shard scoring of request
    ``qi``: each shard's top ``k_shard`` by (score desc, position asc),
    merged by (score desc, shard asc, position asc) — the _hit_comparator
    order — and cut to [frm, frm + size). Totals exact, every hit within
    ``tol`` of its float64 score, the page's scores within ``tol`` of the
    float64 page's, and tie-tolerant recall 1.0: a hit outside the float64
    page counts when its float64 score equals a boundary score of that
    page within ``tol``. → recall."""
    per_shard = c5["cpu"][qi]
    total = int(sum(m.sum() for _, m in per_shard))
    check(resp["hits"]["total"] == total,
          f"{label} request {qi}: total {resp['hits']['total']} != float64 "
          f"matches {total}")
    cand = []
    for si, (s64, m64) in enumerate(per_shard):
        idx = np.nonzero(m64)[0]
        idx = idx[np.lexsort((idx, -s64[idx]))][:k_shard]
        cand.extend((-s64[row], si, pos, row) for pos, row in enumerate(idx))
    cand.sort()
    page = cand[frm:frm + size]
    hits = resp["hits"]["hits"]
    check(len(hits) == len(page), f"{label} request {qi}: {len(hits)} hits "
          f"on the page, float64 {len(page)}")
    if not page:
        return 1.0
    want = np.array([-c[0] for c in page])
    got = np.array([h["_score"] for h in hits])
    check(np.allclose(got, want, rtol=tol, atol=tol),
          f"{label} request {qi}: page scores disagree with the float64 page")
    page_rows = {(c[1], c[3]) for c in page}
    ok = 0
    for h, score in zip(hits, got):
        si, row = divmod(int(h["_id"]), c5["per_shard"])
        s64 = per_shard[si][0][row]
        check(abs(s64 - score) <= tol + tol * abs(s64),
              f"{label} request {qi}: hit {h['_id']} scores {score}, float64 "
              f"{s64}")
        ok += (si, row) in page_rows or abs(s64 - want.min()) <= tol or \
            abs(s64 - want.max()) <= tol
    recall = ok / len(hits)
    check(recall == 1.0, f"{label} request {qi}: tie-tolerant page recall "
          f"{recall}")
    return recall


def agg_inputs(torch, data, c5):
    """Shard 0's columns and one request's pre-post_filter mask, as the
    device collect gets them."""
    from elasticsearch_tpu_torch.search import query_dsl, segment_exec
    searcher = c5["shards"][0]["searcher"]
    seg = searcher.reader.segments[0]
    query = query_dsl.parse_query({"match": {"body": data["texts"][0]}})
    mask = segment_exec.run_segment(seg, searcher.ctx, query, k=10,
                                    want_arrays=True)["agg_mask"]
    col = seg.numeric["rank"]
    return seg.keyword["cat"].ords, mask, col.hi, col.lo, col.exists


def dd_cuda(torch, values, dev):
    from elasticsearch_tpu_torch.index.device_reader import dd_split
    hi, lo = dd_split(values)
    return torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)


def histogram_base(row, interval):
    """_d_histogram_common's base bucket and bucket count from a K9 row."""
    from elasticsearch_tpu_torch.index.device_reader import dd_split
    first = np.floor((row[1] + row[2]) / interval)
    last = np.floor((row[3] + row[4]) / interval)
    bhi, blo = dd_split(np.float64(first * interval))
    return float(bhi), float(blo), int(last - first + 1)


def check_k8(torch, got, want, what):
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K8 counts differ from the plain "
          f"version ({what})")


def check_k9(torch, aggs_ops, args, what):
    """K9 twice (the same bits both runs) against its plain version: count
    and extrema bit-equal, sums within 1e-6 relative → max abs err of the
    sums."""
    got = aggs_ops.dd_stats(*args)
    again = aggs_ops.dd_stats(*args)
    want = aggs_ops.dd_stats_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"K9 gave other bits on a second run "
          f"({what})")
    check(torch.equal(got[:5], want[:5]), f"K9 count or extrema differ from "
          f"the plain version ({what}): {got[:5].tolist()} vs "
          f"{want[:5].tolist()}")
    check(torch.allclose(got[5:], want[5:], rtol=1e-6, atol=0.0),
          f"K9 sums beyond 1e-6 of the plain version ({what}): "
          f"{got[5:].tolist()} vs {want[5:].tolist()}")
    return got, float((got[5:] - want[5:]).abs().max())


def phase_agg_kernels(torch, args, data, c5) -> list[dict]:
    """K8 (three modes) and K9 against their plain versions on one config-5
    shard segment (the cat ordinals, the rank histogram at interval 5, the
    bench-style ranges, under a real request's mask) and at odd shapes, each
    timed beside its plain version, its bound and a library call where one
    computes the same function."""
    from elasticsearch_tpu_torch.ops import aggs_ops
    ords, mask, hi, lo, exists = agg_inputs(torch, data, c5)
    dev = mask.device
    n = mask.shape[0]
    n_mask = int(mask.sum())
    n_ctx = int((mask & exists).sum())

    # ---- K8 ordinal mode: the terms agg over cat --------------------------
    got = aggs_ops.ord_counts(ords, mask, len(C5_CATS))
    check_k8(torch, got, aggs_ops.ord_value_counts(ords, mask, len(C5_CATS)),
             "ordinal, cat")
    sel = ords[:, 0][mask & (ords[:, 0] >= 0)]
    ord_t = {
        "ms": timed(torch, "K8 ordinal", lambda: aggs_ops.ord_counts(
            ords, mask, len(C5_CATS)), reps=100),
        "plain_ms": timed(torch, "K8 ordinal plain",
                          lambda: aggs_ops.ord_value_counts(
                              ords, mask, len(C5_CATS)), reps=20),
        "library_ms": timed(torch, "K8 ordinal torch.bincount (ords masked "
                            "beforehand)", lambda: torch.bincount(
                                sel, minlength=len(C5_CATS)), reps=100)}
    ord_t["bound_ms"], ord_t["bound_by"] = bound(
        n + n_mask * 4 + len(C5_CATS) * 4, n)

    # ---- K9: the extended_stats over rank ---------------------------------
    stats, k9_err = check_k9(torch, aggs_ops, (hi, lo, exists, mask),
                             "rank under the mask")
    k9 = {
        "ms": timed(torch, "K9", lambda: aggs_ops.dd_stats(
            hi, lo, exists, mask), reps=100),
        "plain_ms": timed(torch, "K9 plain", lambda: aggs_ops.dd_stats_plain(
            hi, lo, exists, mask), reps=20)}
    k9["bound_ms"], k9["bound_by"] = bound(n + n_mask + n_ctx * 8 + 64,
                                           6 * n_ctx)

    # ---- K8 histogram mode: rank at interval 5 -----------------------------
    bhi, blo, nb = histogram_base(stats.cpu().numpy(), 5.0)
    h_args = (hi, lo, exists, mask, bhi, blo, 5.0, nb)
    check_k8(torch, aggs_ops.dd_histogram_counts(*h_args),
             aggs_ops.histogram_counts_dd(*h_args), "histogram, rank / 5")
    hist_t = {
        "ms": timed(torch, "K8 histogram", lambda: aggs_ops.dd_histogram_counts(
            *h_args), reps=100),
        "plain_ms": timed(torch, "K8 histogram plain",
                          lambda: aggs_ops.histogram_counts_dd(*h_args),
                          reps=20),
        "library_ms": None, "library_null": "no single torch call: "
        "torch.histc buckets f32 values, not the double-double index"}
    hist_t["bound_ms"], hist_t["bound_by"] = bound(
        n + n_mask + n_ctx * 8 + nb * 4, 4 * n_ctx)

    # ---- K8 ranges mode: bench-style ranges, and a `to: 0` one ------------
    bounds = [(-np.inf, 25.0), (25.0, 75.0), (75.0, np.inf), (-np.inf, 0.0)]
    dd, strict = aggs_ops.range_bounds_dd(bounds)
    dd, strict = torch.from_numpy(dd).to(dev), torch.from_numpy(strict).to(dev)
    r_args = (hi, lo, exists, mask, dd, strict)
    check_k8(torch, aggs_ops.dd_range_counts(*r_args),
             aggs_ops.dd_range_counts_plain(*r_args), "ranges, rank")
    range_t = {
        "ms": timed(torch, "K8 ranges", lambda: aggs_ops.dd_range_counts(
            *r_args), reps=100),
        "plain_ms": timed(torch, "K8 ranges plain",
                          lambda: aggs_ops.dd_range_counts_plain(*r_args),
                          reps=20),
        "library_ms": None, "library_null": "no single torch call counts "
        "overlapping double-double ranges"}
    range_t["bound_ms"], range_t["bound_by"] = bound(
        n + n_mask + n_ctx * 8 + len(bounds) * 21, 4 * len(bounds) * n_ctx)

    # ---- odd shapes -------------------------------------------------------
    rng = np.random.default_rng(args.seed + 5)
    odd = min(100_003, n)
    check_k8(torch, aggs_ops.ord_counts(ords[:odd], mask[:odd], 16),
             aggs_ops.ord_value_counts(ords[:odd], mask[:odd], 16),
             f"ordinal, N={odd}")
    check_k9(torch, aggs_ops, (hi[:odd], lo[:odd], exists[:odd], mask[:odd]),
             f"N={odd}")
    big = torch.from_numpy(rng.integers(-1, 50_000, (n, 1)).astype(
        np.int32)).to(dev)
    check_k8(torch, aggs_ops.ord_counts(big, mask, 50_000),
             aggs_ops.ord_value_counts(big, mask, 50_000),
             "ordinal, a 50,000-ord vocabulary (global atomics)")
    # 4 hours: the bucket index's f32 arithmetic is exact below 2^24 ms
    millis = 1.5e12 + rng.integers(0, 4, odd) * 3_600_000.0 + np.where(
        rng.random(odd) < 0.3, 0.0, rng.integers(1, 3_600_000, odd))
    dhi, dlo = dd_cuda(torch, millis, dev)
    dex = torch.ones(odd, dtype=torch.bool, device=dev)
    dstats, _ = check_k9(torch, aggs_ops, (dhi, dlo, dex, mask[:odd]),
                         "epoch-millis dates")
    dbhi, dblo, dnb = histogram_base(dstats.cpu().numpy(), 3_600_000.0)
    d_args = (dhi, dlo, dex, mask[:odd], dbhi, dblo, 3_600_000.0, dnb)
    d_got = aggs_ops.dd_histogram_counts(*d_args)
    check_k8(torch, d_got, aggs_ops.histogram_counts_dd(*d_args),
             "1h buckets of epoch-millis dates, docs on the edges")
    on_edge = np.floor(millis[mask[:odd].cpu().numpy()] / 3_600_000.0)
    check(np.array_equal(np.bincount((on_edge - on_edge.min()).astype(
        np.int64), minlength=dnb), d_got.cpu().numpy()),
        "K8 1h buckets differ from float64 buckets of the dates")
    d_dd, d_strict = aggs_ops.range_bounds_dd(
        [(-np.inf, 0.0), (float(millis[0]), float(millis[0]) + 3.6e6),
         (float(millis[0]), np.inf)])
    d_dd = torch.from_numpy(d_dd).to(dev)
    d_strict = torch.from_numpy(d_strict).to(dev)
    check_k8(torch, aggs_ops.dd_range_counts(dhi, dlo, dex, mask[:odd], d_dd,
                                             d_strict),
             aggs_ops.dd_range_counts_plain(dhi, dlo, dex, mask[:odd], d_dd,
                                            d_strict),
             "ranges of dates, `to: 0`, a bound on a stored value")
    empty = torch.zeros_like(mask)
    check_k8(torch, aggs_ops.ord_counts(ords, empty, 16),
             torch.zeros(16, dtype=torch.int32, device=dev), "empty mask")
    check_k8(torch, aggs_ops.dd_histogram_counts(hi, lo, exists, empty, bhi,
                                                 blo, 5.0, nb),
             torch.zeros(nb, dtype=torch.int32, device=dev), "empty mask")
    check_k9(torch, aggs_ops, (hi, lo, exists, empty), "empty mask")
    log(f"K8 agg_counts [N={n}, {n_mask} rows in the mask]: equal to plain "
        f"in every mode (ordinal over 16 cat ords: kernel_ms="
        f"{ord_t['ms']:.4f} plain_ms={ord_t['plain_ms']:.4f} library_ms="
        f"{ord_t['library_ms']:.4f} (torch.bincount on ordinals masked "
        f"beforehand) bound_ms={ord_t['bound_ms']:.6f}; histogram rank/5, "
        f"{nb} buckets: kernel_ms={hist_t['ms']:.4f} plain_ms="
        f"{hist_t['plain_ms']:.4f} bound_ms={hist_t['bound_ms']:.6f}; "
        f"{len(bounds)} ranges: kernel_ms={range_t['ms']:.4f} plain_ms="
        f"{range_t['plain_ms']:.4f} bound_ms={range_t['bound_ms']:.6f}), "
        f"and at N={odd}, a 50,000-ord vocabulary, epoch-millis dates at 1h "
        f"with docs on bucket edges, a `to: 0` range and an empty mask")
    log(f"K9 agg_stats [N={n}, {n_ctx} rows in context]: count and extrema "
        f"bit-equal to plain, sums within {k9_err:.3e} (rtol 1e-6), the same "
        f"bits on a second run; kernel_ms={k9['ms']:.4f} plain_ms="
        f"{k9['plain_ms']:.4f} bound_ms={k9['bound_ms']:.6f} library_ms=null "
        f"(no single torch call gives the count, double-double extrema and "
        f"sums); also at N={odd}, on epoch-millis dates and an empty mask")
    k8 = {"name": "agg_counts", "route": "cuda", "source": K8_SOURCE,
          "replaces": K8_REPLACES, "launches": 0, "max_abs_err": 0.0,
          **ord_t, "shape": {"N": n, "masked": n_mask, "ords": 16},
          "modes": {"ordinal": ord_t,
                    "histogram": {**hist_t, "buckets": nb},
                    "ranges": {**range_t, "ranges": len(bounds)}}}
    k9_entry = {"name": "agg_stats", "route": "cuda", "source": K9_SOURCE,
                "replaces": K9_REPLACES, "launches": 0,
                "max_abs_err": k9_err, **k9, "library_ms": None,
                "library_null": "no single torch call gives the count, the "
                "double-double extrema and the sums",
                "shape": {"N": n, "in_context": n_ctx}}
    return [k8, k9_entry]


def phase_topk_large(torch, args, data) -> dict:
    """K2 at k = 20,000 and 65,536 over 2^20-entry rows against its plain
    version (continuous and tie-heavy scores, explicit ids), K2 at k =
    20,000 timed beside the plain version, torch.topk and its bound."""
    from elasticsearch_tpu_torch.ops import topk
    dev = data["reader"].device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    m = 1 << 20
    scores = torch.randn((4, m), generator=gen, device=dev)
    mask = torch.rand((4, m), generator=gen, device=dev) < 0.9
    ids = torch.randperm(1 << 24, generator=gen, device=dev)[:4 * m].view(
        4, m).to(torch.int32)
    errs = []
    for k in (20_000, 65_536):
        errs.append(check_k2(torch, topk, scores, k, f"k = {k}",
                             mask=mask)[1])
        check_k2(torch, topk, torch.round(scores * 2), k,
                 f"k = {k}, tie-heavy", mask=mask)
        check_k2(torch, topk, scores, k, f"k = {k}, explicit ids", ids=ids)
    k = 20_000
    masked = torch.where(mask, scores, float("-inf"))
    res = topk.select_top_k(scores, k, mask=mask)
    out = {"shape": {"R": 4, "M": m, "k": k}, "max_abs_err": max(errs),
           "ms": timed(torch, "K2 k = 20,000", lambda: topk.select_top_k(
               scores, k, mask=mask), reps=20),
           "plain_ms": timed(torch, "K2 k = 20,000 plain",
                             lambda: topk.select_top_k_plain(
                                 scores, k, mask=mask), reps=5),
           "library_ms": timed(torch, "K2 k = 20,000 torch.topk",
                               lambda: torch.topk(masked, k, dim=1),
                               reps=20)}
    out["bound_ms"], out["bound_by"] = bound(
        nbytes(scores) + nbytes(mask) + sum(nbytes(t) for t in res),
        scores.numel())
    log(f"K2 stable_topk past one block's k [R=4, M={m}]: equal to plain at "
        f"k = 20,000 and 65,536 (continuous, tie-heavy, explicit ids); at k "
        f"= {k}: kernel_ms={out['ms']:.4f} plain_ms={out['plain_ms']:.4f} "
        f"library_ms={out['library_ms']:.4f} (torch.topk, tie order "
        f"undefined) bound_ms={out['bound_ms']:.4f}")
    return out


def phase_config5(torch, args, data, c5, name, smi_line) -> dict:
    """BASELINE config 5: bench.py's page at from 500, size 500 of a
    4-term match (every shard collects its top-1000), batches through the
    8 shards and the coordinator's merge, held against the float64
    per-shard scoring."""
    reqs = c5_reqs(data, C5_BATCHES * args.batch,
                   **{"from": C5_FROM, "size": C5_SIZE})
    batches = [reqs[i:i + args.batch] for i in range(0, len(reqs), args.batch)]
    results, per_batch, merge_ms, wall, launches = c5_drive(torch, c5,
                                                            batches)
    for kname in ("bm25_scan", "stable_topk"):
        check(launches[kname] > 0, f"config 5: kernel {kname} was not "
              f"launched on its path")
    recalls = [check_c5_page("config 5", c5, results[0][qi], qi, C5_FROM,
                             C5_SIZE, C5_FROM + C5_SIZE)
               for qi in range(C5_CHECK)]
    n = len(reqs)
    stats = {"qps": n / wall, "p50_ms": statistics.median(per_batch),
             "merge_ms_per_request": sum(merge_ms) / n, "launches": launches}
    log(f"config 5 (8 shards, from {C5_FROM}, size {C5_SIZE}): launches "
        f"{launches}; {stats['qps']:.2f} queries/s, p50 "
        f"{stats['p50_ms']:.3f} ms per batch of {args.batch} (batches: "
        f"{', '.join(f'{x:.3f}' for x in per_batch)} ms); the coordinator's "
        f"host merge (sort_docs + fetch_phase) "
        f"{', '.join(f'{x:.3f}' for x in merge_ms)} ms a batch, "
        f"{stats['merge_ms_per_request']:.3f} ms a request; first "
        f"{C5_CHECK} requests vs float64 per-shard scoring: totals exact, "
        f"scores within 1e-5, tie-tolerant page recall {min(recalls)}; "
        f"{GC.take()} — on {name} ({smi_line})")
    return stats


class SyncCounter:
    """Counts the device→host reads of CUDA tensors (Tensor.cpu, .item,
    int(), float(), bool()) made while it is entered, from any thread."""

    NAMES = ("cpu", "item", "__int__", "__float__", "__bool__")

    def __init__(self, torch):
        self.cls = torch.Tensor
        self.count = 0
        self._lock = threading.Lock()
        self._own = {}

    def __enter__(self):
        for name in self.NAMES:
            self._own[name] = self.cls.__dict__.get(name)
            orig = getattr(self.cls, name)

            def counted(t, *a, _orig=orig, **kw):
                if t.is_cuda:
                    with self._lock:
                        self.count += 1
                return _orig(t, *a, **kw)
            setattr(self.cls, name, counted)
        return self

    def __exit__(self, *exc):
        for name, own in self._own.items():
            if own is None:
                delattr(self.cls, name)
            else:
                setattr(self.cls, name, own)


def check_c5_aggs(label, c5, resp, qi) -> int:
    """One request's reduced aggregations against numpy over the host
    columns of the docs the float64 scoring matches: terms, histogram and
    range buckets and counts, and count, min and max exact (min and max of
    the column's double-double values, hi + lo, which the device reduces);
    sum and avg within 1e-5 and variance and std_deviation within 1e-4 of
    float64. Histogram buckets follow the reference's f32 arithmetic on
    (hi, lo). → the docs whose bucket differs from float64 floor(v / 5)."""
    from elasticsearch_tpu_torch.index.device_reader import dd_split
    rows = np.concatenate([sh["lo"] + np.nonzero(m)[0] for sh, (_, m) in
                           zip(c5["shards"], c5["cpu"][qi])])
    aggs = resp["aggregations"]
    hi, lo = c5["rank_hi"][rows], c5["rank_lo"][rows]
    v = hi.astype(np.float64) + lo
    true = c5["rank"][rows]
    cats = np.bincount(c5["cat"][rows], minlength=len(C5_CATS))
    order = sorted(range(len(C5_CATS)), key=lambda i: (-cats[i], C5_CATS[i]))
    want_terms = [(C5_CATS[i], int(cats[i])) for i in order if cats[i]][:8]
    check([(b["key"], b["doc_count"]) for b in aggs["by_cat"]["buckets"]]
          == want_terms, f"{label} request {qi}: terms buckets differ")
    check(aggs["by_cat"]["sum_other_doc_count"] ==
          len(rows) - sum(c for _, c in want_terms),
          f"{label} request {qi}: terms sum_other_doc_count differs")
    st = aggs["st"]
    check((st["count"], st["min"], st["max"]) == (len(rows), v.min(),
                                                  v.max()),
          f"{label} request {qi}: count/min/max {st['count']}, {st['min']}, "
          f"{st['max']} vs {len(rows)}, {v.min()}, {v.max()}")
    var = float(np.var(true))
    for key, want, rtol in (("sum", true.sum(), 1e-5),
                            ("avg", true.mean(), 1e-5),
                            ("variance", var, 1e-4),
                            ("std_deviation", np.sqrt(var), 1e-4)):
        check(abs(st[key] - want) <= rtol * abs(want),
              f"{label} request {qi}: {key} {st[key]} vs float64 {want}")
    first = np.floor(v.min() / 5.0)
    bhi, blo = dd_split(np.float64(first * 5.0))
    rel = (hi - np.float32(bhi)) + (lo - np.float32(blo))
    idx = np.floor(rel / np.float32(5.0)).astype(np.int64)
    counts = np.bincount(idx)
    want_h = [(float(first * 5.0 + 5.0 * i), int(c))
              for i, c in enumerate(counts) if c]
    check([(b["key"], b["doc_count"]) for b in aggs["hi"]["buckets"]] ==
          want_h, f"{label} request {qi}: histogram buckets differ")
    moved = int((np.floor(true / 5.0) - first != idx).sum())
    bounds = [(None, 25.0), (25.0, 75.0), (75.0, None)]
    want_r = []
    for frm, to in bounds:
        ok = np.ones(len(rows), bool)
        if frm is not None:
            fh, fl = dd_split(np.float64(frm))
            ok &= (hi > fh) | ((hi == fh) & (lo >= fl))
        if to is not None:
            th, tl = dd_split(np.float64(to))
            ok &= (hi < th) | ((hi == th) & (lo < tl))
        want_r.append(int(ok.sum()))
    check([b["doc_count"] for b in aggs["rg"]["buckets"]] == want_r,
          f"{label} request {qi}: range counts differ")
    check(aggs["vc"]["value"] == len(rows),
          f"{label} request {qi}: value_count differs")
    return moved


def phase_config5_aggs(torch, args, data, c5, name, smi_line) -> dict:
    """Config 5 with size 10 and bench.py's terms agg over cat plus
    extended_stats, histogram, range and value_count over the same shards
    and queries: query_phase one request at a time on each shard (the
    reference serves aggs so), then merge_responses reduces them. K8 and K9
    must have launched, no node may have gone to the host collectors and
    no full mask to the host (DeviceAggState.np_mask is wrapped throughout;
    the wrapper runs only if the mask is made). The device→host reads are
    counted on one more batch after the timed ones, so the timed window
    runs without SyncCounter's wrappers."""
    from elasticsearch_tpu_torch.search import aggregations
    reqs = c5_reqs(data, C5_AGG_BATCHES * args.batch, size=10, aggs=C5_AGGS)
    batches = [reqs[i:i + args.batch] for i in range(0, len(reqs), args.batch)]
    before = dict(aggregations.DEVICE_AGG_STATS)
    materialized = []
    orig = aggregations.DeviceAggState.np_mask

    def np_mask(state):
        materialized.append(1)
        return orig(state)
    aggregations.DeviceAggState.np_mask = np_mask
    try:
        results, per_batch, merge_ms, wall, launches = c5_drive(
            torch, c5, batches)
        with SyncCounter(torch) as syncs:
            c5_batch(c5, batches[0])
            torch.cuda.synchronize()
    finally:
        aggregations.DeviceAggState.np_mask = orig
    after = aggregations.DEVICE_AGG_STATS
    for kname in ("bm25_scan", "stable_topk", "agg_counts", "agg_stats"):
        check(launches[kname] > 0, f"config 5 + aggs: kernel {kname} was not "
              f"launched on its path")
    check(after["host_fallbacks"] == before["host_fallbacks"],
          "config 5 + aggs: a node went to the host collectors")
    check(not materialized, "config 5 + aggs: a full mask went to the host")
    n = len(reqs)
    moved = [check_c5_aggs("config 5 + aggs", c5, results[0][qi], qi)
             for qi in range(C5_CHECK)]
    for qi in range(C5_CHECK):
        check_c5_page("config 5 + aggs", c5, results[0][qi], qi, 0, 10, 10)
    stats = {"qps": n / wall, "p50_ms": statistics.median(per_batch),
             "syncs_per_request": syncs.count / len(batches[0]),
             "merge_ms_per_request": sum(merge_ms) / n, "launches": launches}
    log(f"config 5 + aggs (8 shards, size 10, {len(C5_AGGS)} aggs): launches "
        f"{launches}; {stats['qps']:.2f} queries/s, p50 "
        f"{stats['p50_ms']:.3f} ms per batch of {args.batch} (batches: "
        f"{', '.join(f'{x:.3f}' for x in per_batch)} ms); device->host reads "
        f"{stats['syncs_per_request']:.2f} a request (counted on one more, "
        f"untimed batch), host merge and reduce {stats['merge_ms_per_request']:.3f} ms a request; "
        f"device collects {after['device_collects'] - before['device_collects']}"
        f" ({len(batches) + 1} batches), host collectors 0, host masks 0; first {C5_CHECK} requests vs "
        f"numpy: buckets, counts, min, max exact, sums within 1e-5, variance "
        f"within 1e-4, hits vs float64; docs whose f32 histogram bucket "
        f"differs from float64 floor(v / 5): {moved}; {GC.take()} — on "
        f"{name} ({smi_line})")
    return stats


K2_STAGES = ("chunk_topk_kernel", "split_candidates_kernel",
             "select_run_kernel", "sort_tiles_kernel", "merge_runs_kernel",
             "write_run_kernel")


def k2_stages(torch, fn, calls: int = 5) -> dict:
    """``calls`` calls of ``fn`` under torch.profiler, after a warm-up step
    it does not record → per K2 large-k stage, (device ms a launch,
    launches recorded); {} when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    recorded = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                  active=1),
                 on_trace_ready=lambda p: recorded.append(
                     p.key_averages())) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    out = {}
    for ev in (recorded[0] if recorded else []):
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        for stage in K2_STAGES:
            if stage in ev.key and dev_us > 0:
                ms, n = out.get(stage, (0.0, 0))
                out[stage] = (ms + dev_us / 1e3, n + ev.count)
    return {stage: (ms / n, n) for stage, (ms, n) in out.items()}


def stage_text(stages: dict) -> str:
    return ", ".join(f"{name} {ms:.4f} ({n:g})"
                     for name, (ms, n) in stages.items()) or "not measured"


def phase_deep_page(torch, args, data, c5) -> dict:
    """One request at from 20,000, size 100 through config 5: every shard
    runs K2 at k = 20,100 over its 262,144 rows and again in its merge of
    that one segment's 20,100 candidates; untimed, held against the float64
    per-shard scoring. K2's inputs on the path are recorded as it runs and
    each call is then held against K2's plain version on them; the segment
    call of shard 0 is timed beside its plain version, torch.topk and its
    bound. → K2's launches and the timing."""
    from elasticsearch_tpu_torch.ops import topk
    reqs = c5_reqs(data, 1, **{"from": DEEP_FROM, "size": DEEP_SIZE})
    k = DEEP_FROM + DEEP_SIZE
    calls, lock = [], threading.Lock()
    orig = topk.select_top_k

    def recorded(scores, kk, mask=None, ids=None):
        if kk > topk.CHUNK:
            keep = tuple(None if t is None else t.clone()
                         for t in (scores, mask, ids))
            with lock:
                calls.append((kk, *keep))
        return orig(scores, kk, mask=mask, ids=ids)
    topk.select_top_k = recorded
    try:
        topk.TOPK.launches = 0
        out, _ = c5_batch(c5, reqs)
        launches = topk.TOPK.launches
    finally:
        topk.select_top_k = orig
    check(launches > 0, "deep page: K2 was not launched")
    recall = check_c5_page("deep page", c5, out[0], 0, DEEP_FROM, DEEP_SIZE,
                           DEEP_FROM + DEEP_SIZE)
    # the segment calls ([1, 262,144], the shard's mask) and the merges
    # ([1, 20,100], explicit ids: one full chunk and one of 3,716 entries)
    seg_calls = [c for c in calls if c[2] is not None]
    merge_calls = [c for c in calls if c[3] is not None]
    check(len(seg_calls) == C5_SHARDS and len(merge_calls) == C5_SHARDS and
          len(calls) == 2 * C5_SHARDS and all(c[0] == k for c in calls),
          f"deep page: K2 calls past one block's k were "
          f"{[(c[0], tuple(c[1].shape)) for c in calls]}, not a segment "
          f"call and a merge at k = {k} on each of {C5_SHARDS} shards")
    errs = [check_k2(torch, topk, sc, kk, f"the deep page's "
                     f"{'segment' if mk is not None else 'merge'} call "
                     f"{i} [{sc.shape[0]}, {sc.shape[1]}]", mask=mk,
                     ids=ids)[1]
            for i, (kk, sc, mk, ids) in enumerate(calls)]
    _, scores, mask, _ = seg_calls[0]
    masked = torch.where(mask, scores, float("-inf"))
    res = topk.select_top_k(scores, k, mask=mask)
    timing = {"shape": {"R": scores.shape[0], "M": scores.shape[1], "k": k},
              "max_abs_err": max(errs),
              "ms": timed(torch, "K2 deep page", lambda: topk.select_top_k(
                  scores, k, mask=mask), reps=20),
              "plain_ms": timed(torch, "K2 deep page plain",
                                lambda: topk.select_top_k_plain(
                                    scores, k, mask=mask), reps=20),
              "library_ms": timed(torch, "K2 deep page torch.topk",
                                  lambda: torch.topk(masked, k, dim=1),
                                  reps=20)}
    timing["bound_ms"], timing["bound_by"] = bound(
        nbytes(scores) + nbytes(mask) + sum(nbytes(t) for t in res),
        scores.numel())
    timing["stages_ms"] = k2_stages(torch, lambda: topk.select_top_k(
        scores, k, mask=mask))
    _, m_scores, _, m_ids = merge_calls[0]
    timing["merge_stages_ms"] = k2_stages(torch, lambda: topk.select_top_k(
        m_scores, k, ids=m_ids))
    merge_shapes = sorted({tuple(c[1].shape) for c in merge_calls})
    log(f"deep page (from {DEEP_FROM}, size {DEEP_SIZE}, every shard's k = "
        f"{k}): {len(out[0]['hits']['hits'])} hits of "
        f"{out[0]['hits']['total']}, K2 launches {launches}; vs float64 "
        f"per-shard scoring: total exact, scores within 1e-5, tie-tolerant "
        f"page recall {recall}; K2 equal to plain on all {len(calls)} of "
        f"its calls on the path ({len(seg_calls)} segment calls "
        f"[1, {scores.shape[1]}] under the shard's mask, {len(merge_calls)} "
        f"merges {merge_shapes} with explicit ids); shard 0's segment call: "
        f"kernel_ms={timing['ms']:.4f} plain_ms={timing['plain_ms']:.4f} "
        f"library_ms={timing['library_ms']:.4f} (torch.topk, tie order "
        f"undefined) bound_ms={timing['bound_ms']:.4f}; device ms a launch "
        f"(launches recorded in 5 calls) by stage, segment call {stage_text(timing['stages_ms'])}"
        f", merge call {stage_text(timing['merge_stages_ms'])}")
    return {"launches": launches, "deep_page": timing}


def phase_c5_profile(torch, data, c5, label, batch) -> dict:
    """One config-5 batch under torch.profiler (after an unrecorded warm-up
    run of it): device time by kernel, busy share, the host planning of the
    batch on every shard alone and the coordinator's host merge."""
    from elasticsearch_tpu_torch.search import segment_exec
    flags = {"min_score": False, "search_after": False}
    GC.take()
    t0 = time.perf_counter()
    for s in c5_searchers(c5):
        for req in batch:
            segment_exec._plan(s.reader.segments[0], s.ctx, req.query, None,
                               flags)
    plan_ms = (time.perf_counter() - t0) * 1e3
    merges = []
    return profile_batch(torch, label, lambda: merges.append(
        c5_batch(c5, batch)[1]), plan_ms, GC.take(), len(batch),
        extra=lambda: f"; coordinator host merge {merges[-1]:.3f} ms")


# --------------------------------------------------------------------------
# the percolator, sloppy phrases, K7 past k = 1024 (phases 26-31)
# --------------------------------------------------------------------------

# bench.py:1498-1531: seed 77, a 200-word vocabulary, 12 probe docs of 6
# words, 1,000 and 10,000 registrations
PERC_VOCAB = [f"pw{i:03d}" for i in range(200)]
PERC_REGS = (1000, 10000)
PERC_MAPPINGS = {"_doc": {"properties": {
    "body": {"type": "text", "analyzer": "whitespace"},
    "cat": {"type": "keyword"},
    "rank": {"type": "double"}}}}
# the full-feature registry: bench.py's mapping plus the `group` field
PERC_FULL_MAPPINGS = {"_doc": {"properties": {
    **PERC_MAPPINGS["_doc"]["properties"], "group": {"type": "keyword"}}}}
PERC_FULL_REGS = 10000
PERC_CHECK_PROBES = 3
# full-feature items held against percolate_serial (10,000 eager queries
# each)
PERC_SERIAL_PROBES = 2
# K1 and K3 at a percolate lane's shape: a group of registrations against a
# one-doc segment's 128-row bucket
PERC_LANE_B, PERC_LANE_N = 4096, 128
SLOPPY_SLOP = 2
K7_LARGE = (1025, 10_000, 20_000)


def perc_bench_registry():
    """bench.py's percolate generator (bench.py:1498-1531), draw for draw:
    the 12 probe docs, then the 1,000 and the 10,000 registrations from the
    same stream. → (probe docs, {n_regs: registrations})."""
    prng = np.random.default_rng(77)
    pv = PERC_VOCAB

    def reg_body(i: int) -> dict:
        w = pv[int(prng.integers(0, len(pv)))]
        kind = i % 3
        if kind == 0:
            qq = {"match": {"body": f"{w} {pv[(i * 7) % len(pv)]}"}}
        elif kind == 1:
            qq = {"term": {"cat": w}}
        else:
            qq = {"range": {"rank": {"gte": int(prng.integers(0, 90))}}}
        return {"query": qq, "group": f"g{i % 8}"}

    pdocs = [{"body": " ".join(pv[int(j)] for j in
                               prng.integers(0, len(pv), 6)),
              "cat": pv[int(prng.integers(0, len(pv)))],
              "rank": float(prng.integers(0, 100))} for _ in range(12)]
    regs = {n: {f"q{i}": reg_body(i) for i in range(n)} for n in PERC_REGS}
    return pdocs, regs


def perc_full_registry(n: int):
    """The full-feature registry: a quarter sloppy match_phrase (slop 1-3),
    a quarter bool (a must match, a should sloppy phrase, a range filter),
    bench.py's 2-term match and keyword term, and a ``group`` field."""
    prng = np.random.default_rng([77, 28])
    pv = PERC_VOCAB
    regs = {}
    for i in range(n):
        w = pv[int(prng.integers(0, len(pv)))]
        w2 = pv[(i * 7) % len(pv)]
        kind = i % 4
        if kind == 0:
            qq = {"match_phrase": {"body": {"query": f"{w} {w2}",
                                            "slop": 1 + i % 3}}}
        elif kind == 1:
            qq = {"bool": {
                "must": [{"match": {"body": w}}],
                "should": [{"match_phrase": {"body": {
                    "query": f"{w} {w2}", "slop": 2}}}],
                "filter": [{"range": {"rank": {
                    "gte": int(prng.integers(0, 90))}}}]}}
        elif kind == 2:
            qq = {"match": {"body": f"{w} {w2}"}}
        else:
            qq = {"term": {"cat": w}}
        regs[f"q{i}"] = {"query": qq, "group": f"g{i % 8}"}
    return regs


def perc_meta(name, mappings, regs):
    """The duck-typed index metadata the percolator reads."""
    import types
    return types.SimpleNamespace(name=name, uuid=f"{name}-uuid", settings={},
                                 mappings=mappings, percolators=regs,
                                 version=1)


def perc_oracle(regs, doc, k1=1.2, b=0.75) -> dict:
    """float64 recompute of every registration against one probe doc: the
    one-doc index's BM25 (N = 1, df = 1 for a term the doc holds, avgdl =
    the doc's length), constant 1.0 for keyword terms and ranges, the
    in-order sloppy phrase frequency. → {qid: score} of the matches."""
    toks = doc["body"].split()
    dl = len(toks)
    idf = float(np.log1p(0.5 / 1.5))          # N = 1, df = 1
    norm = k1 * (1.0 - b + b * dl / dl)

    def bm25(terms):
        hits = [t for t in terms if t in toks]
        if not hits:
            return None
        return sum(idf * toks.count(t) * (k1 + 1.0) /
                   (toks.count(t) + norm) for t in hits)

    def phrase(text, slop):
        a, b_ = text.split()
        if a not in toks or b_ not in toks:
            return None
        freq = 0.0
        for p, t in enumerate(toks):
            if t != a:
                continue
            for s in range(slop + 1):
                if p + 1 + s < dl and toks[p + 1 + s] == b_:
                    freq += 1.0 / (1.0 + s)
                    break
        if freq == 0.0:
            return None
        return 2 * idf * freq * (k1 + 1.0) / (freq + norm)

    def score(q):
        kind, body = next(iter(q.items()))
        if kind == "match":
            return bm25(body["body"].split())
        if kind == "term":
            return 1.0 if doc["cat"] == body["cat"] else None
        if kind == "range":
            return 1.0 if doc["rank"] >= body["rank"]["gte"] else None
        if kind == "match_phrase":
            return phrase(body["body"]["query"], body["body"]["slop"])
        must = score(body["must"][0])
        if must is None or score(body["filter"][0]) is None:
            return None
        should = score(body["should"][0])
        return must + (should or 0.0)

    out = {}
    for qid, reg in regs.items():
        v = score(reg["query"])
        if v is not None:
            out[qid] = v
    return out


def check_perc_oracle(label, got, want, rtol=1e-5):
    """Every registration's flag and score against the float64 oracle."""
    ids = [m["_id"] for m in got["matches"]]
    check(got["total"] == len(want) and set(ids) == set(want),
          f"{label}: matched {got['total']} registrations, the float64 "
          f"oracle {len(want)} ({len(set(ids) ^ set(want))} differ)")
    for m in got["matches"]:
        w = want[m["_id"]]
        check(abs(m["_score"] - w) <= rtol * abs(w) + 1e-7,
              f"{label}: registration {m['_id']} scored {m['_score']}, the "
              f"float64 oracle {w}")


class LaneTimer:
    """Times ``segment_exec.run_percolate_lanes`` inside percolate calls:
    its host clock (every lane's emit and launches, the one K10 launch, the
    one device→host copy) and the card's span of it (CUDA events on the
    stream); the rest of a call is the host's resolve and rendering."""

    def __init__(self, torch):
        from elasticsearch_tpu_torch.search import segment_exec
        self.torch, self.mod = torch, segment_exec
        self.host_ms = self.card_ms = 0.0
        self.calls = self.lanes = self.rows = 0

    def __enter__(self):
        torch, orig = self.torch, self.mod.run_percolate_lanes
        self._orig = orig

        def timed_lanes(lanes):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = orig(lanes)
            end.record()
            end.synchronize()
            self.host_ms += (time.perf_counter() - t0) * 1e3
            self.card_ms += start.elapsed_time(end)
            self.calls += 1
            self.lanes += len(lanes)
            self.rows += sum(o.shape[0] for o in out)
            return out
        self.mod.run_percolate_lanes = timed_lanes
        return self

    def __exit__(self, *exc):
        self.mod.run_percolate_lanes = self._orig


def perc_call(torch, fn):
    """One percolate call with every launch counter at 0 just before it and
    read just after, its device→host reads counted, its lanes timed. →
    (result, record: wall ms, host resolve ms, lanes ms, card span ms,
    launches, reads, lanes, query rows)."""
    counters = path_kernels()
    torch.cuda.synchronize()
    for kern in counters.values():
        kern.launches = 0
    with SyncCounter(torch) as sync, LaneTimer(torch) as lt:
        t0 = time.perf_counter()
        out = fn()
        wall = (time.perf_counter() - t0) * 1e3
    launches = {k: v.launches for k, v in counters.items() if v.launches}
    return out, {"wall_ms": wall, "resolve_ms": wall - lt.host_ms,
                 "lanes_ms": lt.host_ms, "card_span_ms": lt.card_ms,
                 "launches": launches, "reads": sync.count,
                 "lanes": lt.lanes, "rows": lt.rows}


def perc_line(rec) -> str:
    return (f"{rec['wall_ms']:.3f} ms = host resolve and render "
            f"{rec['resolve_ms']:.3f} + lanes {rec['lanes_ms']:.3f} (card "
            f"span {rec['card_span_ms']:.3f}); {rec['lanes']} lanes, "
            f"{rec['rows']} query rows; launches {rec['launches']}; "
            f"device→host reads {rec['reads']}")


def phase_percolate_kernels(torch, args, data) -> tuple[dict, dict, dict]:
    """K10 against its plain version on ragged lanes, and K1 and K3 at a
    percolate lane's shape (B = 4,096 x N = 128) against theirs, each timed
    beside its bound. → (K10's kernel entry, K1's and K3's numbers at this
    shape)."""
    from elasticsearch_tpu_torch.ops import lexical, percolate, phrase
    dev = data["reader"].device
    rng = np.random.default_rng([args.seed, 26])

    # ---- K10: ragged lanes, NaN, -0.0, empty and dead rows ---------------
    def lanes_of(shapes):
        out = []
        for b, n in shapes:
            sc = (rng.standard_normal((b, n)) * 4).astype(np.float32)
            mk = rng.random((b, n)) < 0.02
            lv = np.zeros(n, bool)
            lv[:max(1, n // 64)] = True           # a one-doc bucket's live
            lv[rng.random(n) < 0.3] = True
            if b >= 5:
                mk[0] = False                     # nothing matches
                mk[1] = ~lv                       # only dead rows match
                alive = np.flatnonzero(lv)[:2]
                mk[2] = False
                mk[2, alive] = True
                sc[2, alive] = -0.0               # matches only at -0.0
                sc[3, alive[0]] = np.nan          # NaN among the matches
                mk[3, alive[0]] = True
                sc[4] = np.nan                    # NaN outside them
                mk[4] = False
                mk[4, alive[-1]] = True
                sc[4, alive[-1]] = 1.5
            out.append(tuple(torch.from_numpy(x).to(dev)
                             for x in (sc, mk, lv)))
        return out

    def check_k10(lanes, what):
        got = percolate.percolate_reduce(lanes)
        want = percolate.percolate_reduce_plain(lanes)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        check(torch.equal(torch.isnan(got), nan) and torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32)),
            f"K10 differs from its plain version ({what})")
        return got

    odd = lanes_of([(10_000, 128), (1, 128), (1234, 128), (0, 128),
                    (37, 256), (6, 7), (300, 130), (5, 1)])
    got = check_k10(odd, "ragged lanes")
    check(int(torch.isnan(got[:, 1]).sum()) >= 1 and
          int(((got[:, 1] == 0) & torch.signbit(got[:, 1])).sum()) >= 1,
          "K10's odd lanes hold no NaN or -0.0 result")
    # the path's shape: one call of 10,000 registrations in three lanes
    lanes = lanes_of([(3334, 128), (3333, 128), (3333, 128)])
    check_k10(lanes, "three lanes of 10,000 queries")
    rows = sum(s.shape[0] for s, _, _ in lanes)
    k10_ms = timed(torch, "K10", lambda: percolate.percolate_reduce(lanes),
                   reps=50)
    k10_plain_ms = timed(torch, "K10 plain",
                         lambda: percolate.percolate_reduce_plain(lanes),
                         reps=20)
    pre = torch.cat([torch.where(m & lv[None, :], s, float("-inf"))
                     for s, m, lv in lanes])
    k10_lib_ms = timed(torch, "K10 library (torch.amax on pre-masked "
                       "scores)", lambda: torch.amax(pre, dim=1), reps=50)
    k10_bytes = sum(s.shape[0] * s.shape[1] * 5 + s.shape[1]
                    for s, _, _ in lanes) + 8 * rows
    k10_b, k10_by = bound(k10_bytes, sum(s.numel() for s, _, _ in lanes))
    log(f"K10 percolate_reduce [3 lanes, {rows} queries x Np = 128]: "
        f"bit-identical to plain (NaN as NaN), also on 8 ragged lanes up to "
        f"B = 10,000 (Np 1, 7, 128, 130, 256, a lane of no rows; empty, "
        f"dead-only, -0.0-only and NaN rows); kernel_ms={k10_ms:.4f} "
        f"plain_ms={k10_plain_ms:.4f} library_ms={k10_lib_ms:.4f} "
        f"(torch.amax over scores masked to -inf beforehand) "
        f"bound_ms={k10_b:.6f} ({k10_by}: {k10_bytes} B)")
    k10 = {"name": "percolate_reduce", "route": "cuda", "source": K10_SOURCE,
           "replaces": K10_REPLACES, "launches": 0, "max_abs_err": 0.0,
           "ms": k10_ms, "plain_ms": k10_plain_ms, "bound_ms": k10_b,
           "bound_by": k10_by, "library_ms": k10_lib_ms,
           "shape": {"lanes": 3, "B": rows, "Np": 128}}

    # ---- K1 at a lane's shape: B = 4,096 x N = 128 -----------------------
    seg = data["reader"].segments[0]
    col = seg.text["body"]
    n = PERC_LANE_N
    host_ut = data["uterms"][:n]
    present = np.unique(host_ut[host_ut >= 0])
    b = PERC_LANE_B
    tids = torch.from_numpy(rng.choice(present, (b, 2)).astype(np.int32)).to(
        dev)
    idf = torch.from_numpy(rng.uniform(0.5, 9.0, (b, 2)).astype(
        np.float32)).to(dev)
    avgdl = torch.full((b,), float(data["lens"].mean()), device=dev)
    p = data["searcher"].ctx.bm25
    k1_args = (col.uterms[:n], col.utf[:n], col.doc_len[:n], tids, idf,
               torch.ones_like(idf), p.k1, p.b, avgdl)
    got_s, got_n, _ = check_k1(torch, lexical, k1_args, col.trailing_pad,
                               f"a percolate lane's shape B={b}, N={n}")
    k1_ms = timed(torch, "K1 at B=4096, N=128", lambda:
                  lexical.bm25_match_batch(*k1_args,
                                           trailing_pad=col.trailing_pad,
                                           want_nmatch=False), reps=20)
    k1_plain_ms = timed(torch, "K1 plain at B=4096, N=128", lambda:
                        lexical.bm25_match_batch_plain(
                            *k1_args, want_nmatch=False), reps=2, warmup=0)
    read, flops = k1_work(torch, col.uterms[:n], col.doc_len[:n], tids,
                          avgdl, int(got_n.sum()))
    k1_b, k1_by = bound(read + nbytes(got_s), flops)
    # ---- K3 at a lane's shape ----------------------------------------------
    tok = col.tokens[:n]
    host_tok = data["tokens"][:n]
    pairs = phrase_pairs(rng, host_tok, data["lens"][:n], b)
    qt = torch.from_numpy(pairs).to(dev)
    sum_idf = idf.sum(dim=1)
    ext = phrase.token_extent(tok)
    k3_args = (tok, col.doc_len[:n], qt, (0, 1), sum_idf, p.k1, p.b, avgdl)
    g3_s, g3_m = phrase.phrase_score_batch(*k3_args, extent=ext)
    w3_s, w3_m = phrase.phrase_score_batch_plain(*k3_args)
    torch.cuda.synchronize()
    check(torch.equal(g3_m, w3_m) and torch.equal(
        g3_s.view(torch.int32), w3_s.view(torch.int32)) and bool(
        g3_m.any()), "K3 is not bit-identical to its plain version at a "
        "percolate lane's shape")
    k3_ms = timed(torch, "K3 at B=4096, N=128", lambda:
                  phrase.phrase_score_batch(*k3_args, extent=ext), reps=20)
    k3_plain_ms = timed(torch, "K3 plain at B=4096, N=128", lambda:
                        phrase.phrase_score_batch_plain(*k3_args), reps=1,
                        warmup=0)
    ext_sum = int(ext.sum())
    k3_bytes = (4 * ext_sum + nbytes(ext) + nbytes(col.doc_len[:n])
                + nbytes(qt) + nbytes(sum_idf) + nbytes(avgdl)
                + nbytes(g3_s) + nbytes(g3_m))
    k3_b, k3_by = bound(k3_bytes, 8 * int(g3_m.sum()) + ext_sum)
    log(f"K1 bm25_scan and K3 phrase_scan at a percolate lane's shape "
        f"[B={b}, N={n}, T=2; {b // 64} query groups on grid y]: both "
        f"bit-identical to plain (K1 with and without nmatch, "
        f"{int((got_n > 0).sum())} hits; K3 {int(g3_m.sum())} (query, doc) "
        f"pairs with the phrase); K1 kernel_ms={k1_ms:.4f} plain_ms="
        f"{k1_plain_ms:.4f} bound_ms={k1_b:.6f} ({k1_by}); K3 kernel_ms="
        f"{k3_ms:.4f} plain_ms={k3_plain_ms:.4f} bound_ms={k3_b:.6f} "
        f"({k3_by})")
    shape = {"B": b, "N": n, "T": 2}
    return (k10,
            {"ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_b,
             "bound_by": k1_by, "shape": shape},
            {"ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_b,
             "bound_by": k3_by, "shape": shape})


def phase_percolate_bench(torch, args, data, name, smi_line) -> dict:
    """bench.py's percolate workload: 1,000 and 10,000 registrations, a
    percolate per probe doc, then one percolate_many of the 12 probes;
    every registration's flag and score on the first probes against the
    float64 oracle, the first probe against percolate_serial."""
    from elasticsearch_tpu_torch.search import percolator
    dev = data["reader"].device
    pdocs, regs_by_n = perc_bench_registry()
    stats = {"launches": {k: 0 for k in path_kernels()}}
    for n_regs in PERC_REGS:
        regs = regs_by_n[n_regs]
        meta = perc_meta(f"smoke_perc_{n_regs}", PERC_MAPPINGS, regs)
        t0 = time.perf_counter()
        reg = percolator.registry_for(meta, dev)
        build_ms = (time.perf_counter() - t0) * 1e3
        st = reg.stats_dict()
        log(f"percolate {n_regs}: registry built in {build_ms:.1f} ms "
            f"(set-up: parse and plan every registration once; "
            f"{st['shape_buckets']} shape buckets)")
        recs, outs = [], []
        for pi, d in enumerate(pdocs):
            out, rec = perc_call(torch, lambda d=d: percolator.percolate(
                meta, d, score=True, device=dev))
            check(rec["launches"].get("percolate_reduce") == 1,
                  f"percolate {n_regs} probe {pi}: launches "
                  f"{rec['launches']}, not one K10")
            for k_, v in rec["launches"].items():
                stats["launches"][k_] += v
            recs.append(rec)
            outs.append(out)
        for pi in range(PERC_CHECK_PROBES):
            check_perc_oracle(f"percolate {n_regs} probe {pi}", outs[pi],
                              perc_oracle(regs, pdocs[pi]))
        t0 = time.perf_counter()
        ser = percolator.percolate_serial(meta, pdocs[0], score=True,
                                          device=dev)
        serial_ms = (time.perf_counter() - t0) * 1e3
        check([m["_id"] for m in ser["matches"]] ==
              [m["_id"] for m in outs[0]["matches"]] and
              ser["total"] == outs[0]["total"],
              f"percolate {n_regs}: probe 0 differs from percolate_serial")
        many, mrec = perc_call(torch, lambda: percolator.percolate_many(
            meta, [{"doc": d, "score": True} for d in pdocs], device=dev))
        check(mrec["launches"].get("percolate_reduce") == 1,
              f"percolate_many {n_regs}: launches {mrec['launches']}, not "
              f"one K10")
        for k_, v in mrec["launches"].items():
            stats["launches"][k_] += v
        check(many == outs, f"percolate_many {n_regs}: an item differs from "
              f"its own percolate call")
        walls = [r["wall_ms"] for r in recs]
        p50 = statistics.median(walls)
        mid = sorted(recs, key=lambda r: r["wall_ms"])[len(recs) // 2]
        log(f"percolate {n_regs}: {len(pdocs)} probes, p50 {p50:.3f} ms a "
            f"call ({', '.join(f'{w:.1f}' for w in walls)}); the p50 call: "
            f"{perc_line(mid)}; matches a probe "
            f"{[o['total'] for o in outs]}; the first {PERC_CHECK_PROBES} "
            f"probes' every registration held against the float64 oracle "
            f"(flags exact, scores within 1e-5); probe 0 equal to "
            f"percolate_serial ({serial_ms:.1f} ms, one query at a time) — "
            f"on {name} ({smi_line})")
        log(f"percolate_many {n_regs}: 12 probes in one call, "
            f"{perc_line(mrec)}, {mrec['wall_ms'] / len(pdocs):.3f} ms a "
            f"probe; every item equal to its own percolate call")
        stats[n_regs] = {"p50_ms": p50, "many_ms": mrec["wall_ms"],
                         "serial_ms": serial_ms, "build_ms": build_ms,
                         "p50_call": mid, "many": mrec}
    check(stats["launches"]["percolate_reduce"] > 0,
          "the percolate path launched no K10")
    return stats


def phase_percolate_full(torch, args, data, name, smi_line) -> dict:
    """A second registry of 10,000 (sloppy phrases, bool, a group field)
    through percolate_many with score, sort, size, highlight, a terms agg
    over group and a reg_filter; held against the float64 oracle and
    percolate_serial on the first probes."""
    from elasticsearch_tpu_torch.search import percolator
    dev = data["reader"].device
    pdocs, _ = perc_bench_registry()
    regs = perc_full_registry(PERC_FULL_REGS)
    meta = perc_meta("smoke_perc_full", PERC_FULL_MAPPINGS, regs)
    t0 = time.perf_counter()
    percolator.registry_for(meta, dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    hl = {"fields": {"body": {}}}
    features = [{"score": True},
                {"sort": True, "size": 25, "highlight": hl},
                {"aggs": {"by_group": {"terms": {"field": "group"}}},
                 "score": True},
                {"reg_filter": {"term": {"group": "g3"}}, "score": True}]
    items = [dict(features[i % len(features)], doc=d)
             for i, d in enumerate(pdocs)]
    out, rec = perc_call(torch, lambda: percolator.percolate_many(
        meta, items, device=dev))
    check(rec["launches"].get("percolate_reduce") == 1 and
          rec["launches"].get("sloppy_phrase_scan", 0) > 0,
          f"percolate full: launches {rec['launches']}: not one K10 and "
          f"some K11")
    for i, (it, got) in enumerate(zip(items, out)):
        check("_exception" not in got, f"percolate full item {i}: "
              f"{got.get('_exception')!r}")
        want = perc_oracle(regs, it["doc"])
        if "reg_filter" in it:
            want = {q: v for q, v in want.items()
                    if regs[q]["group"] == "g3"}
        if i < 2 * len(features):
            if it.get("score") and "size" not in it:
                check_perc_oracle(f"percolate full item {i}", got, want)
            else:
                check(got["total"] == len(want) and {
                    m["_id"] for m in got["matches"]} <= set(want),
                    f"percolate full item {i}: total {got['total']}, "
                    f"oracle {len(want)}")
            if "aggs" in it:
                counts = {}
                for q in want:
                    counts[regs[q]["group"]] = counts.get(
                        regs[q]["group"], 0) + 1
                buckets = {bk["key"]: bk["doc_count"] for bk in
                           got["aggregations"]["by_group"]["buckets"]}
                check(buckets == counts, f"percolate full item {i}: the "
                      f"group agg {buckets} differs from numpy {counts}")
            if it.get("sort"):
                sc = [m["_score"] for m in got["matches"]]
                check(sc == sorted(sc, reverse=True) and len(sc) == min(
                    25, len(want)), f"percolate full item {i}: not sorted "
                    f"by score, or not cut to its size")
        if i < PERC_SERIAL_PROBES:
            kw = {k: v for k, v in it.items() if k not in ("doc", "aggs")}
            ser = percolator.percolate_serial(meta, it["doc"], device=dev,
                                              **kw)
            check([m["_id"] for m in ser["matches"]] ==
                  [m["_id"] for m in got["matches"]] and all(
                  abs(a.get("_score", 0) - b_.get("_score", 0)) <= 1e-6 *
                  abs(b_.get("_score", 1)) and a.get("highlight") ==
                  b_.get("highlight") for a, b_ in zip(got["matches"],
                                                       ser["matches"])),
                  f"percolate full item {i} differs from percolate_serial")
    n_hl = sum("highlight" in m for r in out for m in r["matches"])
    check(n_hl > 0, "percolate full: no match was highlighted")
    log(f"percolate full {PERC_FULL_REGS}: registry built in {build_ms:.1f} "
        f"ms; percolate_many of 12 probes with score, sort + size 25 + "
        f"highlight, a group terms agg and a reg_filter: {perc_line(rec)}; "
        f"matches {[r['total'] for r in out]}, {n_hl} highlighted; the "
        f"first 8 items against the float64 oracle (sloppy phrases in "
        f"order, bool, the agg's buckets), the first {PERC_SERIAL_PROBES} "
        f"against percolate_serial — on {name} ({smi_line})")
    return {"many_ms": rec["wall_ms"], "call": rec,
            "launches": {k: rec["launches"].get(k, 0)
                         for k in path_kernels()}}


def sloppy_bodies(args, data, slop) -> list[dict]:
    """Config 2's bodies with the should clause's phrase given ``slop``."""
    out = []
    for body in config2_bodies(args, data):
        q = body["query"]["bool"]
        text = q["should"][0]["match_phrase"]["body"]
        out.append({"query": {"bool": {"must": q["must"], "should": [
            {"match_phrase": {"body": {"query": text, "slop": slop}}}]}},
            "size": body["size"]})
    return out


def phase_sloppy(torch, args, data, k3, name, smi_line) -> tuple[dict, dict]:
    """K11 against its plain version on config 2's position matrix (slop 1,
    2 and 3) and at odd shapes, timed beside K3; then config 2 with slop 2
    through query_phase_batch against a float64 recompute; then the
    highlighter on the fetched hits of one batch."""
    from elasticsearch_tpu_torch.ops import phrase
    from elasticsearch_tpu_torch.search import query_dsl
    from elasticsearch_tpu_torch.search.highlight import highlight_hit
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    from elasticsearch_tpu_torch.search.segment_exec import (
        _plan_segment_batch)
    searcher, reader = data["searcher"], data["reader"]
    seg = reader.segments[0]
    col = seg.text["body"]
    tn = data["term_names"]
    p = searcher.ctx.bm25
    n, length = col.tokens.shape
    per_slop = {}
    for slop in (1, 2, 3):
        queries = [query_dsl.parse_query({"match_phrase": {"body": {
            "query": f"{tn[a]} {tn[b]}", "slop": slop}}})
            for a, b in data["pairs"][:args.batch]]
        plan = _plan_segment_batch(seg, searcher.ctx, queries, args.k)
        tids, idfs, avgdl, _boost = plan["consts"]
        a11 = (col.tokens, col.doc_len, tids, (0, 1), slop, idfs, p.k1,
               p.b, avgdl)
        got_s, got_m = phrase.sloppy_phrase_score_batch(
            *a11, extent=col.tok_extent)
        want_s, want_m = phrase.sloppy_phrase_score_batch_plain(*a11)
        torch.cuda.synchronize()
        check(torch.equal(got_m, want_m) and torch.equal(
            got_s.view(torch.int32), want_s.view(torch.int32)),
            f"K11 is not bit-identical to its plain version at config 2's "
            f"shape, slop {slop}")
        ms_ = timed(torch, f"K11 slop {slop}", lambda: (
            phrase.sloppy_phrase_score_batch(*a11, extent=col.tok_extent)),
            reps=20)
        hits = int(got_m.sum())
        per_slop[slop] = {"ms": ms_, "hits": hits, "args": a11,
                          "exact_hits": None}
        log(f"K11 sloppy_phrase_scan [B={tids.shape[0]}, N={n}, L={length}, "
            f"T=2, slop {slop}]: bit-identical to plain ({hits} (query, doc) "
            f"pairs match); kernel_ms={ms_:.4f}")
    main = per_slop[SLOPPY_SLOP]
    a11 = main["args"]
    plain_ms = timed(torch, "K11 plain", lambda:
                     phrase.sloppy_phrase_score_batch_plain(*a11), reps=1,
                     warmup=0)
    ext_sum = int(col.tok_extent.sum())
    tids, idfs, avgdl = a11[2], a11[5], a11[8]
    k11_bytes = (4 * ext_sum + nbytes(col.tok_extent) + nbytes(col.doc_len)
                 + nbytes(tids) + nbytes(idfs) + nbytes(avgdl)
                 + n * tids.shape[0] * 5)
    k11_b, k11_by = bound(k11_bytes, 8 * main["hits"] + ext_sum)
    # ---- odd shapes: B = 3, N off the run, holes, 5 terms, slop 3 --------
    rng = np.random.default_rng([args.seed, 29])
    n_odd = min(n, 100_003)
    tok = col.tokens[:n_odd].clone()
    lens = col.doc_len[:n_odd]
    holes = torch.arange(0, n_odd, 5, device=tok.device)
    tok[holes, (lens[holes] // 2).long()] = -1
    ext = phrase.token_extent(tok)
    row = tok[1].cpu().numpy()
    ln = int((row >= 0).sum())
    deltas = (0, 1, 3, 4, 6)
    odd_tids = np.array([
        [row[0], row[2], row[3], row[5], row[7]],      # 3 shifts of 1
        [row[2]] * 5,                                  # repeated
        [row[min(ln - 3 + d, ln - 1)] for d in deltas],   # past the end
        [row[0], -1, row[3], row[4], row[6]]], np.int32)  # an absent term
    qt = torch.from_numpy(odd_tids).to(tok.device)
    o_idf = torch.from_numpy(rng.uniform(0.5, 9.0, (4, 5)).astype(
        np.float32)).to(tok.device)
    o_av = avgdl[:1].expand(4).contiguous()
    for slop in (3, 8):
        oa = (tok, lens, qt, deltas, slop, o_idf, p.k1, p.b, o_av)
        g = phrase.sloppy_phrase_score_batch(*oa, extent=ext)
        w = phrase.sloppy_phrase_score_batch_plain(*oa)
        torch.cuda.synchronize()
        check(torch.equal(g[1], w[1]) and torch.equal(
            g[0].view(torch.int32), w[0].view(torch.int32)) and bool(
            g[1][0].any()), f"K11 differs from its plain version at the odd "
            f"shape, slop {slop}")
    log(f"K11 sloppy_phrase_scan [B=4, N={n_odd}, T=5, deltas {deltas}, "
        f"slop 3 and 8, holes in every fifth row, a shifted, a repeated, a "
        f"past-the-end and an absent-term phrase]: bit-identical to plain")
    log(f"K11 sloppy_phrase_scan at config 2's shape, slop {SLOPPY_SLOP}: "
        f"kernel_ms={main['ms']:.4f} (slop 1 {per_slop[1]['ms']:.4f}, slop "
        f"3 {per_slop[3]['ms']:.4f}; K3 exact {k3['ms']:.4f}, ratio "
        f"{main['ms'] / max(k3['ms'], 1e-9):.3f}) plain_ms={plain_ms:.4f} "
        f"bound_ms={k11_b:.4f} ({k11_by}: {k11_bytes} B) library_ms=null")
    k11 = {"name": "sloppy_phrase_scan", "route": "cuda",
           "source": K11_SOURCE, "replaces": K11_REPLACES, "launches": 0,
           "max_abs_err": 0.0, "ms": main["ms"], "plain_ms": plain_ms,
           "bound_ms": k11_b, "bound_by": k11_by, "library_ms": None,
           "library_null": "no single torch call: shifted compares with a "
                           "nearest-shift search, a weighted count, then "
                           "BM25",
           "shape": {"B": int(tids.shape[0]), "N": n, "L": length, "T": 2,
                     "slop": SLOPPY_SLOP},
           "ms_by_slop": {s: v["ms"] for s, v in per_slop.items()},
           "k3_ms": k3["ms"]}

    # ---- config 2 with slop 2 through query_phase_batch -------------------
    bodies = sloppy_bodies(args, data, SLOPPY_SLOP)
    batches = batches_of(args, bodies)
    results, per_batch, wall, launches, peak = drive(torch, searcher,
                                                     batches)
    stats = report(f"config 2, slop {SLOPPY_SLOP} (bool + sloppy "
                   f"match_phrase)", args, data, batches, per_batch, wall,
                   launches, peak, name, smi_line,
                   ("bm25_scan", "stable_topk", "sloppy_phrase_scan"))
    check(launches["phrase_scan"] == 0, "the sloppy phrase ran K3")
    nq = CHECK_QUERIES
    t0 = time.perf_counter()
    must = cpu_scores(data["uterms"], data["utf"], data["lens"], data["df"],
                      data["qtids"][:nq, :2])
    phr = cpu_phrase_scores(data["tokens"], data["uterms"], data["utf"],
                            data["lens"], data["df"], data["pairs"][:nq],
                            slop=SLOPPY_SLOP)
    matched = [m > 0 for m in must]
    cpu = [np.where(m, s + ph, 0.0) for m, s, ph in zip(matched, must, phr)]
    recall = check_vs_cpu(f"config 2 slop {SLOPPY_SLOP}", args,
                          results[0][:nq], cpu, matched,
                          gid_to_orig(reader))
    exact = cpu_phrase_scores(data["tokens"], data["uterms"], data["utf"],
                              data["lens"], data["df"], data["pairs"][:nq])
    n_sloppy = [int(((ph > 0) & m).sum()) for ph, m in zip(phr, matched)]
    n_only = [int(((ph > 0) & (ex == 0) & m).sum())
              for ph, ex, m in zip(phr, exact, matched)]
    check(sum(n_only) > 0, "config 2 slop: no checked matched doc holds "
          "its phrase only within the slop, so the check does not cover "
          "the shifts")
    log(f"config 2 slop {SLOPPY_SLOP}: first {nq} queries vs float64 CPU "
        f"scoring with a numpy sloppy count ({time.perf_counter() - t0:.1f} "
        f"s; matched docs with the phrase within the slop {n_sloppy}, of "
        f"which not adjacent {n_only}): totals exact, scores within 1e-5, "
        f"tie-tolerant recall@{args.k} = {recall}")
    # ---- highlight the fetched hits of the first batch -----------------
    orig_of = gid_to_orig(reader)
    spec = {"fields": {"body": {}}}
    t0 = time.perf_counter()
    n_hits = n_marked = 0
    for req, res in zip(batches[0], results[0]):
        hits = searcher.fetch_phase(req, res, "msmarco",
                                    list(range(min(10, len(res.doc_ids)))))
        for pos, hit in enumerate(hits):
            orig = int(orig_of[int(res.doc_ids[pos])])
            row = data["tokens"][orig]
            text = " ".join(tn[t] for t in row[row >= 0])
            hl = highlight_hit(spec, {"body": text}, data["mapper"],
                               req.query)
            check(bool(hl) and "<em>" in hl["body"][0],
                  f"hit {hit['_id']} of a sloppy request was not "
                  f"highlighted")
            n_hits += 1
            n_marked += sum(f.count("<em>") for f in hl["body"])
    hl_ms = (time.perf_counter() - t0) * 1e3
    # the highlighter reads sources; this corpus keeps token rows, so each
    # hit's text is rebuilt from its row
    log(f"highlight: the top 10 hits of the first batch's {len(batches[0])} "
        f"requests fetched and highlighted ({n_hits} hits, {n_marked} marks, "
        f"every hit marked) in {hl_ms:.1f} ms on the host")
    stats["highlight_ms"] = hl_ms
    return k11, stats


def phase_k7_large(torch, args, data, name, smi_line) -> dict:
    """The pruned arm past k = 1024 on config 1's impact index: the block-max
    sweep (K7) at k = 1,025, 10,000 and 20,000 through query_phase_batch,
    bit-identical to the eager arm; K7 timed at k = 10,000."""
    from elasticsearch_tpu_torch.ops import blockmax
    searcher, pack = data["impact_searcher"], data["impact_pack"]
    rows = data["qtids"][:8]
    out = {}
    for k in K7_LARGE:
        pruned = batches_of(args, impact_bodies(data, rows, k,
                                                track_total_hits=False))
        eager = batches_of(args, impact_bodies(data, rows, k))
        pr, _, wall_p, launches, _ = drive(torch, searcher, pruned)
        check(launches["blockmax_sweep"] > 0 and
              launches["impact_scan"] == 0,
              f"K7 at k = {k}: the pruned arm did not run K7 alone")
        ea, _, wall_e, launches_e, _ = drive(torch, searcher, eager)
        check(launches_e["impact_scan"] > 0, f"K7 at k = {k}: the eager "
              f"arm did not run K6")
        for qi, (p_, e_) in enumerate(zip(pr[0], ea[0])):
            check(np.array_equal(p_.doc_ids, e_.doc_ids) and np.array_equal(
                p_.scores.view(np.int32), e_.scores.view(np.int32)),
                f"K7 at k = {k}, query {qi}: not bit-identical to the eager "
                f"arm")
        hits = [len(r.doc_ids) for r in pr[0]]
        out[k] = {"pruned_ms": wall_p * 1e3, "eager_ms": wall_e * 1e3,
                  "hits": hits, "launches": launches["blockmax_sweep"]}
        log(f"K7 past 1,024, k = {k}: 8 pruned requests bit-identical to "
            f"the eager arm ({hits} hits); batch wall pruned "
            f"{wall_p * 1e3:.3f} ms, eager {wall_e * 1e3:.3f} ms")
    # K7 alone at k = 10,000 on segment 0 (the running top-k in shared
    # memory: k <= K7_SMEM_K)
    k = 10_000
    qtids, boosts, _, _ = impact_inputs(torch, data, rows)
    s0 = pack.segs[0]
    carry = blockmax.pruned_carry_init(len(rows), k, qtids[0].device)
    seg_args = sweep_args(torch, blockmax, s0, qtids[0],
                          pack.scales[0] * boosts, k)
    first = check_k7(torch, blockmax, carry, seg_args, "k = 10,000")
    ms_ = timed(torch, "K7 at k = 10,000", lambda: blockmax.blockmax_sweep(
        carry, *seg_args, trailing_pad=True), reps=5)
    k7_bytes, k7_ops, union = sweep_work(torch, s0, seg_args, carry, first)
    b_, by = bound(k7_bytes, k7_ops)
    big = 20_000
    carry_big = blockmax.pruned_carry_init(len(rows), big, qtids[0].device)
    args_big = sweep_args(torch, blockmax, s0, qtids[0],
                          pack.scales[0] * boosts, big)
    check_k7(torch, blockmax, carry_big, args_big, "k = 20,000 (global "
             "scratch)")
    log(f"K7 blockmax_sweep [B=8, N={s0['uterms'].shape[0]}, config 1's "
        f"4-term queries, k = {k}]: equal to plain (also k = {big}, past "
        f"the shared-memory top-k); kernel_ms={ms_:.4f} bound_ms={b_:.4f} "
        f"({by}: {k7_bytes} B, {k7_ops} compares over {union} blocks); "
        f"blocks scored {int(first[2].sum())}, skipped "
        f"{int(first[3].sum())}")
    return {"by_k": out, "ms": ms_, "bound_ms": b_, "bound_by": by, "k": k,
            "B": len(rows)}


def phase_percolate_profile(torch, data, stats_p) -> dict:
    """One percolate_many of the 12 probes against the 10,000 bench
    registrations under torch.profiler: card time against the host's
    resolve and render, which phase 27's call of the same items measured
    (``stats_p``)."""
    from elasticsearch_tpu_torch.search import percolator
    dev = data["reader"].device
    pdocs, regs_by_n = perc_bench_registry()
    n_regs = PERC_REGS[-1]
    meta = perc_meta(f"smoke_perc_{n_regs}", PERC_MAPPINGS,
                     regs_by_n[n_regs])
    items = [{"doc": d, "score": True} for d in pdocs]
    rec = stats_p[n_regs]["many"]
    return profile_batch(
        torch, f"percolate_many, {n_regs} registrations x 12 probes",
        lambda: percolator.percolate_many(meta, items, device=dev),
        rec["resolve_ms"], GC.take(), len(items),
        extra=lambda: f"; phase 27's call: host resolve and render "
        f"{rec['resolve_ms']:.3f} ms, the lanes on the host clock "
        f"{rec['lanes_ms']:.3f} ms ({rec['lanes']} lanes, {rec['rows']} "
        f"query rows)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1 << 21,
                    help="corpus size; MS-MARCO has 8,841,823 passages")
    ap.add_argument("--batches", type=int, default=8,
                    help="batches of config 1")
    ap.add_argument("--cfg-batches", type=int, default=4,
                    help="batches of configs 2 and 3 each")
    ap.add_argument("--maxsim-docs", type=int, default=1 << 18,
                    help="docs of the rank_vectors index, in two segments")
    ap.add_argument("--maxsim-batches", type=int, default=2,
                    help="batches of rank_vectors MaxSim, f32 and int8 each")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--terms", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=500_000)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)
    args.cfg_batches = min(args.cfg_batches, args.batches)

    import torch
    try:
        smi_line, name, count = phase_card(torch)
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        phase_build()
        data = phase_data(args)
        kernels = phase_kernels(torch, args, data)
        phase_main_path(torch, args, data, kernels, name, smi_line)
        k3 = phase_phrase_kernel(torch, args, data)
        kernels.append(k3)
        k3["launches_by_config"] = {}
        stats2 = phase_config2(torch, args, data, name, smi_line)
        stats3 = phase_config3(torch, args, data, name, smi_line)
        k3["launches"] = stats2["launches"]["phrase_scan"]
        phase_profile(torch, args, data, "config 1", [
            {"query": {"match": {"body": t}}, "size": args.k}
            for t in data["texts"][:args.batch]])
        phase_profile(torch, args, data, "config 2",
                      config2_bodies(args, data))
        phase_profile(torch, args, data, "config 3",
                      config3_bodies(args, data))
        phase_elementwise(torch, args, data)
        # the knn lane
        k4 = phase_int8_kernel(torch, args, data)
        kernels.append(k4)
        stats4, stats4i = phase_config4(torch, args, data, name, smi_line)
        k4["launches"] = stats4i["launches"]["int8_cosine"]
        stats_h = phase_hybrid(torch, args, data, name, smi_line)
        mdata = phase_maxsim_data(args)
        k5s = phase_maxsim_kernel(torch, args, mdata)
        kernels.extend(k5s)
        stats_m, stats_mi = phase_maxsim(torch, args, mdata, name, smi_line)
        k5s[0]["launches"] = stats_m["launches"]["maxsim"]
        k5s[1]["launches"] = stats_mi["launches"]["maxsim_int8"]
        # the impact lane
        phase_impact_setup(torch, args, data)
        k67 = phase_impact_kernels(torch, args, data)
        kernels.extend(k67)
        stats_ie = phase_impact_eager(torch, args, data, name, smi_line)
        stats_ip = phase_impact_pruned(torch, args, data, name, smi_line)
        stats_ir = phase_impact_rescore(torch, args, data, name, smi_line)
        k67[0]["launches"] = stats_ie["launches"]["impact_scan"]
        k67[1]["launches"] = stats_ip["launches"]["blockmax_sweep"]
        by_config = {"2": stats2, "3": stats3, "4": stats4, "4-int8": stats4i,
                     "hybrid": stats_h, "maxsim": stats_m,
                     "maxsim-int8": stats_mi, "impact-eager": stats_ie,
                     "impact-pruned": stats_ip, "impact-rescore": stats_ir}
        for kern in kernels:
            kern["launches_by_config"] = {
                cfg: st["launches"][kern["name"]]
                for cfg, st in by_config.items()}
        phase_profile(torch, args, data, "config 4 f32",
                      knn_bodies(data["qv4"][:args.batch]))
        phase_profile(torch, args, data, "config 4 int8",
                      knn_bodies(data["qv4"][:args.batch]),
                      searcher=data["searcher_int8"])
        phase_profile(torch, args, data, "hybrid",
                      knn_bodies(data["qvh"][:args.batch], data["texts"]))
        phase_profile(torch, args, mdata, "MaxSim f32",
                      maxsim_bodies(mdata["queries"][:args.batch]))
        phase_profile(torch, args, data, "impact eager", impact_bodies(
            data, data["qtids"][:args.batch], args.k),
            searcher=data["impact_searcher"],
            plan=impact_plan(torch, data, pruned=False))
        phase_profile(torch, args, data, "impact pruned", impact_bodies(
            data, data["q_pruned"][:PRUNED_BATCH], PRUNED_K,
            track_total_hits=False), searcher=data["impact_searcher"],
            plan=impact_plan(torch, data, pruned=True))
        k67[1]["large_k"] = phase_k7_large(torch, args, data, name, smi_line)
        # config 5 and aggregations
        release_lane_state(torch, data, mdata)
        kernels[1]["large_k"] = phase_topk_large(torch, args, data)
        c5 = phase_config5_setup(torch, args, data)
        k89 = phase_agg_kernels(torch, args, data, c5)
        kernels.extend(k89)
        stats5 = phase_config5(torch, args, data, c5, name, smi_line)
        stats5a = phase_config5_aggs(torch, args, data, c5, name, smi_line)
        kernels[1]["large_k"].update(phase_deep_page(torch, args, data, c5))
        by_config.update({"5": stats5, "5-aggs": stats5a})
        for kern in kernels:
            kern["launches_by_config"] = {
                cfg: st["launches"][kern["name"]]
                for cfg, st in by_config.items()}
        for kern in k89:
            kern["launches"] = stats5a["launches"][kern["name"]]
        phase_c5_profile(torch, data, c5, "config 5", c5_reqs(
            data, args.batch, **{"from": C5_FROM, "size": C5_SIZE}))
        prof = phase_c5_profile(torch, data, c5, "config 5 + aggs", c5_reqs(
            data, args.batch, size=10, aggs=C5_AGGS))
        # the device time of one launch on the path, beside the wrapper's
        # event-timed call (K9 is two kernels a launch)
        for kern, key, per_launch in ((k89[0], "K8", 1), (k89[1], "K9", 2)):
            dev_ms, kernels_run = prof.get("parts", {}).get(key, (0.0, 0))
            kern["device_ms"] = dev_ms * per_launch / kernels_run \
                if kernels_run else None
        # the percolator and sloppy phrases
        k10, kernels[0]["percolate_shape"], k3["percolate_shape"] = \
            phase_percolate_kernels(torch, args, data)
        kernels.append(k10)
        stats_p = phase_percolate_bench(torch, args, data, name, smi_line)
        stats_pf = phase_percolate_full(torch, args, data, name, smi_line)
        k11, stats_s = phase_sloppy(torch, args, data, k3, name, smi_line)
        kernels.append(k11)
        k10["launches"] = stats_p["launches"]["percolate_reduce"] + \
            stats_pf["launches"]["percolate_reduce"]
        k11["launches"] = stats_s["launches"]["sloppy_phrase_scan"]
        by_config.update({"percolate": stats_p, "percolate-full": stats_pf,
                          "2-sloppy": stats_s})
        for kern in kernels:
            kern["launches_by_config"] = {
                cfg: st["launches"][kern["name"]]
                for cfg, st in by_config.items()}
        phase_percolate_profile(torch, data, stats_p)
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
