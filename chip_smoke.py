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
32. script kernel — K12 (the script evaluator) against its plain version
            bit for bit (NaN as NaN, -0.0 kept) on segment 0's rows at
            B = 64 x N = 2^20 for a grammar of scripts that uses every
            opcode (the config 3s and 4s scripts among them), at odd
            shapes, with a 60,000-op and a deep program and a pipeline's
            per-row values; the config 3s and 4s scripts timed beside the
            plain version and the bound.
33. config 3s — BASELINE config 3 in its script form: config 3's
            function_score with the gauss decay and a script_score
            ``log(2 + doc['rank'].value) * params.w`` (K1, K12, K2),
            against a float64 CPU scoring.
34. config 4s — BASELINE config 4 in its script form: script_score over
            match_all with ``cosineSimilarity(params.query_vector, 'vec') +
            1.0`` (torch.matmul, K12, K2), against float64 cosines + 1.
35. script fields — config 3s's first batch's top 10 hits fetched with an
            expression field (K12) and a GroovyLite field with a branch,
            against the host's values.
36. script aggs — one request through config 5's shards: a terms agg with
            an avg, a bucket_script and a bucket_selector (one K12 launch
            over the buckets each) and a scripted_metric with an expression
            map script, against numpy.
37. percolate scripts — 1,000 registrations, a tenth function_score with a
            script_score, through a percolate per probe and one
            percolate_many of the 12 probes, against a float64 recompute.
38. profile — one batch of config 3s and of config 4s under
            torch.profiler.
39. leaf kernels — K13 (span programs), K14 (flat span_near), K15 (the
            classic and LM-Dirichlet similarities in K1's scan) and K16
            (term-set membership) against their plain versions at the
            shapes the leaf paths give them on segment 0 (B = 64, N = 2^20,
            L = 224) and at odd shapes: bit-identical for K13-K15, equal
            masks for K16; timed beside the plain versions (on queries 0,
            31, 32 and 63 where a batch takes seconds), the bounds and
            torch.isin for K16.
40. span_near — 3 span_terms of the sampled terms, unordered with slop 3
            and in order with slop 2 (K14, K2), LEAF_BATCHES batches each.
41. span tree — span_not over span_near(span_or, span_multi of a 4-digit
            prefix (100 terms), span_term), pre 1, post 1 (K13, K2).
42. containing, within, first — span_containing and span_within of a
            span_term in a span_near with slop 8, span_first (end 10) over
            a span_or (K13, K2). Phases 40-42 re-count the first request's
            hits on the host's token rows.
43. multi-term filters — bool with config 1's match and a prefix (100
            terms), a wildcard (1,000 terms) or a fuzzy term
            (K16, K1, K2), each request with its own pattern (a plan
            signature holds one set size, so one batch a size; a prefix
            and a wildcard batch hold MULTI_TERM_BATCH requests, a fuzzy
            batch FUZZY_BATCH), the expanded sets counted with numpy.
44. similarities — config 1's match on the body field mapped classic,
            then LMDirichlet (mu 2000), over the same installed segments
            (K15, K2; K1 must not run).
45. compound leaves — one batch each of multi_match (best_fields,
            tie_breaker 0.3), dis_max, boosting, common (cutoff 0.001),
            query_string and more_like_this on 4 like-texts (K1, K2).
            Phases 40-45 hold the first and the last request of every
            batch against the plain versions on the card's tensors (totals
            exact, the hits' scores bit for bit) and a float64 recompute
            from the host's rows (scores within 1e-5, tie-tolerant recall
            1.0).
46. profile — one batch of the span tree under torch.profiler (one recorded
            run: phase 41 ran the batch).
47. geo kernels — config 1's segments get a geo_point column ``location``
            (OpenStreetMap-shaped: 1,000 Zipf-weighted centres, most over
            Europe and North America, a tenth uniform; the Rally geopoint
            track cut from 60.8M points to the reader's 2,097,152) and a
            geo_shape column ``area`` (a few hundred OSM-shaped templates
            made by the port's parse_shape_rings, translated to each row's
            point; every row padded to the widest, V = 32); K17 in every mode
            and K18 in every relation against their plain versions bit for
            bit at the geo paths' shapes on segment 0 and at odd shapes,
            timed beside the plain versions and the bounds.
48. geo paths — batches of 64 with config 1's match in a bool's must and
            a geo leaf in its filter, each centre moved by up to 1°:
            geo_polygon, geo_bounding_box (and across the dateline),
            geo_distance, geo_distance_range, geohash_cell with neighbours,
            exists, a gauss decay under function_score, and geo_shape in
            each relation against an envelope, a circle and a polygon with a
            hole (one batch each); the first and the last
            request of each batch held against the plain versions on the
            card's tensors (totals exact, scores bit for bit) and a float64
            recompute from the f32 coordinates the card holds (filtered sets
            equal outside the libms' band, scores within 1e-5, tie-tolerant
            recall 1.0); K17 or K18, K1 and K2 must have launched (exists
            reads the column's exists mask: K1 and K2).
49. geo aggs — one request inside 400 km with geohash_grid (and a
            geo_centroid sub), geo_distance rings and geo_bounds, through
            query_phase and merge_responses, against numpy; the host
            collectors timed apart.
50. geo percolate — 1,000 registrations (geo_distance, geo_bounding_box,
            geo_shape on the eager lane), a percolate per probe and one
            percolate_many of 12 probes, against a float64 recompute and
            percolate_serial.
51. profile — one geo_distance and one geo_shape batch under
            torch.profiler.
52. nested kernels — config 1's segments get a nested path ``answers``
            (Rally's nested track, StackOverflow questions and answers:
            a negative binomial count a question, mean 1.5, 47% with none,
            a tail into the dozens; answers.user Zipf 1.1 over 100,000
            users, answers.date uniform over 2008-2016, answers.body 1-16
            words from the corpus generator), built by
            carry.nested_block_from_arrays and packed onto the card; K19 in
            every score_mode against its plain version bit for bit on the
            inputs the nested match path gives it (B = 64, N = 2^20, its
            answers) and at odd shapes (parents without children and one
            with 1,000, a deleted parent, every child dead, NaN and ±0.0
            scores, B = 65), timed beside the plain version,
            scatter_reduce_ and the bound.
53. nested paths — batches of 64, each request with its own sampled user,
            date or terms: Rally's randomized nested query (a term and a
            date range in one answer, score_mode none), a nested match on
            answers.body in avg and in sum, config 1's match with a nested
            date-range filter (K19, K2, and K1 where a match runs); the
            first and the last request of each batch held against the plain
            versions on the card's tensors and a float64 recompute from the
            host's rows, each path's p50 and (one batch under
            torch.profiler) the card's busy share; then nested >
            date_histogram > reverse_nested > terms and nested >
            reverse_nested > stats through query_phase and merge_responses
            against numpy; and 1,000 nested registrations through a
            percolate per probe and one percolate_many of 12 probes,
            against a float64 recompute and percolate_serial.

54. plane kernels — config 5's 8 engines (phase 21's) behind the
            collective plane on a mesh of the one card (a NCCL group of one
            rank, 8 shards on it); K20 (the field-sort selection) against
            its plain version bit for bit on the inputs the plane gives it
            (B = 64 x 2^18 rows with 3 and 5 key rows, the per-doc columns
            at stride 0, at k = 1,024 and 32,768; the local merge, 64 x 8
            x 1,024 entries of per-(row, entry) keys) and at odd shapes
            (M = 100,003, ±0.0, NaN, ±inf, an all-tie column, k > M, an
            empty mask, a cursor); the row-batched K8 (ordinal, histogram)
            and K9 against 64 one-row launches and their plain versions on
            shard 0's [64, 2^18] agg mask; each timed beside its plain
            version and its bound.
55. collective plane — batches of 64 through MeshEngineSearcher.
            search_batch, launch counters set to 0 just before and read just
            after: (a) score order from 500, size 500, per-shard statistics,
            bit-identical to phase 23's fan-out; (b) the same with the DFS
            round, against float64 BM25 with global statistics; (c) sort by
            rank desc, size 100; (d) cat asc, rank desc; (e) (c)'s next page
            by search_after; (f) post_filter + min_score; (g) size 10 with
            terms, stats and histogram (against numpy and phase 24's merge);
            (h) an untimed deep field-sort page at from 20,000; (c)-(h) held
            against a numpy recompute in float64; p50 a batch of (a), (c),
            (g); one batch of (a) and of (c) under torch.profiler.
56. DistributedBM25 — config 5's 8 shards' text columns on the same mesh,
            one batch at k = 1,000 against float64 BM25 with global
            statistics; then the plane's blocks and group are released.

The last lines are one JSON object of per-kernel numbers, the nvidia-smi
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# queries of configs 2-4, the hybrid and the sloppy phrase held against the
# float64 CPU scoring (4 since the nested slice, from 8, so that the whole
# run stays well under 20 minutes)
CHECK_QUERIES = 4

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
K12_SOURCE = "elasticsearch_tpu_torch/csrc/script_eval.cu"
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
K12_REPLACES = "elasticsearch_tpu/search/scripts.py:114"
K13_SOURCE = "elasticsearch_tpu_torch/csrc/span_program.cu"
K14_SOURCE = "elasticsearch_tpu_torch/csrc/span_near.cu"
K15_SOURCE = K1_SOURCE            # sim_scan_launch, K1's scan instantiated
K16_SOURCE = "elasticsearch_tpu_torch/csrc/term_set_scan.cu"
K13_REPLACES = "elasticsearch_tpu/ops/spans.py:32"
K14_REPLACES = "elasticsearch_tpu/ops/phrase.py:130"
K15_REPLACES = "elasticsearch_tpu/ops/lexical.py:58"
K16_REPLACES = "elasticsearch_tpu/search/execute.py:820"
K17_SOURCE = "elasticsearch_tpu_torch/csrc/geo_points.cu"
K18_SOURCE = "elasticsearch_tpu_torch/csrc/geo_shape.cu"
K17_REPLACES = "elasticsearch_tpu/ops/filters.py:79"
K18_REPLACES = "elasticsearch_tpu/ops/geoshape.py:117"
K19_SOURCE = "elasticsearch_tpu_torch/csrc/nested_reduce.cu"
K19_REPLACES = "elasticsearch_tpu/search/execute.py:1040"
# the query leaves: batches of each span and similarity path (1 since the
# nested slice, from 2, for the run's margin); the prefix and wildcard
# batches' size (each pattern costs a scan of the 500,000-term dictionary
# of each segment on the host; 64 until the nested slice) and a fuzzy
# batch's (each value a Levenshtein pass over it)
LEAF_BATCHES = 1
MULTI_TERM_BATCH = 16
FUZZY_BATCH = 1


def plain_queries(b):
    """The queries of a batch of b that the leaf kernel phase holds against
    the plain versions where a batch of them takes seconds: the first and
    the last of each half (0, 31, 32 and 63 at b = 64), so both 32-query
    passes of K13 and K14 are compared."""
    return sorted({0, max(b // 2 - 1, 0), b // 2, b - 1})


def checked_requests(n):
    """The requests of a batch of n that the leaf paths hold against the
    plain versions and float64: the first and the last."""
    return sorted({0, n - 1})
# config 4 (bench.py:703-717): 768-d unit vectors, k = num_candidates = 100
VEC_DIMS = 768
KNN_K = 100
# the rank_vectors index: ColBERT-shaped (128-d tokens, the mapping's
# default max_tokens 32), two 2^17-row segments so the merge runs
MAXSIM_DIMS = 128
MAXSIM_TOKENS = 32
MAXSIM_CHECK_QUERIES = 2       # 4 until the nested slice
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


T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of output, with the seconds since the script started."""
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f} s] {msg}",
          flush=True)


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
                chunk: int = 1_000_000, median: float = 50.0,
                min_len: int = 10, max_len: int = 224):
    lens = np.clip(rng.lognormal(np.log(median), 0.45, n_docs),
                   min_len, max_len).astype(np.int32)
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


#: nvcc's -Xptxas -v report of each source, from phase_build
BUILD_LOGS: dict = {}


def phase_build():
    from elasticsearch_tpu_torch.ops import cuda_build
    sources = [Path(src).name for src in (K1_SOURCE, K2_SOURCE, K3_SOURCE,
                                          K4_SOURCE, K5_SOURCE, K6_SOURCE,
                                          K7_SOURCE, K8_SOURCE, K9_SOURCE,
                                          K10_SOURCE, K11_SOURCE, K12_SOURCE,
                                          K13_SOURCE, K14_SOURCE,
                                          K16_SOURCE, K17_SOURCE,
                                          K18_SOURCE, K19_SOURCE,
                                          K20_SOURCE)]
    t0 = time.perf_counter()
    built = cuda_build.build_libraries(sources)
    BUILD_LOGS.update({src: info["log"] for src, info in built.items()})
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
        "sum per (query, row) (45.875 KiB at B = 64, T = 2); script_eval "
        "the program and its constants, 8 B an op or constant (a program "
        "past 200 KiB runs from global memory); span_program per warp each "
        "field's row, a key index per position a term set, the stack of "
        "maps, four scratch maps and an f32 per (query, row) (up to 8 "
        "warps as the row width allows); span_near_scan per warp a row and "
        "a term mask per position and an f32 per (query, row); sim_scan "
        "bm25_scan's layout (LM Dirichlet a second word per (query, term)); "
        "term_set_scan the batch's sorted union of set terms when it holds "
        "40,960 ids or fewer, else none; geo_points a query group's "
        "parameters and rings, up to 48 KiB (a longer ring is read from "
        "global memory); geo_shape the query's ring structure and a query "
        "group's coordinates, up to 48 KiB (likewise); nested_reduce none "
        "(a thread a (query, parent)); sort_select a tile's composite keys, "
        "(key rows + 1) words an entry, and a 2-byte index an entry (54 KiB "
        "at 2,048 entries and 5 key rows)")


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
    (f32 and int8), the impact lane's columns and block tables, the geo
    columns and the nested child blocks."""
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
    geo = sum(nbytes(t) for s in reader.segments
              for c in list(s.geo.values()) + list(s.shape.values())
              for t in vars(c).values()
              if t is not None and hasattr(t, "element_size"))
    nested = sum(reader._segment_bytes(blk.child) + nbytes(blk.parent)
                 + nbytes(blk.offsets) for s in reader.segments
                 for blk in s.nested.values())
    rest = total - rank - tokens - masks - f32 - int8 - impacts - geo - \
        nested
    return (f"reader device bytes {total} (text and live columns "
            f"{rest}, rank column {rank}, position matrices {tokens}, vector "
            f"exists/lens {masks}, vector matrices f32 {f32}, int8 {int8}, "
            f"impact columns and block tables {impacts}, geo_point and "
            f"geo_shape columns {geo}, nested child blocks {nested})")


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
        aggs_ops, blockmax, filters, geoshape, lexical, maxsim, nested,
        percolate, phrase, script_ops, spans, topk, vector)
    return {"bm25_scan": lexical.BM25_SCAN, "stable_topk": topk.TOPK,
            "phrase_scan": phrase.PHRASE_SCAN,
            "sloppy_phrase_scan": phrase.SLOPPY_PHRASE_SCAN,
            "percolate_reduce": percolate.PERCOLATE_REDUCE,
            "int8_cosine": vector.INT8_COSINE, "maxsim": maxsim.MAXSIM,
            "maxsim_int8": maxsim.MAXSIM_INT8,
            "impact_scan": blockmax.IMPACT_SCAN,
            "blockmax_sweep": blockmax.BLOCKMAX_SWEEP,
            "agg_counts": aggs_ops.AGG_COUNTS,
            "agg_stats": aggs_ops.AGG_STATS,
            "agg_counts_rows": aggs_ops.AGG_COUNTS_ROWS,
            "agg_stats_rows": aggs_ops.AGG_STATS_ROWS,
            "sort_select": topk.SORT_SELECT,
            "script_eval": script_ops.SCRIPT_EVAL,
            "span_program": spans.SPAN_PROGRAM,
            "span_near_scan": phrase.SPAN_NEAR_SCAN,
            "sim_scan": lexical.SIM_SCAN,
            "term_set_scan": lexical.TERM_SET_SCAN,
            "geo_point_filter": filters.GEO_POINT_FILTER,
            "shape_relation": geoshape.SHAPE_RELATION,
            "nested_reduce": nested.NESTED_REDUCE}


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
                  plan=None, warmup=True) -> dict:
    """One batch under torch.profiler (after an unrecorded warm-up run of
    it, unless ``warmup`` is False: a batch an earlier phase ran): device
    time by kernel, the busy share of the batch, and the host planning of
    the batch alone (a pure knn request plans no query; the impact lane's
    planning is ``plan``, called with the batch)."""
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
        plan_ms, GC.take(), len(batch), warmup=warmup)


def profile_batch(torch, label, run, plan_ms, plan_gc, size,
                  extra=None, warmup=True) -> dict:
    """``run`` (one batch of ``size`` requests) twice under torch.profiler,
    the first unrecorded (once, recorded, without ``warmup``): device time
    by kernel, the busy share of the batch; ``extra()`` adds to the
    line."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # the batch twice: a warm-up step the profiler does not record (its own
    # start-up cost lands there), then the recorded step; without warmup
    # the one run is recorded whole
    recorded = []
    stepped = {"schedule": torch.profiler.schedule(wait=0, warmup=1,
                                                   active=1),
               "on_trace_ready": lambda p: recorded.append(
                   p.key_averages())} if warmup else {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **stepped) as prof:
        for _ in range(2 if warmup else 1):
            t0 = time.perf_counter()
            run()
            wall_ms = (time.perf_counter() - t0) * 1e3
            batch_gc = GC.take()
            if warmup:
                prof.step()
    if not warmup:
        recorded.append(prof.key_averages())
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
    by_kernel = {"K1": ("bm25_scan_kernel<0>",),
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
                 "K12": ("script_eval_kernel",),
                 "K13": ("span_program_kernel",),
                 "K14": ("span_near_kernel",),
                 "K15": ("bm25_scan_kernel<1>", "bm25_scan_kernel<2>"),
                 "K16": ("term_set_scan_kernel",),
                 "K17": ("geo_points_kernel",),
                 "K18": ("geo_shape_kernel",),
                 "K19": ("nested_reduce_kernel",),
                 "K20": ("select_tile_kernel", "select_merge_kernel"),
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
    data["cos4"] = cos                  # config 4s holds the same queries
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
    return {"shards": shards, "per_shard": per_shard, "cat": cat, "ms": ms,
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
    # the first batch's pages: phase 55 holds the collective plane to them
    stats = {"qps": n / wall, "p50_ms": statistics.median(per_batch),
             "merge_ms_per_request": sum(merge_ms) / n, "launches": launches,
             "responses": results[0]}
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
             "merge_ms_per_request": sum(merge_ms) / n, "launches": launches,
             "responses": results[0]}
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
    """One config-5 batch under torch.profiler (one recorded run: the
    config 5 phases ran the batch): device time by kernel, busy share, the
    host planning of the batch on every shard alone and the coordinator's
    host merge."""
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
        extra=lambda: f"; coordinator host merge {merges[-1]:.3f} ms",
        warmup=False)


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
    registrations under torch.profiler (one recorded run: phase 27 made
    the same call): card time against the host's resolve and render,
    which phase 27's call of the same items measured (``stats_p``)."""
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
        f"query rows)", warmup=False)


# --------------------------------------------------------------------------
# scripts (phases 32-38)
# --------------------------------------------------------------------------

#: BASELINE config 3's script (lang-expression) and config 4's script_score
CONFIG3S_SCRIPT = "log(2 + doc['rank'].value) * params.w"
CONFIG3S_W = 1.5
CONFIG4S_SCRIPT = "cosineSimilarity(params.query_vector, 'vec') + 1.0"
#: scripts that between them use every opcode of K12, over the columns
#: ``a`` (a seeded column with NaN, ±inf, -0.0 and missing values) and
#: ``rank``, the query scores, params ``t`` and ``w`` and the 768-d vectors
SCRIPT_GRAMMAR = [
    CONFIG3S_SCRIPT,
    CONFIG4S_SCRIPT,
    "doc['a'].value * 2 + 1 - doc['rank'].value / 3",
    "doc['a'].value % -2.5 + min(doc['a'].value, doc['rank'].value, 40)",
    "max(doc['a'].value, -doc['a'].value) + abs(doc['rank'].value)",
    "floor(doc['a'].value) + ceil(doc['rank'].value) + doc['a'].value ** 3",
    "doc['a'].value ** -2 + doc['rank'].value ** 0.5 "
    "+ pow(doc['rank'].value, 1.5)",
    "log(doc['rank'].value + 1) * _score + ln(2) + log10(doc['rank'].value)",
    "sqrt(doc['rank'].value) + exp(-doc['rank'].value / 50) + 1/3 * _score",
    "sigmoid(doc['rank'].value) + sigmoid(doc['rank'].value, 2, 3) "
    "+ saturation(doc['rank'].value, 10)",
    "(doc['a'].value if doc['a'].value > params.t else _score) "
    "+ params.w * 2",
    "1 < doc['a'].value < 30 and doc['rank'].value >= 5 or doc['a'].empty",
    "not doc['a'].value or not 0",
    "doc['a'].value == doc['a'].value and True",
    "doc['a'].value != doc['rank'].value",
    "doc['a'].value <= doc['rank'].value",
    "(doc['a'].empty + 7) % 3 + (doc['a'].empty - 3) % -2 "
    "+ (doc['a'].empty + 1) % 0",
    "(doc['a'].empty + 2) ** (doc['a'].empty + 1) + doc['a'].empty ** 2 "
    "+ abs(-3) * (doc['rank'].empty + 0)",
    "-(doc['a'].empty + 0) + 2147483647 + min(doc['a'].empty, 2) "
    "+ max(doc['a'].empty + 0, 1)",
    "(doc['a'].empty + 1) > 1 or (doc['a'].empty + 1) < 2 "
    "or (doc['a'].empty + 1) <= 0 or (doc['a'].empty + 1) >= 3 "
    "or (doc['a'].empty + 1) == 1 or (doc['a'].empty + 1) != 2",
    "max(doc['a'].empty, doc['rank'].empty) + min(doc['a'].empty, "
    "doc['rank'].empty) + doc['a'].empty * doc['rank'].empty",
    "1 if doc['a'].empty else 2.5",
    "doc['a'].empty if doc['a'].value else 3",
    "dotProduct(params.query_vector, 'vec') * 0.5 + _score",
    "doc['a'].value / 0 + doc['a'].value * 1e40 + doc['a'].value % 0",
    "(doc['a'].empty + 1) / 2",
]
#: 500 parenthesized 60-term products: past K12's shared-memory stage
LONG_SCRIPT = " + ".join(
    "(" + " * ".join(["doc['rank'].value"] * 60) + ")" for _ in range(500))
#: a stack deeper than 32 words
DEEP_SCRIPT = "+".join(["(doc['a'].value"] * 40) + ")" * 40
#: a bucket pipeline's per-row names, every kind of per-row value
PIPELINE_SCRIPT = "log(a) * b + min(b, 2) + (c and a > 0)"
#: the script fields fetched for config 3s's first batch: an expression
#: (K12) and a GroovyLite script with a branch (the host, per hit)
SMOKE_SCRIPT_FIELDS = {
    "doubled": {"script": "doc['rank'].value * 2"},
    "branch": {"script": "def r = doc['rank'].value; "
                         "if (r > 50) { return 'hi' } else { return r * 2 }"}}
PERC_SCRIPT_REGS = 1000
PERC_SCRIPT_SOURCE = "_score * params.k + doc['rank'].value / 100"
PERC_SCRIPT_K = 2.0


def script_args(torch, prog, inputs, b, n):
    """K12's arguments for ``prog`` over the first ``n`` rows of the
    phase's inputs and its first ``b`` queries."""
    dev = inputs["score"].device
    cols = [(inputs[f][0][:n].contiguous(), inputs[f][1][:n].contiguous())
            for f in prog.columns]
    prods = []
    for cosine, _, _ in prog.products:
        q = inputs["qv"][:b]
        if cosine:
            q = q / torch.sqrt((q * q).sum(dim=-1, keepdim=True) + 1e-12)
        prods.append((torch.matmul(q, inputs["vecs"][:n].T).contiguous(),
                      inputs["vexists"][:n].contiguous()))
    params = inputs["params"][:b, [["t", "w"].index(k) for k in
                                   prog.params]].contiguous()
    return (prog.code, cols, inputs["score"][:b, :n].contiguous(), prods,
            params, torch.zeros((0, n), dtype=torch.int32, device=dev), b, n)


def check_k12(torch, script_ops, args, what) -> None:
    got = script_ops.script_eval(*args)
    want = script_ops.script_eval_plain(*args)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"K12 result type differs from its plain version ({what})")
    if got.dtype == torch.float32:
        nan = torch.isnan(want)
        check(torch.equal(torch.isnan(got), nan) and torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32)),
            f"K12 is not bit-identical to its plain version ({what})")
    else:
        check(torch.equal(got, want),
              f"K12 differs from its plain version ({what})")


def phase_script_kernel(torch, args, data) -> dict:
    """K12 against its plain version, bit for bit, on segment 0's rows
    (B = 64 x N = 2^20) for every script of the grammar (the config 3s and
    4s scripts among them), then at odd shapes with the long and the deep
    program and a pipeline's per-row values; the config 3s and 4s scripts
    timed beside the plain version and the bound."""
    from elasticsearch_tpu_torch.ops import script_ops
    from elasticsearch_tpu_torch.search import scripts
    reader = data["reader"]
    seg = reader.segments[0]
    dev = reader.device
    n, b = seg.padded_docs, args.batch
    rank = seg.numeric["rank"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 32)
    a = rank.hi - 50.0
    a[:6] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0,
                          0.0, 2.0], device=dev)
    a_exists = torch.rand(n, generator=gen, device=dev) > 0.2
    a_exists[:6] = True
    vcol = reader.fetch_vectors(seg, "vec", "f32")
    inputs = {
        "a": (a, a_exists), "rank": (rank.hi, rank.exists),
        "score": torch.rand((b, n), generator=gen, device=dev) * 12.0,
        "vecs": vcol.vecs, "vexists": vcol.exists,
        "qv": torch.from_numpy(data["qv4"][:b]).to(dev),
        "params": torch.stack([10.0 + torch.arange(b, device=dev),
                               torch.full((b,), CONFIG3S_W, device=dev)],
                              dim=1).float()}
    sparams = {"t": 10.0, "w": CONFIG3S_W, "query_vector": [0.0] * VEC_DIMS}
    every = {v for k, v in vars(script_ops).items()
             if k.isupper() and isinstance(v, int)}
    seen = set()
    for source in SCRIPT_GRAMMAR:
        prog = scripts.compile_script(source).lower("query", sparams)
        seen |= {int(o) for o in prog.code.ops[:, 0]}
        for bb, nn in ((b, n), (1, min(n, 1001)), (3, min(n, 100_003))):
            check_k12(torch, script_ops, script_args(torch, prog, inputs,
                                                     bb, nn),
                      f"{source[:40]!r} at B={bb}, N={nn}")
    for source, bb, nn in ((LONG_SCRIPT, 3, 4099), (DEEP_SCRIPT, b, 4099)):
        prog = scripts.compile_script(source).lower("query", sparams)
        check_k12(torch, script_ops, script_args(torch, prog, inputs, bb,
                                                 nn),
                  f"{len(prog.code.ops)} ops, depth {prog.code.depth}")
    prog = scripts.compile_script(PIPELINE_SCRIPT).lower(
        "pipeline", {}, {"a": 2.0, "b": 3, "c": True})
    seen |= {int(o) for o in prog.code.ops[:, 0]}
    rows = [{"a": 0.5 + i, "b": i - 3, "c": bool(i % 2)} for i in range(1001)]
    check_k12(torch, script_ops, (prog.code, [], None, [], None, torch.from_numpy(
        prog.row_words(rows)).to(dev), 1, len(rows)), "a pipeline's rows")
    check(seen >= every, f"the grammar misses opcodes {sorted(every - seen)}")
    log(f"K12 script_eval: {len(SCRIPT_GRAMMAR)} scripts (every opcode) "
        f"bit-identical to plain (NaN as NaN, -0.0 kept) at B={b} x N={n} "
        f"(segment 0), B=1 x N=1001 and B=3 x N=100003; a "
        f"{len(scripts.compile_script(LONG_SCRIPT).lower('query', sparams).code.ops)}"
        f"-op program (past the shared-memory stage) and a depth-"
        f"{scripts.compile_script(DEEP_SCRIPT).lower('query', sparams).code.depth}"
        f" one (the 1024-word stack), and a pipeline's per-row values, "
        f"bit-identical too")
    out = {}
    for label, source in (("3s", CONFIG3S_SCRIPT), ("4s", CONFIG4S_SCRIPT)):
        prog = scripts.compile_script(source).lower("query", sparams)
        k12_args = script_args(torch, prog, inputs, b, n)
        ms = timed(torch, f"K12 config {label}", lambda: script_ops.
                   script_eval(*k12_args), reps=20)
        plain_ms = timed(torch, f"K12 plain config {label}", lambda:
                         script_ops.script_eval_plain(*k12_args), reps=2)
        nbytes_ = script_ops.script_eval_bytes(prog.code, b, n)
        # every op that is not a load is one operation a (query, row)
        b_ms, b_by = bound(nbytes_, int((prog.code.ops[:, 0] >= script_ops.
                                         B2I).sum()) * b * n)
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "bytes": nbytes_,
                      "ops": len(prog.code.ops)}
        log(f"K12 script_eval config {label} [{source!r}, {len(prog.code.ops)} "
            f"ops, B={b}, N={n}]: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}: {nbytes_} B) library_ms=null")
    ptxas = [line.strip() for line in BUILD_LOGS.get("script_eval.cu", "")
             .splitlines() if "registers" in line or "spill" in line]
    main = out["3s"]
    return {"name": "script_eval", "route": "cuda", "source": K12_SOURCE,
            "replaces": K12_REPLACES, "launches": 0, "max_abs_err": 0.0,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "library_null": "no single torch call evaluates an expression "
                            "tree",
            "shape": {"B": b, "N": n, "script": CONFIG3S_SCRIPT},
            "config_4s": out["4s"], "ptxas": ptxas}


def config3s_bodies(args, data) -> list[dict]:
    """BASELINE config 3 in its script form: config 3's function_score with
    the gauss decay and a script_score (lang-expression) under score_mode
    and boost_mode multiply."""
    functions = [{"field_value_factor": {"field": "rank",
                                         "modifier": "log1p",
                                         "factor": 1.0}},
                 {"gauss": {"rank": {"origin": 50, "scale": 20}}},
                 {"script_score": {"script": {
                     "source": CONFIG3S_SCRIPT,
                     "params": {"w": CONFIG3S_W}}}}]
    return [{"query": {"function_score": {
        "query": {"match": {"body": t}}, "functions": functions,
        "score_mode": "multiply", "boost_mode": "multiply"}},
        "size": args.k}
        for t in data["texts"][:args.cfg_batches * args.batch]]


def config4s_bodies(qvs) -> list[dict]:
    """BASELINE config 4 in its script form: script_score over match_all
    with cosineSimilarity + 1.0, size 100."""
    return [{"query": {"script_score": {
        "query": {"match_all": {}},
        "script": {"source": CONFIG4S_SCRIPT,
                   "params": {"query_vector": v.tolist()}}}},
        "size": KNN_K} for v in qvs]


def phase_config3s(torch, args, data, name, smi_line) -> dict:
    batches = batches_of(args, config3s_bodies(args, data))
    results, per_batch, wall, launches, peak = drive(
        torch, data["searcher"], batches)
    stats = report("config 3s (function_score with script_score)", args,
                   data, batches, per_batch, wall, launches, peak, name,
                   smi_line, ("bm25_scan", "script_eval", "stable_topk"))
    nq = CHECK_QUERIES
    t0 = time.perf_counter()
    bm25 = cpu_scores(data["uterms"], data["utf"], data["lens"], data["df"],
                      data["qtids"][:nq])
    rank = data["rank"]
    sigma2 = -(20.0 ** 2) / (2.0 * np.log(0.5))
    factor = np.log10(rank + 1.0) * np.exp(
        -np.maximum(np.abs(rank - 50.0), 0.0) ** 2 / (2.0 * sigma2)) * (
        np.log(2.0 + rank) * CONFIG3S_W)
    recall = check_vs_cpu("config 3s", args, results[0][:nq],
                          [s * factor for s in bm25], [s > 0 for s in bm25],
                          gid_to_orig(data["reader"]))
    log(f"config 3s: first {nq} queries vs independent float64 CPU scoring "
        f"({time.perf_counter() - t0:.1f} s): totals exact, scores within "
        f"1e-5, tie-tolerant recall@{args.k} = {recall}")
    stats["first_batch"] = (batches[0], results[0])
    return stats


def phase_config4s(torch, args, data, name, smi_line) -> dict:
    check(not torch.backends.cuda.matmul.allow_tf32 and
          torch.get_float32_matmul_precision() == "highest",
          "TF32 is on for float32 matrix products")
    batches = batches_of(args, config4s_bodies(data["qv4"]))
    results, per_batch, wall, launches, peak = drive(
        torch, data["searcher"], batches)
    stats = report("config 4s (script_score cosineSimilarity)", args, data,
                   batches, per_batch, wall, launches, peak, name, smi_line,
                   ("script_eval", "stable_topk"))
    nq = CHECK_QUERIES
    t0 = time.perf_counter()
    reader = data["reader"]
    cos = data.pop("cos4")      # config 4's float64 cosines of these queries
    everyone = [np.ones(len(data["lens"]), bool)] * nq
    recall = check_vs_cpu("config 4s", args, results[0][:nq],
                          [c + 1.0 for c in cos], everyone,
                          gid_to_orig(reader), k=KNN_K, rtol=0,
                          tie_tol=1e-5)
    log(f"config 4s: first {nq} queries vs float64 cosines + 1.0 "
        f"({time.perf_counter() - t0:.1f} s): totals {len(data['lens'])}, "
        f"scores within 1e-5, tie-tolerant recall@{KNN_K} = {recall}")
    return stats


def reset_launches():
    counters = path_kernels()
    for kern in counters.values():
        kern.launches = 0
    return counters


def read_launches(counters) -> dict:
    return {name: kern.launches for name, kern in counters.items()}


def phase_script_fields(torch, args, data, stats3s) -> dict:
    """The top 10 hits of each request of config 3s's first batch fetched
    with an expression script field (K12, once a segment and script) and a
    GroovyLite one with a branch (the host, per hit), against the host's
    rank values."""
    searcher = data["searcher"]
    batch, results = stats3s.pop("first_batch")
    orig_of = gid_to_orig(data["reader"])
    torch.cuda.synchronize()
    counters = reset_launches()
    t0 = time.perf_counter()
    fetched = []
    for req, res in zip(batch, results):
        sreq = dataclasses.replace(req, script_fields=SMOKE_SCRIPT_FIELDS)
        fetched.append((res, searcher.fetch_phase(
            sreq, res, "msmarco", list(range(min(10, len(res.doc_ids)))))))
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches(counters)
    check(launches["script_eval"] > 0, "script_fields launched no K12")
    n_hits = n_hi = 0
    for res, hits in fetched:
        for pos, hit in enumerate(hits):
            r64 = float(data["rank"][orig_of[int(res.doc_ids[pos])]])
            check(hit["fields"]["doubled"] == [float(np.float32(r64)) * 2],
                  f"script field doubled of hit {hit['_id']}: "
                  f"{hit['fields']['doubled']}, rank {r64}")
            want = "hi" if r64 > 50 else r64 * 2
            check(hit["fields"]["branch"] == [want],
                  f"script field branch of hit {hit['_id']}: "
                  f"{hit['fields']['branch']}, rank {r64}")
            n_hits += 1
            n_hi += want == "hi"
    log(f"script_fields: the top 10 hits of config 3s's first batch "
        f"({len(batch)} requests, {n_hits} hits, {n_hi} on the 'hi' branch) "
        f"with an expression field (K12) and a GroovyLite field, equal to "
        f"the host's values, in {ms:.1f} ms; launches {launches}")
    return {"launches": launches, "ms": ms}


def phase_script_aggs(torch, args, data, c5) -> dict:
    """One request through config 5's 8 shards and merge_responses: a terms
    agg over cat with an avg of rank, a bucket_script and a bucket_selector
    (one K12 launch over the buckets each), and a scripted_metric with an
    expression map script (K12 a segment); against numpy."""
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    matched = [m for _, m in c5["cpu"][0]]
    counts = np.zeros(len(C5_CATS), np.int64)
    for sh, m in zip(c5["shards"], matched):
        counts += np.bincount(c5["cat"][sh["lo"] + np.nonzero(m)[0]],
                              minlength=len(C5_CATS))
    thresh = float(np.sqrt(np.median(counts[counts > 0])))
    body = {"query": {"match": {"body": data["texts"][0]}}, "size": 10,
            "aggs": {
                "by_cat": {"terms": {"field": "cat", "size": len(C5_CATS)},
                           "aggs": {
                    "avg_rank": {"avg": {"field": "rank"}},
                    "lg": {"bucket_script": {
                        "buckets_path": {"a": "avg_rank", "c": "_count"},
                        "script": "log(a + 1) * c"}},
                    "keep": {"bucket_selector": {
                        "buckets_path": {"c": "_count"},
                        "script": f"sqrt(c) > {thresh!r}"}}}},
                "sm": {"scripted_metric": {
                    "map_script": "doc['rank'].value * 2"}}}}
    req = parse_search_request(body)
    torch.cuda.synchronize()
    counters = reset_launches()
    t0 = time.perf_counter()
    (resp,), _ = c5_batch(c5, [req])
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches(counters)
    check(launches["script_eval"] > 0, "the script aggs launched no K12")
    aggs = resp["aggregations"]
    sums = np.zeros(len(C5_CATS))
    sm_vals = []
    for sh, m in zip(c5["shards"], matched):
        rows = sh["lo"] + np.nonzero(m)[0]
        np.add.at(sums, c5["cat"][rows], c5["rank"][rows])
        sm_vals.extend((c5["rank_hi"][rows].astype(np.float64) * 2).tolist())
    kept = [i for i in range(len(C5_CATS)) if counts[i] and
            np.sqrt(np.float32(counts[i])) > np.float32(thresh)]
    kept.sort(key=lambda i: (-counts[i], C5_CATS[i]))
    got = aggs["by_cat"]["buckets"]
    check([(b["key"], b["doc_count"]) for b in got] ==
          [(C5_CATS[i], int(counts[i])) for i in kept],
          "script aggs: the selector kept other buckets than numpy")
    check(0 < len(kept) < int((counts > 0).sum()),
          "script aggs: the selector kept every bucket or none")
    for bk, i in zip(got, kept):
        avg = sums[i] / counts[i]
        check(abs(bk["avg_rank"]["value"] - avg) <= 1e-9 * abs(avg),
              f"script aggs: avg of {bk['key']} {bk['avg_rank']['value']} vs "
              f"{avg}")
        want = float(np.log(np.float32(avg + 1))) * counts[i]
        check(abs(bk["lg"]["value"] - want) <= 1e-6 * abs(want),
              f"script aggs: bucket_script of {bk['key']} "
              f"{bk['lg']['value']} vs {want}")
    want_sm = float(np.sum(sm_vals))
    check(abs(aggs["sm"]["value"] - want_sm) <= 1e-12 * abs(want_sm),
          f"script aggs: scripted_metric {aggs['sm']['value']} vs {want_sm}")
    log(f"script aggs (8 shards, one request): terms over cat with avg, "
        f"bucket_script log(a + 1) * c and bucket_selector sqrt(c) > "
        f"{thresh:.3f} ({len(kept)} of {int((counts > 0).sum())} buckets "
        f"kept), scripted_metric over {len(sm_vals)} matches, against numpy "
        f"(avg 1e-9, bucket_script 1e-6, scripted_metric 1e-12) in "
        f"{ms:.1f} ms; launches {launches}")
    return {"launches": launches, "ms": ms}


def perc_script_registry(n: int):
    """bench.py's reg_body thirds with every tenth registration a
    function_score whose script_score reads _score, a param and rank."""
    prng = np.random.default_rng([77, 37])
    pv = PERC_VOCAB
    regs = {}
    for i in range(n):
        w = pv[int(prng.integers(0, len(pv)))]
        match = {"match": {"body": f"{w} {pv[(i * 7) % len(pv)]}"}}
        if i % 10 == 9:
            qq = {"function_score": {"query": match, "functions": [
                {"script_score": {"script": {
                    "source": PERC_SCRIPT_SOURCE,
                    "params": {"k": PERC_SCRIPT_K}}}}]}}
        elif i % 3 == 0:
            qq = match
        elif i % 3 == 1:
            qq = {"term": {"cat": w}}
        else:
            qq = {"range": {"rank": {"gte": int(prng.integers(0, 90))}}}
        regs[f"q{i}"] = {"query": qq, "group": f"g{i % 8}"}
    return regs


def perc_script_oracle(regs, doc) -> dict:
    """perc_oracle with the script registrations: the match's BM25 times
    (BM25 · k + rank / 100), in float64."""
    plain = {q: r for q, r in regs.items()
             if "function_score" not in r["query"]}
    out = perc_oracle(plain, doc)
    for qid, reg in regs.items():
        fs = reg["query"].get("function_score")
        if fs is None:
            continue
        base = perc_oracle({qid: {"query": fs["query"]}}, doc).get(qid)
        if base is not None:
            out[qid] = base * (base * PERC_SCRIPT_K + doc["rank"] / 100.0)
    return out


def phase_percolate_scripts(torch, args, data, name, smi_line) -> dict:
    """A 1,000-registration registry, a tenth of it function_score with a
    script_score (the shape-fallback lane: a K12 launch each), through a
    percolate per probe and one percolate_many of bench.py's 12 probes;
    every registration's flag and score against a float64 recompute."""
    from elasticsearch_tpu_torch.search import percolator
    dev = data["reader"].device
    pdocs, _ = perc_bench_registry()
    regs = perc_script_registry(PERC_SCRIPT_REGS)
    meta = perc_meta("smoke_perc_script", PERC_MAPPINGS, regs)
    t0 = time.perf_counter()
    percolator.registry_for(meta, dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    stats = {"launches": {k: 0 for k in path_kernels()}}
    recs, outs = [], []
    for pi, d in enumerate(pdocs):
        out, rec = perc_call(torch, lambda d=d: percolator.percolate(
            meta, d, score=True, device=dev))
        for k_, v in rec["launches"].items():
            stats["launches"][k_] += v
        check_perc_oracle(f"percolate scripts probe {pi}", out,
                          perc_script_oracle(regs, d))
        recs.append(rec)
        outs.append(out)
    many, mrec = perc_call(torch, lambda: percolator.percolate_many(
        meta, [{"doc": d, "score": True} for d in pdocs], device=dev))
    for k_, v in mrec["launches"].items():
        stats["launches"][k_] += v
    check(many == outs, "percolate_many with scripts: an item differs from "
          "its own percolate call")
    n_script = sum(1 for o in outs for m in o["matches"]
                   if "function_score" in regs[m["_id"]]["query"])
    check(n_script > 0 and stats["launches"]["script_eval"] > 0,
          "no script registration matched a probe, or K12 never launched")
    walls = [r["wall_ms"] for r in recs]
    p50 = statistics.median(walls)
    mid = sorted(recs, key=lambda r: r["wall_ms"])[len(recs) // 2]
    log(f"percolate scripts ({PERC_SCRIPT_REGS} registrations, a tenth with "
        f"a script_score; built in {build_ms:.1f} ms): p50 {p50:.3f} ms a "
        f"call; the p50 call: {perc_line(mid)}; {n_script} script matches "
        f"over the 12 probes, every registration's flag exact and score "
        f"within 1e-5 of float64; percolate_many of the 12: "
        f"{perc_line(mrec)} — on {name} ({smi_line})")
    stats.update(p50_ms=p50, many_ms=mrec["wall_ms"])
    return stats


# --------------------------------------------------------------------------
# the query leaves (phases 39-46): the span family (K13, K14), the classic
# and LM-Dirichlet similarities (K15), multi-term filters (K16), and the
# compound leaves (K1, K2)
# --------------------------------------------------------------------------

def plain_leaf_kernels():
    """A context in which the wrappers of K1 and K13-K16 run their plain
    versions also on CUDA tensors (the resolvers call the wrappers through
    their modules). Launches made there count nowhere."""
    import contextlib
    from elasticsearch_tpu_torch.ops import lexical, phrase, spans

    @contextlib.contextmanager
    def ctx():
        saved = (lexical.bm25_match_batch, lexical.sim_match_batch,
                 lexical.term_set_scan, phrase.span_near_score_batch,
                 spans.span_program_score_batch)
        lexical.bm25_match_batch = (
            lambda *a, trailing_pad=False, want_nmatch=True:
            lexical.bm25_match_batch_plain(*a, want_nmatch=want_nmatch))
        lexical.sim_match_batch = (
            lambda sim, ut, utf, dl, qt, qa, qw, mu=None, trailing_pad=False:
            lexical.classic_match_batch_plain(ut, utf, dl, qt, qa, qw)
            if sim == lexical.SIM_CLASSIC else
            lexical.lm_dirichlet_match_batch_plain(ut, utf, dl, qt, qa, qw,
                                                   mu))
        lexical.term_set_scan = (lambda ut, tids, trailing_pad=False:
                                 lexical.term_set_scan_plain(ut, tids))
        phrase.span_near_score_batch = (
            lambda *a, extent: phrase.span_near_score_batch_plain(*a))
        spans.span_program_score_batch = (
            lambda prog, tk, ext, *a:
            spans.span_program_score_batch_plain(prog, tk, *a))
        try:
            yield
        finally:
            (lexical.bm25_match_batch, lexical.sim_match_batch,
             lexical.term_set_scan, phrase.span_near_score_batch,
             spans.span_program_score_batch) = saved
    return ctx()


def plain_over_reader(searcher, query):
    """The query through every segment with the plain versions on the
    card's tensors → (scores [docs] f32, mask [docs] bool) in corpus order
    (the smoke installs the corpus in order, segment after segment)."""
    from elasticsearch_tpu_torch.search import segment_exec
    scores, masks = [], []
    with plain_leaf_kernels():
        for seg in searcher.reader.segments:
            s, m = segment_exec.execute(seg, searcher.ctx, query)
            nr = seg.seg.num_docs
            scores.append(s[:nr].cpu().numpy())
            masks.append(m[:nr].cpu().numpy())
    return np.concatenate(scores), np.concatenate(masks)


def check_leaf_batches(label, args, searcher, batches, results, score64):
    """The first and the last request of every batch (``score64(i)`` takes
    the request's index over the batches): the total against the plain
    versions run on the card's tensors, exact, the hits' scores theirs bit
    for bit; then against ``score64(i)`` → (float64 score of every doc, its
    mask): the same docs matched, the hits' scores within 1e-5,
    tie-tolerant recall@k 1.0."""
    orig_of = gid_to_orig(searcher.reader)
    t0 = time.perf_counter()
    totals = []
    for bi, (reqs, res_b) in enumerate(zip(batches, results)):
        for j in checked_requests(len(reqs)):
            req, res = reqs[j], res_b[j]
            p_s, p_m = plain_over_reader(searcher, req.query)
            orig = orig_of[np.asarray(res.doc_ids, np.int64)]
            check(res.total == int(p_m.sum()),
                  f"{label} request {j}: total {res.total} != the plain "
                  f"versions' {int(p_m.sum())}")
            check(np.array_equal(np.asarray(res.scores, np.float32),
                                 p_s[orig]),
                  f"{label} request {j}: the hits' scores differ from the "
                  f"plain versions'")
            s64, m64 = score64(bi * len(batches[0]) + j)
            check(np.array_equal(m64, p_m), f"{label} request {j}: the "
                  f"float64 recompute matches other docs than the plain "
                  f"versions")
            check_vs_cpu(label, args, [res], [s64], [m64], orig_of,
                         k=req.size)
            totals.append(res.total)
    log(f"{label}: the first and the last request of each batch: totals "
        f"{totals} exact against the plain versions on the card and a "
        f"float64 recompute, the hits' scores the plain versions' bit for "
        f"bit and within 1e-5 of float64, tie-tolerant recall@k = 1.0 "
        f"({time.perf_counter() - t0:.1f} s)")


class Float64:
    """float64 BM25 pieces over the host's columns, from one postings pass
    over the terms the leaf phases query."""

    def __init__(self, data, n_requests):
        self.data = data
        self.df = data["df"]
        self.lens = data["lens"]
        self.n = len(self.lens)
        self.avgdl = float(self.lens.sum()) / self.n
        self.norm = 1.2 * (0.25 + 0.75 * self.lens.astype(np.float64)
                           / self.avgdl)
        self.post = postings(data["uterms"], data["utf"],
                             data["qtids"][:n_requests])

    def idf(self, terms):
        return float(sum(cpu_idf(self.df, int(t), self.n) for t in terms))

    def bm25(self, terms):
        """→ (Σ BM25 over ``terms``, how many of them each doc holds)."""
        s = np.zeros(self.n, np.float64)
        cnt = np.zeros(self.n, np.int32)
        for t in terms:
            d, f = self.post[int(t)]
            s[d] += cpu_idf(self.df, t, self.n) * f * 2.2 / (f + self.norm[d])
            cnt[d] += 1
        return s, cnt

    def freq_score(self, freq, sum_idf, rows=None):
        """BM25 over a span frequency (freq_score), for ``rows`` or all."""
        norm = self.norm if rows is None else self.norm[rows]
        f = freq.astype(np.float64)
        return np.where(f > 0, sum_idf * f * 2.2 / (f + norm), 0.0)


def leaf_terms(data, i):
    """The four sampled terms of request i (the smoke's df-weighted
    sampler), as names."""
    return [data["term_names"][int(t)] for t in data["qtids"][i]]


def host_rows(torch, data, rows):
    return torch.from_numpy(np.ascontiguousarray(data["tokens"][rows]))


def span_terms(args, data, n):
    """[n, 4] term ids of the span requests: (a, b, c) at three
    consecutive positions p, p + 1, p + 2 (p < 8) of a seeded random doc,
    so each request's spans occur (a token at a random position is drawn
    by collection frequency, like the df-weighted sampler's), and d the
    sampler's fourth term of the request."""
    rng = np.random.default_rng([args.seed, 40])
    docs = rng.integers(0, len(data["lens"]), n)
    pos = rng.integers(0, 8, n)
    abc = np.stack([data["tokens"][docs, pos + j] for j in range(3)], axis=1)
    return np.concatenate([abc, data["qtids"][:n, 3:4]], axis=1).astype(
        np.int32)


def span_bodies(data, kind, n):
    """n request bodies of one span shape over data["span_terms"]."""
    names = data["term_names"]
    out = []
    for i in range(n):
        a, b_, c, d = (names[int(t)] for t in data["span_terms"][i])

        def st(w):
            return {"span_term": {"body": w}}
        if kind == "near_unordered":
            q = {"span_near": {"clauses": [st(a), st(b_), st(c)],
                               "slop": 3, "in_order": False}}
        elif kind == "near_in_order":
            q = {"span_near": {"clauses": [st(a), st(b_), st(c)],
                               "slop": 2, "in_order": True}}
        elif kind == "not_tree":
            q = {"span_not": {
                "include": {"span_near": {"clauses": [
                    {"span_or": {"clauses": [st(a), st(b_)]}},
                    {"span_multi": {"match": {"prefix": {"body": {
                        "value": c[:len(c) - 2]}}}}},
                    st(c)], "slop": 4, "in_order": False}},
                "exclude": st(d), "pre": 1, "post": 1}}
        elif kind in ("containing", "within"):
            q = {f"span_{kind}": {
                "big": {"span_near": {"clauses": [st(a), st(c)],
                                      "slop": 8, "in_order": False}},
                "little": st(b_)}}
        else:                            # first
            q = {"span_first": {"match": {"span_or": {
                "clauses": [st(a), st(b_)]}}, "end": 10}}
        out.append({"query": q, "size": 1000})
    return out


def prefix_ids(prefix, vocab):
    """Term ids of the smoke's names (t000000.., fixed width) that start
    with ``prefix``."""
    digits = prefix[1:]
    span = 10 ** (len(str(vocab - 1)) - len(digits))
    lo = int(digits) * span
    return np.arange(lo, min(lo + span, vocab))


def span_idf64(f64, kind, terms):
    """The float64 Σ idf the span query of ``kind`` over ``terms`` (ids
    a, b, c, d) scores with."""
    a, b_, c, _d = terms
    if kind.startswith("near"):
        return f64.idf((a, b_, c))
    if kind == "not_tree":
        name = f64.data["term_names"][int(c)]
        ids = prefix_ids(name[:len(name) - 2], len(f64.data["term_names"]))
        multi = float(np.mean([cpu_idf(np.maximum(f64.df, 1), t, f64.n)
                               for t in ids]))
        return f64.idf((a, b_)) + multi + f64.idf((c,))
    if kind == "containing":
        return f64.idf((a, c))           # the big span's
    if kind == "first":
        return f64.idf((a, b_))
    return f64.idf((b_,))                # within: the little span's


def span_lowered(searcher, seg, query):
    """The span tree lowered on one segment as the resolver lowers it →
    (SpanProgram, term ids, term sets, Σ idf, scoring field, avgdl)."""
    from elasticsearch_tpu_torch.ops import spans
    from elasticsearch_tpu_torch.search.execute import (
        ConstTable, SegmentResolver, _SpanLowering)
    ct = ConstTable()
    low = _SpanLowering()
    res = SegmentResolver(seg, searcher.ctx, ct)
    code, sum_idf, field = res._span_ends(query, low)
    prog = spans.SpanProgram(code=tuple(code), fields=tuple(low.fields),
                             n_terms=len(low.term_refs),
                             n_sets=len(low.set_refs),
                             depth=spans.program_depth(code))
    return (prog, [int(ct.values[r]) for r in low.term_refs],
            [np.asarray(ct.values[r], np.int32) for r in low.set_refs],
            sum_idf, field, res._avgdl(field))


def span_freq(torch, kind, query, tids, tokens, lowered):
    """Span frequency per row of ``tokens``, with the plain span bodies:
    the flat span_near's counts, or the lowered program."""
    from elasticsearch_tpu_torch.ops import phrase, spans
    dev = tokens.device
    if kind.startswith("near"):
        qt = torch.tensor(tids[:3], dtype=torch.int32, device=dev)
        if kind == "near_in_order":
            return phrase.sloppy_phrase_count(tokens, qt, [0, 1, 2], 2)
        return phrase.span_near_freq_unordered(tokens, qt, 3)
    prog, ptids, sets = lowered[:3]
    return spans.span_program_freq(
        prog, [tokens], torch.tensor(ptids, dtype=torch.int32, device=dev),
        [torch.from_numpy(s).to(dev) for s in sets])


def phase_span_paths(torch, args, data, f64, name, smi_line) -> dict:
    """Phases 40-42: flat span_near unordered (slop 3) and in order (slop
    2) (K14); a span_not over span_near(span_or, span_multi prefix, term)
    (K13); span_containing, span_within and span_first over span_or (K13).
    LEAF_BATCHES batches of each through query_phase_batch, checked; the
    first request's hits re-counted on the host's token rows."""
    searcher = data["searcher"]
    reader = searcher.reader
    orig_of = gid_to_orig(reader)
    out = {}
    for kind, kern in (("near_unordered", "span_near_scan"),
                       ("near_in_order", "span_near_scan"),
                       ("not_tree", "span_program"),
                       ("containing", "span_program"),
                       ("within", "span_program"),
                       ("first", "span_program")):
        # the span tree's span_multi expands each request's prefix on each
        # segment on the host (seconds a batch): one batch of it
        n_b = 1 if kind == "not_tree" else LEAF_BATCHES
        batches = batches_of(args, span_bodies(data, kind, n_b * args.batch))
        results, per_batch, wall, launches, peak = drive(torch, searcher,
                                                         batches)
        stats = report(f"span {kind}", args, data, batches, per_batch, wall,
                       launches, peak, name, smi_line, (kern, "stable_topk"))

        def score64(i, kind=kind):
            query = batches[i // args.batch][i % args.batch].query
            freqs = []
            for seg in reader.segments:
                lowered = None if kind.startswith("near") else \
                    span_lowered(searcher, seg, query)
                f = span_freq(torch, kind, query, data["span_terms"][i],
                              seg.text["body"].tokens, lowered)
                freqs.append(f[:seg.seg.num_docs].cpu().numpy())
            freq = np.concatenate(freqs)
            s64 = f64.freq_score(freq, span_idf64(f64, kind,
                                                  data["span_terms"][i]))
            return s64, freq > 0
        check_leaf_batches(f"span {kind}", args, searcher, batches, results,
                           score64)
        # the first request's hits re-counted on the host's rows
        res0 = results[0][0]
        orig = orig_of[np.asarray(res0.doc_ids, np.int64)]
        lowered = None if kind.startswith("near") else span_lowered(
            searcher, reader.segments[0], batches[0][0].query)
        host = span_freq(torch, kind, batches[0][0].query,
                         data["span_terms"][0], host_rows(torch, data, orig),
                         lowered).numpy()
        want = f64.freq_score(host, span_idf64(f64, kind,
                                               data["span_terms"][0]),
                              rows=orig)
        check(len(orig) > 0 and bool((host > 0).all()) and np.allclose(
            np.asarray(res0.scores), want, rtol=1e-5, atol=1e-5),
            f"span {kind}: the hits re-counted on the host's rows score "
            f"otherwise")
        log(f"span {kind}: the first request's {len(orig)} hits re-counted "
            f"on the host's token rows (span frequencies "
            f"{int(host.min()) if len(host) else '-'}.."
            f"{int(host.max()) if len(host) else '-'}): scores within 1e-5 "
            f"of float64")
        out[kind] = stats
    return out


def fuzzy1_ids(value, vocab):
    """Term ids within one edit of ``value`` among the smoke's names, all
    of one length: exactly the one-digit substitutions (an insertion or a
    deletion makes a name of another length, and there is none)."""
    out = set()
    for pos in range(1, len(value)):
        for dig in "0123456789":
            out.add(int(value[1:pos] + dig + value[pos + 1:]))
    return np.array(sorted(t for t in out if t < vocab))


def docs_with_any(data, ids):
    """Docs holding any of the term ids ``ids``."""
    lut = np.zeros(int(data["uterms"].max()) + 2, bool)
    lut[ids] = True
    return lut[data["uterms"]].any(axis=1)


def wildcard_ids(name, names):
    """Term ids of the names that the wildcard ``name[:3]?name[4]*``
    matches (1,000 of the smoke's fixed-width names)."""
    return np.array([t for t, nm in enumerate(names)
                     if nm[:3] == name[:3] and nm[4] == name[4]])


def phase_multi_term_paths(torch, args, data, f64, name, smi_line) -> dict:
    """Phase 43: bool with config 1's match as must and, as filter, a
    prefix (100 terms), a wildcard (1,000 terms) or a fuzzy
    term (fuzziness 1) (K16, K1, K2), each request with its own pattern
    drawn from its first sampled term, one batch each (MULTI_TERM_BATCH
    requests, FUZZY_BATCH for fuzzy), against float64 BM25 over the must
    and the
    expanded sets counted with numpy. The resolver expands each request's
    pattern on each segment: a host scan of the dictionary."""
    names = data["term_names"]
    vocab = len(names)
    w = len(names[0])
    out = {}
    for label, make, ids_of, n in (
            ("prefix100", lambda s: {"prefix": {"body": s[:w - 2]}},
             lambda s: prefix_ids(s[:w - 2], vocab), MULTI_TERM_BATCH),
            ("wildcard", lambda s: {"wildcard": {"body": f"{s[:3]}?{s[4]}*"}},
             lambda s: wildcard_ids(s, names), MULTI_TERM_BATCH),
            ("fuzzy", lambda s: {"fuzzy": {"body": {"value": s,
                                                    "fuzziness": 1}}},
             lambda s: fuzzy1_ids(s, vocab), FUZZY_BATCH)):
        seeds = [names[int(t)] for t in data["qtids"][:n, 0]]
        bodies = [{"query": {"bool": {"must": [{"match": {"body": t}}],
                                      "filter": [make(sd)]}},
                   "size": args.k}
                  for t, sd in zip(data["texts"][:n], seeds)]
        batches = batches_of(args, bodies)
        results, per_batch, wall, launches, peak = drive(
            torch, data["searcher"], batches)
        sizes = [len(ids_of(seeds[j])) for j in checked_requests(n)]
        stats = report(f"bool + {label} filter (own pattern a request, "
                       f"{'/'.join(map(str, sizes))} terms)", args, data,
                       batches, per_batch, wall, launches, peak, name,
                       smi_line, ("term_set_scan", "bm25_scan",
                                  "stable_topk"))

        def score64(i):
            s, cnt = f64.bm25(data["qtids"][i])
            m = (cnt > 0) & docs_with_any(data, ids_of(seeds[i]))
            return np.where(m, s, 0.0), m
        check_leaf_batches(f"bool + {label}", args, data["searcher"],
                           batches, results, score64)
        stats["expanded_terms"] = sizes
        stats["requests"] = n
        out[label] = stats
    return out


def phase_similarity_paths(torch, args, data, f64, name,
                           smi_line) -> dict:
    """Phase 44: config 1's 4-term match on the body field mapped
    ``classic``, then ``LMDirichlet`` (mu 2000), over the same installed
    segments (a second MapperService: the reader does not depend on the
    mapping), LEAF_BATCHES batches each (K15, K2), against float64 scoring
    from the host's columns."""
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search.phase import ShardSearcher
    dl = f64.lens.astype(np.float64)
    total_tokens = float(f64.lens.sum())
    out = {}
    for sim in ("classic", "LMDirichlet"):
        ms = MapperService()
        ms.merge("_doc", {"properties": {
            "body": {"type": "text", "analyzer": "whitespace",
                     "similarity": sim},
            "rank": {"type": "double"},
            "vec": {"type": "dense_vector", "dims": VEC_DIMS}}})
        searcher = ShardSearcher(0, data["reader"], ms)
        bodies = [{"query": {"match": {"body": t}}, "size": args.k}
                  for t in data["texts"][:LEAF_BATCHES * args.batch]]
        batches = batches_of(args, bodies)
        results, per_batch, wall, launches, peak = drive(torch, searcher,
                                                         batches)
        stats = report(f"config 1 match, {sim} similarity", args, data,
                       batches, per_batch, wall, launches, peak, name,
                       smi_line, ("sim_scan", "stable_topk"))
        check(launches["bm25_scan"] == 0, f"the {sim} match ran K1's BM25")

        def score64(i, sim=sim):
            s = np.zeros(f64.n, np.float64)
            m = np.zeros(f64.n, bool)
            for t in data["qtids"][i]:
                d, f = f64.post[int(t)]
                m[d] = True
                if sim == "classic":
                    idf = 1.0 + np.log(f64.n / (f64.df[t] + 1.0))
                    s[d] += idf * idf * np.sqrt(f) / np.sqrt(dl[d])
                else:
                    frac = float(f.sum()) / total_tokens
                    s[d] += np.maximum(
                        np.log1p(f / (2000.0 * max(frac, 1e-12)))
                        + np.log(2000.0 / (dl[d] + 2000.0)), 0.0)
            return np.where(m, s, 0.0), m
        check_leaf_batches(f"{sim} match", args, searcher, batches, results,
                           score64)
        out[sim] = stats
    return out


def compound_terms(args, data, n):
    """Terms whose plans every request of a batch shares: for common, two
    terms above the cutoff frequency (0.001 of the docs) and two at or
    below it; for more_like_this, 16 distinct terms by df (4 like-texts of
    4), so each request picks all 16."""
    df = data["df"]
    cut = 0.001 * len(data["lens"])
    rng = np.random.default_rng([args.seed, 45])
    high = np.nonzero(df > cut)[0]
    low = np.nonzero((df > 0) & (df <= cut))[0]
    common = np.concatenate([rng.choice(high, (n, 2)),
                             rng.choice(low, (n, 2))], axis=1)
    present = np.nonzero(df > 0)[0]
    w = df[present] / df[present].sum()
    mlt = np.stack([rng.choice(present, 16, replace=False, p=w)
                    for _ in range(n)])
    return {"common": common, "more_like_this": mlt}


def compound_bodies(data, kind, n, terms):
    names = data["term_names"]
    out = []
    for i in range(n):
        a, b_, c, d = leaf_terms(data, i)
        if kind == "multi_match":
            q = {"multi_match": {"query": f"{a} {b_} {c} {d}",
                                 "fields": ["body", "body^0.5"],
                                 "tie_breaker": 0.3}}
        elif kind == "dis_max":
            q = {"dis_max": {"queries": [{"match": {"body": a}},
                                         {"match": {"body": b_}}],
                             "tie_breaker": 0.2}}
        elif kind == "boosting":
            q = {"boosting": {"positive": {"match": {"body": f"{a} {b_}"}},
                              "negative": {"match": {"body": c}},
                              "negative_boost": 0.5}}
        elif kind == "common":
            q = {"common": {"body": {"query": " ".join(
                names[t] for t in terms["common"][i]),
                "cutoff_frequency": 0.001}}}
        elif kind == "query_string":
            q = {"query_string": {"query": f"{a} AND {b_}",
                                  "default_field": "body"}}
        else:
            ts = [names[t] for t in terms["more_like_this"][i]]
            q = {"more_like_this": {"fields": ["body"], "like": [
                " ".join(ts[j:j + 4]) for j in range(0, 16, 4)],
                "min_term_freq": 1, "min_doc_freq": 1}}
        out.append({"query": q, "size": 1000})
    return out


def compound_score64(f64, kind, qt, i, terms):
    """float64 scores and mask of compound request i of ``kind``."""
    a, b_, c, d = qt[i]
    if kind == "multi_match":
        s, cnt = f64.bm25((a, b_, c, d))     # body, and body at boost 0.5
        return np.where(cnt > 0, s + 0.3 * 0.5 * s, 0.0), cnt > 0
    if kind == "dis_max":
        (sa, ca), (sb, cb) = f64.bm25((a,)), f64.bm25((b_,))
        best = np.maximum(sa, sb)
        m = (ca > 0) | (cb > 0)
        return np.where(m, best + 0.2 * (sa + sb - best), 0.0), m
    if kind == "boosting":
        s, cnt = f64.bm25((a, b_))
        neg = f64.bm25((c,))[1] > 0
        return np.where(neg, s * 0.5, s), cnt > 0
    if kind == "common":
        ts = [int(t) for t in terms["common"][i]]
        low = [t for t in ts if f64.df[t] <= 0.001 * f64.n]
        high = [t for t in ts if f64.df[t] > 0.001 * f64.n]
        s, cnt = f64.bm25(low or high)
        if low and high:
            s = s + f64.bm25(high)[0]
        return np.where(cnt > 0, s, 0.0), cnt > 0
    if kind == "query_string":
        s, cnt = f64.bm25((a, b_))       # bool must: both clauses
        return np.where(cnt == 2, s, 0.0), cnt == 2
    # more_like_this, re-selected here: the like texts' terms ranked by
    # idf · tf (then name), the top 25, at least 30% of them per doc
    tf = {}
    for t in terms["more_like_this"][i]:
        tf[int(t)] = tf.get(int(t), 0) + 1
    names = f64.data["term_names"]
    picked = [t for _, _, t in sorted(
        ((cpu_idf(f64.df, t, f64.n) * n_, names[t], t)
         for t, n_ in tf.items()), key=lambda x: (-x[0], x[1]))[:25]]
    s, cnt = f64.bm25(picked)
    m = cnt >= int(len(picked) * 30 / 100.0)
    return np.where(m, s, 0.0), m


def phase_compound_paths(torch, args, data, f64, name, smi_line) -> dict:
    """Phase 45: one batch each of multi_match (best_fields, tie_breaker
    0.3), dis_max, boosting, common (cutoff 0.001), query_string and
    more_like_this on 4 like-texts (K1, K2), against float64 BM25."""
    out = {}
    terms = compound_terms(args, data, args.batch)
    f64.post.update(postings(data["uterms"], data["utf"], np.concatenate(
        [terms["common"].ravel(), terms["more_like_this"].ravel()])))
    for kind in ("multi_match", "dis_max", "boosting", "common",
                 "query_string", "more_like_this"):
        batches = batches_of(args, compound_bodies(data, kind, args.batch,
                                                   terms))
        results, per_batch, wall, launches, peak = drive(
            torch, data["searcher"], batches)
        out[kind] = report(kind, args, data, batches, per_batch, wall,
                           launches, peak, name, smi_line,
                           ("bm25_scan", "stable_topk"))
        check_leaf_batches(kind, args, data["searcher"], batches, results,
                           lambda i, kind=kind: compound_score64(
                               f64, kind, data["qtids"], i, terms))
    return out


def span_program_args(torch, searcher, seg, queries):
    """K13's arguments for a batch of same-signature span queries on one
    segment, stacked as the batch path stacks them."""
    dev = seg.live.device
    rows = [span_lowered(searcher, seg, q) for q in queries]
    prog, field, avg = rows[0][0], rows[0][4], rows[0][5]
    b = len(queries)
    p = searcher.ctx.bm25
    cols = [seg.text[f] for f in prog.fields]
    return (prog, [c.tokens for c in cols], [c.tok_extent for c in cols],
            seg.text[field].doc_len,
            torch.tensor([r[1] for r in rows], dtype=torch.int32,
                         device=dev).reshape(b, prog.n_terms),
            [torch.from_numpy(np.stack([r[2][j] for r in rows])).to(dev)
             for j in range(prog.n_sets)],
            torch.tensor(np.asarray([r[3] for r in rows], np.float32),
                         device=dev), p.k1, p.b,
            torch.full((b,), float(np.float32(avg)), device=dev))


def same_bits(torch, got, want, what):
    torch.cuda.synchronize()
    check(torch.equal(got[1], want[1]) and torch.equal(
        got[0].view(torch.int32), want[0].view(torch.int32)),
        f"{what} is not bit-identical to its plain version")


def token_scan_bytes(col, b):
    """Least bytes of a position-matrix scan for a batch of b: each row read
    up to its extent, the extents and lengths once, [B, N] scores and mask
    bytes written."""
    n = col.tokens.shape[0]
    return (4 * int(col.tok_extent.sum()) + nbytes(col.tok_extent)
            + nbytes(col.doc_len) + b * n * 5)


def row_scan_bytes(torch, col):
    """Least bytes of reading each forward row up to its first pad."""
    u = col.uterms.shape[1]
    return 4 * int(torch.clamp((col.uterms >= 0).sum(dim=1) + 1,
                               max=u).sum())


def phase_leaf_kernels(torch, args, data) -> list[dict]:
    """Phase 39: K13-K16 against their plain versions at the shapes the
    leaf paths give them on segment 0 (B = 64, N = 2^20, L = 224) and at
    odd shapes (N = 100,003, holes, a second query group, absent and
    repeated terms): bit-identical for K13-K15, equal masks for K16; each
    timed beside its plain version (on plain_queries(B) where a batch
    takes seconds), its bound and a library call where one exists."""
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.ops import lexical, phrase, spans
    from elasticsearch_tpu_torch.search import query_dsl
    from elasticsearch_tpu_torch.search.phase import ShardSearcher
    from elasticsearch_tpu_torch.search.execute import _pad_pow2
    from elasticsearch_tpu_torch.search.segment_exec import (
        _plan_segment_batch)
    searcher, reader = data["searcher"], data["reader"]
    for s_ in reader.segments:          # config 2 put them there already
        reader.fetch_tokens(s_, "body")
    seg = reader.segments[0]
    col = seg.text["body"]
    dev = col.uterms.device
    n, length = col.tokens.shape
    b = args.batch
    qi = torch.tensor(plain_queries(b), device=dev)
    pq = len(qi)
    rng = np.random.default_rng([args.seed, 39])
    n_odd = min(n, 100_003)
    p = searcher.ctx.bm25
    kernels = []

    # ---- K13 span_program: the span tree and the containing program -----
    plans = {}
    for kind in ("not_tree", "containing", "within", "first"):
        queries = [query_dsl.parse_query(bd["query"])
                   for bd in span_bodies(data, kind, b)]
        plans[kind] = span_program_args(torch, searcher, seg, queries)
        a13 = plans[kind]
        got = spans.span_program_score_batch(*a13)
        sub = (a13[0], a13[1], a13[2], a13[3], a13[4][qi],
               [s[qi] for s in a13[5]], a13[6][qi], a13[7], a13[8],
               a13[9][qi])
        want = spans.span_program_score_batch_plain(
            sub[0], sub[1], *sub[3:])
        same_bits(torch, (got[0][qi], got[1][qi]), want,
                  f"K13 ({kind}, B={b}, N={n}, {len(a13[0].code)} ops)")
        check(bool(got[1].any()), f"K13 {kind}: nothing matched")
    a13 = plans["not_tree"]
    k13_ms = timed(torch, "K13 span tree", lambda:
                   spans.span_program_score_batch(*a13), reps=5)
    sub = (a13[0], a13[1], a13[3], a13[4][qi], [s[qi] for s in a13[5]],
           a13[6][qi], a13[7], a13[8], a13[9][qi])
    k13_plain = timed(torch, f"K13 plain ({pq} queries)", lambda:
                      spans.span_program_score_batch_plain(*sub), reps=1,
                      warmup=0)
    k13_bytes = token_scan_bytes(col, b) + sum(nbytes(s) for s in a13[5]) \
        + nbytes(a13[4])
    k13_b, k13_by = bound(k13_bytes, 0)
    # odd: the containing program on N = 100,003 rows with holes, B = 3
    tok = col.tokens[:n_odd].clone()
    holes = torch.arange(0, n_odd, 7, device=dev)
    tok[holes, (col.doc_len[holes] // 3).long()] = -1
    ext = phrase.token_extent(tok)
    c13 = plans["containing"]
    o13 = (c13[0], [tok], [ext], col.doc_len[:n_odd], c13[4][:3],
           [s[:3] for s in c13[5]], c13[6][:3], p.k1, p.b, c13[9][:3])
    same_bits(torch, spans.span_program_score_batch(*o13),
              spans.span_program_score_batch_plain(o13[0], o13[1],
                                                   *o13[3:]),
              f"K13 at the odd shape B=3, N={n_odd}")
    log(f"K13 span_program [B={b}, N={n}, L={length}, span tree of "
        f"{len(a13[0].code)} ops, a 128-term set]: bit-identical to plain "
        f"(and the containing, within and first programs; the odd shape); "
        f"kernel_ms={k13_ms:.4f} plain_ms={k13_plain:.4f} ({pq} queries) "
        f"bound_ms={k13_b:.4f} ({k13_by}: {k13_bytes} B) library_ms=null")
    kernels.append({
        "name": "span_program", "route": "cuda", "source": K13_SOURCE,
        "replaces": K13_REPLACES, "launches": 0, "max_abs_err": 0.0,
        "ms": k13_ms, "plain_ms": k13_plain, "plain_queries": pq,
        "bound_ms": k13_b, "bound_by": k13_by, "library_ms": None,
        "library_null": "no single torch call runs a span program",
        "shape": {"B": b, "N": n, "L": length, "ops": len(a13[0].code)}})

    # ---- K14 span_near_scan: unordered slop 3 and in order slop 2 --------
    a14s = {}
    for kind, slop, in_order in (("near_unordered", 3, False),
                                 ("near_in_order", 2, True)):
        queries = [query_dsl.parse_query(bd["query"])
                   for bd in span_bodies(data, kind, b)]
        c = _plan_segment_batch(seg, searcher.ctx, queries, args.k)["consts"]
        a14 = (col.tokens, col.doc_len, torch.stack(c[:3], dim=1), slop,
               in_order, c[3], p.k1, p.b, c[4])
        got = phrase.span_near_score_batch(*a14, extent=col.tok_extent)
        want = phrase.span_near_score_batch_plain(
            a14[0], a14[1], a14[2][qi], slop, in_order, a14[5][qi], p.k1,
            p.b, a14[8][qi])
        same_bits(torch, (got[0][qi], got[1][qi]), want,
                  f"K14 ({kind}, B={b}, N={n})")
        check(bool(got[1].any()), f"K14 {kind}: nothing matched")
        a14s[kind] = a14
    a14 = a14s["near_unordered"]
    k14_ms = timed(torch, "K14 unordered", lambda:
                   phrase.span_near_score_batch(*a14, extent=col.tok_extent),
                   reps=5)
    k14_io_ms = timed(torch, "K14 in order", lambda:
                      phrase.span_near_score_batch(
                          *a14s["near_in_order"], extent=col.tok_extent),
                      reps=5)
    k14_plain = timed(torch, f"K14 plain ({pq} queries)", lambda:
                      phrase.span_near_score_batch_plain(
                          a14[0], a14[1], a14[2][qi], 3, False,
                          a14[5][qi], p.k1, p.b, a14[8][qi]), reps=1,
                      warmup=0)
    k14_bytes = token_scan_bytes(col, b) + 3 * nbytes(a14[5])
    k14_b, k14_by = bound(k14_bytes, 0)
    row = tok[1].cpu().numpy()
    o_tids = torch.tensor([[row[0], row[2], row[1], row[4], row[3]],
                           [row[2]] * 5,
                           [row[0], -1, row[3], row[4], row[6]]],
                          dtype=torch.int32, device=dev)
    o_idf = torch.tensor([1.5, 7.0, 2.25], device=dev)
    o_av = a14[8][:3]
    for slop, in_order in ((0, True), (6, True), (0, False), (6, False)):
        oa = (tok, col.doc_len[:n_odd], o_tids, slop, in_order, o_idf, p.k1,
              p.b, o_av)
        same_bits(torch, phrase.span_near_score_batch(*oa, extent=ext),
                  phrase.span_near_score_batch_plain(*oa),
                  f"K14 at the odd shape B=3, N={n_odd}, T=5, slop {slop}, "
                  f"in_order {in_order}")
    log(f"K14 span_near_scan [B={b}, N={n}, L={length}, T=3]: bit-identical "
        f"to plain (unordered slop 3, in order slop 2; the odd shapes); "
        f"kernel_ms={k14_ms:.4f} (in order {k14_io_ms:.4f}) "
        f"plain_ms={k14_plain:.4f} ({pq} queries) bound_ms={k14_b:.4f} "
        f"({k14_by}: {k14_bytes} B) library_ms=null")
    kernels.append({
        "name": "span_near_scan", "route": "cuda", "source": K14_SOURCE,
        "replaces": K14_REPLACES, "launches": 0, "max_abs_err": 0.0,
        "ms": k14_ms, "in_order_ms": k14_io_ms, "plain_ms": k14_plain,
        "plain_queries": pq, "bound_ms": k14_b, "bound_by": k14_by,
        "library_ms": None,
        "library_null": "no single torch call counts span_near windows",
        "shape": {"B": b, "N": n, "L": length, "T": 3, "slop": 3}})

    # ---- K15 sim_scan: classic and LM Dirichlet at config 1's match ------
    texts = data["texts"][:b]
    k15 = {}
    for sim, code in (("classic", lexical.SIM_CLASSIC),
                      ("LMDirichlet", lexical.SIM_LM_DIRICHLET)):
        ms_ = MapperService()
        ms_.merge("_doc", {"properties": {"body": {
            "type": "text", "analyzer": "whitespace", "similarity": sim}}})
        s2 = ShardSearcher(0, reader, ms_)
        c = _plan_segment_batch(seg, s2.ctx, [query_dsl.parse_query(
            {"match": {"body": t}}) for t in texts], args.k)["consts"]
        tids, qa = c[0], c[3]
        mu = c[4] if code == lexical.SIM_LM_DIRICHLET else None
        ones = torch.ones(tids.shape, dtype=torch.float32, device=dev)
        a15 = (code, col.uterms, col.utf, col.doc_len, tids, qa, ones, mu)

        def plain15(a):
            if a[0] == lexical.SIM_CLASSIC:
                return lexical.classic_match_batch_plain(*a[1:7])
            return lexical.lm_dirichlet_match_batch_plain(*a[1:])
        got = lexical.sim_match_batch(*a15, trailing_pad=col.trailing_pad)
        same_bits(torch, (got[0], got[1]), plain15(a15),
                  f"K15 ({sim}, B={b}, N={n})")
        ms15 = timed(torch, f"K15 {sim}", lambda: lexical.sim_match_batch(
            *a15, trailing_pad=col.trailing_pad), reps=10)
        plain_ms = timed(torch, f"K15 {sim} plain", lambda: plain15(a15),
                         reps=1, warmup=0)
        # odd: B = 65 (two groups) x T = 11 with an absent and a repeated
        # term, N = 100,003
        o_t = torch.from_numpy(make_queries(rng, 65, 11, data["df"])).to(dev)
        o_t[0, -1] = o_t[0, 0]
        o_t[1, 3] = -1
        o_a = torch.from_numpy(rng.uniform(
            1e-7, 3.0, (65, 11)).astype(np.float32)).to(dev)
        o_mu = torch.full((65,), 2000.0, device=dev) if mu is not None \
            else None
        oa = (code, col.uterms[:n_odd], col.utf[:n_odd],
              col.doc_len[:n_odd], o_t, o_a, torch.ones_like(o_a), o_mu)
        same_bits(torch, lexical.sim_match_batch(
            *oa, trailing_pad=col.trailing_pad), plain15(oa),
            f"K15 {sim} at the odd shape B=65, T=11, N={n_odd}")
        hits = int(got[1].sum())
        k15[sim] = {"ms": ms15, "plain_ms": plain_ms, "hits": hits,
                    "args": a15}
    read, _ = k1_work(torch, col.uterms, col.doc_len, k15["classic"][
        "args"][4], k15["classic"]["args"][5][:, 0], k15["classic"]["hits"])
    k15_bytes = read + b * n * 8
    k15_b, k15_by = bound(k15_bytes, 4 * b * n + 8 * k15["classic"]["hits"])
    log(f"K15 sim_scan [B={b}, N={n}, U={col.uterms.shape[1]}, T=4]: "
        f"bit-identical to plain, classic and LM Dirichlet (the odd shapes "
        f"too); kernel_ms classic={k15['classic']['ms']:.4f} LM Dirichlet="
        f"{k15['LMDirichlet']['ms']:.4f} plain_ms classic="
        f"{k15['classic']['plain_ms']:.4f} LM Dirichlet="
        f"{k15['LMDirichlet']['plain_ms']:.4f} bound_ms={k15_b:.4f} "
        f"({k15_by}: {k15_bytes} B) library_ms=null")
    kernels.append({
        "name": "sim_scan", "route": "cuda", "source": K15_SOURCE,
        "replaces": K15_REPLACES, "launches": 0, "max_abs_err": 0.0,
        "ms": k15["classic"]["ms"], "lm_dirichlet_ms":
        k15["LMDirichlet"]["ms"], "plain_ms": k15["classic"]["plain_ms"],
        "lm_dirichlet_plain_ms": k15["LMDirichlet"]["plain_ms"],
        "bound_ms": k15_b, "bound_by": k15_by, "library_ms": None,
        "library_null": "no single torch call scores a similarity over "
                        "forward rows",
        "shape": {"B": b, "N": n, "U": int(col.uterms.shape[1]), "T": 4}})

    # ---- K16 term_set_scan: prefix sets of 10, 100 and 1,000 terms -------
    # each query's set as the resolver builds it (the prefix's ids padded
    # to a power of 2 with -1), from the names' digits: the resolver's scan
    # of the dictionary takes ~0.1 s a query on the host
    k16 = {}
    names = data["term_names"]
    w = len(names[0])
    for size, cut in ((10, w - 1), (100, w - 2), (1000, w - 3)):
        tids = torch.tensor(np.array([_pad_pow2(list(prefix_ids(
            names[int(t)][:cut], len(names))), -1)
            for t in data["qtids"][:b, 0]], np.int32), device=dev)
        got = lexical.term_set_scan(col.uterms, tids,
                                    trailing_pad=col.trailing_pad)
        rows = slice(None) if size < 1000 else qi
        want = lexical.term_set_scan_plain(col.uterms, tids[rows])
        torch.cuda.synchronize()
        check(torch.equal(got[rows], want), f"K16 masks differ from its plain "
              f"version ({size}-term sets, B={b}, N={n})")
        ms16 = timed(torch, f"K16 {size} terms", lambda:
                     lexical.term_set_scan(col.uterms, tids,
                                           trailing_pad=col.trailing_pad),
                     reps=10)
        k16[size] = {"ms": ms16, "tids": tids}
    tids = k16[100]["tids"]
    k16_plain = timed(torch, f"K16 plain (100 terms, {pq} queries)", lambda:
                      lexical.term_set_scan_plain(col.uterms, tids[qi]),
                      reps=1, warmup=0)
    one = tids[0][tids[0] >= 0]
    k16_lib = timed(torch, "torch.isin, one query", lambda:
                    torch.isin(col.uterms, one).any(dim=1), reps=10)
    keys, bits = lexical.term_set_index(tids)
    k16_bytes = row_scan_bytes(torch, col) + nbytes(keys) + nbytes(bits) \
        + b * n
    k16_b, k16_by = bound(k16_bytes, 0)
    o_sets = np.full((70, 1024), -1, np.int32)
    for i in range(70):
        k_ = int(rng.integers(0, 1025))
        o_sets[i, :k_] = rng.choice(len(data["df"]), k_, replace=False)
    o_sets[1, :4] = data["qtids"][0]
    ot = torch.from_numpy(o_sets).to(dev)
    check(torch.equal(lexical.term_set_scan(
        col.uterms[:n_odd], ot, trailing_pad=col.trailing_pad),
        lexical.term_set_scan_plain(col.uterms[:n_odd], ot)),
        f"K16 differs from its plain version at B=70, N={n_odd}")
    log(f"K16 term_set_scan [B={b}, N={n}, U={col.uterms.shape[1]}]: masks "
        f"equal to plain at 10-, 100- and 1,000-term sets (and B=70 with "
        f"empty sets, N={n_odd}); kernel_ms 10={k16[10]['ms']:.4f} "
        f"100={k16[100]['ms']:.4f} 1000={k16[1000]['ms']:.4f} "
        f"plain_ms={k16_plain:.4f} (100 terms, {pq} queries) "
        f"bound_ms={k16_b:.4f} ({k16_by}: {k16_bytes} B) "
        f"library_ms={k16_lib:.4f} (torch.isin(uterms, set).any(1), ONE "
        f"query)")
    kernels.append({
        "name": "term_set_scan", "route": "cuda", "source": K16_SOURCE,
        "replaces": K16_REPLACES, "launches": 0, "max_abs_err": 0.0,
        "ms": k16[100]["ms"], "ms_by_set_size": {s: v["ms"]
                                                  for s, v in k16.items()},
        "plain_ms": k16_plain, "plain_queries": pq, "bound_ms": k16_b,
        "bound_by": k16_by, "library_ms": k16_lib, "library_queries": 1,
        "shape": {"B": b, "N": n, "U": int(col.uterms.shape[1]),
                  "T": 128}})
    return kernels


# --------------------------------------------------------------------------
# the geo slice (phases 47-51)
# --------------------------------------------------------------------------

#: the geo requests' centre, and the Rally geopoint track's polygon (lon, lat)
GEO_ORIGIN = (55.0, 7.0)
GEO_RING = [(-0.1, 49.0), (5.0, 48.0), (15.0, 49.0), (14.0, 60.0),
            (-0.1, 61.0), (-10.0, 50.0)]
#: the geo_shape requests' shapes around GEO_ORIGIN: a 5-vertex envelope, a
#: 33-vertex circle and a polygon with a hole
GEO_QUERY_SHAPES = {
    "envelope": {"type": "envelope", "coordinates": [[6.4, 55.5],
                                                     [7.6, 54.5]]},
    "circle": {"type": "circle", "coordinates": [7.0, 55.0],
               "radius": "60km"},
    "hole": {"type": "polygon", "coordinates": [
        [[5.8, 54.2], [8.3, 54.1], [8.1, 55.9], [6.0, 55.8], [5.8, 54.2]],
        [[6.7, 54.8], [7.3, 54.8], [7.3, 55.2], [6.7, 55.2], [6.7, 54.8]]]},
}
GEO_RELATIONS = ("intersects", "disjoint", "within", "contains")
#: the geo percolate registry and its probes
GEO_REGS = 1000
GEO_PROBES = 12
#: the distance band of the float64 checks (the libms' last bits) and the
#: margin band of the ray casts and orientations (deg²)
GEO_DIST_BAND = 3e-5
GEO_SHAPE_BAND = 1e-9
GEO_MAX_EXCUSED = 1e-3


def geo_points(seed, n):
    """OpenStreetMap-shaped points (the Rally geopoint track's 60.8M OSM
    nodes, cut to the smoke's reader): 1,000 centres of Zipf-weighted sizes
    (s = 1.1), most over Europe and North America, each a Gaussian of
    0.5-3°, plus a tenth area-uniform over the globe; one doc in 20 has no
    point. The heaviest centres sit near GEO_ORIGIN, where the requests
    look. → (lat, lon float64, exists)."""
    rng = np.random.default_rng([seed, 47])
    k = 1000
    region = rng.choice(3, k, p=[0.5, 0.35, 0.15])
    c_lat = np.where(region == 0, rng.uniform(36, 70, k),
                     np.where(region == 1, rng.uniform(25, 60, k),
                              np.degrees(np.arcsin(rng.uniform(-0.9, 0.9,
                                                               k)))))
    c_lon = np.where(region == 0, rng.uniform(-10, 40, k),
                     np.where(region == 1, rng.uniform(-125, -65, k),
                              rng.uniform(-180, 180, k)))
    c_lat[:3] = [GEO_ORIGIN[0], 52.5, 40.7]
    c_lon[:3] = [GEO_ORIGIN[1], 13.4, -74.0]
    w = 1.0 / np.arange(1, k + 1) ** 1.1
    which = rng.choice(k, n, p=w / w.sum())
    spread = rng.uniform(0.5, 3.0, k)[which]
    lat = c_lat[which] + rng.standard_normal(n) * spread
    lon = c_lon[which] + rng.standard_normal(n) * spread / np.maximum(
        np.cos(np.radians(c_lat[which])), 0.2)
    uni = rng.random(n) < 0.1
    lat[uni] = np.degrees(np.arcsin(rng.uniform(-1, 1, int(uni.sum()))))
    lon[uni] = rng.uniform(-180, 180, int(uni.sum()))
    lat = np.clip(lat, -89.9, 89.9)
    lon = (lon + 180.0) % 360.0 - 180.0
    return lat, lon, rng.random(n) > 0.05


def geo_templates(seed):
    """A few hundred shapes around (0, 0), shaped like the Rally geoshape
    track's OSM ways and polygons, as the port's parse_shape_rings lays them
    out: closed 4-12-gons (a tenth with a hole), open linestrings of 2-8
    points, a few points and multipolygons, a few large polygons (admin
    areas, 2-4° across) and one 32-point way, the widest. → (lats, lons
    [T, V] f32, rid [T, V] i32, area [T, V] bool, nv [T] i32, kind [T]),
    V = 32."""
    from elasticsearch_tpu_torch.utils.geoshape import parse_shape_rings
    rng = np.random.default_rng([seed, 48])

    def ring(m, r):
        a = np.sort(rng.uniform(0, 2 * np.pi, m))
        rr = r * rng.uniform(0.6, 1.0, m)
        return [[float(x * np.cos(t)), float(x * np.sin(t))]
                for t, x in zip(a, rr)]

    shapes, kinds = [], []
    for i in range(320):
        u = rng.random()
        r = float(rng.uniform(0.002, 0.05))
        if u < 0.55:
            outer = ring(int(rng.integers(4, 13)), r)
            rings = [outer + [outer[0]]]
            if rng.random() < 0.1:
                hole = [[x * 0.3, y * 0.3] for x, y in
                        ring(int(rng.integers(4, 13)), r)]
                rings.append(hole + [hole[0]])
            shapes.append({"type": "polygon", "coordinates": rings})
            kinds.append("polygon")
        elif u < 0.88:
            pts = np.cumsum(rng.normal(0, r, (int(rng.integers(2, 9)), 2)),
                            axis=0)
            shapes.append({"type": "linestring",
                           "coordinates": pts.tolist()})
            kinds.append("linestring")
        elif u < 0.94:
            shapes.append({"type": "point", "coordinates": [0.0, 0.0]})
            kinds.append("point")
        elif u < 0.98:
            a, b = ring(int(rng.integers(4, 8)), r), \
                ring(int(rng.integers(4, 8)), r)
            b = [[x + 3 * r, y] for x, y in b]
            shapes.append({"type": "multipolygon",
                           "coordinates": [[a + [a[0]]], [b + [b[0]]]]})
            kinds.append("multipolygon")
        else:
            outer = ring(int(rng.integers(8, 13)),
                         float(rng.uniform(1.0, 2.0)))
            shapes.append({"type": "polygon",
                           "coordinates": [outer + [outer[0]]]})
            kinds.append("admin")
    # one long way of 32 points: the widest row, which every row is padded to
    pts = np.cumsum(rng.normal(0, 0.01, (32, 2)), axis=0)
    shapes.append({"type": "linestring", "coordinates": pts.tolist()})
    kinds.append("long way")
    v = 32
    t = len(shapes)
    lats = np.zeros((t, v), np.float32)
    lons = np.zeros((t, v), np.float32)
    rid = np.full((t, v), -1, np.int32)
    area = np.zeros((t, v), bool)
    nv = np.zeros(t, np.int32)
    for i, s in enumerate(shapes):
        rl, ro, rr, ra = parse_shape_rings(s)
        check(len(rl) <= v, f"template {i} has {len(rl)} vertices")
        lats[i, :len(rl)], lons[i, :len(ro)] = rl, ro
        rid[i, :len(rr)], area[i, :len(ra)] = rr, ra
        nv[i] = len(rl) - 1
    return lats, lons, rid, area, nv, np.asarray(kinds)


def geo_shape_rows(seed, lat, lon, templates):
    """Each row a template translated to the row's point (shapes cluster
    as the points do); one row in 20 has no shape. → (lats, lons [N, 32]
    f32, rid [N, 32] i32, area [N, 32] bool, nv [N] i32, exists [N] bool):
    the ring layout of the mapper, padded to the widest template."""
    rng = np.random.default_rng([seed, 49])
    n = len(lat)
    t_lats, t_lons, t_rid, t_area, t_nv, kinds = templates
    p = np.where(kinds == "admin", 0.05, 1.0)
    p = np.where(kinds == "long way", 0.2, p)
    tid = rng.choice(len(t_nv), n, p=p / p.sum())
    exists = rng.random(n) > 0.05
    rid = np.where(exists[:, None], t_rid[tid], -1).astype(np.int32)
    valid = rid >= 0
    lats = np.where(valid, t_lats[tid] + lat[:, None].astype(np.float32),
                    0.0).astype(np.float32)
    lons = np.where(valid, t_lons[tid] + lon[:, None].astype(np.float32),
                    0.0).astype(np.float32)
    area = t_area[tid] & valid
    nv = np.where(exists, t_nv[tid], 0).astype(np.int32)
    return lats, lons, rid, area, nv, exists


def phase_geo_setup(torch, args, data) -> dict:
    """Phase 47's set-up: a geo_point column ``location`` and a geo_shape
    column ``area`` on config 1's segments, built vectorised from the seed,
    put in the host segments and uploaded (the reader's lazy geo upload,
    timed as set-up)."""
    from elasticsearch_tpu_torch.index.device_reader import (
        DeviceGeoField, DeviceShapeField)
    from elasticsearch_tpu_torch.index.segment import (
        GeoFieldColumn, ShapeFieldColumn)
    t0 = time.perf_counter()
    lat, lon, exists = geo_points(args.seed, args.docs)
    templates = geo_templates(args.seed)
    s_lats, s_lons, s_rid, s_area, s_nv, s_ex = geo_shape_rows(
        args.seed, lat, lon, templates)
    build_s = time.perf_counter() - t0
    reader = data["reader"]
    data["mapper"].merge("_doc", {"properties": {
        "location": {"type": "geo_point"}, "area": {"type": "geo_shape"}}})
    t0 = time.perf_counter()
    for dseg in reader.segments:
        seg = dseg.seg
        lo = int(seg.ids[0])
        nr = seg.num_docs
        npad = seg.padded_docs

        def pad(a, fill=0):
            out = np.full((npad,) + a.shape[1:], fill, a.dtype)
            out[:nr] = a[lo:lo + nr]
            return out
        gcol = GeoFieldColumn(lat=pad(lat), lon=pad(lon),
                              exists=pad(exists, False))
        scol = ShapeFieldColumn(lats=pad(s_lats), lons=pad(s_lons),
                                nv=pad(s_nv), exists=pad(s_ex, False),
                                rid=pad(s_rid, -1), area=pad(s_area, False))
        seg.geo_fields["location"] = gcol
        seg.shape_fields["area"] = scol
        dseg.geo["location"] = DeviceGeoField(column=gcol)
        dseg.shape["area"] = DeviceShapeField(column=scol)
        reader.fetch_geo(dseg, "location")
        reader.fetch_shape(dseg, "area")
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    shape_mb = sum(nbytes(t) for s in reader.segments
                   for t in (s.shape["area"].lats, s.shape["area"].lons,
                             s.shape["area"].rid, s.shape["area"].area,
                             s.shape["area"].nv,
                             s.shape["area"].exists)) / 2**20
    used = (s_rid >= 0).sum(axis=1)
    kinds = templates[5]
    by_kind = ", ".join(f"{k} {int((kinds == k).sum())}"
                        for k in np.unique(kinds))
    log(f"geo set-up: {args.docs} points (1,000 Zipf centres, a tenth "
        f"uniform; {int(exists.sum())} with a value) and shapes from "
        f"{len(kinds)} templates ({by_kind}); "
        f"vertices a shape mean {used[s_ex].mean():.2f}, max {used.max()} "
        f"of the V = {s_lats.shape[1]} slots every row is padded to; built "
        f"on the host in {build_s:.1f} s, uploaded in {up_s:.1f} s; the "
        f"shape column {shape_mb:.1f} MiB on the card "
        f"({shape_mb / len(reader.segments):.1f} MiB a segment; "
        f"{100 * used.sum() / s_rid.size:.1f}% of its vertex slots hold a "
        f"vertex); {reader_bytes(reader)}")
    # the host's float64 view of what the card holds (the f32 coordinates)
    lat32, lon32 = lat.astype(np.float32), lon.astype(np.float32)
    valid = s_rid >= 0
    f64_lats = s_lats.astype(np.float64)
    f64_lons = s_lons.astype(np.float64)
    bbox = (np.where(valid, f64_lats, np.inf).min(axis=1),
            np.where(valid, f64_lats, -np.inf).max(axis=1),
            np.where(valid, f64_lons, np.inf).min(axis=1),
            np.where(valid, f64_lons, -np.inf).max(axis=1))
    return {"lat": lat, "lon": lon, "exists": exists,
            "lat32": lat32.astype(np.float64),
            "lon32": lon32.astype(np.float64),
            "shape": (s_lats, s_lons, s_rid, s_area, s_nv, s_ex),
            "bbox": bbox}


def geo_offsets(args, n, salt):
    """Each request's seeded offset of its centre, up to 1° a coordinate."""
    return np.random.default_rng([args.seed, 50, salt]).uniform(-1, 1, (n, 2))


def geo_move(shape, dlat, dlon):
    def move(c):
        if isinstance(c[0], (int, float)):
            return [c[0] + dlon, c[1] + dlat]
        return [move(x) for x in c]
    return {**shape, "coordinates": move(shape["coordinates"])}


def geo_leaf(kind, dlat, dlon):
    """A geo request's leaf, its centre moved by (dlat, dlon)."""
    la, lo = GEO_ORIGIN[0] + dlat, GEO_ORIGIN[1] + dlon
    if kind == "polygon":
        return {"geo_polygon": {"location": {"points": [
            {"lat": y + dlat, "lon": x + dlon} for x, y in GEO_RING]}}}
    if kind == "bbox":
        return {"geo_bounding_box": {"location": {
            "top_left": {"lat": 61.0 + dlat, "lon": -0.1 + dlon},
            "bottom_right": {"lat": 48.0 + dlat, "lon": 15.0 + dlon}}}}
    if kind == "dateline":
        return {"geo_bounding_box": {"location": {
            "top_left": {"lat": 20.0 + dlat, "lon": 170.0 + dlon},
            "bottom_right": {"lat": -20.0 + dlat, "lon": -170.0 + dlon}}}}
    if kind == "distance":
        return {"geo_distance": {"distance": "200km",
                                 "location": {"lat": la, "lon": lo}}}
    if kind == "distance_range":
        return {"geo_distance_range": {"from": "200km", "to": "400km",
                                       "location": {"lat": la, "lon": lo}}}
    if kind == "geohash":
        return {"geohash_cell": {"location": {"lat": la, "lon": lo},
                                 "precision": 5, "neighbors": True}}
    if kind == "exists":
        return {"exists": {"field": "location"}}
    rel, qname = kind.split("/")
    return {"geo_shape": {"area": {
        "shape": geo_move(GEO_QUERY_SHAPES[qname], dlat, dlon),
        "relation": rel}}}


GEO_POINT_PATHS = ("polygon", "bbox", "dateline", "distance",
                   "distance_range", "geohash", "exists", "decay")
GEO_SHAPE_PATHS = tuple(f"{r}/{q}" for r in GEO_RELATIONS
                        for q in GEO_QUERY_SHAPES)


def geo_bodies(args, data, kind, n, salt=0):
    """n requests of a geo path: config 1's 4-term match in a bool's must
    and the geo leaf in its filter, or (decay) the match under a
    function_score with a gauss decay on ``location``."""
    off = geo_offsets(args, n, salt)
    out = []
    for i in range(n):
        text = data["texts"][i % len(data["texts"])]
        dlat, dlon = off[i]
        if kind == "decay":
            q = {"function_score": {
                "query": {"match": {"body": text}},
                "functions": [{"gauss": {"location": {
                    "origin": {"lat": GEO_ORIGIN[0] + dlat,
                               "lon": GEO_ORIGIN[1] + dlon},
                    "scale": "100km", "offset": "10km", "decay": 0.5}}}],
                "boost_mode": "multiply"}}
        else:
            q = {"bool": {"must": [{"match": {"body": text}}],
                          "filter": [geo_leaf(kind, dlat, dlon)]}}
        out.append({"query": q, "size": args.k})
    return out


def haversine64(lat, lon, qlat, qlon):
    """float64 meters (the reference's formula)."""
    r = 6371008.8
    p1, p2 = np.radians(lat), np.radians(qlat)
    a = np.sin(np.radians(lat - qlat) / 2) ** 2 + np.cos(p1) * np.cos(p2) \
        * np.sin(np.radians(lon - qlon) / 2) ** 2
    return 2 * r * np.arcsin(np.sqrt(a))


def ray64(py, px, yi, xi, yj, xj):
    """(flips, margin deg²) of the even-odd step of the points against one
    edge in float64."""
    den = yj - yi
    crosses = (yi > py) != (yj > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xc = (xj - xi) * (py - yi) / np.where(den == 0, 1e-30, den) + xi
        margin = np.where(crosses, np.abs(px - xc) * np.abs(den), np.inf)
    return crosses & (px < xc), margin


def to_f32(v) -> float:
    """``v`` rounded to float32, as a plan's constant carries it."""
    return float(np.float32(v))


def geo_point_mask64(geo, kind, dlat, dlon):
    """float64 recompute of a geo_point leaf from the f32 coordinates the
    card holds and the f32 constants the plan carries. → (mask, band)."""
    from elasticsearch_tpu_torch.utils.geohash import (
        geohash_decode_bbox, geohash_encode, geohash_neighbors)
    lat, lon, ex = geo["lat32"], geo["lon32"], geo["exists"]
    band = np.zeros(len(lat), bool)
    la, lo = GEO_ORIGIN[0] + dlat, GEO_ORIGIN[1] + dlon

    def boxes_mask(boxes):
        m = np.zeros(len(lat), bool)
        for top, left, bottom, right in boxes:
            top, left, bottom, right = (to_f32(v) for v in (top, left, bottom,
                                                         right))
            in_lon = ((lon >= left) & (lon <= right)) if left <= right \
                else ((lon >= left) | (lon <= right))
            m |= (lat <= top) & (lat >= bottom) & in_lon
        return m
    if kind == "exists":
        return ex.copy(), band
    if kind in ("bbox", "dateline"):
        spec = geo_leaf(kind, dlat, dlon)["geo_bounding_box"]["location"]
        tl, br = spec["top_left"], spec["bottom_right"]
        return ex & boxes_mask([(tl["lat"], tl["lon"], br["lat"],
                                 br["lon"])]), band
    if kind == "geohash":
        gh = geohash_encode(la, lo, 5)
        cells = [gh] + geohash_neighbors(gh)
        return ex & boxes_mask([(hi, lo_, lo2, hi_) for lo2, hi, lo_, hi_ in
                                (geohash_decode_bbox(c) for c in cells)]), \
            band
    if kind == "polygon":
        ring = [(to_f32(y + dlat), to_f32(x + dlon)) for x, y in GEO_RING]
        ring.append(ring[0])
        par = np.zeros(len(lat), bool)
        margin = np.full(len(lat), np.inf)
        for (yi, xi), (yj, xj) in zip(ring[:-1], ring[1:]):
            flip, mg = ray64(lat, lon, yi, xi, yj, xj)
            par ^= flip
            margin = np.minimum(margin, mg)
        return ex & par, margin < GEO_SHAPE_BAND
    d = haversine64(lat, lon, to_f32(la), to_f32(lo))
    if kind == "distance":
        r = to_f32(200e3)
        return ex & (d <= r), np.abs(d - r) < GEO_DIST_BAND * r
    lo_b, hi_b = to_f32(200e3), to_f32(400e3)
    return ex & (d >= lo_b) & (d <= hi_b), \
        (np.abs(d - lo_b) < GEO_DIST_BAND * lo_b) | \
        (np.abs(d - hi_b) < GEO_DIST_BAND * hi_b)


def decay_factor64(geo, dlat, dlon, scale=100e3, offset=10e3, decay=0.5):
    """float64 gauss factor of every doc (1 where there is no point)."""
    d = haversine64(geo["lat32"], geo["lon32"], to_f32(GEO_ORIGIN[0] + dlat),
                    to_f32(GEO_ORIGIN[1] + dlon))
    dist = np.maximum(d - offset, 0.0)
    sigma2 = -scale * scale / (2.0 * np.log(decay))
    return np.where(geo["exists"], np.exp(-dist * dist / (2.0 * sigma2)),
                    1.0)


def shape_relation64(geo, rows, qshape, relation):
    """float64 recompute of a geo_shape relation over ``rows`` (indices
    into the corpus) from the f32 rings the card holds, the doc edges and
    vertices flattened. → (mask over rows, min margin deg² of each row)."""
    from elasticsearch_tpu_torch.utils.geoshape import parse_shape_rings
    s_lats, s_lons, s_rid, s_area, s_nv, s_ex = geo["shape"]
    ql, qo, qr, qa = parse_shape_rings(qshape)
    ql = np.asarray(ql, np.float32).astype(np.float64)
    qo = np.asarray(qo, np.float32).astype(np.float64)
    r = len(rows)
    lat = s_lats[rows].astype(np.float64)
    lon = s_lons[rows].astype(np.float64)
    rid, area, nv = s_rid[rows], s_area[rows], s_nv[rows]
    v = lat.shape[1]
    e_ok = (np.arange(v - 1)[None, :] < nv[:, None]) & \
        (rid[:, :-1] == rid[:, 1:]) & (rid[:, :-1] >= 0)
    er, ev = np.nonzero(e_ok)
    a_lat, a_lon = lat[er, ev], lon[er, ev]
    b_lat, b_lon = lat[er, ev + 1], lon[er, ev + 1]
    e_area = area[er, ev]
    vr, vv = np.nonzero(rid >= 0)
    p_lat, p_lon = lat[vr, vv], lon[vr, vv]
    rstart = (vv == 0) | (rid[vr, np.maximum(vv - 1, 0)] != rid[vr, vv])
    margin = np.full(r, np.inf)

    def orient(ax, ay, bx, by, cx, cy):
        return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    cross = np.zeros(r, bool)
    vpar = np.zeros(len(vr), bool)
    for i in range(len(ql) - 1):
        if qr[i] != qr[i + 1]:
            continue
        c_lat, c_lon, d_lat, d_lon = ql[i], qo[i], ql[i + 1], qo[i + 1]
        o = [orient(a_lon, a_lat, b_lon, b_lat, c_lon, c_lat),
             orient(a_lon, a_lat, b_lon, b_lat, d_lon, d_lat),
             orient(c_lon, c_lat, d_lon, d_lat, a_lon, a_lat),
             orient(c_lon, c_lat, d_lon, d_lat, b_lon, b_lat)]
        hit = (o[0] * o[1] <= 0) & (o[2] * o[3] <= 0)
        col = (o[0] == 0) & (o[1] == 0) & (o[2] == 0) & (o[3] == 0)
        bb = (np.minimum(a_lat, b_lat) <= max(c_lat, d_lat)) & \
            (np.maximum(a_lat, b_lat) >= min(c_lat, d_lat)) & \
            (np.minimum(a_lon, b_lon) <= max(c_lon, d_lon)) & \
            (np.maximum(a_lon, b_lon) >= min(c_lon, d_lon))
        hit &= np.where(col, bb, True)
        cross[er[hit]] = True
        m = np.minimum.reduce([np.abs(x) for x in o])
        np.minimum.at(margin, er, m)
        if qa[i]:
            flip, mg = ray64(p_lat, p_lon, c_lat, c_lon, d_lat, d_lon)
            vpar ^= flip
            np.minimum.at(margin, vr, mg)

    def q_in_doc(py, px):
        flip, mg = ray64(py, px, a_lat, a_lon, b_lat, b_lon)
        flip &= e_area
        np.minimum.at(margin, er[e_area], mg[e_area])
        return np.bincount(er[flip], minlength=r) % 2 == 1
    ex = s_ex[rows]
    if relation in ("intersects", "disjoint"):
        inter = cross | (np.bincount(vr[vpar & rstart], minlength=r) > 0)
        starts = [i for i in range(len(qr)) if i == 0 or qr[i] != qr[i - 1]]
        for s in starts:
            inter |= q_in_doc(ql[s], qo[s])
        out = inter if relation == "intersects" else ~inter
    elif relation == "within":
        all_in = np.bincount(vr[~vpar], minlength=r) == 0
        out = all_in & ~cross
    else:
        all_in = np.ones(r, bool)
        for i in range(len(ql) - 1):
            all_in &= q_in_doc(ql[i], qo[i])
        out = all_in & ~cross
    return ex & out, margin


def shape_mask64(geo, qshape, relation):
    """The relation over the whole corpus: rows whose bounding box misses
    the query's can neither meet nor hold it (intersects, within, contains
    False; disjoint True), so only the rest are recomputed. → (mask,
    band)."""
    from elasticsearch_tpu_torch.utils.geoshape import parse_shape_rings
    ql, qo, _, _ = parse_shape_rings(qshape)
    ql = np.asarray(ql, np.float32).astype(np.float64)
    qo = np.asarray(qo, np.float32).astype(np.float64)
    lat_lo, lat_hi, lon_lo, lon_hi = geo["bbox"]
    ex = geo["shape"][5]
    cand = np.nonzero(ex & (lat_lo <= ql.max()) & (lat_hi >= ql.min()) &
                      (lon_lo <= qo.max()) & (lon_hi >= qo.min()))[0]
    mask = ex.copy() if relation == "disjoint" else np.zeros(len(ex), bool)
    band = np.zeros(len(ex), bool)
    m, margin = shape_relation64(geo, cand, qshape, relation)
    mask[cand] = m
    band[cand] = margin < GEO_SHAPE_BAND
    return mask, band


def plain_geo_kernels():
    """A context in which the wrappers of K1, K17 and K18 run their plain
    versions also on CUDA tensors. Launches made there count nowhere."""
    import contextlib
    from elasticsearch_tpu_torch.ops import filters, geoshape, lexical

    @contextlib.contextmanager
    def ctx():
        saved = (lexical.bm25_match_batch, filters.geo_point_filter,
                 geoshape.shape_relation)
        lexical.bm25_match_batch = (
            lambda *a, trailing_pad=False, want_nmatch=True:
            lexical.bm25_match_batch_plain(*a, want_nmatch=want_nmatch))

        def point_plain(lat, lon, exists, mode, params, rl=None, ro=None):
            import torch
            return filters.geo_point_filter_plain(
                lat, lon, exists, mode, torch.as_tensor(
                    params, dtype=torch.float32, device=lat.device), rl, ro)

        def shape_plain(*a):
            if a[6].dim() == 1:
                return geoshape.shape_relation_plain(
                    *a[:6], a[6][None], a[7][None], *a[8:])[0]
            return geoshape.shape_relation_plain(*a)
        filters.geo_point_filter = point_plain
        geoshape.shape_relation = shape_plain
        try:
            yield
        finally:
            (lexical.bm25_match_batch, filters.geo_point_filter,
             geoshape.shape_relation) = saved
    return ctx()


def check_geo_batch(label, args, searcher, reqs, res_b, geo_mask64,
                    score64):
    """The first and the last request of a geo batch: against the plain
    versions on the card's tensors (total exact, the hits' scores bit for
    bit), then against the float64 recompute: ``geo_mask64(j)`` → (the geo
    leaf's mask, its band), ``score64(j)`` → (score of every doc, the match
    mask): the filtered set equal outside the band (at most 0.1% of rows
    excused), scores within 1e-5, tie-tolerant recall@k 1.0. → rows
    excused."""
    from elasticsearch_tpu_torch.search import segment_exec
    orig_of = gid_to_orig(searcher.reader)
    excused = 0
    for j in checked_requests(len(reqs)):
        req, res = reqs[j], res_b[j]
        scores, masks = [], []
        with plain_geo_kernels():
            for seg in searcher.reader.segments:
                s, m = segment_exec.execute(seg, searcher.ctx, req.query)
                nr = seg.seg.num_docs
                scores.append(s[:nr].cpu().numpy())
                masks.append(m[:nr].cpu().numpy())
        p_s, p_m = np.concatenate(scores), np.concatenate(masks)
        orig = orig_of[np.asarray(res.doc_ids, np.int64)]
        check(res.total == int(p_m.sum()),
              f"{label} request {j}: total {res.total} != the plain "
              f"versions' {int(p_m.sum())}")
        check(np.array_equal(np.asarray(res.scores, np.float32), p_s[orig]),
              f"{label} request {j}: the hits' scores differ from the plain "
              f"versions'")
        s64, matched = score64(j)
        g64, band = geo_mask64(j)
        m64 = matched & g64
        diff = m64 != p_m
        check(not (diff & ~band).any(),
              f"{label} request {j}: {int((diff & ~band).sum())} docs "
              f"filtered otherwise than the float64 recompute, outside the "
              f"band")
        check(diff.sum() <= GEO_MAX_EXCUSED * len(diff),
              f"{label} request {j}: {int(diff.sum())} rows excused")
        excused += int(diff.sum())
        check_vs_cpu(label, args, [res], [s64], [p_m], orig_of, k=req.size)
    return excused


def k17_params(torch, kind, off, dev):
    """K17's mode and [B, P] parameters (rings) for a geo_point path's
    requests, as the resolvers build them."""
    from elasticsearch_tpu_torch.ops import filters
    from elasticsearch_tpu_torch.utils.geohash import (
        geohash_decode_bbox, geohash_encode, geohash_neighbors)
    la = GEO_ORIGIN[0] + off[:, 0]
    lo = GEO_ORIGIN[1] + off[:, 1]
    rl = ro = None
    if kind == "distance":
        mode, p = filters.GEO_DISTANCE, np.stack(
            [la, lo, np.full(len(la), 200e3)], 1)
    elif kind == "distance_range":
        mode, p = filters.GEO_DISTANCE_RANGE, np.stack(
            [la, lo, np.full(len(la), 200e3), np.full(len(la), -1.0),
             np.full(len(la), 400e3), np.full(len(la), -1.0)], 1)
    elif kind == "decay":
        mode, p = filters.GEO_DISTANCE_OUT, np.stack([la, lo], 1)
    elif kind in ("bbox", "dateline"):
        top, left, bottom, right = (61.0, -0.1, 48.0, 15.0) \
            if kind == "bbox" else (20.0, 170.0, -20.0, -170.0)
        mode, p = filters.GEO_BOXES, np.stack(
            [top + off[:, 0], left + off[:, 1], bottom + off[:, 0],
             right + off[:, 1]], 1)
    elif kind == "geohash":
        rows = []
        for a, b in zip(la, lo):
            gh = geohash_encode(a, b, 5)
            cells = [gh] + geohash_neighbors(gh)
            rows.append([v for lo2, hi, lo_, hi_ in
                         (geohash_decode_bbox(c) for c in cells)
                         for v in (hi, lo_, lo2, hi_)])
        mode, p = filters.GEO_BOXES, np.asarray(rows)
    else:                                       # polygon
        ring = np.asarray(GEO_RING + GEO_RING[:1])
        mode, p = filters.GEO_POLYGON, np.zeros((len(la), 0))
        rl = torch.from_numpy((ring[None, :, 1] + off[:, :1]).astype(
            np.float32)).to(dev)
        ro = torch.from_numpy((ring[None, :, 0] + off[:, 1:]).astype(
            np.float32)).to(dev)
    return mode, torch.from_numpy(p.astype(np.float32)).to(dev), rl, ro


def k18_query(torch, qname, off, dev):
    """K18's query arrays for a geo_shape path's requests."""
    from elasticsearch_tpu_torch.utils.geoshape import parse_shape_rings
    rows = [parse_shape_rings(geo_move(GEO_QUERY_SHAPES[qname], a, b))
            for a, b in off]
    ql = torch.tensor(np.asarray([r[0] for r in rows], np.float32),
                      device=dev)
    qo = torch.tensor(np.asarray([r[1] for r in rows], np.float32),
                      device=dev)
    return ql, qo, np.asarray(rows[0][2], np.int32), \
        np.asarray(rows[0][3], bool)


def k18_ops(col_rows, qr, qa, relation, b):
    """The reference's operations for a K18 batch over these rows
    (``col_rows``: rid, nv, exists on the host): 24 an orientation test of
    a valid doc edge against a valid query edge, 9 a ray step of a doc
    vertex through an area edge (intersects, disjoint, within) or of a
    query vertex through a doc area edge (contains, and intersects'
    query-ring starts)."""
    rid, area, nv, ex = col_rows
    v = rid.shape[1]
    edges = ((np.arange(v - 1)[None, :] < nv[:, None]) &
             (rid[:, :-1] == rid[:, 1:]) & (rid[:, :-1] >= 0) &
             ex[:, None])
    n_edges = int(edges.sum())
    n_area_edges = int((edges & area[:, :-1]).sum())
    n_vert = int(((rid >= 0) & ex[:, None]).sum())
    q_edges = sum(1 for i in range(len(qr) - 1) if qr[i] == qr[i + 1])
    q_area = sum(1 for i in range(len(qr) - 1)
                 if qr[i] == qr[i + 1] and qa[i])
    starts = sum(1 for i in range(len(qr)) if i == 0 or qr[i] != qr[i - 1])
    per = 24 * n_edges * q_edges
    if relation != "contains":
        per += 9 * n_vert * q_area
    if relation in ("intersects", "disjoint"):
        per += 9 * n_area_edges * starts
    if relation == "contains":
        per += 9 * n_area_edges * (len(qr) - 1)
    return float(per) * b


def phase_geo_kernels(torch, args, data, geo) -> list[dict]:
    """Phase 47: K17 in every mode and K18 in every relation against their
    plain versions, bit for bit, at the geo paths' shapes on segment 0 (B =
    64, N = 2^20) and at odd shapes (N = 100,003, an empty batch, points on
    a box edge and a polygon vertex, a zero-length doc edge, a collinear
    touch, horizontal query edges), timed beside the plain versions (K18's
    on queries 0, 31, 32 and 63) and the bounds."""
    from elasticsearch_tpu_torch.ops import filters, geoshape
    seg = data["reader"].segments[0]
    g, s = seg.geo["location"], seg.shape["area"]
    dev = g.lat.device
    n = g.lat.shape[0]
    b = args.batch
    qi = torch.tensor(plain_queries(b), device=dev)
    pq = len(qi)
    kernels = []

    def same(got, want, what):
        torch.cuda.synchronize()
        if got.dtype == torch.float32:
            ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            ok = torch.equal(got, want)
        check(ok and got.shape == want.shape,
              f"{what} is not bit-identical to its plain version")

    # ---- K17 at the paths' shapes ------------------------------------------
    k17 = {}
    for kind in ("distance", "distance_range", "bbox", "dateline",
                 "geohash", "polygon", "decay"):
        off = geo_offsets(args, b, 0)
        mode, params, rl, ro = k17_params(torch, kind, off, dev)
        got = filters.geo_point_filter(g.lat, g.lon, g.exists, mode, params,
                                       rl, ro)
        want = filters.geo_point_filter_plain(g.lat, g.lon, g.exists, mode,
                                              params, rl, ro)
        same(got, want, f"K17 {kind} (B={b}, N={n})")
        if kind != "decay":
            check(bool(got.any()), f"K17 {kind}: nothing matched")
        ms = timed(torch, f"K17 {kind}", lambda: filters.geo_point_filter(
            g.lat, g.lon, g.exists, mode, params, rl, ro), reps=10)
        plain = timed(torch, f"K17 {kind} plain", lambda:
                      filters.geo_point_filter_plain(
                          g.lat, g.lon, g.exists, mode, params, rl, ro),
                      reps=2)
        out_b = 4 if kind == "decay" else 1
        byts = 9 * n + nbytes(params) + out_b * b * n + \
            (0 if rl is None else nbytes(rl) + nbytes(ro))
        if kind in ("distance", "distance_range", "decay"):
            ops = 18 * b * n          # the haversine: 15 + 3 libm calls
        elif kind == "polygon":
            ops = 9 * b * n * (rl.shape[1] - 1)
        else:
            ops = 6 * b * n * (params.shape[1] // 4)
        bnd, by = bound(byts, ops)
        k17[kind] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                     "bound_by": by}
        log(f"K17 geo_point_filter {kind} [B={b}, N={n}]: bit-identical to "
            f"plain; kernel_ms={ms:.4f} plain_ms={plain:.4f} "
            f"bound_ms={bnd:.4f} ({by}: {byts} B, {ops} ops)")
    # odd shapes: N = 100,003, points on a box edge and a polygon vertex, an
    # empty batch, 9 boxes across the dateline, a horizontal ring edge
    n_odd = min(n, 100_003)
    lat = g.lat[:n_odd].clone()
    lon = g.lon[:n_odd].clone()
    ex = g.exists[:n_odd]
    lat[:4] = torch.tensor([61.0, 48.0, 49.0, 60.0], device=dev)
    lon[:4] = torch.tensor([-0.1, 15.0, -0.1, 14.0], device=dev)
    ring = torch.tensor([[49.0, 48.0, 48.0, 60.0, 61.0, 50.0, 49.0]],
                        device=dev)
    ring_o = torch.tensor([[-0.1, 5.0, 15.0, 14.0, -0.1, -10.0, -0.1]],
                          device=dev)
    boxes = torch.tensor([[61.0, -0.1, 48.0, 15.0] + [5.0, 170.0, -5.0,
                                                      -170.0] * 8,
                          [60.0, 14.0, 49.0, -0.1] * 9], device=dev)
    odd = [(filters.GEO_DISTANCE, torch.tensor(
        [[55.0, 7.0, 200e3], [61.0, -0.1, 0.0], [0.0, 0.0, 2e7]],
        device=dev), None, None),
        (filters.GEO_DISTANCE_RANGE, torch.tensor(
            [[55.0, 7.0, -1.0, 1e5, -1.0, 3e5]], device=dev), None, None),
        (filters.GEO_BOXES, boxes, None, None),
        (filters.GEO_POLYGON, torch.zeros((1, 0), device=dev), ring,
         ring_o),
        (filters.GEO_DISTANCE_OUT, torch.tensor([[55.0, 7.0], [-89.0, 180.0]],
                                                device=dev), None, None)]
    for mode, params, rl, ro in odd:
        same(filters.geo_point_filter(lat, lon, ex, mode, params, rl, ro),
             filters.geo_point_filter_plain(lat, lon, ex, mode, params, rl,
                                            ro),
             f"K17 mode {mode} at the odd shape N={n_odd}")
        e = filters.geo_point_filter(lat, lon, ex, mode, params[:0],
                                     None if rl is None else rl[:0],
                                     None if ro is None else ro[:0])
        check(e.shape == (0, n_odd), f"K17 mode {mode}: an empty batch")
    log(f"K17 geo_point_filter: bit-identical to plain at the odd shapes "
        f"(N={n_odd}; points on box edges and ring vertices, 9 boxes across "
        f"the dateline, a horizontal ring edge, empty batches)")
    main = k17["distance"]
    kernels.append({
        "name": "geo_point_filter", "route": "cuda", "source": K17_SOURCE,
        "replaces": K17_REPLACES, "launches": 0, "max_abs_err": 0.0,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_null": "no single torch call computes a haversine, a box "
                        "test or a ray cast over a column",
        "modes": k17, "shape": {"B": b, "N": n}})

    # ---- K18 at the paths' shapes ----------------------------------------
    host_rows = (s.rid.cpu().numpy(), s.area.cpu().numpy(),
                 s.nv.cpu().numpy(), s.exists.cpu().numpy())
    col = (s.lats, s.lons, s.nv, s.exists, s.rid, s.area)
    k18 = {}
    for qname in GEO_QUERY_SHAPES:
        off = geo_offsets(args, b, 0)
        ql, qo, qr, qa = k18_query(torch, qname, off, dev)
        for rel in GEO_RELATIONS:
            got = geoshape.shape_relation(*col, ql, qo, qr, qa, rel)
            want = geoshape.shape_relation_plain(*col, ql[qi], qo[qi], qr,
                                                 qa, rel)
            same(got[qi], want, f"K18 {rel} {qname} (B={b}, N={n})")
            ms = timed(torch, f"K18 {rel} {qname}", lambda:
                       geoshape.shape_relation(*col, ql, qo, qr, qa, rel),
                       reps=3)
            ops = k18_ops(host_rows, qr, qa, rel, b)
            byts = sum(nbytes(t) for t in col) + b * n + nbytes(ql) * 2
            bnd, by = bound(byts, ops)
            rec = {"ms": ms, "bound_ms": bnd, "bound_by": by,
                   "matches": int(got.sum()), "E": int(ql.shape[1] - 1)}
            if qname == "circle" and rel == "intersects":
                rec["plain_ms"] = timed(
                    torch, f"K18 plain ({pq} queries)", lambda:
                    geoshape.shape_relation_plain(*col, ql[qi], qo[qi], qr,
                                                  qa, rel), reps=1, warmup=0)
            k18[f"{rel}/{qname}"] = rec
            log(f"K18 shape_relation {rel} {qname} [B={b}, N={n}, V="
                f"{s.lats.shape[1]}, E={ql.shape[1] - 1}]: bit-identical to "
                f"plain on queries {plain_queries(b)}; kernel_ms={ms:.4f} "
                f"bound_ms={bnd:.4f} ({by}: {byts} B, {ops:.4g} ops)"
                + (f" plain_ms={rec['plain_ms']:.4f} ({pq} queries)"
                   if "plain_ms" in rec else ""))
    # odd shapes: N = 100,003; a point on the line of the envelope's top
    # edge far away (collinear, disjoint), one on that edge (a touch), the
    # points' zero-length edges; every query edge of the envelope is
    # horizontal or vertical; an empty batch
    odd_col = [t[:n_odd].clone() for t in col]
    for r, (la_, lo_) in enumerate(((55.5, 100.0), (55.5, 7.0))):
        odd_col[5][r] = False
        odd_col[0][r, :2] = la_
        odd_col[1][r, :2] = lo_
        odd_col[2][r] = 1
        odd_col[3][r] = True
        odd_col[4][r] = torch.tensor([0, 0] + [-1] * (col[4].shape[1] - 2),
                                     dtype=torch.int32, device=dev)
        odd_col[5][r, :2] = True
    ql, qo, qr, qa = k18_query(torch, "envelope", np.zeros((3, 2)), dev)
    ql[1:] += 0.25
    for rel in GEO_RELATIONS:
        got = geoshape.shape_relation(*odd_col, ql, qo, qr, qa, rel)
        same(got, geoshape.shape_relation_plain(*odd_col, ql, qo, qr, qa,
                                                rel),
             f"K18 {rel} at the odd shape N={n_odd}")
        if rel == "intersects":
            check(not bool(got[0, 0]) and bool(got[0, 1]),
                  "K18: the collinear point must stay disjoint and the "
                  "point on the edge intersect")
        e = geoshape.shape_relation(*odd_col, ql[:0], qo[:0], qr, qa, rel)
        check(e.shape == (0, n_odd), "K18: an empty batch")
    log(f"K18 shape_relation: bit-identical to plain at the odd shape "
        f"N={n_odd} (a collinear far point disjoint, a point on an edge "
        f"intersecting, zero-length point edges, axis-parallel query edges, "
        f"empty batches), every relation")
    main = k18["intersects/circle"]
    kernels.append({
        "name": "shape_relation", "route": "cuda", "source": K18_SOURCE,
        "replaces": K18_REPLACES, "launches": 0, "max_abs_err": 0.0,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "plain_queries": pq, "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "library_null": "no single torch call tests edges or ray-casts "
                        "vertex rings",
        "relations": k18, "shape": {"B": b, "N": n,
                                    "V": int(s.lats.shape[1])}})
    return kernels


def phase_geo_paths(torch, args, data, geo, f64, name, smi_line) -> dict:
    """Phase 48: the geo batches through query_phase_batch — geo_polygon,
    geo_bounding_box (and across the dateline), geo_distance,
    geo_distance_range, geohash_cell with neighbours, exists, the gauss
    decay, geo_shape in each relation against each query shape (one batch
    each) — the first and the last request of each batch
    against the plain versions on the card's tensors and a float64
    recompute (check_geo_batch)."""
    out = {}
    excused = {}
    for kind in GEO_POINT_PATHS + GEO_SHAPE_PATHS:
        point = kind in GEO_POINT_PATHS
        bodies = geo_bodies(args, data, kind, args.batch)
        batches = batches_of(args, bodies)
        results, per_batch, wall, launches, peak = drive(
            torch, data["searcher"], batches)
        needed = ("bm25_scan", "stable_topk",
                  "geo_point_filter" if point else "shape_relation")
        if kind == "exists":
            needed = needed[:2]
        out[kind] = report(f"geo {kind}", args, data, batches, per_batch,
                           wall, launches, peak, name, smi_line, needed)
        off = geo_offsets(args, args.batch, 0)
        n_exc = 0
        for bi, (reqs, res_b) in enumerate(zip(batches, results)):
            def score64(j, bi=bi):
                i = bi * args.batch + j
                s, cnt = f64.bm25(data["qtids"][i])
                if kind == "decay":
                    return s * decay_factor64(geo, *off[i]), cnt > 0
                return s, cnt > 0

            def mask64(j, bi=bi):
                i = bi * args.batch + j
                if kind == "decay":
                    return np.ones(len(geo["exists"]), bool), \
                        np.zeros(len(geo["exists"]), bool)
                if point:
                    return geo_point_mask64(geo, kind, *off[i])
                rel, qname = kind.split("/")
                return shape_mask64(geo, geo_move(GEO_QUERY_SHAPES[qname],
                                                  *off[i]), rel)
            n_exc += check_geo_batch(f"geo {kind}", args, data["searcher"],
                                     reqs, res_b, mask64, score64)
        excused[kind] = n_exc
    log(f"geo paths: every checked request equal to the plain versions on "
        f"the card (totals, scores bit for bit) and to the float64 "
        f"recompute outside the band (rows excused by path: {excused}; "
        f"scores within 1e-5, tie-tolerant recall 1.0)")
    return out


def geohash64(lat, lon, length):
    """Vectorised geohash_encode (the same float64 bisection) → [N] str."""
    from elasticsearch_tpu_torch.utils.geohash import _BASE32
    lat_lo = np.full(len(lat), -90.0)
    lat_hi = np.full(len(lat), 90.0)
    lon_lo = np.full(len(lat), -180.0)
    lon_hi = np.full(len(lat), 180.0)
    chars = []
    even = True
    code = np.zeros(len(lat), np.int64)
    for bit in range(5 * length):
        if even:
            mid = (lon_lo + lon_hi) / 2
            up = lon >= mid
            lon_lo = np.where(up, mid, lon_lo)
            lon_hi = np.where(up, lon_hi, mid)
        else:
            mid = (lat_lo + lat_hi) / 2
            up = lat >= mid
            lat_lo = np.where(up, mid, lat_lo)
            lat_hi = np.where(up, lat_hi, mid)
        code = (code << 1) | up
        even = not even
        if bit % 5 == 4:
            chars.append(np.asarray(list(_BASE32))[code])
            code[:] = 0
    return np.asarray(["".join(c) for c in zip(*chars)]) if chars else \
        np.zeros(0, str)


def phase_geo_aggs(torch, args, data, geo, f64, name, smi_line) -> dict:
    """Phase 49: one request with the geo_distance 400 km filter and the
    geo aggregations — geohash_grid at precision 4 with a geo_centroid sub,
    geo_distance ranges 0-100 / 100-200 / 200-400 km, geo_bounds — through
    query_phase and controller.merge_responses, against numpy over the
    card's match mask; the host collectors timed apart."""
    from elasticsearch_tpu_torch.search import (aggregations, controller,
                                                segment_exec)
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    searcher = data["searcher"]
    aggs = {
        "grid": {"geohash_grid": {"field": "location", "precision": 4},
                 "aggs": {"c": {"geo_centroid": {"field": "location"}}}},
        "rings": {"geo_distance": {"field": "location", "origin": "55,7",
                                   "unit": "km", "ranges": [
                                       {"from": 0, "to": 100},
                                       {"from": 100, "to": 200},
                                       {"from": 200, "to": 400}]}},
        "bounds": {"geo_bounds": {"field": "location"}}}
    body = {"query": {"bool": {
        "must": [{"match": {"body": data["texts"][0]}}],
        "filter": [{"geo_distance": {"distance": "400km",
                                     "location": "55,7"}}]}},
        "size": 10, "aggs": aggs}
    req = parse_search_request(body)
    coll_ms = {}
    saved = dict(aggregations._COLLECTORS)

    def timed_collector(kind):
        def run(node, mask, ctx):
            t0 = time.perf_counter()
            try:
                return saved[kind](node, mask, ctx)
            finally:
                coll_ms[kind] = coll_ms.get(kind, 0.0) + \
                    (time.perf_counter() - t0) * 1e3
        return run
    for kind in ("geohash_grid", "geo_distance", "geo_bounds",
                 "geo_centroid"):
        aggregations._COLLECTORS[kind] = timed_collector(kind)
    counters = reset_launches()
    try:
        t0 = time.perf_counter()
        res = searcher.query_phase(req)
        qp_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        merged = controller.merge_responses("geo", req, [res], [searcher],
                                            0.0, req.aggs)
        merge_ms = (time.perf_counter() - t0) * 1e3
    finally:
        aggregations._COLLECTORS.update(saved)
    launches = read_launches(counters)
    check(launches["geo_point_filter"] > 0 and launches["bm25_scan"] > 0,
          f"geo aggs: launches {launches}")
    # numpy over the card's own match mask and the host's float64 columns
    mask = np.concatenate([
        segment_exec.match_mask(s, searcher.ctx, req.query).cpu().numpy()[
            :s.seg.num_docs] for s in searcher.reader.segments])
    check(int(mask.sum()) == res.total, "geo aggs: the match mask's count")
    _, cnt = f64.bm25(data["qtids"][0])
    d400 = haversine64(geo["lat32"], geo["lon32"], 55.0, 7.0)
    band = np.abs(d400 - to_f32(400e3)) < GEO_DIST_BAND * to_f32(400e3)
    m64 = (cnt > 0) & geo["exists"] & (d400 <= to_f32(400e3))
    check(not ((m64 != mask) & ~band).any(),
          "geo aggs: the card's mask differs from the float64 recompute "
          "outside the band")
    lat, lon = geo["lat"][mask], geo["lon"][mask]
    got = merged["aggregations"]
    cells = geohash64(lat, lon, 4)
    keys, counts = np.unique(cells, return_counts=True)
    want_grid = {k: int(c) for k, c in zip(keys, counts)}
    got_grid = {b["key"]: b for b in got["grid"]["buckets"]}
    check({k: b["doc_count"] for k, b in got_grid.items()} == want_grid,
          "geo aggs: geohash_grid buckets differ from numpy")
    for k, b in list(got_grid.items())[:50]:
        sel = cells == k
        c = b["c"]
        check(c["count"] == int(sel.sum()) and np.isclose(
            c["location"]["lat"], lat[sel].mean(), rtol=1e-12) and
            np.isclose(c["location"]["lon"], lon[sel].mean(), rtol=1e-12),
            f"geo aggs: the centroid of cell {k}")
    # the aggregation's km haversine (r = 6371.0087714 km) from the origin
    p1, p2 = np.radians(55.0), np.radians(lat)
    a = np.sin(np.radians(lat - 55.0) / 2) ** 2 + np.cos(p1) * np.cos(p2) \
        * np.sin(np.radians(lon - 7.0) / 2) ** 2
    dist_km = 2 * 6371.0087714 * np.arcsin(np.sqrt(a))
    for b, (lo_, hi_) in zip(got["rings"]["buckets"],
                             ((0, 100), (100, 200), (200, 400))):
        want = int(((dist_km >= lo_) & (dist_km < hi_)).sum())
        check(b["doc_count"] == want, f"geo aggs: geo_distance bucket "
              f"{lo_}-{hi_}: {b['doc_count']} != numpy {want}")
    bb = got["bounds"]["bounds"]
    check(bb["top_left"]["lat"] == lat.max() and
          bb["bottom_right"]["lat"] == lat.min() and
          bb["top_left"]["lon"] == lon.min() and
          bb["bottom_right"]["lon"] == lon.max(),
          "geo aggs: geo_bounds differs from numpy")
    log(f"geo aggs: {res.total} matches (a 4-term match inside 400 km of "
        f"(55, 7)), {len(want_grid)} geohash cells at precision 4 with their "
        f"centroids, 3 distance rings "
        f"{[b['doc_count'] for b in got['rings']['buckets']]}, "
        f"bounds; equal to numpy over the card's mask (itself equal to the "
        f"float64 recompute outside the band); query_phase {qp_ms:.1f} ms "
        f"of which the host collectors "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in coll_ms.items())
        + f" (geohash_grid encodes each matching point in a Python loop, "
        f"{1e3 * coll_ms.get('geohash_grid', 0) / max(res.total, 1):.2f} "
        f"µs a point with its sub-aggregation); merge {merge_ms:.1f} ms; "
        f"launches {dict((k, v) for k, v in launches.items() if v)} — on "
        f"{name} ({smi_line})")
    return {"launches": launches, "query_ms": qp_ms, "merge_ms": merge_ms,
            "collector_ms": coll_ms}


def geo_perc_registry(seed):
    """GEO_REGS registrations: a third geo_distance, a third
    geo_bounding_box over the registration's own box, a third geo_shape
    (intersects) of a small polygon or envelope, around GEO_ORIGIN; and
    GEO_PROBES probe docs, each a location and an area."""
    rng = np.random.default_rng([seed, 51])
    regs = {}
    for i in range(GEO_REGS):
        la = GEO_ORIGIN[0] + rng.uniform(-2, 2)
        lo = GEO_ORIGIN[1] + rng.uniform(-2, 2)
        if i % 3 == 0:
            km = int(rng.integers(20, 300))
            q = {"geo_distance": {"distance": f"{km}km",
                                  "location": {"lat": la, "lon": lo}}}
        elif i % 3 == 1:
            h, w = rng.uniform(0.2, 2.0, 2)
            q = {"geo_bounding_box": {"location": {
                "top_left": {"lat": la + h, "lon": lo - w},
                "bottom_right": {"lat": la - h, "lon": lo + w}}}}
        else:
            r = rng.uniform(0.05, 0.6)
            if i % 2:
                shape = {"type": "envelope", "coordinates": [
                    [lo - r, la + r], [lo + r, la - r]]}
            else:
                shape = {"type": "polygon", "coordinates": [[
                    [lo - r, la - r], [lo + r, la - r], [lo, la + r],
                    [lo - r, la - r]]]}
            q = {"geo_shape": {"area": {"shape": shape}}}
        regs[f"g{i}"] = {"query": q}
    probes = []
    for i in range(GEO_PROBES):
        la = GEO_ORIGIN[0] + rng.uniform(-1, 1)
        lo = GEO_ORIGIN[1] + rng.uniform(-1, 1)
        r = rng.uniform(0.01, 0.2)
        probes.append({"location": {"lat": la, "lon": lo},
                       "area": {"type": "polygon", "coordinates": [[
                           [lo - r, la], [lo, la - r], [lo + r, la],
                           [lo, la + r], [lo - r, la]]]}})
    return regs, probes


def geo_perc_oracle(regs, doc):
    """float64 recompute of every registration against one probe: its
    point and rings as the one-doc segment holds them (f32), the
    registrations' constants as their plans carry them (f32). → ({qid}
    matched, {qid} in the band)."""
    from elasticsearch_tpu_torch.search.query_dsl import parse_query
    from elasticsearch_tpu_torch.utils.geoshape import parse_shape_rings
    lat = np.float64(np.float32(doc["location"]["lat"]))
    lon = np.float64(np.float32(doc["location"]["lon"]))
    rl, ro, rr, ra = parse_shape_rings(doc["area"])
    v = len(rl)
    one = {"exists": np.ones(1, bool), "shape": (
        np.asarray([rl], np.float32), np.asarray([ro], np.float32),
        np.asarray([rr], np.int32), np.asarray([ra], bool),
        np.asarray([v - 1], np.int32), np.ones(1, bool))}
    matched, band = set(), set()
    for qid, reg in regs.items():
        q = parse_query(reg["query"])
        kind = type(q).__name__
        if kind == "GeoDistanceQuery":
            d = haversine64(lat, lon, to_f32(q.lat), to_f32(q.lon))
            r = to_f32(q.distance_m)
            hit, near = d <= r, abs(d - r) < GEO_DIST_BAND * r
        elif kind == "GeoBoundingBoxQuery":
            hit = to_f32(q.bottom) <= lat <= to_f32(q.top) and \
                to_f32(q.left) <= lon <= to_f32(q.right)
            near = False
        else:
            m, margin = shape_relation64(one, np.zeros(1, np.int64),
                                         q.shape, q.relation)
            hit, near = bool(m[0]), bool(margin[0] < GEO_SHAPE_BAND)
        if hit:
            matched.add(qid)
        if near:
            band.add(qid)
    return matched, band


def phase_geo_percolate(torch, args, data, name, smi_line) -> dict:
    """Phase 50: GEO_REGS geo registrations (geo_distance and
    geo_bounding_box on the fused lanes, geo_shape on the eager lane), a
    percolate per probe and one percolate_many of the GEO_PROBES probes;
    every registration's flag against the float64 recompute, probe 0
    against percolate_serial, every item of percolate_many equal to its own
    percolate call."""
    from elasticsearch_tpu_torch.search import percolator
    dev = data["reader"].device
    regs, probes = geo_perc_registry(args.seed)
    meta = perc_meta("smoke_geo_perc", {"_doc": {"properties": {
        "location": {"type": "geo_point"},
        "area": {"type": "geo_shape"}}}}, regs)
    t0 = time.perf_counter()
    reg = percolator.registry_for(meta, dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: 0 for k in path_kernels()}
    recs, outs = [], []
    excused = 0
    for pi, d in enumerate(probes):
        out, rec = perc_call(torch, lambda d=d: percolator.percolate(
            meta, d, score=True, device=dev))
        for k_, v in rec["launches"].items():
            launches[k_] += v
        recs.append(rec)
        outs.append(out)
        want, band = geo_perc_oracle(regs, d)
        got = {m["_id"] for m in out["matches"]}
        diff = got ^ want
        check(not (diff - band), f"geo percolate probe {pi}: "
              f"{len(diff - band)} registrations differ from the float64 "
              f"recompute outside the band")
        excused += len(diff)
        check(all(m["_score"] == 1.0 for m in out["matches"]),
              f"geo percolate probe {pi}: a filter scored other than 1.0")
    t0 = time.perf_counter()
    ser = percolator.percolate_serial(meta, probes[0], score=True,
                                      device=dev)
    serial_ms = (time.perf_counter() - t0) * 1e3
    check([m["_id"] for m in ser["matches"]] ==
          [m["_id"] for m in outs[0]["matches"]],
          "geo percolate: probe 0 differs from percolate_serial")
    many, mrec = perc_call(torch, lambda: percolator.percolate_many(
        meta, [{"doc": d, "score": True} for d in probes], device=dev))
    for k_, v in mrec["launches"].items():
        launches[k_] += v
    check(many == outs, "geo percolate_many: an item differs from its own "
          "percolate call")
    for k_ in ("geo_point_filter", "shape_relation", "percolate_reduce"):
        check(launches[k_] > 0, f"geo percolate: {k_} was not launched")
    walls = [r["wall_ms"] for r in recs]
    p50 = statistics.median(walls)
    log(f"geo percolate: {GEO_REGS} registrations (registry built in "
        f"{build_ms:.1f} ms, {reg.stats_dict()['shape_buckets']} shape "
        f"buckets), {len(probes)} probes: p50 {p50:.3f} ms a call; matches a "
        f"probe {[o['total'] for o in outs]}, every registration's flag "
        f"equal to the float64 recompute ({excused} in the band); probe 0 "
        f"equal to percolate_serial ({serial_ms:.1f} ms); percolate_many "
        f"{perc_line(mrec)}, each item equal to its percolate call — on "
        f"{name} ({smi_line})")
    return {"launches": launches, "p50_ms": p50, "many_ms": mrec["wall_ms"],
            "serial_ms": serial_ms}


# --------------------------------------------------------------------------
# nested documents (phases 52-53): answers under config 1's questions (K19)
# --------------------------------------------------------------------------

NESTED_PATH = "answers"
#: answers a question: negative binomial (shape 0.6, mean 1.5): 47% of the
#: questions have none, sd 2.3, a geometric tail into the dozens
NESTED_NB_SHAPE = 0.6
NESTED_MEAN = 1.5
#: answers.user: Zipf 1.1 over 100,000 users; answers.date uniform over
#: 2008-2016 (epoch ms); answers.body 1-16 words (log-normal, median 8)
#: from the smoke's vocabulary and its Zipf
NESTED_USERS = 100_000
NESTED_ZIPF = 1.1
NESTED_DATES = (1_199_145_600_000, 1_483_228_800_000)
NESTED_BODY_MEDIAN = 8.0
NESTED_BODY_MAX = 16
NESTED_DAY_MS = 86_400_000
NESTED_KINDS = ("rally", "match_avg", "match_sum", "bool_filter")
#: batches of each nested path (Float64 holds the postings of the terms of
#: this many batches' requests, and of LEAF_BATCHES')
NESTED_BATCHES = 2
NESTED_AGG_REQUESTS = 2
NESTED_REGS = 1000
NESTED_PROBES = 12
NESTED_PERC_WORDS = [f"nw{i:03d}" for i in range(200)]
NESTED_PERC_USERS = [f"pu{i:02d}" for i in range(50)]


def nested_mapping() -> dict:
    return {"properties": {NESTED_PATH: {"type": "nested", "properties": {
        "user": {"type": "keyword"}, "date": {"type": "date"},
        "body": {"type": "text", "analyzer": "whitespace"}}}}}


def phase_nested_setup(torch, args, data) -> dict:
    """Phase 52's set-up: a nested path ``answers`` on config 1's segments,
    shaped after Rally's ``nested`` track (StackOverflow questions and
    their answers): the answers of each question drawn from the seed,
    built into child blocks with index/carry.nested_block_from_arrays
    (no per-object mapper pass) and packed onto the card with their
    parents' live masks; the host keeps its own copy of every child column
    for the float64 checks."""
    from elasticsearch_tpu_torch.index.carry import nested_block_from_arrays
    from elasticsearch_tpu_torch.index.segment import doc_count_bucket
    rng = np.random.default_rng([args.seed, 52])
    t0 = time.perf_counter()
    p = NESTED_NB_SHAPE / (NESTED_NB_SHAPE + NESTED_MEAN)
    counts = rng.negative_binomial(NESTED_NB_SHAPE, p, args.docs).astype(
        np.int64)
    nc = int(counts.sum())
    parent_of = np.repeat(np.arange(args.docs), counts)
    w = np.arange(1, NESTED_USERS + 1, dtype=np.float64) ** -NESTED_ZIPF
    user = np.searchsorted(np.cumsum(w / w.sum()), rng.random(nc)).astype(
        np.int32)
    user = np.minimum(user, NESTED_USERS - 1)
    date = rng.integers(*NESTED_DATES, nc).astype(np.float64)
    uterms, utf, lens, df, _ = make_corpus(
        rng, nc, args.vocab, NESTED_BODY_MAX, median=NESTED_BODY_MEDIAN,
        min_len=1, max_len=NESTED_BODY_MAX)
    build_s = time.perf_counter() - t0
    reader = data["reader"]
    data["mapper"].merge("_doc", nested_mapping())
    users = [f"u{i:06d}" for i in range(NESTED_USERS)]
    t0 = time.perf_counter()
    for dseg in reader.segments:
        seg = dseg.seg
        lo = int(seg.ids[0])
        c_lo, c_hi = (int(x) for x in np.searchsorted(
            parent_of, [lo, lo + seg.num_docs]))
        n_ch = c_hi - c_lo
        padded = doc_count_bucket(n_ch)

        def pad(a, fill=0):
            out = np.full((padded,) + a.shape[1:], fill, a.dtype)
            out[:n_ch] = a[c_lo:c_hi]
            return out
        ut = uterms[c_lo:c_hi]
        seg_df = np.bincount(ut[ut >= 0], minlength=args.vocab)
        parent = np.full(padded, -1, np.int32)
        parent[:n_ch] = parent_of[c_lo:c_hi] - lo
        blk = nested_block_from_arrays(
            parent, f"{NESTED_PATH}.body", terms=data["term_names"],
            uterms=pad(uterms, -1), utf=pad(utf, 0.0), doc_len=pad(lens),
            df=seg_df, num_children=n_ch,
            keyword={f"{NESTED_PATH}.user": (users, pad(user[:, None], -1))},
            numeric={f"{NESTED_PATH}.date": (
                pad(date), np.arange(padded) < n_ch)})
        seg.nested_blocks[NESTED_PATH] = blk
        dseg.nested[NESTED_PATH] = reader.pack_nested(
            blk, dseg.live.cpu().numpy())
        reader._collect_seg_stats(blk.segment)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    blocks = [s.nested[NESTED_PATH] for s in reader.segments]
    on_card = sum(reader._segment_bytes(b.child) + nbytes(b.parent)
                  + nbytes(b.offsets) for b in blocks)
    log(f"nested set-up: {nc} answers under {args.docs} questions "
        f"(negative binomial shape {NESTED_NB_SHAPE}, mean {NESTED_MEAN}: "
        f"{counts.mean():.4f} a question, {100 * (counts == 0).mean():.2f}% "
        f"with none, max {counts.max()}); answers.user Zipf "
        f"{NESTED_ZIPF} over {NESTED_USERS} users "
        f"({len(np.unique(user))} used), answers.date uniform 2008-2016, "
        f"answers.body {lens.mean():.3f} words a mean (1-"
        f"{NESTED_BODY_MAX}, U = {uterms.shape[1]}); child rows a segment "
        f"{[b.column.segment.num_docs for b in blocks]} padded to "
        f"{[b.child.padded_docs for b in blocks]}; built on the host in "
        f"{build_s:.1f} s, carried and uploaded in {up_s:.1f} s; the child "
        f"blocks {on_card} B on the card "
        f"({on_card / max(sum(b.child.padded_docs for b in blocks), 1):.1f} "
        f"B a padded child row: uterms and utf, doc_len, the user ordinal, "
        f"the date's hi/lo/exists, live, parent, and the offsets); "
        f"{reader_bytes(reader)}")
    n = len(lens)
    return {"counts": counts, "parent_of": parent_of, "user": user,
            "date": date, "uterms": uterms, "utf": utf, "lens": lens,
            "df": df, "users": users, "n": n,
            "term_index": {t: j for j, t in enumerate(data["term_names"])},
            "avgdl": float(lens.sum()) / n,
            "norm": 1.2 * (0.25 + 0.75 * lens.astype(np.float64)
                           / (float(lens.sum()) / n))}


def nested_request_rows(args, nd, n, salt):
    """The sampled child row behind each of n requests: a request asks for
    what this answer holds, so each matches at least one question."""
    rng = np.random.default_rng([args.seed, 53, salt])
    return rng.integers(0, nd["n"], n)


def nested_bodies(args, data, nd, kind, n):
    """n requests of one nested path, each with its own sampled user, date
    range or terms."""
    rows = nested_request_rows(args, nd, n, NESTED_KINDS.index(kind))
    out = []
    for i, r in enumerate(rows):
        if kind == "rally":
            # Rally's randomized nested query: an answer by this user within
            # a window of 30 to 120 days around one of their answers
            rng = np.random.default_rng([args.seed, 54, i])
            span = int(rng.integers(30, 121)) * NESTED_DAY_MS
            d0 = int(nd["date"][r]) - int(rng.integers(0, span))
            q = {"nested": {"path": NESTED_PATH, "score_mode": "none",
                            "query": {"bool": {"must": [
                                {"term": {f"{NESTED_PATH}.user":
                                          nd["users"][nd["user"][r]]}},
                                {"range": {f"{NESTED_PATH}.date": {
                                    "gte": d0, "lt": d0 + span}}}]}}}}
            size = 10
        elif kind in ("match_avg", "match_sum"):
            terms = nd["uterms"][r][nd["uterms"][r] >= 0][:2]
            q = {"nested": {"path": NESTED_PATH,
                            "score_mode": kind.split("_")[1],
                            "query": {"match": {
                                f"{NESTED_PATH}.body": " ".join(
                                    data["term_names"][t] for t in terms)}}}}
            size = 10
        else:
            # a two-year window, from the 365-day step of 2008-01-01 that
            # holds the sampled answer's date
            start = NESTED_DATES[0] + int(nd["date"][r] - NESTED_DATES[0]) \
                // (365 * NESTED_DAY_MS) * 365 * NESTED_DAY_MS
            q = {"bool": {"must": [{"match": {"body": data["texts"][i]}}],
                          "filter": [{"nested": {
                              "path": NESTED_PATH, "score_mode": "none",
                              "query": {"range": {f"{NESTED_PATH}.date": {
                                  "gte": start,
                                  "lt": start + 730 * NESTED_DAY_MS}}}}}]}}
            size = 100
        out.append({"query": q, "size": size})
    return out


def nested_score64(data, nd, f64, kind, body, i):
    """float64 recompute of one nested request from the host's rows →
    (score of every question, its match mask)."""
    nq = len(nd["counts"])
    if kind == "bool_filter":
        rng_ = body["query"]["bool"]["filter"][0]["nested"]["query"][
            "range"][f"{NESTED_PATH}.date"]
        ok = (nd["date"] >= rng_["gte"]) & (nd["date"] < rng_["lt"])
        has = np.bincount(nd["parent_of"][ok], minlength=nq) > 0
        s, cnt = f64.bm25(data["qtids"][i])
        m = (cnt > 0) & has
        return np.where(m, s, 0.0), m
    q = body["query"]["nested"]
    if kind == "rally":
        must = q["query"]["bool"]["must"]
        user = nd["users"].index(must[0]["term"][f"{NESTED_PATH}.user"])
        r = must[1]["range"][f"{NESTED_PATH}.date"]
        ok = (nd["user"] == user) & (nd["date"] >= r["gte"]) & \
            (nd["date"] < r["lt"])
        m = np.bincount(nd["parent_of"][ok], minlength=nq) > 0
        return m.astype(np.float64), m
    names = q["query"]["match"][f"{NESTED_PATH}.body"].split()
    index = nd["term_index"]
    child = np.zeros(nd["n"], np.float64)
    hit = np.zeros(nd["n"], bool)
    post = postings(nd["uterms"], nd["utf"],
                    np.asarray([index[t] for t in names]))
    for t in names:
        d, f = post[index[t]]
        child[d] += cpu_idf(nd["df"], index[t], nd["n"]) * f * 2.2 / \
            (f + nd["norm"][d])
        hit[d] = True
    par = nd["parent_of"][hit]
    ssum = np.bincount(par, weights=child[hit], minlength=nq)
    cnt = np.bincount(par, minlength=nq)
    m = cnt > 0
    s = ssum / np.maximum(cnt, 1) if q["score_mode"] == "avg" else ssum
    return np.where(m, s, 0.0), m


def plain_nested_kernels():
    """A context in which the wrappers of K1 and K19 run their plain
    versions also on CUDA tensors. Launches made there count nowhere."""
    import contextlib
    from elasticsearch_tpu_torch.ops import lexical, nested

    @contextlib.contextmanager
    def ctx():
        saved = (lexical.bm25_match_batch, nested.nested_reduce)
        lexical.bm25_match_batch = (
            lambda *a, trailing_pad=False, want_nmatch=True:
            lexical.bm25_match_batch_plain(*a, want_nmatch=want_nmatch))
        nested.nested_reduce = nested.nested_reduce_plain
        try:
            yield
        finally:
            lexical.bm25_match_batch, nested.nested_reduce = saved
    return ctx()


def k19_bytes(c_mask, child_live, offsets, mode) -> int:
    """K19's least bytes for this run's data: each real child's mask byte
    a query and its live byte once, the scores of the counted children
    (none for score_mode none), the offsets and boosts once, and the
    [B, N] scores and matched bytes written."""
    b = c_mask.shape[0]
    n = offsets.shape[0] - 1
    real = int(offsets[-1])
    counted = int((c_mask[:, :real] & child_live[None, :real]).sum()) \
        if mode != "none" else 0
    return b * real + real + 4 * counted + 4 * (n + 1) + 4 * b + 5 * b * n


def phase_nested_kernels(torch, args, data, nd) -> dict:
    """Phase 52: K19 in every score_mode against its plain version, bit for
    bit, on the inputs the nested match path gives it on segment 0 (B = 64,
    N = 2^20, its answers; captured from one batch of that path) and at odd
    shapes (N = 100,003 with parents without children and one with 1,000,
    a deleted parent's children dead, every child dead, NaN and ±0.0
    scores, B = 65); timed beside the plain version, scatter_reduce_ and
    the bound."""
    from elasticsearch_tpu_torch.ops import nested
    searcher, reader = data["searcher"], data["reader"]
    seg = reader.segments[0]
    blk = seg.nested[NESTED_PATH]
    b = args.batch
    captured = []
    wrapper = nested.nested_reduce

    def capture(*a):
        captured.append(a)
        return wrapper(*a)
    nested.nested_reduce = capture
    try:
        batch = batches_of(args, nested_bodies(args, data, nd, "match_avg",
                                               b))[0]
        check(searcher.query_phase_batch(batch) is not None,
              "nested: the captured batch was declined")
    finally:
        nested.nested_reduce = wrapper
    c_scores, c_mask, live, offsets, boost, _ = captured[0]
    check(c_scores.shape == (b, blk.child.padded_docs) and
          offsets.shape == (seg.padded_docs + 1,),
          f"nested: captured shapes {tuple(c_scores.shape)}, "
          f"{tuple(offsets.shape)}")
    dev = c_scores.device
    n = seg.padded_docs

    def same(got, want, what):
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]) and torch.equal(
            got[0].view(torch.int32), want[0].view(torch.int32)),
            f"K19 {what} is not bit-identical to its plain version")

    ok = c_mask & live[None, :]
    idx = blk.parent.long().clamp(min=0)[None, :].expand(b, -1).contiguous()
    lib_src = {"amax": torch.where(ok, c_scores, float("-inf")),
               "amin": torch.where(ok, c_scores, float("inf")),
               "sum": torch.where(ok, c_scores, 0.0)}
    lib_src["mean"] = lib_src["sum"]
    lib_out = torch.zeros((b, n), dtype=torch.float32, device=dev)
    modes = {}
    for mode, lib_reduce in (("none", None), ("max", "amax"),
                             ("min", "amin"), ("sum", "sum"),
                             ("avg", "mean")):
        args_m = (c_scores, c_mask, live, offsets, boost, mode)
        got = nested.nested_reduce(*args_m)
        want = nested.nested_reduce_plain(*args_m)
        same(got, want, f"{mode} (B={b}, N={n}, Nc={c_scores.shape[1]})")
        check(bool(got[1].any()), f"K19 {mode}: nothing matched")
        ms = timed(torch, f"K19 {mode}", lambda: nested.nested_reduce(
            *args_m), reps=20)
        plain = timed(torch, f"K19 {mode} plain",
                      lambda: nested.nested_reduce_plain(*args_m), reps=2)
        lib = None
        if lib_reduce is not None:
            src = lib_src[lib_reduce]
            lib = timed(torch, f"scatter_reduce_ {lib_reduce}",
                        lambda: lib_out.scatter_reduce_(
                            1, idx, src, lib_reduce, include_self=False),
                        reps=5)
        bms, by = bound(k19_bytes(c_mask, live, offsets, mode), 0)
        modes[mode] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bms, "bound_by": by,
                       "matched": int(got[1].sum())}
    del lib_src, lib_out, idx, ok
    # ---- odd shapes ---------------------------------------------------------
    rng = np.random.default_rng([args.seed, 55])
    n_odd, b_odd = 100_003, 65
    counts = rng.negative_binomial(NESTED_NB_SHAPE, NESTED_NB_SHAPE / (
        NESTED_NB_SHAPE + NESTED_MEAN), n_odd)
    counts[7] = 1000
    off_np = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nc = int(off_np[-1]) + 5
    scores = rng.uniform(-3, 5, (b_odd, nc)).astype(np.float32)
    scores[:, ::7] = 0.0
    scores[:, 3::11] = -0.0
    scores[:, 5::13] = np.nan
    live_np = rng.random(nc) < 0.95
    live_np[off_np[11]:off_np[12]] = False      # a deleted parent
    live_np[-5:] = False
    o_scores, o_mask, o_live, o_off, o_boost = (
        torch.from_numpy(a).to(dev) for a in (
            scores, rng.random((b_odd, nc)) < 0.7, live_np, off_np,
            rng.uniform(0.5, 3, b_odd).astype(np.float32)))
    dead = torch.zeros_like(o_live)
    for mode in ("none", "max", "min", "sum", "avg"):
        a = (o_scores, o_mask, o_live, o_off, o_boost, mode)
        got = nested.nested_reduce(*a)
        same(got, nested.nested_reduce_plain(*a),
             f"{mode} at the odd shape N={n_odd}, B={b_odd}")
        check(not bool(got[1][:, counts == 0].any()) and
              not bool(got[1][:, 11].any()) and bool(got[1][:, 7].all()),
              f"K19 {mode}: parents without live children matched")
        if mode in ("max", "min", "sum", "avg"):
            check(bool(torch.isnan(got[0]).any()),
                  f"K19 {mode}: no NaN came through")
        a = (o_scores, o_mask, dead, o_off, o_boost, mode)
        got = nested.nested_reduce(*a)
        same(got, nested.nested_reduce_plain(*a),
             f"{mode} with every child dead")
        check(not bool(got[1].any()), f"K19 {mode}: a dead child matched")
    log(f"K19 nested_reduce: bit-identical to plain in every score_mode at "
        f"the odd shape N={n_odd}, B={b_odd} (parents without children, "
        f"one with 1,000, a deleted parent, NaN and ±0.0 scores) and with "
        f"every child dead; at the path's shape: "
        + "; ".join(f"{m} {v['ms']:.4f} ms (plain {v['plain_ms']:.3f}, "
                    f"scatter_reduce_ {v['library_ms']}, bound "
                    f"{v['bound_ms']:.4f} ms by {v['bound_by']})"
                    for m, v in modes.items()))
    main = modes["avg"]
    return {"name": "nested_reduce", "route": "cuda", "source": K19_SOURCE,
            "replaces": K19_REPLACES, "launches": 0, "max_abs_err": 0.0,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_call": "torch.Tensor.scatter_reduce_(1, parent, src, "
                            "'mean', include_self=False)",
            "modes": modes,
            "shape": {"B": b, "N": n, "Nc": int(c_scores.shape[1]),
                      "children": int(offsets[-1])}}


def check_nested_batch(label, args, data, nd, f64, kind, reqs, res_b,
                       bodies, first):
    """The first and the last request of a nested batch: against the plain
    versions on the card's tensors (total exact, the hits' scores bit for
    bit), then against the float64 recompute from the host's rows (the
    same questions matched, scores within 1e-5, tie-tolerant recall@k
    1.0)."""
    from elasticsearch_tpu_torch.search import segment_exec
    searcher = data["searcher"]
    orig_of = gid_to_orig(searcher.reader)
    totals = []
    for j in checked_requests(len(reqs)):
        req, res = reqs[j], res_b[j]
        scores, masks = [], []
        with plain_nested_kernels():
            for seg in searcher.reader.segments:
                s, m = segment_exec.execute(seg, searcher.ctx, req.query)
                nr = seg.seg.num_docs
                scores.append(s[:nr].cpu().numpy())
                masks.append(m[:nr].cpu().numpy())
        p_s, p_m = np.concatenate(scores), np.concatenate(masks)
        orig = orig_of[np.asarray(res.doc_ids, np.int64)]
        check(res.total == int(p_m.sum()),
              f"{label} request {j}: total {res.total} != the plain "
              f"versions' {int(p_m.sum())}")
        check(np.array_equal(np.asarray(res.scores, np.float32), p_s[orig]),
              f"{label} request {j}: the hits' scores differ from the plain "
              f"versions'")
        s64, m64 = nested_score64(data, nd, f64, kind, bodies[first + j],
                                  first + j)
        check(np.array_equal(m64, p_m), f"{label} request {j}: the float64 "
              f"recompute matches other questions than the plain versions")
        check_vs_cpu(label, args, [res], [s64], [m64], orig_of, k=req.size)
        totals.append(res.total)
    return totals


def phase_nested_paths(torch, args, data, nd, f64, name, smi_line) -> dict:
    """Phase 53 (queries): NESTED_BATCHES batches of 64 of each nested path
    through query_phase_batch — Rally's randomized nested query (a term
    and a date range in one answer, score_mode none), a nested match on
    answers.body in avg and in sum, and config 1's match with a nested
    date-range filter — each checked by check_nested_batch; one batch of
    each under torch.profiler."""
    out = {}
    totals = {}
    for kind in NESTED_KINDS:
        bodies = nested_bodies(args, data, nd, kind,
                               NESTED_BATCHES * args.batch)
        batches = batches_of(args, bodies)
        results, per_batch, wall, launches, peak = drive(
            torch, data["searcher"], batches)
        needed = ("nested_reduce", "stable_topk") + (
            ("bm25_scan",) if kind != "rally" else ())
        out[kind] = report(f"nested {kind}", args, data, batches, per_batch,
                           wall, launches, peak, name, smi_line, needed)
        totals[kind] = []
        for bi, (reqs, res_b) in enumerate(zip(batches, results)):
            totals[kind] += check_nested_batch(
                f"nested {kind}", args, data, nd, f64, kind, reqs, res_b,
                bodies, bi * args.batch)
        prof = phase_profile(torch, args, data, f"nested {kind}", bodies)
        out[kind]["busy_share"] = None if not prof.get("busy_ms") else \
            prof["busy_ms"] / prof["wall_ms"]
    log(f"nested paths: the first and the last request of each batch equal "
        f"to the plain versions on the card (totals, scores bit for bit) "
        f"and to the float64 recompute (the same questions, scores within "
        f"1e-5, tie-tolerant recall 1.0); totals {totals}; p50 a batch of "
        f"{args.batch}: "
        + ", ".join(f"{k} {v['p50_ms']:.3f} ms (busy "
                    + (f"{100 * v['busy_share']:.1f}%)" if v["busy_share"]
                       is not None else "not measured)")
                    for k, v in out.items()))
    return out


def phase_nested_aggs(torch, args, data, nd, name, smi_line) -> dict:
    """Phase 53 (aggregations): NESTED_AGG_REQUESTS requests of config 1's
    match with nested → date_histogram (answers.date, yearly) →
    reverse_nested → terms (answers.user), and nested → reverse_nested →
    stats (rank), through query_phase and controller.merge_responses;
    against numpy over the card's match mask. A reverse_nested below a
    bucket under nested is the identity over the answers (the JAX
    package's semantics, which the port keeps): only one directly under
    nested maps the answers back to their questions."""
    from elasticsearch_tpu_torch.search import controller, segment_exec
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    searcher = data["searcher"]
    aggs = {"answers": {"nested": {"path": NESTED_PATH}, "aggs": {
        "per_year": {"date_histogram": {"field": f"{NESTED_PATH}.date",
                                        "interval": "year"}, "aggs": {
            "back": {"reverse_nested": {}, "aggs": {"users": {"terms": {
                "field": f"{NESTED_PATH}.user", "size": 5}}}}}},
        "questions": {"reverse_nested": {}, "aggs": {
            "rank": {"stats": {"field": "rank"}}}}}}}
    ms_q, ms_m = [], []
    counters = reset_launches()
    for i in range(NESTED_AGG_REQUESTS):
        req = parse_search_request({"query": {"match": {
            "body": data["texts"][i]}}, "size": 10, "aggs": aggs})
        t0 = time.perf_counter()
        res = searcher.query_phase(req)
        ms_q.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        merged = controller.merge_responses("nested", req, [res],
                                            [searcher], 0.0, req.aggs)
        ms_m.append((time.perf_counter() - t0) * 1e3)
        mask = np.concatenate([
            segment_exec.match_mask(s, searcher.ctx, req.query).cpu()
            .numpy()[:s.seg.num_docs] for s in searcher.reader.segments])
        check(int(mask.sum()) == res.total, "nested aggs: the mask's count")
        child = mask[nd["parent_of"]]
        got = merged["aggregations"]["answers"]
        check(got["doc_count"] == int(child.sum()),
              f"nested aggs: doc_count {got['doc_count']} != numpy "
              f"{int(child.sum())}")
        years = (nd["date"][child].astype("datetime64[ms]")
                 .astype("datetime64[Y]").astype(int) + 1970)
        ys, yc = np.unique(years, return_counts=True)
        buckets = got["per_year"]["buckets"]
        check([b["doc_count"] for b in buckets] == yc.tolist() and
              [int(np.datetime64(int(b["key"]), "ms").astype(
                  "datetime64[Y]").astype(int)) + 1970 for b in buckets] ==
              ys.tolist(), "nested aggs: the yearly buckets")
        for bkt, y in zip(buckets, ys):
            sel = nd["user"][child][years == y]
            cnt = np.bincount(sel, minlength=NESTED_USERS)
            back = bkt["back"]
            check(back["doc_count"] == len(sel),
                  f"nested aggs: reverse_nested in {y}")
            tops = back["users"]["buckets"]
            got_c = [t["doc_count"] for t in tops]
            want_c = sorted(cnt.tolist(), reverse=True)[:len(tops)]
            check(got_c == want_c and all(
                cnt[nd["users"].index(t["key"])] == t["doc_count"]
                for t in tops), f"nested aggs: the top users of {y}")
        has = np.bincount(nd["parent_of"][child],
                          minlength=len(mask)) > 0
        q = got["questions"]
        rank = data["rank"][has]
        check(q["doc_count"] == int(has.sum()) and
              q["rank"]["count"] == int(has.sum()) and
              q["rank"]["min"] == rank.min() and
              q["rank"]["max"] == rank.max() and
              np.isclose(q["rank"]["sum"], rank.sum(), rtol=1e-9),
              "nested aggs: reverse_nested's questions and their rank")
    launches = read_launches(counters)
    check(launches["bm25_scan"] > 0, f"nested aggs: launches {launches}")
    log(f"nested aggs: {NESTED_AGG_REQUESTS} requests (config 1's match, "
        f"nested > date_histogram yearly > reverse_nested > terms, nested > "
        f"reverse_nested > stats) equal to numpy over the card's match mask; "
        f"query_phase {', '.join(f'{x:.1f}' for x in ms_q)} ms (the nested "
        f"collectors are numpy on the host, as in the JAX package), merge "
        f"{', '.join(f'{x:.1f}' for x in ms_m)} ms; launches "
        f"{dict((k, v) for k, v in launches.items() if v)} — on {name} "
        f"({smi_line})")
    return {"launches": launches, "query_ms": ms_q, "merge_ms": ms_m,
            "p50_ms": statistics.median(ms_q)}


def nested_perc_registry(seed):
    """NESTED_REGS registrations on answers: half a nested term on
    answers.user (score_mode none), half a nested match of one word on
    answers.body (score_mode max); NESTED_PROBES probe questions with 1-6
    answers each."""
    rng = np.random.default_rng([seed, 56])
    regs = {}
    for i in range(NESTED_REGS):
        if i % 2:
            q = {"term": {f"{NESTED_PATH}.user": str(rng.choice(
                NESTED_PERC_USERS))}}
            mode = "none"
        else:
            q = {"match": {f"{NESTED_PATH}.body": str(rng.choice(
                NESTED_PERC_WORDS))}}
            mode = "max"
        regs[f"n{i}"] = {"query": {"nested": {
            "path": NESTED_PATH, "score_mode": mode, "query": q}}}
    probes = []
    for _ in range(NESTED_PROBES):
        probes.append({"title": "q", NESTED_PATH: [
            {"user": str(rng.choice(NESTED_PERC_USERS)),
             "body": " ".join(rng.choice(NESTED_PERC_WORDS,
                                         int(rng.integers(3, 12))))}
            for _ in range(int(rng.integers(1, 7)))]})
    return regs, probes


def nested_perc_oracle(regs, doc, k1=1.2, b=0.75) -> dict:
    """float64 recompute of every registration against one probe: over the
    probe's answers (the one-doc segment's child rows) a user term scores
    1.0; a word's BM25 in each answer that holds it (N = the answers, df
    = those holding it, avgdl = their mean length), the max over them. →
    {qid: score} of the matches."""
    answers = doc[NESTED_PATH]
    toks = [a["body"].split() for a in answers]
    n = len(answers)
    avgdl = sum(len(t) for t in toks) / n
    out = {}
    for qid, reg in regs.items():
        q = reg["query"]["nested"]["query"]
        if "term" in q:
            if any(a["user"] == q["term"][f"{NESTED_PATH}.user"]
                   for a in answers):
                out[qid] = 1.0
            continue
        w = q["match"][f"{NESTED_PATH}.body"]
        df = sum(w in t for t in toks)
        if not df:
            continue
        idf = np.log1p((n - df + 0.5) / (df + 0.5))
        out[qid] = max(idf * t.count(w) * (k1 + 1.0) / (
            t.count(w) + k1 * (1 - b + b * len(t) / avgdl))
            for t in toks if w in t)
    return out


def phase_nested_percolate(torch, args, data, name, smi_line) -> dict:
    """Phase 53 (percolate): NESTED_REGS nested registrations, a percolate
    per probe and one percolate_many of the NESTED_PROBES probes; every
    registration's flag and score against the float64 recompute, probe 0
    against percolate_serial, each item of percolate_many equal to its own
    percolate call."""
    from elasticsearch_tpu_torch.search import percolator
    dev = data["reader"].device
    regs, probes = nested_perc_registry(args.seed)
    meta = perc_meta("smoke_nested_perc", {"_doc": {"properties": {
        "title": {"type": "keyword"}, **nested_mapping()["properties"]}}},
        regs)
    t0 = time.perf_counter()
    reg = percolator.registry_for(meta, dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: 0 for k in path_kernels()}
    recs, outs = [], []
    for pi, d in enumerate(probes):
        out, rec = perc_call(torch, lambda d=d: percolator.percolate(
            meta, d, score=True, device=dev))
        for k_, v in rec["launches"].items():
            launches[k_] += v
        recs.append(rec)
        outs.append(out)
        want = nested_perc_oracle(regs, d)
        got = {m["_id"]: m["_score"] for m in out["matches"]}
        check(set(got) == set(want), f"nested percolate probe {pi}: "
              f"{len(set(got) ^ set(want))} registrations differ from the "
              f"float64 recompute")
        check(all(abs(got[q] - want[q]) <= 1e-5 * max(1.0, abs(want[q]))
                  for q in got), f"nested percolate probe {pi}: a score "
              f"differs from the float64 recompute")
    t0 = time.perf_counter()
    ser = percolator.percolate_serial(meta, probes[0], score=True,
                                      device=dev)
    serial_ms = (time.perf_counter() - t0) * 1e3
    check([m["_id"] for m in ser["matches"]] ==
          [m["_id"] for m in outs[0]["matches"]],
          "nested percolate: probe 0 differs from percolate_serial")
    many, mrec = perc_call(torch, lambda: percolator.percolate_many(
        meta, [{"doc": d, "score": True} for d in probes], device=dev))
    for k_, v in mrec["launches"].items():
        launches[k_] += v
    check(many == outs, "nested percolate_many: an item differs from its "
          "own percolate call")
    for k_ in ("nested_reduce", "percolate_reduce"):
        check(launches[k_] > 0, f"nested percolate: {k_} was not launched")
    p50 = statistics.median(r["wall_ms"] for r in recs)
    log(f"nested percolate: {NESTED_REGS} registrations (registry built in "
        f"{build_ms:.1f} ms, {reg.stats_dict()['shape_buckets']} shape "
        f"buckets), {len(probes)} probes: p50 {p50:.3f} ms a call; matches a "
        f"probe {[o['total'] for o in outs]}, every flag and score equal to "
        f"the float64 recompute (scores within 1e-5); probe 0 equal to "
        f"percolate_serial ({serial_ms:.1f} ms); percolate_many "
        f"{perc_line(mrec)}, each item equal to its percolate call — on "
        f"{name} ({smi_line})")
    return {"launches": launches, "p50_ms": p50, "many_ms": mrec["wall_ms"],
            "serial_ms": serial_ms}


# --------------------------------------------------------------------------
# the collective plane (phases 54-56)
# --------------------------------------------------------------------------

K20_SOURCE = "elasticsearch_tpu_torch/csrc/sort_select.cu"
K20_REPLACES = "elasticsearch_tpu/parallel/mesh_engine.py:823"
K8_ROWS_REPLACES = "elasticsearch_tpu/parallel/mesh_engine.py:1569"
K9_ROWS_REPLACES = "elasticsearch_tpu/parallel/mesh_engine.py:1523"
# timed batches of the plane's score-order (a), field-sort (c) and aggs (g)
# requests; the requests of each shape held against float64 (the first of
# config 5's checked requests)
PLANE_BATCHES, PLANE_CHECK = 4, 4
PLANE_AGGS = {"by_cat": {"terms": {"field": "cat", "size": 8}},
              "st": {"stats": {"field": "rank"}},
              "hi": {"histogram": {"field": "rank", "interval": 5}}}
PLANE_SORT_C = [{"rank": "desc"}]
PLANE_SORT_D = [{"cat": "asc"}, {"rank": "desc"}]
PLANE_SIZE = 100


def plane_bodies(data, lo, n, **body):
    return [{"query": {"match": {"body": t}}, **body}
            for t in data["texts"][lo:lo + n]]


def phase_plane_setup(torch, c5) -> dict:
    """The collective plane over config 5's 8 engines (phase 21's) on a
    mesh of the one card: a NCCL group of one rank, spd = 8."""
    from elasticsearch_tpu_torch.parallel import make_mesh
    from elasticsearch_tpu_torch.parallel import mesh_engine as me
    t0 = time.perf_counter()
    mesh = make_mesh()
    plane = me.MeshEngineSearcher(mesh, [sh["engine"] for sh in c5["shards"]],
                                  c5["ms"])
    torch.cuda.synchronize()
    log(f"collective plane: make_mesh() {mesh.shape}, {mesh.backend} group "
        f"of {mesh.group.size()} rank, spd {plane.spd}, {plane.n_slots} "
        f"slot of {plane.shard_stride} rows a shard; blocks uploaded "
        f"{plane.data_layer['bytes_uploaded']} B ({plane.device_bytes()} B "
        f"on the card beside the fan-out's readers) in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated()} B allocated on the card")
    return {"mesh": mesh, "plane": plane}


def record_sort_select(run) -> list:
    """Run ``run`` with K20's wrapper recording a copy of every call's
    inputs → [(keys, k, mask, cursor, neg, rows)]."""
    from elasticsearch_tpu_torch.ops import topk
    calls = []
    orig = topk.sort_select

    def recorded(keys, k, mask=None, cursor=None, neg=(), rows=None):
        calls.append(([x.clone() for x in keys], k,
                      None if mask is None else mask.clone(),
                      None if cursor is None else cursor.clone(),
                      tuple(neg), rows))
        return orig(keys, k, mask=mask, cursor=cursor, neg=neg, rows=rows)
    topk.sort_select = recorded
    try:
        run()
    finally:
        topk.sort_select = orig
    return calls


def k20_bytes(keys, mask, cursor, rows, kk) -> int:
    """Bytes K20 must move: the mask and every key row read once (a column
    once for every row), the cursor, kk positions a row written."""
    return (0 if mask is None else nbytes(mask)) + sum(
        nbytes(x) for x in keys) + (0 if cursor is None else
                                     nbytes(cursor)) + rows * kk * 4


def check_k20(torch, topk, keys, k, mask, cursor, neg, rows, what) -> None:
    got = topk.sort_select(keys, k, mask=mask, cursor=cursor, neg=neg,
                           rows=rows)
    want = topk.sort_select_plain(keys, k, mask=mask, cursor=cursor, neg=neg,
                                  rows=rows)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K20 positions differ from the plain "
          f"version ({what})")


def time_k20(torch, topk, label, keys, k, mask, cursor, neg, rows) -> dict:
    b = rows if rows is not None else mask.shape[0]
    m = mask.shape[1]
    out = {"shape": {"B": b, "M": m, "key_rows": 1 + len(keys), "k": k},
           "ms": timed(torch, f"K20 {label}", lambda: topk.sort_select(
               keys, k, mask=mask, cursor=cursor, neg=neg, rows=rows),
               reps=10),
           "plain_ms": timed(torch, f"K20 {label} plain",
                             lambda: topk.sort_select_plain(
                                 keys, k, mask=mask, cursor=cursor, neg=neg,
                                 rows=rows), reps=3),
           "library_ms": None}
    out["bound_ms"], out["bound_by"] = bound(
        k20_bytes(keys, mask, cursor, b, min(k, m)), 0)
    return out


def k20_odd(torch, topk, dev, seed) -> None:
    """K20 against its plain version at odd shapes: M = 100,003, columns
    holding ±0.0, NaN and ±inf, an all-tie column, per-(row, entry) keys,
    k above M, an empty mask row and a cursor."""
    rng = np.random.default_rng(seed)
    b, m = 16, 100_003
    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 2.5], np.float32)

    def col(shape):
        v = rng.integers(0, 50, shape).astype(np.float32)
        pick = rng.random(shape) < 0.25
        return torch.from_numpy(np.where(
            pick, rng.choice(special, shape), v).astype(np.float32)).to(dev)
    keys = [col((m,)), torch.full((m,), 7.0, device=dev), col((b, m)),
            col((b, m))]
    mask = torch.from_numpy(rng.random((b, m)) < 0.6).to(dev)
    mask[3] = False
    cursor = torch.stack([torch.stack([
        (-x[bi, 777] if i == 2 else (x[bi, 777] if x.dim() == 2
                                     else x[777]))
        for i, x in enumerate(keys)]) for bi in range(b)]).contiguous()
    for k in (1, 1024, 70_000, 200_000):
        check_k20(torch, topk, keys, k, mask, None, (2,), None,
                  f"M = {m}, k = {k}")
        check_k20(torch, topk, keys, k, mask, cursor, (2,), None,
                  f"M = {m}, k = {k}, a cursor")
    check_k20(torch, topk, keys[:2], 50, torch.zeros_like(mask), None, (),
              None, "an empty mask")
    check_k20(torch, topk, [keys[1]], 64, None, None, (), 5,
              "an all-tie column, no mask")


def agg_rows_inputs(torch, plane, bodies) -> dict:
    """Shard 0's columns and the batch's [B, N] agg mask, as the plane's
    terms, histogram and metric lanes get them."""
    from elasticsearch_tpu_torch.parallel import mesh_engine as me
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    from elasticsearch_tpu_torch.search.segment_exec import _build
    reqs = [parse_search_request(b) for b in bodies]
    plans = plane._plan_slots(reqs, dict(me._FLAGS), False, None)
    tpl, consts, emit_q, emit_pf, refs = plans[(0, 0)]
    outs = _build(tpl, consts, emit_q, emit_pf, refs, 16, len(reqs),
                  want_arrays=True)
    lo_v, _ = plane._field_extrema["rank"]
    first = np.floor(lo_v / 5.0)
    bhi, blo = dd_split_f64(first * 5.0)
    hi_v = plane._field_extrema["rank"][1]
    nb = int(np.floor(hi_v / 5.0) - first + 1)
    col = tpl.numeric["rank"]
    return {"ords": tpl.keyword["cat"].ords, "mask": outs["agg_mask"],
            "hi": col.hi, "lo": col.lo, "exists": col.exists,
            "hist": (bhi, blo, 5.0, nb),
            "vocab": plane._layouts[0].kw_vocab["cat"]}


def dd_split_f64(v):
    from elasticsearch_tpu_torch.index.device_reader import dd_split
    hi, lo = dd_split(np.float64(v))
    return float(hi), float(lo)


def phase_plane_kernels(torch, args, data, c5, pl) -> list[dict]:
    """K20 against its plain version at the plane's shapes (the inputs the
    plane gives it on a batch of (c) and (d) at size 1,000: B = 64 x M =
    2^18 with 3 and 5 key rows, per-doc columns; the local merge B = 64 x
    8 x 1,024 of per-(row, entry) keys) at k = 1,024 and 32,768, and at odd
    shapes; the row-batched K8 (ordinal, histogram) and K9 against 64
    one-row launches and their plain versions on shard 0's agg mask of a
    batch of (g). Each timed beside its plain version and its bound."""
    from elasticsearch_tpu_torch.ops import aggs_ops, topk
    plane = pl["plane"]
    dev = plane.device
    b = args.batch
    out = {}
    for label, sort in (("3 key rows", PLANE_SORT_C),
                        ("5 key rows", PLANE_SORT_D)):
        calls = record_sort_select(lambda sort=sort: plane.search_batch(
            plane_bodies(data, 0, b, size=1000, sort=sort),
            global_stats=False))
        # one call a shard, the local merge of the 8 shards' 1,024
        # candidates, the merge of the group's gather
        shard_calls, merges = calls[:C5_SHARDS], calls[C5_SHARDS:-1]
        check(len(calls) == C5_SHARDS + 2 and all(
            c[2].shape[1] == plane.shard_stride for c in shard_calls) and
            merges[0][2].shape[1] == C5_SHARDS * 1024,
            f"K20 calls on the plane's path: "
            f"{[tuple(c[2].shape) for c in calls if c[2] is not None]}")
        keys, _, mask, cursor, neg, rows = shard_calls[0]
        check(all(x.dim() == 1 for x in keys),
              "K20's field keys on the path are not per-doc columns")
        for k in (1024, 32_768):
            check_k20(torch, topk, keys, k, mask, cursor, neg, rows,
                      f"shard 0, {label}, k = {k}")
            out[(label, k)] = time_k20(torch, topk, f"[{b}, "
                                       f"{mask.shape[1]}] {label} k = {k}",
                                       keys, k, mask, cursor, neg, rows)
        mkeys, mk, mmask, mcur, mneg, mrows = merges[0]
        check_k20(torch, topk, mkeys, mk, mmask, mcur, mneg, mrows,
                  f"the local merge, {label}")
        out[("merge", label)] = time_k20(
            torch, topk, f"merge [{b}, {mmask.shape[1]}] {label}", mkeys, mk,
            mmask, mcur, mneg, mrows)
    k20_odd(torch, topk, dev, args.seed + 20)
    main = out[("5 key rows", 1024)]
    null_why = ("no single torch call selects by several keys with ties by "
                "position (torch.sort and torch.topk take one key)")
    k20 = {"name": "sort_select", "route": "cuda", "source": K20_SOURCE,
           "replaces": K20_REPLACES, "launches": 0, "max_abs_err": 0.0,
           **main, "library_null": null_why,
           "shapes": {f"{a} k={k_}" if isinstance(k_, int) else f"{a} {k_}":
                      v for (a, k_), v in out.items()}}
    for (a, k_), v in out.items():
        log(f"K20 sort_select {v['shape']}: bit-identical to plain; "
            f"kernel_ms={v['ms']:.4f} plain_ms={v['plain_ms']:.4f} bound_ms="
            f"{v['bound_ms']:.6f} ({v['bound_by']}) library_ms=null ("
            f"{null_why})")
    # ---- the row-batched K8 and K9 ------------------------------------------
    inp = agg_rows_inputs(torch, plane, plane_bodies(data, 0, b, size=10,
                                                     aggs=PLANE_AGGS))
    ords, mask, hi, lo, exists = (inp[x] for x in ("ords", "mask", "hi",
                                                   "lo", "exists"))
    vocab, h_args = inp["vocab"], inp["hist"]
    rows, n = mask.shape
    got = aggs_ops.ord_counts_rows(ords, mask, vocab)
    got_h = aggs_ops.dd_histogram_counts_rows(hi, lo, exists, mask, *h_args)
    got_s = aggs_ops.dd_stats_rows(hi, lo, exists, mask)
    per_row = [(aggs_ops.ord_counts(ords, mask[r], vocab),
                aggs_ops.dd_histogram_counts(hi, lo, exists, mask[r],
                                             *h_args),
                aggs_ops.dd_stats(hi, lo, exists, mask[r]))
               for r in range(rows)]
    want_s = aggs_ops.dd_stats_rows_plain(hi, lo, exists, mask)
    one_row_plain = [aggs_ops.dd_stats_plain(hi, lo, exists, mask[r])
                     for r in range(rows)]
    torch.cuda.synchronize()
    for r, (o, h, s_) in enumerate(per_row):
        check(torch.equal(got[r], o) and torch.equal(got_h[r], h) and
              torch.equal(got_s[r], s_), f"row-batched K8 / K9 row {r} "
              f"differs from its one-row launch")
    check(torch.equal(got, aggs_ops.ord_counts_rows_plain(ords, mask,
                                                          vocab)),
          "row-batched K8 ordinal differs from its plain version")
    check(torch.equal(got_h, aggs_ops.histogram_counts_dd_rows_plain(
        hi, lo, exists, mask, *h_args)),
        "row-batched K8 histogram differs from its plain version")
    check(torch.equal(got_s, want_s), "row-batched K9 differs from its "
          "plain version (its sums added in the kernel's order)")
    # beside K9's one-row plain version (torch's own sum order): count and
    # extrema equal, the f32 sums within 1e-6 of their magnitudes
    one_row = torch.stack(one_row_plain)
    m64 = (mask & exists[None, :]).double()
    mags = torch.stack([m64 @ hi.double().abs(), m64 @ lo.double().abs(),
                        m64 @ (hi.double() ** 2)], dim=1)
    k9_err = float((got_s[:, 5:] - one_row[:, 5:]).abs().max())
    check(torch.equal(got_s[:, :5], one_row[:, :5]) and bool(
        ((got_s[:, 5:] - one_row[:, 5:]).abs() <= 1e-6 * mags).all()),
        "row-batched K9 beyond 1e-6 of the one-row plain version's sums")
    n_mask = int(mask.sum())
    flat = (torch.arange(rows, device=dev)[:, None] * vocab +
            ords[:, 0][None, :].long())[mask & (ords[:, 0] >= 0)[None, :]]

    def loop(fn):
        return lambda: [fn(r) for r in range(rows)]
    k8r = {
        "ms": timed(torch, "K8 rows ordinal", lambda: aggs_ops.ord_counts_rows(
            ords, mask, vocab), reps=20),
        "per_row_ms": timed(torch, f"K8 ordinal, {rows} one-row launches", loop(
            lambda r: aggs_ops.ord_counts(ords, mask[r], vocab)), reps=5),
        "plain_ms": timed(torch, "K8 rows ordinal plain",
                          lambda: aggs_ops.ord_counts_rows_plain(
                              ords, mask, vocab), reps=5),
        "library_ms": timed(torch, "K8 rows ordinal torch.bincount (flat "
                            "ords masked beforehand)", lambda: torch.bincount(
                                flat, minlength=rows * vocab), reps=20)}
    k8r["bound_ms"], k8r["bound_by"] = bound(
        nbytes(mask) + nbytes(ords) + rows * vocab * 4, n_mask)
    hist = {
        "ms": timed(torch, "K8 rows histogram",
                    lambda: aggs_ops.dd_histogram_counts_rows(
                        hi, lo, exists, mask, *h_args), reps=20),
        "per_row_ms": timed(torch, f"K8 histogram, {rows} one-row launches",
                            loop(
            lambda r: aggs_ops.dd_histogram_counts(hi, lo, exists, mask[r],
                                                   *h_args)), reps=5),
        "plain_ms": timed(torch, "K8 rows histogram plain",
                          lambda: aggs_ops.histogram_counts_dd_rows_plain(
                              hi, lo, exists, mask, *h_args), reps=5),
        "library_ms": None, "library_null": "no single torch call: "
        "torch.histc buckets f32 values, not the double-double index"}
    hist["bound_ms"], hist["bound_by"] = bound(
        nbytes(mask) + nbytes(hi) + nbytes(lo) + nbytes(exists) +
        rows * h_args[3] * 4, 4 * n_mask)
    k9r = {
        "ms": timed(torch, "K9 rows", lambda: aggs_ops.dd_stats_rows(
            hi, lo, exists, mask), reps=20),
        "per_row_ms": timed(torch, f"K9, {rows} one-row launches", loop(
            lambda r: aggs_ops.dd_stats(hi, lo, exists, mask[r])), reps=5),
        "plain_ms": timed(torch, "K9 rows plain",
                          lambda: aggs_ops.dd_stats_rows_plain(
                              hi, lo, exists, mask), reps=3)}
    k9r["bound_ms"], k9r["bound_by"] = bound(
        nbytes(mask) + nbytes(hi) + nbytes(lo) + nbytes(exists) + rows * 64,
        6 * n_mask)
    log(f"row-batched K8 agg_counts [{rows}, {n}] ({n_mask} mask bits): each "
        f"row equal to its one-row launch and to plain; ordinal over "
        f"{vocab} cat ords: kernel_ms={k8r['ms']:.4f} ({rows} one-row launches "
        f"{k8r['per_row_ms']:.4f}) plain_ms={k8r['plain_ms']:.4f} "
        f"library_ms={k8r['library_ms']:.4f} (torch.bincount on flat ords "
        f"masked beforehand) bound_ms={k8r['bound_ms']:.6f}; histogram "
        f"rank / 5, {h_args[3]} buckets: kernel_ms={hist['ms']:.4f} ({rows} "
        f"one-row launches {hist['per_row_ms']:.4f}) plain_ms="
        f"{hist['plain_ms']:.4f} bound_ms={hist['bound_ms']:.6f}")
    log(f"row-batched K9 agg_stats [{rows}, {n}]: each row the bits of its "
        f"one-row launch and of its plain version (sums added in the "
        f"kernel's order); the one-row plain version's sums (torch's order) "
        f"within {k9_err:.3e} (1e-6 of their magnitudes); kernel_ms="
        f"{k9r['ms']:.4f} ({rows} one-row launches {k9r['per_row_ms']:.4f}) "
        f"plain_ms={k9r['plain_ms']:.4f} bound_ms={k9r['bound_ms']:.6f} "
        f"library_ms=null")
    k8_rows = {"name": "agg_counts_rows", "route": "cuda",
               "source": K8_SOURCE, "replaces": K8_ROWS_REPLACES,
               "launches": 0, "max_abs_err": 0.0, **k8r,
               "shape": {"B": rows, "N": n, "ords": vocab},
               "modes": {"ordinal": k8r, "histogram": hist}}
    k9_rows = {"name": "agg_stats_rows", "route": "cuda",
               "source": K9_SOURCE, "replaces": K9_ROWS_REPLACES,
               "launches": 0, "max_abs_err": 0.0, **k9r,
               "library_ms": None, "library_null": "no single torch call "
               "gives the count, the double-double extrema and the sums",
               "shape": {"B": rows, "N": n}}
    return [k20, k8_rows, k9_rows]


def plane_rows(c5, qi):
    """Request ``qi``'s matched corpus rows (float64 scoring's matches),
    shard-major, and their per-shard float64 scores."""
    rows, s64 = [], []
    for sh, (s, m) in zip(c5["shards"], c5["cpu"][qi]):
        idx = np.nonzero(m)[0]
        rows.append(sh["lo"] + idx)
        s64.append(s[idx])
    return np.concatenate(rows), np.concatenate(s64)


def rank_dd(c5, rows):
    return c5["rank_hi"][rows].astype(np.float64) + c5["rank_lo"][rows]


def check_plane_sorted(label, c5, plane, res, qi, order_key, frm, size,
                       values) -> None:
    """A field-sorted page against numpy: the matched rows ordered by
    ``order_key(rows)`` (a lexsort key list, most significant last), ties by
    corpus row — (shard, position) — then [frm, frm + size); ids and sort
    values exact, the total the match count."""
    rows, _ = plane_rows(c5, qi)
    check(res["total"] == len(rows), f"{label} request {qi}: total "
          f"{res['total']} != float64 matches {len(rows)}")
    page = rows[np.lexsort([rows] + order_key(rows))][frm:frm + size]
    got = [int(plane.doc_id(int(d))) for d in res["doc_ids"][frm:frm + size]]
    check(got == page.tolist(), f"{label} request {qi}: ids differ from the "
          f"numpy order")
    want_v = [values(r) for r in page]
    check(res["sort_values"][frm:frm + size] == want_v,
          f"{label} request {qi}: sort values differ from numpy")


def check_plane_scored(label, c5, plane, res, qi, frm, size, s64_rows=None,
                       keep=None, tol=1e-5) -> float:
    """A score-ordered page against float64: the matched rows (those
    ``keep`` admits) ranked by (score desc, corpus row); the total exact
    (``keep`` may return a (lo, hi) band for boundary rows), every hit's
    score within ``tol``, tie-tolerant recall 1.0 → recall."""
    rows, s64 = plane_rows(c5, qi) if s64_rows is None else s64_rows
    total_lo = total_hi = len(rows)
    if keep is not None:
        sure, maybe = keep(rows, s64)
        total_lo, total_hi = int(sure.sum()), int((sure | maybe).sum())
        rows, s64 = rows[sure | maybe], s64[sure | maybe]
    check(total_lo <= res["total"] <= total_hi, f"{label} request {qi}: "
          f"total {res['total']} outside [{total_lo}, {total_hi}]")
    order = np.lexsort((rows, -s64))
    want = s64[order][frm:frm + size]
    page_rows = set(rows[order][frm:frm + size].tolist())
    got_rows = [int(plane.doc_id(int(d))) for d in res["doc_ids"][frm:frm +
                                                                 size]]
    got_s = np.asarray(res["scores"][frm:frm + size], np.float64)
    check(len(got_rows) == len(want), f"{label} request {qi}: "
          f"{len(got_rows)} hits, float64 {len(want)}")
    if not got_rows:
        return 1.0
    score_of = dict(zip(rows.tolist(), s64.tolist()))
    check(all(abs(score_of[r] - s) <= tol + tol * abs(s)
              for r, s in zip(got_rows, got_s)),
          f"{label} request {qi}: a hit's score is not its float64 score")
    check(np.allclose(got_s, want, rtol=tol, atol=tol),
          f"{label} request {qi}: page scores disagree with float64")
    ok = sum(r in page_rows or abs(score_of[r] - want.min()) <= tol or
             abs(score_of[r] - want.max()) <= tol for r in got_rows)
    recall = ok / len(got_rows)
    check(recall == 1.0, f"{label} request {qi}: tie-tolerant recall "
          f"{recall}")
    return recall


def check_plane_aggs(label, c5, res, qi, fanout) -> None:
    """(g)'s aggregations against numpy over the matched rows (terms and
    histogram buckets, count, min, max exact; sum and avg within 1e-5) and
    against phase 24's merged aggregations of the same request where they
    overlap (terms, histogram: equal; stats' count, min and max equal, sum
    and avg within 1e-6)."""
    from elasticsearch_tpu_torch.index.device_reader import dd_split
    rows, _ = plane_rows(c5, qi)
    aggs = res["aggregations"]
    hi, lo = c5["rank_hi"][rows], c5["rank_lo"][rows]
    v = hi.astype(np.float64) + lo
    true = c5["rank"][rows]
    cats = np.bincount(c5["cat"][rows], minlength=len(C5_CATS))
    order = sorted(range(len(C5_CATS)), key=lambda i: (-cats[i], C5_CATS[i]))
    want_terms = [(C5_CATS[i], int(cats[i])) for i in order if cats[i]][:8]
    check([(x["key"], x["doc_count"]) for x in aggs["by_cat"]["buckets"]]
          == want_terms, f"{label} request {qi}: terms buckets differ")
    st = aggs["st"]
    check((st["count"], st["min"], st["max"]) == (len(rows), v.min(),
                                                  v.max()),
          f"{label} request {qi}: count / min / max differ from numpy")
    for key, want in (("sum", true.sum()), ("avg", true.mean())):
        check(abs(st[key] - want) <= 1e-5 * abs(want),
              f"{label} request {qi}: {key} {st[key]} vs float64 {want}")
    first = np.floor(v.min() / 5.0)
    bhi, blo = dd_split(np.float64(first * 5.0))
    rel = (hi - np.float32(bhi)) + (lo - np.float32(blo))
    counts = np.bincount(np.floor(rel / np.float32(5.0)).astype(np.int64))
    want_h = [(float(first * 5.0 + 5.0 * i), int(c))
              for i, c in enumerate(counts) if c]
    check([(x["key"], x["doc_count"]) for x in aggs["hi"]["buckets"]] ==
          want_h, f"{label} request {qi}: histogram buckets differ")
    fa = fanout["aggregations"]
    check(aggs["by_cat"] == fa["by_cat"] and aggs["hi"] == fa["hi"],
          f"{label} request {qi}: terms / histogram differ from phase 24's")
    check(all(st[x] == fa["st"][x] for x in ("count", "min", "max")) and
          all(abs(st[x] - fa["st"][x]) <= 1e-6 * abs(fa["st"][x])
              for x in ("sum", "avg")),
          f"{label} request {qi}: stats differ from phase 24's")


def phase_plane(torch, args, data, c5, pl, stats5, stats5a, name,
                smi_line) -> dict:
    """BASELINE config 5 through the collective plane: (a) score order from
    500, size 500, per-shard statistics; (b) the same with the DFS round;
    (c) sort by rank desc, size 100; (d) cat asc, rank desc; (e) (c)'s next
    page by search_after; (f) post_filter + min_score; (g) size 10 with
    terms, stats and histogram; (h) an untimed deep field-sort page at from
    20,000. Launch counters set to 0 just before the batches, read just
    after; (a) bit-identical to phase 23's fan-out, (b)-(h) against float64
    / numpy, (g) also against phase 24's merged aggregations; p50 a batch
    for (a), (c), (g)."""
    plane = pl["plane"]
    b = args.batch
    a_batches = [plane_bodies(data, i * b, b, **{"from": C5_FROM,
                                                 "size": C5_SIZE})
                 for i in range(PLANE_BATCHES)]
    c_batches = [plane_bodies(data, i * b, b, size=PLANE_SIZE,
                              sort=PLANE_SORT_C)
                 for i in range(PLANE_BATCHES)]
    g_batches = [plane_bodies(data, i * b, b, size=10, aggs=PLANE_AGGS)
                 for i in range(PLANE_BATCHES)]
    r0, s0 = plane_rows(c5, 0)
    min_score = float(np.quantile(s0, 0.9))
    f_batch = plane_bodies(data, 0, b, size=PLANE_SIZE, min_score=min_score,
                           post_filter={"range": {"rank": {"lt": 50}}})
    counters = path_kernels()
    torch.cuda.synchronize()
    GC.take()
    for kern in counters.values():
        kern.launches = 0
    ms_of: dict = {}

    def run(label, batches, gs=False):
        out = []
        for bodies in batches:
            t0 = time.perf_counter()
            out.append(plane.search_batch(bodies, global_stats=gs))
            ms_of.setdefault(label, []).append(
                (time.perf_counter() - t0) * 1e3)
        return out
    t_all = time.perf_counter()
    res_a = run("a", a_batches)
    res_b = run("b", a_batches[:1], gs=True)
    res_c = run("c", c_batches)
    res_d = run("d", [plane_bodies(data, 0, b, size=PLANE_SIZE,
                                   sort=PLANE_SORT_D)])
    check(all(len(r["doc_ids"]) for r in res_c[0]),
          "(c): a request without hits has no cursor for (e)")
    e_batch = [dict(body, search_after=r["sort_values"][-1])
               for body, r in zip(c_batches[0], res_c[0])]
    res_e = run("e", [e_batch])
    res_f = run("f", [f_batch])
    res_g = run("g", g_batches)
    wall = time.perf_counter() - t_all
    torch.cuda.synchronize()
    launches = {kn: kern.launches for kn, kern in counters.items()}
    for kn in ("bm25_scan", "stable_topk", "sort_select", "agg_counts_rows",
               "agg_stats_rows"):
        check(launches[kn] > 0, f"collective plane: kernel {kn} was not "
              f"launched on its path")
    # (a) against phase 23's fan-out: totals, scores and _id order equal
    for qi, (res, resp) in enumerate(zip(res_a[0], stats5["responses"])):
        hits = resp["hits"]["hits"]
        ids = [plane.doc_id(int(d)) for d in res["doc_ids"][C5_FROM:]]
        check(res["total"] == resp["hits"]["total"] and
              ids == [h["_id"] for h in hits] and
              [float(s) for s in res["scores"][C5_FROM:]] ==
              [h["_score"] for h in hits],
              f"(a) request {qi}: not bit-identical to phase 23's fan-out")
    recalls = []
    for qi in range(PLANE_CHECK):
        recalls.append(check_plane_scored("(a)", c5, plane, res_a[0][qi], qi,
                                          C5_FROM, C5_SIZE))
    # (b): DFS statistics against float64 BM25 with global statistics
    glob = cpu_scores(data["uterms"], data["utf"], data["lens"], data["df"],
                      data["qtids"][:PLANE_CHECK])
    for qi in range(PLANE_CHECK):
        rows = np.nonzero(glob[qi] > 0)[0]
        recalls.append(check_plane_scored(
            "(b)", c5, plane, res_b[0][qi], qi, C5_FROM, C5_SIZE,
            s64_rows=(rows, glob[qi][rows])))
    for qi in range(PLANE_CHECK):
        check_plane_sorted("(c)", c5, plane, res_c[0][qi], qi,
                           lambda rows: [-rank_dd(c5, rows)], 0, PLANE_SIZE,
                           lambda r: [phase_sort_value(rank_dd(c5, r))])
        check_plane_sorted("(d)", c5, plane, res_d[0][qi], qi,
                           lambda rows: [-rank_dd(c5, rows),
                                         c5["cat"][rows]], 0, PLANE_SIZE,
                           lambda r: [C5_CATS[c5["cat"][r]],
                                      phase_sort_value(rank_dd(c5, r))])
        # (e) continues (c): the next PLANE_SIZE of the same order
        check_plane_sorted("(e)", c5, plane, {**res_e[0][qi], "doc_ids": [
            -1] * PLANE_SIZE + list(res_e[0][qi]["doc_ids"]),
            "sort_values": [None] * PLANE_SIZE +
            res_e[0][qi]["sort_values"]}, qi,
            lambda rows: [-rank_dd(c5, rows)], PLANE_SIZE, PLANE_SIZE,
            lambda r: [phase_sort_value(rank_dd(c5, r))])

        def keep(rows, s64, tol=1e-5):
            low = c5["rank_hi"][rows] < 50.0
            return (low & (s64 >= min_score + tol),
                    low & (np.abs(s64 - min_score) < tol))
        recalls.append(check_plane_scored("(f)", c5, plane, res_f[0][qi],
                                          qi, 0, PLANE_SIZE, keep=keep))
        check_plane_aggs("(g)", c5, res_g[0][qi], qi,
                         stats5a["responses"][qi])
        check_plane_scored("(g)", c5, plane, res_g[0][qi], qi, 0, 10)
        fan = stats5a["responses"][qi]["hits"]["hits"]
        check([plane.doc_id(int(d)) for d in res_g[0][qi]["doc_ids"]] ==
              [h["_id"] for h in fan], f"(g) request {qi}: hits differ from "
              f"phase 24's")
    # (h) an untimed deep field-sort page
    h_body = plane_bodies(data, 0, 1, sort=PLANE_SORT_C,
                          **{"from": DEEP_FROM, "size": DEEP_SIZE})
    res_h = plane.search_batch(h_body, global_stats=False)[0]
    check_plane_sorted("(h)", c5, plane, res_h, 0,
                       lambda rows: [-rank_dd(c5, rows)], DEEP_FROM,
                       DEEP_SIZE, lambda r: [phase_sort_value(rank_dd(c5,
                                                                      r))])
    stats = {"p50_ms": {x: statistics.median(ms_of[x]) for x in ms_of},
             "batches_ms": ms_of, "launches": launches,
             "qps": sum(len(bb) for bb in a_batches + c_batches + g_batches)
             / (sum(ms_of["a"]) + sum(ms_of["c"]) + sum(ms_of["g"])) * 1e3}
    log(f"collective plane, config 5 ({C5_SHARDS} shards on one card, "
        f"batches of {b}): launches {launches}; p50 ms a batch: (a) score "
        f"order, from {C5_FROM}, size {C5_SIZE}: {stats['p50_ms']['a']:.3f}; "
        f"(c) rank desc, size {PLANE_SIZE}: {stats['p50_ms']['c']:.3f}; (g) "
        f"terms + stats + histogram, size 10: {stats['p50_ms']['g']:.3f}; "
        f"one batch each: (b) DFS {ms_of['b'][0]:.3f}, (d) cat, rank "
        f"{ms_of['d'][0]:.3f}, (e) search_after {ms_of['e'][0]:.3f}, (f) "
        f"post_filter + min_score {min_score:.4f} {ms_of['f'][0]:.3f} ms; "
        f"wall {wall:.1f} s. (a) bit-identical to phase 23's fan-out on all "
        f"{b} requests (totals, scores, _id order); requests 0-"
        f"{PLANE_CHECK - 1} of (a), (b) (DFS, global float64), (f) vs "
        f"float64: totals exact, scores within 1e-5, tie-tolerant recall "
        f"{min(recalls)}; (c), (d), (e), (h) (from {DEEP_FROM}) ids and sort "
        f"values equal to numpy; (g) buckets, count, min, max equal to "
        f"numpy and to phase 24's merge, sums within 1e-5 / 1e-6; last "
        f"batch's host phases {plane.last_phases}; {GC.take()} — on {name} "
        f"({smi_line})")
    return stats


def phase_sort_value(v):
    from elasticsearch_tpu_torch.search.phase import _sort_value_out
    return _sort_value_out(np.float64(v))


def phase_plane_profile(torch, args, data, pl, label, bodies, gs) -> dict:
    """One plane batch under torch.profiler (one recorded run: phase 55
    ran the batch): device busy, hand-kernel launches, the host planning of
    the batch alone and the DFS round alone."""
    from elasticsearch_tpu_torch.parallel import mesh_engine as me
    from elasticsearch_tpu_torch.search.phase import parse_search_request
    plane = pl["plane"]
    reqs = [parse_search_request(x) for x in bodies]
    GC.take()
    t0 = time.perf_counter()
    plane._global_dfs([r.query for r in reqs])
    dfs_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plane._plan_slots(reqs, dict(me._FLAGS), False, None)
    plan_ms = (time.perf_counter() - t0) * 1e3
    return profile_batch(
        torch, label, lambda: plane.search_batch(bodies, global_stats=gs),
        plan_ms, GC.take(), len(bodies), warmup=False,
        extra=lambda: f"; the DFS round alone {dfs_ms:.3f} ms (this batch "
        f"{'runs' if gs else 'skips'} it); the plane's host phases "
        f"{plane.last_phases}")


def phase_distributed(torch, args, data, c5, pl, name, smi_line) -> dict:
    """DistributedBM25 over config 5's 8 shards' text columns on the
    plane's mesh: one batch of config 5's queries at k = 1,000 (K1 with
    its match counts and K2 a shard, the group's psum and all_gather, K2
    over the gathered candidates), against float64 BM25 with global
    statistics."""
    from elasticsearch_tpu_torch.analysis.analyzers import BUILTIN_ANALYZERS
    from elasticsearch_tpu_torch.models.bm25 import PackedTextIndex
    from elasticsearch_tpu_torch.parallel import DistributedBM25
    terms = {t: i for i, t in enumerate(data["term_names"])}
    shards = [PackedTextIndex(
        terms=terms, uterms=data["uterms"][sh["lo"]:sh["hi"]],
        utf=data["utf"][sh["lo"]:sh["hi"]],
        doc_len=data["lens"][sh["lo"]:sh["hi"]],
        live=np.ones(sh["hi"] - sh["lo"], bool), df=sh["df"],
        num_docs=sh["hi"] - sh["lo"],
        total_tokens=int(data["lens"][sh["lo"]:sh["hi"]].sum()))
        for sh in c5["shards"]]
    t0 = time.perf_counter()
    dist = DistributedBM25(pl["mesh"], shards,
                           analyzer=BUILTIN_ANALYZERS["whitespace"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    k = C5_FROM + C5_SIZE
    queries = data["texts"][:args.batch]
    counters = path_kernels()
    for kern in counters.values():
        kern.launches = 0
    t0 = time.perf_counter()
    scores, docs, totals = dist.search(queries, k=k)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {kn: kern.launches for kn, kern in counters.items()}
    for kn in ("bm25_scan", "stable_topk"):
        check(launches[kn] > 0, f"DistributedBM25: kernel {kn} was not "
              f"launched on its path")
    glob = cpu_scores(data["uterms"], data["utf"], data["lens"], data["df"],
                      data["qtids"][:PLANE_CHECK])
    recalls = []
    for qi in range(PLANE_CHECK):
        s64 = glob[qi]
        check(int(totals[qi]) == int((s64 > 0).sum()),
              f"DistributedBM25 query {qi}: total {totals[qi]} != float64 "
              f"matches {(s64 > 0).sum()}")
        valid = docs[qi] >= 0
        orig = np.asarray([c5["shards"][si]["lo"] + row for si, row in
                           (dist.resolve(int(d)) for d in docs[qi][valid])],
                          np.int64)
        check(len(orig) == min(k, int((s64 > 0).sum())),
              f"DistributedBM25 query {qi}: {len(orig)} hits")
        check(np.allclose(scores[qi][valid], s64[orig], rtol=1e-5,
                          atol=1e-5), f"DistributedBM25 query {qi}: scores "
              f"disagree with float64")
        recalls.append(tie_tolerant_recall(s64, orig, k, tol=1e-4))
    check(min(recalls) == 1.0, f"DistributedBM25: recall {min(recalls)}")
    log(f"DistributedBM25 ({C5_SHARDS} shards of {c5['per_shard']} docs on "
        f"one card, {dist.device_bytes()} B of shard columns, packed in "
        f"{setup_s:.1f} s): one batch of {len(queries)} at k = {k} in "
        f"{wall_ms:.3f} ms (the first call: analysis and the query upload "
        f"included); launches {launches}; queries 0-{PLANE_CHECK - 1} vs "
        f"float64 BM25 with global statistics: totals exact, scores within "
        f"1e-5, tie-tolerant recall {min(recalls)} — on {name} ({smi_line})")
    del dist
    return {"launches": launches, "ms": wall_ms}


def release_plane(torch, pl) -> None:
    from elasticsearch_tpu_torch.parallel import mesh_engine as me
    pl.pop("plane", None)
    me.clear_block_cache()
    gc.collect()
    pl["mesh"].close()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"released the plane's blocks and its group: "
        f"{torch.cuda.memory_allocated()} B allocated on the card")


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
        stats_m, stats_mi = phase_maxsim(torch, args, mdata, name,
                                         smi_line)
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
        by_config = {"2": stats2, "3": stats3, "4": stats4,
                     "4-int8": stats4i,
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
        k67[1]["large_k"] = phase_k7_large(torch, args, data, name,
                                           smi_line)
        # config 5 and aggregations
        release_lane_state(torch, data, mdata)
        kernels[1]["large_k"] = phase_topk_large(torch, args, data)
        c5 = phase_config5_setup(torch, args, data)
        k89 = phase_agg_kernels(torch, args, data, c5)
        kernels.extend(k89)
        stats5 = phase_config5(torch, args, data, c5, name, smi_line)
        stats5a = phase_config5_aggs(torch, args, data, c5, name, smi_line)
        kernels[1]["large_k"].update(phase_deep_page(torch, args, data,
                                                     c5))
        by_config.update({"5": stats5, "5-aggs": stats5a})
        for kern in kernels:
            kern["launches_by_config"] = {
                cfg: st["launches"][kern["name"]]
                for cfg, st in by_config.items()}
        for kern in k89:
            kern["launches"] = stats5a["launches"][kern["name"]]
        phase_c5_profile(torch, data, c5, "config 5", c5_reqs(
            data, args.batch, **{"from": C5_FROM, "size": C5_SIZE}))
        prof = phase_c5_profile(
            torch, data, c5, "config 5 + aggs",
            c5_reqs(data, args.batch, size=10, aggs=C5_AGGS))
        # the device time of one launch on the path, beside the wrapper's
        # event-timed call (K9 is two kernels a launch)
        for kern, key, per_launch in ((k89[0], "K8", 1),
                                      (k89[1], "K9", 2)):
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
        # scripts
        k12 = phase_script_kernel(torch, args, data)
        kernels.append(k12)
        stats3s = phase_config3s(torch, args, data, name, smi_line)
        stats4s = phase_config4s(torch, args, data, name, smi_line)
        stats_sf = phase_script_fields(torch, args, data, stats3s)
        stats_sa = phase_script_aggs(torch, args, data, c5)
        stats_ps = phase_percolate_scripts(torch, args, data, name,
                                           smi_line)
        script_paths = {"3s": stats3s, "4s": stats4s,
                        "script-fields": stats_sf, "script-aggs": stats_sa,
                        "percolate-scripts": stats_ps}
        for cfg, st in script_paths.items():
            check(st["launches"]["script_eval"] > 0,
                  f"{cfg}: K12 was not launched on its path")
        by_config.update(script_paths)
        for kern in kernels:
            kern["launches_by_config"] = {
                cfg: st["launches"][kern["name"]]
                for cfg, st in by_config.items()}
        k12["launches"] = sum(st["launches"]["script_eval"]
                              for st in script_paths.values())
        phase_profile(torch, args, data, "config 3s",
                      config3s_bodies(args, data))
        phase_profile(torch, args, data, "config 4s",
                      config4s_bodies(data["qv4"][:args.batch]))
        # the query leaves
        t_leaves = time.perf_counter()
        data["span_terms"] = span_terms(args, data,
                                        LEAF_BATCHES * args.batch)
        k13, k14, k15, k16 = phase_leaf_kernels(torch, args, data)
        kernels.extend((k13, k14, k15, k16))
        f64 = Float64(data, max(LEAF_BATCHES, NESTED_BATCHES) * args.batch)
        leaf_paths = {}
        for kind, st in phase_span_paths(torch, args, data, f64, name,
                                         smi_line).items():
            leaf_paths[f"span-{kind}"] = st
        for label, st in phase_multi_term_paths(torch, args, data, f64,
                                                name, smi_line).items():
            leaf_paths[f"filter-{label}"] = st
        for sim, st in phase_similarity_paths(torch, args, data, f64, name,
                                              smi_line).items():
            leaf_paths[f"match-{sim}"] = st
        for kind, st in phase_compound_paths(torch, args, data, f64, name,
                                             smi_line).items():
            leaf_paths[kind.replace("_", "-")] = st
        by_config.update(leaf_paths)
        for kern in kernels:
            kern["launches_by_config"] = {
                cfg: st["launches"][kern["name"]]
                for cfg, st in by_config.items()}
        for kern in (k13, k14, k15, k16):
            kern["launches"] = sum(st["launches"][kern["name"]]
                                   for st in leaf_paths.values())
        # phase 41 ran this batch: the profile records one run
        phase_profile(torch, args, data, "span tree",
                      span_bodies(data, "not_tree", args.batch),
                      warmup=False)
        log(f"query leaves: phases 39-46 in "
            f"{time.perf_counter() - t_leaves:.1f} s")
        # geo
        t_geo = time.perf_counter()
        geo = phase_geo_setup(torch, args, data)
        k17, k18 = phase_geo_kernels(torch, args, data, geo)
        kernels.extend((k17, k18))
        geo_paths = {f"geo-{kind.replace('/', '-')}": st
                     for kind, st in phase_geo_paths(
                         torch, args, data, geo, f64, name,
                         smi_line).items()}
        geo_paths["geo-aggs"] = phase_geo_aggs(torch, args, data, geo, f64,
                                               name, smi_line)
        geo_paths["geo-percolate"] = phase_geo_percolate(torch, args, data,
                                                         name, smi_line)
        by_config.update(geo_paths)
        for kern in kernels:
            kern["launches_by_config"] = {
                cfg: st["launches"][kern["name"]]
                for cfg, st in by_config.items()}
        for kern in (k17, k18):
            kern["launches"] = sum(st["launches"][kern["name"]]
                                   for st in geo_paths.values())
        phase_profile(torch, args, data, "geo_distance",
                      geo_bodies(args, data, "distance", args.batch))
        phase_profile(torch, args, data, "geo_shape intersects",
                      geo_bodies(args, data, "intersects/circle",
                                 args.batch))
        log(f"geo: phases 47-51 in {time.perf_counter() - t_geo:.1f} s")
        # nested documents
        t_nested = time.perf_counter()
        nd = phase_nested_setup(torch, args, data)
        k19 = phase_nested_kernels(torch, args, data, nd)
        kernels.append(k19)
        nested_paths = {f"nested-{kind.replace('_', '-')}": st
                        for kind, st in phase_nested_paths(
                            torch, args, data, nd, f64, name,
                            smi_line).items()}
        nested_paths["nested-aggs"] = phase_nested_aggs(
            torch, args, data, nd, name, smi_line)
        nested_paths["nested-percolate"] = phase_nested_percolate(
            torch, args, data, name, smi_line)
        by_config.update(nested_paths)
        for kern in kernels:
            kern["launches_by_config"] = {
                cfg: st["launches"][kern["name"]]
                for cfg, st in by_config.items()}
        k19["launches"] = sum(st["launches"]["nested_reduce"]
                              for st in nested_paths.values())
        log(f"nested: phases 52-53 in "
            f"{time.perf_counter() - t_nested:.1f} s")
        # the collective plane and DistributedBM25
        t_plane = time.perf_counter()
        pl = phase_plane_setup(torch, c5)
        k20, k8r, k9r = phase_plane_kernels(torch, args, data, c5, pl)
        kernels.extend((k20, k8r, k9r))
        stats_pl = phase_plane(torch, args, data, c5, pl, stats5, stats5a,
                               name, smi_line)
        phase_plane_profile(torch, args, data, pl, "plane (a): score order, "
                            f"from {C5_FROM}, size {C5_SIZE}", plane_bodies(
                                data, 0, args.batch, **{
                                    "from": C5_FROM, "size": C5_SIZE}),
                            False)
        phase_plane_profile(torch, args, data, pl, "plane (c): rank desc, "
                            f"size {PLANE_SIZE}", plane_bodies(
                                data, 0, args.batch, size=PLANE_SIZE,
                                sort=PLANE_SORT_C), False)
        stats_db = phase_distributed(torch, args, data, c5, pl, name,
                                     smi_line)
        release_plane(torch, pl)
        by_config.update({"plane": stats_pl, "distributed-bm25": stats_db})
        for kern in kernels:
            kern["launches_by_config"] = {
                cfg: st["launches"][kern["name"]]
                for cfg, st in by_config.items()}
        for kern in (k20, k8r, k9r):
            kern["launches"] = stats_pl["launches"][kern["name"]]
        log(f"collective plane: phases 54-56 in "
            f"{time.perf_counter() - t_plane:.1f} s")
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
