// K1: batched BM25 forward scan over one segment's forward impact columns.
//
// Replaces elasticsearch_tpu/ops/lexical.py:bm25_match as the JAX package
// runs it under jax.vmap (search/jit_exec.py:run_reader_batch): for each
// query q of a batch and each doc row d,
//
//   norm(q, d)  = k1 * ((1 - b) + (b * dl_d) / avgdl_q)
//   tfn(q,d,u)  = (utf[d,u] * (k1 + 1)) / (utf[d,u] + norm(q, d))
//   score(q, d) = sum over query terms t, in term order, of
//                 (qidf[q,t] * qweight[q,t]) * tfn(q, d, u)
//                 where uterms[d,u] == qtids[q,t]
//   nmatch(q,d) = number of query terms t with a hit in row d (optional)
//
// What bounds it on an H100: device-memory bytes. A batch must read each
// row's term ids up to its first pad, the matching frequencies on hits only,
// and write [B,N] scores (and counts, when asked for); the arithmetic is a
// handful of flops per (query, doc) and per hit. Each row's steps depend on
// one another (term ids, then the hits' frequencies, then the sums), so what
// stands between the kernel and that bound is latency, and the design keeps
// many rows in flight:
//   * the grid runs over the rows only and every query of the batch is
//     scored inside the block, so each [N,U] cell crosses the memory bus once
//     per batch by construction. Blocks are persistent (as many as fit on the
//     card), and each WARP walks runs of kRun consecutive rows on its own:
//     no block-wide barrier stalls the scan;
//   * a warp scans one row at a time, its lanes over the row's cells: each
//     load is 32 contiguous cells, and the warp stops after the window that
//     holds the row's first pad (`trailing_pad`), so a row of ~50 terms costs
//     two coalesced loads. The next row's first two windows are loaded while
//     the current row is scored;
//   * the block's prologue builds an open-addressing hash table in shared
//     memory of the batch's query terms (term id -> table slot; a term
//     repeated within or across queries has one slot). A cell probes it; on
//     a hit the lane reads utf once and stamps the slot for this row with
//     its tfn under the row's norm — the batch's queries on one field share
//     one avgdl, so a row costs one norm and one division per hit cell, not
//     per (query, term). A group whose queries' avgdl differ (bit for bit)
//     stamps tf instead, and each query divides anew;
//   * then each lane scores its queries: for t in term order it looks up the
//     slot of (q, t), and on a stamp of this row adds its term's share, so
//     the sum is formed in the reference's order for every (q, d);
//   * the warp stages its run's [queries, kRun] results in shared memory and
//     writes kRun contiguous words (one 32-byte sector) per query; counts
//     only when asked for (`nmatch` NULL skips them: the match query's OR
//     plan never reads them). The per-warp buffers are small (a byte stamp
//     and a word per table slot), so ~40 warps fit on an SM.
// A batch whose (query, term) pairs exceed one table (kMaxSlots) is cut into
// query groups (grid y), and a query of more than kMaxSlots terms into term
// chunks that the block walks in order, each chunk adding to the sums the
// previous one wrote, so the term order of the sum holds across chunks.
// Each row must hold a term at most once (the segment builder's layout:
// sorted unique terms, then -1 pads).
// Numerics: every operation is rounded on its own (__fmul_rn / __fadd_rn /
// __fdiv_rn, no FMA contraction, no fast math), in the reference's order, so
// the result is bit-identical to the plain PyTorch version on the card.
//
// K15 (sim_scan_launch): the classic TF-IDF and LM-Dirichlet similarities,
// replacing elasticsearch_tpu/ops/lexical.py:classic_match and
// lm_dirichlet_match (search/execute.py:_match_alt_similarity), are this
// scan instantiated with another per-term formula. Their stamps always carry
// tf (the mode above for queries whose avgdl differ), and each query
// finishes its term's share in term order:
//   classic:      (qweight * (qidf * qidf)) * (sqrt(tf) * inv_norm),
//                 inv_norm = dl > 0 ? 1 / sqrt(dl) : 0
//   LM Dirichlet: qweight * max(log1p(tf / (mu * max(frac, floor)))
//                               + log(mu / (dl + mu)), 0)
// with the counts always written (their mask is nmatch >= required). The
// bound and the design are K1's: the same bytes, a few more operations per
// hit (a square root or two logarithms). The BM25 instantiation is the code
// above unchanged (the similarity is a template argument).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRun = 8;              // consecutive rows a warp scores at once
constexpr int kStride = kRun + 1;    // staging stride: conflict-free
constexpr int kMaxSlots = 512;       // (query, term) pairs per table
constexpr int kMaxGroup = 64;        // queries per block
constexpr unsigned kFull = 0xffffffffu;
// The limit each launch sets is the most any call may take (sm_90's opt-in
// shared memory a block), not this call's size: shards call from several
// threads, and a smaller limit set by another thread between this call's
// setting and its launch would refuse the launch.
constexpr int kSmemOptIn = 232448;

// Shared-memory layout, computed alike on the host (for its size) and in the
// kernel. Per block: the table's keys, each pair's slot and weight, the
// queries' avgdl; per warp: a byte stamp and a value per table slot, and the
// run's staged scores (and counts).
struct Layout {
  int qg, tc, n_chunks, hbits;
  int off_key, off_slot, off_c, off_c2, off_avg, off_stamp, off_val,
      off_score, off_cnt, bytes;
};

// the similarity of an instantiation (sim_scan_launch's `sim`)
constexpr int kBm25 = 0;
constexpr int kClassic = 1;
constexpr int kLmDirichlet = 2;

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int n_queries, int n_terms,
                                              bool with_counts,
                                              int sim = kBm25) {
  Layout l;
  l.tc = n_terms < kMaxSlots ? n_terms : kMaxSlots;
  int qg = kMaxSlots / l.tc;
  if (qg > kMaxGroup) qg = kMaxGroup;
  if (qg > n_queries) qg = n_queries;
  l.qg = qg;
  l.n_chunks = (n_terms + l.tc - 1) / l.tc;
  int hbits = 5;  // at least twice as many table slots as pairs
  while ((1 << hbits) < 2 * l.qg * l.tc) ++hbits;
  l.hbits = hbits;
  const int h = 1 << hbits;
  const int pairs = l.qg * l.tc;
  const int staged = l.qg * kStride * 4;
  int o = 0;
  l.off_key = o;   o = align16(o + h * 4);
  l.off_slot = o;  o = align16(o + pairs * 4);
  l.off_c = o;     o = align16(o + pairs * 4);
  l.off_c2 = o;
  if (sim == kLmDirichlet) o = align16(o + pairs * 4);
  l.off_avg = o;   o = align16(o + l.qg * 4);
  l.off_stamp = o; o = align16(o + kWarps * h);
  l.off_val = o;   o = align16(o + kWarps * h * 4);
  l.off_score = o; o = align16(o + kWarps * staged);
  l.off_cnt = o;
  if (with_counts) o = align16(o + kWarps * staged);
  l.bytes = o;
  return l;
}

__device__ __forceinline__ uint32_t slot_hash(int32_t term, int hbits) {
  return ((uint32_t)term * 0x9E3779B1u) >> (32 - hbits);
}

__device__ __forceinline__ float length_norm(float k1, float omb, float b,
                                             float dl, float avg) {
  return __fmul_rn(k1, __fadd_rn(omb, __fdiv_rn(__fmul_rn(b, dl), avg)));
}

__device__ __forceinline__ float tf_norm(float tf, float k1p1, float norm) {
  return __fdiv_rn(__fmul_rn(tf, k1p1), __fadd_rn(tf, norm));
}

// kSim == kBm25: qidf, qweight, avgdl as named. kClassic: qidf is the
// classic idf, avgdl unused. kLmDirichlet: qidf is P(t|C), avgdl is mu.
template <int kSim>
__global__ void __launch_bounds__(kThreads)
bm25_scan_kernel(const int32_t* __restrict__ uterms,
                 const float* __restrict__ utf,
                 const int32_t* __restrict__ doc_len, int n_docs,
                 int n_unique, const int32_t* __restrict__ qtids,
                 const float* __restrict__ qidf,
                 const float* __restrict__ qweight,
                 const float* __restrict__ avgdl, int n_queries, int n_terms,
                 float k1, float k1p1, float omb, float b, int trailing_pad,
                 float lm_floor, float* __restrict__ scores,
                 int32_t* __restrict__ nmatch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(n_queries, n_terms, nmatch != nullptr, kSim);
  const int qg = L.qg;
  const int hbits = L.hbits;
  const int hsize = 1 << hbits;
  const uint32_t hmask = (uint32_t)hsize - 1u;
  int32_t* s_key = reinterpret_cast<int32_t*>(smem + L.off_key);
  int32_t* s_slot = reinterpret_cast<int32_t*>(smem + L.off_slot);  // [t][q]
  float* s_c = reinterpret_cast<float*>(smem + L.off_c);            // [t][q]
  float* s_c2 = reinterpret_cast<float*>(smem + L.off_c2);          // [t][q]
  float* s_avg = reinterpret_cast<float*>(smem + L.off_avg);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint8_t* my_stamp = smem + L.off_stamp + warp * hsize;
  float* my_val = reinterpret_cast<float*>(smem + L.off_val) + warp * hsize;
  float* my_score = reinterpret_cast<float*>(smem + L.off_score) +
                    warp * qg * kStride;                            // [q][r]
  int32_t* my_cnt =
      nmatch ? reinterpret_cast<int32_t*>(smem + L.off_cnt) +
                   warp * qg * kStride
             : nullptr;

  const int q0 = blockIdx.y * qg;
  const int nq = min(qg, n_queries - q0);
  const int runs = (n_docs + kRun - 1) / kRun;
  const int run_step = gridDim.x * kWarps;
  const bool two = n_unique > 32;

  for (int ch = 0; ch < L.n_chunks; ++ch) {
    const int t0 = ch * L.tc;
    const int nt = min(L.tc, n_terms - t0);
    // ---- the table of this group's (query, term) pairs ------------------
    __syncthreads();  // every warp is done with the previous table
    for (int i = threadIdx.x; i < hsize; i += kThreads) s_key[i] = -1;
    if (kSim != kClassic)
      for (int q = threadIdx.x; q < nq; q += kThreads)
        s_avg[q] = avgdl[q0 + q];
    __syncthreads();
    for (int i = threadIdx.x; i < nt * qg; i += kThreads) {
      const int t = i / qg;
      const int q = i - t * qg;
      int32_t slot = -1;
      float c = 0.0f;
      if (q < nq) {
        const int64_t at = (int64_t)(q0 + q) * n_terms + t0 + t;
        const int32_t term = qtids[at];
        if (kSim == kBm25) {
          c = __fmul_rn(qidf[at], qweight[at]);
        } else if (kSim == kClassic) {
          c = __fmul_rn(qweight[at], __fmul_rn(qidf[at], qidf[at]));
        } else {
          c = qweight[at];
          s_c2[i] = __fmul_rn(s_avg[q], fmaxf(qidf[at], lm_floor));
        }
        if (term >= 0) {
          uint32_t h = slot_hash(term, hbits);
          for (;;) {
            const int32_t prev = atomicCAS(&s_key[h], -1, term);
            if (prev == -1 || prev == term) break;
            h = (h + 1u) & hmask;
          }
          slot = (int32_t)h;
        }
      }
      s_slot[i] = slot;
      s_c[i] = c;
    }
    const float avg0 = kSim == kBm25 ? s_avg[0] : 0.0f;
    // do the group's queries differ in avgdl? then stamps carry tf (as they
    // always do for the other similarities)
    const bool mixed = __syncthreads_or(
        kSim != kBm25 || (threadIdx.x < nq &&
                          __float_as_uint(s_avg[threadIdx.x]) !=
                              __float_as_uint(avg0)));

    // ---- this warp's runs of rows -----------------------------------------
    int run = blockIdx.x * kWarps + warp;
    int32_t next0 = -1, next1 = -1, next_dl = 0;
    auto fetch = [&](int64_t d) {
      const int32_t* rt = uterms + d * n_unique;
      next0 = lane < n_unique ? rt[lane] : -1;
      if (two) next1 = 32 + lane < n_unique ? rt[32 + lane] : -1;
      next_dl = doc_len[d];
    };
    if (run < runs) fetch((int64_t)run * kRun);
    for (; run < runs; run += run_step) {
      const int d0 = run * kRun;
      const int rows = min(kRun, n_docs - d0);
      for (int i = lane; i < hsize / 4; i += 32)
        reinterpret_cast<uint32_t*>(my_stamp)[i] = 0u;
      __syncwarp();
      for (int r = 0; r < rows; ++r) {
        const int d = d0 + r;
        const int32_t* row_t = uterms + (int64_t)d * n_unique;
        const float* row_f = utf + (int64_t)d * n_unique;
        int32_t cell = next0;
        const int32_t cell1 = next1;
        const float dl = (float)next_dl;
        // the next row's first windows, in flight while this one is scored
        if (r + 1 < rows)
          fetch((int64_t)d + 1);
        else if (run + run_step < runs)
          fetch((int64_t)(run + run_step) * kRun);
        const float norm0 =
            kSim == kBm25 ? length_norm(k1, omb, b, dl, avg0) : 0.0f;
        // classic: the row's 1 / sqrt(dl)
        const float inv_norm =
            kSim == kClassic && dl > 0.0f
                ? __fdiv_rn(1.0f, __fsqrt_rn(dl)) : 0.0f;
        const uint8_t stamp = (uint8_t)(r + 1);
        for (int u0 = 0;;) {
          const int u = u0 + lane;
          bool live = cell >= 0;
          bool last = u0 + 32 >= n_unique;
          if (trailing_pad) {
            const unsigned pads =
                __ballot_sync(kFull, u < n_unique && cell < 0);
            if (pads) {
              live = live && lane < __ffs(pads) - 1;
              last = true;
            }
          }
          if (live) {
            uint32_t h = slot_hash(cell, hbits);
            for (;;) {
              const int32_t key = s_key[h];
              if (key == cell) {
                const float tf = row_f[u];
                my_val[h] = mixed ? tf : tf_norm(tf, k1p1, norm0);
                my_stamp[h] = stamp;
                break;
              }
              if (key < 0) break;
              h = (h + 1u) & hmask;
            }
          }
          if (last) break;
          u0 += 32;
          cell = u0 == 32 ? cell1
                          : (u0 + lane < n_unique ? row_t[u0 + lane] : -1);
        }
        __syncwarp();

        // ---- score the row for each query, terms in order ---------------
        for (int q = lane; q < nq; q += 32) {
          const int64_t at = (int64_t)(q0 + q) * n_docs + d;
          float score = ch > 0 ? scores[at] : 0.0f;
          int32_t count = ch > 0 && my_cnt ? nmatch[at] : 0;
          float norm = norm0;
          if (kSim == kBm25) {
            if (mixed) norm = length_norm(k1, omb, b, dl, s_avg[q]);
          } else if (kSim == kLmDirichlet) {
            const float mu = s_avg[q];
            norm = logf(__fdiv_rn(mu, __fadd_rn(dl, mu)));
          }
          for (int t = 0; t < nt; ++t) {
            const int32_t slot = s_slot[t * qg + q];
            if (slot < 0 || my_stamp[slot] != stamp) continue;
            const float v = my_val[slot];
            float share;
            if (kSim == kBm25) {
              const float tfn = mixed ? tf_norm(v, k1p1, norm) : v;
              share = __fmul_rn(s_c[t * qg + q], tfn);
            } else if (kSim == kClassic) {
              share = __fmul_rn(s_c[t * qg + q],
                                __fmul_rn(__fsqrt_rn(v), inv_norm));
            } else {
              const float ts = __fadd_rn(
                  log1pf(__fdiv_rn(v, s_c2[t * qg + q])), norm);
              share = __fmul_rn(s_c[t * qg + q], ts > 0.0f ? ts : 0.0f);
            }
            score = __fadd_rn(score, share);
            ++count;
          }
          my_score[q * kStride + r] = score;
          if (my_cnt) my_cnt[q * kStride + r] = count;
        }
        __syncwarp();
      }

      // ---- write the run: kRun contiguous words per query -----------------
      for (int i = lane; i < nq * kRun; i += 32) {
        const int q = i / kRun;
        const int r = i - q * kRun;
        if (r < rows) {
          const int64_t at = (int64_t)(q0 + q) * n_docs + d0 + r;
          scores[at] = my_score[q * kStride + r];
          if (my_cnt) nmatch[at] = my_cnt[q * kStride + r];
        }
      }
      __syncwarp();
    }
  }
}

template <int kSim>
int scan_launch(const void* uterms, const void* utf, const void* doc_len,
                int n_docs, int n_unique, const void* qtids, const void* qidf,
                const void* qweight, const void* avgdl, int n_queries,
                int n_terms, float k1, float k1p1, float omb, float b,
                int trailing_pad, float lm_floor, void* scores, void* nmatch,
                void* stream) {
  if (n_docs <= 0 || n_queries <= 0 || n_terms <= 0 || n_unique <= 0)
    return (int)cudaErrorInvalidValue;
  const Layout l = make_layout(n_queries, n_terms, nmatch != nullptr, kSim);
  cudaError_t err = cudaFuncSetAttribute(
      bm25_scan_kernel<kSim>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bm25_scan_kernel<kSim>, kThreads, l.bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int groups = (n_queries + l.qg - 1) / l.qg;
  const long long blocks_needed =
      ((n_docs + kRun - 1) / kRun + kWarps - 1) / kWarps;
  // persistent blocks: the card full, shared among the query groups, and no
  // more than the runs of rows need
  long long want = (long long)sms * per_sm / groups;
  if (want < 1) want = 1;
  if (want > blocks_needed) want = blocks_needed;
  dim3 grid((unsigned)want, (unsigned)groups);
  bm25_scan_kernel<kSim><<<grid, kThreads, l.bytes, (cudaStream_t)stream>>>(
      (const int32_t*)uterms, (const float*)utf, (const int32_t*)doc_len,
      n_docs, n_unique, (const int32_t*)qtids, (const float*)qidf,
      (const float*)qweight, (const float*)avgdl, n_queries, n_terms, k1,
      k1p1, omb, b, trailing_pad, lm_floor, (float*)scores,
      (int32_t*)nmatch);
  return (int)cudaGetLastError();
}

}  // namespace

// `nmatch` may be NULL: the counts are then neither kept nor written.
extern "C" int bm25_scan_launch(const void* uterms, const void* utf,
                                const void* doc_len, int n_docs, int n_unique,
                                const void* qtids, const void* qidf,
                                const void* qweight, const void* avgdl,
                                int n_queries, int n_terms, float k1,
                                float k1p1, float omb, float b,
                                int trailing_pad, void* scores, void* nmatch,
                                void* stream) {
  return scan_launch<kBm25>(uterms, utf, doc_len, n_docs, n_unique, qtids,
                            qidf, qweight, avgdl, n_queries, n_terms, k1,
                            k1p1, omb, b, trailing_pad, 0.0f, scores, nmatch,
                            stream);
}

// K15. sim 1 (classic): qa is the classic idf, mu unused (may be NULL);
// sim 2 (LM Dirichlet): qa is P(t|C), mu [n_queries], floor the f32 floor
// of P(t|C). The counts are always written.
extern "C" int sim_scan_launch(const void* uterms, const void* utf,
                               const void* doc_len, int n_docs, int n_unique,
                               const void* qtids, const void* qa,
                               const void* qweight, const void* mu,
                               int n_queries, int n_terms, int sim,
                               float floor, int trailing_pad, void* scores,
                               void* nmatch, void* stream) {
  if (nmatch == nullptr) return (int)cudaErrorInvalidValue;
  if (sim == kClassic)
    return scan_launch<kClassic>(uterms, utf, doc_len, n_docs, n_unique,
                                 qtids, qa, qweight, nullptr, n_queries,
                                 n_terms, 0.0f, 0.0f, 0.0f, 0.0f,
                                 trailing_pad, floor, scores, nmatch, stream);
  if (sim == kLmDirichlet && mu != nullptr)
    return scan_launch<kLmDirichlet>(uterms, utf, doc_len, n_docs, n_unique,
                                     qtids, qa, qweight, mu, n_queries,
                                     n_terms, 0.0f, 0.0f, 0.0f, 0.0f,
                                     trailing_pad, floor, scores, nmatch,
                                     stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bm25_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
