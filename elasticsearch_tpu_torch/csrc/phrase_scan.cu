// K3: batched exact-phrase scan over one segment's position matrix.
//
// Replaces elasticsearch_tpu/ops/phrase.py:phrase_score (phrase_freq, then
// freq_score) as the JAX package runs it under jax.vmap
// (search/execute.py:_res_MatchPhraseQuery, slop 0): for each query q of a
// batch and each doc row d,
//
//   freq(q, d)  = number of start positions p with, for every phrase term k,
//                 tokens[d, p + deltas[k]] == qtids[q, k] and qtids[q,k] >= 0
//                 (a position at or beyond the row's end never matches)
//   norm(q, d)  = k1 * ((1 - b) + (b * dl_d) / avgdl_q)
//   tfn(q, d)   = (freq * (k1 + 1)) / (freq + norm)
//   score(q, d) = sum_idf_q * tfn        where freq > 0, else 0
//   mask(q, d)  = freq > 0
//
// The deltas are shared by the batch: they are part of the plan signature.
//
// What bounds it on an H100: device-memory bytes. A batch must read each
// row's positions up to its extent (its last position holding a term, plus
// one; recorded at upload, so a -1 hole inside a row is a position, not the
// row's end), and write [B,N] scores and a [B,N] mask; the arithmetic is a
// probe per position and a few flops per (query, doc) with freq > 0. The
// design is K1's (csrc/bm25_scan.cu), because the batch, not the query, is
// the unit of reuse:
//   * the grid runs over the rows only and every query of the batch is
//     scored inside the block, so each row of positions crosses the memory
//     bus once per batch. Blocks are persistent and each WARP walks runs of
//     kRun consecutive rows on its own (no block-wide barrier in the scan);
//   * at the start of a run a warp copies the first kStagePos positions of
//     all kRun rows (each only up to its extent, in coalesced 32-position
//     windows) into its shared-memory run buffer with asynchronous copies
//     (cp.async: all in flight at once, no registers held); positions
//     beyond kStagePos (rows longer than ~93% of the corpus's) are read from
//     device memory during the scan. The next run's extents and lengths are
//     in flight while this run is scanned;
//   * the block's prologue builds an open-addressing hash table in shared
//     memory keyed by each phrase's FIRST TWO terms (its first term alone
//     for a one-term phrase), each slot heading the chain of the queries
//     with that key (a query with an absent term matches nowhere and is
//     left out). Each lane takes start positions p and probes the pair of
//     tokens at (p + deltas[0], p + deltas[1]): almost every probe misses
//     after one or two slots, and a hit is almost always a match, whose
//     later terms (p + deltas[k], k >= 2) are checked in the staged row. A
//     full match adds one to the warp's count of (query, row). Overlapping
//     occurrences each count, as the reference's shifted compares count
//     them. (Keyed by the first term alone, every occurrence of a common
//     first term walked a chain of queries in dependent shared-memory
//     loads: 1.30 ms at B = 64, N = 2^20 on an H100, 7.6x the bound.);
//   * at the run's end each lane takes whole queries: it reads the query's
//     kRun counts, computes the scores (every operation rounded on its own,
//     in freq_score's order) and writes the run as one 32-byte sector of
//     scores and 8 mask bytes — full sectors, few instructions.
// A batch of more than kMaxGroup queries is cut into query groups (grid y).
// Numerics: __fmul_rn / __fadd_rn / __fdiv_rn, no FMA contraction, no fast
// math, so the result is bit-identical to the plain PyTorch version on the
// card.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRun = 8;              // consecutive rows a warp scores at once
constexpr int kStride = kRun + 1;    // staging stride: conflict-free
constexpr int kMaxTerms = 32;        // phrase terms (ops/phrase.MAX_TERMS)
constexpr int kMaxGroup = 64;        // queries per block
constexpr int kStageWin = 3;         // 32-position windows staged a row
constexpr int kStagePos = kStageWin * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;  // no (term, term) key
// The limit each launch sets is the most any call may take (sm_90's opt-in
// shared memory a block), not this call's size: shards call from several
// threads, and a smaller limit set by another thread between this call's
// setting and its launch would refuse the launch.
constexpr int kSmemOptIn = 232448;

struct Deltas {
  int d[kMaxTerms];
};

// Shared-memory layout, computed alike on the host (for its size) and in the
// kernel. Per block: the (first, second term) table (keys, chain heads), the
// chain links, the group's terms, sum_idf and avgdl, the deltas; per warp: the
// run's staged rows and its count per (query, row).
struct Layout {
  int qg, hbits;
  int off_key, off_head, off_next, off_qt, off_idf, off_avg, off_delta,
      off_run, off_freq, bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int n_queries, int n_terms) {
  Layout l;
  l.qg = n_queries < kMaxGroup ? n_queries : kMaxGroup;
  int hbits = 5;  // at least twice as many table slots as queries
  while ((1 << hbits) < 2 * l.qg) ++hbits;
  l.hbits = hbits;
  const int h = 1 << hbits;
  int o = 0;
  l.off_key = o;   o = align16(o + h * 8);
  l.off_head = o;  o = align16(o + h * 4);
  l.off_next = o;  o = align16(o + l.qg * 4);
  l.off_qt = o;    o = align16(o + l.qg * n_terms * 4);
  l.off_idf = o;   o = align16(o + l.qg * 4);
  l.off_avg = o;   o = align16(o + l.qg * 4);
  l.off_delta = o; o = align16(o + kMaxTerms * 4);
  l.off_run = o;   o = align16(o + kWarps * kRun * kStagePos * 4);
  l.off_freq = o;  o = align16(o + kWarps * l.qg * kStride * 4);
  l.bytes = o;
  return l;
}

// a phrase's key: its first two terms (the second is 0 for a one-term
// phrase); terms are >= 0, so no key equals kEmpty
__device__ __forceinline__ unsigned long long pair_key(int32_t t0,
                                                       int32_t t1) {
  return ((unsigned long long)(uint32_t)t0 << 32) | (uint32_t)t1;
}

__device__ __forceinline__ uint32_t slot_hash(int32_t t0, int32_t t1,
                                              int hbits) {
  return ((uint32_t)t0 * 0x9E3779B1u ^ (uint32_t)t1 * 0x85EBCA77u) >>
         (32 - hbits);
}

__global__ void __launch_bounds__(kThreads)
phrase_scan_kernel(const int32_t* __restrict__ tokens,
                   const int32_t* __restrict__ extent,
                   const int32_t* __restrict__ doc_len, int n_docs,
                   int n_pos, const int32_t* __restrict__ qtids,
                   int n_queries, int n_terms, Deltas deltas,
                   const float* __restrict__ sum_idf,
                   const float* __restrict__ avgdl, float k1, float k1p1,
                   float omb, float b, float* __restrict__ scores,
                   uint8_t* __restrict__ mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(n_queries, n_terms);
  const int qg = L.qg;
  const int hbits = L.hbits;
  const int hsize = 1 << hbits;
  const uint32_t hmask = (uint32_t)hsize - 1u;
  unsigned long long* s_key =
      reinterpret_cast<unsigned long long*>(smem + L.off_key);
  int32_t* s_head = reinterpret_cast<int32_t*>(smem + L.off_head);
  int32_t* s_next = reinterpret_cast<int32_t*>(smem + L.off_next);
  int32_t* s_qt = reinterpret_cast<int32_t*>(smem + L.off_qt);   // [q][k]
  float* s_idf = reinterpret_cast<float*>(smem + L.off_idf);
  float* s_avg = reinterpret_cast<float*>(smem + L.off_avg);
  int32_t* s_delta = reinterpret_cast<int32_t*>(smem + L.off_delta);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* my_run = reinterpret_cast<int32_t*>(smem + L.off_run) +
                    warp * kRun * kStagePos;                      // [r][x]
  int32_t* my_freq = reinterpret_cast<int32_t*>(smem + L.off_freq) +
                     warp * qg * kStride;                         // [q][r]

  const int q0 = blockIdx.y * qg;
  const int nq = min(qg, n_queries - q0);

  // ---- the group's (first, second term) table ---------------------------
  for (int i = threadIdx.x; i < hsize; i += kThreads) {
    s_key[i] = kEmpty;
    s_head[i] = -1;
  }
  for (int i = threadIdx.x; i < nq * n_terms; i += kThreads)
    s_qt[i] = qtids[(int64_t)q0 * n_terms + i];
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    s_idf[q] = sum_idf[q0 + q];
    s_avg[q] = avgdl[q0 + q];
  }
  for (int k = threadIdx.x; k < kMaxTerms; k += kThreads)
    s_delta[k] = k < n_terms ? deltas.d[k] : 0;
  for (int i = threadIdx.x; i < kWarps * qg * kStride; i += kThreads)
    reinterpret_cast<int32_t*>(smem + L.off_freq)[i] = 0;
  __syncthreads();
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    bool present = true;
    for (int k = 0; k < n_terms; ++k)
      present = present && s_qt[q * n_terms + k] >= 0;
    s_next[q] = -1;
    if (present) {
      const int32_t t0 = s_qt[q * n_terms];
      const int32_t t1 = n_terms > 1 ? s_qt[q * n_terms + 1] : 0;
      const unsigned long long key = pair_key(t0, t1);
      uint32_t h = slot_hash(t0, t1, hbits);
      for (;;) {
        const unsigned long long prev = atomicCAS(&s_key[h], kEmpty, key);
        if (prev == kEmpty || prev == key) break;
        h = (h + 1u) & hmask;
      }
      s_next[q] = atomicExch(&s_head[h], q);
    }
  }
  __syncthreads();
  const int delta0 = s_delta[0];
  const int delta1 = s_delta[1];
  const bool two = n_terms > 1;
  const bool whole_runs = (n_docs & (kRun - 1)) == 0;

  // ---- this warp's runs of rows -------------------------------------------
  const int runs = (n_docs + kRun - 1) / kRun;
  const int run_step = gridDim.x * kWarps;
  int run = blockIdx.x * kWarps + warp;
  // the run's extents and lengths, one row per lane
  int r_ext = 0, r_dl = 0;
  if (run < runs && lane < min(kRun, n_docs - run * kRun)) {
    r_ext = extent[run * kRun + lane];
    r_dl = doc_len[run * kRun + lane];
  }
  for (; run < runs; run += run_step) {
    const int d0 = run * kRun;
    const int rows = min(kRun, n_docs - d0);
    const int32_t* run_tok = tokens + (int64_t)d0 * n_pos;
    // every row's first kStagePos positions, all copies in flight together
    // (a staged position at or past the row's extent is never read)
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int ext = __shfl_sync(kFull, r_ext, r);
#pragma unroll
      for (int w = 0; w < kStageWin; ++w) {
        const int x = w * 32 + lane;
        if (x < ext)
          __pipeline_memcpy_async(&my_run[r * kStagePos + x],
                                  &run_tok[(int64_t)r * n_pos + x], 4);
      }
    }
    __pipeline_commit();
    // the next run's extents and lengths, in flight while this one is
    // scanned
    int n_ext = 0, n_dl = 0;
    const int next = run + run_step;
    if (next < runs && lane < min(kRun, n_docs - next * kRun)) {
      n_ext = extent[next * kRun + lane];
      n_dl = doc_len[next * kRun + lane];
    }
    __pipeline_wait_prior(0);
    __syncwarp();

    // ---- count every query's occurrences in each row of the run ---------
    for (int r = 0; r < rows; ++r) {
      const int ext = __shfl_sync(kFull, r_ext, r);
      const int32_t* srow = my_run + r * kStagePos;
      const int32_t* grow = run_tok + (int64_t)r * n_pos;
      auto tok = [&](int x) -> int32_t {
        return x < ext ? (x < kStagePos ? srow[x] : grow[x]) : -1;
      };
      for (int p = lane; p < ext; p += 32) {
        const int32_t x0 = tok(p + delta0);
        const int32_t x1 = two ? tok(p + delta1) : 0;
        if (x0 < 0 || x1 < 0) continue;
        const unsigned long long want = pair_key(x0, x1);
        uint32_t h = slot_hash(x0, x1, hbits);
        for (;;) {
          const unsigned long long key = s_key[h];
          if (key == want) {
            for (int q = s_head[h]; q >= 0; q = s_next[q]) {
              const int32_t* qt = s_qt + q * n_terms;
              bool all = true;
              for (int k = 2; k < n_terms && all; ++k)
                all = tok(p + s_delta[k]) == qt[k];
              if (all) atomicAdd(&my_freq[q * kStride + r], 1);
            }
            break;
          }
          if (key == kEmpty) break;
          h = (h + 1u) & hmask;
        }
      }
    }
    __syncwarp();

    // ---- score and write the run: a lane a query, kRun entries each ------
    float dl[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r) dl[r] = (float)__shfl_sync(kFull, r_dl, r);
    for (int q = lane; q < nq; q += 32) {
      const float avg = s_avg[q];
      const float idf = s_idf[q];
      float sc[kRun];
      uint32_t mk[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const int f = my_freq[q * kStride + r];
        my_freq[q * kStride + r] = 0;
        float score = 0.0f;
        if (f > 0) {
          const float ff = (float)f;
          const float norm = __fmul_rn(
              k1, __fadd_rn(omb, __fdiv_rn(__fmul_rn(b, dl[r]), avg)));
          const float tfn =
              __fdiv_rn(__fmul_rn(ff, k1p1), __fadd_rn(ff, norm));
          score = __fmul_rn(idf, tfn);
        }
        sc[r] = score;
        mk[r] = f > 0 ? 1u : 0u;
      }
      const int64_t at = (int64_t)(q0 + q) * n_docs + d0;
      if (whole_runs) {
        // d0 and n_docs are multiples of kRun = 8: aligned vector stores
        float4* dst = reinterpret_cast<float4*>(scores + at);
        dst[0] = make_float4(sc[0], sc[1], sc[2], sc[3]);
        dst[1] = make_float4(sc[4], sc[5], sc[6], sc[7]);
        *reinterpret_cast<uint2*>(mask + at) =
            make_uint2(mk[0] | mk[1] << 8 | mk[2] << 16 | mk[3] << 24,
                       mk[4] | mk[5] << 8 | mk[6] << 16 | mk[7] << 24);
      } else {
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
          if (r < rows) {
            scores[at + r] = sc[r];
            mask[at + r] = (uint8_t)mk[r];
          }
        }
      }
    }
    __syncwarp();
    r_ext = n_ext;
    r_dl = n_dl;
  }
}

}  // namespace

// `deltas` is a HOST array of n_terms non-negative position offsets.
extern "C" int phrase_scan_launch(const void* tokens, const void* extent,
                                  const void* doc_len, int n_docs, int n_pos,
                                  const void* qtids, int n_queries,
                                  int n_terms, const void* deltas,
                                  const void* sum_idf, const void* avgdl,
                                  float k1, float k1p1, float omb, float b,
                                  void* scores, void* mask, void* stream) {
  if (n_docs <= 0 || n_pos <= 0 || n_queries <= 0 || n_terms <= 0 ||
      n_terms > kMaxTerms || deltas == nullptr)
    return (int)cudaErrorInvalidValue;
  Deltas d = {};
  for (int k = 0; k < n_terms; ++k) {
    d.d[k] = static_cast<const int*>(deltas)[k];
    if (d.d[k] < 0) return (int)cudaErrorInvalidValue;
  }
  const Layout l = make_layout(n_queries, n_terms);
  cudaError_t err = cudaFuncSetAttribute(
      phrase_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, phrase_scan_kernel, kThreads, l.bytes);
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
  phrase_scan_kernel<<<grid, kThreads, l.bytes, (cudaStream_t)stream>>>(
      (const int32_t*)tokens, (const int32_t*)extent,
      (const int32_t*)doc_len, n_docs, n_pos, (const int32_t*)qtids,
      n_queries, n_terms, d, (const float*)sum_idf, (const float*)avgdl, k1,
      k1p1, omb, b, (float*)scores, (uint8_t*)mask);
  return (int)cudaGetLastError();
}

extern "C" const char* phrase_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
