// K11: batched sloppy-phrase scan over one segment's position matrix.
//
// Replaces elasticsearch_tpu/ops/phrase.py:_sloppy_displacement,
// sloppy_phrase_freq and sloppy_phrase_score as the JAX package runs them
// under jax.vmap (search/execute.py:_res_MatchPhraseQuery, slop > 0): for
// each query q of a batch, each doc row d and each start position p,
//
//   term 0 must sit at p + deltas[0];
//   term i > 0 takes its smallest shift s_i in [0, slop] with
//     tokens[d, p + deltas[i] + s_i] == qtids[q, i]   (qtids[q, i] >= 0;
//     a position at or beyond the row's end never matches);
//   a match at p when every term is found and total = sum s_i <= slop;
//   freq(q, d)  = the sum over matching p, in ascending p, of
//                 1 / (1 + total)
//   sum_idf_q   = idfs[q, 0] + idfs[q, 1] + ... in term order (f32)
//   score(q, d) = sum_idf_q * tfn(freq)   as K3's tail (freq_score)
//   mask(q, d)  = freq > 0
//
// These are the JAX body's semantics with its documented deviations from
// Lucene's SloppyPhraseScorer: matches are anchored at term 0 (shift 0),
// out-of-order matches are not found, and a phrase that repeats a term may
// map two query terms onto one position. The deltas and the slop are
// shared by the batch: both are part of the plan signature.
//
// What bounds it on an H100: device-memory bytes, as K3 (csrc/
// phrase_scan.cu), whose design this is: each row's positions up to its
// extent read once per batch, [B,N] scores and a [B,N] mask written. The
// grid runs over runs of rows (persistent blocks, a warp a run of kRun
// rows, the run's first kStagePos positions staged in shared memory with
// cp.async), every query of a group (grid y, <= kMaxGroup) is scored inside
// the block, and the block's prologue builds K3's shared-memory hash table
// keyed by each phrase's first two terms, each slot heading the chain of
// the queries with that pair. A lane takes start positions p and, for each
// shift s in [0, slop], probes the pair of tokens at (p + deltas[0],
// p + deltas[1] + s): almost every probe misses after a slot or two, and
// a hit is a query whose term 1 sits at shift s (a bitmap of the group's
// first terms lets most positions skip the probes). The query is taken there
// only if s is its SMALLEST such shift (no earlier shift holds term 1),
// then its later terms are looked for at their smallest shifts, giving up
// as soon as the shifts so far leave no room in the slop (the search of
// sloppy_shifts.cuh, which K14 shares). (Keyed by the
// first term alone, every occurrence of a common first term walked its
// chain of queries: 4.82 ms at B = 64, N = 2^20, slop 2 on an H100, 6.2x
// K3.)
// The sum over positions is taken in ascending p, as the plain version
// takes it, so the two agree bit for bit: the warp walks the row in
// 32-position windows in order, a ballot marks the lanes whose position
// matches some query, and those lanes add their matches one after another,
// in lane order, to the warp's per-(query, row) sums in shared memory
// (matches are rare, so this costs little). A missing term ends the search
// at that position; no sentinel enters a float sum. Then, as K3, each lane
// takes whole queries and writes the run's scores and mask bytes.
// Numerics: __fmul_rn / __fadd_rn / __fdiv_rn, no FMA contraction, no fast
// math.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sloppy_shifts.cuh"

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
constexpr int kFirstBits = 13;       // the first-term bitmap: 8192 bits
// The limit each launch sets is the most any call may take (sm_90's opt-in
// shared memory a block), not this call's size: calls from several threads
// would otherwise race it.
constexpr int kSmemOptIn = 232448;

struct Deltas {
  int d[kMaxTerms];
};

// Shared-memory layout, computed alike on the host and in the kernel. Per
// block: the (first, second term) table (keys, chain heads), the chain links, the
// group's terms, sum_idf and avgdl, the deltas; per warp: the run's staged
// rows and its sum per (query, row).
struct Layout {
  int qg, hbits;
  int off_key, off_head, off_next, off_first, off_qt, off_idf, off_avg,
      off_delta, off_run, off_freq, bytes;
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
  l.off_first = o; o = align16(o + (1 << kFirstBits) / 8);
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

__device__ __forceinline__ uint32_t first_bit(int32_t t0) {
  return ((uint32_t)t0 * 0x9E3779B1u) >> (32 - kFirstBits);
}

__device__ __forceinline__ uint32_t slot_hash(int32_t t0, int32_t t1,
                                              int hbits) {
  return ((uint32_t)t0 * 0x9E3779B1u ^ (uint32_t)t1 * 0x85EBCA77u) >>
         (32 - hbits);
}

__global__ void __launch_bounds__(kThreads)
sloppy_phrase_kernel(const int32_t* __restrict__ tokens,
                     const int32_t* __restrict__ extent,
                     const int32_t* __restrict__ doc_len, int n_docs,
                     int n_pos, const int32_t* __restrict__ qtids,
                     int n_queries, int n_terms, Deltas deltas, int slop,
                     const float* __restrict__ idfs,
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
  uint32_t* s_first = reinterpret_cast<uint32_t*>(smem + L.off_first);
  int32_t* s_qt = reinterpret_cast<int32_t*>(smem + L.off_qt);   // [q][k]
  float* s_idf = reinterpret_cast<float*>(smem + L.off_idf);
  float* s_avg = reinterpret_cast<float*>(smem + L.off_avg);
  int32_t* s_delta = reinterpret_cast<int32_t*>(smem + L.off_delta);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* my_run = reinterpret_cast<int32_t*>(smem + L.off_run) +
                    warp * kRun * kStagePos;                      // [r][x]
  float* my_freq = reinterpret_cast<float*>(smem + L.off_freq) +
                   warp * qg * kStride;                           // [q][r]

  const int q0 = blockIdx.y * qg;
  const int nq = min(qg, n_queries - q0);

  // ---- the group's first-term table -------------------------------------
  for (int i = threadIdx.x; i < hsize; i += kThreads) {
    s_key[i] = kEmpty;
    s_head[i] = -1;
  }
  for (int i = threadIdx.x; i < (1 << kFirstBits) / 32; i += kThreads)
    s_first[i] = 0u;
  for (int i = threadIdx.x; i < nq * n_terms; i += kThreads)
    s_qt[i] = qtids[(int64_t)q0 * n_terms + i];
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    // the idf sum in term order, in f32, as the reference's device sum
    const float* qi = idfs + (int64_t)(q0 + q) * n_terms;
    float s = qi[0];
    for (int k = 1; k < n_terms; ++k) s = __fadd_rn(s, qi[k]);
    s_idf[q] = s;
    s_avg[q] = avgdl[q0 + q];
  }
  for (int k = threadIdx.x; k < kMaxTerms; k += kThreads)
    s_delta[k] = k < n_terms ? deltas.d[k] : 0;
  for (int i = threadIdx.x; i < kWarps * qg * kStride; i += kThreads)
    reinterpret_cast<float*>(smem + L.off_freq)[i] = 0.0f;
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
      const uint32_t bit = first_bit(t0);
      atomicOr(&s_first[bit >> 5], 1u << (bit & 31));
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
  const int s_max = two ? slop : 0;
  const bool whole_runs = (n_docs & (kRun - 1)) == 0;

  // ---- this warp's runs of rows -------------------------------------------
  const int runs = (n_docs + kRun - 1) / kRun;
  const int run_step = gridDim.x * kWarps;
  int run = blockIdx.x * kWarps + warp;
  int r_ext = 0, r_dl = 0;
  if (run < runs && lane < min(kRun, n_docs - run * kRun)) {
    r_ext = extent[run * kRun + lane];
    r_dl = doc_len[run * kRun + lane];
  }
  for (; run < runs; run += run_step) {
    const int d0 = run * kRun;
    const int rows = min(kRun, n_docs - d0);
    const int32_t* run_tok = tokens + (int64_t)d0 * n_pos;
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
    int n_ext = 0, n_dl = 0;
    const int next = run + run_step;
    if (next < runs && lane < min(kRun, n_docs - next * kRun)) {
      n_ext = extent[next * kRun + lane];
      n_dl = doc_len[next * kRun + lane];
    }
    __pipeline_wait_prior(0);
    __syncwarp();

    // ---- every query's sloppy frequency in each row of the run ----------
    for (int r = 0; r < rows; ++r) {
      const int ext = __shfl_sync(kFull, r_ext, r);
      const int32_t* srow = my_run + r * kStagePos;
      const int32_t* grow = run_tok + (int64_t)r * n_pos;
      auto tok = [&](int x) -> int32_t {
        return x < ext ? (x < kStagePos ? srow[x] : grow[x]) : -1;
      };
      // every query matching at start position p: with `add`, 1 / (1 +
      // total) added to its sum of this row; without, whether any matches
      auto at = [&](int p, bool add) -> bool {
        const int32_t x0 = p < ext ? tok(p + delta0) : -1;
        if (x0 < 0) return false;
        const uint32_t bit = first_bit(x0);
        if (!(s_first[bit >> 5] >> (bit & 31) & 1u)) return false;
        bool any = false;
        for (int sh = 0; sh <= s_max; ++sh) {
          const int at1 = p + delta1 + sh;
          if (two && at1 >= ext) break;
          const int32_t x1 = two ? tok(at1) : 0;
          if (x1 < 0) continue;
          const unsigned long long want = pair_key(x0, x1);
          uint32_t h = slot_hash(x0, x1, hbits);
          int head = -1;
          for (;;) {
            const unsigned long long key = s_key[h];
            if (key == want) { head = s_head[h]; break; }
            if (key == kEmpty) break;
            h = (h + 1u) & hmask;
          }
          if (head < 0) continue;
          // term 1's smallest shift is sh only if no earlier shift holds
          // it (a query found there was taken there)
          bool first = true;
          for (int s2 = 0; s2 < sh && first; ++s2)
            first = tok(p + delta1 + s2) != x1;
          if (!first) continue;
          for (int q = head; q >= 0; q = s_next[q]) {
            const int rest = sloppy_rest_shifts(s_qt + q * n_terms, 2,
                                                n_terms, s_delta, slop - sh,
                                                p, ext, tok);
            if (rest < 0) continue;
            if (!add) return true;
            float* f = &my_freq[q * kStride + r];
            *f = __fadd_rn(*f, __fdiv_rn(1.0f, __fadd_rn(
                                                   1.0f, (float)(sh + rest))));
            any = true;
          }
        }
        return any;
      };
      // windows in ascending order, so each (query, row) sum takes its
      // positions in ascending order
      for (int w0 = 0; w0 < ext; w0 += 32) {
        const int p = w0 + lane;
        unsigned todo = __ballot_sync(kFull, at(p, false));
        while (todo) {
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          if (lane == src) at(p, true);
          __syncwarp();
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
        const float ff = my_freq[q * kStride + r];
        my_freq[q * kStride + r] = 0.0f;
        float score = 0.0f;
        if (ff > 0.0f) {
          const float norm = __fmul_rn(
              k1, __fadd_rn(omb, __fdiv_rn(__fmul_rn(b, dl[r]), avg)));
          const float tfn =
              __fdiv_rn(__fmul_rn(ff, k1p1), __fadd_rn(ff, norm));
          score = __fmul_rn(idf, tfn);
        }
        sc[r] = score;
        mk[r] = ff > 0.0f ? 1u : 0u;
      }
      const int64_t at = (int64_t)(q0 + q) * n_docs + d0;
      if (whole_runs) {
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

// `deltas` is a HOST array of n_terms non-negative position offsets; idfs
// is [n_queries, n_terms] f32.
extern "C" int sloppy_phrase_launch(const void* tokens, const void* extent,
                                    const void* doc_len, int n_docs,
                                    int n_pos, const void* qtids,
                                    int n_queries, int n_terms,
                                    const void* deltas, int slop,
                                    const void* idfs, const void* avgdl,
                                    float k1, float k1p1, float omb, float b,
                                    void* scores, void* mask, void* stream) {
  if (n_docs <= 0 || n_pos <= 0 || n_queries <= 0 || n_terms <= 0 ||
      n_terms > kMaxTerms || deltas == nullptr || slop < 0)
    return (int)cudaErrorInvalidValue;
  Deltas d = {};
  for (int k = 0; k < n_terms; ++k) {
    d.d[k] = static_cast<const int*>(deltas)[k];
    if (d.d[k] < 0) return (int)cudaErrorInvalidValue;
  }
  const Layout l = make_layout(n_queries, n_terms);
  cudaError_t err = cudaFuncSetAttribute(
      sloppy_phrase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sloppy_phrase_kernel, kThreads, l.bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int groups = (n_queries + l.qg - 1) / l.qg;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const long long blocks_needed =
      ((n_docs + kRun - 1) / kRun + kWarps - 1) / kWarps;
  long long want = (long long)sms * per_sm / groups;
  if (want < 1) want = 1;
  if (want > blocks_needed) want = blocks_needed;
  dim3 grid((unsigned)want, (unsigned)groups);
  sloppy_phrase_kernel<<<grid, kThreads, l.bytes, (cudaStream_t)stream>>>(
      (const int32_t*)tokens, (const int32_t*)extent,
      (const int32_t*)doc_len, n_docs, n_pos, (const int32_t*)qtids,
      n_queries, n_terms, d, slop, (const float*)idfs, (const float*)avgdl,
      k1, k1p1, omb, b, (float*)scores, (uint8_t*)mask);
  return (int)cudaGetLastError();
}

extern "C" const char* sloppy_phrase_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
