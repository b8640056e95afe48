// K6: batched quantized-impact scan over one segment's impact columns.
//
// Replaces elasticsearch_tpu/ops/blockmax.py:impact_scores as
// eager_segment_topk (blockmax.py:133) runs it under jax.vmap in
// search/jit_exec.py:run_impact_batch: for each query q of a batch and each
// row d,
//
//   qsum(q, d)  = sum of qimp[d,u] over the slots u and query terms t with
//                 uterms[d,u] == qtids[q,t]          (exact integer sum)
//   anyhit(q,d) = at least one such (u, t)
//   sf(q, d)    = f32(qsum) * scale_boost[q]          (the one rounding)
//   valid(q,d)  = anyhit && live[d] && (sf < cs[q] ||
//                 (sf == cs[q] && d + doc_base > cd[q]))
//
// The JAX body packs each hit as (q << 8) | 1 and sums in int32 to get the
// sum and the match count in one reduction; here the count is only ever
// tested against zero, so a flag takes its place. The sum is integer, so its
// order does not matter, and the single f32 multiply (__fmul_rn) is the only
// rounding: the result is bit-identical to the plain PyTorch version by
// construction.
//
// What bounds it on an H100: device-memory bytes. A batch must read each
// row's term ids up to its first pad, the impact of each hit cell, and write
// [B,N] scores and [B,N] valid bytes; there is no float work beyond one
// multiply and a compare per (query, row). The design is K1's
// (csrc/bm25_scan.cu) without the BM25 arithmetic:
//   * the grid runs over the rows only and every query of the batch is
//     scored inside the block, so each [N,U] cell crosses the memory bus once
//     per batch. Blocks are persistent, and each warp walks runs of kRun
//     consecutive rows on its own;
//   * a warp scans a row with its lanes over the row's cells, 32 contiguous
//     cells a load, and stops after the window holding the row's first pad
//     (`trailing_pad`); the next row's first two windows are in flight while
//     the current one is scored;
//   * the block's prologue builds an open-addressing hash table in shared
//     memory of the batch's query terms; a cell probes it, and on a hit the
//     lane reads the cell's impact once and stamps the term's slot for this
//     row with it;
//   * then each lane scores its queries: for each of the query's terms it
//     adds the stamped impact of the term's slot, so a term repeated in a
//     query counts as often as the JAX body counts it;
//   * the warp stages its run's [queries, kRun] results in shared memory and
//     writes kRun contiguous scores and valid bytes per query.
// A batch whose (query, term) pairs exceed one table is cut into query
// groups (grid y). The caller caps the terms a query (255 at 8-bit impacts,
// 127 at 16-bit: validate_impact_settings), so one table holds every term of
// at least one query. Each row must hold a term at most once (the segment
// builder's layout).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRun = 8;              // consecutive rows a warp scores at once
constexpr int kStride = kRun + 1;    // staging stride: conflict-free
constexpr int kMaxSlots = 512;       // (query, term) pairs per table
constexpr int kMaxGroup = 64;        // queries per block
constexpr int kMaxTerms = 255;
constexpr unsigned kFull = 0xffffffffu;
// The limit each launch sets is the most any call may take (sm_90's opt-in
// shared memory a block), not this call's size: shards call from several
// threads, and a smaller limit set by another thread between this call's
// setting and its launch would refuse the launch.
constexpr int kSmemOptIn = 232448;

struct Layout {
  int qg, hbits;
  int off_key, off_slot, off_sb, off_cs, off_cd, off_stamp, off_val,
      off_score, off_valid, bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int n_queries, int n_terms) {
  Layout l;
  int qg = kMaxSlots / n_terms;
  if (qg > kMaxGroup) qg = kMaxGroup;
  if (qg > n_queries) qg = n_queries;
  l.qg = qg;
  int hbits = 5;  // at least twice as many table slots as pairs
  while ((1 << hbits) < 2 * qg * n_terms) ++hbits;
  l.hbits = hbits;
  const int h = 1 << hbits;
  const int pairs = qg * n_terms;
  int o = 0;
  l.off_key = o;   o = align16(o + h * 4);
  l.off_slot = o;  o = align16(o + pairs * 4);
  l.off_sb = o;    o = align16(o + qg * 4);
  l.off_cs = o;    o = align16(o + qg * 4);
  l.off_cd = o;    o = align16(o + qg * 4);
  l.off_stamp = o; o = align16(o + kWarps * h);
  l.off_val = o;   o = align16(o + kWarps * h * 4);
  l.off_score = o; o = align16(o + kWarps * qg * kStride * 4);
  l.off_valid = o; o = align16(o + kWarps * qg * kStride);
  l.bytes = o;
  return l;
}

__device__ __forceinline__ uint32_t slot_hash(int32_t term, int hbits) {
  return ((uint32_t)term * 0x9E3779B1u) >> (32 - hbits);
}

template <typename Q>
__global__ void __launch_bounds__(kThreads)
impact_scan_kernel(const int32_t* __restrict__ uterms,
                   const Q* __restrict__ qimp,
                   const uint8_t* __restrict__ live, int n_docs, int n_unique,
                   const int32_t* __restrict__ qtids, int n_queries,
                   int n_terms, const float* __restrict__ scale_boost,
                   const float* __restrict__ cs,
                   const int32_t* __restrict__ cd, int doc_base,
                   int trailing_pad, float* __restrict__ scores,
                   uint8_t* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(n_queries, n_terms);
  const int qg = L.qg;
  const int hbits = L.hbits;
  const int hsize = 1 << hbits;
  const uint32_t hmask = (uint32_t)hsize - 1u;
  int32_t* s_key = reinterpret_cast<int32_t*>(smem + L.off_key);
  int32_t* s_slot = reinterpret_cast<int32_t*>(smem + L.off_slot);  // [t][q]
  float* s_sb = reinterpret_cast<float*>(smem + L.off_sb);
  float* s_cs = reinterpret_cast<float*>(smem + L.off_cs);
  int32_t* s_cd = reinterpret_cast<int32_t*>(smem + L.off_cd);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint8_t* my_stamp = smem + L.off_stamp + warp * hsize;
  int32_t* my_val = reinterpret_cast<int32_t*>(smem + L.off_val) +
                    warp * hsize;
  float* my_score = reinterpret_cast<float*>(smem + L.off_score) +
                    warp * qg * kStride;                            // [q][r]
  uint8_t* my_valid = smem + L.off_valid + warp * qg * kStride;     // [q][r]

  const int q0 = blockIdx.y * qg;
  const int nq = min(qg, n_queries - q0);
  const int runs = (n_docs + kRun - 1) / kRun;
  const int run_step = gridDim.x * kWarps;
  const bool two = n_unique > 32;

  // ---- the table of this group's (query, term) pairs ----------------------
  for (int i = threadIdx.x; i < hsize; i += kThreads) s_key[i] = -1;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    s_sb[q] = scale_boost[q0 + q];
    s_cs[q] = cs[q0 + q];
    s_cd[q] = cd[q0 + q];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_terms * qg; i += kThreads) {
    const int t = i / qg;
    const int q = i - t * qg;
    int32_t slot = -1;
    if (q < nq) {
      const int32_t term = qtids[(int64_t)(q0 + q) * n_terms + t];
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
  }
  __syncthreads();

  // ---- this warp's runs of rows -------------------------------------------
  int run = blockIdx.x * kWarps + warp;
  int32_t next0 = -1, next1 = -1;
  auto fetch = [&](int64_t d) {
    const int32_t* rt = uterms + d * n_unique;
    next0 = lane < n_unique ? rt[lane] : -1;
    if (two) next1 = 32 + lane < n_unique ? rt[32 + lane] : -1;
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
      const Q* row_q = qimp + (int64_t)d * n_unique;
      int32_t cell = next0;
      const int32_t cell1 = next1;
      if (r + 1 < rows)
        fetch((int64_t)d + 1);
      else if (run + run_step < runs)
        fetch((int64_t)(run + run_step) * kRun);
      const uint8_t stamp = (uint8_t)(r + 1);
      for (int u0 = 0;;) {
        const int u = u0 + lane;
        bool present = cell >= 0;
        bool last = u0 + 32 >= n_unique;
        if (trailing_pad) {
          const unsigned pads = __ballot_sync(kFull, u < n_unique && cell < 0);
          if (pads) {
            present = present && lane < __ffs(pads) - 1;
            last = true;
          }
        }
        if (present) {
          uint32_t h = slot_hash(cell, hbits);
          for (;;) {
            const int32_t key = s_key[h];
            if (key == cell) {
              my_val[h] = (int32_t)row_q[u];
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

      // ---- score the row for each query --------------------------------
      const bool row_live = live[d] != 0;
      const int32_t gid = d + doc_base;
      for (int q = lane; q < nq; q += 32) {
        int32_t qsum = 0;
        bool hit = false;
        for (int t = 0; t < n_terms; ++t) {
          const int32_t slot = s_slot[t * qg + q];
          if (slot < 0 || my_stamp[slot] != stamp) continue;
          qsum += my_val[slot];
          hit = true;
        }
        const float sf = __fmul_rn(__int2float_rn(qsum), s_sb[q]);
        const float c = s_cs[q];
        my_score[q * kStride + r] = sf;
        my_valid[q * kStride + r] =
            (hit && row_live && (sf < c || (sf == c && gid > s_cd[q]))) ? 1
                                                                        : 0;
      }
      __syncwarp();
    }

    // ---- write the run: kRun contiguous words and bytes per query ---------
    for (int i = lane; i < nq * kRun; i += 32) {
      const int q = i / kRun;
      const int r = i - q * kRun;
      if (r < rows) {
        const int64_t at = (int64_t)(q0 + q) * n_docs + d0 + r;
        scores[at] = my_score[q * kStride + r];
        valid[at] = my_valid[q * kStride + r];
      }
    }
    __syncwarp();
  }
}

template <typename Q>
int launch(const void* uterms, const void* qimp, const void* live, int n_docs,
           int n_unique, const void* qtids, int n_queries, int n_terms,
           const void* scale_boost, const void* cs, const void* cd,
           int doc_base, int trailing_pad, void* scores, void* valid,
           cudaStream_t stream) {
  const Layout l = make_layout(n_queries, n_terms);
  cudaError_t err = cudaFuncSetAttribute(
      impact_scan_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, impact_scan_kernel<Q>, kThreads, l.bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int groups = (n_queries + l.qg - 1) / l.qg;
  const long long blocks_needed =
      ((n_docs + kRun - 1) / kRun + kWarps - 1) / kWarps;
  long long want = (long long)sms * per_sm / groups;
  if (want < 1) want = 1;
  if (want > blocks_needed) want = blocks_needed;
  dim3 grid((unsigned)want, (unsigned)groups);
  impact_scan_kernel<Q><<<grid, kThreads, l.bytes, stream>>>(
      (const int32_t*)uterms, (const Q*)qimp, (const uint8_t*)live, n_docs,
      n_unique, (const int32_t*)qtids, n_queries, n_terms,
      (const float*)scale_boost, (const float*)cs, (const int32_t*)cd,
      doc_base, trailing_pad, (float*)scores, (uint8_t*)valid);
  return (int)cudaGetLastError();
}

}  // namespace

// `bits` is 8 (qimp uint8) or 16 (qimp uint16); `live` and `valid` are bool
// bytes.
extern "C" int impact_scan_launch(const void* uterms, const void* qimp,
                                  int bits, const void* live, int n_docs,
                                  int n_unique, const void* qtids,
                                  int n_queries, int n_terms,
                                  const void* scale_boost, const void* cs,
                                  const void* cd, int doc_base,
                                  int trailing_pad, void* scores, void* valid,
                                  void* stream) {
  if (n_docs <= 0 || n_queries <= 0 || n_terms <= 0 || n_unique <= 0 ||
      n_terms > kMaxTerms)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8)
    return launch<uint8_t>(uterms, qimp, live, n_docs, n_unique, qtids,
                           n_queries, n_terms, scale_boost, cs, cd, doc_base,
                           trailing_pad, scores, valid, s);
  if (bits == 16)
    return launch<uint16_t>(uterms, qimp, live, n_docs, n_unique, qtids,
                            n_queries, n_terms, scale_boost, cs, cd, doc_base,
                            trailing_pad, scores, valid, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* impact_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
