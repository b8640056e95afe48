// K14: batched flat span_near scan over one segment's position matrix.
//
// Replaces elasticsearch_tpu/ops/phrase.py:sloppy_phrase_count (in order)
// and span_near_freq_unordered, followed by freq_score, as the JAX package
// runs them under jax.vmap (search/execute.py:_res_SpanNearQuery, every
// clause a span_term): for each query q of a batch (T clause terms, one
// shared slop) and each doc row d,
//
//   in order:  a span at start p when tokens[d, p] == qt[0] and each later
//              term k sits at its smallest shift s_k >= 0 past p + k with
//              s_1 + ... + s_{T-1} <= slop (the in-order search K11 does,
//              sloppy_shifts.cuh); freq = the number of such p;
//   unordered: match(p) when every clause term occurs in
//              tokens[d, p : p + T + slop]; freq = the number of p with
//              match(p) and not match(p - 1) (runs count once);
//   score(q, d) = sum_idf_q * tfn(freq)   (K3's tail: freq_score)
//   mask(q, d)  = freq > 0
//
// A term id < 0 (absent from the segment) matches nowhere, and no term
// matches at or past the row's extent.
//
// What bounds it on an H100: device-memory bytes, as K3 and K11 — each
// row's positions up to its extent read once per batch, [B, N] scores and a
// [B, N] mask written. The design: persistent blocks over runs of kRun rows
// (a warp a run), every query of a group (grid y, <= 64) scored inside the
// block. A warp stages a row's positions in shared memory once; then for
// each query its lanes mark, per position, which clause terms sit there
// (a T-bit mask in shared memory). A query missing a term in the row scores
// 0 at once (the common case); for the others the lanes test their start
// positions — unordered: the or of the masks over the window is full;
// in order: term 0 at p and sloppy_rest_shifts — and a ballot counts them.
// Then each lane takes whole queries and writes the run's kRun scores and
// mask bytes. This is the simple form: each (query, row) pair costs a pass
// over the row's positions.
// Numerics: the counts are integers; the epilogue is __fmul_rn / __fadd_rn /
// __fdiv_rn in freq_score's order, so the kernel is bit-identical to the
// plain PyTorch version on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sloppy_shifts.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kRun = 8;              // consecutive rows a warp scores at once
constexpr int kStride = kRun + 1;    // staging stride: conflict-free
constexpr int kMaxTerms = 32;        // ops/phrase.MAX_TERMS
constexpr int kMaxGroup = 64;        // queries per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemOptIn = 232448;

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Shared memory: per block the group's terms, whether each query has all
// its terms, sum_idf and avgdl, the deltas 0..T-1; per warp a row's
// positions, their term masks and the run's freq per (query, row).
struct Layout {
  int qg, pos_pad, off_qt, off_ok, off_idf, off_avg, off_delta, off_warp,
      warp_bytes, bytes;
};

__host__ __device__ inline Layout make_layout(int n_queries, int n_terms,
                                              int n_pos, int warps) {
  Layout l;
  l.qg = n_queries < kMaxGroup ? n_queries : kMaxGroup;
  l.pos_pad = (n_pos + 31) & ~31;
  int o = 0;
  l.off_qt = o;    o = align16(o + l.qg * n_terms * 4);
  l.off_ok = o;    o = align16(o + l.qg * 4);
  l.off_idf = o;   o = align16(o + l.qg * 4);
  l.off_avg = o;   o = align16(o + l.qg * 4);
  l.off_delta = o; o = align16(o + kMaxTerms * 4);
  l.off_warp = o;
  l.warp_bytes = align16(2 * l.pos_pad * 4 + l.qg * kStride * 4);
  l.bytes = o + warps * l.warp_bytes;
  return l;
}

__global__ void span_near_kernel(const int32_t* __restrict__ tokens,
                                 const int32_t* __restrict__ extent,
                                 const int32_t* __restrict__ doc_len,
                                 int n_docs, int n_pos,
                                 const int32_t* __restrict__ qtids,
                                 int n_queries, int n_terms, int slop,
                                 int in_order,
                                 const float* __restrict__ sum_idf,
                                 const float* __restrict__ avgdl, float k1,
                                 float k1p1, float omb, float b,
                                 float* __restrict__ scores,
                                 uint8_t* __restrict__ mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const Layout L = make_layout(n_queries, n_terms, n_pos, warps);
  const int qg = L.qg;
  int32_t* s_qt = reinterpret_cast<int32_t*>(smem + L.off_qt);   // [q][k]
  int32_t* s_ok = reinterpret_cast<int32_t*>(smem + L.off_ok);
  float* s_idf = reinterpret_cast<float*>(smem + L.off_idf);
  float* s_avg = reinterpret_cast<float*>(smem + L.off_avg);
  int32_t* s_delta = reinterpret_cast<int32_t*>(smem + L.off_delta);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* wbase = smem + L.off_warp + warp * L.warp_bytes;
  int32_t* my_tok = reinterpret_cast<int32_t*>(wbase);
  uint32_t* my_bits = reinterpret_cast<uint32_t*>(wbase + L.pos_pad * 4);
  float* my_freq = reinterpret_cast<float*>(wbase + 2 * L.pos_pad * 4);

  const int q0 = blockIdx.y * qg;
  const int nq = min(qg, n_queries - q0);
  for (int i = threadIdx.x; i < nq * n_terms; i += blockDim.x)
    s_qt[i] = qtids[(int64_t)q0 * n_terms + i];
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    bool ok = true;
    for (int k = 0; k < n_terms; ++k)
      ok = ok && qtids[(int64_t)(q0 + q) * n_terms + k] >= 0;
    s_ok[q] = ok;
    s_idf[q] = sum_idf[q0 + q];
    s_avg[q] = avgdl[q0 + q];
  }
  for (int k = threadIdx.x; k < kMaxTerms; k += blockDim.x) s_delta[k] = k;
  __syncthreads();
  const uint32_t full =
      n_terms == 32 ? 0xffffffffu : ((1u << n_terms) - 1u);
  const int window = n_terms + slop;
  const bool whole_runs = (n_docs & (kRun - 1)) == 0;

  const int runs = (n_docs + kRun - 1) / kRun;
  const int run_step = gridDim.x * warps;
  for (int run = blockIdx.x * warps + warp; run < runs; run += run_step) {
    const int d0 = run * kRun;
    const int rows = min(kRun, n_docs - d0);
    for (int r = 0; r < rows; ++r) {
      const int d = d0 + r;
      const int ext = min(extent[d], n_pos);
      const int32_t* row = tokens + (int64_t)d * n_pos;
      for (int x = lane; x < ext; x += 32) my_tok[x] = row[x];
      __syncwarp();
      auto tok = [&](int x) -> int32_t { return x < ext ? my_tok[x] : -1; };
      for (int q = 0; q < nq; ++q) {
        const int32_t* qt = s_qt + q * n_terms;
        int count = 0;
        if (s_ok[q] && ext > 0) {
          // each position's clause terms, and which terms the row holds
          uint32_t seen = 0u;
          for (int x = lane; x < ext; x += 32) {
            const int32_t t = my_tok[x];
            uint32_t m = 0u;
            for (int k = 0; k < n_terms; ++k)
              m |= (uint32_t)(t == qt[k]) << k;
            my_bits[x] = m;
            seen |= m;
          }
          seen = __reduce_or_sync(kFull, seen);
          __syncwarp();
          if (seen == full) {
            uint32_t carry = 0u;   // match(p - 1) of the previous window
            for (int w0 = 0; w0 < ext; w0 += 32) {
              const int p = w0 + lane;
              bool hit = false;
              if (p < ext) {
                if (in_order) {
                  hit = (my_bits[p] & 1u) &&
                        sloppy_rest_shifts(qt, 1, n_terms, s_delta, slop, p,
                                           ext, tok) >= 0;
                } else {
                  uint32_t m = 0u;
                  const int end = min(p + window, ext);
                  for (int x = p; x < end; ++x) m |= my_bits[x];
                  hit = m == full;
                }
              }
              const uint32_t ballot = __ballot_sync(kFull, hit);
              if (in_order) {
                count += __popc(ballot);
              } else {
                count += __popc(ballot & ~((ballot << 1) | carry));
                carry = ballot >> 31;
              }
            }
          }
          __syncwarp();
        }
        if (lane == 0) my_freq[q * kStride + r] = (float)count;
      }
      __syncwarp();
    }
    __syncwarp();

    // ---- score and write the run: a lane a query, kRun entries each ------
    float dl[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      dl[r] = r < rows ? (float)doc_len[d0 + r] : 0.0f;
    for (int q = lane; q < nq; q += 32) {
      const float avg = s_avg[q];
      const float idf = s_idf[q];
      float sc[kRun];
      uint32_t mk[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const float ff = r < rows ? my_freq[q * kStride + r] : 0.0f;
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
  }
}

}  // namespace

extern "C" int span_near_launch(const void* tokens, const void* extent,
                                const void* doc_len, int n_docs, int n_pos,
                                const void* qtids, int n_queries,
                                int n_terms, int slop, int in_order,
                                const void* sum_idf, const void* avgdl,
                                float k1, float k1p1, float omb, float b,
                                void* scores, void* mask, void* stream) {
  if (n_docs <= 0 || n_pos <= 0 || n_queries <= 0 || n_terms <= 0 ||
      n_terms > kMaxTerms || slop < 0)
    return (int)cudaErrorInvalidValue;
  // as many warps a block as the per-warp row buffers allow
  int warps = kMaxWarps;
  while (warps > 1 &&
         make_layout(n_queries, n_terms, n_pos, warps).bytes > kSmemOptIn)
    --warps;
  const Layout l = make_layout(n_queries, n_terms, n_pos, warps);
  if (l.bytes > kSmemOptIn) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      span_near_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, span_near_kernel, warps * 32, l.bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int groups = (n_queries + l.qg - 1) / l.qg;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const long long blocks_needed =
      ((n_docs + kRun - 1) / kRun + warps - 1) / warps;
  long long want = (long long)sms * per_sm / groups;
  if (want < 1) want = 1;
  if (want > blocks_needed) want = blocks_needed;
  dim3 grid((unsigned)want, (unsigned)groups);
  span_near_kernel<<<grid, warps * 32, l.bytes, (cudaStream_t)stream>>>(
      (const int32_t*)tokens, (const int32_t*)extent,
      (const int32_t*)doc_len, n_docs, n_pos, (const int32_t*)qtids,
      n_queries, n_terms, slop, in_order, (const float*)sum_idf,
      (const float*)avgdl, k1, k1p1, omb, b, (float*)scores, (uint8_t*)mask);
  return (int)cudaGetLastError();
}

extern "C" const char* span_near_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
