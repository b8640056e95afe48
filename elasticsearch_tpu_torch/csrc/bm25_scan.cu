// K1: batched BM25 forward scan over one segment's forward impact columns.
//
// Replaces elasticsearch_tpu/ops/lexical.py:bm25_match as the JAX package
// runs it under jax.vmap (search/jit_exec.py:run_reader_batch): for each
// query q of a batch and each doc row d,
//
//   norm_d      = k1 * ((1 - b) + (b * dl_d) / avgdl_q)
//   tfn(d, u)   = (utf[d,u] * (k1 + 1)) / (utf[d,u] + norm_d)
//   score(q, d) = sum over query terms t, in term order, of
//                 (qidf[q,t] * qweight[q,t]) * tfn(d, u) where uterms[d,u] == qtids[q,t]
//   nmatch(q,d) = number of query terms t with a hit in row d
//
// What bounds it on an H100: device-memory bytes. Each launch must read the
// [N,U] int32 term ids and, on hits only, the matching f32 frequencies, and
// write [B,N] scores and counts; the arithmetic is a handful of flops per hit.
// Design against that bound:
//   * one thread per doc row, one grid column per query; the query index is
//     the FAST grid dimension, so the B blocks that read the same doc tile run
//     together and all but the first are served from L2, which brings the
//     device-memory reads of [N,U] close to once per batch instead of once per
//     query (the read-once-per-batch kernel is still to come: ROADMAP);
//   * rows hold their sorted unique terms first and -1 pads after (the
//     segment builder's layout); with `trailing_pad` the scan stops at the
//     first pad, so a row of ~40 terms costs ~40 reads, not U;
//   * utf is read only for a cell that hits a query term;
//   * the query's terms sit in shared memory, 8 at a time in registers.
// Numerics: every operation is rounded on its own (__fmul_rn / __fadd_rn /
// __fdiv_rn, no FMA contraction, no fast math), in the reference's order, so
// the result is bit-identical to the plain PyTorch version on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;       // query terms held in registers per row pass

__global__ void bm25_scan_kernel(const int32_t* __restrict__ uterms,
                                 const float* __restrict__ utf,
                                 const int32_t* __restrict__ doc_len,
                                 int n_docs, int n_unique,
                                 const int32_t* __restrict__ qtids,
                                 const float* __restrict__ qidf,
                                 const float* __restrict__ qweight,
                                 const float* __restrict__ avgdl,
                                 int n_terms, float k1, float k1p1,
                                 float omb, float b, int trailing_pad,
                                 float* __restrict__ scores,
                                 int32_t* __restrict__ nmatch) {
  extern __shared__ unsigned char smem[];
  int32_t* s_tid = reinterpret_cast<int32_t*>(smem);
  float* s_c = reinterpret_cast<float*>(smem + sizeof(int32_t) * n_terms);
  const int q = blockIdx.x;
  for (int t = threadIdx.x; t < n_terms; t += blockDim.x) {
    s_tid[t] = qtids[(int64_t)q * n_terms + t];
    s_c[t] = __fmul_rn(qidf[(int64_t)q * n_terms + t],
                       qweight[(int64_t)q * n_terms + t]);
  }
  __syncthreads();
  const float avg = avgdl[q];

  for (int64_t d = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; d < n_docs;
       d += (int64_t)gridDim.y * blockDim.x) {
    const int32_t* row_t = uterms + d * n_unique;
    const float* row_f = utf + d * n_unique;
    const float dl = (float)doc_len[d];
    const float norm = __fmul_rn(k1, __fadd_rn(omb, __fdiv_rn(__fmul_rn(b, dl), avg)));
    float score = 0.0f;
    int32_t count = 0;
    for (int t0 = 0; t0 < n_terms; t0 += kChunk) {
      int32_t tid[kChunk];
      float sum[kChunk];
      bool hit[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        tid[j] = (t0 + j < n_terms) ? s_tid[t0 + j] : -1;
        sum[j] = 0.0f;
        hit[j] = false;
      }
      for (int u = 0; u < n_unique; ++u) {
        const int32_t term = row_t[u];
        if (term < 0) {
          if (trailing_pad) break;
          continue;
        }
        bool any = false;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) any |= (tid[j] == term);
        if (!any) continue;
        const float tf = row_f[u];
        const float tfn = __fdiv_rn(__fmul_rn(tf, k1p1), __fadd_rn(tf, norm));
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (tid[j] == term) {
            hit[j] = true;
            sum[j] = __fadd_rn(sum[j], tfn);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (hit[j]) {
          score = __fadd_rn(score, __fmul_rn(s_c[t0 + j], sum[j]));
          ++count;
        }
      }
    }
    scores[(int64_t)q * n_docs + d] = score;
    nmatch[(int64_t)q * n_docs + d] = count;
  }
}

}  // namespace

extern "C" int bm25_scan_launch(const void* uterms, const void* utf,
                                const void* doc_len, int n_docs, int n_unique,
                                const void* qtids, const void* qidf,
                                const void* qweight, const void* avgdl,
                                int n_queries, int n_terms, float k1,
                                float k1p1, float omb, float b,
                                int trailing_pad, void* scores, void* nmatch,
                                void* stream) {
  const int doc_blocks = (n_docs + kThreads - 1) / kThreads;
  dim3 grid(n_queries, doc_blocks < 65535 ? doc_blocks : 65535);
  const size_t smem = (sizeof(int32_t) + sizeof(float)) * (size_t)n_terms;
  bm25_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)uterms, (const float*)utf, (const int32_t*)doc_len,
      n_docs, n_unique, (const int32_t*)qtids, (const float*)qidf,
      (const float*)qweight, (const float*)avgdl, n_terms, k1, k1p1, omb, b,
      trailing_pad, (float*)scores, (int32_t*)nmatch);
  return (int)cudaGetLastError();
}

extern "C" const char* bm25_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
