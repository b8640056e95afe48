// K5: batched MaxSim (late interaction) over a rank_vectors column, f32 and
// int8.
//
// Replaces elasticsearch_tpu/ops/maxsim.py:maxsim_scores_batch_body (f32
// tokens) and maxsim_scores_int8_batch_body (int8 tokens) as the knn lane
// runs them (search/jit_exec.py:run_knn_hybrid_batch on a rank_vectors
// field): for each query b of a batch, each of its tokens i and each doc n,
//
//   sim(b, i, n, j) = sum over d of qs[b, i, d] * float(toks[n, j, d])
//   m(b, i, n)      = max over j < lens[n] of sim       (-inf: no tokens)
//   int8 only:  m   = (m * scale) + (offset * qsum[b, i])
//   m               = 0 where m is not finite (a doc with no tokens)
//   out[b, n]       = sum over i with qmask[b, i] of m, i ascending
//
// qs holds L2-normalized query tokens [B, Qt, D] f32 (padding tokens zero,
// qmask False); toks the column's tokens [N, T, D] (f32 normalized per token,
// or int8 with the segment's scale/offset snapshot, whose affine correction
// is constant over j and scale >= 0, so the max runs on the raw dots); qsum
// the query tokens' component sums. Only [B, N] is written.
//
// What bounds it on an H100: operations, 2 * B * Qt * N * T * D flops (at
// B = 64, Qt = 32, N = 2^17, T = 32, D = 128: 2.2 TFLOP, ~33 ms at the f32
// CUDA-core rate of 67 TFLOP/s), against ~N * T * D column bytes. Written out
// in torch, the reference's einsum builds [B, N, Qt, 16] per block of doc
// tokens (34 GB at those shapes). Here the score is a matrix product with a
// reduction in its epilogue, and nothing but [B, N] reaches device memory:
//   * the query tokens of the batch, flattened to rows [B * Qt, D], and the
//     doc tokens, flattened to columns [N * T, D], are cut into tiles of 128
//     rows (whole queries: 128 / Qt of them) and 128 columns (whole docs:
//     128 / T of them); a block computes one tile pair, walking D in steps
//     of 16 with the next step's loads in flight (registers) while this step
//     is multiplied from shared memory (int8 tokens converted to float once,
//     as they are stored). Blocks are ordered query tile fastest, so the
//     blocks that read one tile of doc tokens run together and find it in L2;
//   * each of the 256 threads keeps an 8 x 8 register tile of f32 sums (fused
//     multiply-adds in ascending d);
//   * the epilogue stages the 128 x 128 tile of dots in shared memory, takes
//     each (query token, doc) maximum over the doc's real tokens, then each
//     (query, doc) sum over the query's unmasked tokens in ascending order,
//     every operation rounded on its own (__fmul_rn, __fadd_rn). A query of
//     more than 128 tokens spans several row tiles and a doc of more than
//     128 tokens several column tiles, walked in order inside the block with
//     the running max and sum kept in shared memory.
// The sums over D are taken in another order than the plain version's matrix
// product, so the two agree to float rounding, not bit for bit; the sum over
// query tokens runs in the same order in both.
//
// Later work: as for K4 (csrc/int8_cosine.cu), the int8 tokens are exact in
// bf16 and a query split into two or three bf16 terms would put the product
// on the tensor cores; this first design stays on the CUDA cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;   // rows (query tokens) and columns (doc tokens)
constexpr int kBK = 16;      // depth per step
constexpr int kThreads = 256;
constexpr int kCStride = kTile + 4;   // the dot tile's row stride (floats)

struct Geometry {
  int qb, row_chunks;   // queries per row tile; row tiles per query
  int nd, col_chunks;   // docs per column tile; column tiles per doc
  long long q_groups, d_groups;
};

__host__ __device__ inline Geometry make_geometry(int n_docs, int t_doc,
                                                  int n_queries, int q_tok) {
  Geometry g;
  g.qb = q_tok <= kTile ? kTile / q_tok : 1;
  g.row_chunks = q_tok <= kTile ? 1 : (q_tok + kTile - 1) / kTile;
  g.nd = t_doc <= kTile ? kTile / t_doc : 1;
  g.col_chunks = t_doc <= kTile ? 1 : (t_doc + kTile - 1) / kTile;
  g.q_groups = (n_queries + g.qb - 1) / g.qb;
  g.d_groups = (n_docs + g.nd - 1) / g.nd;
  return g;
}

constexpr int kSmemBytes =
    (2 * kBK * kTile + kTile * kCStride + 3 * kTile) * (int)sizeof(float);

// loads of one thread's kLoad consecutive values of a token row into floats
constexpr int kLoad = kBK * kTile / kThreads;   // 8

template <typename T, bool kVec>
struct Loader;

template <bool kVec>
struct Loader<float, kVec> {
  __device__ __forceinline__ static void load(const float* src, bool ok,
                                              int k, int dims, float* out) {
    if (kVec) {   // dims % 4 == 0: a float4 is all in range or all out
#pragma unroll
      for (int v = 0; v < kLoad / 4; ++v) {
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (ok && k + 4 * v < dims)
          x = *reinterpret_cast<const float4*>(src + k + 4 * v);
        out[4 * v] = x.x;
        out[4 * v + 1] = x.y;
        out[4 * v + 2] = x.z;
        out[4 * v + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLoad; ++j)
        out[j] = (ok && k + j < dims) ? src[k + j] : 0.0f;
    }
  }
};

template <bool kVec>
struct Loader<int8_t, kVec> {
  __device__ __forceinline__ static void load(const int8_t* src, bool ok,
                                              int k, int dims, float* out) {
    if (kVec) {   // dims % 8 == 0: the 8 bytes are all in range or all out
      int2 v = make_int2(0, 0);
      if (ok && k < dims) v = *reinterpret_cast<const int2*>(src + k);
      const int w[2] = {v.x, v.y};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out[i * 4 + j] = (float)(int8_t)((uint32_t)w[i] >> (8 * j));
    } else {
#pragma unroll
      for (int j = 0; j < kLoad; ++j)
        out[j] = (ok && k + j < dims) ? (float)src[k + j] : 0.0f;
    }
  }
};

template <typename TD, bool kVec, bool kInt8>
__global__ void __launch_bounds__(kThreads, 2)
maxsim_kernel(const TD* __restrict__ toks, const int32_t* __restrict__ lens,
              const float* __restrict__ qs, const uint8_t* __restrict__ qmask,
              const float* __restrict__ qsum, int n_docs, int t_doc,
              int dims, int n_queries, int q_tok, float scale, float offset,
              float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;                          // [kBK][kTile] query rows
  float* s_b = s_a + kBK * kTile;             // [kBK][kTile] doc columns
  float* s_c = s_b + kBK * kTile;             // [kTile][kCStride] dots
  float* s_rm = s_c + kTile * kCStride;       // [kTile] running max
  float* s_ss = s_rm + kTile;                 // [kTile] running sums
  int* s_len = reinterpret_cast<int*>(s_ss + kTile);   // [kTile] lens

  const Geometry g = make_geometry(n_docs, t_doc, n_queries, q_tok);
  const long long blk = blockIdx.x;
  const int b0 = (int)(blk % g.q_groups) * g.qb;
  const long long n0 = (blk / g.q_groups) * g.nd;
  const int qb_eff = min(g.qb, n_queries - b0);
  const int nd_eff = (int)min((long long)g.nd, n_docs - n0);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int ld_row = tid & (kTile - 1);     // the row / column this thread
  const int ld_k = (tid >> 7) * kLoad;      // loads, and its half of a step

  for (int d = tid; d < nd_eff; d += kThreads)
    s_len[d] = min(lens[n0 + d], t_doc);

  for (int rc = 0; rc < g.row_chunks; ++rc) {
    // the row tile: whole queries, or a 128-token slice of one query
    const long long row0 = (long long)b0 * q_tok + (long long)rc * kTile;
    const int rows = g.row_chunks == 1 ? qb_eff * q_tok
                                       : min(kTile, q_tok - rc * kTile);
    const bool a_ok = ld_row < rows;
    const float* a_src = qs + (row0 + (a_ok ? ld_row : 0)) * dims;
    for (int cc = 0; cc < g.col_chunks; ++cc) {
      // the column tile: whole docs, or a 128-token slice of one doc
      const long long col0 = n0 * t_doc + (long long)cc * kTile;
      const int cols = g.col_chunks == 1 ? nd_eff * t_doc
                                         : min(kTile, t_doc - cc * kTile);
      const bool b_ok = ld_row < cols;
      const TD* b_src = toks + (col0 + (b_ok ? ld_row : 0)) * dims;

      float a_reg[kLoad], b_reg[kLoad];
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

      Loader<float, kVec>::load(a_src, a_ok, ld_k, dims, a_reg);
      Loader<TD, kVec>::load(b_src, b_ok, ld_k, dims, b_reg);
#pragma unroll
      for (int j = 0; j < kLoad; ++j) {
        s_a[(ld_k + j) * kTile + ld_row] = a_reg[j];
        s_b[(ld_k + j) * kTile + ld_row] = b_reg[j];
      }
      __syncthreads();
      for (int k0 = 0; k0 < dims; k0 += kBK) {
        const bool more = k0 + kBK < dims;
        if (more) {
          Loader<float, kVec>::load(a_src, a_ok, k0 + kBK + ld_k, dims,
                                    a_reg);
          Loader<TD, kVec>::load(b_src, b_ok, k0 + kBK + ld_k, dims, b_reg);
        }
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          const float* ra = s_a + kk * kTile;
          const float* rb = s_b + kk * kTile;
          const float4 a0 = *reinterpret_cast<const float4*>(ra + ty * 4);
          const float4 a1 =
              *reinterpret_cast<const float4*>(ra + 64 + ty * 4);
          const float4 c0 = *reinterpret_cast<const float4*>(rb + tx * 4);
          const float4 c1 =
              *reinterpret_cast<const float4*>(rb + 64 + tx * 4);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
          const float cv[8] = {c0.x, c0.y, c0.z, c0.w,
                               c1.x, c1.y, c1.z, c1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
        }
        __syncthreads();
        if (more) {
#pragma unroll
          for (int j = 0; j < kLoad; ++j) {
            s_a[(ld_k + j) * kTile + ld_row] = a_reg[j];
            s_b[(ld_k + j) * kTile + ld_row] = b_reg[j];
          }
          __syncthreads();
        }
      }

      // the tile of dots to shared memory
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
        float* dst = s_c + r * kCStride;
        *reinterpret_cast<float4*>(dst + tx * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(dst + 64 + tx * 4) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
      __syncthreads();

      // each (query token, doc) maximum over the doc's real tokens
      if (g.col_chunks == 1) {
        for (int p = tid; p < rows * nd_eff; p += kThreads) {
          const int r = p / nd_eff, d = p - r * nd_eff;
          float* src = s_c + r * kCStride + d * t_doc;
          float m = -INFINITY;
          for (int j = 0; j < s_len[d]; ++j) m = fmaxf(m, src[j]);
          src[0] = m;     // in place: this (r, d) alone reads its columns
        }
      } else {
        const int j_lo = cc * kTile;
        const int j_hi = min(s_len[0], j_lo + cols);
        for (int r = tid; r < rows; r += kThreads) {
          const float* src = s_c + r * kCStride;
          float m = cc == 0 ? -INFINITY : s_rm[r];
          for (int j = j_lo; j < j_hi; ++j) m = fmaxf(m, src[j - j_lo]);
          s_rm[r] = m;
        }
      }
      __syncthreads();
    }

    // each (query, doc) sum over the query's unmasked tokens, ascending
    const int queries = g.row_chunks == 1 ? qb_eff : 1;
    const int tok_per_q = g.row_chunks == 1 ? q_tok : rows;
    for (int p = tid; p < queries * nd_eff; p += kThreads) {
      const int q = p / nd_eff, d = p - q * nd_eff;
      const int b = b0 + q;
      float s = (g.row_chunks == 1 || rc == 0) ? 0.0f : s_ss[d];
      for (int i = 0; i < tok_per_q; ++i) {
        const int r = q * q_tok * (g.row_chunks == 1) + i;
        const long long qi =
            (long long)b * q_tok + (g.row_chunks == 1 ? i : rc * kTile + i);
        float v = g.col_chunks == 1 ? s_c[r * kCStride + d * t_doc]
                                    : s_rm[r];
        if (!isfinite(v))
          v = 0.0f;
        else if (kInt8)
          v = __fadd_rn(__fmul_rn(v, scale), __fmul_rn(offset, qsum[qi]));
        if (qmask[qi]) s = __fadd_rn(s, v);
      }
      if (rc == g.row_chunks - 1)
        out[(long long)b * n_docs + n0 + d] = s;
      else
        s_ss[d] = s;
    }
    __syncthreads();
  }
}

template <typename TD, bool kVec, bool kInt8>
int launch(const void* toks, const void* lens, const void* qs,
           const void* qmask, const void* qsum, int n_docs, int t_doc,
           int dims, int n_queries, int q_tok, float scale, float offset,
           void* out, cudaStream_t stream, long long blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_kernel<TD, kVec, kInt8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  maxsim_kernel<TD, kVec, kInt8><<<(unsigned)blocks, kThreads, kSmemBytes,
                                   stream>>>(
      (const TD*)toks, (const int32_t*)lens, (const float*)qs,
      (const uint8_t*)qmask, (const float*)qsum, n_docs, t_doc, dims,
      n_queries, q_tok, scale, offset, (float*)out);
  return (int)cudaGetLastError();
}

// The grid of one launch, or the CUDA error that refuses it.
int check_grid(int n_docs, int t_doc, int dims, int n_queries, int q_tok,
               long long* blocks) {
  if (n_docs <= 0 || t_doc <= 0 || dims <= 0 || n_queries <= 0 ||
      q_tok <= 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(n_docs, t_doc, n_queries, q_tok);
  *blocks = g.q_groups * g.d_groups;
  if (*blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

}  // namespace

// The two instantiations have an entry point each, so each is bound (and
// its launches counted) on its own.
extern "C" int maxsim_f32_launch(const void* toks, const void* lens,
                                 const void* qs, const void* qmask,
                                 int n_docs, int t_doc, int dims,
                                 int n_queries, int q_tok, void* out,
                                 void* stream) {
  long long blocks;
  const int rc = check_grid(n_docs, t_doc, dims, n_queries, q_tok, &blocks);
  if (rc != 0) return rc;
  const uintptr_t align = reinterpret_cast<uintptr_t>(toks) |
                          reinterpret_cast<uintptr_t>(qs);
  cudaStream_t s = (cudaStream_t)stream;
  if (dims % 4 == 0 && (align & 15) == 0)
    return launch<float, true, false>(toks, lens, qs, qmask, nullptr, n_docs,
                                      t_doc, dims, n_queries, q_tok, 1.0f,
                                      0.0f, out, s, blocks);
  return launch<float, false, false>(toks, lens, qs, qmask, nullptr, n_docs,
                                     t_doc, dims, n_queries, q_tok, 1.0f,
                                     0.0f, out, s, blocks);
}

// int8 tokens: v ~ q*scale + offset per component; qsum [B, Qt] holds each
// query token's component sum.
extern "C" int maxsim_int8_launch(const void* toks, const void* lens,
                                  const void* qs, const void* qmask,
                                  const void* qsum, int n_docs, int t_doc,
                                  int dims, int n_queries, int q_tok,
                                  float scale, float offset, void* out,
                                  void* stream) {
  long long blocks;
  const int rc = check_grid(n_docs, t_doc, dims, n_queries, q_tok, &blocks);
  if (rc != 0) return rc;
  const uintptr_t align = reinterpret_cast<uintptr_t>(toks) |
                          reinterpret_cast<uintptr_t>(qs);
  cudaStream_t s = (cudaStream_t)stream;
  if (dims % 8 == 0 && (align & 15) == 0)
    return launch<int8_t, true, true>(toks, lens, qs, qmask, qsum, n_docs,
                                      t_doc, dims, n_queries, q_tok, scale,
                                      offset, out, s, blocks);
  return launch<int8_t, false, true>(toks, lens, qs, qmask, qsum, n_docs,
                                     t_doc, dims, n_queries, q_tok, scale,
                                     offset, out, s, blocks);
}

extern "C" const char* maxsim_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
