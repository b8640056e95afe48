// K4: batched cosine over an int8-quantized vector column.
//
// Replaces elasticsearch_tpu/ops/vector.py:cosine_scores_int8_batch as the
// knn lane runs it (search/jit_exec.py:run_knn_hybrid_batch, a dense_vector
// field under `index.knn.quantization: int8`): for each query b of a batch
// and each doc row n,
//
//   dot(b, n)   = sum over d of qn[b, d] * float(qvecs[n, d])
//   out[b, n]   = (dot * scale) + (offset * qsum[b])   where exists[n]
//               = 0                                     elsewhere
//
// qn is the L2-normalized query [B, D] f32 and qsum[b] its component sum,
// both made by the wrapper (ops/vector.py); scale and offset are the
// segment's quantization snapshot (index/segment.py:quantize_vectors). The
// dequantized dot expands to scale * (qint . qn) + offset * sum(qn), so the
// column stays int8 in device memory.
//
// What bounds it on an H100: operations. 2 * B * N * D flops on the CUDA
// cores against ~N * D bytes of column (at B = 64, N = 2^20, D = 768: 103
// GFLOP, 1.54 ms at the f32 rate of 67 TFLOP/s, against 0.32 ms of bytes).
// The plain version (ops/vector.py) writes a float copy of the whole column
// (4x its bytes) before the product; this kernel reads each int8 row once per
// batch and never writes a float copy:
//   * a block owns a tile of 128 docs and 64 queries (grid y covers batches
//     of more than 64) and walks D in steps of 32: each step the tile's 128 x
//     32 int8 values are read with 16-byte loads, converted to float once and
//     stored transposed in shared memory beside the 64 x 32 query values, and
//     the next step's loads are in flight (in registers) while this step is
//     multiplied;
//   * each of the 256 threads keeps a 4 x 8 register tile of f32 sums (fused
//     multiply-adds in ascending d), reading its operands as float4 from
//     shared memory;
//   * the epilogue applies * scale, then + offset * qsum[b], then the exists
//     select, each operation rounded on its own (__fmul_rn, __fadd_rn), in
//     the reference's order.
// The sums over D are taken in another order than the plain version's matrix
// product, so the two agree to float rounding, not bit for bit.
//
// Later work: the int8 values are exact in bf16, so a query split into two
// or three bf16 terms would put the product on the tensor cores (wgmma) at
// f32 accuracy; this first design stays on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;    // queries per block tile
constexpr int kBN = 128;   // docs per block tile
constexpr int kBK = 32;    // depth per step
constexpr int kThreads = 256;

// 16 int8 values (one 16-byte load) → 16 floats
__device__ __forceinline__ void unpack16(int4 v, float* out) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[i * 4 + j] = (float)(int8_t)((uint32_t)w[i] >> (8 * j));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_cosine_kernel(const int8_t* __restrict__ qvecs,
                   const float* __restrict__ qn,
                   const float* __restrict__ qsum,
                   const uint8_t* __restrict__ exists, int n_docs, int dims,
                   int n_queries, float scale, float offset,
                   float* __restrict__ out) {
  __shared__ __align__(16) float s_q[kBK][kBM];
  __shared__ __align__(16) float s_d[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long n0 = (long long)blockIdx.x * kBN;
  const int b0 = blockIdx.y * kBM;
  // loaders: a doc row's 32-byte step in two 16-byte halves; a query row's
  // 32 floats in four 8-float quarters
  const int d_row = tid >> 1, d_k = (tid & 1) * 16;
  const int q_row = tid >> 2, q_k = (tid & 3) * 8;
  const long long dn = n0 + d_row;
  const bool d_ok = dn < n_docs;
  const int qb = b0 + q_row;
  const bool q_ok = qb < n_queries;
  const int8_t* d_src = qvecs + (d_ok ? dn : 0) * (long long)dims;
  const float* q_src = qn + (long long)(q_ok ? qb : 0) * dims;

  float d_reg[16];
  float q_reg[8];
  auto load = [&](int k0) {
    const int kd = k0 + d_k;
    if (kVec) {
      int4 v = make_int4(0, 0, 0, 0);
      if (d_ok && kd < dims)   // dims % 16 == 0: all 16 in range
        v = *reinterpret_cast<const int4*>(d_src + kd);
      unpack16(v, d_reg);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        d_reg[j] = (d_ok && kd + j < dims) ? (float)d_src[kd + j] : 0.0f;
    }
    const int kq = k0 + q_k;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      q_reg[j] = (q_ok && kq + j < dims) ? q_src[kq + j] : 0.0f;
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < 16; ++j) s_d[d_k + j][d_row] = d_reg[j];
#pragma unroll
    for (int j = 0; j < 8; ++j) s_q[q_k + j][q_row] = q_reg[j];
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < dims; k0 += kBK) {
    const bool more = k0 + kBK < dims;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&s_q[kk][ty * 4]);
      const float4 c0 = *reinterpret_cast<const float4*>(&s_d[kk][tx * 4]);
      const float4 c1 =
          *reinterpret_cast<const float4*>(&s_d[kk][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  // epilogue: * scale, + offset * qsum[b], the exists select
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    if (b >= n_queries) continue;
    const float oq = __fmul_rn(offset, qsum[b]);
    float* row = out + (long long)b * n_docs;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long n = n0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long nj = n + j;
        v[j] = (nj < n_docs && exists[nj])
                   ? __fadd_rn(__fmul_rn(acc[i][h * 4 + j], scale), oq)
                   : 0.0f;
      }
      if ((n_docs & 3) == 0 && n + 3 < n_docs) {
        *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < n_docs) row[n + j] = v[j];
      }
    }
  }
}

}  // namespace

extern "C" int int8_cosine_launch(const void* qvecs, const void* qn,
                                  const void* qsum, const void* exists,
                                  int n_docs, int dims, int n_queries,
                                  float scale, float offset, void* out,
                                  void* stream) {
  if (n_docs <= 0 || dims <= 0 || n_queries <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n_docs + kBN - 1) / kBN),
            (unsigned)((n_queries + kBM - 1) / kBM));
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  const bool vec = (dims % 16 == 0) &&
                   ((reinterpret_cast<uintptr_t>(qvecs) & 15) == 0);
  if (vec)
    int8_cosine_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)qvecs, (const float*)qn, (const float*)qsum,
        (const uint8_t*)exists, n_docs, dims, n_queries, scale, offset,
        (float*)out);
  else
    int8_cosine_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)qvecs, (const float*)qn, (const float*)qsum,
        (const uint8_t*)exists, n_docs, dims, n_queries, scale, offset,
        (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* int8_cosine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
