// K9: masked double-double statistics of one segment's numeric column, in
// one pass.
//
// Replaces the device reductions of the JAX package's metric collect
// (elasticsearch_tpu/search/aggregations.py _d_count_minmax, _d_metric,
// _d_value_count) over ops/aggs_ops.py dd_min_max, sum_of_squares and
// value_count and the masked sums of hi and lo: where the reference runs
// two extrema reductions and three sums a segment, K9 reads the column
// once and writes one row of eight doubles,
//   count, min_hi, min_lo, max_hi, max_lo, sum(hi), sum(lo), sum(hi * hi),
// over the rows where exists and mask are set. Extrema follow the
// dd_min_max contract: min_hi is the least hi and min_lo the least lo of
// the rows holding it (so (min_hi, min_lo) is the lexicographic minimum),
// the maxima alike; an empty set gives (+inf, +inf) and (-inf, -inf); a
// NaN in hi makes min_hi and max_hi NaN with min_lo +inf and max_lo -inf,
// as jnp.min / jnp.max propagate it; -0.0 and +0.0 compare equal and a zero
// extremum is written as +0.0. The three sums are f32, as the reference's.
// With hi and lo NULL only the count is taken (value_count).
//
// Determinism: no float atomics. Every thread folds a fixed set of rows in
// a fixed order, a block combines its threads by a fixed tree (warp
// shuffles, then shared memory), a second launch of one warp combines the
// block partials in block order: the same inputs give the same bits on
// every run, so an aggregation's sum does not flicker between requests.
//
// Row-batched entry (agg_stats_rows_launch): the collective plane's metric
// lane (elasticsearch_tpu/parallel/mesh_engine.py:1523-1560, the masked
// partials of a [B, N] agg mask) takes every mask row in one launch: grid.y
// is the row, each row cut over exactly the blocks a one-row launch uses,
// so a row's eight values are the bits a one-row launch gives.
//
// What bounds it on an H100: device-memory bytes — hi, lo, exists and mask
// read once (10 B a row, 2.6 MB at 262,144 rows: a bound under 1 us), so
// the two launches' latency sets its time.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;   // two waves of 132 SMs
constexpr unsigned kFull = 0xffffffffu;

struct Acc {
  int count;
  int nan;        // a NaN hi was seen
  float mn_hi, mn_lo, mx_hi, mx_lo;
  float s_hi, s_lo, s_sq;
};

// the caller's scratch holds kMaxBlocks records of kRecordBytes
constexpr int kRecordBytes = 64;
static_assert(sizeof(Acc) <= kRecordBytes, "a block partial outgrew its slot");

__device__ __forceinline__ Acc empty_acc() {
  return Acc{0, 0, CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
             0.f, 0.f, 0.f};
}

// b folded into a (a's rows come first; extrema are order-free)
__device__ __forceinline__ void fold(Acc& a, const Acc& b) {
  a.count += b.count;
  a.nan |= b.nan;
  if (b.mn_hi < a.mn_hi || (b.mn_hi == a.mn_hi && b.mn_lo < a.mn_lo)) {
    a.mn_hi = b.mn_hi;
    a.mn_lo = b.mn_lo;
  }
  if (b.mx_hi > a.mx_hi || (b.mx_hi == a.mx_hi && b.mx_lo > a.mx_lo)) {
    a.mx_hi = b.mx_hi;
    a.mx_lo = b.mx_lo;
  }
  a.s_hi = __fadd_rn(a.s_hi, b.s_hi);
  a.s_lo = __fadd_rn(a.s_lo, b.s_lo);
  a.s_sq = __fadd_rn(a.s_sq, b.s_sq);
}

__device__ __forceinline__ Acc shfl_down(const Acc& a, int o) {
  Acc b;
  b.count = __shfl_down_sync(kFull, a.count, o);
  b.nan = __shfl_down_sync(kFull, a.nan, o);
  b.mn_hi = __shfl_down_sync(kFull, a.mn_hi, o);
  b.mn_lo = __shfl_down_sync(kFull, a.mn_lo, o);
  b.mx_hi = __shfl_down_sync(kFull, a.mx_hi, o);
  b.mx_lo = __shfl_down_sync(kFull, a.mx_lo, o);
  b.s_hi = __shfl_down_sync(kFull, a.s_hi, o);
  b.s_lo = __shfl_down_sync(kFull, a.s_lo, o);
  b.s_sq = __shfl_down_sync(kFull, a.s_sq, o);
  return b;
}

// lane 0 ends with the warp's fold, lanes in order by a fixed tree
__device__ __forceinline__ Acc warp_fold(Acc a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Acc b = shfl_down(a, o);
    fold(a, b);
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
agg_stats_partial_kernel(int64_t n, const float* __restrict__ hi,
                         const float* __restrict__ lo,
                         const uint8_t* __restrict__ exists,
                         const uint8_t* __restrict__ mask,
                         Acc* __restrict__ partials) {
  __shared__ Acc warps[kThreads / 32];
  mask += (int64_t)blockIdx.y * n;             // the row-batched entry's row
  partials += (int64_t)blockIdx.y * gridDim.x;
  Acc a = empty_acc();
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x; row < n;
       row += stride) {
    if (!(mask[row] && exists[row])) continue;
    a.count += 1;
    if (hi == nullptr) continue;
    const float h = hi[row];
    const float l = lo[row];
    if (h != h) {
      a.nan = 1;
    } else {
      if (h < a.mn_hi || (h == a.mn_hi && l < a.mn_lo)) {
        a.mn_hi = h;
        a.mn_lo = l;
      }
      if (h > a.mx_hi || (h == a.mx_hi && l > a.mx_lo)) {
        a.mx_hi = h;
        a.mx_lo = l;
      }
    }
    a.s_hi = __fadd_rn(a.s_hi, h);
    a.s_lo = __fadd_rn(a.s_lo, l);
    a.s_sq = __fadd_rn(a.s_sq, __fmul_rn(h, h));
  }
  a = warp_fold(a);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warps[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = (threadIdx.x < kThreads / 32) ? warps[threadIdx.x] : empty_acc();
    a = warp_fold(a);
    if (threadIdx.x == 0) partials[blockIdx.x] = a;
  }
}

__device__ __forceinline__ float canonical_zero(float v) {
  return v == 0.f ? 0.f : v;
}

// One warp: lane j folds partials j, j + 32, ... in order, then the tree.
__global__ void agg_stats_final_kernel(int blocks,
                                       const Acc* __restrict__ partials,
                                       double* __restrict__ out) {
  partials += (int64_t)blockIdx.x * blocks;    // one warp a row
  out += (int64_t)blockIdx.x * 8;
  Acc a = empty_acc();
  for (int b = threadIdx.x; b < blocks; b += 32) fold(a, partials[b]);
  a = warp_fold(a);
  if (threadIdx.x != 0) return;
  if (a.nan) {
    a.mn_hi = CUDART_NAN_F;
    a.mn_lo = CUDART_INF_F;
    a.mx_hi = CUDART_NAN_F;
    a.mx_lo = -CUDART_INF_F;
  }
  out[0] = (double)a.count;
  out[1] = (double)canonical_zero(a.mn_hi);
  out[2] = (double)a.mn_lo;
  out[3] = (double)canonical_zero(a.mx_hi);
  out[4] = (double)a.mx_lo;
  out[5] = (double)a.s_hi;
  out[6] = (double)a.s_lo;
  out[7] = (double)a.s_sq;
}

}  // namespace

// hi, lo: [n] f32 or both NULL (count only); exists: [n] u8; mask: [rows,
// n] u8 (bool); partials: scratch of rows x kMaxBlocks x kRecordBytes
// bytes; out: [rows, 8] f64.
extern "C" int agg_stats_rows_launch(int rows, long long n, const void* hi,
                                     const void* lo, const void* exists,
                                     const void* mask, void* partials,
                                     void* out, void* stream) {
  if (rows < 0 || rows > 65535 || n < 0 || (hi == nullptr) != (lo == nullptr)
      || exists == nullptr || mask == nullptr || partials == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  agg_stats_partial_kernel<<<dim3((unsigned)blocks, (unsigned)rows), kThreads,
                             0, s>>>(
      n, (const float*)hi, (const float*)lo, (const uint8_t*)exists,
      (const uint8_t*)mask, (Acc*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  agg_stats_final_kernel<<<(unsigned)rows, 32, 0, s>>>(
      (int)blocks, (const Acc*)partials, (double*)out);
  return (int)cudaGetLastError();
}

// One mask row: partials of kMaxBlocks x kRecordBytes bytes; out: [8] f64.
extern "C" int agg_stats_launch(long long n, const void* hi, const void* lo,
                                const void* exists, const void* mask,
                                void* partials, void* out, void* stream) {
  return agg_stats_rows_launch(1, n, hi, lo, exists, mask, partials, out,
                               stream);
}

extern "C" const char* agg_stats_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
