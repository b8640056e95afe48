// K8: masked bucket counts of one segment for one aggregation.
//
// Replaces three bodies the JAX package's device aggregation collect runs
// per segment (elasticsearch_tpu/search/aggregations.py collect_device):
//   * ordinal mode  — ops/aggs_ops.py ord_value_counts (the terms agg over a
//     keyword column): bucket ords[row, j] for every j < K with ords >= 0;
//   * dd-histogram  — ops/aggs_ops.py histogram_counts_dd (histogram and
//     fixed-interval date_histogram): bucket
//     floor(((hi - base_hi) + (lo - base_lo)) / interval), each operation
//     rounded alone in f32 as XLA does, counted when 0 <= bucket < nb;
//   * ranges        — the per-range ops/filters.py numeric_range + sum of
//     _d_range: a row adds one to every range [from, to) it falls in, by
//     the exact double-double compare ((hi, lo) lexicographic), the upper
//     bound strict unless it is +inf. Ranges may overlap.
// A row counts only where mask (and, for the numeric modes, exists) is set.
// Output: int32 counts[nb], exact, so the order of the atomics is free.
//
// What bounds it on an H100: device-memory bytes — mask, exists, hi, lo (or
// the [N, K] ordinals) read once, nb counts written once: 1-3 MB at a
// 262,144-row segment, a bound near 1 us, so a launch's own latency sets
// its time. Design: a grid-stride pass, one row a thread, neighbouring
// threads on neighbouring rows (coalesced reads of every column). Each
// block counts into a private histogram in shared memory (atomicAdd there),
// then adds its non-zero bins to the global counts with one atomic each.
// When nb bins do not fit the shared histogram (a large keyword
// vocabulary) the rows add straight to the global counts.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 528;         // four waves of 132 SMs
constexpr int kSharedBins = 12288;      // 48 KiB of int32 counts

enum Mode { kOrdinal = 0, kHistogram = 1, kRanges = 2 };

struct Ranges {
  const float* bounds;  // [nr, 4]: from_hi, from_lo, to_hi, to_lo
  const uint8_t* strict;  // [nr]: 1 = the upper bound compares strictly
};

// (hi, lo) >= (qhi, qlo), exact f64 order (ops/filters.py _dd_ge)
__device__ __forceinline__ bool dd_ge(float hi, float lo, float qhi,
                                      float qlo) {
  return hi > qhi || (hi == qhi && lo >= qlo);
}

__device__ __forceinline__ bool dd_lt(float hi, float lo, float qhi,
                                      float qlo) {
  return hi < qhi || (hi == qhi && lo < qlo);
}

__device__ __forceinline__ bool dd_le(float hi, float lo, float qhi,
                                      float qlo) {
  return hi < qhi || (hi == qhi && lo <= qlo);
}

// The reference's bucket index, every operation rounded alone (no
// contraction: the intrinsics are never fused or reassociated). floorf of
// a NaN or of a value past int32 converts as XLA converts: NaN to 0, the
// rest saturated.
__device__ __forceinline__ int dd_bucket(float hi, float lo, float base_hi,
                                         float base_lo, float interval) {
  const float rel = __fadd_rn(__fsub_rn(hi, base_hi), __fsub_rn(lo, base_lo));
  return __float2int_rz(floorf(__fdiv_rn(rel, interval)));
}

template <bool SHARED>
__device__ __forceinline__ void bump(uint32_t* shist, int32_t* counts,
                                     int bin) {
  if (SHARED)
    atomicAdd(&shist[bin], 1u);
  else
    atomicAdd(&counts[bin], 1);
}

template <bool SHARED>
__global__ void __launch_bounds__(kThreads)
agg_counts_kernel(int mode, int64_t n, const uint8_t* __restrict__ mask,
                  const uint8_t* __restrict__ exists,
                  const float* __restrict__ hi, const float* __restrict__ lo,
                  const int32_t* __restrict__ ords, int k, float base_hi,
                  float base_lo, float interval, Ranges ranges, int nb,
                  int32_t* __restrict__ counts) {
  extern __shared__ uint32_t shist[];
  if (SHARED) {
    for (int i = threadIdx.x; i < nb; i += kThreads) shist[i] = 0u;
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x; row < n;
       row += stride) {
    if (!mask[row]) continue;
    if (mode == kOrdinal) {
      for (int j = 0; j < k; ++j) {
        const int32_t o = ords[row * k + j];
        if (o >= 0 && o < nb) bump<SHARED>(shist, counts, o);
      }
      continue;
    }
    if (!exists[row]) continue;
    const float h = hi[row];
    const float l = lo[row];
    if (mode == kHistogram) {
      const int b = dd_bucket(h, l, base_hi, base_lo, interval);
      if (b >= 0 && b < nb) bump<SHARED>(shist, counts, b);
      continue;
    }
    for (int r = 0; r < nb; ++r) {
      const float* q = ranges.bounds + 4 * r;
      const bool below = ranges.strict[r] ? dd_lt(h, l, q[2], q[3])
                                          : dd_le(h, l, q[2], q[3]);
      if (dd_ge(h, l, q[0], q[1]) && below) bump<SHARED>(shist, counts, r);
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += kThreads)
      if (shist[i]) atomicAdd(&counts[i], (int32_t)shist[i]);
  }
}

}  // namespace

// mode 0: ords [n, k] int32 (exists, hi, lo unused); mode 1: hi, lo, exists
// with base_hi, base_lo, interval; mode 2: hi, lo, exists with `bounds`
// [nb, 4] f32 and `strict` [nb] u8 on the device. counts: [nb] int32,
// zeroed here on the stream before the launch.
extern "C" int agg_counts_launch(int mode, long long n, const void* mask,
                                 const void* exists, const void* hi,
                                 const void* lo, const void* ords, int k,
                                 float base_hi, float base_lo, float interval,
                                 const void* bounds, const void* strict,
                                 int nb, void* counts, void* stream) {
  if (mode < kOrdinal || mode > kRanges || n < 0 || nb < 0 ||
      (mode == kOrdinal && (ords == nullptr || k < 1)) ||
      (mode != kOrdinal && (hi == nullptr || lo == nullptr ||
                            exists == nullptr)) ||
      (mode == kRanges && (bounds == nullptr || strict == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(counts, 0, (size_t)nb * sizeof(int32_t), s);
  if (err != cudaSuccess || n == 0 || nb == 0) return (int)err;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const Ranges r{(const float*)bounds, (const uint8_t*)strict};
  if (nb <= kSharedBins) {
    agg_counts_kernel<true><<<(unsigned)blocks, kThreads,
                              (size_t)nb * sizeof(uint32_t), s>>>(
        mode, n, (const uint8_t*)mask, (const uint8_t*)exists,
        (const float*)hi, (const float*)lo, (const int32_t*)ords, k, base_hi,
        base_lo, interval, r, nb, (int32_t*)counts);
  } else {
    agg_counts_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        mode, n, (const uint8_t*)mask, (const uint8_t*)exists,
        (const float*)hi, (const float*)lo, (const int32_t*)ords, k, base_hi,
        base_lo, interval, r, nb, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* agg_counts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
