// K10: the percolator's match reduction, every lane of a call in one launch.
//
// Replaces elasticsearch_tpu/ops/percolate.py:match_reduce_body and
// pack_match_result_body as search/jit_exec.py:run_percolate_lanes applies
// them after the live mask, inside each lane's fused program. A percolate
// call runs many lanes (one probe segment x one same-signature group of
// registered queries); lane l gives scores [B_l, Np] f32 and mask [B_l, Np]
// bool, and its segment a live mask [Np]. For each query row of each lane:
//
//   matched = any(mask & live)
//   best    = the max of the scores where mask & live, or 0.0 if none
//             (a NaN among them gives NaN, as jnp.max propagates it;
//             among zeros +0.0 wins over -0.0, so the result is the same
//             whatever order the lanes of a warp combine in)
//   out[offset_l + row] = (matched ? 1.0 : 0.0, best)
//
// The lanes come as a device table of int64 records (scores, mask and live
// pointers, rows, Np, the lane's first output row), ascending in offset.
//
// What bounds it on an H100: device-memory bytes, the scores and mask read
// once (5 bytes a row cell) and 8 bytes written a query: at 10,000 queries
// x Np = 128 about 6.4 MB, ~2 us at 3.35 TB/s, so one launch's latency sets
// its time. The design is one launch for the whole call (not one a lane)
// and a warp a query row: the warp finds its lane by a binary search of
// the table's offsets, and at Np a multiple of 4 each lane of the warp
// reads 16 bytes of scores and 4 of mask and live at a time (Np = 128, the
// one-doc segment's bucket, is one load each).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWords = 6;  // int64 words of a lane's record
constexpr unsigned kFull = 0xffffffffu;

struct Best {
  bool any;
  bool nan;
  float best;  // -inf until a match
};

// b folded into a: the larger, +0.0 over -0.0
__device__ __forceinline__ void take(Best& a, float v) {
  if (v != v) {
    a.nan = true;
  } else if (v > a.best || (v == a.best && !signbit(v))) {
    a.best = v;
  }
  a.any = true;
}

__device__ __forceinline__ void cell(Best& a, float s, uint32_t m, uint32_t l) {
  if (m && l) take(a, s);
}

__global__ void __launch_bounds__(kThreads)
percolate_reduce_kernel(const long long* __restrict__ table, int n_lanes,
                        long long total_rows, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long g =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= total_rows) return;
  // the last lane whose first output row is at or before g
  int lo = 0, hi = n_lanes - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(table + (long long)mid * kWords + 5) <= g) lo = mid;
    else hi = mid - 1;
  }
  const long long* rec = table + (long long)lo * kWords;
  const float* scores = reinterpret_cast<const float*>(__ldg(rec + 0));
  const uint8_t* mask = reinterpret_cast<const uint8_t*>(__ldg(rec + 1));
  const uint8_t* live = reinterpret_cast<const uint8_t*>(__ldg(rec + 2));
  const long long np = __ldg(rec + 4);
  const long long row = g - __ldg(rec + 5);
  const float* srow = scores + row * np;
  const uint8_t* mrow = mask + row * np;

  Best a{false, false, -CUDART_INF_F};
  const bool vec = (np & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(srow) |
                     reinterpret_cast<uintptr_t>(mrow) |
                     reinterpret_cast<uintptr_t>(live)) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(srow) & 15) == 0;
  if (vec) {
    const long long n4 = np >> 2;
    for (long long c = lane; c < n4; c += 32) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(srow) + c);
      const uint32_t m = __ldg(reinterpret_cast<const uint32_t*>(mrow) + c);
      const uint32_t l = __ldg(reinterpret_cast<const uint32_t*>(live) + c);
      cell(a, s.x, m & 0xffu, l & 0xffu);
      cell(a, s.y, m & 0xff00u, l & 0xff00u);
      cell(a, s.z, m & 0xff0000u, l & 0xff0000u);
      cell(a, s.w, m & 0xff000000u, l & 0xff000000u);
    }
  } else {
    for (long long c = lane; c < np; c += 32)
      cell(a, __ldg(srow + c), __ldg(mrow + c), __ldg(live + c));
  }
  const bool any = __any_sync(kFull, a.any);
  const bool nan = __any_sync(kFull, a.nan);
  float best = a.best;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(kFull, best, off);
    if (v > best || (v == best && !signbit(v))) best = v;
  }
  if (lane == 0) {
    out[g * 2] = any ? 1.0f : 0.0f;
    out[g * 2 + 1] = !any ? 0.0f : (nan ? CUDART_NAN_F : best);
  }
}

}  // namespace

// `table` is a device array of n_lanes records of kWords int64, ascending
// in their output offset (word 5); out is [total_rows, 2] f32.
extern "C" int percolate_reduce_launch(const void* table, int n_lanes,
                                       long long total_rows, void* out,
                                       void* stream) {
  if (table == nullptr || n_lanes <= 0 || total_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (total_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  percolate_reduce_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const long long*)table, n_lanes, total_rows, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* percolate_reduce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
