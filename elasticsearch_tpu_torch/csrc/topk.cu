// K2: stable masked top-k, one row per block.
//
// Replaces the lax.top_k calls of elasticsearch_tpu/ops/topk.py — top_k
// (one segment's top-k, implicit doc ids 0..M-1) and merge_top_k_batch_body
// (the cross-segment merge, explicit doc ids) — with their exact contract:
// per row, the k best ELIGIBLE entries in (score desc, position asc) order,
// padded with (-inf, -1). An entry is eligible when its mask is set, its
// score is above -inf and its id (if ids are given) is >= 0. The JAX package
// gets the position-asc tie order from the stability of lax.top_k; within a
// segment position order is doc order, and across segments concatenated in
// segment order it is TopDocs.merge's order. torch.topk promises no tie
// order on CUDA, so the port does not use it.
//
// What bounds it on an H100: device-memory bytes — each row's scores, mask
// and ids are read, k results written. Design against that bound:
//   * each entry maps to one unique, order-preserving 64-bit key,
//     (ordered float bits << 32) | (0xFFFFFFFF - position);
//   * an MSD radix select finds the k-th key: 12-bit digits, a 4096-bin
//     histogram in shared memory, warp-aggregated shared atomics
//     (__match_any_sync), and an early stop as soon as the boundary bin holds
//     exactly the entries still wanted — BM25 scores usually settle in two or
//     three passes over the row, ties need more (at most six);
//   * every pass reads the row with four independent coalesced loads in
//     flight per thread;
//   * the k winners are gathered into shared memory and bitonic-sorted there,
//     so only k results are written.
// One block per row is the simple design: at B = 64 rows it fills 64 of the
// card's 132 SMs. Splitting a row over several blocks is for a later PR.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kBits = 12;
constexpr int kBins = 1 << kBits;
constexpr int kBinsPerThread = kBins / kThreads;

__device__ __forceinline__ uint32_t ordered_bits(float s) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;  // -0 ties +0, as a float compare does
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t make_key(float s, int64_t pos) {
  return ((uint64_t)ordered_bits(s) << 32) |
         (uint64_t)(0xFFFFFFFFu - (uint32_t)pos);
}

// Inclusive scan of one value per thread over the block.
__device__ uint32_t block_inclusive_scan(uint32_t v, uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  return v;
}

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ scores, const uint8_t* __restrict__ mask,
            const int32_t* __restrict__ ids, int m, int k, int kpad,
            float* __restrict__ out_scores, int32_t* __restrict__ out_ids,
            int32_t* __restrict__ out_count) {
  extern __shared__ uint64_t sbuf[];  // histogram, later the sort buffer
  uint32_t* hist = reinterpret_cast<uint32_t*>(sbuf);
  __shared__ uint32_t warp_sums[32];
  __shared__ uint32_t s_total, s_bin, s_rank, s_cnt, s_n;

  const int64_t row = blockIdx.x;
  const float* rs = scores + row * m;
  const uint8_t* rm = mask ? mask + row * m : nullptr;
  const int32_t* ri = ids ? ids + row * m : nullptr;

  uint64_t prefix = 0;  // the top `pbits` bits every selected key starts with
  int pbits = 0;
  uint32_t rank = (uint32_t)k;  // 1-based rank of the k-th key in its group
  uint32_t total = 0;           // eligible entries in the row
  bool select_all = false;

  for (int pass = 0;; ++pass) {
    const int w = (64 - pbits) < kBits ? (64 - pbits) : kBits;
    const int shift = 64 - pbits - w;
    for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0u;
    __syncthreads();
    for (int64_t base = 0; base < m; base += (int64_t)kUnroll * kThreads) {
      float s[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
        const bool in = i < m;
        s[j] = in ? rs[i] : -CUDART_INF_F;
        ok[j] = in && (!rm || rm[i]) && (!ri || ri[i] >= 0);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
        const uint64_t key = make_key(s[j], i);
        const bool take = ok[j] && s[j] > -CUDART_INF_F &&
                          (pbits == 0 || (key >> (64 - pbits)) == prefix);
        const uint32_t bin = take ? (uint32_t)(key >> shift) & (kBins - 1)
                                  : 0xFFFFFFFFu;
        const uint32_t peers = __match_any_sync(0xffffffffu, bin);
        if (take && (threadIdx.x & 31) == __ffs(peers) - 1)
          atomicAdd(&hist[bin], (uint32_t)__popc(peers));
      }
    }
    __syncthreads();
    // thread t owns bins kBins-1-4t .. kBins-4-4t, i.e. the scan runs from
    // the highest bin down
    uint32_t local = 0;
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j)
      local += hist[kBins - 1 - kBinsPerThread * threadIdx.x - j];
    const uint32_t incl = block_inclusive_scan(local, warp_sums);
    const uint32_t excl = incl - local;
    if (threadIdx.x == kThreads - 1) s_total = incl;
    if (excl < rank && rank <= incl) {
      uint32_t cum = excl;
      for (int j = 0; j < kBinsPerThread; ++j) {
        const uint32_t bin = kBins - 1 - kBinsPerThread * threadIdx.x - j;
        if (cum + hist[bin] >= rank) {
          s_bin = bin;
          s_rank = rank - cum;
          s_cnt = hist[bin];
          break;
        }
        cum += hist[bin];
      }
    }
    __syncthreads();
    if (pass == 0) {
      total = s_total;
      if (total <= (uint32_t)k) {
        select_all = true;
        break;
      }
    }
    prefix = (prefix << w) | s_bin;
    pbits += w;
    rank = s_rank;
    const uint32_t cnt = s_cnt;
    __syncthreads();
    if (cnt == rank) break;  // every key of this bin is selected
  }

  const uint32_t nsel = select_all ? total : (uint32_t)k;
  if (threadIdx.x == 0) s_n = 0u;
  __syncthreads();
  for (int64_t base = 0; base < m; base += (int64_t)kUnroll * kThreads) {
    float s[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
      const bool in = i < m;
      s[j] = in ? rs[i] : -CUDART_INF_F;
      ok[j] = in && (!rm || rm[i]) && (!ri || ri[i] >= 0);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
      const uint64_t key = make_key(s[j], i);
      if (ok[j] && s[j] > -CUDART_INF_F &&
          (select_all || (key >> (64 - pbits)) >= prefix)) {
        const uint32_t slot = atomicAdd(&s_n, 1u);
        if (slot < (uint32_t)kpad) sbuf[slot] = key;
      }
    }
  }
  __syncthreads();
  for (int i = nsel + threadIdx.x; i < kpad; i += kThreads) sbuf[i] = 0ull;
  __syncthreads();

  // bitonic sort, descending; key 0 (padding) sinks below every real key
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < kpad; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const uint64_t a = sbuf[i];
          const uint64_t b = sbuf[j];
          const bool desc = (i & size) == 0;
          if (desc ? (a < b) : (a > b)) {
            sbuf[i] = b;
            sbuf[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  float* os = out_scores + row * k;
  int32_t* oi = out_ids + row * k;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    if ((uint32_t)j < nsel) {
      const uint32_t pos = 0xFFFFFFFFu - (uint32_t)(sbuf[j] & 0xFFFFFFFFull);
      os[j] = rs[pos];
      oi[j] = ri ? ri[pos] : (int32_t)pos;
    } else {
      os[j] = -CUDART_INF_F;
      oi[j] = -1;
    }
  }
  if (threadIdx.x == 0) out_count[row] = (int32_t)total;
}

}  // namespace

extern "C" int topk_launch(const void* scores, const void* mask,
                           const void* ids, int rows, int m, int k, int kpad,
                           void* out_scores, void* out_ids, void* out_count,
                           void* stream) {
  size_t smem = (size_t)kpad * sizeof(uint64_t);
  if (smem < kBins * sizeof(uint32_t)) smem = kBins * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const uint8_t*)mask, (const int32_t*)ids, m, k,
      kpad, (float*)out_scores, (int32_t*)out_ids, (int32_t*)out_count);
  return (int)cudaGetLastError();
}

extern "C" const char* topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
