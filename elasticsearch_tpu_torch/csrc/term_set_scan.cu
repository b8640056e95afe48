// K16: batched term-set membership over one segment's forward columns.
//
// Replaces the text arm of elasticsearch_tpu/search/execute.py:
// _vocab_scan_mask (prefix / wildcard / regexp / fuzzy on a text field),
//
//   hit = (uterms[:, :, None] == tids[None, None, :]) & (tids >= 0)
//   mask = hit.any(axis=(1, 2))
//
// as the JAX package runs it under jax.vmap: for each query q of a batch
// and each doc row d, does row d hold any term of q's expanded set? The
// sets run from a few terms to over a thousand (tids is padded to a power
// of two with -1).
//
// What bounds it on an H100: device-memory bytes — each row's term ids read
// once per batch up to its first pad, and a [B, N] byte mask written. The
// design keeps it so whatever the set sizes: the wrapper
// (ops/lexical.term_set_index) turns the batch's sets into the sorted union
// of their ids and, per id, a 64-bit mask of the queries of each 64-query
// group that hold it (term_set.cuh, shared with K13's term_set leaf). The
// union sits in shared memory when it fits (kSmemKeys ids, else it is read
// from global memory, where it stays in L2). A warp scans one row at a
// time, its lanes over the row's cells, 32 contiguous cells a load,
// stopping after the window that holds the row's first pad
// (`trailing_pad`); each live cell is looked up ONCE by binary search, and
// on a hit or-s its query mask into the row's. A warp or-reduces the lanes'
// masks, keeps a run of kRun rows, and then each lane writes kRun
// contiguous mask bytes for a query. Grid y runs over the 64-query groups;
// blocks are persistent over runs of rows, as in K1.
// Numerics: none; the mask is exactly the reference's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "term_set.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRun = 8;              // consecutive rows a warp keeps
constexpr int kSmemKeys = 40960;     // union ids kept in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemOptIn = 232448;

__global__ void __launch_bounds__(kThreads)
term_set_scan_kernel(const int32_t* __restrict__ uterms, int n_docs,
                     int n_unique, const int32_t* __restrict__ keys,
                     int n_keys, const unsigned long long* __restrict__ bits,
                     int groups, int n_queries, int trailing_pad,
                     uint8_t* __restrict__ mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool staged = n_keys <= kSmemKeys;
  int32_t* s_keys = reinterpret_cast<int32_t*>(smem);
  if (staged) {
    for (int i = threadIdx.x; i < n_keys; i += kThreads) s_keys[i] = keys[i];
  }
  __syncthreads();
  const int32_t* k = staged ? s_keys : keys;
  const int g = blockIdx.y;
  const int q0 = g * 64;
  const int nq = min(64, n_queries - q0);
  const bool whole_runs = (n_docs & (kRun - 1)) == 0;

  const int runs = (n_docs + kRun - 1) / kRun;
  const int run_step = gridDim.x * kWarps;
  for (int run = blockIdx.x * kWarps + warp; run < runs; run += run_step) {
    const int d0 = run * kRun;
    const int rows = min(kRun, n_docs - d0);
    unsigned long long row_bits = 0ull;   // lane r keeps row r's mask
    for (int r = 0; r < rows; ++r) {
      const int32_t* row = uterms + (int64_t)(d0 + r) * n_unique;
      unsigned long long acc = 0ull;
      for (int u0 = 0; u0 < n_unique; u0 += 32) {
        const int u = u0 + lane;
        const int32_t cell = u < n_unique ? row[u] : -1;
        bool last = u0 + 32 >= n_unique;
        if (trailing_pad && __ballot_sync(kFull, u < n_unique && cell < 0))
          last = true;
        if (cell >= 0) {
          const int idx = term_set_find(k, n_keys, cell);
          if (idx >= 0) acc |= term_set_queries(bits, groups, idx, g);
        }
        if (last) break;
      }
      // or the lanes' masks together
      unsigned lo = (unsigned)acc, hi = (unsigned)(acc >> 32);
      lo = __reduce_or_sync(kFull, lo);
      hi = __reduce_or_sync(kFull, hi);
      if (lane == r)
        row_bits = ((unsigned long long)hi << 32) | (unsigned long long)lo;
    }
    // each lane writes the run's bytes of its queries
    unsigned long long run_bits[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      run_bits[r] = __shfl_sync(kFull, row_bits, r);
    for (int q = lane; q < nq; q += 32) {
      uint32_t mk[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r) mk[r] = (uint32_t)(run_bits[r] >> q) & 1u;
      const int64_t at = (int64_t)(q0 + q) * n_docs + d0;
      if (whole_runs) {
        *reinterpret_cast<uint2*>(mask + at) =
            make_uint2(mk[0] | mk[1] << 8 | mk[2] << 16 | mk[3] << 24,
                       mk[4] | mk[5] << 8 | mk[6] << 16 | mk[7] << 24);
      } else {
#pragma unroll
        for (int r = 0; r < kRun; ++r)
          if (r < rows) mask[at + r] = (uint8_t)mk[r];
      }
    }
  }
}

}  // namespace

// keys: [n_keys] sorted int32; bits: [n_keys, groups] int64; mask:
// [n_queries, n_docs] bytes.
extern "C" int term_set_scan_launch(const void* uterms, int n_docs,
                                    int n_unique, const void* keys,
                                    int n_keys, const void* bits, int groups,
                                    int n_queries, int trailing_pad,
                                    void* mask, void* stream) {
  if (n_docs <= 0 || n_unique <= 0 || n_keys <= 0 || n_queries <= 0 ||
      groups != (n_queries + 63) / 64 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = n_keys <= kSmemKeys ? n_keys * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      term_set_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, term_set_scan_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks_needed =
      ((n_docs + kRun - 1) / kRun + kWarps - 1) / kWarps;
  long long want = (long long)sms * per_sm / groups;
  if (want < 1) want = 1;
  if (want > blocks_needed) want = blocks_needed;
  dim3 grid((unsigned)want, (unsigned)groups);
  term_set_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)uterms, n_docs, n_unique, (const int32_t*)keys, n_keys,
      (const unsigned long long*)bits, groups, n_queries, trailing_pad,
      (uint8_t*)mask);
  return (int)cudaGetLastError();
}

extern "C" const char* term_set_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
