// K20: the first k entries of each row in lexicographic key order.
//
// Replaces elasticsearch_tpu/parallel/mesh_engine.py:_stable_order, the
// collective plane's field-sort selection (per shard at :1671, in the
// merges at :1725): composed stable argsorts over the key rows
//   inval, k_0, k_1, ..., k_{n-1}          (ascending, most significant first)
// with ties broken by the entry's position in the row. Here, per row b and
// entry m < M:
//   raw_i  = key_i[b * stride_i + m], negated where bit i of `neg` is set
//            (stride 0: a per-doc column shared by every row; stride M: a
//            per-(row, entry) key)
//   valid  = mask[b, m] (all set when mask is NULL), and, with a cursor,
//            (raw_0, ..., raw_{n-1}) > (cur_0, ..., cur_{n-1})
//            lexicographically by IEEE compares (NaN neither > nor ==),
//            the search_after compare of mesh_engine.py:1651-1667
//   inval  = !valid; an invalid entry's keys all read +inf (:1668-1669)
// and the row's order is by (inval, u(k_0), ..., u(k_{n-1}), m), where u is
// an order-preserving map of f32 onto uint32 that folds -0.0 onto +0.0 and
// maps every NaN to one value above +inf: jnp.argsort's order (equal zeros
// tie, NaNs last and tied). Output: the first kk positions a row, i32.
//
// Design (a simple one that is right; speed is later work): each row is cut
// into tiles of `tile` entries (a power of two <= 2048). A block builds its
// tile's composite keys (inval, u(k)..., position: n + 2 words an entry) in
// shared memory, bitonic-sorts an index over them — the composite is a strict
// total order, so any correct sort is the stable one — and writes its first
// min(kk, tile) entries as a sorted run. Runs then merge pairwise, each pass
// one thread an output entry (merge path: a binary search for its co-rank
// in the two runs), every merged run cut to kk, until one run is left; the
// last pass writes positions only. Scratch: two run buffers of rows x
// ceil(M / tile) x min(kk, tile) entries — for kk >= tile that is the whole
// [rows, M] row of composites, the price of the simple merge.
//
// What bounds it on an H100: device-memory bytes — the mask and the
// per-(row, entry) keys read once, a stride-0 column once, kk positions a
// row written. The tile sorts' shared-memory traffic and the merge passes'
// reads of the run buffers come on top of that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxKeys = 16;
constexpr int kMaxTile = 2048;
constexpr int kMergeThreads = 256;

struct KeyRows {
  const float* ptr[kMaxKeys];
  long long stride[kMaxKeys];
};

// Order-preserving f32 -> u32: -0.0 ties +0.0, every NaN above +inf.
__device__ __forceinline__ uint32_t ord_key(float x) {
  if (x != x) return 0xFFFFFFFFu;
  const uint32_t b = (x == 0.0f) ? 0u : __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

constexpr uint32_t kInfKey = 0xFF800000u;   // ord_key(+inf)

// Composite of row b's entry m: w[0] inval, w[1..n] keys, w[n+1] position.
__device__ __forceinline__ void composite(
    const KeyRows& keys, int n, unsigned neg, const uint8_t* __restrict__ mask,
    const float* __restrict__ cursor, long long m_len, int b, long long m,
    uint32_t* w) {
  bool valid = mask == nullptr || mask[(long long)b * m_len + m] != 0;
  float raw[kMaxKeys];
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float v = keys.ptr[i][(long long)b * keys.stride[i] + m];
    raw[i] = ((neg >> i) & 1u) ? -v : v;
  }
  if (valid && cursor != nullptr) {
    const float* c = cursor + (long long)b * n;
    bool gt = false, eq = true;
    for (int i = 0; i < n; ++i) {
      gt = gt || (eq && raw[i] > c[i]);
      eq = eq && raw[i] == c[i];
    }
    valid = gt;
  }
  w[0] = valid ? 0u : 1u;
  for (int i = 0; i < n; ++i) w[1 + i] = valid ? ord_key(raw[i]) : kInfKey;
  w[n + 1] = (uint32_t)m;
}

__device__ __forceinline__ bool less(const uint32_t* a, const uint32_t* b,
                                     int words) {
  for (int i = 0; i < words; ++i)
    if (a[i] != b[i]) return a[i] < b[i];
  return false;
}

__device__ __forceinline__ long long run_len(long long r, long long span,
                                             long long cap, long long m) {
  long long end = (r + 1) * span;
  if (end > m) end = m;
  const long long covered = end - r * span;
  return covered < cap ? covered : cap;
}

// One block a (tile, row): sort the tile's composites, write its first
// min(kk, tile length) as a run (or, with one tile, the positions).
__global__ void select_tile_kernel(KeyRows keys, int n, unsigned neg,
                                   const uint8_t* __restrict__ mask,
                                   const float* __restrict__ cursor,
                                   long long m, int kk, int tile,
                                   long long cap0, long long row_words,
                                   uint32_t* __restrict__ runs,
                                   int* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int words = n + 2;
  uint32_t* comp = smem;                                 // [tile][words]
  uint16_t* idx = (uint16_t*)(smem + (size_t)tile * words);
  const int b = blockIdx.y;
  const long long base = (long long)blockIdx.x * tile;
  long long len = m - base;
  if (len > tile) len = tile;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    uint32_t* w = comp + (size_t)e * words;
    if (e < len) {
      composite(keys, n, neg, mask, cursor, m, b, base + e, w);
    } else {
      for (int i = 0; i < words; ++i) w[i] = 0xFFFFFFFFu;   // after all
    }
    idx[e] = (uint16_t)e;
  }
  __syncthreads();
  // bitonic sort of idx by the composites, ascending
  for (int size = 2; size <= tile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < tile / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const uint16_t a = idx[lo], c = idx[hi];
        const bool gt = less(comp + (size_t)c * words,
                             comp + (size_t)a * words, words);
        if (gt == up) {
          idx[lo] = c;
          idx[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  long long keep = len < kk ? len : kk;
  if (out != nullptr) {                     // a single tile: the answer
    for (long long e = threadIdx.x; e < keep; e += blockDim.x)
      out[(long long)b * kk + e] =
          (int)comp[(size_t)idx[e] * words + words - 1];
    return;
  }
  uint32_t* dst = runs + b * row_words + blockIdx.x * cap0 * words;
  for (long long e = threadIdx.x; e < keep * words; e += blockDim.x) {
    const long long ent = e / words;
    dst[e] = comp[(size_t)idx[ent] * words + (e - ent * words)];
  }
}

// One thread an output entry of merged run q = runs 2q and 2q+1 of the
// input pass, cut to cap_out; `out` set: write positions only.
__global__ void select_merge_kernel(int words, long long m, int kk,
                                    long long span_in, long long cap_in,
                                    long long cap_out, long long runs_in,
                                    long long row_words,
                                    const uint32_t* __restrict__ src,
                                    uint32_t* __restrict__ dst,
                                    int* __restrict__ out) {
  const int b = blockIdx.z;
  const long long q = blockIdx.y;
  const long long i = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  const long long ra = 2 * q, rb = 2 * q + 1;
  const long long a_len = run_len(ra, span_in, cap_in, m);
  const long long b_len = rb < runs_in ? run_len(rb, span_in, cap_in, m) : 0;
  long long o_len = a_len + b_len;
  if (o_len > cap_out) o_len = cap_out;
  if (i >= o_len) return;
  const uint32_t* A = src + b * row_words + ra * cap_in * words;
  const uint32_t* B = A + cap_in * words;
  long long lo = i - b_len > 0 ? i - b_len : 0;
  long long hi = i < a_len ? i : a_len;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (less(A + mid * words, B + (i - 1 - mid) * words, words))
      lo = mid + 1;
    else
      hi = mid;
  }
  const long long ia = lo, ib = i - lo;
  const uint32_t* pick =
      (ib >= b_len || (ia < a_len && less(A + ia * words, B + ib * words,
                                          words)))
          ? A + ia * words
          : B + ib * words;
  if (out != nullptr) {
    out[(long long)b * kk + i] = (int)pick[words - 1];
    return;
  }
  uint32_t* d = dst + b * row_words + q * cap_out * words + i * words;
  for (int w = 0; w < words; ++w) d[w] = pick[w];
}

}  // namespace

// key_ptrs / key_strides: host arrays of n device pointers (f32) and their
// row strides in elements (0 or m); neg: bit i negates key i; mask: u8
// [rows, m] or NULL; cursor: f32 [rows, n] or NULL; tile: a power of two in
// [64, 2048]; run_a, run_b: scratch of rows x ceil(m / tile) x min(kk, tile)
// x (n + 2) uint32 each, unused (may be NULL) when m <= tile; out: i32
// [rows, kk] with kk <= m.
extern "C" int sort_select_launch(int rows, long long m, int kk, int n,
                                  const long long* key_ptrs,
                                  const long long* key_strides, unsigned neg,
                                  const void* mask, const void* cursor,
                                  int tile, void* run_a, void* run_b,
                                  void* out, void* stream) {
  if (rows < 0 || m < 1 || m >= (1LL << 31) - 1 || kk < 1 || kk > m ||
      n < 0 || n > kMaxKeys || tile < 64 || tile > kMaxTile ||
      (tile & (tile - 1)) != 0 || rows > 65535 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  KeyRows keys{};
  for (int i = 0; i < n; ++i) {
    keys.ptr[i] = (const float*)key_ptrs[i];
    keys.stride[i] = key_strides[i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int words = n + 2;
  const long long tiles = (m + tile - 1) / tile;
  if (tiles > 1 && (run_a == nullptr || run_b == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long cap0 = kk < tile ? kk : tile;
  const long long row_words = tiles * cap0 * words;
  const size_t smem = (size_t)tile * words * sizeof(uint32_t) +
                      (size_t)tile * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      select_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = tile / 2 < 512 ? tile / 2 : 512;
  select_tile_kernel<<<dim3((unsigned)tiles, (unsigned)rows), threads, smem,
                     s>>>(keys, n, neg, (const uint8_t*)mask,
                          (const float*)cursor, m, kk, tile, cap0, row_words,
                          (uint32_t*)run_a, tiles == 1 ? (int*)out : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  uint32_t* src = (uint32_t*)run_a;
  uint32_t* dst = (uint32_t*)run_b;
  long long span = tile, cap = cap0, runs = tiles;
  while (runs > 1) {
    const long long runs_out = (runs + 1) / 2;
    const long long span_out = 2 * span;
    const long long cap_out = kk < span_out ? kk : span_out;
    const bool last = runs_out == 1;
    const dim3 grid((unsigned)((cap_out + kMergeThreads - 1) / kMergeThreads),
                    (unsigned)runs_out, (unsigned)rows);
    select_merge_kernel<<<grid, kMergeThreads, 0, s>>>(
        words, m, kk, span, cap, cap_out, runs, row_words, src, dst,
        last ? (int*)out : nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    uint32_t* t = src;
    src = dst;
    dst = t;
    span = span_out;
    cap = cap_out;
    runs = runs_out;
  }
  return (int)cudaSuccess;
}

extern "C" const char* sort_select_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
