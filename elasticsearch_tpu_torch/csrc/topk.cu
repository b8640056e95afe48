// K2: stable masked top-k, each long row split over many blocks.
//
// Replaces the lax.top_k calls of elasticsearch_tpu/ops/topk.py — top_k
// (one segment's top-k, implicit doc ids 0..M-1) and merge_top_k_batch_body
// (the cross-segment merge, explicit doc ids) — with their exact contract:
// per row, the k best ELIGIBLE entries in (score desc, position asc) order,
// padded with (-inf, -1), and the count of eligible entries. An entry is
// eligible when its mask is set, its score is above -inf and its id (if ids
// are given) is >= 0. The JAX package gets the position-asc tie order from
// the stability of lax.top_k; within a segment position order is doc order,
// and across segments concatenated in segment order it is TopDocs.merge's
// order. torch.topk promises no tie order on CUDA, so the port does not use
// it.
//
// Keys. Each eligible entry maps to one order-preserving 64-bit key,
//   (ordered float bits << 32) | (0xFFFFFFFF - position),
// with -0 folded onto +0 as a float compare does. The keys of a row are
// unique, so "the k largest keys" is one set with no tie to break, and it is
// exactly the (score desc, position asc) top-k. Key 0 never belongs to an
// eligible entry (its high word would be a NaN's) and marks "no entry".
//
// Why splitting a row is exact. Cut a row into chunks. Every key of the
// row's top-k is among the k largest keys of its own chunk (fewer than k keys
// of that chunk can beat it, since fewer than k keys of the whole row do).
// So the top-k of the row is the top-k of the union of the chunks' top-k's
// (or of any supersets of them), and the row's eligible count is the sum of
// the chunks' counts. For the
// same reason the bin of the row's k-th key, found from a histogram of ALL
// the row's keys, splits the union correctly: every key above that bin, and
// the best of the bin's keys, are in the union.
//
// What bounds it on an H100: device-memory bytes — each row's scores, mask
// and ids are read once, k results written. Next comes the work per entry
// (67M entries at B = 64, N = 2^20), so each pass over a whole chunk costs a
// few instructions an entry. Design:
//   * stage 1, one block per (row, chunk of `chunk` entries), two blocks per
//     SM: the block reads its chunk ONCE from device memory (16-byte loads
//     where aligned) into shared memory as 32-bit ordered score words, 0 for
//     an ineligible entry, building on the way the histogram of the words'
//     top 12 bits, which it also adds to its row's histogram in device
//     memory. One scan of it gives the chunk's eligible count and the bin of
//     its k-th key, and one pass sends every key at or above that bin to the
//     row's candidate buffer: the chunk's top-k and the rest of that bin,
//     while that rest is at most k keys (else radix passes over the chunk
//     find its exact top-k). At B = 64 rows of 2^20 entries that is 4,096
//     blocks, so all 132 SMs stream the input;
//   * stage 2, one block per row, takes the bin of the row's k-th key from
//     the row histogram, so one pass over its candidates (at most
//     chunks x k keys, read from L2) keeps the keys above the bin and lists
//     the bin's keys; it resolves the list, then bitonic-sorts the k winners
//     in shared memory, so only k results are written;
//   * a row of at most `chunk` entries (the cross-segment merge) is one
//     stage-1 block that selects, sorts and writes by itself;
//   * keys are written out with one atomic per warp and step (a warp scan of
//     the lanes' counts), and in the radix passes a run of tied keys is
//     counted with one atomic per warp; a boundary bin too big for its list
//     (a huge run of ties) is resolved by passes over all keys instead.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBits = 12;
constexpr int kBins = 1 << kBits;
constexpr int kChunkThreads = 512;   // stage 1: 8 histogram bins a thread
constexpr int kRowThreads = 1024;    // stage 2: 4 histogram bins a thread
constexpr int kStageUnroll = 4;      // 16-byte groups in flight per thread
constexpr int kUnroll = 8;           // candidate keys in flight per thread
constexpr int kList1 = 2048;         // boundary-bin keys a one-chunk row keeps
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may take
constexpr unsigned kFull = 0xffffffffu;

// per row of the candidate state (zeroed by the wrapper): the fill of its
// candidate buffer, then the histogram of its keys' top kBits bits
constexpr int kHistAt = 4;
constexpr int kRowState = kHistAt + kBins;

__device__ __forceinline__ uint32_t ordered_bits(float s) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;  // -0 ties +0, as a float compare does
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t entry_word(float s, bool ok) {
  return (ok && s > -CUDART_INF_F) ? ordered_bits(s) : 0u;
}

__device__ __forceinline__ uint64_t key_of(uint32_t word, uint32_t pos) {
  return word ? (((uint64_t)word << 32) | (uint64_t)(0xFFFFFFFFu - pos))
              : 0ull;
}

// Inclusive scan of one value per thread over the block.
template <int THREADS>
__device__ uint32_t block_inclusive_scan(uint32_t v, uint32_t* warp_sums) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += n;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  return v;
}

// Key visitors. Each hands a block's keys (0 = no entry) to f in steps of
// kStep keys a lane, with the same number of steps in every lane, as the
// warp-wide intrinsics need.

// One chunk staged in shared memory as score words, padded with zero words
// to a multiple of 4 x THREADS; a step is two groups of 4 words.
template <int THREADS>
struct StagedKeys {
  static constexpr int kStep = 8;
  const uint4* words;  // [groups] of 4 words
  int groups;
  uint32_t first;      // row position of entry 0
  template <class F>
  __device__ void visit_steps(F f) const {
    for (int g = threadIdx.x; g < groups; g += 2 * THREADS) {
      const int h = g + THREADS;
      const uint4 w = words[g];
      const uint4 v = h < groups ? words[h] : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t p = first + 4u * (uint32_t)g;
      const uint32_t q = first + 4u * (uint32_t)h;
      const uint64_t k[kStep] = {key_of(w.x, p),     key_of(w.y, p + 1),
                                 key_of(w.z, p + 2), key_of(w.w, p + 3),
                                 key_of(v.x, q),     key_of(v.y, q + 1),
                                 key_of(v.z, q + 2), key_of(v.w, q + 3)};
      f(k);
    }
  }
};

// n keys in memory: a row's candidates in device memory (stage 2), or a
// boundary bin's keys in shared memory.
template <int THREADS, int UNROLL>
struct KeyArray {
  static constexpr int kStep = UNROLL;
  const uint64_t* keys;
  int n;
  template <class F>
  __device__ void visit_steps(F f) const {
    for (int base = 0; base < n; base += UNROLL * THREADS) {
      uint64_t k[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const int i = base + j * THREADS + threadIdx.x;
        k[j] = i < n ? keys[i] : 0ull;
      }
      f(k);
    }
  }
};

// Hand the keys of a visitor to f one at a time.
template <class Keys, class F>
__device__ void visit(const Keys& keys, F f) {
  keys.visit_steps([&](const uint64_t(&k)[Keys::kStep]) {
#pragma unroll
    for (int j = 0; j < Keys::kStep; ++j) f(k[j]);
  });
}

struct SelectShared {
  uint32_t warp_sums[32];
  uint32_t bin, rank, cnt, total;
  uint32_t eligible;  // the first histogram's sum
  uint32_t n;  // keys sent to the output
  uint32_t m;  // keys of the boundary bin (listed while they fit)
  uint32_t slot_base;
  unsigned long long lo, hi;  // a list's smallest and largest key
};

// Radix state: the selected keys are those whose top `pbits` bits are
// >= `prefix`; `rank` is the 1-based rank of the k-th key among the keys
// whose top bits equal `prefix`.
struct Radix {
  uint64_t prefix;
  int pbits;
  uint32_t rank;
};

__device__ __forceinline__ bool under(uint64_t key, const Radix& st) {
  return key != 0ull &&
         (st.pbits == 0 || (key >> (64 - st.pbits)) == st.prefix);
}

__device__ __forceinline__ bool above(uint64_t key, const Radix& st) {
  return key != 0ull && (key >> (64 - st.pbits)) > st.prefix;
}

// selected: at or above the prefix (st.pbits >= 1)
__device__ __forceinline__ bool picked(uint64_t key, const Radix& st) {
  return key != 0ull && (key >> (64 - st.pbits)) >= st.prefix;
}

// Count `bin` in the histogram for every lane with `take`. When the warp's
// takers share one bin (a run of ties) one lane adds them all; otherwise each
// adds its own.
__device__ __forceinline__ void count_digit(bool take, uint32_t bin,
                                            uint32_t* hist) {
  const uint32_t votes = __ballot_sync(kFull, take);
  if (votes == 0u) return;
  const int leader = __ffs(votes) - 1;
  const uint32_t first = __shfl_sync(kFull, bin, leader);
  if (__all_sync(kFull, !take || bin == first)) {
    if ((int)(threadIdx.x & 31) == leader)
      atomicAdd(&hist[first], (uint32_t)__popc(votes));
  } else if (take) {
    atomicAdd(&hist[bin], 1u);
  }
}

// Write the keys that `pick_a` selects to out_a[] and those that `pick_b`
// selects to out_b[] (the slots below cap_b only), slots counted in *fill_a
// and *fill_b: a warp scan of the lanes' counts, then one atomic per warp and
// step.
template <class Keys, class PickA, class PickB>
__device__ void emit(const Keys& keys, PickA pick_a, uint64_t* out_a,
                     uint32_t* fill_a, PickB pick_b, uint64_t* out_b,
                     uint32_t* fill_b, uint32_t cap_b) {
  constexpr int S = Keys::kStep;  // at most 32 x S < 2^16 picks a step
  const int lane = threadIdx.x & 31;
  keys.visit_steps([&](const uint64_t(&k)[S]) {
    uint32_t ma = 0, mb = 0;  // this lane's picks, one bit a key
#pragma unroll
    for (int j = 0; j < S; ++j) {
      ma |= (uint32_t)pick_a(k[j]) << j;
      mb |= (uint32_t)pick_b(k[j]) << j;
    }
    const uint32_t own = __popc(ma) | ((uint32_t)__popc(mb) << 16);
    uint32_t incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t n = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += n;
    }
    const uint32_t tot = __shfl_sync(kFull, incl, 31);
    if (tot == 0u) return;
    uint32_t ba = 0, bb = 0;
    if (lane == 31) {
      if (tot & 0xFFFFu) ba = atomicAdd(fill_a, tot & 0xFFFFu);
      if (tot >> 16) bb = atomicAdd(fill_b, tot >> 16);
    }
    uint32_t sa = __shfl_sync(kFull, ba, 31) + ((incl - own) & 0xFFFFu);
    uint32_t sb = __shfl_sync(kFull, bb, 31) + ((incl - own) >> 16);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if ((ma >> j) & 1u) out_a[sa++] = k[j];
      if ((mb >> j) & 1u) {
        if (sb < cap_b) out_b[sb] = k[j];
        ++sb;
      }
    }
  });
}

template <class Keys, class Pick>
__device__ void emit(const Keys& keys, Pick pick, uint64_t* out,
                     uint32_t* fill) {
  emit(keys, pick, out, fill, [](uint64_t) { return false; }, out, fill, 0u);
}

// Scan the histogram from the highest bin down for the bin that holds the
// rank-th key and descend into it; sh.total gets the histogram's sum.
// Returns that bin's count (meaningless when the sum is below the rank).
template <int THREADS>
__device__ uint32_t descend(const uint32_t* hist, Radix& st, int w,
                            SelectShared& sh) {
  constexpr int kPer = kBins / THREADS;
  // thread t owns bins kBins-1-kPer*t .. kBins-kPer-kPer*t
  uint32_t local = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    local += hist[kBins - 1 - kPer * threadIdx.x - j];
  const uint32_t incl = block_inclusive_scan<THREADS>(local, sh.warp_sums);
  const uint32_t excl = incl - local;
  if (threadIdx.x == THREADS - 1) sh.total = incl;
  if (excl < st.rank && st.rank <= incl) {
    uint32_t cum = excl;
    for (int j = 0; j < kPer; ++j) {
      const uint32_t bin = kBins - 1 - kPer * threadIdx.x - j;
      if (cum + hist[bin] >= st.rank) {
        sh.bin = bin;
        sh.rank = st.rank - cum;
        sh.cnt = hist[bin];
        break;
      }
      cum += hist[bin];
    }
  }
  __syncthreads();
  st.prefix = (st.prefix << w) | sh.bin;
  st.pbits += w;
  st.rank = sh.rank;
  const uint32_t cnt = sh.cnt;
  __syncthreads();
  return cnt;
}

// Skip the bits that every key of a list shares beyond the prefix (a run of
// ties shares its whole score word): the prefix grows to the common leading
// bits of the smallest and largest key. sh.lo / sh.hi must start at
// (~0, 0).
template <class Keys>
__device__ void narrow(const Keys& keys, Radix& st, SelectShared& sh) {
  unsigned long long lo = ~0ull, hi = 0ull;
  visit(keys, [&](uint64_t key) {
    if (key != 0ull) {
      lo = key < lo ? key : lo;
      hi = key > hi ? key : hi;
    }
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long l = __shfl_xor_sync(kFull, lo, o);
    const unsigned long long h = __shfl_xor_sync(kFull, hi, o);
    lo = l < lo ? l : lo;
    hi = h > hi ? h : hi;
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&sh.lo, lo);
    atomicMax(&sh.hi, hi);
  }
  __syncthreads();
  lo = sh.lo;
  hi = sh.hi;
  const int b = lo == hi ? 64 : __clzll(lo ^ hi);
  if (b > st.pbits) {
    st.pbits = b;
    st.prefix = hi >> (64 - b);
  }
}

// One radix pass: histogram of the next digit of the keys under the prefix,
// then descend.
template <int THREADS, class Keys>
__device__ uint32_t radix_pass(const Keys& keys, Radix& st, uint32_t* hist,
                               SelectShared& sh) {
  const int w = (64 - st.pbits) < kBits ? (64 - st.pbits) : kBits;
  const int shift = 64 - st.pbits - w;
  const uint32_t digit_mask = (1u << w) - 1u;
  for (int i = threadIdx.x; i < kBins; i += THREADS) hist[i] = 0u;
  __syncthreads();
  visit(keys, [&](uint64_t key) {
    count_digit(under(key, st), (uint32_t)(key >> shift) & digit_mask, hist);
  });
  __syncthreads();
  return descend<THREADS>(hist, st, w, sh);
}

// Send the k largest keys of `keys` (every key when there are at most k) to
// out[], in no order, slots counted in sh.n (0 on entry, as sh.m); with
// `slack`, every key of the bin of the k-th key, descending to narrower bins
// until that adds at most `slack` keys. `hist` holds the histogram of the
// top kBits bits of the keys, or of a superset of them that holds every key
// the superset's top-k takes from them (the row's histogram, for the
// candidates of stage 2); its sum, the eligible count, goes to sh.eligible.
// A boundary bin of at most `list_cap` keys is resolved over a copy of its
// keys in `list`. `out_for(n)` gives the output once the number n of keys
// sent is known, and n is returned. Block-wide: every thread calls it.
template <int THREADS, class Keys, class OutFor>
__device__ uint32_t select_top(const Keys& keys, uint32_t k, uint32_t slack,
                               uint32_t* hist, uint64_t* list,
                               uint32_t list_cap, OutFor out_for,
                               SelectShared& sh) {
  Radix st{0ull, 0, k};
  uint32_t cnt = descend<THREADS>(hist, st, kBits, sh);
  const uint32_t total = sh.total;
  if (threadIdx.x == 0) sh.eligible = total;
  if (total <= k) {
    uint64_t* out = out_for(total);
    emit(keys, [](uint64_t key) { return key != 0ull; }, out, &sh.n);
    return total;
  }
  // keys are unique, so a bin holds exactly the keys wanted at 64 bits at
  // the latest; the bound on pbits only guards against a broken input
  if (slack > 0 || list_cap == 0 || cnt == st.rank) {
    // descend until the boundary bin, whole, adds at most `slack` keys
    while (cnt - st.rank > slack && st.pbits < 64)
      cnt = radix_pass<THREADS>(keys, st, hist, sh);
    const uint32_t n = k - st.rank + cnt;
    uint64_t* out = out_for(n);
    emit(keys, [&](uint64_t key) { return picked(key, st); }, out, &sh.n);
    return n;
  }
  // the keys above the boundary bin are selected; list the bin's own
  uint64_t* out = out_for(k);
  const Radix bin = st;
  emit(keys, [&](uint64_t key) { return above(key, bin); }, out, &sh.n,
       [&](uint64_t key) { return under(key, bin); }, list, &sh.m, list_cap);
  __syncthreads();
  cnt = sh.m;
  if (cnt <= list_cap) {
    const KeyArray<THREADS, 1> kept{list, (int)cnt};
    if (cnt != st.rank) narrow(kept, st, sh);
    while (cnt != st.rank && st.pbits < 64)
      cnt = radix_pass<THREADS>(kept, st, hist, sh);
    emit(kept, [&](uint64_t key) { return picked(key, st); }, out, &sh.n);
    return k;
  }
  // too many keys for the list (a huge run of ties): passes over all keys
  while (cnt != st.rank && st.pbits < 64)
    cnt = radix_pass<THREADS>(keys, st, hist, sh);
  emit(keys, [&](uint64_t key) { return under(key, bin) && picked(key, st); },
       out, &sh.n);
  return k;
}

// Bitonic sort of kpad keys in shared memory, descending; key 0 (padding)
// sinks below every real key. kpad is a power of two and a multiple of 32.
template <int THREADS>
__device__ void bitonic_sort_desc(uint64_t* sbuf, int kpad) {
  // Strides of 32 and more go through shared memory, the smaller ones
  // through warp shuffles in registers, one barrier for all of them.
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size >> 1; stride >= 32; stride >>= 1) {
      for (int i = threadIdx.x; i < kpad; i += THREADS) {
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
    for (int i = threadIdx.x; i < kpad; i += THREADS) {
      uint64_t v = sbuf[i];
      const bool desc = (i & size) == 0;
      for (int stride = (size >> 1) < 16 ? (size >> 1) : 16; stride > 0;
           stride >>= 1) {
        const uint64_t o = __shfl_xor_sync(kFull, v, stride);
        // in a descending run the lower index keeps the larger key
        const bool keep_max = desc == ((i & stride) == 0);
        v = keep_max ? (v > o ? v : o) : (v < o ? v : o);
      }
      sbuf[i] = v;
    }
    __syncthreads();
  }
}

// The result of one key: its entry's score and id, or (-inf, -1) for key 0.
__device__ __forceinline__ void write_key(uint64_t key, const float* rs,
                                          const int32_t* ri, float* os,
                                          int32_t* oi) {
  if (key) {
    const uint32_t pos = 0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull);
    *os = rs[pos];
    *oi = ri ? ri[pos] : (int32_t)pos;
  } else {
    *os = -CUDART_INF_F;
    *oi = -1;
  }
}

// Sort the nsel gathered keys (descending) and write the row's k results.
template <int THREADS>
__device__ void sort_and_write(uint64_t* sbuf, int kpad, uint32_t nsel, int k,
                               const float* rs, const int32_t* ri, float* os,
                               int32_t* oi) {
  for (int i = nsel + threadIdx.x; i < kpad; i += THREADS) sbuf[i] = 0ull;
  __syncthreads();
  bitonic_sort_desc<THREADS>(sbuf, kpad);
  for (int j = threadIdx.x; j < k; j += THREADS)
    write_key((uint32_t)j < nsel ? sbuf[j] : 0ull, rs, ri, os + j, oi + j);
}

// Stage 1: one block per (row, chunk). With `cand` NULL the row is a single
// chunk and the block writes the row's results itself.
__global__ void __launch_bounds__(kChunkThreads, 2)
chunk_topk_kernel(const float* __restrict__ scores,
                  const uint8_t* __restrict__ mask,
                  const int32_t* __restrict__ ids, int m, int k, int kpad,
                  int chunk, int chunks, int vec, uint64_t* __restrict__ cand,
                  uint32_t* __restrict__ state, float* __restrict__ out_scores,
                  int32_t* __restrict__ out_ids,
                  int32_t* __restrict__ out_count) {
  extern __shared__ uint4 smem4[];
  __shared__ SelectShared sh;
  const int64_t row = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const int64_t first = (int64_t)c * chunk;
  const int len = (int64_t)m - first < chunk ? (int)(m - first) : chunk;
  constexpr int kGroupStep = 4 * kChunkThreads;
  const int groups = (len + kGroupStep - 1) / kGroupStep * kChunkThreads;
  uint4* words = smem4;
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem4 + groups);
  // a single-chunk row's boundary-bin list and winners
  uint64_t* list = reinterpret_cast<uint64_t*>(hist + kBins);
  uint64_t* sbuf = list + kList1;

  const float* rs = scores + row * m;
  const uint8_t* rm = mask ? mask + row * m : nullptr;
  const int32_t* ri = ids ? ids + row * m : nullptr;

  for (int i = threadIdx.x; i < kBins; i += kChunkThreads) hist[i] = 0u;
  if (threadIdx.x == 0) {
    sh.n = 0u;
    sh.m = 0u;
    sh.lo = ~0ull;
    sh.hi = 0ull;
  }
  __syncthreads();

  // ---- stage the chunk (one read of scores, mask and ids) and count the --
  // ---- top kBits bits of its words ----------------------------------------
  for (int g0 = 0; g0 < groups; g0 += kStageUnroll * kChunkThreads) {
    float s[kStageUnroll][4];
    bool ok[kStageUnroll][4];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int g = g0 + u * kChunkThreads + threadIdx.x;
      const int e = 4 * g;  // chunk-local index of the group's first entry
      const int64_t p = first + e;
      if (vec && e < len) {  // len is a multiple of 4 on this path
        const float4 v = *reinterpret_cast<const float4*>(rs + p);
        s[u][0] = v.x; s[u][1] = v.y; s[u][2] = v.z; s[u][3] = v.w;
        uint32_t mk = 0x01010101u;
        if (rm) mk = *reinterpret_cast<const uint32_t*>(rm + p);
        int4 iv = make_int4(0, 0, 0, 0);
        if (ri) iv = *reinterpret_cast<const int4*>(ri + p);
        ok[u][0] = (mk & 0xFFu) && iv.x >= 0;
        ok[u][1] = (mk & 0xFF00u) && iv.y >= 0;
        ok[u][2] = (mk & 0xFF0000u) && iv.z >= 0;
        ok[u][3] = (mk & 0xFF000000u) && iv.w >= 0;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = e + j < len;
          s[u][j] = in ? rs[p + j] : -CUDART_INF_F;
          ok[u][j] = in && (!rm || rm[p + j]) && (!ri || ri[p + j] >= 0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int g = g0 + u * kChunkThreads + threadIdx.x;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = entry_word(s[u][j], ok[u][j]);
        // spread BM25 scores rarely share a bin within a warp: plain
        // atomics beat a warp vote here, ties included (measured)
        if (w[j]) atomicAdd(&hist[w[j] >> (32 - kBits)], 1u);
      }
      if (g < groups) words[g] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  __syncthreads();
  const StagedKeys<kChunkThreads> keys{words, groups, (uint32_t)first};

  if (cand == nullptr) {  // the whole row: select, sort, write
    const uint32_t nsel = select_top<kChunkThreads>(
        keys, (uint32_t)k, 0u, hist, list, kList1,
        [&](uint32_t) { return sbuf; }, sh);
    __syncthreads();
    sort_and_write<kChunkThreads>(sbuf, kpad, nsel, k, rs, ri,
                                  out_scores + row * k, out_ids + row * k);
    if (threadIdx.x == 0) out_count[row] = (int32_t)sh.eligible;
    return;
  }
  uint32_t* rstate = state + row * kRowState;
  for (int i = threadIdx.x; i < kBins; i += kChunkThreads)
    if (hist[i]) atomicAdd(&rstate[kHistAt + i], hist[i]);
  // up to 2k keys a chunk: its top-k and the rest of the k-th key's bin
  const int64_t cap = (int64_t)chunks * min(2 * k, chunk);
  select_top<kChunkThreads>(
      keys, (uint32_t)k, (uint32_t)k, hist, nullptr, 0u,
      [&](uint32_t n) {
        if (threadIdx.x == 0) sh.slot_base = atomicAdd(&rstate[0], n);
        __syncthreads();
        return cand + row * cap + sh.slot_base;
      },
      sh);
}

// Stage 2: one block per row over its chunks' candidates.
__global__ void __launch_bounds__(kRowThreads)
merge_candidates_kernel(const float* __restrict__ scores,
                        const int32_t* __restrict__ ids, int m, int k,
                        int kpad, int64_t cap, int list_cap,
                        const uint64_t* __restrict__ cand,
                        const uint32_t* __restrict__ state,
                        float* __restrict__ out_scores,
                        int32_t* __restrict__ out_ids,
                        int32_t* __restrict__ out_count) {
  extern __shared__ uint4 smem4[];
  __shared__ SelectShared sh;
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem4);
  uint64_t* sbuf = reinterpret_cast<uint64_t*>(hist + kBins);
  uint64_t* list = sbuf + kpad;
  const int64_t row = blockIdx.x;
  const uint32_t* rstate = state + row * kRowState;
  for (int i = threadIdx.x; i < kBins; i += kRowThreads)
    hist[i] = rstate[kHistAt + i];
  if (threadIdx.x == 0) {
    sh.n = 0u;
    sh.m = 0u;
    sh.lo = ~0ull;
    sh.hi = 0ull;
  }
  __syncthreads();
  const KeyArray<kRowThreads, kUnroll> keys{cand + row * cap,
                                            (int)rstate[0]};
  const uint32_t nsel = select_top<kRowThreads>(
      keys, (uint32_t)k, 0u, hist, list, (uint32_t)list_cap,
      [&](uint32_t) { return sbuf; }, sh);
  __syncthreads();
  sort_and_write<kRowThreads>(sbuf, kpad, nsel, k, scores + row * m,
                              ids ? ids + row * m : nullptr,
                              out_scores + row * k, out_ids + row * k);
  if (threadIdx.x == 0) out_count[row] = (int32_t)sh.eligible;
}

// ---- k above the one-block sort (k > chunk) --------------------------------
// Stage 1 then sends every eligible key of its chunk to the candidates (a
// chunk holds fewer than k), building the row histogram as before. Stage 2,
// many blocks per row, each over a slice of the candidates: every block
// takes the bin of the row's k-th key from the row histogram, sends the keys
// above that bin straight to the row's run buffer of `run_len` keys (a
// multiple of kTile) and lists the bin's own keys in a second buffer. Stage
// 3, one block per row, resolves the bin list by radix passes until the
// boundary holds exactly the keys wanted and appends them to the run, the
// rest of the run zero. Stage 4 sorts the run in kTile-key tiles in shared
// memory with the bitonic sort, a block a tile; stage 5 merges sorted runs
// pairwise in device memory, each thread placing kMergeItems outputs after a
// merge-path binary search of its first one, until one run is left; stage 6
// writes its first k keys.

constexpr int kTile = 2048;          // keys a tile-sorting block sorts
constexpr int kTileThreads = 512;
constexpr int kSplitKeys = kUnroll * kRowThreads;  // candidates a stage-2
                                                   // block reads
constexpr int kMergeItems = 8;       // outputs a merging thread places
// per row of the candidate state: keys in the run, keys in the bin list
constexpr int kRunFill = 1;
constexpr int kBinFill = 2;

// Stage 2 for a large k: one block per (row, slice of kSplitKeys candidates).
__global__ void __launch_bounds__(kRowThreads)
split_candidates_kernel(int k, int64_t cap, int slices, int run_len,
                        const uint64_t* __restrict__ cand,
                        uint32_t* __restrict__ state,
                        uint64_t* __restrict__ runs,
                        uint64_t* __restrict__ bins) {
  __shared__ uint32_t hist[kBins];
  __shared__ SelectShared sh;
  const int64_t row = blockIdx.x / slices;
  const int first = (blockIdx.x % slices) * kSplitKeys;
  uint32_t* rstate = state + row * kRowState;
  const int n_row = (int)rstate[0];
  if (first >= n_row) return;  // the whole block: a slice past the fill
  for (int i = threadIdx.x; i < kBins; i += kRowThreads)
    hist[i] = rstate[kHistAt + i];
  __syncthreads();
  Radix st{0ull, 0, (uint32_t)k};
  descend<kRowThreads>(hist, st, kBits, sh);
  const KeyArray<kRowThreads, kUnroll> keys{
      cand + row * cap + first, min(kSplitKeys, n_row - first)};
  uint64_t* run = runs + row * run_len;
  if (sh.total <= (uint32_t)k) {  // every eligible key is wanted
    emit(keys, [](uint64_t key) { return key != 0ull; }, run,
         &rstate[kRunFill]);
    return;
  }
  const Radix bin = st;
  emit(keys, [&](uint64_t key) { return above(key, bin); }, run,
       &rstate[kRunFill], [&](uint64_t key) { return under(key, bin); },
       bins + row * cap, &rstate[kBinFill], (uint32_t)cap);
}

// Stage 3 for a large k: one block per row over its boundary bin's list.
__global__ void __launch_bounds__(kRowThreads)
select_run_kernel(int k, int64_t cap, int run_len,
                  const uint64_t* __restrict__ bins,
                  const uint32_t* __restrict__ state,
                  uint64_t* __restrict__ runs,
                  int32_t* __restrict__ out_count) {
  __shared__ uint32_t hist[kBins];
  __shared__ SelectShared sh;
  const int64_t row = blockIdx.x;
  const uint32_t* rstate = state + row * kRowState;
  for (int i = threadIdx.x; i < kBins; i += kRowThreads)
    hist[i] = rstate[kHistAt + i];
  if (threadIdx.x == 0) {
    sh.lo = ~0ull;
    sh.hi = 0ull;
  }
  __syncthreads();
  Radix st{0ull, 0, (uint32_t)k};
  uint32_t cnt = descend<kRowThreads>(hist, st, kBits, sh);
  const uint32_t total = sh.total;
  uint64_t* run = runs + row * run_len;
  uint32_t n = total;
  if (total > (uint32_t)k) {
    // the k - rank keys above the bin are in the run; the bin's cnt keys
    // are listed, and the rank best of them complete the run
    if (threadIdx.x == 0) sh.n = (uint32_t)k - st.rank;
    __syncthreads();
    const KeyArray<kRowThreads, kUnroll> kept{bins + row * cap, (int)cnt};
    if (cnt != st.rank) narrow(kept, st, sh);
    while (cnt != st.rank && st.pbits < 64)
      cnt = radix_pass<kRowThreads>(kept, st, hist, sh);
    emit(kept, [&](uint64_t key) { return picked(key, st); }, run, &sh.n);
    n = (uint32_t)k;
  }
  __syncthreads();
  for (int i = n + threadIdx.x; i < run_len; i += kRowThreads) run[i] = 0ull;
  if (threadIdx.x == 0) out_count[row] = (int32_t)total;
}

// Stage 4: one block per (row, tile of kTile keys), sorted in place.
__global__ void __launch_bounds__(kTileThreads)
sort_tiles_kernel(int run_len, uint64_t* __restrict__ runs) {
  __shared__ uint64_t sbuf[kTile];
  const int tiles = run_len / kTile;
  uint64_t* tile = runs + (int64_t)(blockIdx.x / tiles) * run_len +
                   (int64_t)(blockIdx.x % tiles) * kTile;
  for (int i = threadIdx.x; i < kTile; i += kTileThreads) sbuf[i] = tile[i];
  __syncthreads();
  bitonic_sort_desc<kTileThreads>(sbuf, kTile);
  for (int i = threadIdx.x; i < kTile; i += kTileThreads) tile[i] = sbuf[i];
}

// Stage 5: merge the descending runs of `width` keys of src pairwise into
// runs of 2 x width in dst (a lone last run is copied).
__global__ void merge_runs_kernel(int rows, int run_len, int width,
                                  const uint64_t* __restrict__ src,
                                  uint64_t* __restrict__ dst) {
  const int per_row = run_len / kMergeItems;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)rows * per_row) return;
  const int64_t row = t / per_row;
  const int o = (int)(t % per_row) * kMergeItems;
  const int start = o / (2 * width) * (2 * width);
  const uint64_t* a = src + row * run_len + start;
  const int la = min(width, run_len - start);
  const uint64_t* b = a + la;
  const int lb = max(0, min(width, run_len - start - width));
  const int d = o - start;
  // i: keys of a among the first d outputs (a first on equal keys)
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] >= b[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  int i = lo, j = d - lo;
  uint64_t* out = dst + row * run_len + o;
#pragma unroll
  for (int e = 0; e < kMergeItems; ++e) {
    const bool take_a = i < la && (j >= lb || a[i] >= b[j]);
    out[e] = take_a ? a[i++] : b[j++];
  }
}

// Stage 6: the first k keys of each row's run → results.
__global__ void write_run_kernel(int k, int run_len, int m,
                                 const uint64_t* __restrict__ runs,
                                 const float* __restrict__ scores,
                                 const int32_t* __restrict__ ids,
                                 float* __restrict__ out_scores,
                                 int32_t* __restrict__ out_ids) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = blockIdx.y;
  if (j >= k) return;
  write_key(runs[row * run_len + j], scores + row * m,
            ids ? ids + row * m : nullptr, out_scores + row * k + j,
            out_ids + row * k + j);
}

// Stages 2-6 for k > chunk; `cand` holds 2 x rows x cap keys (the
// candidates, then the boundary-bin lists) and `runs` 2 x rows x run_len.
cudaError_t large_k(const float* scores, const int32_t* ids, int rows, int m,
                    int k, int64_t cap, uint64_t* cand, uint32_t* state,
                    uint64_t* runs, float* out_scores, int32_t* out_ids,
                    int32_t* out_count, cudaStream_t s) {
  const int run_len = (k + kTile - 1) / kTile * kTile;
  const int tiles = run_len / kTile;
  const int slices = (int)((cap + kSplitKeys - 1) / kSplitKeys);
  uint64_t* bins = cand + (int64_t)rows * cap;
  uint64_t* src = runs;
  uint64_t* dst = runs + (int64_t)rows * run_len;
  split_candidates_kernel<<<(unsigned)rows * slices, kRowThreads, 0, s>>>(
      k, cap, slices, run_len, cand, state, src, bins);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  select_run_kernel<<<rows, kRowThreads, 0, s>>>(k, cap, run_len, bins, state,
                                                 src, out_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sort_tiles_kernel<<<(unsigned)rows * tiles, kTileThreads, 0, s>>>(run_len,
                                                                    src);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t threads = (int64_t)rows * (run_len / kMergeItems);
  for (int width = kTile; width < run_len; width *= 2) {
    merge_runs_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
        rows, run_len, width, src, dst);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    uint64_t* t = src;
    src = dst;
    dst = t;
  }
  write_run_kernel<<<dim3((unsigned)((k + 255) / 256), (unsigned)rows), 256,
                     0, s>>>(k, run_len, m, src, scores, ids, out_scores,
                             out_ids);
  return cudaGetLastError();
}

}  // namespace

// `chunk` entries per stage-1 block (a multiple of 4). A row of more than
// `chunk` entries needs `cand` ([rows, ceil(m / chunk) * min(2k, chunk)]
// 64-bit keys) and `state` ([rows, 4 + 4096] zeroed 32-bit counters); with
// k > chunk as well, `cand` twice that ([2, rows, ceil(m / chunk) * chunk])
// and `runs` ([2, rows, ceil(k / 2048) * 2048] 64-bit keys).
extern "C" int topk_launch(const void* scores, const void* mask,
                           const void* ids, int rows, int m, int k, int kpad,
                           int chunk, void* cand, void* state, void* runs,
                           void* out_scores, void* out_ids, void* out_count,
                           void* stream) {
  const int chunks = (m + chunk - 1) / chunk;
  const bool split = chunks > 1;
  const bool large = split && k > chunk;
  if ((split && (cand == nullptr || state == nullptr)) ||
      (large && runs == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vec = m % 4 == 0 && (uintptr_t)scores % 16 == 0 &&
                  (uintptr_t)mask % 4 == 0 && (uintptr_t)ids % 16 == 0;
  const int span = split ? chunk : m;
  constexpr int kGroupStep = 4 * kChunkThreads;
  const size_t stage =
      (size_t)((span + kGroupStep - 1) / kGroupStep) * kGroupStep * 4;
  size_t smem1 = stage + kBins * sizeof(uint32_t);
  if (!split)
    smem1 += (kList1 + (size_t)kpad) * sizeof(uint64_t);
  // the limit is the most any call may take (beside the static
  // SelectShared), not this call's size: shards call from several threads,
  // and a smaller limit set by another thread between this setting and the
  // launch would refuse the launch
  cudaError_t err = cudaFuncSetAttribute(
      chunk_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax - (int)sizeof(SelectShared));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(chunk_topk_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  chunk_topk_kernel<<<(unsigned)rows * chunks, kChunkThreads, smem1,
                      (cudaStream_t)stream>>>(
      (const float*)scores, (const uint8_t*)mask, (const int32_t*)ids, m, k,
      kpad, chunk, chunks, vec, split ? (uint64_t*)cand : nullptr,
      (uint32_t*)state, (float*)out_scores, (int32_t*)out_ids,
      (int32_t*)out_count);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  if (large)
    return (int)large_k((const float*)scores, (const int32_t*)ids, rows, m,
                        k, (int64_t)chunks * chunk, (uint64_t*)cand,
                        (uint32_t*)state, (uint64_t*)runs,
                        (float*)out_scores, (int32_t*)out_ids,
                        (int32_t*)out_count, (cudaStream_t)stream);

  // the boundary-bin list takes what shared memory the block has left
  const size_t smem2 = kSmemMax - sizeof(SelectShared);
  const int list_cap = (int)((smem2 - kBins * sizeof(uint32_t)) /
                             sizeof(uint64_t)) - kpad;
  err = cudaFuncSetAttribute(merge_candidates_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const int64_t cap = (int64_t)chunks * (2 * k < chunk ? 2 * k : chunk);
  merge_candidates_kernel<<<rows, kRowThreads, smem2, (cudaStream_t)stream>>>(
      (const float*)scores, (const int32_t*)ids, m, k, kpad, cap, list_cap,
      (const uint64_t*)cand, (const uint32_t*)state, (float*)out_scores,
      (int32_t*)out_ids, (int32_t*)out_count);
  return (int)cudaGetLastError();
}

extern "C" const char* topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
