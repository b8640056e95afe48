// K7: the block-max pruned sweep of one segment, for a batch of queries.
//
// Replaces elasticsearch_tpu/ops/blockmax.py:pruned_segment_topk (a lax.scan
// over the blocks with a lax.cond hot/cold branch) as
// search/jit_exec.py:run_impact_pruned runs it under lax.map, one query at a
// time, threading a carry across segments. For each query q, over the
// segment's NB blocks of r = N / NB rows in the given order (order[q,:], the
// stable argsort of -ub_f):
//
//   theta = the running k-th score (-inf until k slots are filled)
//   a block b runs iff ub_i[q,b] > 0 && ub_f[q,b] >= theta
//   a running block scores its rows as K6 does (integer sum of the impacts of
//   the slots holding q's terms, sf = f32(qsum) * scale_boost[q], valid =
//   anyhit && live && cursor), merges its valid rows into the running top-k
//   by (score desc, doc asc), and counts scored += 1, matched += sum(valid);
//   a skipped block counts skipped += 1 and reads none of its rows.
//
// The carry is (ts [B,k] f32, td [B,k] int32 global ids, scored, skipped,
// matched [B] int32), read at the start and written at the end (in place).
// Empty slots are (-inf, -1).
//
// What bounds it on an H100: the bytes of the distinct blocks the batch
// scores, each read once (each row's term ids up to its first pad, the
// impacts of its hits) plus the small tables; the skip is the point, so the
// work depends on the data.
// What its design does about it:
//   * the sweep is sequential per query by contract: the counters are
//     outputs (the drain reports `matched` as the hit total), so theta must
//     be the k-th score that every earlier block left, as in the lax.scan. A
//     stale theta shared across blocks would change the counters. So each
//     query walks its blocks in order, and the parallelism is inside a
//     block: a query gets a cluster of thread blocks (CTAs) on neighbouring
//     SMs, as many as fill the card twice over for the batch (up to 8; two
//     waves, so the clusters of queries that score few blocks make room
//     for the rest), and each CTA scores its own slice of every block's
//     rows. Every CTA holds the same running top-k in its shared memory and
//     takes the same run/skip decisions; after each slice the CTAs exchange
//     their candidates through distributed shared memory and each merges
//     all of them, so the copies stay equal. A block two queries score is
//     read twice: sharing those reads is what is left between this design
//     and its bound;
//   * a CTA's 32 warps each take 4 consecutive rows at a time, lanes over a
//     row's cells: the first two 32-cell windows of all 4 rows are loaded
//     into registers before any is compared, then the rows that go on past
//     64 cells load their next windows together, until each stops at its
//     first pad. A cell's test is a few register compares (a query's first
//     four terms live in registers) and a row's impacts are read only where
//     a cell holds a term. The loop is kept small (the rare paths out of
//     line): unrolled wider, the kernel outgrew the instruction cache;
//   * the visiting order and the bounds are staged in shared memory, so a
//     run of skipped blocks costs no global load;
//   * the running top-k and its merge buffer are 64-bit keys, (score
//     descending, doc ascending) in one unsigned order: the score's bits
//     mapped to an order-preserving integer and inverted, then the doc id.
//     Keys are unique (doc ids are), so a merge is a rank computation. Both
//     lists (2 * k keys) live in dynamic shared memory while they fit
//     (k <= kSmemK); past that each CTA keeps them in its own slice of a
//     global scratch buffer the caller allocates, so any k is served;
//   * a row whose key is not below the k-th key cannot enter the top-k, so
//     only the others are appended to the CTA's candidate list (a row equal
//     in score to theta with a smaller doc id does enter: ties are kept).
//     Each CTA sorts its list (bitonic, in shared memory) and keeps its first
//     k; then each CTA places every element of the running list and of the
//     cluster's lists at its rank in their union, keeping the first k.
//     Merging a block's rows slice by slice gives the top-k of the union,
//     whatever the order;
//   * the run test of the next block reads the k-th key after the merge.
// The scores are bit-identical to the plain version's (one integer sum and
// one __fmul_rn), and so are the top-k, the order and the counters, for any
// cluster size.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;           // rows a warp loads at once
constexpr int kPreload = 2;        // 32-cell windows of each loaded at once
constexpr int kSmemK = 12288;      // largest k whose lists fit in shared
                                   // memory (ops/blockmax.K7_SMEM_K)
// The dynamic shared-memory limit each launch sets: the most any call may
// take (C3: a per-call limit races across threads).
constexpr int kDynSmemMax = 2 * kSmemK * 8;
constexpr int kSlice = 2048;       // rows a CTA scores between merges
constexpr int kTile = 1024;        // visiting order staged at a time
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kWaves = 2;          // clusters fill the SMs this many times
constexpr int kMaxTerms = 255;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kEmpty = ~0ull;

__device__ __forceinline__ uint64_t make_key(float score, int32_t doc) {
  if (doc < 0) return kEmpty;
  const uint32_t b = __float_as_uint(score);
  const uint32_t asc = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((uint64_t)(~asc) << 32) | (uint32_t)doc;
}

__device__ __forceinline__ float key_score(uint64_t key) {
  if (key == kEmpty) return __uint_as_float(0xff800000u);  // -inf
  const uint32_t asc = ~(uint32_t)(key >> 32);
  const uint32_t b = (asc & 0x80000000u) ? (asc & 0x7fffffffu) : ~asc;
  return __uint_as_float(b);
}

__device__ __forceinline__ int32_t key_doc(uint64_t key) {
  return key == kEmpty ? -1 : (int32_t)(uint32_t)key;
}

// number of entries of the ascending list a[0..n) below x
__device__ __forceinline__ int rank_below(const uint64_t* a, int n,
                                          uint64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the query's terms: the first kRegTerms in registers (-1 past the end, as
// a term absent from the segment is: no cell that holds a term is
// negative), all of them in shared memory
constexpr int kRegTerms = 4;
struct Terms {
  int32_t reg[kRegTerms];
  const int32_t* all;  // every term, in shared memory
  int n_terms;
};

// the number of the query's terms that `cell` is (a term twice in the query
// counts twice); out of line, since only a hit calls it
__device__ __noinline__ int term_count(int32_t cell, const int32_t* s_terms,
                                       int n_terms) {
  int n = 0;
  for (int t = 0; t < n_terms; ++t) n += s_terms[t] == cell;
  return n;
}

// one lane's cell of a row: add the impact of every query term it holds.
// The test is a few register compares (kRest: and the terms past
// kRegTerms); the impact is read only on a hit, which is rare
template <bool kRest, typename Q>
__device__ __forceinline__ void scan_cell(int32_t cell, const Q* row_q, int u,
                                          const Terms& terms, int32_t& qs,
                                          unsigned& hits, unsigned bit) {
  bool m = false;
#pragma unroll
  for (int t = 0; t < kRegTerms; ++t) m |= terms.reg[t] == cell;
  if (kRest) {
#pragma unroll 1
    for (int t = kRegTerms; t < terms.n_terms; ++t)
      m |= terms.all[t] == cell;
  }
  if (m && cell >= 0) {
    qs += (int32_t)row_q[u] * term_count(cell, terms.all, terms.n_terms);
    hits |= bit;
  }
}

// whether a row goes on past the window just scanned (`w` is the lane's
// cell of it, `u0` the window's first cell); warp-uniform
__device__ __forceinline__ bool row_goes_on(int32_t w, int u0, int n_unique,
                                            int trailing_pad) {
  const bool more = u0 + 32 < n_unique;
  const int32_t last = __shfl_sync(kFull, w, 31);
  return more && (!trailing_pad || last >= 0);
}

// Scores rows [r0, r1) of the segment for one query; appends the valid rows
// whose key is below `kth` to s_own and counts the valid rows in `matched`.
template <bool kRest, typename Q>
__device__ __forceinline__ void score_rows(
    const int32_t* __restrict__ uterms, const Q* __restrict__ qimp,
    const uint8_t* __restrict__ live, int n_unique, int r0, int r1,
    const Terms& terms, float sb, float cur_s, int32_t cur_d, int doc_base,
    int trailing_pad, uint64_t kth, uint64_t* s_own, int* s_n, int& matched,
    int lane, int warp) {
  for (int g = r0 + warp * kRows; g < r1; g += kWarps * kRows) {
    // the first kPreload windows of kRows rows, every load issued before
    // any cell is compared (past a trailing pad they hold pads)
    int32_t w[kPreload][kRows];
#pragma unroll
    for (int p = 0; p < kPreload; ++p) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int u = 32 * p + lane;
        w[p][r] = g + r < r1 && u < n_unique
                      ? __ldg(uterms + (int64_t)(g + r) * n_unique + u)
                      : -1;
      }
    }
    int32_t qs[kRows];
    unsigned hits = 0;  // bit r: this lane found a query term in row g + r
    unsigned open = 0;  // rows that go on past the preload (warp-uniform)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const Q* rq = qimp + (int64_t)(g + r) * n_unique;
      qs[r] = 0;
#pragma unroll
      for (int p = 0; p < kPreload; ++p)
        scan_cell<kRest>(w[p][r], rq, 32 * p + lane, terms, qs[r], hits,
                         1u << r);
      if (g + r < r1 && row_goes_on(w[kPreload - 1][r], 32 * (kPreload - 1),
                                    n_unique, trailing_pad))
        open |= 1u << r;
    }
    for (int u0 = 32 * kPreload; open; u0 += 32) {
      int32_t c[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        c[r] = (open >> r & 1) && u0 + lane < n_unique
                   ? __ldg(uterms + (int64_t)(g + r) * n_unique + u0 + lane)
                   : -1;
      unsigned next = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (open >> r & 1) {
          scan_cell<kRest>(c[r], qimp + (int64_t)(g + r) * n_unique,
                           u0 + lane, terms, qs[r], hits, 1u << r);
          if (row_goes_on(c[r], u0, n_unique, trailing_pad)) next |= 1u << r;
        }
      }
      open = next;
    }
    const unsigned any = __reduce_or_sync(kFull, hits);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!(any >> r & 1)) continue;  // warp-uniform
      const int32_t qsum = __reduce_add_sync(kFull, qs[r]);
      const int d = g + r;
      if (lane == 0 && live[d]) {
        const float sf = __fmul_rn(__int2float_rn(qsum), sb);
        const int32_t gid = d + doc_base;
        if (sf < cur_s || (sf == cur_s && gid > cur_d)) {
          ++matched;
          const uint64_t key = make_key(sf, gid);
          if (key < kth) s_own[atomicAdd(s_n, 1)] = key;
        }
      }
    }
  }
}

// ascending bitonic sort of a[0..n) in shared memory, n <= kSlice
__device__ void sort_keys(uint64_t* a, int n) {
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  for (int i = n + threadIdx.x; i < p2; i += kThreads) a[i] = kEmpty;
  __syncthreads();
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p2; i += kThreads) {
        const int other = i ^ stride;
        if (other > i) {
          const uint64_t x = a[i], y = a[other];
          const bool up = (i & size) == 0;
          if ((x > y) == up) {
            a[i] = y;
            a[other] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// kGlobalTop: the running top-k and its merge buffer live in `scratch`
// (k > kSmemK), else in dynamic shared memory
template <typename Q, bool kGlobalTop>
__global__ void __launch_bounds__(kThreads, 1)
blockmax_sweep_kernel(const int32_t* __restrict__ uterms,
                      const Q* __restrict__ qimp,
                      const uint8_t* __restrict__ live, int n_unique,
                      int n_blocks, int rows_per_block,
                      const int32_t* __restrict__ ub_i,
                      const float* __restrict__ ub_f,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ qtids, int n_terms,
                      const float* __restrict__ scale_boost,
                      const float* __restrict__ cs,
                      const int32_t* __restrict__ cd, int k, int doc_base,
                      int trailing_pad, float* __restrict__ ts,
                      int32_t* __restrict__ td, int32_t* __restrict__ scored,
                      int32_t* __restrict__ skipped,
                      int32_t* __restrict__ matched,
                      uint64_t* __restrict__ scratch) {
  extern __shared__ __align__(16) uint64_t s_dyn[];
  __shared__ uint64_t s_own[kSlice];  // this CTA's candidates of a slice
  __shared__ int32_t s_bi[kTile];     // staged order; -1: ub_i == 0
  __shared__ float s_ubf[kTile];
  __shared__ int32_t s_terms[kMaxTerms];
  __shared__ int s_n;                 // candidates appended to s_own
  __shared__ int s_nk;                // s_own's length after the cut to k
  __shared__ int s_cnt[kMaxCluster];  // every CTA's s_nk, for the merge
  __shared__ int s_matched;

  // the running top-k (ascending keys) and the merge's buffer: in shared
  // memory, or this CTA's slice of the global scratch when k > kSmemK
  uint64_t* s_top =
      kGlobalTop ? scratch + (int64_t)blockIdx.x * 2 * k : s_dyn;
  uint64_t* s_tmp = s_top + k;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int q = blockIdx.x / n_ctas;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < n_terms; t += kThreads)
    s_terms[t] = qtids[(int64_t)q * n_terms + t];
  Terms terms;
#pragma unroll
  for (int t = 0; t < kRegTerms; ++t)
    terms.reg[t] = t < n_terms ? qtids[(int64_t)q * n_terms + t] : -1;
  terms.all = s_terms;
  terms.n_terms = n_terms;
  for (int i = threadIdx.x; i < k; i += kThreads)
    s_top[i] = make_key(ts[(int64_t)q * k + i], td[(int64_t)q * k + i]);
  if (threadIdx.x == 0) {
    s_n = 0;
    s_matched = 0;
  }
  const float sb = scale_boost[q];
  const float cur_s = cs[q];
  const int32_t cur_d = cd[q];
  int n_scored = 0, n_skipped = 0, my_matched = 0;
  const int64_t qb = (int64_t)q * n_blocks;
  // this CTA's rows of every block, in slices; every CTA walks as many
  // slices as the first (the cluster meets after each)
  const int share = (rows_per_block + n_ctas - 1) / n_ctas;
  const int my_lo = min(rows_per_block, rank * share);
  const int my_hi = min(rows_per_block, my_lo + share);
  const int n_slices = (share + kSlice - 1) / kSlice;

  for (int j0 = 0; j0 < n_blocks; j0 += kTile) {
    const int nt = min(kTile, n_blocks - j0);
    __syncthreads();  // the previous tile is read no more
    for (int t = threadIdx.x; t < nt; t += kThreads) {
      const int bi = order[qb + j0 + t];
      s_bi[t] = ub_i[qb + bi] > 0 ? bi : -1;
      s_ubf[t] = ub_f[qb + bi];
    }
    __syncthreads();
    for (int jt = 0; jt < nt; ++jt) {
      const int bi = s_bi[jt];
      if (bi < 0 || !(s_ubf[jt] >= key_score(s_top[k - 1]))) {
        ++n_skipped;  // every thread of the cluster takes the same branch
        continue;
      }
      ++n_scored;
      const int first_row = bi * rows_per_block;
      for (int sl = 0; sl < n_slices; ++sl) {
        const int lo = min(my_hi, my_lo + sl * kSlice);
        const int hi = min(my_hi, lo + kSlice);
        if (n_terms > kRegTerms)
          score_rows<true, Q>(uterms, qimp, live, n_unique, first_row + lo,
                              first_row + hi, terms, sb, cur_s, cur_d,
                              doc_base, trailing_pad, s_top[k - 1], s_own,
                              &s_n, my_matched, lane, warp);
        else
          score_rows<false, Q>(uterms, qimp, live, n_unique, first_row + lo,
                               first_row + hi, terms, sb, cur_s, cur_d,
                               doc_base, trailing_pad, s_top[k - 1], s_own,
                               &s_n, my_matched, lane, warp);
        __syncthreads();
        const int n_own = s_n;
        if (n_own > 1) sort_keys(s_own, n_own);  // ends with a barrier
        if (threadIdx.x == 0) s_nk = min(n_own, k);
        cluster.sync();  // every CTA's list is sorted and cut
        // ---- merge the running list and the cluster's lists by rank ----
        if (threadIdx.x < n_ctas)
          s_cnt[threadIdx.x] = *cluster.map_shared_rank(&s_nk, threadIdx.x);
        __syncthreads();
        int total = 0;
        for (int r = 0; r < n_ctas; ++r) total += s_cnt[r];
        if (total > 0) {  // uniform over the cluster
          for (int i = threadIdx.x; i < k; i += kThreads) s_tmp[i] = kEmpty;
          __syncthreads();
          for (int i = threadIdx.x; i < k; i += kThreads) {
            const uint64_t x = s_top[i];
            if (x == kEmpty) continue;
            int at = i;
            for (int r = 0; r < n_ctas; ++r)
              if (s_cnt[r])
                at += rank_below(cluster.map_shared_rank(s_own, r),
                                 s_cnt[r], x);
            if (at < k) s_tmp[at] = x;
          }
          for (int r = 0; r < n_ctas; ++r) {
            const uint64_t* list = cluster.map_shared_rank(s_own, r);
            for (int i = threadIdx.x; i < s_cnt[r]; i += kThreads) {
              const uint64_t x = list[i];
              int at = i + rank_below(s_top, k, x);
              for (int r2 = 0; r2 < n_ctas; ++r2)
                if (r2 != r && s_cnt[r2])
                  at += rank_below(cluster.map_shared_rank(s_own, r2),
                                   s_cnt[r2], x);
              if (at < k) s_tmp[at] = x;
            }
          }
        }
        cluster.sync();  // no CTA reads another's list any more
        if (total > 0)
          for (int i = threadIdx.x; i < k; i += kThreads) s_top[i] = s_tmp[i];
        if (threadIdx.x == 0) s_n = 0;
        __syncthreads();
      }
    }
  }

  // ---- write the carry back ------------------------------------------------
  if (lane == 0 && my_matched) atomicAdd(&s_matched, my_matched);
  __syncthreads();
  if (threadIdx.x == 0 && s_matched) atomicAdd(matched + q, s_matched);
  if (rank != 0) return;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const uint64_t key = s_top[i];
    ts[(int64_t)q * k + i] = key_score(key);
    td[(int64_t)q * k + i] = key_doc(key);
  }
  if (threadIdx.x == 0) {
    scored[q] += n_scored;
    skipped[q] += n_skipped;
  }
}

// CTAs a query's cluster gets: enough to fill the card kWaves times over for
// the batch (the clusters of a batch of B queries hold B * size CTAs of one
// SM each), at most 8 and at most what the device can place (asked once
// per device)
template <typename Q>
int cluster_size(int n_queries, cudaLaunchConfig_t cfg,
                 cudaLaunchAttribute attr) {
  static int sms_of[64], fits_of[64];  // 0: not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  const int slot = dev & 63;
  if (fits_of[slot] == 0) {
    int sms = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int fits = kMaxCluster;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cfg.dynamicSmemBytes = kDynSmemMax;
    for (; fits > 1; fits >>= 1) {
      attr.val.clusterDim.x = fits;
      cfg.gridDim = dim3(fits);
      int active = 0;
      if (cudaOccupancyMaxActiveClusters(
              &active, blockmax_sweep_kernel<Q, false>, &cfg) ==
              cudaSuccess &&
          active > 0)
        break;
      cudaGetLastError();  // clear a refused query; try a smaller cluster
    }
    sms_of[slot] = sms;
    fits_of[slot] = fits;
  }
  int c = 1;
  while (c < fits_of[slot] &&
         (int64_t)n_queries * c * 2 <= (int64_t)kWaves * sms_of[slot])
    c *= 2;
  return c;
}

template <typename Q>
int launch(const void* uterms, const void* qimp, const void* live,
           int n_unique, int n_blocks, int rows_per_block, const void* ub_i,
           const void* ub_f, const void* order, const void* qtids,
           int n_queries, int n_terms, const void* scale_boost,
           const void* cs, const void* cd, int k, int doc_base,
           int trailing_pad, void* ts, void* td, void* scored, void* skipped,
           void* matched, void* scratch, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      blockmax_sweep_kernel<Q, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kDynSmemMax);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = scratch != nullptr ? 0 : 2 * k * 8;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int c = cluster_size<Q>(n_queries, cfg, attr[0]);
  attr[0].val.clusterDim.x = c;
  cfg.gridDim = dim3(n_queries * c);
  e = cudaLaunchKernelEx(
      &cfg,
      scratch != nullptr ? blockmax_sweep_kernel<Q, true>
                         : blockmax_sweep_kernel<Q, false>,
      (const int32_t*)uterms, (const Q*)qimp,
      (const uint8_t*)live, n_unique, n_blocks, rows_per_block,
      (const int32_t*)ub_i, (const float*)ub_f, (const int32_t*)order,
      (const int32_t*)qtids, n_terms, (const float*)scale_boost,
      (const float*)cs, (const int32_t*)cd, k, doc_base, trailing_pad,
      (float*)ts, (int32_t*)td, (int32_t*)scored, (int32_t*)skipped,
      (int32_t*)matched, (uint64_t*)scratch);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// `bits` is 8 (qimp uint8) or 16 (qimp uint16); `live` is bool bytes. The
// carry (ts, td, scored, skipped, matched) is read and updated in place.
// `scratch` is NULL for k <= kSmemK; above it, 2 * k uint64 for each CTA of
// the launch (n_queries * kMaxCluster CTAs at most).
extern "C" int blockmax_sweep_launch(
    const void* uterms, const void* qimp, int bits, const void* live,
    int n_docs, int n_unique, int n_blocks, const void* ub_i,
    const void* ub_f, const void* order, const void* qtids, int n_queries,
    int n_terms, const void* scale_boost, const void* cs, const void* cd,
    int k, int doc_base, int trailing_pad, void* ts, void* td, void* scored,
    void* skipped, void* matched, void* scratch, void* stream) {
  if (n_docs <= 0 || n_queries <= 0 || n_unique <= 0 || n_blocks <= 0 ||
      n_docs % n_blocks || k < 1 || n_terms < 0 || n_terms > kMaxTerms ||
      (k > kSmemK) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const int rows_per_block = n_docs / n_blocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8)
    return launch<uint8_t>(uterms, qimp, live, n_unique, n_blocks,
                           rows_per_block, ub_i, ub_f, order, qtids,
                           n_queries, n_terms, scale_boost, cs, cd, k,
                           doc_base, trailing_pad, ts, td, scored, skipped,
                           matched, scratch, s);
  if (bits == 16)
    return launch<uint16_t>(uterms, qimp, live, n_unique, n_blocks,
                            rows_per_block, ub_i, ub_f, order, qtids,
                            n_queries, n_terms, scale_boost, cs, cd, k,
                            doc_base, trailing_pad, ts, td, scored, skipped,
                            matched, scratch, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* blockmax_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
