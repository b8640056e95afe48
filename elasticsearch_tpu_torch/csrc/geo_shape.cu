// K18: geo_shape relations of a batch over one segment's shape column.
//
// Replaces elasticsearch_tpu/ops/geoshape.py:shape_relation (:117) with its
// helpers _edge_cross_any (:43), _points_in_query_shape (:79) and
// _query_point_in_doc_shapes (:96), as the JAX package runs them under
// jax.vmap. A doc row is a vertex soup of V slots: lats, lons [V] f32, ring
// ids rid [V] i32 (-1 pads), area flags [V] and nv edge slots; an edge
// joins slots v and v + 1 when v < nv and both hold the same ring. The
// query is a soup of the same layout, its ring structure (qrid, qarea, the
// ring starts) shared by the batch and its coordinates per query. For each
// query q and row d:
//
//   cross     any valid doc edge meets any valid query edge (orientation
//             test, boundary contact included; all four orientations zero
//             = collinear, decided by the edges' bounding intervals)
//   doc_in    any doc ring-start vertex has odd parity in q's area rings
//   q_in      any query ring-start vertex has odd parity in d's area rings
//   intersects = exists & (cross | doc_in | q_in);  disjoint = exists & !
//   within     = exists & every doc vertex has odd parity in q & !cross
//   contains   = exists & every query vertex but the closing one has odd
//                parity in d & !cross
//
// What bounds it on an H100: operations, not bytes. A (row, query) pair
// tests every doc edge against every query edge (four orientations, ~20
// flops) and casts a ray from every doc vertex through the query's edges
// (~9 flops), so N x B x V x E pairs of ~30 flops each: at N = 2^20, B =
// 64, V = 32, E = 32 ~2 TFLOP against ~0.4 GB of columns. The design is one
// warp a doc row, its lanes over the row's vertex slots (32 at a time, more
// slots in further passes), each lane holding its vertex and the edge that
// starts there in registers, looping over the query's edges, which sit in
// shared memory (a warp's reads broadcast). A lane's own vertex parity
// comes out of its loop with no reduction; the parities of a query vertex
// inside the doc are one ballot a vertex. Only what the relation needs is
// computed: intersects stops at the first cross or inside vertex, contains
// at the first query vertex outside. Rows that do not exist are written 0
// without work. The reference's [N, V] intermediates per query edge never
// exist. Blocks are persistent over rows; grid y runs over groups of
// queries whose coordinates fit in 48 KB (a query too long for that is read
// from global memory).
// Numerics: geo_common.cuh — every orientation and crossing is rounded as
// the plain version rounds it, so the masks are bit for bit equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "geo_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntersects = 0;
constexpr int kDisjoint = 1;
constexpr int kWithin = 2;
constexpr int kContains = 3;

// one lane's vertex slot v of a doc row and the edge from v to v + 1
struct Slot {
  float alat, alon, blat, blon;
  bool vvalid;  // rid[v] >= 0
  bool evalid;  // v < nv, rid[v] == rid[v + 1] >= 0
  bool earea;   // evalid and area[v]
  bool rstart;  // rid[v] >= 0 and v starts its ring
};

__device__ __forceinline__ Slot load_slot(
    const float* __restrict__ lats, const float* __restrict__ lons,
    const int32_t* __restrict__ rid, const uint8_t* __restrict__ area,
    size_t base, int v, int n_slots, int nv) {
  Slot s{0.f, 0.f, 0.f, 0.f, false, false, false, false};
  if (v >= n_slots) return s;
  const int r = rid[base + v];
  s.alat = lats[base + v];
  s.alon = lons[base + v];
  s.vvalid = r >= 0;
  s.rstart = r >= 0 && (v == 0 || rid[base + v - 1] != r);
  if (v + 1 < n_slots) {
    s.blat = lats[base + v + 1];
    s.blon = lons[base + v + 1];
    s.evalid = v < nv && r >= 0 && rid[base + v + 1] == r;
    s.earea = s.evalid && area[base + v] != 0;
  }
  return s;
}

// does the doc edge (a, b) meet the query edge (c, d)? (_edge_cross_any)
__device__ __forceinline__ bool edges_meet(const Slot& s, float clat,
                                           float clon, float dlat,
                                           float dlon) {
  const float o1 = geo::orient(s.alon, s.alat, s.blon, s.blat, clon, clat);
  const float o2 = geo::orient(s.alon, s.alat, s.blon, s.blat, dlon, dlat);
  const float o3 = geo::orient(clon, clat, dlon, dlat, s.alon, s.alat);
  const float o4 = geo::orient(clon, clat, dlon, dlat, s.blon, s.blat);
  const bool hit = __fmul_rn(o1, o2) <= 0.0f && __fmul_rn(o3, o4) <= 0.0f;
  if (!hit) return false;
  const bool collinear = o1 == 0.0f && o2 == 0.0f && o3 == 0.0f && o4 == 0.0f;
  if (!collinear) return true;
  return fminf(s.alat, s.blat) <= fmaxf(clat, dlat) &&
         fmaxf(s.alat, s.blat) >= fminf(clat, dlat) &&
         fminf(s.alon, s.blon) <= fmaxf(clon, dlon) &&
         fmaxf(s.alon, s.blon) >= fminf(clon, dlon);
}

template <int kRel>
__global__ void __launch_bounds__(kThreads)
geo_shape_kernel(const float* __restrict__ lats,
                 const float* __restrict__ lons,
                 const int32_t* __restrict__ rid,
                 const uint8_t* __restrict__ area,
                 const int32_t* __restrict__ nv,
                 const uint8_t* __restrict__ exists, int n, int n_slots,
                 const float* __restrict__ qlats,
                 const float* __restrict__ qlons, int n_queries, int qlen,
                 const int32_t* __restrict__ qmeta, int n_starts, int group,
                 int staged, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem_i[];
  // qrid [qlen], qarea [qlen], ring starts [n_starts], then the group's
  // coordinates: lats [group, qlen], lons [group, qlen]
  const int meta = 2 * qlen + n_starts;
  const int32_t* s_rid = smem_i;
  const int32_t* s_area = smem_i + qlen;
  const int32_t* s_start = smem_i + 2 * qlen;
  float* s_lat = reinterpret_cast<float*>(smem_i + meta);
  float* s_lon = s_lat + (staged ? group * qlen : 0);
  const int q0 = blockIdx.y * group;
  const int gq = min(group, n_queries - q0);
  for (int i = threadIdx.x; i < meta; i += kThreads) smem_i[i] = qmeta[i];
  if (staged) {
    for (int i = threadIdx.x; i < gq * qlen; i += kThreads) {
      s_lat[i] = qlats[(size_t)q0 * qlen + i];
      s_lon[i] = qlons[(size_t)q0 * qlen + i];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int e = qlen - 1;
  const int passes = (n_slots + 31) / 32;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < n;
       row += gridDim.x * kWarps) {
    if (!exists[row]) {
      for (int j = lane; j < gq; j += 32)
        out[(size_t)(q0 + j) * n + row] = 0;
      continue;
    }
    const int row_nv = nv[row];
    const size_t base = (size_t)row * n_slots;
    Slot s = load_slot(lats, lons, rid, area, base, lane, n_slots, row_nv);
    int loaded = 0;
    auto get = [&](int pass) -> const Slot& {
      if (pass != loaded) {
        s = load_slot(lats, lons, rid, area, base, pass * 32 + lane,
                      n_slots, row_nv);
        loaded = pass;
      }
      return s;
    };
    for (int j = 0; j < gq; ++j) {
      const float* ql = staged ? s_lat + j * qlen
                               : qlats + (size_t)(q0 + j) * qlen;
      const float* qo = staged ? s_lon + j * qlen
                               : qlons + (size_t)(q0 + j) * qlen;
      bool cross = false;   // warp-uniform
      bool doc_in = false;  // intersects, disjoint: a ring start inside
      bool all_in = true;   // within: every vertex inside
      for (int pass = 0; pass < passes; ++pass) {
        const Slot& t = get(pass);
        bool meet = false;
        bool parity = false;
        for (int i = 0; i < e; ++i) {
          if (s_rid[i] != s_rid[i + 1]) continue;
          const float clat = ql[i], clon = qo[i];
          const float dlat = ql[i + 1], dlon = qo[i + 1];
          if (t.evalid && !meet) meet = edges_meet(t, clat, clon, dlat, dlon);
          if (kRel != kContains && s_area[i])
            parity ^= geo::ray_flip(t.alat, t.alon, clat, clon, dlat, dlon);
        }
        cross = cross || __any_sync(kFull, meet);
        if (kRel == kIntersects || kRel == kDisjoint)
          doc_in = doc_in || __any_sync(kFull, t.rstart && parity);
        if (kRel == kWithin)
          all_in = all_in && __all_sync(kFull, !t.vvalid || parity);
      }
      bool result;
      if (kRel == kIntersects || kRel == kDisjoint) {
        bool inter = cross || doc_in;
        // one vertex of each query ring inside the doc's area rings
        for (int k = 0; k < n_starts && !inter; ++k) {
          const float py = ql[s_start[k]], px = qo[s_start[k]];
          unsigned par = 0;
          for (int pass = 0; pass < passes; ++pass) {
            const Slot& t = get(pass);
            par ^= __popc(__ballot_sync(
                kFull, t.earea &&
                           geo::ray_flip(py, px, t.alat, t.alon, t.blat,
                                         t.blon)));
          }
          inter = (par & 1u) != 0;
        }
        result = kRel == kIntersects ? inter : !inter;
      } else if (kRel == kWithin) {
        result = all_in && !cross;
      } else {  // kContains: every query vertex but the closing one inside
        bool all_q = !cross;
        for (int i = 0; i < e && all_q; ++i) {
          const float py = ql[i], px = qo[i];
          unsigned par = 0;
          for (int pass = 0; pass < passes; ++pass) {
            const Slot& t = get(pass);
            par ^= __popc(__ballot_sync(
                kFull, t.earea &&
                           geo::ray_flip(py, px, t.alat, t.alon, t.blat,
                                         t.blon)));
          }
          all_q = (par & 1u) != 0;
        }
        result = all_q;
      }
      if (lane == 0) out[(size_t)(q0 + j) * n + row] = result ? 1 : 0;
    }
  }
}

template <int kRel>
int launch(const float* lats, const float* lons, const int32_t* rid,
           const uint8_t* area, const int32_t* nv, const uint8_t* exists,
           int n, int n_slots, const float* qlats, const float* qlons,
           int n_queries, int qlen, const int32_t* qmeta, int n_starts,
           uint8_t* out, cudaStream_t stream) {
  constexpr int kBudget = 48 * 1024;
  const int meta_bytes = (2 * qlen + n_starts) * 4;
  if (meta_bytes > kBudget) return (int)cudaErrorInvalidValue;
  const int per_query = qlen * 8;
  const int staged = meta_bytes + per_query <= kBudget;
  int group = staged ? (kBudget - meta_bytes) / per_query : n_queries;
  if (group > n_queries) group = n_queries;
  if (group < 1) group = 1;
  const int groups = (n_queries + group - 1) / group;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = meta_bytes + (staged ? (size_t)group * per_query : 0);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = ((long long)n + kWarps - 1) / kWarps;
  const long long cap = (long long)sms * 8;
  if (blocks > cap) blocks = cap;
  dim3 grid((unsigned)blocks, (unsigned)groups);
  geo_shape_kernel<kRel><<<grid, kThreads, smem, stream>>>(
      lats, lons, rid, area, nv, exists, n, n_slots, qlats, qlons, n_queries,
      qlen, qmeta, n_starts, group, staged, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Doc rings lats, lons [n, n_slots] f32, rid [n, n_slots] i32, area
// [n, n_slots] u8, nv [n] i32, exists [n] u8; query coordinates qlats,
// qlons [n_queries, qlen] f32; qmeta [2 * qlen + n_starts] i32: the query's
// ring ids, area flags (0/1) and ring-start indices; out [n_queries, n] u8.
// relation: 0 intersects, 1 disjoint, 2 within, 3 contains.
extern "C" int geo_shape_launch(const void* lats, const void* lons,
                                const void* rid, const void* area,
                                const void* nv, const void* exists, int n,
                                int n_slots, const void* qlats,
                                const void* qlons, int n_queries, int qlen,
                                const void* qmeta, int n_starts,
                                int relation, void* out, void* stream) {
  if (n <= 0 || n_queries <= 0) return 0;
  if (lats == nullptr || lons == nullptr || rid == nullptr ||
      area == nullptr || nv == nullptr || exists == nullptr ||
      qlats == nullptr || qlons == nullptr || qmeta == nullptr ||
      out == nullptr || n_slots < 1 || qlen < 2 || n_starts < 1)
    return (int)cudaErrorInvalidValue;
  const float* la = (const float*)lats;
  const float* lo = (const float*)lons;
  const int32_t* ri = (const int32_t*)rid;
  const uint8_t* ar = (const uint8_t*)area;
  const int32_t* nvp = (const int32_t*)nv;
  const uint8_t* ex = (const uint8_t*)exists;
  const float* qla = (const float*)qlats;
  const float* qlo = (const float*)qlons;
  const int32_t* qm = (const int32_t*)qmeta;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (relation) {
    case kIntersects:
      return launch<kIntersects>(la, lo, ri, ar, nvp, ex, n, n_slots, qla,
                                 qlo, n_queries, qlen, qm, n_starts, o, s);
    case kDisjoint:
      return launch<kDisjoint>(la, lo, ri, ar, nvp, ex, n, n_slots, qla, qlo,
                               n_queries, qlen, qm, n_starts, o, s);
    case kWithin:
      return launch<kWithin>(la, lo, ri, ar, nvp, ex, n, n_slots, qla, qlo,
                             n_queries, qlen, qm, n_starts, o, s);
    case kContains:
      return launch<kContains>(la, lo, ri, ar, nvp, ex, n, n_slots, qla, qlo,
                               n_queries, qlen, qm, n_starts, o, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* geo_shape_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
