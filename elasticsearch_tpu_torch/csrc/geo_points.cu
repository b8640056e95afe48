// K17: the geo_point filters of a batch over one segment's geo column.
//
// Replaces elasticsearch_tpu/ops/filters.py:geo_distance (:79),
// geo_bounding_box (:90), geo_distance_range (:97) and geo_polygon (:116,
// through ops/geoshape.py:_points_in_query_shape), the geohash_cell
// resolver's OR of up to 9 boxes (search/execute.py:1778-1803) and the
// inline haversine of the geo decay (search/execute.py:1591-1604), as the
// JAX package runs them under jax.vmap: for each query q of a batch and
// each doc row d,
//
//   distance        exists & haversine(d, q) <= radius
//   distance_range  exists & each of gte, gt, lte, lt holds (< 0: open)
//   boxes           exists & OR over q's boxes of lat in [bottom, top] and
//                   lon in [left, right] (its complement across the
//                   dateline when left > right)
//   polygon         exists & an odd count of q's ring edges cross the ray
//                   from d toward +lon (the even-odd rule)
//   distance_out    haversine(d, q) in meters, f32 (the decay's input)
//
// What bounds it on an H100: device-memory bytes — lat, lon and exists
// read once (9 bytes a row) and a [B, N] byte mask (or f32 distances)
// written; the arithmetic, up to three libm calls a (query, row) pair, is
// ~100 flops, and the polygon mode 9 a ring edge. The design is one thread
// a row that reads its point once for the whole batch and loops over the
// queries, whose parameters (and rings) sit in shared memory: grid y runs
// over groups of queries that fit in 48 KB; a ring too long for that is
// read from global memory, where a warp's reads of one vertex broadcast.
// Each output row q is written by consecutive threads, so the stores
// coalesce. cos(lat) is taken once a row and cos(qlat) once a query.
// Numerics: geo_common.cuh — bit for bit the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "geo_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDistance = 0;
constexpr int kDistanceRange = 1;
constexpr int kBoxes = 2;
constexpr int kPolygon = 3;
constexpr int kDistanceOut = 4;

__device__ __forceinline__ bool in_box(float lat, float lon, const float* b) {
  const float top = b[0], left = b[1], bottom = b[2], right = b[3];
  const bool in_lat = (lat <= top) && (lat >= bottom);
  const bool in_lon = left <= right ? (lon >= left) && (lon <= right)
                                    : (lon >= left) || (lon <= right);
  return in_lat && in_lon;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
geo_points_kernel(const float* __restrict__ lat,
                  const float* __restrict__ lon,
                  const uint8_t* __restrict__ exists, int n, int n_queries,
                  int group, const float* __restrict__ params, int n_params,
                  const float* __restrict__ ring_lat,
                  const float* __restrict__ ring_lon, int ring_len,
                  int rings_staged, void* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.y * group;
  const int gq = min(group, n_queries - q0);
  // staged per query: its parameters, then cos(qlat) for the distance modes
  const int stride = n_params + 1;
  float* s_par = smem;
  float* s_rlat = smem + group * stride;
  float* s_rlon = s_rlat + (rings_staged ? group * ring_len : 0);
  for (int i = threadIdx.x; i < gq * n_params; i += kThreads) {
    const int q = i / n_params;
    s_par[q * stride + i % n_params] = params[(size_t)q0 * n_params + i];
  }
  if (kMode == kPolygon && rings_staged) {
    for (int i = threadIdx.x; i < gq * ring_len; i += kThreads) {
      s_rlat[i] = ring_lat[(size_t)q0 * ring_len + i];
      s_rlon[i] = ring_lon[(size_t)q0 * ring_len + i];
    }
  }
  __syncthreads();
  if (kMode == kDistance || kMode == kDistanceRange ||
      kMode == kDistanceOut) {
    for (int q = threadIdx.x; q < gq; q += kThreads)
      s_par[q * stride + n_params] = geo::cos_rad(s_par[q * stride]);
    __syncthreads();
  }
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const float la = lat[row];
  const float lo = lon[row];
  const bool ex = exists[row] != 0;
  const float cp1 = (kMode == kBoxes || kMode == kPolygon)
                        ? 0.0f : geo::cos_rad(la);
  for (int j = 0; j < gq; ++j) {
    const float* p = s_par + j * stride;
    const size_t at = (size_t)(q0 + j) * n + row;
    if (kMode == kDistanceOut) {
      static_cast<float*>(out)[at] =
          geo::haversine(la, lo, cp1, p[0], p[1], p[n_params]);
      continue;
    }
    bool hit = false;
    if (kMode == kDistance) {
      hit = geo::haversine(la, lo, cp1, p[0], p[1], p[n_params]) <= p[2];
    } else if (kMode == kDistanceRange) {
      const float d = geo::haversine(la, lo, cp1, p[0], p[1], p[n_params]);
      hit = (p[2] < 0.0f || d >= p[2]) && (p[3] < 0.0f || d > p[3]) &&
            (p[4] < 0.0f || d <= p[4]) && (p[5] < 0.0f || d < p[5]);
    } else if (kMode == kBoxes) {
      for (int k = 0; k < n_params; k += 4) hit = hit || in_box(la, lo, p + k);
    } else {  // kPolygon: one closed ring of ring_len - 1 edges
      const float* rl = rings_staged ? s_rlat + j * ring_len
                                     : ring_lat + (size_t)(q0 + j) * ring_len;
      const float* ro = rings_staged ? s_rlon + j * ring_len
                                     : ring_lon + (size_t)(q0 + j) * ring_len;
      bool parity = false;
      for (int i = 0; i + 1 < ring_len; ++i)
        parity ^= geo::ray_flip(la, lo, rl[i], ro[i], rl[i + 1], ro[i + 1]);
      hit = parity;
    }
    static_cast<uint8_t*>(out)[at] = (ex && hit) ? 1 : 0;
  }
}

template <int kMode>
int launch(const float* lat, const float* lon, const uint8_t* exists, int n,
           int n_queries, const float* params, int n_params,
           const float* ring_lat, const float* ring_lon, int ring_len,
           void* out, cudaStream_t stream) {
  constexpr int kBudget = 48 * 1024;
  const int per_query = (n_params + 1) * 4;
  const int ring_bytes = kMode == kPolygon ? ring_len * 8 : 0;
  int staged = per_query + ring_bytes <= kBudget;
  int group = kBudget / (per_query + (staged ? ring_bytes : 0));
  if (group > n_queries) group = n_queries;
  if (group < 1) group = 1;
  const int groups = (n_queries + group - 1) / group;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)group * (per_query + (staged ? ring_bytes : 0));
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)groups);
  geo_points_kernel<kMode><<<grid, kThreads, smem, stream>>>(
      lat, lon, exists, n, n_queries, group, params, n_params, ring_lat,
      ring_lon, ring_len, staged, out);
  return (int)cudaGetLastError();
}

}  // namespace

// lat, lon [n] f32 and exists [n] u8; params [n_queries, n_params] f32
// (distance: qlat, qlon, radius; distance_range: qlat, qlon, gte, gt, lte,
// lt; boxes: top, left, bottom, right a box; polygon: none; distance_out:
// qlat, qlon); polygon rings [n_queries, ring_len] f32 each, closed; out
// [n_queries, n] u8 (f32 for distance_out).
extern "C" int geo_points_launch(const void* lat, const void* lon,
                                 const void* exists, int n, int mode,
                                 int n_queries, const void* params,
                                 int n_params, const void* ring_lat,
                                 const void* ring_lon, int ring_len,
                                 void* out, void* stream) {
  if (n <= 0 || n_queries <= 0) return 0;
  if (lat == nullptr || lon == nullptr || exists == nullptr ||
      out == nullptr || n_params < 0 || (n_params > 0 && params == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* la = (const float*)lat;
  const float* lo = (const float*)lon;
  const uint8_t* ex = (const uint8_t*)exists;
  const float* pa = (const float*)params;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kDistance:
      if (n_params != 3) return (int)cudaErrorInvalidValue;
      return launch<kDistance>(la, lo, ex, n, n_queries, pa, n_params,
                               nullptr, nullptr, 0, out, s);
    case kDistanceRange:
      if (n_params != 6) return (int)cudaErrorInvalidValue;
      return launch<kDistanceRange>(la, lo, ex, n, n_queries, pa, n_params,
                                    nullptr, nullptr, 0, out, s);
    case kBoxes:
      if (n_params < 4 || n_params % 4) return (int)cudaErrorInvalidValue;
      return launch<kBoxes>(la, lo, ex, n, n_queries, pa, n_params, nullptr,
                            nullptr, 0, out, s);
    case kPolygon:
      if (ring_lat == nullptr || ring_lon == nullptr || ring_len < 2)
        return (int)cudaErrorInvalidValue;
      return launch<kPolygon>(la, lo, ex, n, n_queries, pa, 0,
                              (const float*)ring_lat, (const float*)ring_lon,
                              ring_len, out, s);
    case kDistanceOut:
      if (n_params != 2) return (int)cudaErrorInvalidValue;
      return launch<kDistanceOut>(la, lo, ex, n, n_queries, pa, n_params,
                                  nullptr, nullptr, 0, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* geo_points_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
