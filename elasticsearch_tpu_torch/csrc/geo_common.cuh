// The geo arithmetic shared by K17 (csrc/geo_points.cu) and K18
// (csrc/geo_shape.cu): the haversine of elasticsearch_tpu/ops/filters.py
// (geo_distance, geo_distance_range) and search/execute.py's geo decay, the
// orientation test of ops/geoshape.py:_orient, and one step of the even-odd
// ray cast of ops/geoshape.py:_points_in_query_shape and
// _query_point_in_doc_shapes.
//
// Every operation is rounded alone, in the reference's order (no FMA
// contraction), and the transcendentals are the precise sinf / cosf / asinf
// and the IEEE square root, so each result is bit for bit what the plain
// PyTorch versions (one CUDA kernel an operation) give on the same inputs.

#pragma once

#include <stdint.h>

namespace geo {

// f32(pi / 180): jnp.radians multiplies by the constant rounded to f32
constexpr float kRad = 0x1.1df46ap-6f;
// f32(2 * 6371008.8): `2 * r * arcsin(..)` is one multiply by the rounded
// Python constant
constexpr float kTwoR = 0x1.84db04p+23f;
// the ray cast's stand-in for a zero edge height (a horizontal edge)
constexpr float kTiny = 1e-30f;

// lat in radians' cosine, once a point (cos(p1)) or a query (cos(p2))
__device__ __forceinline__ float cos_rad(float deg) {
  return cosf(__fmul_rn(deg, kRad));
}

// meters between the point (lat, lon) and the query point (qlat, qlon):
//   a = sin(dphi / 2)^2 + (cos(p1) * cos(p2)) * sin(dlmb / 2)^2
//   d = 2r * asin(sqrt(a))
// with cp1 = cos_rad(lat), cq = cos_rad(qlat)
__device__ __forceinline__ float haversine(float lat, float lon, float cp1,
                                           float qlat, float qlon, float cq) {
  const float dphi = __fmul_rn(__fsub_rn(lat, qlat), kRad);
  const float dlmb = __fmul_rn(__fsub_rn(lon, qlon), kRad);
  const float s1 = sinf(__fmul_rn(dphi, 0.5f));
  const float s2 = sinf(__fmul_rn(dlmb, 0.5f));
  const float a = __fadd_rn(__fmul_rn(s1, s1),
                            __fmul_rn(__fmul_rn(cp1, cq), __fmul_rn(s2, s2)));
  return __fmul_rn(kTwoR, asinf(__fsqrt_rn(a)));
}

// (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
__device__ __forceinline__ float orient(float ax, float ay, float bx,
                                        float by, float cx, float cy) {
  return __fsub_rn(__fmul_rn(__fsub_rn(bx, ax), __fsub_rn(cy, ay)),
                   __fmul_rn(__fsub_rn(by, ay), __fsub_rn(cx, ax)));
}

// Does the edge (yi, xi) - (yj, xj) flip the even-odd parity of the point
// (py, px)? The ray runs toward +x (+lon):
//   crosses = (yi > py) != (yj > py)
//   xcross  = (xj - xi) * (py - yi) / (yj - yi, or 1e-30 when 0) + xi
//   flip    = crosses & (px < xcross)
__device__ __forceinline__ bool ray_flip(float py, float px, float yi,
                                         float xi, float yj, float xj) {
  const bool crosses = (yi > py) != (yj > py);
  float den = __fsub_rn(yj, yi);
  if (den == 0.0f) den = kTiny;
  const float xc = __fadd_rn(
      __fdiv_rn(__fmul_rn(__fsub_rn(xj, xi), __fsub_rn(py, yi)), den), xi);
  return crosses && (px < xc);
}

}  // namespace geo
