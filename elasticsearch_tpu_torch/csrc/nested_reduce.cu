// K19: the nested query's child -> parent reduce.
//
// Replaces the emit of elasticsearch_tpu/search/execute.py:_res_NestedQuery
// (its .at[idx].max / .min / .add scatters onto the parent rows). The inner
// query gives child scores [B, Nc] f32 and a child mask [B, Nc] bool; the
// child segment's live mask [Nc] already folds in the parent's. The block's
// child -> parent join comes as CSR offsets [N+1] i32: parent p's children
// are rows offsets[p] .. offsets[p+1], in child order. For query b, parent p:
//
//   counted  = the children c of p with mask[b, c] && live[c]
//   matched  = counted is not empty
//   none     1.0
//   max/min  the extreme of the counted scores (a NaN among them gives NaN;
//            +0.0 beats -0.0 for max and -0.0 beats +0.0 for min)
//   sum      the counted scores added left to right in child order
//   avg      that sum / max(count, 1)
//   out      matched ? value * boost[b] : 0.0,  matched as 0/1 bytes
//
// Every value is one rounding of one operation in the order the plain
// version (ops/nested.py:nested_reduce_plain) takes, so the results are
// bit-identical to it on the card; nvcc's default -prec-div keeps the
// division IEEE.
//
// What bounds it on an H100: device-memory bytes. Each child's score and
// mask byte are read once per query, the live byte and the offsets once,
// and each (query, parent) writes 5 bytes: at B = 64, Nc = 1.5M, N = 2^20
// about 0.8 GB, ~0.25 ms at 3.35 TB/s. The design is the simple one: one
// thread a (query, parent) walks its parent's rows, so no atomics are
// needed and the order is fixed. Adjacent threads take adjacent parents,
// whose children are adjacent rows, so a warp's reads stay within a few
// cache lines while the parents have a child or two; a parent with many
// children holds its warp for as long (a load imbalance a later design can
// split across a warp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

enum Mode { kNone = 0, kMax = 1, kMin = 2, kSum = 3, kAvg = 4 };

template <int MODE>
__global__ void __launch_bounds__(kThreads)
nested_reduce_kernel(const float* __restrict__ scores,
                     const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ live,
                     const int* __restrict__ offsets,
                     const float* __restrict__ boost, int b, long long nc,
                     long long n, float* __restrict__ out_scores,
                     uint8_t* __restrict__ out_matched) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int lo = __ldg(offsets + p);
  const int hi = __ldg(offsets + p + 1);
  for (int q = blockIdx.y; q < b; q += gridDim.y) {
    const float* srow = scores + (long long)q * nc;
    const uint8_t* mrow = mask + (long long)q * nc;
    bool any = false;
    bool nan = false;
    float acc = MODE == kMax ? -__int_as_float(0x7f800000)
              : MODE == kMin ? __int_as_float(0x7f800000) : 0.0f;
    float cnt = 0.0f;
    for (int c = lo; c < hi; ++c) {
      if (!(__ldg(mrow + c) && __ldg(live + c))) continue;
      any = true;
      if (MODE == kNone) break;
      const float v = __ldg(srow + c);
      if (MODE == kMax) {
        if (v != v) nan = true;
        else if (v > acc || (v == acc && !signbit(v))) acc = v;
      } else if (MODE == kMin) {
        if (v != v) nan = true;
        else if (v < acc || (v == acc && signbit(v))) acc = v;
      } else {
        acc = __fadd_rn(acc, v);
        cnt = __fadd_rn(cnt, 1.0f);
      }
    }
    float value;
    if (MODE == kNone) value = 1.0f;
    else if (MODE == kMax || MODE == kMin)
      value = nan ? __int_as_float(0x7fffffff) : acc;
    else if (MODE == kSum) value = acc;
    else value = __fdiv_rn(acc, fmaxf(cnt, 1.0f));
    const long long o = (long long)q * n + p;
    out_scores[o] = any ? __fmul_rn(value, __ldg(boost + q)) : 0.0f;
    out_matched[o] = any ? 1 : 0;
  }
}

template <int MODE>
cudaError_t launch(const float* scores, const uint8_t* mask,
                   const uint8_t* live, const int* offsets,
                   const float* boost, int b, long long nc, long long n,
                   float* out_scores, uint8_t* out_matched,
                   cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)(b < kMaxGridY ? b : kMaxGridY));
  nested_reduce_kernel<MODE><<<grid, kThreads, 0, stream>>>(
      scores, mask, live, offsets, boost, b, nc, n, out_scores,
      out_matched);
  return cudaGetLastError();
}

}  // namespace

// scores/mask [b, nc] (f32, bytes), live [nc] bytes, offsets [n + 1] i32,
// boost [b] f32 -> out_scores [b, n] f32, out_matched [b, n] bytes.
extern "C" int nested_reduce_launch(const void* scores, const void* mask,
                                    const void* live, const void* offsets,
                                    const void* boost, int b, long long nc,
                                    long long n, int mode, void* out_scores,
                                    void* out_matched, void* stream) {
  if (b <= 0 || n <= 0 || nc < 0 || offsets == nullptr ||
      out_scores == nullptr || out_matched == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* s = (const float*)scores;
  const uint8_t* m = (const uint8_t*)mask;
  const uint8_t* l = (const uint8_t*)live;
  const int* off = (const int*)offsets;
  const float* bo = (const float*)boost;
  float* os = (float*)out_scores;
  uint8_t* om = (uint8_t*)out_matched;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case kNone: return (int)launch<kNone>(s, m, l, off, bo, b, nc, n, os, om, st);
    case kMax: return (int)launch<kMax>(s, m, l, off, bo, b, nc, n, os, om, st);
    case kMin: return (int)launch<kMin>(s, m, l, off, bo, b, nc, n, os, om, st);
    case kSum: return (int)launch<kSum>(s, m, l, off, bo, b, nc, n, os, om, st);
    case kAvg: return (int)launch<kAvg>(s, m, l, off, bo, b, nc, n, os, om, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* nested_reduce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
