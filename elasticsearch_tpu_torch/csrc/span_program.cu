// K13: batched span-algebra programs over one segment's position matrices.
//
// Replaces elasticsearch_tpu/ops/spans.py (term_ends, term_set_ends,
// pad_ends, or_ends, first_ends, _first_start_from, near_unordered_ends,
// near_ordered_ends, coverage, not_ends, containing_ends, within_ends,
// span_freq) followed by ops/phrase.py:freq_score, as the JAX package runs
// them under jax.vmap for a span query tree (search/execute.py:_span_ends /
// _span_score_emit). The resolver lowers the tree to a postfix program over
// a stack of min-end maps (ops/spans.SpanProgram; ends[p] = the smallest
// end of a span starting at p, INF = 2^30 where none starts):
//
//   TERM f t        push  p+1 where tokens_f[p] == tid[q, t] (tid >= 0)
//   TERM_SET f j    push  p+1 where tokens_f[p] is in query q's set j
//   OR n            pop n maps, push their element-wise min
//   FIRST e         top[p] <= e ? top[p] : INF
//   NEAR n s o      pop n, push near_ordered (o) / near_unordered, slop s
//   NOT pre post    pop exc, inc; push inc minus spans whose window
//                   [p - pre, end + post) meets an exc span
//   CONTAINING      pop little, big; push big spans holding a little one
//   WITHIN          pop little, big; push little spans inside a big one
//
// then freq(q, d) = the number of starts with a span, and score(q, d) =
// freq_score(freq, doc_len, sum_idf_q, k1, b, avgdl_q) (BM25 over freq, the
// query's Sigma idf), mask = freq > 0. Each instruction carries its map
// width (the widest of its operands, as the reference pads them): NEAR in
// order and NOT clip to it.
//
// The reference's containing_ends and within_ends loop over all L shifts
// (O(L^2) a row) and not_ends takes two prefix sums over coverage. Every
// span the algebra makes ends after it starts, so here each is one warp
// scan: CONTAINING is suffix_min(little)[p] <= big[p], WITHIN is
// prefix_max(big)[q] >= little[q], and NOT asks whether the largest exc end
// among starts before the window's end passes the window's start
// (ops/spans.py's plain versions are these same forms; the CPU tests hold
// them against the JAX bodies). _first_start_from is a suffix-min scan.
//
// What bounds it on an H100: device-memory bytes, as K3 — each row's
// positions up to its extent read once per batch (one matrix per field the
// program reads), [B, N] scores and a [B, N] mask written. The design:
// persistent blocks over runs of kRun rows, a warp a run, every query of a
// group (grid y, <= 64) run inside the block. A warp stages each field's
// row in shared memory once, looks every position's token up in each term
// set once (term_set.cuh's binary search over the batch's union, shared
// with K16), then runs the program for each query of the group with its
// stack of maps in shared memory (a lane holds positions lane, lane + 32,
// ...; each op is a pass over them, each scan five shuffles a 32-position
// chunk). Then each lane takes whole queries and writes the run's kRun
// scores and mask bytes. This is the simple form: a (query, row) pair costs
// a pass over the row's positions per instruction.
// Numerics: the maps and counts are integers; the epilogue is __fmul_rn /
// __fadd_rn / __fdiv_rn in freq_score's order, so the kernel is
// bit-identical to the plain PyTorch version on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "term_set.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kRun = 8;              // consecutive rows a warp scores at once
constexpr int kStride = kRun + 1;    // staging stride: conflict-free
constexpr int kMaxGroup = 64;        // queries per block
constexpr int kMaxOps = 64;          // ops/spans.MAX_OPS
constexpr int kMaxFields = 4;        // ops/spans.MAX_FIELDS
constexpr int kMaxSets = 8;          // ops/spans.MAX_SETS
constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemOptIn = 232448;

enum Op {
  kTerm = 0, kTermSet = 1, kOr = 2, kFirst = 3, kNear = 4, kNot = 5,
  kContaining = 6, kWithin = 7
};

struct Program {
  int code[kMaxOps * 5];             // (op, a, b, c, width) per instruction
};

struct Fields {
  const int32_t* tok[kMaxFields];
  const int32_t* ext[kMaxFields];
  int width[kMaxFields];
  int set_field[kMaxSets];           // the field each term set's leaf reads
  int set_off[kMaxSets];             // its keys' offset and count
  int set_len[kMaxSets];
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int pad32(int x) { return (x + 31) & ~31; }

// Shared memory: per block the group's term slots, sum_idf and avgdl; per
// warp each field's staged row, each set's key index per position, the
// stack of maps, four scratch maps and the run's freq per (query, row).
struct Layout {
  int qg, wpad, tok_ints, off_tid, off_idf, off_avg, off_warp, warp_bytes,
      bytes;
};

__host__ __device__ inline Layout make_layout(int n_queries, int n_terms,
                                              const Fields& f, int n_fields,
                                              int n_sets, int depth,
                                              int warps) {
  Layout l;
  l.qg = n_queries < kMaxGroup ? n_queries : kMaxGroup;
  int w = 0;
  l.tok_ints = 0;
  for (int i = 0; i < n_fields; ++i) {
    w = f.width[i] > w ? f.width[i] : w;
    l.tok_ints += pad32(f.width[i]);
  }
  l.wpad = pad32(w);
  int o = 0;
  l.off_tid = o;  o = align16(o + l.qg * (n_terms > 0 ? n_terms : 1) * 4);
  l.off_idf = o;  o = align16(o + l.qg * 4);
  l.off_avg = o;  o = align16(o + l.qg * 4);
  l.off_warp = o;
  l.warp_bytes = align16(
      (l.tok_ints + (n_sets + depth + 4) * l.wpad) * 4 + l.qg * kStride * 4);
  l.bytes = o + warps * l.warp_bytes;
  return l;
}

// dst[p] = min over starts >= p of src(p) (src(p) given per position)
template <typename Src>
__device__ __forceinline__ void suffix_min(int32_t* dst, int wpad, int lane,
                                           const Src& src) {
  int carry = kInf;
  for (int j0 = wpad - 32; j0 >= 0; j0 -= 32) {
    int v = src(j0 + lane);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_down_sync(kFull, v, off);
      if (lane + off < 32) v = min(v, o);
    }
    v = min(v, carry);
    dst[j0 + lane] = v;
    carry = __shfl_sync(kFull, v, 0);
  }
}

// dst[p] = max over starts <= p of src(p)
template <typename Src>
__device__ __forceinline__ void prefix_max(int32_t* dst, int wpad, int lane,
                                           const Src& src) {
  int carry = -1;
  for (int j0 = 0; j0 < wpad; j0 += 32) {
    int v = src(j0 + lane);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v = max(v, o);
    }
    v = max(v, carry);
    dst[j0 + lane] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
}

__global__ void span_program_kernel(
    Program prog, Fields fields, int n_ops, int n_fields,
    const int32_t* __restrict__ doc_len, int n_docs, int n_queries,
    int depth, const int32_t* __restrict__ tids, int n_terms,
    const int32_t* __restrict__ set_keys,
    const unsigned long long* __restrict__ set_bits, int n_sets, int groups,
    const float* __restrict__ sum_idf, const float* __restrict__ avgdl,
    float k1, float k1p1, float omb, float b, float* __restrict__ scores,
    uint8_t* __restrict__ mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const Layout L = make_layout(n_queries, n_terms, fields, n_fields, n_sets,
                               depth, warps);
  const int qg = L.qg;
  const int wpad = L.wpad;
  int32_t* s_tid = reinterpret_cast<int32_t*>(smem + L.off_tid);  // [q][t]
  float* s_idf = reinterpret_cast<float*>(smem + L.off_idf);
  float* s_avg = reinterpret_cast<float*>(smem + L.off_avg);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* wbase = reinterpret_cast<int32_t*>(smem + L.off_warp +
                                              warp * L.warp_bytes);
  int32_t* my_tok = wbase;                                // fields' rows
  int32_t* my_idx = my_tok + L.tok_ints;                  // [set][p]
  int32_t* my_stack = my_idx + n_sets * wpad;             // [depth][p]
  int32_t* my_f = my_stack + depth * wpad;                // scratch maps
  int32_t* my_a = my_f + wpad;
  int32_t* my_b = my_a + wpad;
  int32_t* my_c = my_b + wpad;
  float* my_freq = reinterpret_cast<float*>(my_c + wpad); // [q][r]
  int tok_off[kMaxFields];
  {
    int o = 0;
    for (int i = 0; i < n_fields; ++i) {
      tok_off[i] = o;
      o += pad32(fields.width[i]);
    }
  }

  const int g = blockIdx.y;
  const int q0 = g * qg;
  const int nq = min(qg, n_queries - q0);
  for (int i = threadIdx.x; i < nq * n_terms; i += blockDim.x)
    s_tid[i] = tids[(int64_t)q0 * n_terms + i];
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    s_idf[q] = sum_idf[q0 + q];
    s_avg[q] = avgdl[q0 + q];
  }
  __syncthreads();
  const bool whole_runs = (n_docs & (kRun - 1)) == 0;

  const int runs = (n_docs + kRun - 1) / kRun;
  const int run_step = gridDim.x * warps;
  for (int run = blockIdx.x * warps + warp; run < runs; run += run_step) {
    const int d0 = run * kRun;
    const int rows = min(kRun, n_docs - d0);
    for (int r = 0; r < rows; ++r) {
      const int d = d0 + r;
      // ---- stage each field's row; positions at or past its extent hold -1
      int ext[kMaxFields];
      for (int i = 0; i < n_fields; ++i) {
        const int w = fields.width[i];
        ext[i] = min(fields.ext[i][d], w);
        const int32_t* row = fields.tok[i] + (int64_t)d * w;
        int32_t* dst = my_tok + tok_off[i];
        for (int x = lane; x < pad32(w); x += 32)
          dst[x] = x < ext[i] ? row[x] : -1;
      }
      __syncwarp();
      // ---- each term set: every position's key index, once for the batch
      for (int j = 0; j < n_sets; ++j) {
        const int fi = fields.set_field[j];
        const int32_t* keys = set_keys + fields.set_off[j];
        const int nk = fields.set_len[j];
        const int32_t* tk = my_tok + tok_off[fi];
        for (int p = lane; p < wpad; p += 32) {
          const int32_t x = p < fields.width[fi] ? tk[p] : -1;
          my_idx[j * wpad + p] = x >= 0 ? term_set_find(keys, nk, x) : -1;
        }
      }
      __syncwarp();

      // ---- run the program for each query of the group ------------------
      for (int q = 0; q < nq; ++q) {
        const int ql = q;                 // the query's bit in its group
        int top = 0;
        for (int i = 0; i < n_ops; ++i) {
          const int* ins = prog.code + i * 5;
          const int op = ins[0], a = ins[1], bb = ins[2], c = ins[3],
                    w = ins[4];
          if (op == kTerm) {
            int32_t* dst = my_stack + top * wpad;
            const int32_t tid = s_tid[q * n_terms + bb];
            const int32_t* tk = my_tok + tok_off[a];
            const int fw = fields.width[a];
            for (int p = lane; p < wpad; p += 32)
              dst[p] = tid >= 0 && p < fw && tk[p] == tid ? p + 1 : kInf;
            ++top;
          } else if (op == kTermSet) {
            int32_t* dst = my_stack + top * wpad;
            const int32_t* idx = my_idx + bb * wpad;
            const int off = fields.set_off[bb];
            for (int p = lane; p < wpad; p += 32) {
              const int k = idx[p];
              const bool hit =
                  k >= 0 &&
                  ((term_set_queries(set_bits, groups, off + k, g) >> ql) &
                   1ull);
              dst[p] = hit ? p + 1 : kInf;
            }
            ++top;
          } else if (op == kOr) {
            int32_t* dst = my_stack + (top - a) * wpad;
            for (int p = lane; p < wpad; p += 32) {
              int m = dst[p];
              for (int k = 1; k < a; ++k)
                m = min(m, my_stack[(top - a + k) * wpad + p]);
              dst[p] = m;
            }
            top -= a - 1;
          } else if (op == kFirst) {
            int32_t* s = my_stack + (top - 1) * wpad;
            for (int p = lane; p < wpad; p += 32)
              s[p] = s[p] <= a ? s[p] : kInf;
          } else if (op == kNear) {
            const int base = top - a;
            const int slop = bb;
            int32_t* e0 = my_stack + base * wpad;
            if (c) {
              // ordered: chain each clause's earliest start >= the end
              for (int p = lane; p < wpad; p += 32) {
                my_a[p] = e0[p];
                my_c[p] = e0[p] < kInf;
                my_b[p] = 0;
              }
              for (int k = 1; k < a; ++k) {
                const int32_t* ek = my_stack + (base + k) * wpad;
                __syncwarp();
                suffix_min(my_f, wpad, lane, [&](int p) {
                  return ek[p] < kInf ? p : kInf;
                });
                __syncwarp();
                for (int p = lane; p < wpad; p += 32) {
                  if (!my_c[p]) continue;
                  const int cur = my_a[p];
                  const int start = cur < w ? my_f[cur] : kInf;
                  if (start < kInf) {
                    my_b[p] += start - cur;
                    my_a[p] = ek[start];
                  } else {
                    my_c[p] = 0;
                    my_a[p] = kInf;
                  }
                }
              }
              __syncwarp();
              for (int p = lane; p < wpad; p += 32)
                e0[p] = my_c[p] && my_b[p] <= slop ? my_a[p] : kInf;
            } else {
              // unordered: each clause's earliest span starting >= p
              for (int k = 0; k < a; ++k) {
                const int32_t* ek = my_stack + (base + k) * wpad;
                __syncwarp();
                suffix_min(my_f, wpad, lane, [&](int p) {
                  return ek[p] < kInf ? p : kInf;
                });
                __syncwarp();
                for (int p = lane; p < wpad; p += 32) {
                  const int sk = my_f[p];
                  const int e_at = sk < kInf ? ek[sk] : kInf;
                  // my_c: bit 0 every clause has a span, bit 1 one starts
                  // at p
                  int flags = k == 0 ? 1 : my_c[p];
                  if (sk >= kInf) flags &= ~1;
                  if (ek[p] < kInf) flags |= 2;
                  my_c[p] = flags;
                  my_a[p] = k == 0 ? e_at : max(my_a[p], e_at);
                  my_b[p] = (k == 0 ? 0 : my_b[p]) +
                            (sk < kInf ? e_at - sk : 0);
                }
              }
              __syncwarp();
              for (int p = lane; p < wpad; p += 32)
                e0[p] = my_c[p] == 3 && my_a[p] - p - my_b[p] <= slop
                            ? my_a[p] : kInf;
            }
            top = base + 1;
          } else if (op == kNot) {
            int32_t* inc = my_stack + (top - 2) * wpad;
            const int32_t* exc = my_stack + (top - 1) * wpad;
            const int pre = a, post = bb;
            prefix_max(my_f, wpad, lane, [&](int p) {
              return exc[p] < kInf ? exc[p] : -1;
            });
            __syncwarp();
            for (int p = lane; p < wpad; p += 32) {
              const int v = inc[p];
              if (v >= kInf) continue;
              const int w0 = min(max(p - pre, 0), w);
              const int w1 = min(max(v + post, 0), w);
              const int reach = w1 > 0 ? my_f[w1 - 1] : -1;
              if (w0 < w1 && reach > w0) inc[p] = kInf;
            }
            --top;
          } else if (op == kContaining) {
            int32_t* big = my_stack + (top - 2) * wpad;
            const int32_t* little = my_stack + (top - 1) * wpad;
            suffix_min(my_f, wpad, lane, [&](int p) { return little[p]; });
            __syncwarp();
            for (int p = lane; p < wpad; p += 32)
              big[p] = big[p] < kInf && my_f[p] <= big[p] ? big[p] : kInf;
            --top;
          } else {  // kWithin
            int32_t* out = my_stack + (top - 2) * wpad;   // big's slot
            const int32_t* little = my_stack + (top - 1) * wpad;
            prefix_max(my_f, wpad, lane, [&](int p) {
              return out[p] < kInf ? out[p] : -1;
            });
            __syncwarp();
            for (int p = lane; p < wpad; p += 32)
              out[p] = little[p] < kInf && my_f[p] >= little[p] ? little[p]
                                                                 : kInf;
            --top;
          }
          __syncwarp();
        }
        // ---- span_freq: the starts with a span ---------------------------
        int count = 0;
        for (int p0 = 0; p0 < wpad; p0 += 32)
          count += __popc(__ballot_sync(kFull, my_stack[p0 + lane] < kInf));
        if (lane == 0) my_freq[q * kStride + r] = (float)count;
        __syncwarp();
      }
    }
    __syncwarp();

    // ---- score and write the run: a lane a query, kRun entries each ------
    float dl[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      dl[r] = r < rows ? (float)doc_len[d0 + r] : 0.0f;
    for (int q = lane; q < nq; q += 32) {
      const float avg = s_avg[q];
      const float idf = s_idf[q];
      float sc[kRun];
      uint32_t mk[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const float ff = r < rows ? my_freq[q * kStride + r] : 0.0f;
        float score = 0.0f;
        if (ff > 0.0f) {
          const float norm = __fmul_rn(
              k1, __fadd_rn(omb, __fdiv_rn(__fmul_rn(b, dl[r]), avg)));
          const float tfn =
              __fdiv_rn(__fmul_rn(ff, k1p1), __fadd_rn(ff, norm));
          score = __fmul_rn(idf, tfn);
        }
        sc[r] = score;
        mk[r] = ff > 0.0f ? 1u : 0u;
      }
      const int64_t at = (int64_t)(q0 + q) * n_docs + d0;
      if (whole_runs) {
        float4* dst = reinterpret_cast<float4*>(scores + at);
        dst[0] = make_float4(sc[0], sc[1], sc[2], sc[3]);
        dst[1] = make_float4(sc[4], sc[5], sc[6], sc[7]);
        *reinterpret_cast<uint2*>(mask + at) =
            make_uint2(mk[0] | mk[1] << 8 | mk[2] << 16 | mk[3] << 24,
                       mk[4] | mk[5] << 8 | mk[6] << 16 | mk[7] << 24);
      } else {
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
          if (r < rows) {
            scores[at + r] = sc[r];
            mask[at + r] = (uint8_t)mk[r];
          }
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// code: HOST array of n_ops * 5 ints (op, a, b, c, width); fields: HOST
// array of n_fields * 3 64-bit words (tokens pointer, extent pointer,
// width); set_offs: HOST array of n_sets * 2 ints (offset, count) into
// set_keys ([sum of counts] int32, sorted per set) and set_bits
// ([sum of counts, groups] int64). tids: [n_queries, n_terms] int32.
extern "C" int span_program_launch(const int* code, const long long* fields,
                                   int n_ops, int n_fields,
                                   const void* doc_len, int n_docs,
                                   int n_queries, int depth,
                                   const void* tids, int n_terms,
                                   const void* set_keys,
                                   const void* set_bits, const int* set_offs,
                                   int n_sets, const void* sum_idf,
                                   const void* avgdl, int groups, float k1,
                                   float k1p1, float omb, float b,
                                   void* scores, void* mask, void* stream) {
  if (n_docs <= 0 || n_queries <= 0 || n_ops <= 0 || n_ops > kMaxOps ||
      n_fields <= 0 || n_fields > kMaxFields || n_sets < 0 ||
      n_sets > kMaxSets || depth <= 0 || n_terms < 0 ||
      groups != (n_queries + kMaxGroup - 1) / kMaxGroup || groups > 65535)
    return (int)cudaErrorInvalidValue;
  Program prog = {};
  for (int i = 0; i < n_ops * 5; ++i) prog.code[i] = code[i];
  Fields f = {};
  for (int i = 0; i < n_fields; ++i) {
    f.tok[i] = reinterpret_cast<const int32_t*>(fields[3 * i]);
    f.ext[i] = reinterpret_cast<const int32_t*>(fields[3 * i + 1]);
    f.width[i] = (int)fields[3 * i + 2];
    if (f.width[i] <= 0) return (int)cudaErrorInvalidValue;
  }
  for (int j = 0; j < n_sets; ++j) {
    f.set_off[j] = set_offs[2 * j];
    f.set_len[j] = set_offs[2 * j + 1];
    f.set_field[j] = -1;
  }
  // each term set's field, and a check of the program's operands
  int top = 0;
  for (int i = 0; i < n_ops; ++i) {
    const int op = prog.code[i * 5], a = prog.code[i * 5 + 1],
              bb = prog.code[i * 5 + 2];
    if (op == kTerm || op == kTermSet) {
      if (a < 0 || a >= n_fields) return (int)cudaErrorInvalidValue;
      if (op == kTerm && (bb < 0 || bb >= n_terms))
        return (int)cudaErrorInvalidValue;
      if (op == kTermSet) {
        if (bb < 0 || bb >= n_sets) return (int)cudaErrorInvalidValue;
        f.set_field[bb] = a;
      }
      ++top;
    } else if (op == kOr || op == kNear) {
      if (a < 1 || a > top) return (int)cudaErrorInvalidValue;
      top -= a - 1;
    } else if (op == kNot || op == kContaining || op == kWithin) {
      if (top < 2) return (int)cudaErrorInvalidValue;
      --top;
    } else if (op == kFirst) {
      if (top < 1) return (int)cudaErrorInvalidValue;
    } else {
      return (int)cudaErrorInvalidValue;
    }
    if (top > depth) return (int)cudaErrorInvalidValue;
  }
  if (top != 1) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < n_sets; ++j) {
    if (f.set_field[j] < 0) {   // a set no leaf reads: looked up nowhere
      f.set_field[j] = 0;
      f.set_len[j] = 0;
    }
  }
  // as many warps a block as the per-warp buffers allow
  int warps = kMaxWarps;
  while (warps > 1 && make_layout(n_queries, n_terms, f, n_fields, n_sets,
                                  depth, warps).bytes > kSmemOptIn)
    --warps;
  const Layout l =
      make_layout(n_queries, n_terms, f, n_fields, n_sets, depth, warps);
  if (l.bytes > kSmemOptIn) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      span_program_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, span_program_kernel, warps * 32, l.bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks_needed =
      ((n_docs + kRun - 1) / kRun + warps - 1) / warps;
  long long want = (long long)sms * per_sm / groups;
  if (want < 1) want = 1;
  if (want > blocks_needed) want = blocks_needed;
  dim3 grid((unsigned)want, (unsigned)groups);
  span_program_kernel<<<grid, warps * 32, l.bytes, (cudaStream_t)stream>>>(
      prog, f, n_ops, n_fields, (const int32_t*)doc_len, n_docs, n_queries,
      depth, (const int32_t*)tids, n_terms, (const int32_t*)set_keys,
      (const unsigned long long*)set_bits, n_sets, groups,
      (const float*)sum_idf, (const float*)avgdl, k1, k1p1, omb, b,
      (float*)scores, (uint8_t*)mask);
  return (int)cudaGetLastError();
}

extern "C" const char* span_program_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
