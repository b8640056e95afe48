// K12: the script expression evaluator, a postfix program over doc values.
//
// Replaces elasticsearch_tpu/search/scripts.py:_eval as
// search/execute.py:_script_factor runs it inside each fused program (the
// lang-expression engine of script_score; also script_fields, the
// scripted_metric map script and the bucket pipelines). search/scripts.py
// lowers the script's tree to a flat postfix program with a static type on
// every value (bool, int32 or f32, as jnp's promotion gives it); this
// kernel runs that program for every (query, row) of a batch and writes
// out[b, row] as a 32-bit word of the program's result type.
//
// Inputs (ops/script_ops.py documents the opcodes; the numbers are its):
//   column slots      f32 values [N] and u8 exists [N] (doc['f'].value reads
//                     exists ? value : 0, .empty reads !exists)
//   score             [B, N] f32, where the program reads _score
//   product slots     [B, N] f32 (cosineSimilarity / dotProduct, one
//                     torch.matmul a segment) with the field's exists [N]
//   params            [B, P] f32, per-query numeric params
//   rowvals           [H, N] 32-bit words, per-row host values (pipelines)
// The pointers, the ops (opcode in the high word) and the constants come in
// one int64 table, copied to the device in one go.
//
// Design (a first version that is right): one thread a row, looping over
// the batch's queries, the row's first kColCache column values and exists
// flags loaded once before that loop. The program and its constants are
// staged in shared memory; every thread runs the same opcode at the same
// time, so the dispatch never diverges. The stack lives in a per-thread
// array (local memory, L1-cached) of kStack words: 32, or 1024 for a deeper
// program (the reference's recursive walker stops near 1000 levels), so a
// script the reference takes is never refused for its depth. A program too
// long for shared memory runs from global memory. The grid is ceil(N/256)
// blocks; the ragged edge is masked.
//
// What bounds it on an H100: device-memory bytes at the configs' programs
// (3s reads one column and _score and writes [B, N]: ~9 bytes a cell over
// 3.35 TB/s); a long program is bound by the dispatch instead.
//
// Rounding, case by case, so the kernel is bit-identical to the plain
// version (eager torch, one rounding an op):
//   + - * /   __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn: nvcc would
//             otherwise contract a*b+c into an FMA. No --use_fast_math.
//   log log10 exp sqrt pow floor ceil abs
//             logf, log10f, expf, sqrtf, powf, floorf, ceilf, fabsf: the
//             functions torch's CUDA ops call. F_POW is only emitted for a
//             non-integer exponent; x ** <int literal> is lax.integer_pow,
//             F_IPOW: binary exponentiation, acc*x then x*x, 1/acc for a
//             negative exponent, in the same order as the plain version
//             (torch.pow's own special cases of 2 and 0.5 are never taken).
//   min max   NaN propagates (fminf would drop it); of two zeros min takes
//             -0.0 and max +0.0, as jnp.minimum / jnp.maximum do.
//   %         Python's remainder: fmodf, then the divisor added where the
//             remainder is nonzero and its sign differs from the divisor's
//             (a zero remainder keeps fmodf's sign). On int32 a divisor of
//             0 gives 0 (jnp divides by 1) and -1 gives 0.
//   int32     add, sub, mul, neg, abs wrap (done in uint32); int ** int
//             array is jnp's six-round binary exponentiation.
//   bool      a value is 0 or 1; f32 -> bool is x != 0 (NaN is true).
//   sigmoid, saturation are expanded by the compiler into the ops above,
//             exactly as _FUNCS composes them.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColCache = 8;
constexpr int kSmemLimit = 200 * 1024;

enum Op : int {
  LD_CONST_F = 0, LD_CONST_I = 1, LD_CONST_B = 2, LD_COL = 3, LD_EMPTY = 4,
  LD_SCORE = 5, LD_PARAM = 6, LD_PROD = 7, LD_ROW_F = 8, LD_ROW_I = 9,
  LD_ROW_B = 10, B2I = 11, B2F = 12, I2F = 13, F2B = 14, I2B = 15,
  F_ADD = 16, F_SUB = 17, F_MUL = 18, F_DIV = 19, F_MOD = 20, F_POW = 21,
  F_MIN = 22, F_MAX = 23, F_NEG = 24, F_ABS = 25, F_FLOOR = 26, F_CEIL = 27,
  F_LOG = 28, F_LOG10 = 29, F_SQRT = 30, F_EXP = 31, F_IPOW = 32,
  F_LT = 33, F_LE = 34, F_GT = 35, F_GE = 36, F_EQ = 37, F_NE = 38,
  I_ADD = 40, I_SUB = 41, I_MUL = 42, I_MOD = 43, I_POW = 44, I_MIN = 45,
  I_MAX = 46, I_NEG = 47, I_ABS = 48, I_IPOW = 49,
  I_LT = 50, I_LE = 51, I_GT = 52, I_GE = 53, I_EQ = 54, I_NE = 55,
  B_AND = 56, B_OR = 57, B_NOT = 58, SELECT = 59,
};

__device__ __forceinline__ float as_f(uint32_t w) { return __uint_as_float(w); }
__device__ __forceinline__ uint32_t of_f(float f) { return __float_as_uint(f); }
__device__ __forceinline__ int32_t as_i(uint32_t w) { return (int32_t)w; }

__device__ __forceinline__ float fmin_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;
}

__device__ __forceinline__ float fmax_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;
}

__device__ __forceinline__ float fmod_py(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, b);
  return m;
}

__device__ __forceinline__ int32_t imod_py(int32_t a, int32_t b) {
  if (b == 0 || b == -1) b = 1;
  int32_t m = a % b;
  if (m != 0 && ((m < 0) != (b < 0))) m = (int32_t)((uint32_t)m + (uint32_t)b);
  return m;
}

__device__ __forceinline__ float fipow(float x, int n) {
  if (n == 0) return 1.0f;
  const bool recip = n < 0;
  unsigned k = recip ? 0u - (unsigned)n : (unsigned)n;
  float acc = 0.0f;
  bool have = false;
  while (k > 0) {
    if (k & 1u) {
      acc = have ? __fmul_rn(acc, x) : x;
      have = true;
    }
    k >>= 1;
    if (k > 0) x = __fmul_rn(x, x);
  }
  return recip ? __fdiv_rn(1.0f, acc) : acc;
}

__device__ __forceinline__ int32_t iipow(int32_t x, int n) {
  if (n == 0) return 1;
  uint32_t ux = (uint32_t)x, acc = 0;
  bool have = false;
  unsigned k = (unsigned)n;
  while (k > 0) {
    if (k & 1u) {
      acc = have ? acc * ux : ux;
      have = true;
    }
    k >>= 1;
    if (k > 0) ux = ux * ux;
  }
  return (int32_t)acc;
}

__device__ __forceinline__ int32_t ipow_int_int(int32_t x, int32_t y) {
  uint32_t ux = (uint32_t)x, uy = (uint32_t)y;
  uint32_t acc = (x == 0 && y != 0) ? 0u : 1u;
  for (int i = 0; i < 6; ++i) {
    if (uy & 1u) acc = acc * ux;
    ux = ux * ux;
    uy >>= 1;
  }
  return (int32_t)acc;
}

template <int kStack, bool kSharedProgram>
__global__ void __launch_bounds__(kThreads)
script_eval_kernel(const long long* __restrict__ blob, int n_cols,
                   int n_prods, int n_ops, int n_consts,
                   const float* __restrict__ score,
                   const float* __restrict__ params, int n_params,
                   const uint32_t* __restrict__ rowvals,
                   uint32_t* __restrict__ out, int batch, long long n) {
  extern __shared__ long long smem[];
  const long long* ptrs = blob;
  const long long* gops = blob + 2 * n_cols + 2 * n_prods;
  const long long* gconsts = gops + n_ops;
  const long long* ops = gops;
  const long long* consts = gconsts;
  if (kSharedProgram) {
    for (int i = threadIdx.x; i < n_ops + n_consts; i += blockDim.x)
      smem[i] = __ldg(gops + i);
    __syncthreads();
    ops = smem;
    consts = smem + n_ops;
  }
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;

  // the row's first column values, loaded once for the whole batch
  float cval[kColCache];
  bool cex[kColCache];
#pragma unroll
  for (int c = 0; c < kColCache; ++c) {
    if (c < n_cols) {
      const float* v = reinterpret_cast<const float*>(__ldg(ptrs + c));
      const uint8_t* e =
          reinterpret_cast<const uint8_t*>(__ldg(ptrs + n_cols + c));
      cex[c] = e[row] != 0;
      cval[c] = v[row];
    }
  }

  uint32_t st[kStack];
  for (int b = 0; b < batch; ++b) {
    int sp = 0;
    const long long cell = (long long)b * n + row;
    for (int pc = 0; pc < n_ops; ++pc) {
      const long long word = ops[pc];
      const int op = (int)(word >> 32);
      const int arg = (int)(word & 0xffffffffLL);
      switch (op) {
        case LD_CONST_F:
        case LD_CONST_I:
          st[sp++] = (uint32_t)consts[arg];
          break;
        case LD_CONST_B:
          st[sp++] = (uint32_t)consts[arg] != 0u;
          break;
        case LD_COL: {
          float v;
          bool ex;
          if (arg < kColCache) {
            v = cval[arg];
            ex = cex[arg];
          } else {
            v = reinterpret_cast<const float*>(__ldg(ptrs + arg))[row];
            ex = reinterpret_cast<const uint8_t*>(
                     __ldg(ptrs + n_cols + arg))[row] != 0;
          }
          st[sp++] = of_f(ex ? v : 0.0f);
          break;
        }
        case LD_EMPTY: {
          bool ex;
          if (arg < kColCache) ex = cex[arg];
          else ex = reinterpret_cast<const uint8_t*>(
                        __ldg(ptrs + n_cols + arg))[row] != 0;
          st[sp++] = ex ? 0u : 1u;
          break;
        }
        case LD_SCORE:
          st[sp++] = of_f(score[cell]);
          break;
        case LD_PARAM:
          st[sp++] = of_f(params[(long long)b * n_params + arg]);
          break;
        case LD_PROD: {
          const float* p =
              reinterpret_cast<const float*>(__ldg(ptrs + 2 * n_cols + arg));
          const uint8_t* e = reinterpret_cast<const uint8_t*>(
              __ldg(ptrs + 2 * n_cols + n_prods + arg));
          st[sp++] = of_f(e[row] ? p[cell] : 0.0f);
          break;
        }
        case LD_ROW_F:
        case LD_ROW_I:
          st[sp++] = rowvals[(long long)arg * n + row];
          break;
        case LD_ROW_B:
          st[sp++] = rowvals[(long long)arg * n + row] != 0u;
          break;
        case B2I:
          break;  // 0 / 1 either way
        case B2F:
          st[sp - 1] = of_f(st[sp - 1] ? 1.0f : 0.0f);
          break;
        case I2F:
          st[sp - 1] = of_f(__int2float_rn(as_i(st[sp - 1])));
          break;
        case F2B:
          st[sp - 1] = as_f(st[sp - 1]) != 0.0f;
          break;
        case I2B:
          st[sp - 1] = st[sp - 1] != 0u;
          break;
        case F_NEG:
          st[sp - 1] ^= 0x80000000u;
          break;
        case F_ABS:
          st[sp - 1] = of_f(fabsf(as_f(st[sp - 1])));
          break;
        case F_FLOOR:
          st[sp - 1] = of_f(floorf(as_f(st[sp - 1])));
          break;
        case F_CEIL:
          st[sp - 1] = of_f(ceilf(as_f(st[sp - 1])));
          break;
        case F_LOG:
          st[sp - 1] = of_f(logf(as_f(st[sp - 1])));
          break;
        case F_LOG10:
          st[sp - 1] = of_f(log10f(as_f(st[sp - 1])));
          break;
        case F_SQRT:
          st[sp - 1] = of_f(sqrtf(as_f(st[sp - 1])));
          break;
        case F_EXP:
          st[sp - 1] = of_f(expf(as_f(st[sp - 1])));
          break;
        case F_IPOW:
          st[sp - 1] = of_f(fipow(as_f(st[sp - 1]), arg));
          break;
        case I_NEG:
          st[sp - 1] = 0u - st[sp - 1];
          break;
        case I_ABS:
          if (as_i(st[sp - 1]) < 0) st[sp - 1] = 0u - st[sp - 1];
          break;
        case I_IPOW:
          st[sp - 1] = (uint32_t)iipow(as_i(st[sp - 1]), arg);
          break;
        case B_NOT:
          st[sp - 1] ^= 1u;
          break;
        case SELECT: {
          const uint32_t bb = st[--sp];
          const uint32_t aa = st[--sp];
          st[sp - 1] = st[sp - 1] ? aa : bb;
          break;
        }
        default: {
          const uint32_t wb = st[--sp];
          const uint32_t wa = st[sp - 1];
          const float fa = as_f(wa), fb = as_f(wb);
          const int32_t ia = as_i(wa), ib = as_i(wb);
          uint32_t r = 0;
          switch (op) {
            case F_ADD: r = of_f(__fadd_rn(fa, fb)); break;
            case F_SUB: r = of_f(__fsub_rn(fa, fb)); break;
            case F_MUL: r = of_f(__fmul_rn(fa, fb)); break;
            case F_DIV: r = of_f(__fdiv_rn(fa, fb)); break;
            case F_MOD: r = of_f(fmod_py(fa, fb)); break;
            case F_POW: r = of_f(powf(fa, fb)); break;
            case F_MIN: r = of_f(fmin_nan(fa, fb)); break;
            case F_MAX: r = of_f(fmax_nan(fa, fb)); break;
            case F_LT: r = fa < fb; break;
            case F_LE: r = fa <= fb; break;
            case F_GT: r = fa > fb; break;
            case F_GE: r = fa >= fb; break;
            case F_EQ: r = fa == fb; break;
            case F_NE: r = fa != fb; break;
            case I_ADD: r = wa + wb; break;
            case I_SUB: r = wa - wb; break;
            case I_MUL: r = wa * wb; break;
            case I_MOD: r = (uint32_t)imod_py(ia, ib); break;
            case I_POW: r = (uint32_t)ipow_int_int(ia, ib); break;
            case I_MIN: r = (uint32_t)(ia < ib ? ia : ib); break;
            case I_MAX: r = (uint32_t)(ia > ib ? ia : ib); break;
            case I_LT: r = ia < ib; break;
            case I_LE: r = ia <= ib; break;
            case I_GT: r = ia > ib; break;
            case I_GE: r = ia >= ib; break;
            case I_EQ: r = ia == ib; break;
            case I_NE: r = ia != ib; break;
            case B_AND: r = (wa != 0u) & (wb != 0u); break;
            case B_OR: r = (wa != 0u) | (wb != 0u); break;
            default: break;
          }
          st[sp - 1] = r;
          break;
        }
      }
    }
    out[cell] = st[0];
  }
}

template <int kStack, bool kShared>
cudaError_t launch_one(const long long* blob, int n_cols, int n_prods,
                       int n_ops, int n_consts, const float* score,
                       const float* params, int n_params,
                       const uint32_t* rowvals, uint32_t* out, int batch,
                       long long n, cudaStream_t stream) {
  const size_t smem =
      kShared ? (size_t)(n_ops + n_consts) * sizeof(long long) : 0;
  if (kShared) {
    // the most any call may take, set once (a per-call size could race
    // with another thread's launch)
    static bool set = false;
    if (!set) {
      cudaError_t e = cudaFuncSetAttribute(
          script_eval_kernel<kStack, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (e != cudaSuccess) return e;
      set = true;
    }
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  script_eval_kernel<kStack, kShared><<<(unsigned)blocks, kThreads, smem,
                                        stream>>>(
      blob, n_cols, n_prods, n_ops, n_consts, score, params, n_params,
      rowvals, out, batch, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int script_eval_launch(const long long* blob, int n_cols, int n_prods,
                       int n_ops, int n_consts, const float* score,
                       const float* params, int n_params,
                       const uint32_t* rowvals, uint32_t* out, int batch,
                       long long n, int depth, cudaStream_t stream) {
  if (depth > 1024) return (int)cudaErrorInvalidValue;
  const bool shared =
      (size_t)(n_ops + n_consts) * sizeof(long long) <= (size_t)kSmemLimit;
  cudaError_t e;
  if (depth <= 32) {
    e = shared ? launch_one<32, true>(blob, n_cols, n_prods, n_ops, n_consts,
                                      score, params, n_params, rowvals, out,
                                      batch, n, stream)
               : launch_one<32, false>(blob, n_cols, n_prods, n_ops,
                                       n_consts, score, params, n_params,
                                       rowvals, out, batch, n, stream);
  } else {
    e = shared ? launch_one<1024, true>(blob, n_cols, n_prods, n_ops,
                                        n_consts, score, params, n_params,
                                        rowvals, out, batch, n, stream)
               : launch_one<1024, false>(blob, n_cols, n_prods, n_ops,
                                         n_consts, score, params, n_params,
                                         rowvals, out, batch, n, stream);
  }
  return (int)e;
}

const char* script_eval_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
