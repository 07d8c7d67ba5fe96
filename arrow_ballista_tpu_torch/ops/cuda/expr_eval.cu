// Expression prologue for sm_90a: a stage's filter, aggregate arguments
// and their validities for every row of one batch, in one launch.
//
// Replaces arrow_ballista_tpu/ops/kernels.py:JaxExprCompiler (kernel B3):
// the closures that XLA inlines into make_partial_agg_kernel,
// make_join_kernel, make_keyed_prep_kernel and the fused runner.  The port
// compiles them into a linear register program (ops/kernels.py:
// ExprProgram): row i of the code computes register i, equal subtrees
// share a register, and store rows write the outputs.
//
// Bound: bytes.  Each leaf column and validity is read once and each
// output written once (q1: 32 bytes in and 17 out a row); a few dozen
// f64 operations a row are far below the card's rate.
//
// Design: one thread per row over a grid-stride loop; every thread runs
// the same code, so the switch on the opcode is warp-uniform.  The code
// crosses as one small device tensor made once per stage function (not
// __constant__ memory: executor task threads launch concurrently) and each
// CTA copies it into shared memory; IN tables are read through the
// read-only cache.  The registers' 8-byte values are a CTA tile in shared
// memory, [reg][thread] so that a warp's accesses fall in distinct banks,
// sized to the program (256 threads a CTA, halved while the tile passes
// 48 KiB); each thread keeps its registers' validity bits in one 64-bit
// word (bytes in the tile past 64 registers), and the operand registers'
// dtypes come packed beside each opcode, so an instruction reads from
// shared memory only its row and its operands' values.
//
// Numerics are torch's one-op kernels' on the card, bit for bit: f64
// + - * / through the _rn intrinsics (never contracted into an FMA);
// int64 + - * and negation in uint64 (wrapping, where signed overflow is
// undefined in C++); x / -1 as the wrapping negation and x % -1 as 0
// (INT64_MIN / -1 is INT64_MIN); float % as torch's remainder (fmod, then
// the divisor added when the signs differ); float -> int64 casts through
// cvt.rzi (saturating, NaN -> 0), CAST explicitly so; the transcendentals
// through the same libdevice functions torch's kernels call.
//
// x32 programs (the reference's x32 closures) run in int32 and float32
// registers with the same rules in 32 bits: one f32 rounding per operation
// (__f*_rn, never an FMA), int32 arithmetic that wraps, the f32 libdevice
// functions (sqrtf, expf, ...), float -> int32 casts saturating at the
// int32 range.

#include <cuda_runtime.h>
#include <stdint.h>

#include "expr_eval.h"

namespace {

typedef unsigned long long u64;

constexpr int kMaxThreads = 256;
constexpr size_t kSmemTarget = 48 << 10;   // halve the CTA past this
constexpr unsigned kMaxBlocks = 132 * 16;  // 16 CTAs per SM, then stride
constexpr long long kI64Max = 0x7fffffffffffffffLL;
constexpr long long kI64Min = -kI64Max - 1;

__device__ __forceinline__ double as_f64(u64 b) { return __longlong_as_double((long long)b); }
__device__ __forceinline__ u64 f64_bits(double x) { return (u64)__double_as_longlong(x); }
__device__ __forceinline__ float as_f32(u64 b) { return __int_as_float((int)(unsigned)b); }
__device__ __forceinline__ u64 f32_bits(float x) { return (u64)(unsigned)__float_as_int(x); }
__device__ __forceinline__ u64 i32_word(int v) { return (u64)(long long)v; }

// torch's .to(dtype) between the five dtypes; a bool is 0 or 1, an int32
// register is sign-extended, so the integer sources read as long long.
__device__ __forceinline__ u64 convert(u64 b, int from, int to) {
  if (from == to) return b;
  const bool ints = from == kDtI64 || from == kDtI32 || from == kDtBool;
  switch (to) {
    case kDtBool:
      if (from == kDtF64) return as_f64(b) != 0.0;
      if (from == kDtF32) return as_f32(b) != 0.0f;
      return b != 0;
    case kDtI64:
      if (from == kDtF64) return (u64)__double2ll_rz(as_f64(b));
      if (from == kDtF32) return (u64)__float2ll_rz(as_f32(b));
      return b;
    case kDtI32:
      if (from == kDtF64) return i32_word(__double2int_rz(as_f64(b)));
      if (from == kDtF32) return i32_word(__float2int_rz(as_f32(b)));
      return i32_word((int)(unsigned)b);  // wraps, as .to(int32)
    case kDtF32:
      if (from == kDtF64) return f32_bits(__double2float_rn(as_f64(b)));
      if (from == kDtBool) return f32_bits(b ? 1.0f : 0.0f);
      return f32_bits(from == kDtI32 ? __int2float_rn((int)(long long)b)
                                     : __ll2float_rn((long long)b));
    default:  // kDtF64
      if (from == kDtF32) return f64_bits((double)as_f32(b));
      if (from == kDtBool) return f64_bits(b ? 1.0 : 0.0);
      return f64_bits(ints ? __ll2double_rn((long long)b) : as_f64(b));
  }
}

// A value as a condition (nonzero; NaN is true).
__device__ __forceinline__ bool truth(u64 b, int dt) {
  if (dt == kDtF64) return as_f64(b) != 0.0;
  if (dt == kDtF32) return as_f32(b) != 0.0f;
  return b != 0;
}

__device__ __forceinline__ bool compare(int op, u64 x, u64 y, int dt) {
  if (dt == kDtF32) {
    const float l = as_f32(x), r = as_f32(y);
    switch (op) {
      case kOpEq: return l == r;
      case kOpNe: return l != r;
      case kOpLt: return l < r;
      case kOpLe: return l <= r;
      case kOpGt: return l > r;
      default: return l >= r;
    }
  }
  if (dt == kDtF64) {
    const double l = as_f64(x), r = as_f64(y);
    switch (op) {
      case kOpEq: return l == r;
      case kOpNe: return l != r;
      case kOpLt: return l < r;
      case kOpLe: return l <= r;
      case kOpGt: return l > r;
      default: return l >= r;
    }
  }
  const long long l = (long long)x, r = (long long)y;
  switch (op) {
    case kOpEq: return l == r;
    case kOpNe: return l != r;
    case kOpLt: return l < r;
    case kOpLe: return l <= r;
    case kOpGt: return l > r;
    default: return l >= r;
  }
}

__device__ __forceinline__ u64 arith(int op, u64 x, u64 y, int dt) {
  if (dt == kDtF64) {
    const double l = as_f64(x), r = as_f64(y);
    return f64_bits(op == kOpAdd ? __dadd_rn(l, r)
                    : op == kOpSub ? __dsub_rn(l, r) : __dmul_rn(l, r));
  }
  if (dt == kDtF32) {
    const float l = as_f32(x), r = as_f32(y);
    return f32_bits(op == kOpAdd ? __fadd_rn(l, r)
                    : op == kOpSub ? __fsub_rn(l, r) : __fmul_rn(l, r));
  }
  if (dt == kDtBool) return op == kOpAdd ? (x | y) : (x & y);  // torch: or, and
  const u64 w = op == kOpAdd ? x + y : op == kOpSub ? x - y : x * y;
  return dt == kDtI32 ? i32_word((int)(unsigned)w) : w;
}

__device__ __forceinline__ double unary_f64(int op, double x) {
  switch (op) {
    case kOpAbs: return ::fabs(x);
    case kOpSqrt: return ::sqrt(x);
    case kOpExp: return ::exp(x);
    case kOpLn: return ::log(x);
    case kOpLog10: return ::log10(x);
    case kOpLog2: return ::log2(x);
    case kOpCeil: return ::ceil(x);
    case kOpFloor: return ::floor(x);
    case kOpSin: return ::sin(x);
    case kOpCos: return ::cos(x);
    case kOpTan: return ::tan(x);
    case kOpSignum: return (x != x || x == 0.0) ? x : (x > 0.0 ? 1.0 : -1.0);
    case kOpRound: return ::rint(x);  // half to even
    default: return __dmul_rn(x, x);  // kOpSquare
  }
}

__device__ __forceinline__ float unary_f32(int op, float x) {
  switch (op) {
    case kOpAbs: return ::fabsf(x);
    case kOpSqrt: return ::sqrtf(x);
    case kOpExp: return ::expf(x);
    case kOpLn: return ::logf(x);
    case kOpLog10: return ::log10f(x);
    case kOpLog2: return ::log2f(x);
    case kOpCeil: return ::ceilf(x);
    case kOpFloor: return ::floorf(x);
    case kOpSin: return ::sinf(x);
    case kOpCos: return ::cosf(x);
    case kOpTan: return ::tanf(x);
    case kOpSignum: return (x != x || x == 0.0f) ? x : (x > 0.0f ? 1.0f : -1.0f);
    case kOpRound: return ::rintf(x);  // half to even
    default: return __fmul_rn(x, x);  // kOpSquare
  }
}

// The error word of x² for the exact float32 pair x = hi + lo (kernel
// B12f, x32's variance family; its p word is kOpSquare of hi), in the
// order the reference's square_pair_closure compiles to: the Dekker
// error hi·hi - p as one FMA (NaN where the Veltkamp split hi·4097
// overflows, as there), then fma(2·hi, lo, e) + lo·lo.  Each step rounds
// as written: no contraction beyond the FMAs named.
__device__ __forceinline__ float sqpair_lo(float hi, float lo) {
  const float p = __fmul_rn(hi, hi);
  const float split = __fmul_rn(hi, 4097.0f);
  float e = isinf(split) ? __int_as_float(0x7fc00000) : __fmaf_rn(hi, hi, -p);
  e = __fmaf_rn(__fmul_rn(2.0f, hi), lo, e);
  return __fadd_rn(e, __fmul_rn(lo, lo));
}

// A float register as the function's operand dtype (kDtF64 or kDtF32).
__device__ __forceinline__ u64 unary(int op, u64 x, int dt) {
  return dt == kDtF32 ? f32_bits(unary_f32(op, as_f32(x))) : f64_bits(unary_f64(op, as_f64(x)));
}

// Validity bits of a thread's registers: one 64-bit word in a register
// for programs of up to kExprMaskRegs registers (each register is written
// once a row, so bits are or-ed into a word cleared a row), else one byte
// a register in shared memory.
template <bool kInWord>
struct Validity {
  unsigned long long word;
  unsigned char* bytes;  // [reg][thread]
  int T, t;
  __device__ __forceinline__ void clear() { word = 0; }
  __device__ __forceinline__ bool get(int r) const {
    return kInWord ? (word >> r) & 1ULL : bytes[r * T + t] != 0;
  }
  __device__ __forceinline__ void set(int r, bool v) {
    if (kInWord) {
      word |= (unsigned long long)v << r;
    } else {
      bytes[r * T + t] = v;
    }
  }
};

// __grid_constant__: the input and output pointer tables are indexed at
// run time, read in place from the parameter bank instead of copied
template <bool kInWord>
__global__ void expr_eval_kernel(const __grid_constant__ ExprEvalParams p) {
  extern __shared__ long long smem[];
  ExprInstr* code = reinterpret_cast<ExprInstr*>(smem);
  const int T = blockDim.x, t = threadIdx.x;
  u64* vals = reinterpret_cast<u64*>(code + p.n_instr);
  Validity<kInWord> oks{0, reinterpret_cast<unsigned char*>(vals + (size_t)p.n_regs * T), T, t};
  const long long* src = reinterpret_cast<const long long*>(p.code);
  for (int i = t; i < p.n_instr * 4; i += T) smem[i] = src[i];
  __syncthreads();

  const long long stride = (long long)gridDim.x * T;
  for (long long row = (long long)blockIdx.x * T + t; row < p.n; row += stride) {
    oks.clear();
    for (int i = 0; i < p.n_instr; ++i) {
      const ExprInstr in = code[i];
      const int op = in.op & 0xff;
      const int da = (in.op >> 8) & 0xff, db = (in.op >> 16) & 0xff;
      const int a = in.a, b = in.b;
      // register a (a leaf's a is an input slot; a literal has none)
      const bool reg_a = op != kOpLeaf && a >= 0;
      const u64 va = reg_a ? vals[a * T + t] : 0;
      const bool oa = reg_a ? oks.get(a) : true;
      if (op == kOpStoreValue) {
        void* dst = p.out[b];
        if (dst != nullptr) {
          const u64 w = convert(va, da, in.out_dt);
          if (in.out_dt == kDtBool) {
            static_cast<unsigned char*>(dst)[row] = (unsigned char)w;
          } else if (in.out_dt == kDtI32 || in.out_dt == kDtF32) {
            static_cast<unsigned*>(dst)[row] = (unsigned)w;
          } else {
            static_cast<u64*>(dst)[row] = w;
          }
        }
        continue;
      }
      if (op == kOpStoreValid) {
        void* dst = p.out[b];
        if (dst != nullptr) static_cast<unsigned char*>(dst)[row] = oa;
        continue;
      }
      u64 v = 0;
      bool ok = true;
      switch (op) {
        case kOpLeaf:
          if (a >= 0) {
            if (in.out_dt == kDtBool) {
              v = (u64)(static_cast<const unsigned char*>(p.in[a])[row] != 0);
            } else if (in.out_dt == kDtI32) {
              v = i32_word(static_cast<const int*>(p.in[a])[row]);
            } else if (in.out_dt == kDtF32) {
              v = (u64)static_cast<const unsigned*>(p.in[a])[row];
            } else {
              v = static_cast<const u64*>(p.in[a])[row];
            }
          }
          if (p.in[b] != nullptr) ok = static_cast<const unsigned char*>(p.in[b])[row] != 0;
          break;
        case kOpLit:
          v = (in.out_dt == kDtF32) ? (u64)(unsigned)in.imm : (u64)in.imm;
          break;
        case kOpNull:
          ok = false;
          break;
        case kOpConvert:
          v = convert(va, da, in.out_dt);
          ok = oa;
          break;
        case kOpCastI64: {  // float -> the result's integer dtype, saturating
          if (in.out_dt == kDtI32) {
            const float x = as_f32(convert(va, da, kDtF32));
            v = i32_word(x != x ? 0
                         : x >= 2147483648.0f ? 0x7fffffff
                         : x < -2147483648.0f ? (-0x7fffffff - 1) : __float2int_rz(x));
          } else {
            const double x = as_f64(convert(va, da, kDtF64));
            v = (u64)(x != x ? 0LL
                      : x >= 9223372036854775808.0 ? kI64Max
                      : x < -9223372036854775808.0 ? kI64Min : __double2ll_rz(x));
          }
          ok = oa;
          break;
        }
        case kOpAnd:
        case kOpOr: {
          const bool l = truth(va, da) && oa;
          const bool r = truth(vals[b * T + t], db) && oks.get(b);
          v = op == kOpAnd ? (l && r) : (l || r);
          break;
        }
        case kOpNot:
          v = !(truth(va, da) && oa);
          break;
        case kOpIsNull:
          v = !oa;
          break;
        case kOpIsNotNull:
          v = oa;
          break;
        case kOpIn:
        case kOpNotIn: {
          const u64 x = convert(va, da, in.in_dt);
          const long long* table = p.consts + b;
          bool hit = false;
          if (in.in_dt == kDtF64) {
            const double l = as_f64(x);
            for (int j = 0; j < in.c && !hit; ++j) hit = as_f64((u64)__ldg(table + j)) == l;
          } else if (in.in_dt == kDtF32) {
            const float l = as_f32(x);
            for (int j = 0; j < in.c && !hit; ++j) hit = as_f32((u64)__ldg(table + j)) == l;
          } else if (in.in_dt == kDtI32) {  // table words hold int32 values
            for (int j = 0; j < in.c && !hit; ++j) hit = (int)__ldg(table + j) == (int)x;
          } else {
            for (int j = 0; j < in.c && !hit; ++j) hit = (u64)__ldg(table + j) == x;
          }
          v = op == kOpIn ? hit : !hit;
          ok = oa;
          break;
        }
        case kOpSelect: {
          const bool cnd = truth(va, da) && oa;
          v = cnd ? convert(vals[b * T + t], db, in.out_dt) : vals[in.c * T + t];
          ok = cnd ? oks.get(b) : oks.get(in.c);
          break;
        }
        default: {
          const bool binary = op <= kOpModF || op == kOpPower || op == kOpSqPairLo;
          const u64 vb = binary ? vals[b * T + t] : 0;
          ok = binary ? oa && oks.get(b) : oa;
          if (op >= kOpEq && op <= kOpGe) {
            v = compare(op, convert(va, da, in.in_dt), convert(vb, db, in.in_dt), in.in_dt);
          } else if (op >= kOpAdd && op <= kOpMul) {
            v = arith(op, convert(va, da, in.in_dt), convert(vb, db, in.in_dt), in.in_dt);
          } else if (op == kOpDivInt || op == kOpModInt) {
            // in the operand dtype's width (int64, or int32 in x32)
            const long long l = (long long)convert(va, da, in.in_dt);
            const long long r = (long long)convert(vb, db, in.in_dt);
            if (op == kOpDivInt) {
              v = r == -1 ? 0ULL - (u64)l : (u64)(l / (r == 0 ? 1 : r));
            } else if (r == 0 || r == -1) {
              v = 0;
            } else {
              long long m = l % r;
              if (m != 0 && ((m < 0) != (r < 0))) m += r;
              v = (u64)m;
            }
            if (in.in_dt == kDtI32) v = i32_word((int)(unsigned)v);
          } else if (in.in_dt == kDtF32 &&
                     (op == kOpDivF || op == kOpModF || op == kOpPower)) {
            const float l = as_f32(convert(va, da, kDtF32));
            const float r = as_f32(convert(vb, db, kDtF32));
            float out;
            if (op == kOpDivF) {
              out = __fdiv_rn(l, r);
            } else if (op == kOpPower) {
              out = ::powf(l, r);
            } else {
              out = ::fmodf(l, r);
              if (out != 0.0f && ((r < 0.0f) != (out < 0.0f))) out = __fadd_rn(out, r);
            }
            v = f32_bits(out);
          } else if (op == kOpDivF || op == kOpModF || op == kOpPower) {
            const double l = as_f64(convert(va, da, kDtF64));
            const double r = as_f64(convert(vb, db, kDtF64));
            double out;
            if (op == kOpDivF) {
              out = __ddiv_rn(l, r);
            } else if (op == kOpPower) {
              out = ::pow(l, r);
            } else {
              out = ::fmod(l, r);
              if (out != 0.0 && ((r < 0.0) != (out < 0.0))) out = __dadd_rn(out, r);
            }
            v = f64_bits(out);
          } else if (op == kOpSqPairLo) {  // x32 only: float32 operands
            v = f32_bits(sqpair_lo(as_f32(convert(va, da, kDtF32)),
                                   as_f32(convert(vb, db, kDtF32))));
          } else if (op == kOpNeg) {
            const u64 x = convert(va, da, in.in_dt);
            if (in.in_dt == kDtF64) {
              v = f64_bits(-as_f64(x));
            } else if (in.in_dt == kDtF32) {
              v = f32_bits(-as_f32(x));
            } else {
              v = 0ULL - x;
              if (in.in_dt == kDtI32) v = i32_word((int)(unsigned)v);
            }
          } else {  // the float functions and the square, in the operand dtype
            v = unary(op, convert(va, da, in.in_dt), in.in_dt);
          }
          break;
        }
      }
      vals[i * T + t] = v;
      oks.set(i, ok);
    }
  }
}

}  // namespace

extern "C" cudaError_t expr_eval_launch(const ExprEvalParams* params, cudaStream_t stream) {
  const ExprEvalParams& p = *params;
  if (p.n <= 0 || p.n_instr <= 0) return cudaSuccess;
  int threads = kMaxThreads;
  while (threads > 32 && expr_smem_bytes(p.n_instr, p.n_regs, threads) > kSmemTarget) {
    threads /= 2;
  }
  const size_t smem = expr_smem_bytes(p.n_instr, p.n_regs, threads);
  if (smem > (size_t)kExprSmemLimit || p.n_instr > kExprMaxInstr) return cudaErrorInvalidValue;
  const bool in_word = p.n_regs <= kExprMaskRegs;
  // always the same limit: task threads launch concurrently
  cudaError_t err = cudaFuncSetAttribute(
      in_word ? expr_eval_kernel<true> : expr_eval_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kExprSmemLimit);
  if (err != cudaSuccess) return err;
  long long blocks = (p.n + threads - 1) / threads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (in_word) {
    expr_eval_kernel<true><<<(unsigned)blocks, threads, smem, stream>>>(p);
  } else {
    expr_eval_kernel<false><<<(unsigned)blocks, threads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}
