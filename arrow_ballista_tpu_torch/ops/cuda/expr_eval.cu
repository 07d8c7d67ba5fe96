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
// operations a row are far below the card's rate, so long as each row of
// code costs the card a few instructions a row of data and not a decode.
//
// Design: a CTA takes tiles of T x R rows (expr_eval.h:expr_plan sizes T,
// R and the shared memory to the program), thread t the R consecutive
// rows t R .. t R + R - 1.  Each row of code is read and decoded once a
// tile and runs as typed loops over the thread's R rows: the switches on
// the opcode and on the operand dtypes pick the loops, templated on the
// C++ types, and nothing inside a loop branches on a dtype or an opcode;
// an operand of another dtype is converted first, by a loop of its own
// (from -> to) into a scratch block.  A register lives where
// ExprProgram.reg_layout puts it: a block of R values a thread in shared
// memory, read and written 16 bytes at a time (the chunks of a 32- or
// 64-byte block swizzled by thread, so that an access phase falls in
// distinct banks); one uniform value (literals and what only they feed,
// computed once a CTA before the first tile); a leaf's staged input
// itself; or, a bool, one R-bit mask a thread.  A register's validity is
// an R-bit mask a thread too, so AND, OR, NOT, SELECT and the null tests
// act on R rows at once; a register whose validity this batch cannot
// carry (the wrapper's presence bits) keeps none, and a row with nothing
// to do a tile (an invariant register, a numeric leaf without a validity,
// a store to an output not written) is skipped.  The leaf columns
// (values and validities) of the next tile are copied into shared memory
// with cp.async while this tile runs (two buffers), or, where one buffer
// lets an SM hold more warps, this tile's just before it runs: then the
// CTAs of an SM hide one another's copies.  The body is bound by its
// instructions' latency, not their count, so the rule favours warps.  A
// value output is stored by the warp together, 512 consecutive bytes a
// store; a bool or validity output as each thread's R bytes in one store.  The code stays in global memory, read through the
// read-only cache (every thread of a warp reads the same row).
//
// Numerics are torch's one-op kernels' on the card, bit for bit: f64
// + - * / through the _rn intrinsics (never contracted into an FMA);
// int64 + - * and negation in uint64 (wrapping, where signed overflow is
// undefined in C++); x / -1 as the wrapping negation and x % -1 as 0
// (INT64_MIN / -1 is INT64_MIN); float % as torch's remainder (fmod, then
// the divisor added when the signs differ); float -> int64 casts through
// cvt.rzi (saturating, NaN -> 0), CAST explicitly so; the transcendentals
// through the same libdevice functions torch's kernels call.  Each value
// is computed by the same operation on the same operands as in the
// per-row evaluation the twin (ops/kernels.py:expr_program_reference)
// specifies: the tile changes where a value is kept, never how it is
// computed, so the bits are the twin's.
//
// x32 programs (the reference's x32 closures) run in int32 and float32
// registers with the same rules in 32 bits: one f32 rounding per operation
// (__f*_rn, never an FMA), int32 arithmetic that wraps, the f32 libdevice
// functions (sqrtf, expf, ...), float -> int32 casts saturating at the
// int32 range.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>
#include <utility>
#include <type_traits>

#include "expr_eval.h"

namespace {

typedef unsigned long long u64;
constexpr int kR = kExprMaxRows;
constexpr long long kI64Max = 0x7fffffffffffffffLL;
constexpr long long kI64Min = -kI64Max - 1;

// ---------------------------------------------------------- conversions
// torch's .to(dtype) between the numeric types (Cvt<From, To>)
template <class F, class X> struct Cvt;
template <class X> struct Cvt<X, X> {
  static __device__ __forceinline__ X go(X x) { return x; }
};
template <> struct Cvt<long long, double> {
  static __device__ __forceinline__ double go(long long x) { return __ll2double_rn(x); }
};
template <> struct Cvt<int, double> {
  static __device__ __forceinline__ double go(int x) { return __ll2double_rn(x); }
};
template <> struct Cvt<float, double> {
  static __device__ __forceinline__ double go(float x) { return (double)x; }
};
template <> struct Cvt<double, long long> {
  static __device__ __forceinline__ long long go(double x) { return __double2ll_rz(x); }
};
template <> struct Cvt<float, long long> {
  static __device__ __forceinline__ long long go(float x) { return __float2ll_rz(x); }
};
template <> struct Cvt<int, long long> {
  static __device__ __forceinline__ long long go(int x) { return x; }
};
template <> struct Cvt<double, int> {
  static __device__ __forceinline__ int go(double x) { return __double2int_rz(x); }
};
template <> struct Cvt<float, int> {
  static __device__ __forceinline__ int go(float x) { return __float2int_rz(x); }
};
template <> struct Cvt<long long, int> {  // wraps, as .to(int32)
  static __device__ __forceinline__ int go(long long x) { return (int)(unsigned)(u64)x; }
};
template <> struct Cvt<double, float> {
  static __device__ __forceinline__ float go(double x) { return __double2float_rn(x); }
};
template <> struct Cvt<int, float> {
  static __device__ __forceinline__ float go(int x) { return __int2float_rn(x); }
};
template <> struct Cvt<long long, float> {
  static __device__ __forceinline__ float go(long long x) { return __ll2float_rn(x); }
};

// a bool as a number (0 or 1) and a number as a condition (nonzero; NaN is true)
template <class X> __device__ __forceinline__ X from_bit(unsigned b) { return b ? X(1) : X(0); }
template <class X> __device__ __forceinline__ bool truth(X x) { return x != X(0); }

template <class X> __device__ __forceinline__ X lit_value(long long imm) { return (X)imm; }
template <> __device__ __forceinline__ double lit_value<double>(long long imm) {
  return __longlong_as_double(imm);
}
template <> __device__ __forceinline__ float lit_value<float>(long long imm) {
  return __int_as_float((int)(unsigned)(u64)imm);
}

// ------------------------------------------------------------ the tile
// The CTA's shared memory (expr_eval.h:expr_smem_bytes), addressed by
// 32-bit byte offsets.
extern __shared__ __align__(16) char expr_smem[];

template <class X> __device__ __forceinline__ X& at(unsigned off) {
  return *reinterpret_cast<X*>(expr_smem + off);
}

// One thread's view of its CTA's shared memory for the current tile.
struct Tile {
  unsigned desc;     // [n_regs] words: a register's byte offset << 4 | kind
  unsigned vmask;    // [n_regs][T] validity bits
  unsigned usc;      // [2][T] u64: an invariant operand converted, a thread's own
  unsigned scratch;  // [n_scratch][T] 8-byte blocks: an operand converted
  unsigned stage;    // the current tile's staged inputs
  long long row0;    // the tile's first row; thread t has rows row0 + t R + r
  int T, t, R;
  int b4, b8;        // a thread's block of 4- and 8-byte values (expr_block_bytes)
  unsigned full;     // R low bits
  unsigned sw2, sw4; // this thread's chunk swizzle in a block of 2 or 4 chunks
  unsigned valid0;   // valid_bits' first word (registers 0-31)
};

// The chunk swizzle of thread t's block of `chunks` 16-byte chunks (as a
// byte offset to XOR): of the 8 threads of an access phase, those whose
// blocks fall on the same banks take their chunks in different orders.
__host__ __device__ __forceinline__ unsigned swizzle(int t, int chunks) {
  return chunks == 4 ? 16u * ((t >> 1) & 3) : chunks == 2 ? 16u * ((t >> 2) & 1) : 0u;
}

template <class X> __device__ __forceinline__ unsigned swizzle_of(const Tile& k) {
  const int chunks = k.R * (int)sizeof(X) / 16;
  return chunks == 4 ? k.sw4 : chunks == 2 ? k.sw2 : 0u;
}

// element r of a register at byte offset off + r * step (step 0: one
// value for every row)
struct Src {
  unsigned off, step;
};

template <class X> struct DtOf;
template <> struct DtOf<long long> { static constexpr int v = kDtI64; };
template <> struct DtOf<double> { static constexpr int v = kDtF64; };
template <> struct DtOf<int> { static constexpr int v = kDtI32; };
template <> struct DtOf<float> { static constexpr int v = kDtF32; };

__device__ __forceinline__ unsigned desc_of(const Tile& k, int reg) {
  return at<unsigned>(k.desc + 4 * reg);
}

__device__ __forceinline__ bool invariant(const Tile& k, int reg) {
  return desc_of(k, reg) & kRegInvariant;
}

template <class X> __device__ __forceinline__ int block_of(const Tile& k) {
  return sizeof(X) == 8 ? k.b8 : k.b4;
}

// A numeric register of type X (a leaf: its staged column).
template <class X>
__device__ __forceinline__ Src src(const Tile& k, int reg) {
  const unsigned d = desc_of(k, reg), kind = d & 3;
  unsigned off = d >> 4;
  if (kind == kRegUniform) return {off, 0};
  if (kind == kRegLeaf) off += k.stage;
  return {off + k.t * block_of<X>(k), (unsigned)sizeof(X)};
}

__device__ __forceinline__ bool has_validity(const Tile& k, const ExprEvalParams& p, int reg) {
  return ((reg < 32 ? k.valid0 : p.valid_bits[reg >> 5]) >> (reg & 31)) & 1u;
}
// a register's validity bits (every row valid when it carries none)
__device__ __forceinline__ unsigned valid_of(const Tile& k, const ExprEvalParams& p, int reg) {
  return has_validity(k, p, reg) ? at<unsigned char>(k.vmask + reg * k.T + k.t) : k.full;
}
__device__ __forceinline__ void set_valid(const Tile& k, const ExprEvalParams& p, int reg,
                                          unsigned m) {
  if (has_validity(k, p, reg)) at<unsigned char>(k.vmask + reg * k.T + k.t) = (unsigned char)m;
}
__device__ __forceinline__ unsigned mask_of(const Tile& k, int reg) {
  return at<unsigned char>((desc_of(k, reg) >> 4) + k.t);
}
__device__ __forceinline__ void set_mask(const Tile& k, int reg, unsigned m) {
  at<unsigned char>((desc_of(k, reg) >> 4) + k.t) = (unsigned char)m;
}

// four bytes as four bits (a byte is true when nonzero) and back (0 or 1)
__device__ __forceinline__ unsigned bits_of(unsigned w) {
  const unsigned b = __vcmpne4(w, 0u) & 0x01010101u;
  return (b | b >> 7 | b >> 14 | b >> 21) & 0xfu;
}
__device__ __forceinline__ unsigned bytes_of(unsigned m) {
  return (m & 1u) | (m & 2u) << 7 | (m & 4u) << 14 | (m & 8u) << 21;
}

// The R bytes of a staged bool column (a thread's consecutive rows) as a mask.
__device__ __forceinline__ unsigned bytes_mask(const Tile& k, const ExprEvalParams& p, int slot) {
  const unsigned off = k.stage + p.stage_off[slot] + k.t * k.R;
  if (k.R == 8) {
    const uint2 w = at<uint2>(off);
    return bits_of(w.x) | bits_of(w.y) << 4;
  }
  if (k.R == 4) return bits_of(at<unsigned>(off));
  unsigned m = 0;
  for (int r = 0; r < k.R; ++r) m |= (unsigned)(at<unsigned char>(off + r) != 0) << r;
  return m;
}

// ------------------------------------------------------ the typed loops
// Each runs over a thread's R rows with no branch on a dtype or an opcode
// inside: the operands' R values are loaded first (predicated, so the
// loads are in flight together), then computed, then stored.
// 16 bytes of X values
template <class X> struct Vec16;
template <> struct Vec16<double> {
  typedef double2 V;
  static __device__ __forceinline__ void get(const V& q, double* v) { v[0] = q.x; v[1] = q.y; }
  static __device__ __forceinline__ V put(const double* v) { return make_double2(v[0], v[1]); }
};
template <> struct Vec16<long long> {
  typedef longlong2 V;
  static __device__ __forceinline__ void get(const V& q, long long* v) { v[0] = q.x; v[1] = q.y; }
  static __device__ __forceinline__ V put(const long long* v) {
    return make_longlong2(v[0], v[1]);
  }
};
template <> struct Vec16<float> {
  typedef float4 V;
  static __device__ __forceinline__ void get(const V& q, float* v) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ V put(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec16<int> {
  typedef int4 V;
  static __device__ __forceinline__ void get(const V& q, int* v) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ V put(const int* v) { return make_int4(v[0], v[1], v[2], v[3]); }
};

// A register's R values: one broadcast value, 16 bytes at a time (its
// chunks in the thread's swizzled order), or (a block under 16 bytes) one
// at a time.
template <class X>
__device__ __forceinline__ void gather(X (&v)[kR], Src a, const Tile& k) {
  constexpr int per = 16 / (int)sizeof(X);
  if (a.step == 0) {
    const X u = at<X>(a.off);
#pragma unroll
    for (int r = 0; r < kR; ++r) v[r] = u;
  } else if (k.R >= per) {
    const unsigned sw = swizzle_of<X>(k);
#pragma unroll
    for (int j = 0; j < kR / per; ++j)
      if (j * per < k.R)
        Vec16<X>::get(at<typename Vec16<X>::V>((a.off + 16 * j) ^ sw), v + j * per);
  } else {
#pragma unroll
    for (int r = 0; r < per; ++r) v[r] = r < k.R ? at<X>(a.off + r * sizeof(X)) : X(0);
  }
}

template <class X>
__device__ __forceinline__ void scatter(Src o, const X (&v)[kR], const Tile& k) {
  constexpr int per = 16 / (int)sizeof(X);
  if (o.step == 0) {
    at<X>(o.off) = v[0];
  } else if (k.R >= per) {
    const unsigned sw = swizzle_of<X>(k);
#pragma unroll
    for (int j = 0; j < kR / per; ++j)
      if (j * per < k.R)
        at<typename Vec16<X>::V>((o.off + 16 * j) ^ sw) = Vec16<X>::put(v + j * per);
  } else {
#pragma unroll
    for (int r = 0; r < per; ++r)
      if (r < k.R) at<X>(o.off + r * sizeof(X)) = v[r];
  }
}

// element r of a register (its block's chunks swizzled)
template <class X>
__device__ __forceinline__ unsigned elem(const Tile& k, Src a, int r) {
  return a.step ? (a.off + r * (unsigned)sizeof(X)) ^ swizzle_of<X>(k) : a.off;
}

// a conversion (from -> to): one row at a time, off the common path
template <class F, class X>
__device__ __forceinline__ void cvt_loop(const Tile& k, Src a, Src o, int n) {
#pragma unroll 1
  for (int r = 0; r < n; ++r) at<X>(elem<X>(k, o, r)) = Cvt<F, X>::go(at<F>(elem<F>(k, a, r)));
}

template <class X>
__device__ __forceinline__ void mask_loop(const Tile& k, unsigned m, Src o, int n) {
#pragma unroll 1
  for (int r = 0; r < n; ++r) at<X>(elem<X>(k, o, r)) = from_bit<X>((m >> r) & 1u);
}

template <class F>
__device__ __forceinline__ unsigned truth_loop(const Tile& k, Src s) {
  F v[kR];
  gather<F>(v, s, k);
  unsigned m = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) m |= (unsigned)truth(v[r]) << r;
  return m & k.full;
}

// Register `reg` (dtype `from`) converted into `o` over n rows: the
// switch picks one typed loop.
template <class X>
__device__ __forceinline__ void convert_into(const Tile& k, int reg, int from, Src o, int n) {
  switch (from) {
    case kDtBool: mask_loop<X>(k, mask_of(k, reg), o, n); return;
    case kDtI64: cvt_loop<long long, X>(k, src<long long>(k, reg), o, n); return;
    case kDtF64: cvt_loop<double, X>(k, src<double>(k, reg), o, n); return;
    case kDtI32: cvt_loop<int, X>(k, src<int>(k, reg), o, n); return;
    default: cvt_loop<float, X>(k, src<float>(k, reg), o, n); return;
  }
}

// Register `reg` (dtype `from`) read as X: itself when the dtypes agree,
// else converted into scratch slot `slot` (a thread's own uniform slot
// when the register is one value for every row).
template <class X>
__device__ __forceinline__ Src as(const Tile& k, int reg, int from, int slot) {
  if (from == DtOf<X>::v) return src<X>(k, reg);
  Src o;
  int n;
  if (invariant(k, reg)) {
    o = {k.usc + 8 * (slot * k.T + k.t), 0};
    n = 1;
  } else {
    o = {k.scratch + (slot * k.T + k.t) * k.b8, (unsigned)sizeof(X)};
    n = k.R;
  }
  convert_into<X>(k, reg, from, o, n);
  return o;
}

// Register `reg` (dtype `from`) as a condition: one bit a row.
__device__ __forceinline__ unsigned load_truth(const Tile& k, int reg, int from) {
  switch (from) {
    case kDtBool: return mask_of(k, reg);
    case kDtI64: return truth_loop<long long>(k, src<long long>(k, reg));
    case kDtF64: return truth_loop<double>(k, src<double>(k, reg));
    case kDtI32: return truth_loop<int>(k, src<int>(k, reg));
    default: return truth_loop<float>(k, src<float>(k, reg));
  }
}

// ------------------------------------------------------------ the ops
template <class X> struct Arith;
template <> struct Arith<double> {
  static __device__ __forceinline__ double go(int op, double l, double r) {
    return op == kOpAdd ? __dadd_rn(l, r) : op == kOpSub ? __dsub_rn(l, r) : __dmul_rn(l, r);
  }
};
template <> struct Arith<float> {
  static __device__ __forceinline__ float go(int op, float l, float r) {
    return op == kOpAdd ? __fadd_rn(l, r) : op == kOpSub ? __fsub_rn(l, r) : __fmul_rn(l, r);
  }
};
template <> struct Arith<long long> {  // wrapping
  static __device__ __forceinline__ long long go(int op, long long l, long long r) {
    const u64 x = (u64)l, y = (u64)r;
    return (long long)(op == kOpAdd ? x + y : op == kOpSub ? x - y : x * y);
  }
};
template <> struct Arith<int> {
  static __device__ __forceinline__ int go(int op, int l, int r) {
    const unsigned x = (unsigned)l, y = (unsigned)r;
    return (int)(op == kOpAdd ? x + y : op == kOpSub ? x - y : x * y);
  }
};

template <int Op, class X> struct ArithOp {
  static __device__ __forceinline__ X go(X l, X r) { return Arith<X>::go(Op, l, r); }
};

template <int Op, class X> struct Cmp {
  static __device__ __forceinline__ bool go(X l, X r) {
    return Op == kOpEq ? l == r : Op == kOpNe ? l != r : Op == kOpLt ? l < r
         : Op == kOpLe ? l <= r : Op == kOpGt ? l > r : l >= r;
  }
};

// integer / and % in the operand dtype's width: a zero divisor divides
// by 1 (the twin's guard), x / -1 negates wrapping, x % 0 and x % -1 are 0,
// % takes the divisor's sign
template <class X> struct IntDiv {
  typedef typename std::conditional<sizeof(X) == 8, u64, unsigned>::type U;
  static __device__ __forceinline__ X div(X l, X r) {
    return r == X(-1) ? (X)(U(0) - (U)l) : l / (r == X(0) ? X(1) : r);
  }
  static __device__ __forceinline__ X mod(X l, X r) {
    if (r == X(0) || r == X(-1)) return X(0);
    X m = l % r;
    if (m != X(0) && ((m < X(0)) != (r < X(0)))) m += r;
    return m;
  }
};
template <int Op, class X> struct IntOp {
  static __device__ __forceinline__ X go(X l, X r) {
    return Op == kOpDivInt ? IntDiv<X>::div(l, r) : IntDiv<X>::mod(l, r);
  }
};

// the float functions: the cheap ones inline, the libdevice calls out of
// line (stream1/stream2 run them a row at a time), one function an opcode
template <int Op> __device__ __noinline__ double f64_call(double x) {
  if constexpr (Op == kOpExp) return ::exp(x);
  else if constexpr (Op == kOpLn) return ::log(x);
  else if constexpr (Op == kOpLog10) return ::log10(x);
  else if constexpr (Op == kOpLog2) return ::log2(x);
  else if constexpr (Op == kOpSin) return ::sin(x);
  else if constexpr (Op == kOpCos) return ::cos(x);
  else return ::tan(x);
}
template <int Op> __device__ __noinline__ float f32_call(float x) {
  if constexpr (Op == kOpExp) return ::expf(x);
  else if constexpr (Op == kOpLn) return ::logf(x);
  else if constexpr (Op == kOpLog10) return ::log10f(x);
  else if constexpr (Op == kOpLog2) return ::log2f(x);
  else if constexpr (Op == kOpSin) return ::sinf(x);
  else if constexpr (Op == kOpCos) return ::cosf(x);
  else return ::tanf(x);
}
__device__ __noinline__ double f64_pow(double l, double r) { return ::pow(l, r); }
__device__ __noinline__ float f32_pow(float l, float r) { return ::powf(l, r); }
__device__ __noinline__ double f64_fmod(double l, double r) { return ::fmod(l, r); }
__device__ __noinline__ float f32_fmod(float l, float r) { return ::fmodf(l, r); }

template <int Op> __device__ __forceinline__ double unary(double x) {
  switch (Op) {
    case kOpAbs: return ::fabs(x);
    case kOpSqrt: return ::sqrt(x);
    case kOpCeil: return ::ceil(x);
    case kOpFloor: return ::floor(x);
    case kOpSignum: return (x != x || x == 0.0) ? x : (x > 0.0 ? 1.0 : -1.0);
    case kOpRound: return ::rint(x);  // half to even
    case kOpSquare: return __dmul_rn(x, x);
    case kOpNeg: return -x;
    default: return f64_call<Op>(x);
  }
}
template <int Op> __device__ __forceinline__ float unary(float x) {
  switch (Op) {
    case kOpAbs: return ::fabsf(x);
    case kOpSqrt: return ::sqrtf(x);
    case kOpCeil: return ::ceilf(x);
    case kOpFloor: return ::floorf(x);
    case kOpSignum: return (x != x || x == 0.0f) ? x : (x > 0.0f ? 1.0f : -1.0f);
    case kOpRound: return ::rintf(x);  // half to even
    case kOpSquare: return __fmul_rn(x, x);
    // torch's f32 negation is an arithmetic op: a NaN comes out as the
    // canonical one, where a sign flip would keep its payload
    case kOpNeg: return x != x ? __int_as_float(0x7fffffff) : -x;
    default: return f32_call<Op>(x);
  }
}
template <int Op> __device__ __forceinline__ long long unary(long long x) {  // kOpNeg, wrapping
  return (long long)(0ULL - (u64)x);
}
template <int Op> __device__ __forceinline__ int unary(int x) {
  return (int)(0u - (unsigned)x);
}
template <int Op, class X> struct UnaryOp {
  static __device__ __forceinline__ X go(X x) { return unary<Op>(x); }
};

template <int Op, class X> struct FloatOp;
template <int Op> struct FloatOp<Op, double> {
  static __device__ __forceinline__ double go(double l, double r) {
    if (Op == kOpDivF) return __ddiv_rn(l, r);
    if (Op == kOpPower) return f64_pow(l, r);
    double out = f64_fmod(l, r);
    if (out != 0.0 && ((r < 0.0) != (out < 0.0))) out = __dadd_rn(out, r);
    return out;
  }
};
template <int Op> struct FloatOp<Op, float> {
  static __device__ __forceinline__ float go(float l, float r) {
    if (Op == kOpDivF) return __fdiv_rn(l, r);
    if (Op == kOpPower) return f32_pow(l, r);
    float out = f32_fmod(l, r);
    if (out != 0.0f && ((r < 0.0f) != (out < 0.0f))) out = __fadd_rn(out, r);
    return out;
  }
};

// The error word of x² for the exact float32 pair x = hi + lo (kernel
// B12f, x32's variance family; its p word is kOpSquare of hi), in the
// order the reference's square_pair_closure compiles to: the Dekker
// error hi·hi - p as one FMA (NaN where the Veltkamp split hi·4097
// overflows, as there), then fma(2·hi, lo, e) + lo·lo.  Each step rounds
// as written: no contraction beyond the FMAs named.
struct SqPairLo {
  static __device__ __forceinline__ float go(float hi, float lo) {
    const float p = __fmul_rn(hi, hi);
    const float split = __fmul_rn(hi, 4097.0f);
    float e = isinf(split) ? __int_as_float(0x7fc00000) : __fmaf_rn(hi, hi, -p);
    e = __fmaf_rn(__fmul_rn(2.0f, hi), lo, e);
    return __fadd_rn(e, __fmul_rn(lo, lo));
  }
};

template <class Op, class X>
__device__ __forceinline__ void each(X (&a)[kR], const X (&b)[kR], int R) {
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (r < R) a[r] = Op::go(a[r], b[r]);
}

template <class Op, class X>
__device__ __forceinline__ void each(X (&a)[kR], int R) {
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (r < R) a[r] = Op::go(a[r]);
}

// The binary ops of X into register i (an X register): the operands
// loaded and the result stored by one body for every op of X, the op's
// own typed loop picked between them.
// An op that calls out of line (fmod, pow, the libdevice functions) over
// the R rows one at a time, from and to shared memory: no row's value is
// held in registers across a call.
template <class Op, class X>
__device__ __forceinline__ void stream2(const Tile& k, Src a, Src b, Src o) {
#pragma unroll 1
  for (int r = 0; r < k.R; ++r)
    at<X>(elem<X>(k, o, r)) = Op::go(at<X>(elem<X>(k, a, r)), at<X>(elem<X>(k, b, r)));
}
template <class Op, class X>
__device__ __forceinline__ void stream1(const Tile& k, Src a, Src o) {
#pragma unroll 1
  for (int r = 0; r < k.R; ++r) at<X>(elem<X>(k, o, r)) = Op::go(at<X>(elem<X>(k, a, r)));
}

template <class X>
__device__ __forceinline__ void binary_row(const Tile& k, int i, const ExprInstr& in, int op) {
  if constexpr (!std::is_integral<X>::value) {
    if (op == kOpModF || op == kOpPower) {
      const Src a = as<X>(k, in.a, (in.op >> 8) & 0xff, 0);
      const Src b = as<X>(k, in.b, (in.op >> 16) & 0xff, 1);
      if (op == kOpModF) {
        stream2<FloatOp<kOpModF, X>, X>(k, a, b, src<X>(k, i));
      } else {
        stream2<FloatOp<kOpPower, X>, X>(k, a, b, src<X>(k, i));
      }
      return;
    }
  }
  X a[kR], b[kR];
  gather<X>(a, as<X>(k, in.a, (in.op >> 8) & 0xff, 0), k);
  gather<X>(b, as<X>(k, in.b, (in.op >> 16) & 0xff, 1), k);
  switch (op) {
    case kOpAdd: each<ArithOp<kOpAdd, X>, X>(a, b, k.R); break;
    case kOpSub: each<ArithOp<kOpSub, X>, X>(a, b, k.R); break;
    case kOpMul: each<ArithOp<kOpMul, X>, X>(a, b, k.R); break;
    default:
      if constexpr (std::is_integral<X>::value) {
        if (op == kOpDivInt) {
          each<IntOp<kOpDivInt, X>, X>(a, b, k.R);
        } else {
          each<IntOp<kOpModInt, X>, X>(a, b, k.R);
        }
      } else {
        if (op == kOpDivF) {
          each<FloatOp<kOpDivF, X>, X>(a, b, k.R);
        } else if constexpr (sizeof(X) == 4) {  // kOpSqPairLo, float32 operands
          each<SqPairLo, X>(a, b, k.R);
        }
      }
      break;
  }
  scatter<X>(src<X>(k, i), a, k);
}

// The unary ops of X (negation; for a float, the functions and the square).
template <class X>
__device__ __forceinline__ void unary_row(const Tile& k, int i, const ExprInstr& in, int op) {
  const Src s = as<X>(k, in.a, (in.op >> 8) & 0xff, 0);
  if constexpr (!std::is_integral<X>::value) {
    switch (op) {
      case kOpExp: stream1<UnaryOp<kOpExp, X>, X>(k, s, src<X>(k, i)); return;
      case kOpLn: stream1<UnaryOp<kOpLn, X>, X>(k, s, src<X>(k, i)); return;
      case kOpLog10: stream1<UnaryOp<kOpLog10, X>, X>(k, s, src<X>(k, i)); return;
      case kOpLog2: stream1<UnaryOp<kOpLog2, X>, X>(k, s, src<X>(k, i)); return;
      case kOpSin: stream1<UnaryOp<kOpSin, X>, X>(k, s, src<X>(k, i)); return;
      case kOpCos: stream1<UnaryOp<kOpCos, X>, X>(k, s, src<X>(k, i)); return;
      case kOpTan: stream1<UnaryOp<kOpTan, X>, X>(k, s, src<X>(k, i)); return;
      default: break;
    }
  }
  X a[kR];
  gather<X>(a, s, k);
  if constexpr (std::is_integral<X>::value) {
    each<UnaryOp<kOpNeg, X>, X>(a, k.R);
  } else {
    switch (op) {
      case kOpNeg: each<UnaryOp<kOpNeg, X>, X>(a, k.R); break;
      case kOpAbs: each<UnaryOp<kOpAbs, X>, X>(a, k.R); break;
      case kOpSqrt: each<UnaryOp<kOpSqrt, X>, X>(a, k.R); break;
      case kOpCeil: each<UnaryOp<kOpCeil, X>, X>(a, k.R); break;
      case kOpFloor: each<UnaryOp<kOpFloor, X>, X>(a, k.R); break;
      case kOpSignum: each<UnaryOp<kOpSignum, X>, X>(a, k.R); break;
      case kOpRound: each<UnaryOp<kOpRound, X>, X>(a, k.R); break;
      default: each<UnaryOp<kOpSquare, X>, X>(a, k.R); break;
    }
  }
  scatter<X>(src<X>(k, i), a, k);
}

template <int Op, class X>
__device__ __forceinline__ unsigned cmp_bits(const X (&a)[kR], const X (&b)[kR]) {
  unsigned m = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) m |= (unsigned)Cmp<Op, X>::go(a[r], b[r]) << r;
  return m;
}

// The comparisons of X operands, one bit a row.
template <class X>
__device__ __forceinline__ unsigned compare_row(const Tile& k, const ExprInstr& in, int op) {
  X a[kR], b[kR];
  gather<X>(a, as<X>(k, in.a, (in.op >> 8) & 0xff, 0), k);
  gather<X>(b, as<X>(k, in.b, (in.op >> 16) & 0xff, 1), k);
  unsigned m;
  switch (op) {
    case kOpEq: m = cmp_bits<kOpEq, X>(a, b); break;
    case kOpNe: m = cmp_bits<kOpNe, X>(a, b); break;
    case kOpLt: m = cmp_bits<kOpLt, X>(a, b); break;
    case kOpLe: m = cmp_bits<kOpLe, X>(a, b); break;
    case kOpGt: m = cmp_bits<kOpGt, X>(a, b); break;
    default: m = cmp_bits<kOpGe, X>(a, b); break;
  }
  return m & k.full;
}

__device__ __forceinline__ unsigned compare_in(const Tile& k, const ExprInstr& in, int op) {
  if (in.in_dt == kDtBool) {  // 0 and 1 as integers
    const unsigned l = load_truth(k, in.a, (in.op >> 8) & 0xff);
    const unsigned r = load_truth(k, in.b, (in.op >> 16) & 0xff);
    const unsigned f = k.full;
    switch (op) {
      case kOpEq: return ~(l ^ r) & f;
      case kOpNe: return l ^ r;
      case kOpLt: return ~l & r & f;
      case kOpLe: return (~l | r) & f;
      case kOpGt: return l & ~r & f;
      default: return (l | ~r) & f;
    }
  }
  switch (in.in_dt) {
    case kDtI64: return compare_row<long long>(k, in, op);
    case kDtF64: return compare_row<double>(k, in, op);
    case kDtI32: return compare_row<int>(k, in, op);
    default: return compare_row<float>(k, in, op);
  }
}

// IN / NOT IN: the R rows in registers, then one pass over the table.
template <class X>
__device__ __forceinline__ unsigned in_list(const Tile& k, const ExprEvalParams& p,
                                            const ExprInstr& in) {
  X v[kR];
  gather<X>(v, as<X>(k, in.a, (in.op >> 8) & 0xff, 0), k);
  const long long* table = p.consts + in.b;
  unsigned m = 0;
  for (int j = 0; j < in.c; ++j) {
    const X w = lit_value<X>(__ldg(table + j));
#pragma unroll
    for (int r = 0; r < kR; ++r) m |= (unsigned)(v[r] == w) << r;
  }
  return m & k.full;
}

template <class X>
__device__ __forceinline__ void select(const Tile& k, int i, const ExprInstr& in,
                                       unsigned cond) {
  X tv[kR], ev[kR];
  gather<X>(tv, as<X>(k, in.b, (in.op >> 16) & 0xff, 0), k);
  gather<X>(ev, src<X>(k, in.c), k);
#pragma unroll
  for (int r = 0; r < kR; ++r) tv[r] = (cond >> r) & 1u ? tv[r] : ev[r];
  scatter<X>(src<X>(k, i), tv, k);
}

// float -> the result's integer dtype, saturating, NaN -> 0
struct CastI32 {
  static __device__ __forceinline__ int go(float x) {
    return x != x ? 0
         : x >= 2147483648.0f ? 0x7fffffff
         : x < -2147483648.0f ? (-0x7fffffff - 1) : __float2int_rz(x);
  }
};
struct CastI64 {
  static __device__ __forceinline__ long long go(double x) {
    return x != x ? 0LL
         : x >= 9223372036854775808.0 ? kI64Max
         : x < -9223372036854775808.0 ? kI64Min : __double2ll_rz(x);
  }
};
template <class Cast, class F, class X>
__device__ __forceinline__ void cast_int(const Tile& k, int i, const ExprInstr& in) {
  F a[kR];
  X v[kR];
  gather<F>(a, as<F>(k, in.a, (in.op >> 8) & 0xff, 0), k);
#pragma unroll
  for (int r = 0; r < kR; ++r) v[r] = Cast::go(a[r]);
  scatter<X>(src<X>(k, i), v, k);
}

// The typed loop of an op over one numeric dtype.
#define EXPR_BY_DT(DT, CALL)                       \
  switch (DT) {                                    \
    case kDtI64: { typedef long long X; CALL; } break; \
    case kDtF64: { typedef double X; CALL; } break;    \
    case kDtI32: { typedef int X; CALL; } break;       \
    default: { typedef float X; CALL; } break;         \
  }

// Register i (row i of the code) for the thread's R rows of this tile.
__device__ __forceinline__ void run_reg(const Tile& k, const ExprEvalParams& p, int i,
                                        const ExprInstr& in) {
  const int op = in.op & 0xff;
  const int da = (in.op >> 8) & 0xff, db = (in.op >> 16) & 0xff;
  const unsigned full = k.full;
  switch (op) {
    case kOpLeaf: {
      // a numeric leaf is its staged column; a bool one a mask of it
      set_valid(k, p, i, p.stage_off[in.b] >= 0 ? bytes_mask(k, p, in.b) : full);
      if (in.out_dt == kDtBool) {
        set_mask(k, i, in.a >= 0 ? bytes_mask(k, p, in.a) : 0u);
      } else if (in.a < 0) {  // no value column: 0
        at<u64>(desc_of(k, i) >> 4) = 0;
      }
      return;
    }
    case kOpLit:
    case kOpNull: {
      const long long imm = op == kOpLit ? in.imm : 0;
      if (in.out_dt == kDtBool) {
        set_mask(k, i, imm != 0 ? full : 0u);
      } else {
        // uniform: one slot, read as the register's width
        at<u64>(desc_of(k, i) >> 4) = in.out_dt == kDtF32 || in.out_dt == kDtI32
                                          ? (u64)(unsigned)(u64)imm : (u64)imm;
      }
      set_valid(k, p, i, op == kOpLit ? full : 0u);
      return;
    }
    case kOpConvert:
      if (in.out_dt == kDtBool) {
        set_mask(k, i, load_truth(k, in.a, da));
      } else {
        EXPR_BY_DT(in.out_dt, (convert_into<X>(k, in.a, da, src<X>(k, i), k.R)));
      }
      set_valid(k, p, i, valid_of(k, p, in.a));
      return;
    case kOpCastI64:
      if (in.out_dt == kDtI32) {
        cast_int<CastI32, float, int>(k, i, in);
      } else {
        cast_int<CastI64, double, long long>(k, i, in);
      }
      set_valid(k, p, i, valid_of(k, p, in.a));
      return;
    case kOpAnd:
    case kOpOr: {
      const unsigned l = load_truth(k, in.a, da) & valid_of(k, p, in.a);
      const unsigned r = load_truth(k, in.b, db) & valid_of(k, p, in.b);
      set_mask(k, i, op == kOpAnd ? l & r : l | r);
      set_valid(k, p, i, full);
      return;
    }
    case kOpNot:
      set_mask(k, i, ~(load_truth(k, in.a, da) & valid_of(k, p, in.a)) & full);
      set_valid(k, p, i, full);
      return;
    case kOpIsNull:
    case kOpIsNotNull: {
      const unsigned v = valid_of(k, p, in.a);
      set_mask(k, i, op == kOpIsNull ? ~v & full : v);
      set_valid(k, p, i, full);
      return;
    }
    case kOpEq:
    case kOpNe:
    case kOpLt:
    case kOpLe:
    case kOpGt:
    case kOpGe:
      set_mask(k, i, compare_in(k, in, op));
      break;
    case kOpAdd:
    case kOpSub:
    case kOpMul:
    case kOpDivInt:
    case kOpModInt:
    case kOpDivF:
    case kOpModF:
    case kOpPower:
    case kOpSqPairLo:
      if (in.in_dt == kDtBool) {  // torch: or, and
        const unsigned l = load_truth(k, in.a, da), r = load_truth(k, in.b, db);
        set_mask(k, i, op == kOpAdd ? l | r : l & r);
      } else {
        EXPR_BY_DT(in.in_dt, (binary_row<X>(k, i, in, op)));
      }
      break;
    case kOpIn:
    case kOpNotIn: {
      unsigned m;
      EXPR_BY_DT(in.in_dt, (m = in_list<X>(k, p, in)));
      set_mask(k, i, op == kOpIn ? m : ~m & full);
      set_valid(k, p, i, valid_of(k, p, in.a));
      return;
    }
    case kOpSelect: {
      const unsigned cond = load_truth(k, in.a, da) & valid_of(k, p, in.a);
      if (in.out_dt == kDtBool) {
        const unsigned tb = load_truth(k, in.b, db), eb = mask_of(k, in.c);
        set_mask(k, i, (cond & tb) | (~cond & eb));
      } else {
        EXPR_BY_DT(in.out_dt, (select<X>(k, i, in, cond)));
      }
      set_valid(k, p, i, (cond & valid_of(k, p, in.b)) | (~cond & valid_of(k, p, in.c)));
      return;
    }
    default:  // kOpNeg, the float functions, kOpSquare
      EXPR_BY_DT(in.in_dt, (unary_row<X>(k, i, in, op)));
      break;
  }
  // the ops that carry their operands' validity
  const bool two = op <= kOpModF || op == kOpPower || op == kOpSqPairLo;
  const unsigned va = valid_of(k, p, in.a);
  set_valid(k, p, i, two ? va & valid_of(k, p, in.b) : va);
}

// A bool output, R bits a thread: its R consecutive rows' bytes, four
// (or eight) in one store.
__device__ __forceinline__ void store_bits(const Tile& k, const ExprEvalParams& p,
                                           unsigned char* out, unsigned m) {
  const long long row = k.row0 + (long long)k.t * k.R;
  if (k.R >= 4 && row + k.R <= p.n) {
    if (k.R == 8) {
      *reinterpret_cast<uint2*>(out + row) = make_uint2(bytes_of(m & 0xfu), bytes_of(m >> 4));
    } else {
      *reinterpret_cast<unsigned*>(out + row) = bytes_of(m);
    }
    return;
  }
  for (int r = 0; r < k.R && row + r < p.n; ++r) out[row + r] = (m >> r) & 1u;
}

template <class F, class X>
__device__ __forceinline__ void store_converted(const Tile& k, const ExprEvalParams& p, Src a,
                                                X* out) {
  const long long row = k.row0 + (long long)k.t * k.R;
#pragma unroll 1
  for (int r = 0; r < k.R && row + r < p.n; ++r) out[row + r] = Cvt<F, X>::go(at<F>(elem<F>(k, a, r)));
}

template <class X>
__device__ __forceinline__ void store_values(const Tile& k, const ExprEvalParams& p, X* out,
                                             int reg, int from) {
  const long long row = k.row0 + (long long)k.t * k.R;
  const int chunks = k.R * (int)sizeof(X) / 16;
  const int lane = k.t & 31, wt = k.t - lane;
  const long long wrow = k.row0 + (long long)wt * k.R;  // the warp's first row
  if (from == DtOf<X>::v && (desc_of(k, reg) & 3) == kRegTile && chunks > 0 &&
      wrow + 32 * k.R <= p.n) {
    // the common case: the warp's 32 blocks are consecutive rows; each
    // lane copies every 32nd 16-byte chunk of them, so a store of the warp
    // is 512 consecutive bytes
    const unsigned base = (desc_of(k, reg) >> 4) + wt * block_of<X>(k);
    char* dst = reinterpret_cast<char*>(out + wrow);
    __syncwarp();
    for (int c = lane; c < 32 * chunks; c += 32) {
      const int owner = c / chunks, j = c - owner * chunks;
      const unsigned from_off = base + owner * block_of<X>(k) + ((16u * j) ^ swizzle(wt + owner, chunks));
      *reinterpret_cast<uint4*>(dst + 16 * c) = at<uint4>(from_off);
    }
    return;
  }
  if (from == DtOf<X>::v) {  // 16 bytes a store, the loads together
    constexpr int per = 16 / (int)sizeof(X);
    X v[kR];
    gather<X>(v, src<X>(k, reg), k);
    if (k.R >= per && row + k.R <= p.n) {
#pragma unroll
      for (int j = 0; j < kR / per; ++j)
        if (j * per < k.R)
          *reinterpret_cast<typename Vec16<X>::V*>(out + row + j * per) =
              Vec16<X>::put(v + j * per);
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (r < k.R && row + r < p.n) out[row + r] = v[r];
    }
    return;
  }
  switch (from) {
    case kDtBool: {
      const unsigned m = mask_of(k, reg);
#pragma unroll 1
      for (int r = 0; r < k.R && row + r < p.n; ++r) out[row + r] = from_bit<X>((m >> r) & 1u);
      return;
    }
    case kDtI64: store_converted<long long, X>(k, p, src<long long>(k, reg), out); return;
    case kDtF64: store_converted<double, X>(k, p, src<double>(k, reg), out); return;
    case kDtI32: store_converted<int, X>(k, p, src<int>(k, reg), out); return;
    default: store_converted<float, X>(k, p, src<float>(k, reg), out); return;
  }
}

// A store row: register a to output slot b, rows below n only.
__device__ __forceinline__ void run_store(const Tile& k, const ExprEvalParams& p,
                                          const ExprInstr& in) {
  void* out = p.out[in.b];
  if (out == nullptr) return;
  const int da = (in.op >> 8) & 0xff;
  if ((in.op & 0xff) == kOpStoreValid) {
    store_bits(k, p, static_cast<unsigned char*>(out), valid_of(k, p, in.a));
  } else if (in.out_dt == kDtBool) {
    store_bits(k, p, static_cast<unsigned char*>(out), load_truth(k, in.a, da));
  } else {
    EXPR_BY_DT(in.out_dt, (store_values<X>(k, p, static_cast<X*>(out), in.a, da)));
  }
}

__device__ __forceinline__ ExprInstr fetch(const ExprInstr* code, int i) {
  const int4* w = reinterpret_cast<const int4*>(code + i);
  const int4 x = __ldg(w), y = __ldg(w + 1);
  ExprInstr in;
  in.op = x.x;
  in.out_dt = x.y;
  in.in_dt = x.z;
  in.a = x.w;
  in.b = y.x;
  in.c = y.y;
  in.imm = (long long)(((u64)(unsigned)y.w << 32) | (unsigned)y.z);
  return in;
}

// Copy one tile's leaf columns into a staging buffer: 16-byte cp.async
// chunks of the rows in order, each into its thread's block (a block of
// 16 bytes or more is its own chunks; smaller ones pack the chunk as they
// come), the bytes past the last row zero-filled (src-size).
__device__ __forceinline__ void stage_tile(const ExprEvalParams& p, unsigned buf, long long row0,
                                           int T, int R, int t) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(expr_smem) + buf;
  for (int j = 0; j < p.n_staged; ++j) {
    const int slot = p.staged[j], w = p.width[slot];
    const char* src = static_cast<const char*>(p.in[slot]) + row0 * w;
    const unsigned dst = base + p.stage_off[slot];
    const int rw = R * w, block = expr_block_bytes(R, w), shift = __ffs(rw) - 1;
    const long long left = (p.n - row0) * w;
    const int chunks = T * rw / 16;
    for (int c = t; c < chunks && 16LL * c < left; c += T) {
      const long long rest = left - 16LL * c;
      const int bytes = rest >= 16 ? 16 : (int)rest;
      const unsigned b = 16u * c;  // the chunk's bytes in row order
      const unsigned owner = b >> shift;
      const unsigned to =
          rw >= 16 ? owner * block + ((b & (rw - 1)) ^ swizzle(owner, rw / 16)) : b;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst + to),
                   "l"(src + b), "r"(bytes)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// __grid_constant__: the pointer and offset tables are indexed at run
// time, read in place from the parameter bank instead of copied
__global__ void __launch_bounds__(kExprMaxThreads, 2)
    expr_eval_kernel(const __grid_constant__ ExprEvalParams p) {
  const int T = blockDim.x, t = threadIdx.x, R = p.rows, tr = T * R;
  const int b4 = expr_block_bytes(R, 4), b8 = expr_block_bytes(R, 8);
  // the regions of expr_eval.h:expr_smem_bytes, as byte offsets
  const unsigned desc = 0;
  const unsigned uni = desc + (unsigned)expr_align16(4 * (size_t)p.n_regs);
  const unsigned usc = uni + (unsigned)expr_align16(8 * (size_t)p.n_uniform);
  const unsigned vmask = usc + 16 * T;
  const unsigned bmask = vmask + (unsigned)expr_align16((size_t)T * p.n_regs);
  const unsigned scratch =
      (unsigned)expr_align128(bmask + expr_align16((size_t)T * p.n_mask));
  const unsigned wide = scratch + p.n_scratch * T * b8;
  const unsigned narrow = wide + p.n_wide * T * b8;
  const unsigned stage = narrow + p.n_narrow * T * b4;
  const unsigned stage_bytes = p.stage_bytes;

  const long long n_tiles = (p.n + tr - 1) / tr;
  const long long first = blockIdx.x;
  // the first tiles' copies go out before anything else
  for (int s = 0; s + 1 < p.stages; ++s) {
    const long long tl = first + (long long)s * gridDim.x;
    if (tl < n_tiles) {
      stage_tile(p, stage + s * stage_bytes, tl * tr, T, R, t);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  // each register's byte offset (a leaf's within a staging buffer)
  for (int i = t; i < p.n_regs; i += T) {
    const int w = __ldg(p.layout + i), idx = w >> 4;
    unsigned off;
    switch (w & 3) {
      case kRegTile: off = w & kRegWide ? wide + idx * T * b8 : narrow + idx * T * b4; break;
      case kRegUniform: off = uni + 8 * idx; break;
      case kRegLeaf: off = p.stage_off[idx]; break;
      default: off = bmask + idx * T; break;
    }
    at<unsigned>(desc + 4 * i) = off << 4 | (w & 15);
  }
  // every row of code into L1 at once: the rows are then read one by one
  for (int i = 4 * t; i < p.n_instr; i += 4 * T) {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p.code + i));
  }
  __syncthreads();

  Tile k{desc, vmask, usc, scratch, stage, 0, T, t, R, b4, b8, (1u << R) - 1u,
         swizzle(t, 2), swizzle(t, 4), p.valid_bits[0]};
  const int words = (p.n_instr + 31) / 32;
  // the first pass computes the registers whose value is the same on every
  // row, once; each later pass one tile (one call site of the row body)
  int buf = 0;
  for (long long tl = first - gridDim.x; tl < n_tiles; tl += gridDim.x) {
    const bool once = tl < first;
    if (!once) {
      // the copy a tile ahead (or, one buffer, this tile's own)
      const int ahead = p.stages - 1;
      const long long next = tl + (long long)ahead * gridDim.x;
      const int nbuf = (buf + ahead) % p.stages;
      if (next < n_tiles) {
        stage_tile(p, stage + nbuf * stage_bytes, next * tr, T, R, t);
      } else {
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      // this tile's copy has landed once at most `ahead` newer ones are pending
      switch (ahead) {
        case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
        case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
        case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
        default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
      }
      __syncthreads();
      k.stage = stage + buf * stage_bytes;
      k.row0 = tl * tr;
    }
    // the rows to run, a word of 32 at a time: the invariant ones once,
    // then a tile's rows less those it skips
    for (int w = 0; w < words; ++w) {
      const int left = p.n_instr - 32 * w;
      unsigned rows = left >= 32 ? ~0u : (1u << left) - 1u;
      rows &= once ? p.skip_bits[w] : ~p.skip_bits[w];
      while (rows) {
        const int i = 32 * w + __ffs(rows) - 1;
        rows &= rows - 1;
        if (once && (i >= p.n_regs || !invariant(k, i))) continue;
        const ExprInstr in = fetch(p.code, i);
        if (i < p.n_regs) {
          run_reg(k, p, i, in);
        } else {
          run_store(k, p, in);
        }
      }
    }
    __syncthreads();  // a tile's buffer is free for the copy after next
    if (!once) buf = (buf + 1) % p.stages;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

std::mutex g_attr_mutex;
std::set<int> g_attr_set;  // devices whose kernel has its shared-memory limit
std::mutex g_occ_mutex;
std::map<std::pair<int, size_t>, int> g_occ;  // (threads, smem) -> CTAs an SM

// The kernel's shared-memory limit, always the same, set once a device
// (task threads launch concurrently).
cudaError_t set_attributes() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_attr_mutex);
  if (g_attr_set.count(dev)) return cudaSuccess;
  err = cudaFuncSetAttribute(expr_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kExprSmemLimit);
  if (err == cudaSuccess) g_attr_set.insert(dev);
  return err;
}

// A device's SMs, asked once a device.
cudaError_t sm_count(int dev, int* sms) {
  static int counts[64];
  if (dev < 0 || dev >= 64) return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (counts[dev] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = counts[dev];
  return cudaSuccess;
}

// CTAs of this shape an SM holds at once (the runtime's occupancy, asked
// once a shape).
cudaError_t resident_ctas(const ExprPlan& pl, int* per_sm) {
  std::lock_guard<std::mutex> lock(g_occ_mutex);
  const auto key = std::make_pair(pl.threads, pl.smem);
  const auto it = g_occ.find(key);
  if (it != g_occ.end()) {
    *per_sm = it->second;
    return cudaSuccess;
  }
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, expr_eval_kernel, pl.threads, pl.smem);
  if (err == cudaSuccess) g_occ[key] = *per_sm;
  return err;
}

}  // namespace

extern "C" cudaError_t expr_eval_launch(const ExprEvalParams* params, cudaStream_t stream) {
  if (params->n <= 0 || params->n_instr <= 0) return cudaSuccess;
  ExprEvalParams p = *params;
  const ExprPlan pl = expr_plan(p.n, p.n_regs, p.n_uniform, p.n_mask, p.n_wide, p.n_narrow,
                                p.n_scratch, p.staged_w);
  if (p.n_instr > kExprMaxInstr || pl.smem > (size_t)kExprSmemLimit) {
    return cudaErrorInvalidValue;
  }
  p.rows = pl.rows;
  p.stages = pl.stages;
  // each staged slot's blocks, in slot order, within one staging buffer
  int off = 0;
  for (int j = 0; j < p.n_staged; ++j) {
    const int slot = p.staged[j];
    p.stage_off[slot] = off;
    off += pl.threads * expr_block_bytes(pl.rows, p.width[slot]);
  }
  p.stage_bytes = (int)expr_align128(off);
  // always the same limit, set once: task threads launch concurrently
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err == cudaSuccess) err = resident_ctas(pl, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tr = (long long)pl.threads * pl.rows;
  long long blocks = (p.n + tr - 1) / tr;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  expr_eval_kernel<<<(unsigned)blocks, pl.threads, pl.smem, stream>>>(p);
  return cudaGetLastError();
}

extern "C" cudaError_t expr_eval_describe(long long n, int n_regs, const int* counts,
                                          const int* staged_w, long long* out) {
  const ExprPlan pl = expr_plan(n, n_regs, counts[0], counts[1], counts[2], counts[3],
                                counts[4], staged_w);
  out[0] = pl.threads;
  out[1] = pl.rows;
  out[2] = pl.stages;
  out[3] = (long long)pl.smem;
  cudaFuncAttributes attr;
  cudaError_t err = set_attributes();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, expr_eval_kernel);
  if (err != cudaSuccess) return err;
  out[4] = attr.numRegs;
  out[5] = (long long)attr.localSizeBytes;
  int per_sm = 0;
  out[6] = 0;
  if (pl.smem <= (size_t)kExprSmemLimit) {
    err = resident_ctas(pl, &per_sm);
    out[6] = per_sm;
  }
  return err;
}
