// Device folds shared by the port's aggregate, scan and range kernels.
//
// Every value travels as a 64-bit word: int64 as itself, float64 as its
// bits.  Min/max follow jnp.minimum/jnp.maximum: NaN propagates and -0.0
// orders below +0.0 whatever the operand order (CUDA's fmin/fmax drop the
// NaN instead).
#pragma once

#include <limits.h>
#include <math.h>

#include "segment_agg.h"
#include "x32_ops.cuh"

namespace agg_ops {

__device__ __forceinline__ double as_f64(long long w) {
  return __longlong_as_double(w);
}
__device__ __forceinline__ long long as_word(double v) {
  return __double_as_longlong(v);
}

__device__ __forceinline__ double min_nan(double a, double b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;  // equal: -0.0 wins
}

__device__ __forceinline__ double max_nan(double a, double b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;  // equal: +0.0 wins
}

__device__ __forceinline__ bool is_f64_op(int op) {
  return op == SA_ADD_F64 || op == SA_MIN_F64 || op == SA_MAX_F64;
}

// The fold's identity; sums and counts start at 0 (+0.0 is the zero word,
// (0, 0) the zero pair).
__device__ __forceinline__ long long identity(int op) {
  switch (op) {
    case SA_MIN_F64: return 0x7ff0000000000000LL;              // +inf
    case SA_MAX_F64: return (long long)0xfff0000000000000ULL;  // -inf
    case SA_MIN_I64: return LLONG_MAX;
    case SA_MAX_I64: return LLONG_MIN;
    case SA_UMIN_U64: return -1LL;  // the largest unsigned word
    default: return 0;
  }
}

// An f32 (hi, lo) pair as one word, hi in the low half.
__device__ __forceinline__ long long df32_word(float hi, float lo) {
  return (long long)(((unsigned long long)(unsigned)__float_as_int(lo) << 32) |
                     (unsigned long long)(unsigned)__float_as_int(hi));
}
__device__ __forceinline__ float df32_hi(long long w) { return __int_as_float((int)w); }
__device__ __forceinline__ float df32_lo(long long w) { return __int_as_float((int)(w >> 32)); }

// The reference's _scan_segments df32 combine: s, e = 2Sum(a_hi, b_hi),
// then 2Sum(s, a_lo + b_lo + e).
__device__ __forceinline__ long long df32_combine(long long a, long long b) {
  float s, e, hi, lo;
  x32_ops::two_sum(df32_hi(a), df32_hi(b), &s, &e);
  x32_ops::two_sum(s, __fadd_rn(__fadd_rn(df32_lo(a), df32_lo(b)), e), &hi, &lo);
  return df32_word(hi, lo);
}

__device__ __forceinline__ long long combine(int op, long long a, long long b) {
  switch (op) {
    case SA_DF32: return df32_combine(a, b);
    case SA_UMIN_U64:
      return (unsigned long long)a < (unsigned long long)b ? a : b;
    case SA_UMAX_U64:
      return (unsigned long long)a > (unsigned long long)b ? a : b;
    case SA_ADD_F64: return as_word(as_f64(a) + as_f64(b));
    case SA_MIN_F64: return as_word(min_nan(as_f64(a), as_f64(b)));
    case SA_MAX_F64: return as_word(max_nan(as_f64(a), as_f64(b)));
    case SA_MIN_I64: return a < b ? a : b;
    case SA_MAX_I64: return a > b ? a : b;
    default:  // SA_COUNT, SA_ADD_I64: two's-complement wrap, like int64 +
      return (long long)((unsigned long long)a + (unsigned long long)b);
  }
}

// The same folds with the op fixed at compile time (no switch in a loop).
// An f64 sum that is NaN is the one quiet NaN word: which operand's NaN an
// add returns depends on the operand order the compiler picks, so the
// segment aggregate's folds (segment_agg.cuh) would otherwise give NaN
// words that differ between paths that add the same values in the same
// order.  ``raw_of`` adds without that step, for a run of adds whose end
// goes through ``canon_of``: whether a sum is NaN does not depend on the
// order, so the canonical word is the same.
constexpr long long kQuietNan = 0x7ff8000000000000LL;

template <int kOp>
__device__ __forceinline__ long long identity_of() {
  if constexpr (kOp == SA_MIN_F64) return 0x7ff0000000000000LL;
  if constexpr (kOp == SA_MAX_F64) return (long long)0xfff0000000000000ULL;
  if constexpr (kOp == SA_MIN_I64) return LLONG_MAX;
  if constexpr (kOp == SA_MAX_I64) return LLONG_MIN;
  return 0;
}

template <int kOp>
__device__ __forceinline__ long long canon_of(long long a) {
  if constexpr (kOp == SA_ADD_F64) return isnan(as_f64(a)) ? kQuietNan : a;
  return a;
}

template <int kOp>
__device__ __forceinline__ long long combine_of(long long a, long long b);

template <int kOp>
__device__ __forceinline__ long long raw_of(long long a, long long b) {
  if constexpr (kOp == SA_ADD_F64) return as_word(as_f64(a) + as_f64(b));
  return combine_of<kOp>(a, b);
}

template <int kOp>
__device__ __forceinline__ long long combine_of(long long a, long long b) {
  if constexpr (kOp == SA_ADD_F64) {
    const double r = as_f64(a) + as_f64(b);
    return isnan(r) ? kQuietNan : as_word(r);
  }
  if constexpr (kOp == SA_MIN_F64) return as_word(min_nan(as_f64(a), as_f64(b)));
  if constexpr (kOp == SA_MAX_F64) return as_word(max_nan(as_f64(a), as_f64(b)));
  if constexpr (kOp == SA_MIN_I64) return a < b ? a : b;
  if constexpr (kOp == SA_MAX_I64) return a > b ? a : b;
  // SA_COUNT, SA_ADD_I64: two's-complement wrap
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

}  // namespace agg_ops
