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

// The fold's identity; sums and counts start at 0 (+0.0 is the zero word).
__device__ __forceinline__ long long identity(int op) {
  switch (op) {
    case SA_MIN_F64: return 0x7ff0000000000000LL;              // +inf
    case SA_MAX_F64: return (long long)0xfff0000000000000ULL;  // -inf
    case SA_MIN_I64: return LLONG_MAX;
    case SA_MAX_I64: return LLONG_MIN;
    default: return 0;
  }
}

__device__ __forceinline__ long long combine(int op, long long a, long long b) {
  switch (op) {
    case SA_ADD_F64: return as_word(as_f64(a) + as_f64(b));
    case SA_MIN_F64: return as_word(min_nan(as_f64(a), as_f64(b)));
    case SA_MAX_F64: return as_word(max_nan(as_f64(a), as_f64(b)));
    case SA_MIN_I64: return a < b ? a : b;
    case SA_MAX_I64: return a > b ? a : b;
    default:  // SA_COUNT, SA_ADD_I64: two's-complement wrap, like int64 +
      return (long long)((unsigned long long)a + (unsigned long long)b);
  }
}

}  // namespace agg_ops
