// Device arithmetic of the x32 mode, shared by the x32 state merge
// (x32_merge.cu), the segmented scan's x32 folds and epilogue
// (seg_scan.cu) and the mesh reduce's x32 form (mesh_reduce.cu).
//
// Every f32 operation rounds once, as the reference's XLA ops do: adds and
// subtracts go through the __f*_rn intrinsics, which are never contracted
// into an FMA or reassociated, so 2Sum's error term stays exact.
#pragma once

#include <math.h>
#include <stdint.h>

#include "x32_merge.h"

namespace x32_ops {

__device__ __forceinline__ float as_f32(int32_t w) { return __int_as_float(w); }
__device__ __forceinline__ int32_t as_word(float v) { return __float_as_int(v); }

// Knuth 2Sum: s = fl(a + b) and its exact rounding error e.
__device__ __forceinline__ void two_sum(float a, float b, float* s, float* e) {
  const float t = __fadd_rn(a, b);
  const float bb = __fsub_rn(t, a);
  *e = __fadd_rn(__fsub_rn(a, __fsub_rn(t, bb)), __fsub_rn(b, bb));
  *s = t;
}

// jnp.minimum / jnp.maximum on f32: NaN propagates (the NaN operand
// itself), -0.0 orders below +0.0.
__device__ __forceinline__ float min_nan(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;
}

// An order pair (int32 words of split_u64_i32) as its unsigned join_u64:
// the unsigned order of the word is the pair's lexicographic order.
__device__ __forceinline__ unsigned long long ord_join(int32_t hi, int32_t lo) {
  return ((unsigned long long)((uint32_t)hi ^ 0x80000000u) << 32) |
         (unsigned long long)((uint32_t)lo ^ 0x80000000u);
}
__device__ __forceinline__ int32_t ord_hi(unsigned long long u) {
  return (int32_t)((uint32_t)(u >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int32_t ord_lo(unsigned long long u) {
  return (int32_t)((uint32_t)u ^ 0x80000000u);
}

// Merge new words into state row(s) f (and f + 1 for a pair) at column g,
// as ops/kernels.py:x32_merge_reference: a sum's (hi, lo) by 2Sum of the
// hi words, lo = acc_lo + new_lo + e; an order pair lexicographically; the
// rest by i32 add (wrapping) or f32/i32 min/max.  ``row(f)`` points at
// state row f.
__device__ __forceinline__ void merge_field(int op, int32_t* acc, int32_t* acc2,
                                            int32_t b, int32_t b2) {
  switch (op) {
    case XM_SUM_HI: {
      float s, e;
      two_sum(as_f32(*acc), as_f32(b), &s, &e);
      const float lo = __fadd_rn(__fadd_rn(as_f32(*acc2), as_f32(b2)), e);
      *acc = as_word(s);
      *acc2 = as_word(lo);
      return;
    }
    case XM_OMIN_HI:
    case XM_OMAX_HI: {
      const unsigned long long a = ord_join(*acc, *acc2), n = ord_join(b, b2);
      const bool take = op == XM_OMIN_HI ? n < a : n > a;
      if (take) {
        *acc = b;
        *acc2 = b2;
      }
      return;
    }
    case XM_ADD_I32:
      *acc = (int32_t)((uint32_t)*acc + (uint32_t)b);
      return;
    case XM_MIN_F32: *acc = as_word(min_nan(as_f32(*acc), as_f32(b))); return;
    case XM_MAX_F32: *acc = as_word(max_nan(as_f32(*acc), as_f32(b))); return;
    case XM_MIN_I32: *acc = b < *acc ? b : *acc; return;
    case XM_MAX_I32: *acc = b > *acc ? b : *acc; return;
    default: return;  // XM_SUM_LO, XM_PAIR_LO: merged with the row above
  }
}

// A pair op's second row is merged by the first.
__device__ __forceinline__ bool is_pair_head(int op) {
  return op == XM_SUM_HI || op == XM_OMIN_HI || op == XM_OMAX_HI;
}

}  // namespace x32_ops
