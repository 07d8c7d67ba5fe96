// Launch interface of x32_merge.cu, shared with the PyTorch binding and
// the other x32 kernels; mirrored by ops/kernels.py (XM_*).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_agg.h"

// Per state row: how an x32 state merges it.
enum X32Op : int8_t {
  XM_SUM_HI = 0,   // a (hi, lo) f32 pair: this row and the next, by 2Sum
  XM_SUM_LO = 1,   // the pair's lo word (merged with the row above)
  XM_ADD_I32 = 2,  // counts and presence
  XM_MIN_F32 = 3,
  XM_MAX_F32 = 4,
  XM_MIN_I32 = 5,
  XM_MAX_I32 = 6,
  XM_OMIN_HI = 7,  // an order pair: this row (hi) and the next (lo)
  XM_OMAX_HI = 8,
  XM_PAIR_LO = 9,  // the order pair's lo word
};

struct X32MergeParams {
  int32_t* state;                          // [n_fields, capacity], in place
  const int32_t* rows[kSegAggMaxFields];   // each [capacity]: the new words
  int8_t ops[kSegAggMaxFields];
  int n_fields;
  long long capacity;
};

extern "C" cudaError_t x32_merge_launch(const X32MergeParams* params,
                                        cudaStream_t stream);
