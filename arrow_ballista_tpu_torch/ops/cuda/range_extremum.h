// Launch interface of range_extremum.cu, shared with the PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct RangeExtremumParams {
  long long n;
  int op;       // SA_MIN_F64, SA_MAX_F64, SA_MIN_I64 or SA_MAX_I64
  int depth;    // levels above level 0
  const int32_t* perm;     // [n] sorted row -> input row
  const void* values;      // [n] input order: f64 or i64 words (8 bytes),
                           // or x32's f32 or int32 words (4 bytes)
  int value_bytes;
  const bool* valid;       // [n] input order, or null
  int in_i64;              // integer values under an f64 op: convert
  // the frame [i + start, i + end] clipped to the row's segment
  // [seg_first, seg_last]; an unbounded side takes the segment's edge
  const long long* seg_first;  // [n] sorted order
  const long long* seg_last;   // [n]
  int has_start, has_end;
  long long start, end;
  long long* table;  // [depth + 1][n] scratch
  long long* out;    // [n] sorted order; empty frames hold the identity
};

extern "C" cudaError_t range_extremum_launch(const RangeExtremumParams* params,
                                             cudaStream_t stream);
