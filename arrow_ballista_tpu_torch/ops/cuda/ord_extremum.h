// Launch interface of ord_extremum.cu, shared with its PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// What the operand words are (ops/kernels.py ORD_*).
enum OrdKind : int { ORD_PAIR = 0, ORD_F32 = 1, ORD_I32 = 2 };

constexpr int kOrdSmemGroups = 8192;  // groups a CTA keeps in shared memory

struct OrdParams {
  const int32_t* gid;    // [n]
  const bool* tail;      // [n] or null
  const bool* pred;      // [n] or null
  const bool* pvalid;    // [n] or null
  const bool* valid;     // [n] or null: the operand's validity
  const int32_t* hi;     // [n]: a pair's hi, or the f32 bits / i32 value
  const int32_t* lo;     // [n]: a pair's lo, or null
  int kind;
  int is_min;
  long long n;
  long long capacity;
  unsigned long long* keys;  // [capacity] scratch: each group's extremal key
  int32_t* out;              // [1 or 2, capacity]: the state words
};

extern "C" cudaError_t ord_extremum_launch(const OrdParams* params, cudaStream_t stream);
