// Launch interface of segment_agg.cu, shared with its PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Per-field reduction codes (kernels.py OP_* must agree).
enum SegAggOp : int8_t {
  SA_COUNT = 0,  // + of the field's mask
  SA_ADD_F64 = 1,
  SA_ADD_I64 = 2,
  SA_MIN_F64 = 3,
  SA_MAX_F64 = 4,
  SA_MIN_I64 = 5,
  SA_MAX_I64 = 6,
};

constexpr int kSegAggMaxCols = 32;
constexpr int kSegAggMaxFields = 64;
constexpr int kSegAggWarps = 8;  // warps per CTA of the row pass

struct SegAggParams {
  const int32_t* gid;    // [n]
  const bool* tail;      // [n] or null (all rows live)
  const bool* pred;      // [n] or null (no filter)
  const bool* pvalid;    // [n] or null (predicate never null)
  const void* values[kSegAggMaxCols];  // [n] f64 or i64 words, or null
  const bool* valids[kSegAggMaxCols];  // [n] or null (all valid)
  int8_t ops[kSegAggMaxFields];
  int8_t cols[kSegAggMaxFields];       // column a field reads, -1: none
  int n_fields;
  int tile;                 // groups per shared-memory tile
  int n_chunks;             // row chunks of pass 1
  long long n;              // rows
  long long capacity;       // groups
  long long rows_per_chunk;
  long long* partial;       // [n_chunks, n_fields, capacity] scratch
  long long* state;         // [n_fields, capacity], merged in place
};

extern "C" int segment_agg_smem_bytes(int n_fields, int tile);
extern "C" cudaError_t segment_agg_launch(const SegAggParams* params,
                                          cudaStream_t stream);
