// Launch interface of join_probe.cu, shared with the PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kJoinMaxCols = 32;  // build columns one probe gathers

struct JoinBuildParams {
  long long m;             // build rows (unique keys)
  const void* bkeys;       // [m] build keys
  int key_bytes;           // 8: int64 keys; 4: x32's int32 keys
  long long kmin;          // the smallest build key
  long long span;          // table slots
  int32_t* table;          // [span] row + 1 at slot key - kmin, else 0
};

struct JoinProbeParams {
  long long n;                // probe rows
  const void* pkey;           // [n] probe join key
  int key_bytes;              // 8: int64 keys; 4: x32's int32 (pkey and bkeys)
  const uint8_t* pkey_valid;  // [n] or null: every key valid
  const uint8_t* valid;       // [n] incoming row mask, or null: every row
  const int32_t* table;       // dense form: [span] slot table, else null
  long long span;
  long long kmin;
  const void* bkeys;       // sorted form: [m] sorted unique build keys
  long long m;
  int n_cols;                               // build columns to gather
  const void* bvals[kJoinMaxCols];          // [rows] each column's values
  int val_bytes[kJoinMaxCols];              // 8 (f64, i64), 4 (x32's f32, i32) or 1 (bool)
  const uint8_t* bvalids[kJoinMaxCols];     // [rows] or null: all valid
  void* out_vals[kJoinMaxCols];             // [n] gathered values
  uint8_t* out_valids[kJoinMaxCols];        // [n] gathered validity & match
  uint8_t* mask;                            // [n] valid & match
};

extern "C" cudaError_t join_build_table_launch(const JoinBuildParams* params,
                                               cudaStream_t stream);
extern "C" cudaError_t join_probe_launch(const JoinProbeParams* params,
                                         cudaStream_t stream);
