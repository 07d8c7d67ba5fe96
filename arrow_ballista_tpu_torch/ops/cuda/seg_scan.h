// Launch interface of seg_scan.cu, shared with the PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_agg.h"

constexpr int kScanMaxCols = 32;
constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;  // consecutive scan positions per thread
constexpr int kScanTile = kScanThreads * kScanItems;

// Where a column's element at sorted row r comes from.
enum ScanSrc : int8_t {
  SS_VALUES = 0,  // values[perm[r]] (0 for a sum, the identity otherwise,
                  // where valid[perm[r]] is false)
  SS_COUNT = 1,   // valid[perm[r]] as 0/1, or 1 without a validity
  SS_IOTA = 2,    // r itself
  SS_AUX = 3,     // aux[r] as 0/1
};

struct SegScanParams {
  long long n;
  const int32_t* perm;  // [n] gather of values/valid, or null (identity)
  // segment starts: flag[r] (window), or a change of key[perm[r]] (sorted
  // aggregate); row 0 always starts one
  const uint8_t* flag;
  const int32_t* key;
  const uint8_t* aux;   // [n] SS_AUX source
  int reverse;          // scan from the last row to the first
  int n_cols;
  const void* values[kScanMaxCols];  // [n] f64 or i64 words
  const bool* valid[kScanMaxCols];   // [n] or null (all valid)
  int8_t src[kScanMaxCols];
  int8_t op[kScanMaxCols];           // SA_ADD_F64 .. SA_MAX_I64
  int8_t in_i64[kScanMaxCols];       // i64 values under an f64 op: convert
  long long* out[kScanMaxCols];      // [n] scanned words, or null
  // sorted-aggregate epilogue (state != null): at each segment's last row
  // with key < capacity, field f merges its column's total into
  // state[f][key] with op field_op[f]
  long long* state;
  long long capacity;
  int n_fields;
  int8_t field_col[kSegAggMaxFields];
  int8_t field_op[kSegAggMaxFields];
  // scratch
  long long n_blocks;
  long long* block_agg;    // [n_blocks][n_cols]
  long long* block_carry;  // [n_blocks][n_cols]
  uint8_t* block_start;    // [n_blocks]
};

extern "C" long long seg_scan_blocks(long long n);
extern "C" cudaError_t seg_scan_launch(const SegScanParams* params,
                                       cudaStream_t stream);
