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

// How a SS_VALUES column's words are read (x32's sort route reads 32-bit
// columns; ops/kernels.py SW_*).
enum ScanWidth : int8_t {
  SW_WORD = 0,      // 8-byte f64 / i64 words
  SW_F32 = 1,       // f32: widened to f64 (an f64 fold) or the pair (v, 0)
  SW_I32 = 2,       // i32: sign-extended
  SW_F32_PAIR = 3,  // f32 values and values2: the 2Sum of the two halves
  SW_ORD_PAIR = 4,  // i32 order pair (values, values2): join_u64
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
  const void* values2[kScanMaxCols]; // [n] a pair's second half, or null
  int8_t width[kScanMaxCols];        // ScanWidth
  long long* out[kScanMaxCols];      // [n] scanned words, or null
  // sorted-aggregate epilogue (state != null): at each segment's last row
  // with key < capacity, field f merges its column's total into
  // state[f][key] with op field_op[f]
  long long* state;
  // x32 epilogue (state32 != null): field f merges its column's total into
  // the int32 state32[f][key] with the x32 merge field_op[f] (X32Op)
  int32_t* state32;
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
