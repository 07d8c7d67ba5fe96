// Launch interface of seg_scan.cu, shared with the PyTorch binding and
// mirrored by ops/kernels.py (SS_*, SW_*, SCAN_*, scan_launch_plan).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "segment_agg.h"

constexpr int kScanMaxCols = 32;
constexpr int kScanThreads = 256;   // a CTA: 8 warps
constexpr int kScanMaxRows = 8;     // R: consecutive scan positions a thread
constexpr int kScanPlanSms = 132;   // the H100's SMs, for the small-call rule
constexpr int kScanSmemBudget = 65536;       // a CTA's shared bytes: three an SM, with
                                             // room left for L1 (the gathers of perm)
constexpr int kScanSmemBudgetWide = 115712;  // two an SM, for R >= 4 over more columns
constexpr int kScanFixedBytes = 5120;    // ScanShared (warp totals, carries)
constexpr unsigned kScanTagMax = 1u << 30;  // call tags: status words hold 30 bits
constexpr int kScanHeaderWords = 64;      // the ticket and the CTAs done (256 bytes)

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
  int8_t op[kScanMaxCols];           // SA_ADD_F64 .. SA_MAX_I64, SA_DF32 .. SA_UMAX_U64
  int8_t in_i64[kScanMaxCols];       // i64 values under an f64 op: convert
  const void* values2[kScanMaxCols]; // [n] a pair's second half, or null
  int8_t width[kScanMaxCols];        // ScanWidth
  long long* out[kScanMaxCols];      // [n] scanned words, or null
  // sorted-aggregate epilogue (state != null, forward only): at each
  // segment's last row with key < capacity, field f merges its column's
  // total into state[f][key] with op field_op[f]
  long long* state;
  // x32 epilogue (state32 != null): field f merges its column's total into
  // the int32 state32[f][key] with the x32 merge field_op[f] (X32Op)
  int32_t* state32;
  long long capacity;
  int n_fields;
  int8_t field_col[kSegAggMaxFields];
  int8_t field_op[kSegAggMaxFields];
  // the look-back's words, kept by the caller across calls on one stream
  // (the binding): words of an earlier call carry another tag, so only a
  // new or regrown buffer is cleared
  unsigned* words;            // [kScanHeaderWords + status_cap]: the ticket,
                              // the CTAs done, then a status word a tile
  long long status_cap;       // status words the buffer holds
  long long* values_scratch;  // [value_cap]: each tile's total and
                              // inclusive prefix, a column's word as two
                              // tagged halves
  long long value_cap;
  unsigned tag;  // this call's tag, 1 .. kScanTagMax - 1
  int fresh;     // 1: the buffer is new (one memset clears all of it first)
};

// The tile rule: a CTA of kScanThreads threads scans T = threads x rows
// consecutive positions, with every column's element of the tile staged in
// shared memory.  R (rows) is the largest of 8, 4, 2, 1 whose tile leaves
// room for three CTAs an SM (kScanSmemBudget); where that R is below 4, the
// largest that leaves room for two (kScanSmemBudgetWide).  A call of fewer
// tiles than two an SM halves R.
struct ScanPlan {
  int threads;
  int rows;
  int tile;  // threads x rows
  int smem;  // dynamic shared bytes
};

// Padded words of one column's staged tile: one spare word every 16, so
// that a thread's R consecutive words fall in distinct banks.
__host__ __device__ inline int scan_padded(int tile) { return tile + tile / 16; }

__host__ __device__ inline int scan_align16(int x) { return (x + 15) & ~15; }

// Shared bytes of a tile of ``rows`` a thread over ``n_cols`` columns: the
// fixed part, each column's padded 8-byte words, perm (4 B a position), the
// sorted keys with one neighbour each side (4 B) and the start flags (1 B).
__host__ __device__ inline int scan_smem_bytes(int rows, int n_cols) {
  const int t = kScanThreads * rows;
  return kScanFixedBytes + n_cols * 8 * scan_padded(t) + 4 * t + 4 * (t + 2) +
         scan_align16(t);
}

inline ScanPlan scan_plan(long long n, int n_cols) {
  int rows = kScanMaxRows;
  while (rows > 1 && scan_smem_bytes(rows, n_cols) > kScanSmemBudget) rows /= 2;
  if (rows < 4) {
    rows = kScanMaxRows;
    while (rows > 1 && scan_smem_bytes(rows, n_cols) > kScanSmemBudgetWide) rows /= 2;
  }
  auto tiles = [&]() {
    const long long t = (long long)kScanThreads * rows;
    return (n + t - 1) / t;
  };
  while (rows > 1 && tiles() < 2 * kScanPlanSms) rows /= 2;
  return ScanPlan{kScanThreads, rows, kScanThreads * rows, scan_smem_bytes(rows, n_cols)};
}

// Tiles of a call (scan_plan): the status words and 4 x n_cols value
// words a tile it needs of the scratch.
extern "C" long long seg_scan_tiles(long long n, int n_cols);
extern "C" cudaError_t seg_scan_launch(const SegScanParams* params,
                                       cudaStream_t stream);
// What a launch over ``n`` rows of ``n_cols`` columns runs with: out =
// {threads, rows a thread, tile, shared bytes (scan_plan), the kernel's
// registers a thread, its local bytes a thread, CTAs an SM, grid} on the
// current device.
extern "C" cudaError_t seg_scan_describe(long long n, int n_cols, long long* out);
