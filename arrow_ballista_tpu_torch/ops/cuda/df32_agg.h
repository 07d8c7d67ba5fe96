// Launch interface of df32_agg.cu, shared with its PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kDfMaxCols = 32;   // value columns, summed slots, counts, outputs
constexpr int kDfWarps = 8;      // warps per CTA of pass 1
constexpr int kDfSmemBudget = 96 << 10;  // pass 1's per-warp partials

struct Df32Params {
  const int32_t* gid;   // [n]
  const bool* tail;     // [n] or null (all rows live)
  const bool* pred;     // [n] or null (no filter)
  const bool* pvalid;   // [n] or null
  const float* values[kDfMaxCols];  // [n] f32, or null (a validity-only column)
  const bool* valids[kDfMaxCols];   // [n] or null (all valid)
  int n_slots;                      // summed columns
  int8_t slot_col[kDfMaxCols];      // the value column of each slot
  int n_cnt;                        // exact counts
  int8_t cnt_col[kDfMaxCols];       // the validity column of each, -1: the row mask
  int n_out;                        // sum outputs
  int8_t out_a[kDfMaxCols];         // slot of each output
  int8_t out_b[kDfMaxCols];         // second slot (an int64 pair's lo half), or -1
  long long n;
  long long capacity;
  long long block;      // rows per block
  long long nb;         // pow2 block count of the pair tree
  long long n_real;     // blocks holding rows (ceil(n / block))
  int tile;             // groups per tile of pass 1
  int32_t* partial;     // [n_real][n_slots + n_cnt][capacity] f32 bits / counts
  float* hi;            // [n_out][capacity]
  float* lo;            // [n_out][capacity]
  int32_t* cnt;         // [n_cnt][capacity]
};

extern "C" int df32_agg_tile(int n_cols, long long capacity);
extern "C" cudaError_t df32_agg_launch(const Df32Params* params, cudaStream_t stream);
