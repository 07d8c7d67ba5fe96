// Launch interface of df32_agg.cu, shared with its PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kDfMaxCols = 32;  // value columns, summed slots, counts, outputs
// Pass 1: one CTA sorts one run of rows by group in shared memory.
constexpr int kDfThreads = 512;                        // threads of a pass-1 CTA
constexpr int kDfWarps = kDfThreads / 32;              // its warps
constexpr int kDfRunRows = 1 << 14;                    // most rows a run holds: the matmul block
constexpr int kDfRowsPerThread = kDfRunRows / kDfThreads;  // a thread's rows of a full run
constexpr int kDfQuads = kDfRowsPerThread / 4;         // a thread's 4-row vector loads of a run
constexpr int kDfBatch = 4;                            // 4-row loads a thread keeps in flight
constexpr int kDfMaxTile = 8192;                       // most groups a CTA holds (one tile up to here)
constexpr int kDfMaxRankWarps = 16;                    // warps with their own bin counters in the rank
constexpr int kDfSmemMax = 232448;                     // dynamic shared memory a CTA may use (sm_90)
constexpr int kDfSmemSm = 233472;                      // shared memory of an SM (sm_90)
constexpr int kDfMaxDevices = 64;                      // devices whose smem attribute is cached
constexpr uint16_t kDfDead = 0xFFFF;                   // key and rank of a row outside the tile's live rows
// Pass 2: the 2Sum tree over the blocks, parallel over blocks and groups.
constexpr int kDfCombineThreads = 256;  // most threads of a pass-2 CTA
constexpr int kDfCombineFill = 264;     // pass-2 CTAs sought: two per SM of an H100
constexpr int kDfMaxLevels = 20;        // pass 2's register stack: at most 2^20 blocks
constexpr int kDfShortLevels = 6;       // its short stack, for chunks of at most 2^6 blocks

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
  // the plan (df32_agg_plan)
  long long runs_per_block;  // ceil(block / kDfRunRows)
  long long run_rows;        // rows per run (a block's last run may be shorter)
  int tile;                  // groups per pass-1 CTA
  int rank_warps;            // warps with bin counters in the stable rank
  int smem;                  // pass 1's dynamic shared memory, bytes
  int vec;                   // 1: every row array and run start allow 4-row vector loads
  int32_t* partial;     // [n_real * runs_per_block][n_slots + n_cnt][capacity] f32 bits / counts
  float* hi;            // [n_out][capacity]
  float* lo;            // [n_out][capacity]
  int32_t* cnt;         // [n_cnt][capacity]
};

// Fills the plan fields from block, capacity and the row arrays' pointers
// (set them first).
extern "C" void df32_agg_plan(Df32Params* params);
extern "C" cudaError_t df32_agg_launch(const Df32Params* params, cudaStream_t stream);
