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
  // the segmented scan's x32 folds (x32's sort route), over 64-bit words
  SA_DF32 = 7,      // an f32 (hi, lo) pair, hi in the low word
  SA_UMIN_U64 = 8,  // unsigned min of a joined order pair
  SA_UMAX_U64 = 9,
};

constexpr int kSegAggMaxCols = 32;
constexpr int kSegAggMaxFields = 64;
// Pass 1: one CTA sorts one run of rows by group in shared memory.
constexpr int kSegAggThreads = 512;                     // threads of a pass-1 CTA
constexpr int kSegAggWarps = kSegAggThreads / 32;       // its warps
constexpr int kSegAggRunRows = 8192;                    // rows of a run (one sort)
constexpr int kSegAggQuads = kSegAggRunRows / 4 / kSegAggThreads;  // a thread's 4-row loads a run
constexpr int kSegAggMaxTile = 8192;                    // most groups a CTA holds
constexpr int kSegAggSmemMax = 140 << 10;               // dynamic shared memory a CTA takes
constexpr int kSegAggAccWords = 1024;                   // most words of a chunk's partial kept in shared memory
constexpr int kSegAggChunksPerSm = 1;                   // the chunk rule: at most one chunk an SM
constexpr int kSegAggMaxDevices = 64;                   // devices whose smem attribute is cached
constexpr uint16_t kSegAggDead = 0xFFFF;                // key and rank of a row outside the tile's live rows
constexpr long long kSegAggScratchBudget = 256LL << 20;  // chunk partials in device memory

struct SegAggParams {
  const int32_t* gid;    // [n]
  const bool* tail;      // [n] or null (all rows live)
  const bool* pred;      // [n] or null (no filter)
  const bool* pvalid;    // [n] or null (predicate never null)
  const void* values[kSegAggMaxCols];  // [n] f64 or i64 words, or null
  const bool* valids[kSegAggMaxCols];  // [n] or null (all valid)
  int8_t ops[kSegAggMaxFields];         // each state field's op
  int8_t field_fold[kSegAggMaxFields];  // the distinct fold each field takes
  int8_t fold_ops[kSegAggMaxFields];    // each fold's op
  int8_t fold_cols[kSegAggMaxFields];   // its column: a count's validity, -1 the row mask
  int8_t fold_fields[kSegAggMaxFields]; // the fields by fold: fold k's are
  int8_t fold_first[kSegAggMaxFields + 1];  // fold_fields[fold_first[k], fold_first[k + 1])
  int n_fields;
  int n_folds;
  // the plan (segment_agg_plan)
  int tile;                 // groups of a pass-1 CTA (min(capacity, kSegAggMaxTile))
  int rank_warps;           // warps with their own bin counters in the rank
  int smem;                 // pass 1's dynamic shared memory, bytes
  int vec;                  // 1: the row arrays allow 16-byte loads
  int n_chunks;             // row chunks of pass 1 (one CTA a chunk and tile)
  int direct;               // 1: one run, folded into the state by pass 1 alone
  long long n;              // rows
  long long capacity;       // groups
  long long rows_per_chunk; // whole runs
  long long* partial;       // [n_chunks, n_folds, capacity] scratch (null when direct)
  long long* state;         // [n_fields, capacity], merged in place
};

// Fills the plan fields from n, capacity, n_folds, the row arrays'
// pointers and the card's SM count (set them first).
extern "C" void segment_agg_plan(SegAggParams* params, int sms);
extern "C" cudaError_t segment_agg_launch(const SegAggParams* params,
                                          cudaStream_t stream);
