// Launch interface of the keyed single-dispatch runner's kernels
// (keyed_fold.cu), shared with the PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed.h"

constexpr int kFoldMaxEntries = 32;  // stage_compiler.py: _FUSED_MAX_ENTRIES

// One pending batch: its rows land at [offset, offset + n) of the
// concatenated operands.
struct KeyedEntry {
  long long offset;
  long long n;
  const uint8_t* masks[3];              // row masks ANDed together, or null
  const void* values[kKeyedMaxKeys];    // [n] raw key values or host codes
  const uint8_t* valid[kKeyedMaxKeys];  // [n] or null (all valid)
  int8_t in_type[kKeyedMaxKeys];        // KeyIn
};

struct KeyedEncodeEntriesParams {
  long long total;  // rows of all entries
  int n_entries;
  const KeyedEntry* entries;  // [n_entries] in device memory, in row order
  int n_keys;
  int8_t kind[kKeyedMaxKeys];  // KeyKind (KK_CODE: a host code)
  int32_t* inv;                // [total] 1 where a mask drops the row, else 0
  // With `fold`, comb[r] = sum over keys of (word_k - fold_min[k]) <<
  // fold_shift[k], a non-negative int32; else out[k][r] = word_k.
  int fold;
  long long fold_min[kKeyedMaxKeys];
  int fold_shift[kKeyedMaxKeys];
  int32_t* comb;              // [total], or null
  void* out[kKeyedMaxKeys];   // [total] per-key codes, or null
  int out_bytes;  // the code width, folded or not: 8 int64 codes; 4 x32's int32 words
};

struct KeyedUnfoldParams {
  long long capacity;
  long long n_groups;
  const int32_t* sk;      // [n] the folded words in sorted order
  const int32_t* starts;  // [n + 1] each group's first sorted row
  int n_keys;
  long long fold_min[kKeyedMaxKeys];
  int fold_shift[kKeyedMaxKeys];
  int fold_width[kKeyedMaxKeys];
  void* out;      // [n_keys][capacity]
  int out_bytes;  // 8: int64 words; 4: x32's int32 words
};

extern "C" cudaError_t keyed_encode_entries_launch(const KeyedEncodeEntriesParams* p,
                                                   cudaStream_t s);
extern "C" cudaError_t keyed_unfold_launch(const KeyedUnfoldParams* p, cudaStream_t s);
