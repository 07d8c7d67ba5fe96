// Launch interface of radix_sort.cu, shared with the PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kRadixMaxKeys = 32;
constexpr int kRadixThreads = 256;  // 8 warps
constexpr int kRadixItems = 16;     // rows per thread of a pass
constexpr int kRadixTile = kRadixThreads * kRadixItems;

struct RadixSortParams {
  const void* keys[kRadixMaxKeys];  // [n] int32 or int64, most significant first
  int key_bytes[kRadixMaxKeys];     // 4 or 8
  int n_keys;
  long long n;
  unsigned* hist;                    // [n_keys][8][256] whole-column digit counts
  unsigned* counts;                  // [256][n_tiles] per-tile counts (one pass)
  unsigned long long* key_buf[2];    // [n] the carried key, sign bit flipped
  int32_t* perm_scratch;             // [n] the other permutation buffer
};

extern "C" long long radix_sort_tiles(long long n);

// Passes a sort may run: one per byte of every key column.
extern "C" int radix_sort_candidates(const RadixSortParams* p);

// Every key column's 256-bin histogram of each of its bytes, into p->hist
// (zeroed first), then the sort's plan, all on the device.  The histograms
// do not depend on the permutation, so they decide before any pass which
// passes to skip.  plan is int32 [1 + candidates + n_keys]:
//   plan[0]              the number of passes that run;
//   plan[1 + c]          candidate c (LSD order: the last key first, its
//                        bytes from the least significant): the buffer
//                        (0 or 1) the pass reads, or -1 to skip it;
//   plan[1 + cands + k]  key column k's gather before its first pass that
//                        runs: the buffer (0 or 1), 2 + the buffer for the
//                        sort's first gather (which starts the permutation
//                        at row order), or -1 when no pass of k runs.
extern "C" cudaError_t radix_sort_plan(const RadixSortParams* p, int* plan,
                                       cudaStream_t stream);

// The LSD passes, every candidate launched and the skipped ones returning
// at once; the permutation lands in perm_out (buffer 0; perm_scratch is
// buffer 1).  With no pass at all the output is iota.
extern "C" cudaError_t radix_sort_passes(const RadixSortParams* p,
                                         const int* plan, int32_t* perm_out,
                                         cudaStream_t stream);
