// Launch interface of radix_sort.cu, shared with the PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

constexpr int kRadixMaxKeys = 32;
constexpr int kRadixThreads = 512;  // a pass's CTA: 16 warps
constexpr int kRadixItems = 12;     // rows per thread of a pass
constexpr int kRadixTile = kRadixThreads * kRadixItems;  // 6144 rows a tile
constexpr int kRadixSmallThreads = 1024;  // the one-CTA sort
constexpr int kRadixSmallItems = 16;
// the most rows the one-CTA sort takes (a 4-byte word and a 2-byte row
// index a row in shared memory, 96 KB at this size; the rows of a thread
// in registers)
constexpr int kRadixSmallMax = kRadixSmallThreads * kRadixSmallItems;
// candidate passes over the packed key (two 32-bit words), before the
// columns' own
constexpr int kRadixPackedSlots = 8;

// plan[1 + slot] of a candidate pass that runs: bit 0 the buffer it
// reads, and these flags
constexpr int kPlanGather = 2;    // the first pass of its 32-bit word: read
                                  // the word from its source through perm
constexpr int kPlanIdentity = 4;  // the sort's first pass: perm is the row
constexpr int kPlanKeyOut = 8;    // a later pass of the word runs: carry it

struct RadixSortParams {
  const void* keys[kRadixMaxKeys];  // [n] int32 or int64, most significant first
  int key_bytes[kRadixMaxKeys];     // 4 or 8
  int n_keys;
  long long n;
};

// Passes a sort's columns may need: one per byte of every key column.
extern "C" int radix_sort_candidates(const RadixSortParams* p);

// Bytes of device scratch the multi-CTA sort of n rows needs: 256-byte
// aligned regions, in order, the plan (first, so that plan[0] is the
// scratch's first int32), the packing layout, each column's bounds, the
// packed key's histograms, the columns' histograms, one tile counter a
// slot, the look-back status words ([tiles][256] u64); then the second
// permutation buffer, two carried-word buffers ([n] u32 each) and, unless
// the key is one int32 column (never packed), the packed key ([n] u64).
extern "C" size_t radix_sort_scratch_bytes(long long n, int n_keys, int candidates);

// Everything before the passes, on the device: every column's bounds and
// the 256-bin histogram of each of its bytes in one read, the packed key
// where it pays (it holds every column's span and replaces two or more
// gathered words) with its own histograms, then the plan.  The histograms
// do not depend on the permutation, so they decide before any pass which
// passes to skip.  plan is int32 [1 + 8 + candidates + 1]:
//   plan[0]          the number of passes that run;
//   plan[1 + slot]   slot 0-7: the packed key's bytes, least significant
//                    first; slot 8 + c: candidate c of the columns (LSD
//                    order: the last key first, its bytes from the least
//                    significant): -1 to skip it, else the buffer (0 or 1)
//                    it reads and the kPlan* flags;
//   plan[9 + cands]  the packed key's 32-bit words a row (1 or 2).
extern "C" cudaError_t radix_sort_plan(const RadixSortParams* p, void* scratch,
                                       size_t scratch_bytes, cudaStream_t stream);

// The whole sort into perm_out.  With no scratch (small != 0, n at most
// kRadixSmallMax) one launch of one CTA; else, in scratch of at least
// radix_sort_scratch_bytes: radix_sort_plan's launches, one launch a slot
// (a skipped one returns at once) and one that writes the row order when
// no pass runs.
extern "C" cudaError_t radix_sort(const RadixSortParams* p, int32_t* perm_out,
                                  void* scratch, size_t scratch_bytes, int small,
                                  cudaStream_t stream);
