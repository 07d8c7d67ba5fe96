// The keyed single-dispatch runner's kernels (B7c), for sm_90a.
//
// Replaces the encode, concatenate and radix-combine half of
// arrow_ballista_tpu/ops/stage_compiler.py:_keyed_fused_sort_for (the
// jitted runner of _keyed_reduce_fused) and the shift unpack after its
// sort.  The sort between them is K1 (radix_sort.cu) over one word.
//
// keyed_encode_entries: one launch over every pending batch of a keyed
// stage.  Each block copies the entry table (at most 32 entries) into
// shared memory; each thread walks rows in a grid-stride loop, advancing
// its entry as the rows pass the entry's end (rows only grow), so the
// lookup costs O(1) per row.  Per row it writes the AND of the entry's
// row masks into inv and each key's code (keyed.h: key_code, the same
// code as key_encode) at the row's place in the concatenated operands.
// With a fold plan it writes one int32 word instead of the per-key
// columns: the sum of each key's min-rebased word shifted to its place,
// computed in 64 bits.  The host chose the plan from the stream's exact
// code spans, so every rebased word lies in [0, 2^width) and the widths
// sum to 31 bits at most: the word is non-negative and orders as the
// keys do, lexicographically.  Bound: bytes, each input read once, inv
// and the codes (or the word) written once.
//
// keyed_unfold: each group's key codes from the folded word of its first
// sorted row (starts[g]), by shifts and masks, into the finish's key rows
// ([n_keys][capacity], 0 past n_groups): the same words the key gather
// (keyed_finish.cu) writes from unfolded sorted keys.  One thread per
// slot in a grid-stride loop; n_groups work, not n.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed_fold.h"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;

__global__ void keyed_encode_entries_kernel(KeyedEncodeEntriesParams p) {
  __shared__ KeyedEntry es[kFoldMaxEntries];
  static_assert(sizeof(KeyedEntry) % sizeof(long long) == 0, "entry words");
  {
    const int words = p.n_entries * (int)(sizeof(KeyedEntry) / sizeof(long long));
    const long long* src = reinterpret_cast<const long long*>(p.entries);
    long long* dst = reinterpret_cast<long long*>(es);
    for (int w = threadIdx.x; w < words; w += blockDim.x) dst[w] = src[w];
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  int e = 0;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < p.total;
       r += stride) {
    while (r >= es[e].offset + es[e].n) ++e;
    const KeyedEntry& en = es[e];
    const long long i = r - en.offset;
    bool keep = true;
    for (int j = 0; j < 3; ++j) {
      if (en.masks[j] != nullptr && !en.masks[j][i]) keep = false;
    }
    p.inv[r] = keep ? 0 : 1;
    long long comb = 0;
    for (int k = 0; k < p.n_keys; ++k) {
      const long long w =
          code_word(key_code(p.kind[k], en.in_type[k], en.values[k], en.valid[k], i),
                    p.out_bytes);
      if (p.fold) {
        comb += (w - p.fold_min[k]) << p.fold_shift[k];
      } else if (p.out_bytes == 4) {
        static_cast<int32_t*>(p.out[k])[r] = (int32_t)w;
      } else {
        static_cast<long long*>(p.out[k])[r] = w;
      }
    }
    if (p.fold) p.comb[r] = (int32_t)comb;
  }
}

__global__ void keyed_unfold_kernel(KeyedUnfoldParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < p.capacity;
       g += stride) {
    const bool live = g < p.n_groups;
    const long long w = live ? (long long)p.sk[p.starts[g]] : 0;
    for (int k = 0; k < p.n_keys; ++k) {
      const long long mask = (1LL << p.fold_width[k]) - 1;
      const long long v = live ? ((w >> p.fold_shift[k]) & mask) + p.fold_min[k] : 0;
      const long long at = (long long)k * p.capacity + g;
      if (p.out_bytes == 4) {
        static_cast<int32_t*>(p.out)[at] = (int32_t)v;
      } else {
        static_cast<long long*>(p.out)[at] = v;
      }
    }
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

extern "C" cudaError_t keyed_encode_entries_launch(const KeyedEncodeEntriesParams* params,
                                                   cudaStream_t stream) {
  const KeyedEncodeEntriesParams& p = *params;
  if (p.total == 0) return cudaSuccess;
  if (p.n_entries < 1 || p.n_entries > kFoldMaxEntries) return cudaErrorInvalidValue;
  keyed_encode_entries_kernel<<<grid_for(p.total), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

extern "C" cudaError_t keyed_unfold_launch(const KeyedUnfoldParams* params,
                                           cudaStream_t stream) {
  const KeyedUnfoldParams& p = *params;
  if (p.capacity == 0 || p.n_keys == 0) return cudaSuccess;
  keyed_unfold_kernel<<<grid_for(p.capacity), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
