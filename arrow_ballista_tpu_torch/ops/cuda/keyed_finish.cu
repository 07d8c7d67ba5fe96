// The keyed route's finish (B8), for sm_90a: each group's key codes into
// the fetch tensor.
//
// Replaces the key half of arrow_ballista_tpu/ops/kernels.py:
// keyed_finish_kernel.  The segmented reduction of that function is K2
// (seg_scan.cu), whose epilogue merges every segment's totals straight
// into the state rows of the same [n_fields + n_keys, capacity] tensor;
// this kernel fills the key rows: row k, slot g holds the code of key k
// at group g's first sorted row (starts[g]) for g < n_groups, else 0.  So
// states and keys come back to the host in one copy.
//
// x32's form (int32 codes, int32 state rows) writes int32 words.
// Bound: bytes, n_keys x capacity words written, as many codes gathered.
// One thread per slot in a grid-stride loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed.h"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;

__global__ void keyed_keys_kernel(KeyedKeysParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < p.capacity; g += stride) {
    const bool live = g < p.n_groups;
    const long long r = live ? p.starts[g] : 0;
    for (int k = 0; k < p.n_keys; ++k) {
      long long v = 0;
      if (live) {
        v = p.key_bytes[k] == 8 ? static_cast<const long long*>(p.sk[k])[r]
                                : (long long)static_cast<const int32_t*>(p.sk[k])[r];
      }
      const long long at = (long long)k * p.capacity + g;
      if (p.out_bytes == 4) {
        static_cast<int32_t*>(p.out)[at] = (int32_t)v;
      } else {
        static_cast<long long*>(p.out)[at] = v;
      }
    }
  }
}

}  // namespace

extern "C" cudaError_t keyed_keys_launch(const KeyedKeysParams* params,
                                         cudaStream_t stream) {
  const KeyedKeysParams& p = *params;
  if (p.capacity == 0 || p.n_keys == 0) return cudaSuccess;
  long long blocks = (p.capacity + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  keyed_keys_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
