// Shuffle partition id of each row from its hash-partition keys, for sm_90a.
//
// Replaces arrow_ballista_tpu/ops/kernels.py:partition_id_hash and
// make_partition_id_kernel (kernel B4), which build the 64-bit hash from
// uint32 limbs because an x32 TPU has no u64.  Here it is native u64, the
// arithmetic of exec/operators.py:hash_partition_indices: per key column
// hv = x * 0x9E3779B97F4A7C15, hv ^= hv >> 32, a null takes
// 0xA5A5A5A5DEADBEEF; columns combine as h = h * 31 + hv (all mod 2^64);
// pid = h mod n_out.  So the ids equal the host partitioner's bit for bit,
// and map and reduce sides co-partition whichever computed them.
//
// Bound: bytes, each key's 8-byte pattern and 1-byte null flag read once
// and the 4-byte id written once.  Design: one thread per row in a
// grid-stride loop, column-major inputs so neighbouring threads read
// neighbouring words; no shared memory, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition_id.h"

namespace {

constexpr unsigned long long kHashMul = 0x9E3779B97F4A7C15ULL;
constexpr unsigned long long kNullHash = 0xA5A5A5A5DEADBEEFULL;
constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;  // 16 blocks per SM, then stride

__global__ void partition_id_kernel(PartitionIdParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < p.n; i += stride) {
    unsigned long long h = 0;
    for (int c = 0; c < p.n_cols; ++c) {
      const long long at = (long long)c * p.n + i;
      unsigned long long hv = (unsigned long long)p.bits[at] * kHashMul;
      hv ^= hv >> 32;
      if (p.nulls[at]) hv = kNullHash;
      h = h * 31ULL + hv;
    }
    p.out[i] = (int32_t)(h % (unsigned long long)p.n_out);
  }
}

}  // namespace

extern "C" cudaError_t partition_id_launch(const PartitionIdParams* params,
                                           cudaStream_t stream) {
  const PartitionIdParams& p = *params;
  if (p.n == 0) return cudaSuccess;
  long long blocks = (p.n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  partition_id_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
