// Cross-shard reduce of partial-aggregate states, for sm_90a.
//
// Replaces the psum / pmin / pmax of reduce_states in
// arrow_ballista_tpu/parallel/mesh.py:make_distributed_agg_step (kernel
// B13b-reduce): after every shard has reduced its rows to a
// [n_fields, capacity] state (int64 words, floats as their f64 bits),
// each state word is folded over shards 0..S-1 in that order with the
// field's merge -- + for sums, counts and presence, the NaN-aware min/max
// of agg_ops.cuh for extrema -- the same merge B1 applies between batches.
// So the result equals ops/kernels.py:combine_states folded over the
// shards in order, bit for bit.
//
// Bound: bytes, S * n_fields * capacity * 8 read and one state written.
// Design: one thread per state word in a grid-stride loop; consecutive
// threads read consecutive words of each shard's state.  No shared memory
// and no atomics: the fold order is fixed, so two runs give identical bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "agg_ops.cuh"
#include "mesh_reduce.h"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;

__global__ void mesh_reduce_kernel(MeshReduceParams p) {
  const long long total = (long long)p.n_fields * p.capacity;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int op = p.ops[i / p.capacity];
    long long acc = p.states[0][i];
    for (int s = 1; s < p.n_shards; ++s) acc = agg_ops::combine(op, acc, p.states[s][i]);
    p.out[i] = acc;
  }
}

}  // namespace

extern "C" cudaError_t mesh_reduce_launch(const MeshReduceParams* params,
                                          cudaStream_t stream) {
  const MeshReduceParams& p = *params;
  const long long total = (long long)p.n_fields * p.capacity;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  mesh_reduce_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
