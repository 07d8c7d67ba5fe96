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
// x32 (int32 states, X32Op codes) folds with the reference's x32
// collectives instead: a sum's hi and lo words are each added in f32 (its
// psum of each word, no 2Sum), an order pair takes the lexicographic
// min/max (pmin of hi, then pmin of lo among the ties), counts add and
// f32/i32 extrema take jnp.minimum/maximum's rules -- again in shard
// order, bit-identical to the twin (parallel/mesh.py:_mesh_merge_x32).
//
// Bound: bytes, S * n_fields * capacity * 8 (x32: 4) read and one state
// written.
// Design: one thread per state word in a grid-stride loop; consecutive
// threads read consecutive words of each shard's state.  No shared memory
// and no atomics: the fold order is fixed, so two runs give identical bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "agg_ops.cuh"
#include "mesh_reduce.h"
#include "x32_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;

__global__ void mesh_reduce_kernel(MeshReduceParams p) {
  const long long total = (long long)p.n_fields * p.capacity;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int op = p.ops[i / p.capacity];
    long long acc = static_cast<const long long*>(p.states[0])[i];
    for (int s = 1; s < p.n_shards; ++s) {
      acc = agg_ops::combine(op, acc, static_cast<const long long*>(p.states[s])[i]);
    }
    static_cast<long long*>(p.out)[i] = acc;
  }
}

__global__ void mesh_reduce_x32_kernel(MeshReduceParams p) {
  const long long total = (long long)p.n_fields * p.capacity;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int32_t* out = static_cast<int32_t*>(p.out);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int op = p.ops[i / p.capacity];
    if (op == XM_PAIR_LO) continue;  // merged with the hi row above
    const bool pair = op == XM_OMIN_HI || op == XM_OMAX_HI;
    const long long i2 = pair ? i + p.capacity : i;
    int32_t acc = static_cast<const int32_t*>(p.states[0])[i];
    int32_t acc2 = static_cast<const int32_t*>(p.states[0])[i2];
    for (int s = 1; s < p.n_shards; ++s) {
      const int32_t* st = static_cast<const int32_t*>(p.states[s]);
      if (op == XM_SUM_HI || op == XM_SUM_LO) {  // psum of each word
        acc = __float_as_int(__fadd_rn(__int_as_float(acc), __int_as_float(st[i])));
      } else {
        x32_ops::merge_field(op, &acc, &acc2, st[i], st[i2]);
      }
    }
    out[i] = acc;
    if (pair) out[i2] = acc2;
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
  if (p.x32) {
    mesh_reduce_x32_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  } else {
    mesh_reduce_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}
