// The x32 state merge (kernel M), for sm_90a.
//
// Replaces the x32 branches of arrow_ballista_tpu/ops/kernels.py:
// combine_states (with _two_sum and _lex_merge): a batch's x32 state rows
// -- each a [capacity] int32 row, floats as their bits, from the double-
// float segment sum (df32_agg.cu) and the extremum (ord_extremum.cu) --
// merged into the running state in place.  A sum's (hi, lo) pair merges by
// 2Sum of the hi words (lo = acc_lo + new_lo + e), an order pair by its
// lexicographic extremum, counts by i32 add, f32/i32 extrema by
// jnp.minimum/maximum's rules (x32_ops.cuh).
//
// Bound: bytes, 3 * n_fields * capacity * 4 (read both, write one).
// Design: one thread per (field, group) in a grid-stride loop; the thread
// of a pair's first row also owns its second, so no two threads touch one
// word.  No atomics, no reduction order: bit-identical to its twin.

#include <cuda_runtime.h>
#include <stdint.h>

#include "x32_merge.h"
#include "x32_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;

__global__ void x32_merge_kernel(const __grid_constant__ X32MergeParams p) {
  const long long total = (long long)p.n_fields * p.capacity;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int f = (int)(i / p.capacity);
    const long long g = i - (long long)f * p.capacity;
    const int op = p.ops[f];
    if (op == XM_SUM_LO || op == XM_PAIR_LO) continue;
    const bool pair = x32_ops::is_pair_head(op);
    int32_t* acc = p.state + i;
    int32_t* acc2 = pair ? acc + p.capacity : acc;
    const int32_t b2 = pair ? p.rows[f + 1][g] : 0;
    x32_ops::merge_field(op, acc, acc2, p.rows[f][g], b2);
  }
}

}  // namespace

extern "C" cudaError_t x32_merge_launch(const X32MergeParams* params,
                                        cudaStream_t stream) {
  const X32MergeParams& p = *params;
  const long long total = (long long)p.n_fields * p.capacity;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  x32_merge_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
