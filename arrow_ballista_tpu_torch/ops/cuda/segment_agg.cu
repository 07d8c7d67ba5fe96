// Segment aggregate over host-assigned group ids, merged into a running
// state, for sm_90a.
//
// Replaces arrow_ballista_tpu/ops/kernels.py:make_partial_agg_kernel (its
// scatter route: jax.ops.segment_sum/min/max over the masked columns) and
// kernels.py:combine_states (the cross-batch merge, here the epilogue).
//
// Inputs per launch: gid int32 [n]; optional bool masks tail, pred and
// pvalid [n]; up to kMaxCols value columns (8-byte words: f64 or i64) each
// with an optional bool validity [n]; per state field an op code and the
// column it reads; the state int64 [n_fields, capacity] (float fields hold
// their f64 bits).  A null mask is all-true.  The row mask is
// tail & pred & pvalid, a field's mask the row mask & its column's
// validity -- the reference's order.
//
// Bound: bytes.  Every row is read once (gid, masks, the value columns);
// the state is tiny next to a batch.  Design:
//   pass 1, grid (group tiles, row chunks): seg_agg::chunk_partial
//     (segment_agg.cuh) folds one chunk into its partial in global
//     scratch.  A tile is the group range whose per-warp partials fit the
//     shared-memory budget, so any capacity works (rows are re-scanned
//     once per tile, from L2: tiles are the fast grid dimension).
//   pass 2: each (field, group) folds the state and then the chunk
//     partials in chunk order (seg_agg::merge_field).
// Every fold runs in a fixed order, so two runs give identical bits; no
// float atomics anywhere.  Min/max propagate NaN and order -0.0 below
// +0.0, as jax.ops.segment_min/max and jnp.minimum/maximum do (fmin/fmax
// would drop the NaN).

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_agg.cuh"
#include "segment_agg.h"

namespace {

__global__ void segment_agg_partial(SegAggParams p) {
  extern __shared__ long long smem[];  // [warps][n_fields][tile]
  const long long c0 = (long long)blockIdx.y * p.rows_per_chunk;
  const long long c1 = min(p.n, c0 + p.rows_per_chunk);
  seg_agg::chunk_partial(p, c0, c1, (long long)blockIdx.x * p.tile,
                         p.partial + (long long)blockIdx.y * p.n_fields * p.capacity,
                         smem);
}

__global__ void segment_agg_merge(SegAggParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (long long)p.n_fields * p.capacity) seg_agg::merge_field(p, i);
}

}  // namespace

extern "C" int segment_agg_smem_bytes(int n_fields, int tile) {
  return kSegAggWarps * n_fields * tile * (int)sizeof(long long);
}

extern "C" cudaError_t segment_agg_launch(const SegAggParams* params,
                                          cudaStream_t stream) {
  const SegAggParams& p = *params;
  const int smem = segment_agg_smem_bytes(p.n_fields, p.tile);
  cudaError_t err = cudaFuncSetAttribute(
      segment_agg_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (p.capacity + p.tile - 1) / p.tile;
  if (p.n > 0) {
    dim3 grid((unsigned)n_tiles, (unsigned)p.n_chunks);
    segment_agg_partial<<<grid, kSegAggWarps * 32, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long total = (long long)p.n_fields * p.capacity;
    const int threads = 256;
    segment_agg_merge<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                        stream>>>(p);
  }
  return cudaGetLastError();
}
