// Segment aggregate over host-assigned group ids, merged into a running
// state, for sm_90a.
//
// Replaces arrow_ballista_tpu/ops/kernels.py:make_partial_agg_kernel (its
// scatter route: jax.ops.segment_sum/min/max over the masked columns) and
// kernels.py:combine_states (the cross-batch merge, here pass 2).
//
// Inputs per launch: gid int32 [n]; optional bool masks tail, pred and
// pvalid [n]; up to kSegAggMaxCols value columns (8-byte words: f64 or
// i64) each with an optional bool validity [n]; per state field an op
// code and its distinct fold (the wrapper's fold map: one fold per (op,
// column), a count's column its validity or -1); the state int64
// [n_fields, capacity] (float fields hold their f64 bits).  A null mask is
// all-true.  The row mask is tail & pred & pvalid, a field's mask the row
// mask & its column's validity -- the reference's order.
//
// Bound: bytes.  Every row is read once up to capacity kSegAggMaxTile
// (gid, masks, the columns the distinct folds read); the state is tiny
// next to a batch.  Design (segment_agg.cuh has the run rule and the fold
// order):
//   pass 1, grid (group tiles, chunks), kSegAggThreads a CTA, one CTA an
//     SM (its registers hold the next fold's column): seg_agg::chunk_pass
//     sorts each run of its chunk by group in shared memory and folds each
//     distinct fold over the sorted run into the chunk's partial; a batch
//     of one run folds straight into the state and pass 2 does not run.
//   pass 2: each state word folds the chunk partials of its field's fold
//     in chunk order (seg_agg::merge_word).
// Min/max propagate NaN and order -0.0 below +0.0, as jax.ops.segment_min
// /max and jnp.minimum/maximum do (fmin/fmax would drop the NaN); int64
// sums wrap.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_agg.cuh"
#include "segment_agg.h"

namespace {

__global__ void __launch_bounds__(kSegAggThreads, 1)
    segment_agg_partial(const __grid_constant__ SegAggParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long c0 = (long long)blockIdx.y * p.rows_per_chunk;
  const long long c1 = min(p.n, c0 + p.rows_per_chunk);
  long long* out =
      p.direct ? nullptr : p.partial + (long long)blockIdx.y * p.n_folds * p.capacity;
  seg_agg::chunk_pass(p, c0, c1, (long long)blockIdx.x * p.tile, out, smem);
}

__global__ void segment_agg_merge(const __grid_constant__ SegAggParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (long long)p.n_fields * p.capacity) seg_agg::merge_word(p, i);
}

// Lets pass 1 take kSegAggSmemMax of dynamic shared memory, and the SM's
// most shared memory, once a device (a benign race: every caller sets the
// same values).
cudaError_t allow_smem() {
  static bool done[kSegAggMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kSegAggMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(segment_agg_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSegAggSmemMax);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(segment_agg_partial,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && dev < kSegAggMaxDevices) done[dev] = true;
  return err;
}

}  // namespace

extern "C" void segment_agg_plan(SegAggParams* p, int sms) {
  p->tile = (int)(p->capacity < kSegAggMaxTile ? p->capacity : kSegAggMaxTile);
  p->rank_warps = seg_agg::rank_warps(p->tile);
  p->smem = seg_agg::lay::kTotal;
  // the run rule (segment_agg.cuh)
  const long long runs = (p->n + kSegAggRunRows - 1) / kSegAggRunRows;
  long long chunks = kSegAggScratchBudget / ((long long)p->n_folds * p->capacity * 8);
  chunks = chunks < (long long)kSegAggChunksPerSm * sms ? chunks : (long long)kSegAggChunksPerSm * sms;
  chunks = chunks < 65535 ? chunks : 65535;
  chunks = chunks < runs ? chunks : runs;
  chunks = chunks > 1 ? chunks : 1;
  const long long per = (runs + chunks - 1) / chunks;
  p->rows_per_chunk = per * kSegAggRunRows;
  p->n_chunks = (int)(runs > 0 ? (runs + per - 1) / per : 0);
  p->direct = runs == 1 ? 1 : 0;
  auto aligned = [](const void* a, uintptr_t to) { return ((uintptr_t)a % to) == 0; };
  bool vec = aligned(p->gid, 16) && aligned(p->tail, 4) && aligned(p->pred, 4) &&
             aligned(p->pvalid, 4);
  for (int k = 0; k < p->n_folds; ++k) {
    const int c = p->fold_cols[k];
    if (c < 0) continue;
    vec = vec && aligned(p->values[c], 16) && aligned(p->valids[c], 4);
  }
  p->vec = vec ? 1 : 0;
}

extern "C" cudaError_t segment_agg_launch(const SegAggParams* params,
                                          cudaStream_t stream) {
  const SegAggParams& p = *params;
  if (p.n <= 0) return cudaSuccess;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  const long long n_tiles = (p.capacity + p.tile - 1) / p.tile;
  dim3 grid((unsigned)n_tiles, (unsigned)p.n_chunks);
  segment_agg_partial<<<grid, kSegAggThreads, p.smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.direct) return err;
  const long long total = (long long)p.n_fields * p.capacity;
  const int threads = 256;
  segment_agg_merge<<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(p);
  return cudaGetLastError();
}
