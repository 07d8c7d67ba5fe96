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
//   pass 1, grid (group tiles, row chunks): each warp walks a contiguous
//     run of its chunk 32 rows at a time; lanes with equal gid find each
//     other with __match_any_sync and the lowest lane folds its peers'
//     values in lane order (shuffles) into the warp's own shared-memory
//     partial for the tile; the CTA then merges its warps in warp order
//     into the chunk's partial in global scratch.  A tile is the group
//     range whose per-warp partials fit the shared-memory budget, so any
//     capacity works (rows are re-scanned once per tile, from L2: tiles
//     are the fast grid dimension).
//   pass 2: each (field, group) folds the state and then the chunk
//     partials in chunk order.
// Every fold runs in a fixed order, so two runs give identical bits; no
// float atomics anywhere.  Min/max propagate NaN and order -0.0 below
// +0.0, as jax.ops.segment_min/max and jnp.minimum/maximum do (fmin/fmax
// would drop the NaN).

#include <cuda_runtime.h>
#include <stdint.h>

#include "agg_ops.cuh"
#include "segment_agg.h"

namespace {

using agg_ops::combine;
using agg_ops::identity;

constexpr unsigned kFull = 0xffffffffu;

// One row's contribution to one field (its identity when masked out).
__device__ __forceinline__ long long contribution(const SegAggParams& p, int f,
                                                  long long row) {
  const int op = p.ops[f];
  const int c = p.cols[f];
  const bool ok = c < 0 || p.valids[c] == nullptr || p.valids[c][row];
  if (op == SA_COUNT) return ok ? 1 : 0;
  if (!ok) return identity(op);
  return static_cast<const long long*>(p.values[c])[row];
}

__global__ void segment_agg_partial(SegAggParams p) {
  extern __shared__ long long smem[];  // [warps][n_fields][tile]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int nf = p.n_fields;
  const long long t0 = (long long)blockIdx.x * p.tile;
  const int tile = (int)min((long long)p.tile, p.capacity - t0);
  long long* mine = smem + (long long)warp * nf * p.tile;

  for (int i = threadIdx.x; i < n_warps * nf * p.tile; i += blockDim.x) {
    smem[i] = identity(p.ops[(i / p.tile) % nf]);
  }
  __syncthreads();

  const long long c0 = (long long)blockIdx.y * p.rows_per_chunk;
  const long long c1 = min(p.n, c0 + p.rows_per_chunk);
  const long long per_warp = ((c1 - c0 + n_warps - 1) / n_warps + 31) / 32 * 32;
  const long long w0 = c0 + warp * per_warp;
  const long long w1 = min(c1, w0 + per_warp);

  for (long long base = w0; base < w1; base += 32) {
    const long long row = base + lane;
    int key = -1;
    if (row < w1) {
      const long long g = p.gid[row];
      bool m = p.tail == nullptr || p.tail[row];
      if (m && p.pred != nullptr) {
        m = p.pred[row] && (p.pvalid == nullptr || p.pvalid[row]);
      }
      if (m && g >= t0 && g < t0 + tile) key = (int)(g - t0);
    }
    const unsigned active = __ballot_sync(kFull, key >= 0);
    if (active == 0) continue;  // warp-uniform
    const unsigned peers = __match_any_sync(kFull, key);
    const bool leader = key >= 0 && (__ffs(peers) - 1) == lane;
    for (int f = 0; f < nf; ++f) {
      const int op = p.ops[f];
      const long long v = key >= 0 ? contribution(p, f, row) : identity(op);
      long long acc = leader ? mine[f * p.tile + key] : 0;
      unsigned rest = active;
      while (rest) {  // lane order, identical for every lane
        const int j = __ffs(rest) - 1;
        rest &= rest - 1;
        const long long vj = __shfl_sync(kFull, v, j);
        if (leader && ((peers >> j) & 1u)) acc = combine(op, acc, vj);
      }
      if (leader) mine[f * p.tile + key] = acc;
    }
  }
  __syncthreads();

  long long* out = p.partial + (long long)blockIdx.y * nf * p.capacity;
  for (int i = threadIdx.x; i < nf * tile; i += blockDim.x) {
    const int f = i / tile;
    const int g = i % tile;
    long long acc = smem[f * p.tile + g];
    for (int w = 1; w < n_warps; ++w) {
      acc = combine(p.ops[f], acc, smem[((long long)w * nf + f) * p.tile + g]);
    }
    out[f * p.capacity + t0 + g] = acc;
  }
}

__global__ void segment_agg_merge(SegAggParams p) {
  const long long total = (long long)p.n_fields * p.capacity;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int op = p.ops[i / p.capacity];
  long long acc = p.state[i];
  for (int c = 0; c < p.n_chunks; ++c) {
    acc = combine(op, acc, p.partial[(long long)c * total + i]);
  }
  p.state[i] = acc;
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
