// Device bodies of the segment aggregate (B1), shared by its one-batch
// kernel (segment_agg.cu) and its multi-entry kernel
// (segment_agg_entries.cu), so both fold every row in the same order.
//
// chunk_partial: pass 1 of one row chunk [c0, c1) for the group tile
//   starting at t0.  Each warp walks a contiguous run of the chunk 32 rows
//   at a time; lanes with equal gid find each other with __match_any_sync
//   and the lowest lane folds its peers' values in lane order (shuffles)
//   into the warp's own shared-memory partial for the tile; the CTA then
//   merges its warps in warp order into the chunk's partial ``out``
//   ([n_fields, capacity] in global scratch).
// merge_field: pass 2 for one (field, group) word: the state, then the
//   chunk partials in chunk order.
// Every fold runs in a fixed order, so two runs give identical bits; no
// float atomics anywhere.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "agg_ops.cuh"
#include "segment_agg.h"

namespace seg_agg {

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

// smem: [warps][n_fields][p.tile] words of dynamic shared memory.
__device__ __forceinline__ void chunk_partial(const SegAggParams& p, long long c0,
                                              long long c1, long long t0,
                                              long long* out, long long* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int nf = p.n_fields;
  const int tile = (int)min((long long)p.tile, p.capacity - t0);
  long long* mine = smem + (long long)warp * nf * p.tile;

  for (int i = threadIdx.x; i < n_warps * nf * p.tile; i += blockDim.x) {
    smem[i] = identity(p.ops[(i / p.tile) % nf]);
  }
  __syncthreads();

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

// Word i of the state ([n_fields, capacity] flattened) folded with the
// p.n_chunks partials of p.partial, in chunk order.
__device__ __forceinline__ void merge_field(const SegAggParams& p, long long i) {
  const long long total = (long long)p.n_fields * p.capacity;
  const int op = p.ops[i / p.capacity];
  long long acc = p.state[i];
  for (int c = 0; c < p.n_chunks; ++c) {
    acc = combine(op, acc, p.partial[(long long)c * total + i]);
  }
  p.state[i] = acc;
}

}  // namespace seg_agg
