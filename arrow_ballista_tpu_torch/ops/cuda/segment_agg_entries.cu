// Multi-entry segment aggregate for sm_90a: every retained batch (entry)
// of a stage folded into one state by one call.
//
// Replaces arrow_ballista_tpu/ops/stage_compiler.py:_run_fused and
// _fused_for (the per-entry partial-aggregate body, combine_states across
// the entries and pack_states, unrolled into one jitted program).
//
// Inputs: a device table of E entry descriptors (SegAggParams: gid, tail,
// pred, pvalid, values[], valids[] of that entry, as the one-batch kernel
// takes them) and a device table of row chunks in (entry, chunk) order,
// each entry cut into chunks by the one-batch kernel's rule for its own
// row count.  The descriptors live in device memory, not in kernel
// parameters: 32 entries of up to 32 columns overrun the parameter space.
//
// Design:
//   pass 1, grid (group tiles, chunks): each CTA copies its chunk's entry
//     descriptor into shared memory and runs seg_agg::chunk_partial, the
//     one-batch kernel's own body, into the chunk's partial;
//   pass 2: seg_agg::merge_field folds the state, then the partials in
//     (entry, chunk) order.
// So the fold order is that of E launches of the one-batch kernel in
// entry order, and the state is bit-identical to theirs.
//
// Scratch: one [n_fields, capacity] partial per chunk.  At capacity 2^16
// and 16 fields a partial is 8 MiB, the one-batch rule caps an entry at
// 32 chunks (its 256 MiB budget), and 32 entries would want 8 GiB; so the
// binding splits the chunk table into rounds (each a pass 1 and a pass 2)
// whose partials fit the same 256 MiB, run in table order, which leaves
// the fold order unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_agg.cuh"
#include "segment_agg_entries.h"

namespace {

__global__ void entries_partial(SegAggParams common, const SegAggParams* entries,
                                const SegAggChunk* chunks, long long first) {
  extern __shared__ long long smem[];  // [warps][n_fields][tile]
  __shared__ SegAggParams p;
  __shared__ SegAggChunk ch;
  if (threadIdx.x == 0) ch = chunks[first + blockIdx.y];
  __syncthreads();
  // word-wise copy of the entry's descriptor
  const int words = (int)(sizeof(SegAggParams) / sizeof(int));
  const int* src = reinterpret_cast<const int*>(entries + ch.entry);
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  seg_agg::chunk_partial(
      p, ch.r0, ch.r1, (long long)blockIdx.x * common.tile,
      common.partial + (long long)blockIdx.y * common.n_fields * common.capacity,
      smem);
}

__global__ void entries_merge(SegAggParams common) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (long long)common.n_fields * common.capacity) {
    seg_agg::merge_field(common, i);
  }
}

}  // namespace

static_assert(sizeof(SegAggParams) % sizeof(int) == 0, "descriptor words");

extern "C" cudaError_t segment_agg_entries_launch(const SegAggParams* params,
                                                  const SegAggParams* entries,
                                                  const SegAggChunk* chunks,
                                                  long long first,
                                                  cudaStream_t stream) {
  const SegAggParams& p = *params;
  if (p.n_chunks <= 0) return cudaSuccess;
  const int smem = segment_agg_smem_bytes(p.n_fields, p.tile);
  cudaError_t err = cudaFuncSetAttribute(
      entries_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (p.capacity + p.tile - 1) / p.tile;
  dim3 grid((unsigned)n_tiles, (unsigned)p.n_chunks);
  entries_partial<<<grid, kSegAggWarps * 32, smem, stream>>>(p, entries, chunks,
                                                            first);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)p.n_fields * p.capacity;
  const int threads = 256;
  entries_merge<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                  stream>>>(p);
  return cudaGetLastError();
}
