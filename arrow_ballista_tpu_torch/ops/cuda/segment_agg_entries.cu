// Multi-entry segment aggregate for sm_90a: every retained batch (entry)
// of a stage folded into one state by one call.
//
// Replaces arrow_ballista_tpu/ops/stage_compiler.py:_run_fused and
// _fused_for (the per-entry partial-aggregate body, combine_states across
// the entries and pack_states, unrolled into one jitted program).
//
// Inputs: a device table of E entry descriptors (SegAggParams: gid, tail,
// pred, pvalid, values[], valids[] of that entry and its plan, as the
// one-batch kernel takes them; the fold map is common to every entry) and
// a device table of row chunks in (entry, chunk) order, each entry cut
// into chunks by the one-batch kernel's run rule for its own row count
// (segment_agg.cuh).  The descriptors live in device memory, not in kernel
// parameters: 32 entries of up to 32 columns overrun the parameter space.
//
// Bound: bytes, as the one-batch kernel: each entry's rows read once up
// to capacity kSegAggMaxTile.  Design:
//   pass 1, grid (group tiles, chunks): each CTA copies its chunk's entry
//     descriptor into shared memory and runs seg_agg::chunk_pass, the
//     one-batch kernel's own body, into the chunk's partial;
//   pass 2: seg_agg::merge_word folds each state word with the partials
//     in (entry, chunk) order.
// Why the bits equal one one-batch launch per entry in entry order: a
// chunk's partial is the same whichever kernel computes it (the same body
// over the same runs), and pass 2 folds state, then partials, in the same
// order as E launches would, entry after entry.  An entry of one run,
// which the one-batch kernel folds into the state directly (state, then
// run, every group), is here a chunk whose partial is that run's result
// for every group, folded by pass 2 as state, then partial: the same
// combine on the same words.
//
// Scratch: one [n_folds, capacity] partial per chunk.  The run rule caps
// an entry's chunks at the scratch budget, but 32 entries may want 32
// times it; so the binding splits the chunk table into rounds (each a
// pass 1 and a pass 2) whose partials fit kSegAggScratchBudget, run in
// table order, which leaves the fold order unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_agg.cuh"
#include "segment_agg_entries.h"

namespace {

__global__ void __launch_bounds__(kSegAggThreads, 1)
    entries_partial(const __grid_constant__ SegAggParams common, const SegAggParams* entries,
                    const SegAggChunk* chunks, long long first) {
  extern __shared__ __align__(16) unsigned char smem[];
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
  seg_agg::chunk_pass(
      p, ch.r0, ch.r1, (long long)blockIdx.x * common.tile,
      common.partial + (long long)blockIdx.y * common.n_folds * common.capacity, smem);
}

__global__ void entries_merge(const __grid_constant__ SegAggParams common) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (long long)common.n_fields * common.capacity) seg_agg::merge_word(common, i);
}

// As the one-batch kernel's: kSegAggSmemMax of dynamic shared memory and
// the SM's most shared memory, set once a device.
cudaError_t allow_smem() {
  static bool done[kSegAggMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kSegAggMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(entries_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSegAggSmemMax);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(entries_partial, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && dev < kSegAggMaxDevices) done[dev] = true;
  return err;
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
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  const long long n_tiles = (p.capacity + p.tile - 1) / p.tile;
  dim3 grid((unsigned)n_tiles, (unsigned)p.n_chunks);
  entries_partial<<<grid, kSegAggThreads, p.smem, stream>>>(p, entries, chunks, first);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)p.n_fields * p.capacity;
  const int threads = 256;
  entries_merge<<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(p);
  return cudaGetLastError();
}
