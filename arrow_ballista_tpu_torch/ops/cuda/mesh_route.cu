// Stable routing of one shard's rows into per-destination staging, for
// sm_90a.
//
// Replaces local_exchange in arrow_ballista_tpu/parallel/mesh.py:
// ici_batch_exchange and ici_all_to_all_repartition (kernel B13b-route):
// a stable argsort of the destinations (invalid rows to the sentinel
// n_dev), per-destination counts and offsets, each row's index within its
// destination's run, and a scatter into [n_dev, capacity] staging; rows
// past capacity are counted, not written.  Here no sort: a stable
// partition gives the same staging, since rows of one destination keep
// their input order and only that order reaches a slot.  A valid row whose
// destination lies outside 0..n_dev-1 is counted as dropped too.
//
// Bound: bytes.  dest, valid and every column are read (the scatter reads
// them again, the count pass only dest and valid), the staged columns and
// validity written once; slots left empty keep the zeros the wrapper
// allocated.  Design, three passes over fixed row tiles:
//   plan 1: each block counts its tile's rows per destination (shared
//     atomics, order-free) into counts[d][block];
//   plan 2: one block per destination scans its counts over the blocks
//     into exclusive offsets and adds the rows past capacity to dropped;
//   scatter: each block walks its tile 256 rows at a time; a row's rank
//     among the earlier rows of its destination is the warp rank
//     (__match_any_sync, lanes below it), the counts of earlier warps of
//     this step and the block's running count, so the slot is
//     offsets[d][block] + that rank: the order of a stable partition.
// Every element moves as its raw bytes, so the staging is bit-identical
// to the reference's and the twin's whatever the dtype.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh_route.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int bucket_of(const MeshRouteParams& p, long long i) {
  const int d = p.dest[i];
  return (p.valid[i] && d >= 0 && d < p.n_dev) ? d : p.n_dev;
}

__global__ void route_count(MeshRouteParams p) {
  extern __shared__ int hist[];  // [n_dev]
  __shared__ unsigned long long bad;
  for (int d = threadIdx.x; d < p.n_dev; d += blockDim.x) hist[d] = 0;
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * p.tile;
  const long long t1 = min(p.n, t0 + p.tile);
  unsigned long long my_bad = 0;
  for (long long i = t0 + threadIdx.x; i < t1; i += blockDim.x) {
    const int b = bucket_of(p, i);
    if (b < p.n_dev) {
      atomicAdd(&hist[b], 1);
    } else if (p.valid[i]) {
      ++my_bad;  // a valid row with no destination: never delivered
    }
  }
  if (my_bad) atomicAdd(&bad, my_bad);
  __syncthreads();
  for (int d = threadIdx.x; d < p.n_dev; d += blockDim.x)
    p.counts[(long long)d * p.n_blocks + blockIdx.x] = hist[d];
  if (threadIdx.x == 0 && bad) atomicAdd(p.dropped, bad);
}

__global__ void route_scan(MeshRouteParams p) {
  __shared__ long long warp_sums[kScanThreads / 32];
  __shared__ long long carry;
  long long* row = p.counts + (long long)blockIdx.x * p.n_blocks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int c0 = 0; c0 < p.n_blocks; c0 += blockDim.x) {
    const int i = c0 + threadIdx.x;
    const long long v = i < p.n_blocks ? row[i] : 0;
    long long incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const long long up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int nw = blockDim.x / 32;
      long long w = lane < nw ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const long long up = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += up;
      }
      if (lane < nw) warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const long long before = carry + (warp ? warp_sums[warp - 1] : 0);
    if (i < p.n_blocks) row[i] = before + incl - v;  // exclusive offset
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[blockDim.x / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0 && carry > p.capacity)
    atomicAdd(p.dropped, (unsigned long long)(carry - p.capacity));
}

__device__ __forceinline__ void copy_elem(const void* src, void* dst, int esize,
                                          long long i, long long at) {
  switch (esize) {
    case 1: static_cast<uint8_t*>(dst)[at] = static_cast<const uint8_t*>(src)[i]; break;
    case 2: static_cast<uint16_t*>(dst)[at] = static_cast<const uint16_t*>(src)[i]; break;
    case 4: static_cast<uint32_t*>(dst)[at] = static_cast<const uint32_t*>(src)[i]; break;
    default:
      static_cast<unsigned long long*>(dst)[at] =
          static_cast<const unsigned long long*>(src)[i];
  }
}

__global__ void route_scatter(MeshRouteParams p) {
  extern __shared__ long long base[];  // [n_dev] block offsets
  int* running = reinterpret_cast<int*>(base + p.n_dev);  // [n_dev]
  int* wcount = running + p.n_dev;                        // [kWarps][n_dev]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < p.n_dev; d += blockDim.x) {
    base[d] = p.counts[(long long)d * p.n_blocks + blockIdx.x];
    running[d] = 0;
    for (int w = 0; w < kWarps; ++w) wcount[w * p.n_dev + d] = 0;
  }
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * p.tile;
  const long long t1 = min(p.n, t0 + p.tile);
  const unsigned lt = (1u << lane) - 1u;
  for (long long c0 = t0; c0 < t1; c0 += blockDim.x) {
    const long long i = c0 + threadIdx.x;
    const int b = i < t1 ? bucket_of(p, i) : p.n_dev;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int rank = __popc(peers & lt);
    const bool real = b < p.n_dev;
    if (real && rank == 0) wcount[warp * p.n_dev + b] = __popc(peers);
    __syncthreads();
    if (real) {
      long long slot = base[b] + running[b] + rank;
      for (int w = 0; w < warp; ++w) slot += wcount[w * p.n_dev + b];
      if (slot < p.capacity) {
        const long long at = (long long)b * p.capacity + slot;
        for (int c = 0; c < p.n_cols; ++c) copy_elem(p.cols[c], p.staged[c], p.esize[c], i, at);
        if (p.staged_valid) p.staged_valid[at] = true;
      }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < p.n_dev; d += blockDim.x) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) {
        s += wcount[w * p.n_dev + d];
        wcount[w * p.n_dev + d] = 0;
      }
      running[d] += s;
    }
    __syncthreads();
  }
}

size_t scatter_smem(int n_dev) {
  return (size_t)n_dev * sizeof(long long) + (size_t)n_dev * (1 + kWarps) * sizeof(int);
}

}  // namespace

extern "C" cudaError_t mesh_route_plan(const MeshRouteParams* params,
                                       cudaStream_t stream) {
  const MeshRouteParams& p = *params;
  if (p.n == 0) return cudaSuccess;
  route_count<<<p.n_blocks, kThreads, (size_t)p.n_dev * sizeof(int), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  route_scan<<<p.n_dev, kScanThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

extern "C" cudaError_t mesh_route_scatter(const MeshRouteParams* params,
                                          cudaStream_t stream) {
  const MeshRouteParams& p = *params;
  if (p.n == 0) return cudaSuccess;
  route_scatter<<<p.n_blocks, kThreads, scatter_smem(p.n_dev), stream>>>(p);
  return cudaGetLastError();
}
