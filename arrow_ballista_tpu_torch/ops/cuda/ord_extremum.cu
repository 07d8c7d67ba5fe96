// Exact per-group extremum (kernel E), for sm_90a.
//
// Replaces arrow_ballista_tpu/ops/kernels.py:_ord_segment_extremum (an f64
// min/max in x32 rides an order pair: the reference reduces hi, then lo
// among the rows tied at the extremal hi) and the x32 matmul and scatter
// routes' jax.ops.segment_min / segment_max over f32 and i32 operands.
//
// split_u64_i32 biases both halves, so the lexicographic signed order of a
// pair (hi, lo) IS the unsigned order of join_u64(hi, lo): the reference's
// two passes are one unsigned 64-bit min/max per group.  An f32 maps to
// its IEEE order key (sign flip), with NaN the extreme (0 for a min, the
// largest key for a max) so that it propagates as the canonical NaN, as
// XLA's scatter min/max keeps it, and -0.0 orders below +0.0; an i32 maps
// to v ^ 2^31.  Rows outside tail & pred & pvalid & valid do not take
// part; an empty group keeps the identity (INT32_MAX pairs, +inf,
// INT32_MAX for a min; their opposites for a max).
//
// Bound: bytes (gid, the masks and the operand words read once).  Design:
// grid-stride over 32-row warp steps; lanes of one group (__match_any_sync)
// reduce their keys with __reduce_min/max_sync on the two 32-bit halves,
// and one lane per group folds the result with a 64-bit atomicMin/Max --
// into the CTA's shared-memory copy of the groups up to kOrdSmemGroups,
// flushed once per CTA, else straight into device memory.  A min or max
// over integers does not depend on order: atomics leave the bits exact,
// and two runs give the same result.  A last pass splits the keys back
// into the state words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ord_extremum.h"
#include "x32_ops.cuh"

namespace {

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 8;

__device__ __forceinline__ u64 identity(const OrdParams& p) {
  if (p.kind == ORD_PAIR) return p.is_min ? ~0ULL : 0ULL;
  if (p.kind == ORD_F32) return p.is_min ? 0xFF800000ULL : 0x007FFFFFULL;  // +inf, -inf
  return p.is_min ? 0xFFFFFFFFULL : 0ULL;
}

__device__ __forceinline__ u64 key_of(const OrdParams& p, long long row) {
  const uint32_t h = (uint32_t)p.hi[row];
  if (p.kind == ORD_PAIR) return x32_ops::ord_join(p.hi[row], p.lo[row]);
  if (p.kind == ORD_I32) return (u64)(h ^ 0x80000000u);
  if (isnan(__int_as_float((int32_t)h))) return p.is_min ? 0ULL : 0xFFFFFFFFULL;
  return (u64)((h & 0x80000000u) ? ~h : (h | 0x80000000u));
}

__device__ __forceinline__ void fold(const OrdParams& p, u64* at, u64 k) {
  if (p.is_min) {
    atomicMin(at, k);
  } else {
    atomicMax(at, k);
  }
}

__global__ void ord_init(const __grid_constant__ OrdParams p) {
  const u64 id = identity(p);
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < p.capacity;
       g += (long long)gridDim.x * blockDim.x) {
    p.keys[g] = id;
  }
}

__global__ void ord_reduce(const __grid_constant__ OrdParams p) {
  extern __shared__ u64 local[];  // [capacity] when it fits
  const bool in_smem = p.capacity <= kOrdSmemGroups;
  const u64 id = identity(p);
  if (in_smem) {
    for (long long g = threadIdx.x; g < p.capacity; g += blockDim.x) local[g] = id;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < p.n;
       base += stride) {
    const long long row = base + lane;
    int g = -1;
    u64 k = id;
    if (row < p.n) {
      bool m = p.tail == nullptr || p.tail[row];
      if (m && p.pred != nullptr) m = p.pred[row] && (p.pvalid == nullptr || p.pvalid[row]);
      if (m && p.valid != nullptr) m = p.valid[row];
      if (m) {
        g = p.gid[row];
        k = key_of(p, row);
      }
    }
    const unsigned peers = __match_any_sync(kFull, g);
    const uint32_t khi = (uint32_t)(k >> 32);
    const uint32_t mhi = p.is_min ? __reduce_min_sync(peers, khi) : __reduce_max_sync(peers, khi);
    const uint32_t klo = khi == mhi ? (uint32_t)k : (p.is_min ? 0xFFFFFFFFu : 0u);
    const uint32_t mlo = p.is_min ? __reduce_min_sync(peers, klo) : __reduce_max_sync(peers, klo);
    if (g >= 0 && (__ffs(peers) - 1) == lane) {
      const u64 best = ((u64)mhi << 32) | mlo;
      fold(p, in_smem ? local + g : p.keys + g, best);
    }
  }
  if (in_smem) {
    __syncthreads();
    for (long long g = threadIdx.x; g < p.capacity; g += blockDim.x) {
      if (local[g] != id) fold(p, p.keys + g, local[g]);
    }
  }
}

__global__ void ord_split(const __grid_constant__ OrdParams p) {
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < p.capacity;
       g += (long long)gridDim.x * blockDim.x) {
    const u64 k = p.keys[g];
    if (p.kind == ORD_PAIR) {
      p.out[g] = x32_ops::ord_hi(k);
      p.out[p.capacity + g] = x32_ops::ord_lo(k);
    } else if (p.kind == ORD_I32) {
      p.out[g] = (int32_t)((uint32_t)k ^ 0x80000000u);
    } else {
      const uint32_t k32 = (uint32_t)k;
      uint32_t bits = (k32 & 0x80000000u) ? (k32 & 0x7FFFFFFFu) : ~k32;
      if (k32 == (p.is_min ? 0u : 0xFFFFFFFFu)) bits = 0x7FC00000u;  // NaN
      p.out[g] = (int32_t)bits;
    }
  }
}

unsigned grid_for(long long items) {
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

extern "C" cudaError_t ord_extremum_launch(const OrdParams* params, cudaStream_t stream) {
  const OrdParams& p = *params;
  if (p.capacity == 0) return cudaSuccess;
  ord_init<<<grid_for(p.capacity), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.n > 0) {
    const int smem = p.capacity <= kOrdSmemGroups ? (int)(p.capacity * sizeof(u64)) : 0;
    err = cudaFuncSetAttribute(ord_reduce, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kOrdSmemGroups * (int)sizeof(u64));
    if (err != cudaSuccess) return err;
    ord_reduce<<<grid_for(p.n), kThreads, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ord_split<<<grid_for(p.capacity), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
