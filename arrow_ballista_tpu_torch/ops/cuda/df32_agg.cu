// Double-float segment sum (kernel D), for sm_90a.
//
// Replaces arrow_ballista_tpu/ops/kernels.py:_blocked_onehot_agg (the x32
// "matmul" route: every sum and count column at 2^14-row blocks) and
// _segment_sum_df32 (the x32 scatter route: one column at the backend's
// block).  Both compute, per block of rows, each group's f32 partial of
// every masked column, then combine the blocks in the reference's
// pairwise 2Sum tree (hi[0::2] with hi[1::2], lo = lo[0::2] + lo[1::2] +
// e) into a double-float (hi, lo) pair; counts are exact integers.  The
// reference builds a [block, capacity] one-hot and multiplies; this
// kernel folds the partials directly, no one-hot and no GEMM.
//
// Inputs: gid int32 [n]; optional bool masks tail, pred, pvalid; f32 value
// columns with optional validities.  Row mask = tail & pred & pvalid, a
// column's mask the row mask & its validity; a masked row adds 0.
//
// Bound: bytes.  Each row is read once per group tile (q1: gid, the mask
// inputs and five f32 columns); the partials are [blocks, columns,
// capacity] words, small next to a batch at the main path's capacities.
// Design:
//   pass 1, grid (group tiles, row blocks), 8 warps a CTA: each warp walks
//     a contiguous run of the block 32 rows at a time.  Per column, the
//     lanes of each group present in the step reduce in a fixed xor-
//     butterfly tree (other lanes add 0) and the lowest lane adds the sum
//     to the warp's shared-memory partial; a step with more than
//     kTreeGroups groups folds each group's lanes in lane order instead
//     (few rows each).  The CTA then adds its warps in a fixed tree, ((0+1)
//     + (2+3)) + ((4+5) + (6+7)), into the block's partial in global
//     memory.  So the sum of one block is a tree of ~64 sequential steps,
//     not 2^14 sequential adds.
//   pass 2, one thread per (output, group): the pairwise 2Sum tree over the
//     pow2 block count (blocks past the rows are 0) as a stack of (hi, lo,
//     level) -- the same pairs in the same order as the reference's level
//     by level tree -- then an int64 pair's two halves combine by 2Sum; and
//     one thread per (count, group) adds the block counts.
// Every fold runs in a fixed order: two launches give identical bits.  No
// float atomics, no FMA (the __f*_rn intrinsics).

#include <cuda_runtime.h>
#include <stdint.h>

#include "df32_agg.h"
#include "x32_ops.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTreeGroups = 8;  // groups per step reduced by the tree

__device__ __forceinline__ bool row_live(const Df32Params& p, long long row) {
  bool m = p.tail == nullptr || p.tail[row];
  if (m && p.pred != nullptr) m = p.pred[row] && (p.pvalid == nullptr || p.pvalid[row]);
  return m;
}

__device__ __forceinline__ bool col_ok(const Df32Params& p, int c, long long row) {
  return c < 0 || p.valids[c] == nullptr || p.valids[c][row];
}

// Column j's contribution (j < n_slots: an f32 value, else a 0/1 count) as
// a 32-bit word.
__device__ __forceinline__ int32_t contribution(const Df32Params& p, int j, long long row) {
  if (j < p.n_slots) {
    const int c = p.slot_col[j];
    return col_ok(p, c, row) ? __float_as_int(p.values[c][row]) : 0;
  }
  return col_ok(p, p.cnt_col[j - p.n_slots], row) ? 1 : 0;
}

__device__ __forceinline__ int32_t add(bool is_float, int32_t a, int32_t b) {
  return is_float ? __float_as_int(__fadd_rn(__int_as_float(a), __int_as_float(b)))
                  : (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t butterfly(bool is_float, int32_t x) {
  for (int off = 16; off > 0; off >>= 1) x = add(is_float, x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__global__ void df32_partial(const __grid_constant__ Df32Params p) {
  extern __shared__ int32_t smem[];  // [warps][n_cols][tile]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_cols = p.n_slots + p.n_cnt;
  const long long t0 = (long long)blockIdx.x * p.tile;
  const int tile = (int)min((long long)p.tile, p.capacity - t0);
  const long long b = blockIdx.y;
  const long long c0 = b * p.block;
  const long long c1 = min(p.n, c0 + p.block);
  int32_t* mine = smem + (long long)warp * n_cols * p.tile;

  for (int i = threadIdx.x; i < kDfWarps * n_cols * p.tile; i += blockDim.x) smem[i] = 0;
  __syncthreads();

  const long long per_warp = ((c1 - c0 + kDfWarps - 1) / kDfWarps + 31) / 32 * 32;
  const long long w0 = c0 + warp * per_warp;
  const long long w1 = min(c1, w0 + per_warp);
  for (long long base = w0; base < w1; base += 32) {
    const long long row = base + lane;
    int key = -1;
    if (row < w1 && row_live(p, row)) {
      const long long g = p.gid[row];
      if (g >= t0 && g < t0 + tile) key = (int)(g - t0);
    }
    const unsigned active = __ballot_sync(kFull, key >= 0);
    if (active == 0) continue;  // warp-uniform
    // groups present in this step (warp-uniform count)
    int n_groups = 0;
    for (unsigned rest = active; rest && n_groups <= kTreeGroups; ++n_groups) {
      const int k = __shfl_sync(kFull, key, __ffs(rest) - 1);
      rest &= ~__ballot_sync(kFull, key == k);
    }
    const bool tree = n_groups <= kTreeGroups;
    const unsigned peers = __match_any_sync(kFull, key);
    const bool leader = key >= 0 && (__ffs(peers) - 1) == lane;
    for (int j = 0; j < n_cols; ++j) {
      const bool is_float = j < p.n_slots;
      const int32_t v = key >= 0 ? contribution(p, j, row) : 0;
      int32_t* part = mine + (long long)j * p.tile;
      if (tree) {
        for (unsigned rest = active; rest;) {
          const int lead = __ffs(rest) - 1;
          const int k = __shfl_sync(kFull, key, lead);
          rest &= ~__ballot_sync(kFull, key == k);
          const int32_t x = butterfly(is_float, key == k ? v : 0);
          if (lane == lead) part[k] = add(is_float, part[k], x);
        }
      } else {
        int32_t acc = leader ? part[key] : 0;
        for (unsigned rest = active; rest;) {  // lane order
          const int jl = __ffs(rest) - 1;
          rest &= rest - 1;
          const int32_t vj = __shfl_sync(kFull, v, jl);
          if (leader && ((peers >> jl) & 1u)) acc = add(is_float, acc, vj);
        }
        if (leader) part[key] = acc;
      }
    }
  }
  __syncthreads();

  int32_t* out = p.partial + b * n_cols * p.capacity;
  for (int i = threadIdx.x; i < n_cols * tile; i += blockDim.x) {
    const int j = i / tile;
    const int g = i - j * tile;
    const bool is_float = j < p.n_slots;
    int32_t w[kDfWarps];
    for (int k = 0; k < kDfWarps; ++k) w[k] = smem[((long long)k * n_cols + j) * p.tile + g];
    for (int width = kDfWarps / 2; width > 0; width >>= 1) {
      for (int k = 0; k < width; ++k) w[k] = add(is_float, w[2 * k], w[2 * k + 1]);
    }
    out[(long long)j * p.capacity + t0 + g] = w[0];
  }
}

// The pairwise 2Sum tree over the pow2 block count of one slot's partials
// for group g (blocks past n_real are 0).
__device__ void block_tree(const Df32Params& p, int slot, long long g, float* hi_out,
                           float* lo_out) {
  const int n_cols = p.n_slots + p.n_cnt;
  float sh[64], sl[64];
  int lev[64];
  int top = 0;
  for (long long b = 0; b < p.nb; ++b) {
    float h = b < p.n_real
                  ? __int_as_float(p.partial[(b * n_cols + slot) * p.capacity + g])
                  : 0.0f;
    float l = 0.0f;
    int level = 0;
    while (top > 0 && lev[top - 1] == level) {
      --top;
      float s, e;
      x32_ops::two_sum(sh[top], h, &s, &e);
      l = __fadd_rn(__fadd_rn(sl[top], l), e);
      h = s;
      ++level;
    }
    sh[top] = h;
    sl[top] = l;
    lev[top] = level;
    ++top;
  }
  *hi_out = sh[0];
  *lo_out = sl[0];
}

__global__ void df32_combine(const __grid_constant__ Df32Params p) {
  const long long sums = (long long)p.n_out * p.capacity;
  const long long total = sums + (long long)p.n_cnt * p.capacity;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    if (i < sums) {
      const int k = (int)(i / p.capacity);
      const long long g = i - (long long)k * p.capacity;
      float hi, lo;
      block_tree(p, p.out_a[k], g, &hi, &lo);
      if (p.out_b[k] >= 0) {
        float hb, lb, s, e;
        block_tree(p, p.out_b[k], g, &hb, &lb);
        x32_ops::two_sum(hi, hb, &s, &e);
        lo = __fadd_rn(__fadd_rn(lo, lb), e);
        hi = s;
      }
      p.hi[i] = hi;
      p.lo[i] = lo;
    } else {
      const long long r = i - sums;
      const int c = (int)(r / p.capacity);
      const long long g = r - (long long)c * p.capacity;
      const int n_cols = p.n_slots + p.n_cnt;
      uint32_t acc = 0;
      for (long long b = 0; b < p.n_real; ++b) {
        acc += (uint32_t)p.partial[(b * n_cols + p.n_slots + c) * p.capacity + g];
      }
      p.cnt[r] = (int32_t)acc;
    }
  }
}

}  // namespace

extern "C" int df32_agg_tile(int n_cols, long long capacity) {
  long long tile = kDfSmemBudget / ((long long)kDfWarps * n_cols * 4);
  if (tile > capacity) tile = capacity;
  return (int)(tile < 1 ? 1 : tile);
}

extern "C" cudaError_t df32_agg_launch(const Df32Params* params, cudaStream_t stream) {
  const Df32Params& p = *params;
  const int n_cols = p.n_slots + p.n_cnt;
  if (n_cols == 0 || p.capacity == 0) return cudaSuccess;
  cudaError_t err;
  if (p.n > 0) {
    const int smem = kDfWarps * n_cols * p.tile * (int)sizeof(int32_t);
    err = cudaFuncSetAttribute(df32_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDfSmemBudget);
    if (err != cudaSuccess) return err;
    const long long n_tiles = (p.capacity + p.tile - 1) / p.tile;
    dim3 grid((unsigned)n_tiles, (unsigned)p.n_real);
    df32_partial<<<grid, kDfWarps * 32, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long total = (long long)(p.n_out + p.n_cnt) * p.capacity;
  if (total > 0) {
    const int threads = 128;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    df32_combine<<<(unsigned)blocks, threads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}
