// Exact per-group median and distinct count of the keyed route (B9), for
// sm_90a.
//
// Replaces the post-sort half of arrow_ballista_tpu/ops/kernels.py:
// keyed_median_kernel.  K1 sorts the rows by (not mask, *keys, arg-null,
// ohi, olo), so each group's rows are contiguous with its valid arguments
// first, ascending by the order pair (ohi, olo) of their f64 value; the
// gid kernel (keyed_gids.cu) over that order gives each group's first row
// and the valid row count.  Here one block owns one group slot g: its
// rows are [starts[g], end) with end = starts[g + 1], or the valid count
// for the last group; a slot past n_groups is the empty group at the
// valid count, as the reference's searchsorted gives it.  The block counts
// the rows whose argument is valid (cnt), reads the order pairs at the two
// middle rows start + floor((cnt - 1) / 2) and start + floor(cnt / 2)
// (clamped to the rows), and counts the run starts among the valid
// arguments (distinct values).  Out: [6][capacity] int64 rows hi@lo,
// lo@lo, hi@hi, lo@hi, cnt, distinct (int32 rows in x32, the reference's
// i32 indices: the keys and pairs are int32 words there, the counts below
// 2^31 rows).  The host decodes and averages.
//
// Bound: bytes, each sorted row's argnull and order pair gathered once
// through perm.  Deterministic integer block reductions, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed.h"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kMaxBlocks = 132 * 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ long long block_sum(long long x) {
  __shared__ long long part[32];
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(kFull, x, d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = x;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += part[w];
  __syncthreads();
  return total;
}

__global__ void keyed_median_kernel(KeyedMedianParams p) {
  const long long n_groups = p.counts[0];
  const long long n_valid = p.counts[1];
  for (long long g = blockIdx.x; g < p.capacity; g += gridDim.x) {
    long long start = n_valid, end = n_valid;
    if (g < n_groups) {
      start = p.starts[g];
      end = g + 1 < n_groups ? (long long)p.starts[g + 1] : n_valid;
    }
    long long c = 0;
    for (long long r = start + threadIdx.x; r < end; r += blockDim.x) {
      c += p.argnull[p.perm[r]] == 0 ? 1 : 0;
    }
    const long long cnt = block_sum(c);
    long long d = 0;
    for (long long r = start + threadIdx.x; r < start + cnt; r += blockDim.x) {
      const long long i = p.perm[r];
      bool run = r == start;
      if (!run) {
        const long long j = p.perm[r - 1];
        run = p.ohi[i] != p.ohi[j] || p.olo[i] != p.olo[j];
      }
      d += run ? 1 : 0;
    }
    const long long distinct = block_sum(d);
    if (threadIdx.x == 0) {
      const long long last = p.n - 1;
      long long lo = start + (cnt >= 1 ? (cnt - 1) / 2 : -1);
      long long hi = start + cnt / 2;
      lo = lo < 0 ? 0 : (lo > last ? last : lo);
      hi = hi < 0 ? 0 : (hi > last ? last : hi);
      const long long il = p.perm[lo], ih = p.perm[hi];
      const long long cap = p.capacity;
      const long long row[6] = {p.ohi[il], p.olo[il], p.ohi[ih], p.olo[ih], cnt, distinct};
      for (int k = 0; k < 6; ++k) {
        if (p.out_bytes == 4) {
          static_cast<int32_t*>(p.out)[k * cap + g] = (int32_t)row[k];
        } else {
          static_cast<long long*>(p.out)[k * cap + g] = row[k];
        }
      }
    }
  }
}

}  // namespace

extern "C" cudaError_t keyed_median_launch(const KeyedMedianParams* params,
                                           cudaStream_t stream) {
  const KeyedMedianParams& p = *params;
  if (p.n == 0 || p.capacity == 0) return cudaSuccess;
  unsigned blocks = p.capacity < kMaxBlocks ? (unsigned)p.capacity : kMaxBlocks;
  keyed_median_kernel<<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
