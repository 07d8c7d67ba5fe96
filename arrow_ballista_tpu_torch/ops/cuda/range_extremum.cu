// ROWS-frame min/max by a sparse table, for sm_90a.
//
// Replaces arrow_ballista_tpu/ops/window_kernel.py:_range_extremum and the
// frame arithmetic around it in make_window_kernel: level k holds the
// extremum of the 2^k rows starting at each sorted row (level 0 is the
// argument gathered through perm, the identity where it is null); a row's
// frame [lo, hi] is answered by two reads of level floor(log2(hi-lo+1)),
// which overlap inside the frame.  Frames are clipped to the row's
// segment, so levels may span segments without leaking into a result.
// Min/max follow jnp.minimum/maximum (NaN propagates, -0.0 below +0.0);
// the identity is +/-inf for f64 and the int64 limits for i64, and an
// empty frame yields it.  x32's f32 and int32 arguments widen exactly
// to those words as level 0 reads them.
//
// Bound: bytes, (depth + 1) writes and reads of an [n] level plus the
// index arrays.  Design: one elementwise launch per level (a level reads
// the whole previous one), then one query launch; no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "agg_ops.cuh"
#include "range_extremum.h"

namespace {

using agg_ops::combine;
using agg_ops::identity;

__global__ void rx_level0(RangeExtremumParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const long long j = p.perm[i];
  long long w = identity(p.op);
  if (p.valid == nullptr || p.valid[j]) {
    if (p.value_bytes == 4) {  // x32: widened exactly to the op's word
      const int32_t v = static_cast<const int32_t*>(p.values)[j];
      w = !agg_ops::is_f64_op(p.op) ? (long long)v
          : p.in_i64 ? agg_ops::as_word((double)v)
                     : agg_ops::as_word((double)__int_as_float(v));
    } else {
      w = static_cast<const long long*>(p.values)[j];
      if (p.in_i64 && agg_ops::is_f64_op(p.op)) w = agg_ops::as_word((double)w);
    }
  }
  p.table[i] = w;
}

__global__ void rx_level(RangeExtremumParams p, int k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const long long s = 1LL << (k - 1);
  const long long* prev = p.table + (long long)(k - 1) * p.n;
  const long long other = i + s < p.n ? prev[i + s] : identity(p.op);
  p.table[(long long)k * p.n + i] = combine(p.op, prev[i], other);
}

__global__ void rx_query(RangeExtremumParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const long long first = p.seg_first[i];
  const long long last = p.seg_last[i];
  long long lo = first, hi = last;
  if (p.has_start && i + p.start > lo) lo = i + p.start;
  if (p.has_end && i + p.end < hi) hi = i + p.end;
  if (hi < lo) {
    p.out[i] = identity(p.op);
    return;
  }
  const long long len = hi - lo + 1;
  int k = 0;
  for (int q = 1; q <= p.depth; ++q) k += len >= (1LL << q);
  const long long size = 1LL << k;
  const long long* level = p.table + (long long)k * p.n;
  long long b = hi - size + 1;
  b = b < 0 ? 0 : (b > p.n - 1 ? p.n - 1 : b);
  p.out[i] = combine(p.op, level[lo], level[b]);
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + 255) / 256); }

}  // namespace

extern "C" cudaError_t range_extremum_launch(const RangeExtremumParams* params,
                                             cudaStream_t stream) {
  const RangeExtremumParams& p = *params;
  if (p.n == 0) return cudaSuccess;
  rx_level0<<<blocks_for(p.n), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  for (int k = 1; k <= p.depth && err == cudaSuccess; ++k) {
    rx_level<<<blocks_for(p.n), 256, 0, stream>>>(p, k);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  rx_query<<<blocks_for(p.n), 256, 0, stream>>>(p);
  return cudaGetLastError();
}
