// Per-group centred corr moments of the keyed route (B10), for sm_90a.
//
// Replaces the elementwise half of arrow_ballista_tpu/ops/kernels.py:
// keyed_corr_kernel, both modes (x32's sums are K2's double-float folds
// over each argument's exact f32 pair, its centring in f32: see
// corr_center_x32_kernel).  Its two segmented sums are K2 (seg_scan.cu):
// pass 1 sums n, x and y over the pairwise-valid rows per group through
// perm; pass 2 sums the centred products over the sorted rows.  Here:
//   corr_mask   - the pairwise mask: both arguments valid and neither NaN
//                 (pandas' pairwise deletion), one thread per row;
//   corr_center - per sorted row, its group's means from pass 1 (the
//                 clamped group id, as the reference gathers them) and the
//                 products x'y', x'^2, y'^2 of the centred pair, 0 where
//                 the pair is not valid; one thread per row.
// Bound: bytes (the centring pass gathers x, y and the mask through perm
// and the means by group id, and writes three f64 columns).

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed.h"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;

__device__ __forceinline__ double value_at(const void* v, int is_i64, long long i) {
  return is_i64 ? (double)static_cast<const long long*>(v)[i]
                : static_cast<const double*>(v)[i];
}

__device__ __forceinline__ bool is_nan_at(const void* v, int type, long long i) {
  if (type == CT_F64) return isnan(static_cast<const double*>(v)[i]);
  if (type == CT_F32) return isnan(static_cast<const float*>(v)[i]);
  return false;
}

__global__ void corr_mask_kernel(CorrMaskParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < p.n;
       i += stride) {
    bool ok = (p.xvalid == nullptr || p.xvalid[i]) && (p.yvalid == nullptr || p.yvalid[i]);
    ok = ok && !is_nan_at(p.x, p.x_type, i) && !is_nan_at(p.y, p.y_type, i);
    p.m[i] = ok ? 1 : 0;
  }
}

__global__ void corr_center_kernel(CorrCenterParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long cap = p.capacity;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < p.n;
       r += stride) {
    long long g = p.s2[r];
    g = g < 0 ? 0 : (g > cap - 1 ? cap - 1 : g);
    const long long cnt = p.moments[g];
    const double nf = (double)(cnt > 1 ? cnt : 1);
    const double mx = __longlong_as_double(p.moments[cap + g]) / nf;
    const double my = __longlong_as_double(p.moments[2 * cap + g]) / nf;
    const long long i = p.perm[r];
    double xy = 0.0, xx = 0.0, yy = 0.0;
    if (p.m[i]) {
      const double xc = __dsub_rn(value_at(p.x, p.x_i64, i), mx);
      const double yc = __dsub_rn(value_at(p.y, p.y_i64, i), my);
      xy = __dmul_rn(xc, yc);
      xx = __dmul_rn(xc, xc);
      yy = __dmul_rn(yc, yc);
    }
    p.xy[r] = xy;
    p.xx[r] = xx;
    p.yy[r] = yy;
  }
}

// x32: the group means in f32 from pass 1's double-float sums, each
// sorted row's pair centred as (hi - mean) + lo and the products in f32,
// every step rounded as written (the reference's x32 corr_fn order).
__global__ void corr_center_x32_kernel(CorrCenterX32Params p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long cap = p.capacity;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < p.n;
       r += stride) {
    long long g = p.s2[r];
    g = g < 0 ? 0 : (g > cap - 1 ? cap - 1 : g);
    const int32_t cnt = p.moments[g];
    const float nf = (float)(cnt > 1 ? cnt : 1);
    const float mx = __fdiv_rn(__fadd_rn(__int_as_float(p.moments[cap + g]),
                                         __int_as_float(p.moments[2 * cap + g])), nf);
    const float my = __fdiv_rn(__fadd_rn(__int_as_float(p.moments[3 * cap + g]),
                                         __int_as_float(p.moments[4 * cap + g])), nf);
    const long long i = p.perm[r];
    float xy = 0.0f, xx = 0.0f, yy = 0.0f;
    if (p.m[i]) {
      const float xc = __fadd_rn(__fsub_rn(p.xhi[i], mx), p.xlo[i]);
      const float yc = __fadd_rn(__fsub_rn(p.yhi[i], my), p.ylo[i]);
      xy = __fmul_rn(xc, yc);
      xx = __fmul_rn(xc, xc);
      yy = __fmul_rn(yc, yc);
    }
    p.xy[r] = xy;
    p.xx[r] = xx;
    p.yy[r] = yy;
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

extern "C" cudaError_t corr_mask_launch(const CorrMaskParams* params,
                                        cudaStream_t stream) {
  if (params->n == 0) return cudaSuccess;
  corr_mask_kernel<<<grid_for(params->n), kThreads, 0, stream>>>(*params);
  return cudaGetLastError();
}

extern "C" cudaError_t corr_center_launch(const CorrCenterParams* params,
                                          cudaStream_t stream) {
  if (params->n == 0) return cudaSuccess;
  corr_center_kernel<<<grid_for(params->n), kThreads, 0, stream>>>(*params);
  return cudaGetLastError();
}

extern "C" cudaError_t corr_center_x32_launch(const CorrCenterX32Params* params,
                                              cudaStream_t stream) {
  if (params->n == 0) return cudaSuccess;
  corr_center_x32_kernel<<<grid_for(params->n), kThreads, 0, stream>>>(*params);
  return cudaGetLastError();
}
