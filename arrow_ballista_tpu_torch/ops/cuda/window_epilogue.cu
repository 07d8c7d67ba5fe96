// Per-row window arithmetic around the sort and the scans, for sm_90a.
//
// Replaces the elementwise and gather parts of
// arrow_ballista_tpu/ops/window_kernel.py:make_window_kernel:
//   * window_flags: _change_flag over the sorted keys, for the partition
//     keys (segments) and for all keys (peer groups);
//   * window_pack: row_number, rank, ntile arithmetic, RANGE values read at
//     the row's last peer, ROWS-frame prefixes (P@hi, P@lo-1) and counts in
//     the layout _unpack reads, clamped lag/lead/first_value/last_value
//     gathers with their ok rows, the inverse permutation
//     inv[perm[i]] = i, and the pack into [n_rows, n] int64 words in INPUT
//     row order (floats as their bits); x32's form packs int32 words (the
//     reference's x32 layout: a df32 total as its hi and lo words, f32
//     extrema as f32 bits), each row narrowed as its descriptor says.
// The clamping follows the reference exactly: gathers clip their index to
// [0, n - 1] and the ok rows say which results the host keeps.
//
// Bound: bytes.  One thread per row; window_pack walks input rows so its
// writes are contiguous, and gathers what it needs at sorted positions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_epilogue.h"

namespace {

__device__ __forceinline__ long long key_word(const void* col, int bytes,
                                              long long i) {
  if (bytes == 4) return static_cast<const int32_t*>(col)[i];
  return static_cast<const long long*>(col)[i];
}

__global__ void wf_flags(WindowFlagsParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  bool seg = i == 0, peer = i == 0;
  if (i > 0) {
    const long long a = p.perm[i - 1], b = p.perm[i];
    for (int k = 0; k < p.n_keys && !peer; ++k) {
      if (key_word(p.keys[k], p.key_bytes[k], a) !=
          key_word(p.keys[k], p.key_bytes[k], b)) {
        peer = true;
        seg = k < p.n_part;
      }
    }
  }
  p.seg_flag[i] = seg;
  p.peer_flag[i] = peer;
}

__global__ void wp_inverse(WindowPackParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n) p.inv[p.perm[i]] = (int32_t)i;
}

__device__ __forceinline__ long long clip(long long x, long long n) {
  return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

__global__ void wp_pack(WindowPackParams p) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.n) return;
  const long long n = p.n;
  const long long i = p.inv[j];
  const long long sf = p.sf ? p.sf[i] : 0;
  const long long sl = p.sl ? p.sl[i] : 0;
  for (int r = 0; r < p.n_rows; ++r) {
    const long long* d = p.desc + (long long)r * kPackFields;
    const int kind = (int)d[0];
    const long long a = d[1], b = d[2];
    const long long* x = reinterpret_cast<const long long*>(d[5]);
    long long out = 0;
    switch (kind) {
      case WP_ROW_NUMBER: out = i - sf + 1; break;
      case WP_RANK: out = p.pf[i] - sf + 1; break;
      case WP_AT_ROW: out = x[i]; break;
      case WP_NTILE: {
        const long long size = sl - sf + 1, pos = i - sf;
        const long long q = size / a, rem = size % a;
        const long long big = rem * (q + 1);
        out = pos < big ? pos / (q + 1) + 1
                        : rem + (pos - big) / (q > 0 ? q : 1) + 1;
        break;
      }
      case WP_AT_PEER_LAST: out = x[p.pl[i]]; break;
      case WP_RANGE_COUNT: out = p.pl[i] - sf + 1; break;
      case WP_VALUE:
      case WP_VALUE_OK: {
        const int fn = (int)d[3];
        long long src;
        bool ok = true;
        if (fn == WV_FIRST) {
          src = sf;
        } else if (fn == WV_LAST) {
          src = p.pl[i];
        } else {
          src = fn == WV_LAG ? i - a : i + a;
          ok = src >= sf && src <= sl;
        }
        const long long at = p.perm[clip(src, n)];
        if (kind == WP_VALUE) {
          out = d[9] == 4 ? (long long)reinterpret_cast<const int32_t*>(d[6])[at]
                          : reinterpret_cast<const long long*>(d[6])[at];
        } else {
          const bool* valid = reinterpret_cast<const bool*>(d[7]);
          out = ok && (valid == nullptr || valid[at]);
        }
        break;
      }
      default: {  // the ROWS-frame kinds
        const long long lo = d[3] ? (i + a > sf ? i + a : sf) : sf;
        const long long hi = d[4] ? (i + b < sl ? i + b : sl) : sl;
        const bool empty = hi < lo;
        const bool lo_open = lo > sf;
        if (kind == WP_FRAME_COUNT) {
          out = empty ? 0 : hi - lo + 1;
        } else if (kind == WP_FRAME_HI) {
          out = x[clip(hi, n)];
        } else if (kind == WP_FRAME_LO) {
          out = lo_open ? x[clip(lo - 1, n)] : 0;
        } else {  // WP_FRAME_DIFF
          out = empty ? 0 : x[clip(hi, n)] - (lo_open ? x[clip(lo - 1, n)] : 0);
        }
      }
    }
    if (p.out_bytes == 4) {
      const int nw = (int)d[8];
      static_cast<int32_t*>(p.out)[(long long)r * n + j] =
          nw == WN_HI32 ? (int32_t)(out >> 32)
          : nw == WN_F32 ? __float_as_int(__double2float_rn(__longlong_as_double(out)))
                         : (int32_t)out;
    } else {
      static_cast<long long*>(p.out)[(long long)r * n + j] = out;
    }
  }
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + 255) / 256); }

}  // namespace

extern "C" cudaError_t window_flags_launch(const WindowFlagsParams* params,
                                           cudaStream_t stream) {
  if (params->n == 0) return cudaSuccess;
  wf_flags<<<blocks_for(params->n), 256, 0, stream>>>(*params);
  return cudaGetLastError();
}

extern "C" cudaError_t window_pack_launch(const WindowPackParams* params,
                                          cudaStream_t stream) {
  const WindowPackParams& p = *params;
  if (p.n == 0) return cudaSuccess;
  wp_inverse<<<blocks_for(p.n), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wp_pack<<<blocks_for(p.n), 256, 0, stream>>>(p);
  return cudaGetLastError();
}
