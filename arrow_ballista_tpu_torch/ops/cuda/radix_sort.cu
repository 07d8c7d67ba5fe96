// Stable LSD radix argsort over several integer key columns, for sm_90a.
//
// Replaces the multi-key sorts of arrow_ballista_tpu/ops/window_kernel.py:
// make_window_kernel (lax.sort over (pad flag, PARTITION BY codes, null
// ranks and order keys, iota)) and of ops/kernels.py:_sorted_segment_agg
// (lax.sort of gid<<31 | row).  Ties keep row order, so the permutation is
// exactly that of lax.sort(keys + (iota,), num_keys=len(keys) + 1).
//
// Keys are int32 or int64 columns, most significant first; flipping the
// sign bit makes signed order unsigned, and the sort runs over 8-bit
// digits from the least significant byte of the last key to the most
// significant byte of the first.
//
// Bound: bytes.  A pass reads the carried (key, perm) pair twice (tile
// histogram, then scatter) and writes it once.  Design:
//   * one histogram kernel per key column counts all of its bytes at once
//     (warp-aggregated shared-memory atomics).  Those counts do not depend
//     on the permutation, so one plan kernel reads them before any pass
//     and marks every pass whose digit is the same on all rows to be
//     skipped: pad flags, null ranks, and the high bytes of small keys
//     (line numbers, dates, supplier codes) cost an empty launch each.
//     The plan stays on the device, so the host never waits for it: every
//     possible pass is launched and a skipped one returns at once;
//   * before the first pass of a key column, a gather lays that column out
//     in the current permutation's order (as a sign-flipped u64), so a
//     pass reads its keys contiguously;
//   * a pass is three kernels: per-tile digit counts, an exclusive scan of
//     the counts in (digit, tile) order offset by the digit's start, and a
//     stable scatter.  Inside a tile each warp owns a contiguous run of
//     rows and ranks a 32-row chunk with __match_any_sync; per-warp digit
//     offsets are scanned in warp order, so rows keep their order.
// Integer atomics only count (their order cannot change the result); no
// library sort or scan is called.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_sort.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kRadixThreads / 32;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ unsigned long long flip_key(const void* col,
                                                       int bytes, long long i) {
  if (bytes == 4) {
    const unsigned v = static_cast<const unsigned*>(col)[i];
    return (unsigned long long)(v ^ 0x80000000u);
  }
  const unsigned long long v = static_cast<const unsigned long long*>(col)[i];
  return v ^ 0x8000000000000000ULL;
}

// Histogram of every byte of one key column, added into hist[bytes][256].
__global__ void rs_histogram(const void* col, int bytes, long long n,
                             unsigned* hist) {
  __shared__ unsigned sh[8][256];
  for (int i = threadIdx.x; i < 8 * 256; i += blockDim.x) (&sh[0][0])[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool live = i < n;
    const unsigned long long u = live ? flip_key(col, bytes, i) : 0;
    for (int d = 0; d < bytes; ++d) {
      const unsigned bin = live ? (unsigned)((u >> (8 * d)) & 0xff) : 0x100u;
      const unsigned peers = __match_any_sync(kFull, bin);
      if (live && (__ffs(peers) - 1) == lane) {
        atomicAdd(&sh[d][bin], (unsigned)__popc(peers));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bytes * 256; i += blockDim.x) {
    const unsigned c = (&sh[0][0])[i];
    if (c) atomicAdd(&hist[i], c);
  }
}

// The sort's device plan (see radix_sort.h for its layout): which passes
// run, which buffer each reads, and where each key column is gathered.
// Candidates go in LSD order: the last key first, each key's bytes from
// the least significant.  The buffers alternate with every pass that
// runs, starting so that the last one lands in buffer 0 (the output).
__global__ void rs_plan(const RadixSortParams p, int* plan) {
  __shared__ unsigned char runs[kRadixMaxKeys * 8];
  int total = 0;
  for (int k = 0; k < p.n_keys; ++k) total += p.key_bytes[k];
  int c = 0;
  for (int k = p.n_keys - 1; k >= 0; --k) {
    for (int d = 0; d < p.key_bytes[k]; ++d, ++c) {
      const unsigned* h = p.hist + ((size_t)k * 8 + d) * 256;
      // one bucket holds every row: this digit cannot reorder anything
      const int one = __syncthreads_or(h[threadIdx.x] == (unsigned)p.n);
      if (threadIdx.x == 0) runs[c] = !one;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int n_run = 0;
  for (int i = 0; i < total; ++i) n_run += runs[i];
  plan[0] = n_run;
  int cur = n_run & 1;
  bool started = false;
  c = 0;
  for (int k = p.n_keys - 1; k >= 0; --k) {
    int gather = -1;
    for (int d = 0; d < p.key_bytes[k]; ++d, ++c) {
      plan[1 + c] = runs[c] ? cur : -1;
      if (!runs[c]) continue;
      if (gather < 0) gather = started ? cur : 2 + cur;
      started = true;
      cur ^= 1;
    }
    plan[1 + total + k] = gather;
  }
}

// key[b][i] = the flipped key of row perm[b][i], b = the plan's buffer
// for this column; on the first gather of the sort, row i, and then
// perm[b][i] = i starts the permutation.  No gather when no pass of the
// column runs.
__global__ void rs_gather(const void* col, int bytes, long long n,
                          const int* gather, int32_t* perm0, int32_t* perm1,
                          unsigned long long* key0, unsigned long long* key1) {
  const int g = *gather;
  if (g < 0) return;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t* perm = (g & 1) ? perm1 : perm0;
  unsigned long long* key = (g & 1) ? key1 : key0;
  if (g >= 2) {
    key[i] = flip_key(col, bytes, i);
    perm[i] = (int32_t)i;
  } else {
    key[i] = flip_key(col, bytes, perm[i]);
  }
}

// The identity permutation when no pass runs.
__global__ void rs_iota_if_none(long long n, const int* plan, int32_t* out) {
  if (plan[0] != 0) return;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (int32_t)i;
}

// The rows of tile t that warp w walks: [row0, row0 + 32 * kRadixItems).
__device__ __forceinline__ long long warp_row0(int tile, int warp) {
  return (long long)tile * kRadixTile + (long long)warp * 32 * kRadixItems;
}

// counts[bin * n_tiles + tile] = rows of the tile whose digit is bin, in
// the buffer *src names (a skipped pass when it is negative).
__global__ void rs_upsweep(const unsigned long long* key0,
                           const unsigned long long* key1, const int* src,
                           long long n, int shift, unsigned* counts,
                           long long n_tiles) {
  const int s = *src;
  if (s < 0) return;
  const unsigned long long* key = s ? key1 : key0;
  __shared__ unsigned sh[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long r0 = warp_row0(blockIdx.x, threadIdx.x >> 5);
  for (int c = 0; c < kRadixItems; ++c) {
    const long long row = r0 + 32 * c + lane;
    const bool live = row < n;
    const unsigned bin = live ? (unsigned)((key[row] >> shift) & 0xff) : 0x100u;
    const unsigned peers = __match_any_sync(kFull, bin);
    if (live && (__ffs(peers) - 1) == lane) {
      atomicAdd(&sh[bin], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    counts[(long long)b * n_tiles + blockIdx.x] = sh[b];
  }
}

// Block-wide exclusive scan of one value per thread; returns the thread's
// prefix and leaves the block total in *total.
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    unsigned s = lane < nw ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned o = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += o;
    }
    if (lane < nw) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const unsigned before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - v;
}

// One block per digit: the digit's start (rows with a smaller digit, from
// the whole-column histogram) plus the exclusive scan of its tile counts.
__global__ void rs_scan(const unsigned* digit_hist, const int* src,
                        unsigned* counts, long long n_tiles) {
  if (*src < 0) return;
  __shared__ unsigned base;
  const int d = blockIdx.x;
  if (threadIdx.x == 0) {
    unsigned s = 0;
    for (int j = 0; j < d; ++j) s += digit_hist[j];
    base = s;
  }
  __syncthreads();
  unsigned carry = base;
  unsigned* row = counts + (long long)d * n_tiles;
  constexpr int kPer = 4;
  for (long long c0 = 0; c0 < n_tiles; c0 += (long long)kScanThreads * kPer) {
    const long long i0 = c0 + (long long)threadIdx.x * kPer;
    unsigned v[kPer];
    unsigned sum = 0;
    for (int k = 0; k < kPer; ++k) {
      v[k] = i0 + k < n_tiles ? row[i0 + k] : 0;
      sum += v[k];
    }
    unsigned total;
    unsigned run = carry + block_exclusive_scan(sum, &total);
    for (int k = 0; k < kPer; ++k) {
      if (i0 + k < n_tiles) row[i0 + k] = run;
      run += v[k];
    }
    carry += total;
  }
}

// Stable scatter of one pass from buffer *src to the other: each row goes
// to its digit's offset for the tile, plus the rows of the same digit
// before it in the tile.
__global__ void rs_scatter(unsigned long long* key0, unsigned long long* key1,
                           int32_t* perm0, int32_t* perm1, const int* src,
                           long long n, int shift, const unsigned* offsets,
                           long long n_tiles) {
  const int s = *src;
  if (s < 0) return;
  const unsigned long long* key_in = s ? key1 : key0;
  const int32_t* perm_in = s ? perm1 : perm0;
  unsigned long long* key_out = s ? key0 : key1;
  int32_t* perm_out = s ? perm0 : perm1;
  __shared__ unsigned wofs[kWarps][256];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kWarps * 256; i += blockDim.x) {
    (&wofs[0][0])[i] = 0;
  }
  __syncthreads();
  const long long r0 = warp_row0(blockIdx.x, warp);
  // per-warp digit counts (one leader per digit and chunk: no race)
  for (int c = 0; c < kRadixItems; ++c) {
    const long long row = r0 + 32 * c + lane;
    const bool live = row < n;
    const unsigned bin = live ? (unsigned)((key_in[row] >> shift) & 0xff) : 0x100u;
    const unsigned peers = __match_any_sync(kFull, bin);
    if (live && (__ffs(peers) - 1) == lane) wofs[warp][bin] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // per digit, the warps' starts in warp order from the tile's offset
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    unsigned run = offsets[(long long)b * n_tiles + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const unsigned t = wofs[w][b];
      wofs[w][b] = run;
      run += t;
    }
  }
  __syncthreads();
  for (int c = 0; c < kRadixItems; ++c) {
    const long long row = r0 + 32 * c + lane;
    const bool live = row < n;
    const unsigned long long k = live ? key_in[row] : 0;
    const unsigned bin = live ? (unsigned)((k >> shift) & 0xff) : 0x100u;
    const unsigned peers = __match_any_sync(kFull, bin);
    if (live) {
      const unsigned pos = wofs[warp][bin] + __popc(peers & lt);
      key_out[pos] = k;
      perm_out[pos] = perm_in[row];
    }
    __syncwarp();
    if (live && (__ffs(peers) - 1) == lane) wofs[warp][bin] += __popc(peers);
    __syncwarp();
  }
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" long long radix_sort_tiles(long long n) {
  return (n + kRadixTile - 1) / kRadixTile;
}

extern "C" int radix_sort_candidates(const RadixSortParams* params) {
  int total = 0;
  for (int k = 0; k < params->n_keys; ++k) total += params->key_bytes[k];
  return total;
}

extern "C" cudaError_t radix_sort_plan(const RadixSortParams* params,
                                       int* plan, cudaStream_t stream) {
  const RadixSortParams& p = *params;
  cudaError_t err = cudaMemsetAsync(
      p.hist, 0, sizeof(unsigned) * 8 * 256 * (size_t)p.n_keys, stream);
  if (err != cudaSuccess) return err;
  if (p.n > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (p.n + 255) / 256;
    const unsigned grid = (unsigned)(want < 8LL * sms ? want : 8LL * sms);
    for (int k = 0; k < p.n_keys; ++k) {
      rs_histogram<<<grid, 256, 0, stream>>>(p.keys[k], p.key_bytes[k], p.n,
                                             p.hist + (size_t)k * 8 * 256);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  rs_plan<<<1, 256, 0, stream>>>(p, plan);
  return cudaGetLastError();
}

extern "C" cudaError_t radix_sort_passes(const RadixSortParams* params,
                                         const int* plan, int32_t* perm_out,
                                         cudaStream_t stream) {
  const RadixSortParams& p = *params;
  if (p.n == 0) return cudaSuccess;
  const int total = radix_sort_candidates(params);
  const long long n_tiles = radix_sort_tiles(p.n);
  const unsigned rows = blocks_for(p.n, 256);
  int c = 0;
  for (int k = p.n_keys - 1; k >= 0; --k) {
    rs_gather<<<rows, 256, 0, stream>>>(p.keys[k], p.key_bytes[k], p.n,
                                        plan + 1 + total + k, perm_out,
                                        p.perm_scratch, p.key_buf[0],
                                        p.key_buf[1]);
    for (int d = 0; d < p.key_bytes[k]; ++d, ++c) {
      const int* src = plan + 1 + c;
      const int shift = 8 * d;
      rs_upsweep<<<(unsigned)n_tiles, kRadixThreads, 0, stream>>>(
          p.key_buf[0], p.key_buf[1], src, p.n, shift, p.counts, n_tiles);
      rs_scan<<<256, kScanThreads, 0, stream>>>(
          p.hist + ((size_t)k * 8 + d) * 256, src, p.counts, n_tiles);
      rs_scatter<<<(unsigned)n_tiles, kRadixThreads, 0, stream>>>(
          p.key_buf[0], p.key_buf[1], perm_out, p.perm_scratch, src, p.n,
          shift, p.counts, n_tiles);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  rs_iota_if_none<<<rows, 256, 0, stream>>>(p.n, plan, perm_out);
  return cudaGetLastError();
}
