// Inclusive segmented scan over several columns in one launch, for sm_90a.
//
// Replaces the lax.associative_scan programs of
// arrow_ballista_tpu/ops/window_kernel.py:_seg_scan (running RANGE
// aggregates, ROWS-frame prefixes), _seg_first/_seg_last (a first/last-row
// scan of the row index) and ops/kernels.py:_scan_segments (the sorted
// partial aggregate, whose totals are read at each segment's last row).
//
// A column's element at sorted row r is gathered through perm (values with
// their validity: 0 for a sum, the fold's identity otherwise), or is a
// count, the row index, or an auxiliary 0/1 flag.  Each row either starts
// a segment (flag[r], or a change of key[perm[r]]) or continues it; the
// fold per column is a sum, min or max over f64 or i64 words, min/max with
// jnp.minimum/maximum's NaN and signed-zero rules (agg_ops.cuh).  x32's
// sort route adds three folds over 64-bit words: the double-float pair of
// _scan_segments' "df32" kind (2Sum, then 2Sum of s with a_lo + b_lo + e)
// and the unsigned min/max of a joined order pair ("omin"/"omax"); its
// columns are 32-bit (f32, i32, or f32 / i32 pairs), and its epilogue
// merges into an int32 state with the x32 merge (x32_ops.cuh).
//
// Bound: bytes (the gathers of the columns through perm, the flags, the
// outputs).  Design, three deterministic phases over tiles of kScanTile
// rows, kScanItems consecutive rows per thread:
//   1. each block folds its tile per column (thread fold, then a warp
//      shuffle scan of (value, has-start) pairs and a scan of the warp
//      totals) and writes the tile's total and whether a segment starts
//      in it;
//   2. one block per column scans the tile totals into each tile's carry;
//   3. each block folds its tile again with the carry in front and writes
//      every row's scanned value, or, for the sorted aggregate, merges each
//      segment's total at its last row into the running state (one thread
//      owns each segment end, so no two writes meet).
// The fold order depends only on n, so two runs give identical bits; there
// are no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "agg_ops.cuh"
#include "seg_scan.h"

namespace {

using agg_ops::combine;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHas = 1;    // the pair holds at least one row
constexpr int kStart = 2;  // a segment starts within its rows

struct Acc {
  long long v;
  int fl;
};

__device__ __forceinline__ Acc fold(int op, Acc a, Acc b) {
  if (!(b.fl & kHas)) return a;
  if (!(a.fl & kHas)) return b;
  return Acc{(b.fl & kStart) ? b.v : combine(op, a.v, b.v), a.fl | b.fl};
}

__device__ __forceinline__ long long row_of(const SegScanParams& p, long long e) {
  return p.reverse ? p.n - 1 - e : e;
}

__device__ __forceinline__ int key_at(const SegScanParams& p, long long r) {
  return p.key[p.perm ? p.perm[r] : r];
}

// A segment starts at row r (r >= 1) in row order.
__device__ __forceinline__ bool boundary(const SegScanParams& p, long long r) {
  if (p.flag) return p.flag[r] != 0;
  return key_at(p, r) != key_at(p, r - 1);
}

// A segment starts at scan position e (in scan order).
__device__ __forceinline__ bool starts(const SegScanParams& p, long long e) {
  const long long r = row_of(p, e);
  if (!p.reverse) return r == 0 || boundary(p, r);
  return r == p.n - 1 || boundary(p, r + 1);
}

__device__ __forceinline__ long long element(const SegScanParams& p, int c,
                                             long long r) {
  const int src = p.src[c];
  if (src == SS_IOTA) return r;
  if (src == SS_AUX) return p.aux[r] ? 1 : 0;
  const long long j = p.perm ? p.perm[r] : r;
  const bool ok = p.valid[c] == nullptr || p.valid[c][j];
  if (src == SS_COUNT) return ok ? 1 : 0;
  const int op = p.op[c];
  if (!ok) return agg_ops::identity(op);
  switch (p.width[c]) {
    case SW_F32: {
      const float f = static_cast<const float*>(p.values[c])[j];
      return op == SA_DF32 ? agg_ops::df32_word(f, 0.0f) : agg_ops::as_word((double)f);
    }
    case SW_I32:
      return (long long)static_cast<const int32_t*>(p.values[c])[j];
    case SW_F32_PAIR: {
      float s, e;
      x32_ops::two_sum(static_cast<const float*>(p.values[c])[j],
                       static_cast<const float*>(p.values2[c])[j], &s, &e);
      return agg_ops::df32_word(s, e);
    }
    case SW_ORD_PAIR:
      return (long long)x32_ops::ord_join(static_cast<const int32_t*>(p.values[c])[j],
                                          static_cast<const int32_t*>(p.values2[c])[j]);
    default: {
      const long long w = static_cast<const long long*>(p.values[c])[j];
      if (p.in_i64[c] && agg_ops::is_f64_op(op)) return agg_ops::as_word((double)w);
      return w;
    }
  }
}

// The x32 epilogue: the segment total ``w`` of a column merged into field
// f's row(s) of the int32 state at group ``key`` (ops/kernels.py:
// _x32_scan_rows decodes the same way).
__device__ __forceinline__ void merge_x32(const SegScanParams& p, int f, int key,
                                          long long w) {
  const int op = p.field_op[f];
  int32_t* s = p.state32 + (long long)f * p.capacity + key;
  int32_t* s2 = s + p.capacity;
  switch (op) {
    case XM_SUM_HI:
      x32_ops::merge_field(op, s, s2, __float_as_int(agg_ops::df32_hi(w)),
                           __float_as_int(agg_ops::df32_lo(w)));
      return;
    case XM_OMIN_HI:
    case XM_OMAX_HI:
      x32_ops::merge_field(op, s, s2, x32_ops::ord_hi((unsigned long long)w),
                           x32_ops::ord_lo((unsigned long long)w));
      return;
    case XM_MIN_F32:
    case XM_MAX_F32:
      x32_ops::merge_field(op, s, s, __float_as_int((float)agg_ops::as_f64(w)), 0);
      return;
    case XM_SUM_LO:
    case XM_PAIR_LO:
      return;
    default:  // counts and i32 extrema: the word's low 32 bits
      x32_ops::merge_field(op, s, s, (int32_t)w, 0);
      return;
  }
}

__device__ __forceinline__ Acc shfl_up(Acc a, int d) {
  return Acc{__shfl_up_sync(kFull, a.v, d), __shfl_up_sync(kFull, a.fl, d)};
}

// Block-wide scan of one pair per thread: returns the exclusive prefix
// (empty for thread 0) and leaves the block's total in *total.
__device__ Acc block_scan(int op, Acc a, Acc* total) {
  __shared__ long long sv[32];
  __shared__ int sf[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  Acc incl = a;
  for (int d = 1; d < 32; d <<= 1) {
    const Acc o = shfl_up(incl, d);
    if (lane >= d) incl = fold(op, o, incl);
  }
  Acc lane_excl = shfl_up(incl, 1);
  if (lane == 0) lane_excl.fl = 0;
  if (lane == 31) {
    sv[warp] = incl.v;
    sf[warp] = incl.fl;
  }
  __syncthreads();
  if (warp == 0) {
    Acc w = lane < nw ? Acc{sv[lane], sf[lane]} : Acc{0, 0};
    for (int d = 1; d < 32; d <<= 1) {
      const Acc o = shfl_up(w, d);
      if (lane >= d) w = fold(op, o, w);
    }
    if (lane < nw) {
      sv[lane] = w.v;
      sf[lane] = w.fl;
    }
  }
  __syncthreads();
  const Acc warp_excl = warp == 0 ? Acc{0, 0} : Acc{sv[warp - 1], sf[warp - 1]};
  *total = Acc{sv[nw - 1], sf[nw - 1]};
  __syncthreads();  // sv/sf are reused by the next call
  return fold(op, warp_excl, lane_excl);
}

struct Tile {
  long long e0;   // first scan position of this thread
  int live;       // positions of this thread below n
  unsigned start; // bit k: a segment starts at e0 + k
};

__device__ __forceinline__ Tile thread_tile(const SegScanParams& p) {
  Tile t;
  t.e0 = (long long)blockIdx.x * kScanTile + (long long)threadIdx.x * kScanItems;
  const long long left = p.n - t.e0;
  t.live = left <= 0 ? 0 : (left < kScanItems ? (int)left : kScanItems);
  t.start = 0;
  for (int k = 0; k < t.live; ++k) {
    if (starts(p, t.e0 + k)) t.start |= 1u << k;
  }
  return t;
}

__device__ __forceinline__ Acc thread_fold(const SegScanParams& p, int c,
                                           const Tile& t) {
  Acc acc{0, 0};
  for (int k = 0; k < t.live; ++k) {
    const Acc x{element(p, c, row_of(p, t.e0 + k)),
                kHas | (((t.start >> k) & 1u) ? kStart : 0)};
    acc = fold(p.op[c], acc, x);
  }
  return acc;
}

__global__ void ss_reduce(SegScanParams p) {
  const Tile t = thread_tile(p);
  for (int c = 0; c < p.n_cols; ++c) {
    Acc total;
    block_scan(p.op[c], thread_fold(p, c, t), &total);
    if (threadIdx.x == 0) {
      p.block_agg[(long long)blockIdx.x * p.n_cols + c] = total.v;
      if (c == 0) p.block_start[blockIdx.x] = (total.fl & kStart) ? 1 : 0;
    }
  }
}

// One block per column: block_carry[b] = the scan of the tiles before b.
__global__ void ss_carry(SegScanParams p) {
  const int c = blockIdx.x;
  const int op = p.op[c];
  const long long per = (p.n_blocks + blockDim.x - 1) / blockDim.x;
  const long long b0 = (long long)threadIdx.x * per;
  const long long b1 = b0 + per < p.n_blocks ? b0 + per : p.n_blocks;
  Acc acc{0, 0};
  for (long long b = b0; b < b1; ++b) {
    const Acc x{p.block_agg[b * p.n_cols + c],
                kHas | (p.block_start[b] ? kStart : 0)};
    acc = fold(op, acc, x);
  }
  Acc total;
  Acc run = block_scan(op, acc, &total);
  for (long long b = b0; b < b1; ++b) {
    p.block_carry[b * p.n_cols + c] =
        (run.fl & kHas) ? run.v : agg_ops::identity(op);
    const Acc x{p.block_agg[b * p.n_cols + c],
                kHas | (p.block_start[b] ? kStart : 0)};
    run = fold(op, run, x);
  }
}

__global__ void ss_apply(SegScanParams p) {
  const Tile t = thread_tile(p);
  unsigned ends = 0;  // sorted aggregate: segment ends with a live key
  int keys[kScanItems];
  if (p.state != nullptr || p.state32 != nullptr) {
    for (int k = 0; k < t.live; ++k) {
      const long long r = t.e0 + k;  // forward only
      keys[k] = key_at(p, r);
      if ((r == p.n - 1 || boundary(p, r + 1)) && keys[k] < p.capacity) {
        ends |= 1u << k;
      }
    }
  }
  for (int c = 0; c < p.n_cols; ++c) {
    const int op = p.op[c];
    Acc total;
    Acc run = block_scan(op, thread_fold(p, c, t), &total);
    if (blockIdx.x > 0) {
      const Acc carry{p.block_carry[(long long)blockIdx.x * p.n_cols + c], kHas};
      run = fold(op, carry, run);
    }
    long long* out = p.out[c];
    for (int k = 0; k < t.live; ++k) {
      const long long r = row_of(p, t.e0 + k);
      const Acc x{element(p, c, r), kHas | (((t.start >> k) & 1u) ? kStart : 0)};
      run = fold(op, run, x);
      if (out != nullptr) out[r] = run.v;
      if ((ends >> k) & 1u) {
        for (int f = 0; f < p.n_fields; ++f) {
          if (p.field_col[f] != c) continue;
          if (p.state32 != nullptr) {
            merge_x32(p, f, keys[k], run.v);
            continue;
          }
          long long* s = p.state + (long long)f * p.capacity + keys[k];
          *s = combine(p.field_op[f], *s, run.v);
        }
      }
    }
  }
}

}  // namespace

extern "C" long long seg_scan_blocks(long long n) {
  return (n + kScanTile - 1) / kScanTile;
}

extern "C" cudaError_t seg_scan_launch(const SegScanParams* params,
                                       cudaStream_t stream) {
  const SegScanParams& p = *params;
  if (p.n == 0 || p.n_cols == 0) return cudaSuccess;
  const unsigned grid = (unsigned)p.n_blocks;
  ss_reduce<<<grid, kScanThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ss_carry<<<(unsigned)p.n_cols, 1024, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ss_apply<<<grid, kScanThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
