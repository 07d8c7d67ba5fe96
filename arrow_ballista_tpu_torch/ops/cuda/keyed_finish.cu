// The keyed route's finish (B8), for sm_90a: every group's segment of the
// sorted rows reduced straight into its state slots, and each group's key
// codes into the key rows of the same [n_fields + n_keys, capacity]
// tensor, so states and keys come back to the host in one copy.
//
// Replaces arrow_ballista_tpu/ops/kernels.py:keyed_finish_kernel: the
// gather through the sort's permutation, _scan_segments' totals at each
// segment's last row, the unique keys and the pack.
//
// Bound: bytes.  Where the sort's permutation is random, each gathered
// 4- or 8-byte word costs a 32-byte sector: one gather of each column
// array through perm (chip_smoke.py's gather_ms) costs a sector a column
// a row.  kf_pack brings that to one sector a row (below gather_ms where
// a pass gathers several arrays), plus perm and the group ids read in
// order and one write of the output.
//
// Design.  Group g is the run of sorted rows [starts[g], starts[g + 1]),
// the valid rows come first, and starts[n_groups] counts them.  Only each
// segment's total is needed, so:
//   0. kf_pack (a pass that gathers two columns or more): each input row's
//      element words of the pass's columns, read in input order, into one
//      record of 2 or 4 words written coalesced through shared memory, so
//      the sorted pass gathers one 32-byte sector a row instead of a
//      sector a column array.  The records are scratch of 16 or 32 bytes
//      an input row (320 MB at 1e7 rows and 4 words);
//   1. kf_tiles: each CTA owns kFinishTile sorted rows (tiled by rows, not
//      groups, so a skewed group cannot unbalance it) and reads perm and
//      the sorted group ids s2 in order; a segment starts where s2
//      changes.  A thread folds kFinishItems consecutive rows, every
//      column of a row gathered together through perm.  One block-wide
//      segmented scan of the threads' open pieces (warp shuffles of all
//      columns at once, then the warp totals) closes the segments that
//      cross threads.  The totals of the segments that start and end in
//      the tile go to shared memory by group id (the tile's groups are
//      consecutive), and the CTA writes their slots coalesced.  A segment
//      cut by the tile's edge leaves its in-tile piece in scratch: the
//      tile's head (the segment that began before the tile) or tail (the
//      one that runs past it); a tile inside one segment leaves its whole
//      fold as its head.
//   2. kf_cross: one CTA per tile edge; the CTA at a segment's first edge
//      folds its pieces in tile order by a fixed tree (a contiguous run a
//      thread, then ordered shuffle steps and the warps in order) and
//      writes the group's slots.  A group over thousands of tiles costs
//      one CTA a few dozen dependent steps.
//   3. kf_fill: the identity in every state slot at or past n_groups and
//      the key rows (group g's code at starts[g], 0 past n_groups),
//      coalesced.
// Each slot is written once, its word combine(identity, total) computed
// in registers (x32: x32_ops::merge_field on the identity pair), so -0.0,
// NaN and +-inf come out as agg_ops.cuh and x32_ops.cuh decide.  Every
// total is a fold in a tree that depends only on n and starts: two runs
// give identical bits.  No atomics.
//
// A pass carries one to kFinishMaxCols columns (the wrapper splits wider
// finishes into passes, each writing its own columns' rows; the first
// also writes the key rows).

#include <cuda_runtime.h>
#include <stdint.h>

#include "agg_ops.cuh"
#include "keyed.h"
#include "seg_scan.h"
#include "x32_ops.cuh"

namespace {

using agg_ops::combine;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kFinishThreads / 32;
constexpr int kHas = 1;    // the piece holds at least one row
constexpr int kReset = 2;  // a segment starts (or closes) within its rows
constexpr int kFillThreads = 256;
constexpr unsigned kFillBlocks = 132 * 8;

template <int NC>
struct Piece {
  long long v[NC];
  int fl;
};

// The segmented operator: b's rows follow a's.
template <int NC>
__device__ __forceinline__ Piece<NC> join(const KeyedFinishParams& p, const Piece<NC>& a,
                                          const Piece<NC>& b) {
  if ((b.fl & kReset) || !(a.fl & kHas)) {
    Piece<NC> r = b;
    r.fl |= a.fl & kReset;
    return r;
  }
  if (!(b.fl & kHas)) return a;
  Piece<NC> r;
#pragma unroll
  for (int c = 0; c < NC; ++c) r.v[c] = combine(p.op[c], a.v[c], b.v[c]);
  r.fl = a.fl | b.fl;
  return r;
}

template <int NC>
__device__ __forceinline__ Piece<NC> shfl_up(const Piece<NC>& a, int d) {
  Piece<NC> r;
#pragma unroll
  for (int c = 0; c < NC; ++c) r.v[c] = __shfl_up_sync(kFull, a.v[c], d);
  r.fl = __shfl_up_sync(kFull, a.fl, d);
  return r;
}

template <int NC>
__device__ __forceinline__ Piece<NC> shfl_down(const Piece<NC>& a, int d) {
  Piece<NC> r;
#pragma unroll
  for (int c = 0; c < NC; ++c) r.v[c] = __shfl_down_sync(kFull, a.v[c], d);
  r.fl = __shfl_down_sync(kFull, a.fl, d);
  return r;
}

// Column c's element at input row j, as seg_scan.cu reads it: a count is
// the validity as 0/1; a null value is its fold's identity (0 for a sum).
__device__ __forceinline__ long long element(const KeyedFinishParams& p, int c, long long j) {
  const bool ok = p.valid[c] == nullptr || p.valid[c][j];
  if (p.src[c] == SS_COUNT) return ok ? 1 : 0;
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

// Column c's element at input row j in the sorted pass: from the packed
// record, or gathered from the columns.
__device__ __forceinline__ long long row_element(const KeyedFinishParams& p, int c,
                                                 long long j) {
  if (p.rec_words == 0) return element(p, c, j);
  return p.slot[c] < 0 ? 1 : __ldg(p.rec + j * p.rec_words + p.slot[c]);
}

// State row f of group g from its column's total w: the row's identity
// merged with w in registers, then written once (an x32 pair's two rows by
// the first; the second row's own call writes nothing).
__device__ __forceinline__ void put_field(const KeyedFinishParams& p, int f, long long g,
                                          long long w) {
  const int op = p.field_op[f];
  const long long at = (long long)f * p.capacity + g;
  if (!p.x32) {
    static_cast<long long*>(p.out)[at] = combine(op, p.field_ident[f], w);
    return;
  }
  const bool pair = x32_ops::is_pair_head(op);
  int32_t a = (int32_t)p.field_ident[f];
  int32_t a2 = pair ? (int32_t)p.field_ident[f + 1] : 0;
  int32_t b, b2 = 0;
  switch (op) {
    case XM_SUM_HI:
      b = __float_as_int(agg_ops::df32_hi(w));
      b2 = __float_as_int(agg_ops::df32_lo(w));
      break;
    case XM_OMIN_HI:
    case XM_OMAX_HI:
      b = x32_ops::ord_hi((unsigned long long)w);
      b2 = x32_ops::ord_lo((unsigned long long)w);
      break;
    case XM_MIN_F32:
    case XM_MAX_F32:
      b = __float_as_int((float)agg_ops::as_f64(w));
      break;
    case XM_SUM_LO:
    case XM_PAIR_LO:
      return;  // written with the row above
    default:  // counts and i32 extrema: the word's low 32 bits
      b = (int32_t)w;
      break;
  }
  x32_ops::merge_field(op, &a, &a2, b, b2);
  int32_t* out = static_cast<int32_t*>(p.out);
  out[at] = a;
  if (pair) out[at + p.capacity] = a2;
}

template <int NC>
__device__ __forceinline__ void store(long long* dst, const Piece<NC>& x) {
#pragma unroll
  for (int c = 0; c < NC; ++c) dst[c] = x.v[c];
}

template <int NC>
__device__ __forceinline__ Piece<NC> load(const long long* src, int fl) {
  Piece<NC> x;
#pragma unroll
  for (int c = 0; c < NC; ++c) x.v[c] = src[c];
  x.fl = fl;
  return x;
}

// Shared-memory staging of a tile's segment totals: column c's total of
// group gbase + i at stage[c * kStageWords + staged(i)], padded one word
// in nine so the threads' strided writes spread over the banks.
constexpr int kStageWords = kFinishTile + kFinishTile / 8;
__device__ __forceinline__ int staged(long long i) { return (int)(i + (i >> 3)); }

// Each block packs kFillThreads rows at a time: a thread's record into
// shared memory, then the block's records out as consecutive words (a
// record's padding word is never read).
template <int NC>
__global__ void kf_pack(KeyedFinishParams p) {
  __shared__ long long buf[kFillThreads * kFinishMaxCols];
  const int words = p.rec_words;
  const long long step = (long long)gridDim.x * kFillThreads;
  for (long long base = (long long)blockIdx.x * kFillThreads; base < p.n; base += step) {
    const long long j = base + threadIdx.x;
    if (j < p.n) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (p.slot[c] >= 0) buf[threadIdx.x * words + p.slot[c]] = element(p, c, j);
      }
    }
    __syncthreads();
    const long long rows = p.n - base < kFillThreads ? p.n - base : kFillThreads;
    for (long long i = threadIdx.x; i < rows * words; i += kFillThreads) {
      p.rec[base * words + i] = buf[i];
    }
    __syncthreads();
  }
}

template <int NC>
__global__ void __launch_bounds__(kFinishThreads) kf_tiles(KeyedFinishParams p) {
  extern __shared__ long long stage[];  // [NC][kStageWords]
  __shared__ long long sv[kWarps][NC];
  __shared__ int sf[kWarps];
  const long long nv = p.starts[p.n_groups];
  const long long tile0 = (long long)blockIdx.x * kFinishTile;
  if (tile0 >= nv) return;  // the whole CTA: past the valid rows
  const int gbase = p.s2[tile0];
  const long long r0 = tile0 + (long long)threadIdx.x * kFinishItems;
  const long long left = nv - r0;
  const int live = left <= 0 ? 0 : (left < kFinishItems ? (int)left : kFinishItems);
  int gid[kFinishItems];
  int32_t j[kFinishItems];
#pragma unroll
  for (int k = 0; k < kFinishItems; ++k) {
    if (k < live) {
      gid[k] = p.s2[r0 + k];
      j[k] = p.perm[r0 + k];
    }
  }
  // group ids are >= 0: -1 marks the first and the last valid row
  const int before = live > 0 && r0 > 0 ? p.s2[r0 - 1] : -1;
  const int after = live > 0 && r0 + live < nv ? p.s2[r0 + live] : -1;

  Piece<NC> acc;   // the open segment
  Piece<NC> head;  // the rows before the first start, where their segment closes here
  acc.fl = 0;
  head.fl = 0;
  bool started = false;  // acc's segment starts in these rows
#pragma unroll
  for (int k = 0; k < kFinishItems; ++k) {
    if (k < live) {
      long long e[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) e[c] = row_element(p, c, j[k]);
      // (indices mod kFinishItems keep the unrolled reads in bounds)
      const int prev = k == 0 ? before : gid[(k + kFinishItems - 1) % kFinishItems];
      const int next = k + 1 < live ? gid[(k + 1) % kFinishItems] : after;
      if (gid[k] != prev || !(acc.fl & kHas)) {
        started = gid[k] != prev;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc.v[c] = e[c];
        acc.fl = kHas;
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc.v[c] = combine(p.op[c], acc.v[c], e[c]);
      }
      if (gid[k] != next) {
        if (started) {
          const int at = staged(gid[k] - gbase);
#pragma unroll
          for (int c = 0; c < NC; ++c) stage[c * kStageWords + at] = acc.v[c];
        } else {
          head = acc;
        }
        acc.fl = 0;
        started = false;
      }
    }
  }
  Piece<NC> mine = acc;  // this thread's element of the segmented scan
  if (live == 0) {
    mine.fl = 0;
  } else if (!(acc.fl & kHas)) {
    mine.fl = kReset;  // the last row closes a segment: nothing runs on
  } else if (started) {
    mine.fl = kHas | kReset;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Piece<NC> incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Piece<NC> o = shfl_up(incl, d);
    if (lane >= d) incl = join(p, o, incl);
  }
  Piece<NC> excl = shfl_up(incl, 1);
  if (lane == 0) excl.fl = 0;
  if (lane == 31) {
    store(sv[warp], incl);
    sf[warp] = incl.fl;
  }
  __syncthreads();
  if (warp == 0) {
    Piece<NC> w;
    w.fl = 0;
    if (lane < kWarps) w = load<NC>(sv[lane], sf[lane]);
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Piece<NC> o = shfl_up(w, d);
      if (lane >= d) w = join(p, o, w);
    }
    if (lane < kWarps) {
      store(sv[lane], w);
      sf[lane] = w.fl;
    }
  }
  __syncthreads();
  if (warp > 0) excl = join(p, load<NC>(sv[warp - 1], sf[warp - 1]), excl);

  const long long at = (long long)blockIdx.x * NC;
  if (head.fl & kHas) {
    // the segment open at the previous thread's end closes in these rows
    const Piece<NC> t = join(p, excl, head);
    if (t.fl & kReset) {
      const int i = staged(gid[0] - gbase);
#pragma unroll
      for (int c = 0; c < NC; ++c) stage[c * kStageWords + i] = t.v[c];
    } else {
      store(p.head + at, t);  // it began before the tile
    }
  }
  const int fl = sf[kWarps - 1];  // the tile's total
  if (threadIdx.x == 0 && (fl & kHas)) {  // a segment runs past the tile's last row
    long long* dst = (fl & kReset) ? p.tail : p.head;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[at + c] = sv[kWarps - 1][c];
  }
  __syncthreads();
  // the segments that start and end in the tile: consecutive group ids
  const long long last = (tile0 + kFinishTile < nv ? tile0 + kFinishTile : nv) - 1;
  const long long g0 = gbase + (tile0 > 0 && p.s2[tile0 - 1] == gbase ? 1 : 0);
  const long long g1 = p.s2[last] - ((fl & kHas) ? 1 : 0);
  for (int f = 0; f < p.n_fields; ++f) {
    const int c = p.field_col[f];
    if (c < 0) continue;
    const long long* col = stage + (long long)c * kStageWords;
    for (long long g = g0 + threadIdx.x; g <= g1; g += kFinishThreads) {
      put_field(p, f, g, col[staged(g - gbase)]);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kFinishThreads) kf_cross(KeyedFinishParams p) {
  __shared__ long long sv[kWarps][NC];
  __shared__ int sf[kWarps];
  const long long edge = blockIdx.x;  // between tile `edge` and the next
  const long long nv = p.starts[p.n_groups];
  const long long r = (edge + 1) * kFinishTile;
  if (r >= nv) return;
  const int g = p.s2[r];
  if (p.s2[r - 1] != g || p.starts[g] / kFinishTile != edge) return;
  // pieces: this tile's tail, then the heads of the tiles up to the last
  const long long m = ((long long)p.starts[g + 1] - 1) / kFinishTile - edge + 1;
  const long long per = (m + kFinishThreads - 1) / kFinishThreads;
  const long long i0 = (long long)threadIdx.x * per;
  const long long i1 = i0 + per < m ? i0 + per : m;
  Piece<NC> acc;
  acc.fl = 0;
  for (long long i = i0; i < i1; ++i) {
    const long long* src = i == 0 ? p.tail + edge * NC : p.head + (edge + i) * NC;
    acc = join(p, acc, load<NC>(src, kHas));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Piece<NC> o = shfl_down(acc, d);
    if ((lane & (2 * d - 1)) == 0) acc = join(p, acc, o);
  }
  if (lane == 0) {
    store(sv[warp], acc);
    sf[warp] = acc.fl;
  }
  __syncthreads();
  if (warp == 0) {
    acc.fl = 0;
    if (lane < kWarps) acc = load<NC>(sv[lane], sf[lane]);
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Piece<NC> o = shfl_down(acc, d);
      if ((lane & (2 * d - 1)) == 0) acc = join(p, acc, o);
    }
    if (lane == 0) {
      store(sv[0], acc);
      for (int f = 0; f < p.n_fields; ++f) {
        if (p.field_col[f] >= 0) put_field(p, f, g, sv[0][p.field_col[f]]);
      }
    }
  }
}

__global__ void kf_fill(KeyedFinishParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long g0 = p.n_keys > 0 ? 0 : p.n_groups;
  for (long long g = g0 + (long long)blockIdx.x * blockDim.x + threadIdx.x; g < p.capacity;
       g += stride) {
    const bool live = g < p.n_groups;
    if (!live) {
      for (int f = 0; f < p.n_fields; ++f) {
        if (p.field_col[f] < 0) continue;
        const long long at = (long long)f * p.capacity + g;
        if (p.out_bytes == 4) {
          static_cast<int32_t*>(p.out)[at] = (int32_t)p.field_ident[f];
        } else {
          static_cast<long long*>(p.out)[at] = p.field_ident[f];
        }
      }
    }
    const long long r = live && p.n_keys > 0 ? p.starts[g] : 0;
    for (int k = 0; k < p.n_keys; ++k) {
      long long v = 0;
      if (live) {
        v = p.key_bytes[k] == 8 ? static_cast<const long long*>(p.sk[k])[r]
                                : (long long)static_cast<const int32_t*>(p.sk[k])[r];
      }
      const long long at = (long long)(p.key_row0 + k) * p.capacity + g;
      if (p.out_bytes == 4) {
        static_cast<int32_t*>(p.out)[at] = (int32_t)v;
      } else {
        static_cast<long long*>(p.out)[at] = v;
      }
    }
  }
}

unsigned grid_stride_blocks(long long items, int threads) {
  long long blocks = (items + threads - 1) / threads;
  return (unsigned)(blocks < kFillBlocks ? (blocks > 0 ? blocks : 1) : kFillBlocks);
}

template <int NC>
cudaError_t launch_pass(const KeyedFinishParams& p, cudaStream_t stream) {
  if (p.n_tiles <= 0) return cudaSuccess;
  cudaError_t err;
  if (p.rec_words > 0) {
    kf_pack<NC><<<grid_stride_blocks(p.n, kFillThreads), kFillThreads, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int smem = NC * kStageWords * (int)sizeof(long long);  // < 48 KB at NC <= 4
  kf_tiles<NC><<<(unsigned)p.n_tiles, kFinishThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess || p.n_tiles == 1) return err;
  kf_cross<NC><<<(unsigned)(p.n_tiles - 1), kFinishThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t keyed_finish_launch(const KeyedFinishParams* params,
                                           cudaStream_t stream) {
  const KeyedFinishParams& p = *params;
  cudaError_t err = cudaSuccess;
  switch (p.n_cols) {
    case 1: err = launch_pass<1>(p, stream); break;
    case 2: err = launch_pass<2>(p, stream); break;
    case 3: err = launch_pass<3>(p, stream); break;
    case 4: err = launch_pass<4>(p, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const long long fill = p.capacity - (p.n_keys > 0 ? 0 : p.n_groups);
  if (fill <= 0 || (p.n_keys == 0 && p.n_fields == 0)) return cudaSuccess;
  kf_fill<<<grid_stride_blocks(fill, kFillThreads), kFillThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
