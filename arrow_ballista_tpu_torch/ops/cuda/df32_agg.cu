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
// kernel sorts each run of rows by group and folds the sorted values, no
// one-hot and no GEMM.
//
// Inputs: gid int32 [n]; optional bool masks tail, pred, pvalid; f32 value
// columns with optional validities.  Row mask = tail & pred & pvalid, a
// column's mask the row mask & its validity; a masked row adds 0.
//
// Bound: bytes.  Each input is read once at every capacity up to
// kDfMaxTile (8192, the matmul route's limit): gid and the masks once,
// each summed column and validity once.  The block partials,
// [blocks x runs, columns, capacity] words, are written by pass 1 and read
// back by pass 2; the reference's block structure makes them part of the
// work (at capacity 8192 and 2^23 rows they are larger than the batch).
// Design:
//   pass 1, grid (runs, group tiles), kDfThreads a CTA.  A run is a block
//     (the matmul form's 2^14 rows) or a fixed slice of one (the scatter
//     form's larger blocks split into ceil(block / kDfRunRows) runs).  The
//     CTA reads the run's group ids and masks in 16-byte loads, stages each
//     row's key (its group within the tile, or kDfDead for a masked row) in
//     shared memory and ranks the keys by a stable counting sort: every
//     live row counts into its rank warp's counter of its bin (a shared
//     atomic add: counts do not depend on order), each bin's counters turn
//     into their prefix over the rank warps and the bins' sizes into the
//     bins' starts, and then each of kDfMaxRankWarps warps (fewer at a wide
//     tile: their counters share the memory) walks its contiguous rows in
//     order, a row's rank being its bin's start, its warp's prefix and the
//     lanes of its step with its key below it (__match_any_sync).  So the
//     ranks follow row order and no atomic reaches a value.  The row count
//     is the bins' sizes.  A bitmask marks each group's first sorted
//     position and the groups are numbered in bin order.  Then per column:
//     each live row's value goes to its rank (one coalesced 16-byte read
//     of the column), each thread adds a fixed contiguous slice of the
//     sorted values in order, each group from +0.0 (an odd length, so a
//     warp's reads hit 32 banks; the bitmask says where a group starts),
//     a segmented scan in a fixed shuffle tree joins the pieces of groups
//     that cross slices in position order, and the tile's row is flushed
//     coalesced (0 for an empty group).  Past kDfMaxTile groups (only a
//     forced scatter form) the grid tiles the groups and each tile
//     re-reads the run.
//   pass 2, one CTA per (output row, stripe of G groups) with K chunks of
//     consecutive blocks: each thread folds its blocks' runs in run order,
//     runs the pairwise 2Sum subtree of its chunk in a register stack
//     (levels unrolled, no local memory), and the CTA joins the K chunks in
//     the upper levels of the same tree in shared memory, the lower chunk
//     always the left operand.  So the pairs and their order are the
//     reference's; blocks past the rows are 0.  An int64 pair's two halves
//     combine by 2Sum; counts add the block counts.  G shrinks from 32
//     until the grid holds kDfCombineFill CTAs.
// Every fold runs in a fixed order: two launches give identical bits.  No
// float atomics, no FMA (the __f*_rn intrinsics).

#include <cuda_runtime.h>
#include <stdint.h>

#include "df32_agg.h"
#include "x32_ops.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr long long align16(long long x) { return (x + 15) & ~15LL; }

// Byte offsets of pass 1's shared memory: rank, off (bin starts, then
// each bin's group index), the bitmask of group starts among the sorted
// positions and the scan scratch stay; the union holds key + bin counters
// while ranking, then per column the sorted values + one sum a group.
struct Smem {
  long long rank, off, starts, scan, u, vals_sums, hist, total;
  __host__ __device__ Smem(long long run_rows, int tile, int warps) {
    rank = 0;
    off = align16(2 * run_rows);
    starts = off + align16(2LL * (tile + 1));
    scan = starts + align16(4 * (run_rows / 32 + 2));
    u = scan + 4 * 4 * kDfWarps;
    hist = u + align16(2 * run_rows);
    vals_sums = u + align16(4 * run_rows);
    const long long ranking = align16(2 * run_rows) + align16(2LL * warps * tile + 4);
    const long long folding = align16(4 * run_rows) + align16(4LL * tile);
    total = u + (ranking > folding ? ranking : folding);
  }
};

// Rows [row, row + 4) of an int32/f32 array: one 16-byte load where the
// run allows it, else the rows below ``avail`` one by one (0 past it).
__device__ __forceinline__ void load4(const int32_t* a, long long row, int avail, bool vec,
                                      int32_t (&x)[4]) {
  if (vec && avail >= 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(a + row));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = e < avail ? a[row + e] : 0;
}

// The same rows of a bool array as the four bytes of a word (null: all 1).
__device__ __forceinline__ uint32_t load4b(const bool* a, long long row, int avail, bool vec) {
  if (a == nullptr) return 0x01010101u;
  if (vec && avail >= 4) return __ldg(reinterpret_cast<const uint32_t*>(a + row));
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) w |= (e < avail && a[row + e]) ? 1u << (8 * e) : 0u;
  return w;
}

__device__ __forceinline__ int32_t add(bool is_float, int32_t a, int32_t b) {
  return is_float ? __float_as_int(__fadd_rn(__int_as_float(a), __int_as_float(b)))
                  : (int32_t)((uint32_t)a + (uint32_t)b);
}

// a[0, E) replaced by its exclusive prefix sums (each warp scans a
// contiguous segment); returns the total.
__device__ int scan_u16(uint16_t* a, int E, uint32_t* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = ((E + kDfWarps - 1) / kDfWarps + 31) / 32 * 32;
  const int e0 = min(E, warp * seg);
  const int e1 = min(E, e0 + seg);
  uint32_t s = 0;
  for (int e = e0 + lane; e < e1; e += 32) s += a[e];
  s = __reduce_add_sync(kFull, s);
  if (lane == 0) wsum[warp] = s;
  __syncthreads();
  uint32_t carry = 0, total = 0;
  for (int w = 0; w < kDfWarps; ++w) {
    if (w < warp) carry += wsum[w];
    total += wsum[w];
  }
  for (int base = e0; base < e1; base += 32) {
    const int e = base + lane;
    const uint32_t v = e < e1 ? a[e] : 0u;
    uint32_t x = v;
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (e < e1) a[e] = (uint16_t)(carry + x - v);
    carry += __shfl_sync(kFull, x, 31);
  }
  return (int)total;
}

// The carry into each thread's slice: the segmented exclusive scan of the
// slices' (flag, value) in thread order, flag 1 where a group starts inside
// the slice (the value is then the last group's piece).  A fixed tree:
// shuffles within a warp, then the same over the warps' totals.
__device__ int32_t slice_carry(bool is_float, int f, int32_t v, int* sf, int32_t* sv) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int fo = __shfl_up_sync(kFull, f, d);
    const int32_t vo = __shfl_up_sync(kFull, v, d);
    if (lane >= d) {
      v = f ? v : add(is_float, vo, v);
      f |= fo;
    }
  }
  if (lane == 31) {
    sf[warp] = f;
    sv[warp] = v;
  }
  __syncthreads();
  // the earlier warps' piece: the same segmented scan over the warps'
  // totals (lane w holds warp w's), read at lane warp - 1
  int fw = lane < kDfWarps ? sf[lane] : 0;
  int32_t vw = lane < kDfWarps ? sv[lane] : 0;
  for (int d = 1; d < kDfWarps; d <<= 1) {
    const int fo = __shfl_up_sync(kFull, fw, d);
    const int32_t vo = __shfl_up_sync(kFull, vw, d);
    if (lane >= d) {
      vw = fw ? vw : add(is_float, vo, vw);
      fw |= fo;
    }
  }
  const int32_t wv = __shfl_sync(kFull, vw, max(warp - 1, 0));  // unused by warp 0
  const int fe = __shfl_up_sync(kFull, f, 1);
  const int32_t ve = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) return wv;
  return (fe || warp == 0) ? ve : add(is_float, wv, ve);
}

// A column's contributions for kQ of this thread's quads (rows
// 4 * (tid + q * kDfThreads) + 0..3): each row's word and validity byte.
template <int kQ>
struct Quads {
  int32_t v[kQ][4];
  uint32_t ok[kQ];
};

// The first full column at or after j: a summed column or a count of a
// validity (a row count is the bins' sizes), or n_cols.
__device__ __forceinline__ int full_column(const Df32Params& p, int j) {
  while (j < p.n_slots + p.n_cnt && j >= p.n_slots && p.cnt_col[j - p.n_slots] < 0) ++j;
  return j;
}

// Issues the loads of column j for quads [q0, q0 + kQ).
template <int kQ>
__device__ __forceinline__ void load_column(const Df32Params& p, int j, long long r0, int len,
                                            bool vec, int q0, Quads<kQ>& c) {
  const bool is_float = j < p.n_slots;
  const int col = is_float ? p.slot_col[j] : p.cnt_col[j - p.n_slots];
  const int32_t* x = is_float ? reinterpret_cast<const int32_t*>(p.values[col]) : nullptr;
  const bool* valid = p.valids[col];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = 4 * (threadIdx.x + (q0 + u) * kDfThreads);
    const int avail = len - i;
    c.ok[u] = 0u;
    if (avail > 0) {
      c.ok[u] = load4b(valid, r0 + i, avail, vec);
      if (is_float) {
        load4(x, r0 + i, avail, vec, c.v[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) c.v[u][e] = 1;
      }
    }
  }
}

// Each live row's contribution (0 where its validity is off) to its rank.
template <int kQ>
__device__ __forceinline__ void store_column(const Quads<kQ>& c, const uint16_t* rank,
                                             int32_t* vals, int len, int q0) {
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = 4 * (threadIdx.x + (q0 + u) * kDfThreads);
    if (i < len) {
      const uint2 r = *reinterpret_cast<const uint2*>(rank + i);  // rank is padded to whole quads
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t rr = ((e < 2 ? r.x : r.y) >> (16 * (e & 1))) & 0xffffu;
        if (i + e < len && rr != kDfDead) vals[rr] = ((c.ok[u] >> (8 * e)) & 0xffu) ? c.v[u][e] : 0;
      }
    }
  }
}

// kDeep: one CTA an SM (a wide tile's shared memory), so the registers
// allow every quad of a column in flight at once, and the next column's
// loads are issued before this column's fold (the first before the rank).
template <bool kDeep>
__global__ void __launch_bounds__(kDfThreads, kDeep ? 1 : 2)
    df32_partial(const __grid_constant__ Df32Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_cols = p.n_slots + p.n_cnt;
  const long long run = blockIdx.x;
  const long long blk = run / p.runs_per_block;
  const long long r0 = blk * p.block + (run - blk * p.runs_per_block) * p.run_rows;
  const long long r1 = min(min(r0 + p.run_rows, (blk + 1) * p.block), p.n);
  const int len = r1 > r0 ? (int)(r1 - r0) : 0;
  const bool vec = p.vec && (r0 & 3) == 0;
  const long long t0 = (long long)blockIdx.y * p.tile;
  const int tile = (int)min((long long)p.tile, p.capacity - t0);
  const int W = p.rank_warps;
  const int rw = (len + W * 32 - 1) / (W * 32) * 32;  // rows of each rank warp

  const Smem lay(p.run_rows, p.tile, W);
  uint16_t* rank = reinterpret_cast<uint16_t*>(smem + lay.rank);
  uint16_t* off = reinterpret_cast<uint16_t*>(smem + lay.off);
  int* sf = reinterpret_cast<int*>(smem + lay.scan);
  int32_t* sv = sf + kDfWarps;
  uint32_t* wsum = reinterpret_cast<uint32_t*>(sv + kDfWarps);
  uint16_t* key = reinterpret_cast<uint16_t*>(smem + lay.u);
  uint16_t* hist = reinterpret_cast<uint16_t*>(smem + lay.hist);  // [rank warp][bin]
  uint32_t* hist32 = reinterpret_cast<uint32_t*>(hist);
  int32_t* vals = reinterpret_cast<int32_t*>(smem + lay.u);

  const int E = W * tile;
  for (int e = tid; e < (E + 1) / 2; e += kDfThreads) hist32[e] = 0u;
  __syncthreads();
  // keys (the group within the tile, or kDfDead), each live row counted
  // into its rank warp's counter of its bin (a 16-bit half of a word)
  constexpr int kStage = kDeep ? kDfQuads : kDfBatch;
  int j = full_column(p, 0);
  Quads<kDfQuads> next;  // kDeep: the next full column's contributions
  for (int k0 = 0; k0 < kDfQuads; k0 += kStage) {
    int32_t g[kStage][4];
    uint32_t m[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = 4 * (tid + (k0 + u) * kDfThreads);
      const int avail = len - i;
      m[u] = 0u;
      if (avail > 0) {
        load4(p.gid, r0 + i, avail, vec, g[u]);
        m[u] = load4b(p.tail, r0 + i, avail, vec) & load4b(p.pred, r0 + i, avail, vec) &
               load4b(p.pvalid, r0 + i, avail, vec);
      }
    }
    if (kDeep && j < n_cols) load_column<kDfQuads>(p, j, r0, len, vec, 0, next);
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = 4 * (tid + (k0 + u) * kDfThreads);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e < len) {
          const long long k = (long long)g[u][e] - t0;
          const bool live = ((m[u] >> (8 * e)) & 0xffu) && k >= 0 && k < tile;
          key[i + e] = live ? (uint16_t)k : kDfDead;
          if (live) {
            const int h = (i + e) / rw * tile + (int)k;
            atomicAdd(&hist32[h >> 1], 1u << (16 * (h & 1)));
          }
        }
      }
    }
  }
  __syncthreads();
  // each bin's counters to their exclusive prefix over the rank warps, the
  // bin's size to off; then off to the bins' starts
  for (int b = tid; b < tile; b += kDfThreads) {
    uint32_t acc = 0;
    for (int w = 0; w < W; ++w) {
      const uint32_t c = hist[w * tile + b];
      hist[w * tile + b] = (uint16_t)acc;
      acc += c;
    }
    off[b] = (uint16_t)acc;
  }
  __syncthreads();
  const int L = scan_u16(off, tile, wsum);  // live rows in the tile
  if (tid == 0) off[tile] = (uint16_t)L;
  __syncthreads();
  // the ranks: each rank warp walks its rows in order, each row taking its
  // bin's start, its warp's prefix and its equal keys below it in the step
  if (warp < W) {
    const int w0 = min(len, warp * rw);
    const int w1 = min(len, w0 + rw);
    for (int base = w0; base < w1; base += 32) {
      const int i = base + lane;
      const unsigned k = i < w1 ? key[i] : kDfDead;
      const unsigned peers = __match_any_sync(kFull, k);  // no live key equals kDfDead
      const int h = warp * tile + (int)k;
      uint16_t r = kDfDead;
      if (k != kDfDead) r = (uint16_t)(off[k] + hist[h] + __popc(peers & ((1u << lane) - 1u)));
      __syncwarp();
      if (k != kDfDead && lane == __ffs(peers) - 1) hist[h] += __popc(peers);
      if (i < w1) rank[i] = r;
      __syncwarp();
    }
  }

  // the row counts are the bins' sizes; mark each group's first sorted
  // position, then number the groups in bin order
  int32_t* out0 = p.partial + (run * n_cols) * p.capacity + t0;
  for (int jc = p.n_slots; jc < n_cols; ++jc) {
    if (p.cnt_col[jc - p.n_slots] >= 0) continue;
    int32_t* out = out0 + (long long)jc * p.capacity;
    for (int b = tid; b < tile; b += kDfThreads) out[b] = (int32_t)off[b + 1] - (int32_t)off[b];
  }
  uint32_t* starts = reinterpret_cast<uint32_t*>(smem + lay.starts);
  for (int w = tid; w < (int)(p.run_rows / 32 + 2); w += kDfThreads) starts[w] = 0u;
  __syncthreads();
  for (int b = tid; b < tile; b += kDfThreads) {
    const int o = off[b];
    if (off[b + 1] > o) atomicOr(&starts[o >> 5], 1u << (o & 31));
  }
  // this thread's slice of the sorted positions and the bin holding its start
  const int S = (L + kDfThreads - 1) / kDfThreads | 1;  // odd: the lanes' reads hit 32 banks
  const int s0 = min(L, tid * S);
  const int s1 = min(L, s0 + S);
  int b0 = 0;
  if (s0 < L) {
    int lo = 0, hi = tile;  // the last bin starting at or before s0
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (off[mid] <= s0) lo = mid; else hi = mid;
    }
    b0 = lo;
  }
  uint16_t nonempty[(kDfMaxTile + kDfThreads - 1) / kDfThreads];
#pragma unroll
  for (int u = 0; u < (kDfMaxTile + kDfThreads - 1) / kDfThreads; ++u) {
    const int b = tid + u * kDfThreads;
    nonempty[u] = b < tile && off[b + 1] > off[b];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < (kDfMaxTile + kDfThreads - 1) / kDfThreads; ++u) {
    const int b = tid + u * kDfThreads;
    if (b < tile) off[b] = nonempty[u];
  }
  __syncthreads();
  const int groups = scan_u16(off, tile, wsum);  // off[b]: the group index of bin b
  if (tid == 0) off[tile] = (uint16_t)groups;
  __syncthreads();
  const int g0 = off[b0];  // the group holding s0
  const uint64_t win = s0 < L ? ((uint64_t)starts[s0 >> 5] | (uint64_t)starts[(s0 >> 5) + 1] << 32) >> (s0 & 31)
                              : 0ull;
  const bool cont = s0 < L && !(win & 1ull);  // the slice opens inside a group
  const bool closes = s1 >= L || ((starts[s1 >> 5] >> (s1 & 31)) & 1u);  // its last group ends at s1 - 1

  int32_t* sums = reinterpret_cast<int32_t*>(smem + lay.vals_sums);
  for (; j < n_cols; j = full_column(p, j + 1)) {
    int32_t* out = out0 + (long long)j * p.capacity;
    const bool is_float = j < p.n_slots;
    if (kDeep) {
      store_column<kDfQuads>(next, rank, vals, len, 0);
    } else {
      for (int k0 = 0; k0 < kDfQuads; k0 += kDfBatch) {
        Quads<kDfBatch> c;
        load_column<kDfBatch>(p, j, r0, len, vec, k0, c);
        store_column<kDfBatch>(c, rank, vals, len, k0);
      }
    }
    __syncthreads();
    if (kDeep) {
      const int jn = full_column(p, j + 1);
      if (jn < n_cols) load_column<kDfQuads>(p, jn, r0, len, vec, 0, next);
    }
    // this slice in order: each group's sum from +0.0, written under its
    // group index when the group starts and ends inside the slice; the
    // group open at s0 (its head) waits for the carry
    int32_t acc = 0;
    int32_t head = 0;
    bool head_ends = false;
    bool own = false;  // the open group started inside the slice
    int g = g0;
#pragma unroll 4
    for (int i = 0; i < s1 - s0; ++i) {
      const bool st = (win >> i) & 1ull;
      const int32_t x = vals[s0 + i];
      const bool ended = st && i > 0;
      if (ended && own) sums[g] = acc;
      if (ended && !own) {
        head = acc;
        head_ends = true;
      }
      g += ended ? 1 : 0;
      own = own || st;
      acc = add(is_float, st ? 0 : acc, x);
    }
    int f = 1;
    int32_t tail = 0;
    if (s0 < s1) {
      if (closes) {
        if (own) sums[g] = acc;
        else {
          head = acc;
          head_ends = true;
        }
      } else {
        f = own ? 1 : 0;
        tail = acc;
      }
    }
    const int32_t carry = slice_carry(is_float, f, tail, sf, sv);
    if (head_ends) sums[g0] = add(is_float, carry, head);
    __syncthreads();
    for (int b = tid; b < tile; b += kDfThreads) {
      const int gi = off[b];
      out[b] = off[b + 1] > gi ? sums[gi] : 0;
    }
  }
}

// One block's f32 partial: its runs added in run order.
__device__ __forceinline__ float block_value(const Df32Params& p, int slot, long long b,
                                             long long g) {
  const int n_cols = p.n_slots + p.n_cnt;
  const int32_t* src = p.partial + (b * p.runs_per_block * n_cols + slot) * p.capacity + g;
  const long long stride = (long long)n_cols * p.capacity;
  float v = __int_as_float(src[0]);
  for (long long r = 1; r < p.runs_per_block; ++r) v = __fadd_rn(v, __int_as_float(src[r * stride]));
  return v;
}

// (h, l) <- the pair node of (h, l) on the left and (h2, l2) on the right,
// as the reference's tree: 2Sum of the hi words, lo = lo + lo2 + e.
__device__ __forceinline__ void merge(float& h, float& l, float h2, float l2) {
  float s, e;
  x32_ops::two_sum(h, h2, &s, &e);
  l = __fadd_rn(__fadd_rn(l, l2), e);
  h = s;
}

// A node of level I ending at leaf j into the register stack of kL levels:
// merged (the pending subtree on the left) with each full level, where j's
// bit is 1, and kept at the first empty one; (ch, cl) is then the subtree
// that ends at leaf j.  Level I is a template argument, so the stack stays
// in registers; j is warp-uniform, so the branches do not diverge.
template <int I, int kL>
__device__ __forceinline__ void push(float (&ph)[kL], float (&pl)[kL], long long j, float& ch,
                                     float& cl) {
  if constexpr (I < kL) {
    if ((j >> I) & 1) {
      float h = ph[I], l = pl[I];
      merge(h, l, ch, cl);
      ch = h;
      cl = l;
      push<I + 1, kL>(ph, pl, j, ch, cl);
    } else {
      ph[I] = ch;
      pl[I] = cl;
    }
  }
}

// The pairwise 2Sum tree of one slot for group g over the pow2 block count:
// this thread's chunk [c * M, (c + 1) * M) (M <= 2^kL): four leaves at a
// time into a level-2 node, each node into a register stack; then the K
// chunks across the CTA (threads c * G + gl, c = 0 the result).
template <int kL>
__device__ __forceinline__ void block_tree(const Df32Params& p, int slot, long long g, bool ok,
                                           int c, int G, int K, long long M, float* sh, float* sl,
                                           float* hi, float* lo) {
  const long long first = c * M;
  auto leaf = [&](long long j) {
    return ok && first + j < p.n_real ? block_value(p, slot, first + j, g) : 0.0f;
  };
  float ch = leaf(0), cl = 0.0f;
  if (M == 2) {
    merge(ch, cl, leaf(1), 0.0f);
  } else if (M >= 4) {
    float ph[kL], pl[kL];
    for (long long j0 = 0; j0 < M; j0 += 4) {
      float h[4], l[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        h[u] = leaf(j0 + u);
        l[u] = 0.0f;
      }
      merge(h[0], l[0], h[1], l[1]);
      merge(h[2], l[2], h[3], l[3]);
      merge(h[0], l[0], h[2], l[2]);
      ch = h[0];
      cl = l[0];
      push<2, kL>(ph, pl, j0, ch, cl);
    }
  }
  const int t = threadIdx.x;
  sh[t] = ch;
  sl[t] = cl;
  for (int s = 1; s < K; s <<= 1) {
    __syncthreads();
    if ((c & (2 * s - 1)) == 0) {
      float h = sh[t], l = sl[t];
      merge(h, l, sh[t + s * G], sl[t + s * G]);
      sh[t] = h;
      sl[t] = l;
    }
  }
  __syncthreads();
  *hi = sh[t];
  *lo = sl[t];
  __syncthreads();
}

// kL: the register stack's levels.
template <int kL>
__global__ void __launch_bounds__(kDfCombineThreads) df32_combine(const __grid_constant__ Df32Params p,
                                                                  int G) {
  __shared__ float sh[kDfCombineThreads], sl[kDfCombineThreads];
  const int t = threadIdx.x;
  const int K = blockDim.x / G;
  const int gl = t % G;
  const int c = t / G;
  const long long stripes = (p.capacity + G - 1) / G;
  const long long row = blockIdx.x / stripes;
  const long long g = (blockIdx.x - row * stripes) * G + gl;
  const bool ok = g < p.capacity;
  const long long M = p.nb / K;
  if (row < p.n_out) {
    float hi, lo;
    block_tree<kL>(p, p.out_a[row], g, ok, c, G, K, M, sh, sl, &hi, &lo);
    if (p.out_b[row] >= 0) {
      float hb, lb;
      block_tree<kL>(p, p.out_b[row], g, ok, c, G, K, M, sh, sl, &hb, &lb);
      merge(hi, lo, hb, lb);
    }
    if (c == 0 && ok) {
      p.hi[row * p.capacity + g] = hi;
      p.lo[row * p.capacity + g] = lo;
    }
    return;
  }
  const long long cr = row - p.n_out;
  const int n_cols = p.n_slots + p.n_cnt;
  const long long runs = p.n_real * p.runs_per_block;
  uint32_t acc = 0;
  if (ok) {
    const int32_t* src = p.partial + (p.n_slots + cr) * p.capacity + g;
    for (long long r = c * M * p.runs_per_block; r < min(runs, (c + 1) * M * p.runs_per_block);
         ++r) {
      acc += (uint32_t)src[r * n_cols * p.capacity];
    }
  }
  uint32_t* su = reinterpret_cast<uint32_t*>(sh);
  su[t] = acc;
  for (int s = 1; s < K; s <<= 1) {
    __syncthreads();
    if ((c & (2 * s - 1)) == 0) su[t] += su[t + s * G];
  }
  if (c == 0 && ok) p.cnt[cr * p.capacity + g] = (int32_t)su[t];
}

// Lets a pass-1 instantiation take the most dynamic shared memory, once a
// device (a benign race: every caller sets the same value).
template <bool kDeep>
cudaError_t allow_smem() {
  static bool done[kDfMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kDfMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(df32_partial<kDeep>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDfSmemMax);
  if (err == cudaSuccess && dev < kDfMaxDevices) done[dev] = true;
  return err;
}

}  // namespace

extern "C" void df32_agg_plan(Df32Params* p) {
  p->runs_per_block = (p->block + kDfRunRows - 1) / kDfRunRows;
  p->run_rows = (p->block + p->runs_per_block - 1) / p->runs_per_block;
  p->tile = (int)(p->capacity < kDfMaxTile ? p->capacity : kDfMaxTile);
  int w = kDfMaxRankWarps;
  while (w > 1 && Smem(p->run_rows, p->tile, w).total > kDfSmemMax) w >>= 1;
  p->rank_warps = w;
  p->smem = (int)Smem(p->run_rows, p->tile, w).total;
  auto aligned = [](const void* a, uintptr_t to) { return ((uintptr_t)a % to) == 0; };
  bool vec = p->block % 4 == 0 && p->run_rows % 4 == 0 && aligned(p->gid, 16) &&
             aligned(p->tail, 4) && aligned(p->pred, 4) && aligned(p->pvalid, 4);
  for (int j = 0; j < p->n_slots; ++j) {
    vec = vec && aligned(p->values[p->slot_col[j]], 16) && aligned(p->valids[p->slot_col[j]], 4);
  }
  for (int j = 0; j < p->n_cnt; ++j) {
    vec = vec && (p->cnt_col[j] < 0 || aligned(p->valids[p->cnt_col[j]], 4));
  }
  p->vec = vec ? 1 : 0;
}

extern "C" cudaError_t df32_agg_launch(const Df32Params* params, cudaStream_t stream) {
  const Df32Params& p = *params;
  const int n_cols = p.n_slots + p.n_cnt;
  if (n_cols == 0 || p.capacity == 0) return cudaSuccess;
  cudaError_t err;
  if (p.n_real > 0) {
    // two CTAs an SM where their shared memory fits (1 KB each reserved)
    const bool deep = 2 * (p.smem + 1024) > kDfSmemSm;
    const auto kernel = deep ? df32_partial<true> : df32_partial<false>;
    err = deep ? allow_smem<true>() : allow_smem<false>();
    if (err != cudaSuccess) return err;
    const long long tiles = (p.capacity + p.tile - 1) / p.tile;
    dim3 grid((unsigned)(p.n_real * p.runs_per_block), (unsigned)tiles);
    kernel<<<grid, kDfThreads, p.smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long rows = p.n_out + p.n_cnt;
  int G = 32;
  while (G > 1 && rows * ((p.capacity + G - 1) / G) < kDfCombineFill) G >>= 1;
  const long long K = (long long)kDfCombineThreads / G < p.nb ? kDfCombineThreads / G : p.nb;
  const long long grid = rows * ((p.capacity + G - 1) / G);
  const auto combine = p.nb / K <= (1LL << kDfShortLevels) ? df32_combine<kDfShortLevels>
                                                           : df32_combine<kDfMaxLevels>;
  combine<<<(unsigned)grid, (unsigned)(G * K), 0, stream>>>(p, G);
  return cudaGetLastError();
}
