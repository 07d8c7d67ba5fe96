// Device bodies of the segment aggregate (B1), shared by its one-batch
// kernel (segment_agg.cu) and its multi-entry kernel
// (segment_agg_entries.cu), so both fold every row in the same order.
//
// Bound: bytes.  Each row's group id, masks and the columns its distinct
// folds read are read once, at every capacity up to kSegAggMaxTile (8192,
// the widest the scatter route takes on the card); past it (a forced
// scatter route only) each group tile re-reads the rows.
//
// The run rule.  A batch (or an entry) of n rows is cut into runs of
// kSegAggRunRows rows, R = ceil(n / kSegAggRunRows), and the runs into C
// chunks of consecutive runs: C = min(R, kSegAggChunksPerSm x the card's
// SMs, the chunks whose [n_folds, capacity] partials fit
// kSegAggScratchBudget, 65535), ceil(R / C) runs a chunk, the last chunk
// shorter (segment_agg_plan).  One CTA folds one chunk for one group tile,
// one CTA an SM.  A batch of one run (R = 1) is folded into the state by
// pass 1 alone: one launch, no scratch.
//
// The fold order.  Fields that fold the same column by the same op (and
// counts of the same validity; a column without one counts the row mask)
// give the same bits, so the wrapper maps the fields to their distinct
// folds and each fold runs once.  For a run the CTA:
//   - computes each row's key (its group within the tile, or
//     kSegAggDead) from its group id (staged in shared memory by cp.async
//     while the run before folded) and masks;
//   - ranks the live rows by a stable counting sort: each of W rank warps
//     walks its contiguous rows 32 at a time, and the lanes of one key find
//     each other by ballots of the key's bits (no __match_any_sync); a
//     row's rank is its bin's start, the rows of its bin in earlier rank
//     warps and the lanes of its step below it.  So the ranks follow row
//     order within each group, and no atomic touches a value;
//   - per distinct fold (the op a template argument: no switch inside a
//     loop): stores each live row's contribution, loaded into registers a
//     fold ahead (one coalesced read of the column), at its rank; folds a
//     fixed contiguous slice of the sorted positions in each thread, each
//     group from the op's identity, the positions between two group starts
//     in a tight loop; joins the pieces of groups that cross slices by a
//     segmented scan in a fixed shuffle tree; emits each group's result
//     once.  A count of the row mask is its bin's size (no gather).
// The first run of a chunk writes its partial (every group, the identity
// where it has no rows); a later run folds into it (partial, then run)
// where the group has rows; the partial stays in shared memory while it
// fits kSegAggAccWords.  Pass 2 folds each state word with the chunk
// partials in chunk order (merge_word).  A direct run folds state, then
// run, in pass 1: the same combine on the same words as pass 2 over one
// partial.  Every fold runs in a fixed order, so two launches give
// identical bits, and an f64 sum that is NaN is the one quiet NaN word
// (agg_ops.cuh): the add's NaN operand order is the compiler's.  No float
// atomics anywhere.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "agg_ops.cuh"
#include "segment_agg.h"

namespace seg_agg {

using agg_ops::canon_of;
using agg_ops::combine_of;
using agg_ops::identity_of;
using agg_ops::raw_of;

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Pass 1's shared memory at fixed byte offsets, so that every array is
// one base register and an immediate.  rank, off (each bin's start, then
// the live rows), the bitmask of group starts among the sorted positions,
// the scan scratch, the chunk accumulator (a chunk's partial, kept here
// while it folds its runs where n_folds x tile fits kSegAggAccWords) and
// the staged group ids of the next run stay; the union holds key + the
// rank warps' bin counters while ranking, then the sorted contributions of
// one fold.
namespace lay {
constexpr int kRank = 0;                                               // uint16 [run rows]
constexpr int kOff = kRank + 2 * kSegAggRunRows;                       // uint16 [tile + 1]
constexpr int kStarts = kOff + align16(2 * (kSegAggMaxTile + 1));      // uint32 [rows / 32 + 2]
constexpr int kScan = kStarts + align16(4 * (kSegAggRunRows / 32 + 2));
constexpr int kAcc = kScan + align16(kSegAggWarps * (4 + 4 + 8));      // long long [acc words]
constexpr int kU = kAcc + 8 * kSegAggAccWords;                         // the union
constexpr int kHist = kU + 2 * kSegAggRunRows;                         // uint16 [rank warp][tile]
constexpr int kGid = kU + 8 * kSegAggRunRows;                          // int32 [run rows], staged
constexpr int kTotal = kGid + 4 * kSegAggRunRows;
}  // namespace lay
static_assert(lay::kTotal <= kSegAggSmemMax, "pass 1's shared memory");

// Rank warps whose bin counters fit beside the keys in the union.
__host__ __device__ inline int rank_warps(int tile) {
  int w = kSegAggWarps;
  while (w > 1 && lay::kHist + 2 * w * tile > lay::kGid) w >>= 1;
  return w;
}

// Whether the chunk's partial stays in shared memory while it folds its runs.
__host__ __device__ inline bool acc_in_smem(int n_folds, int tile) {
  return n_folds * tile <= kSegAggAccWords;
}

// Whether fold k gathers a column (a count of the row mask does not).
__device__ __forceinline__ bool gathers(const SegAggParams& p, int k) {
  const int c = p.fold_cols[k];
  return p.fold_ops[k] != SA_COUNT || (c >= 0 && p.valids[c] != nullptr);
}

// a[0, E) replaced by its exclusive prefix sums (each warp scans a
// contiguous segment); returns the total.
static __device__ int scan_u16(uint16_t* a, int E, uint32_t* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = ((E + kSegAggWarps - 1) / kSegAggWarps + 31) / 32 * 32;
  const int e0 = min(E, warp * seg);
  const int e1 = min(E, e0 + seg);
  uint32_t s = 0;
  for (int e = e0 + lane; e < e1; e += 32) s += a[e];
  s = __reduce_add_sync(kFull, s);
  if (lane == 0) wsum[warp] = s;
  __syncthreads();
  uint32_t carry = 0, total = 0;
  for (int w = 0; w < kSegAggWarps; ++w) {
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
// the slice (the value is then its last group's piece).  A fixed tree:
// shuffles within a warp, then the same over the warps' totals.
template <int kOp>
__device__ long long slice_carry(int f, long long v, int* sf, long long* sv) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int fo = __shfl_up_sync(kFull, f, d);
    const long long vo = __shfl_up_sync(kFull, v, d);
    if (lane >= d) {
      v = f ? v : combine_of<kOp>(vo, v);
      f |= fo;
    }
  }
  if (lane == 31) {
    sf[warp] = f;
    sv[warp] = v;
  }
  __syncthreads();
  // the earlier warps' piece: the same scan over the warps' totals (lane w
  // holds warp w's), read at lane warp - 1
  int fw = lane < kSegAggWarps ? sf[lane] : 1;
  long long vw = lane < kSegAggWarps ? sv[lane] : identity_of<kOp>();
  for (int d = 1; d < kSegAggWarps; d <<= 1) {
    const int fo = __shfl_up_sync(kFull, fw, d);
    const long long vo = __shfl_up_sync(kFull, vw, d);
    if (lane >= d) {
      vw = fw ? vw : combine_of<kOp>(vo, vw);
      fw |= fo;
    }
  }
  const long long wv = __shfl_sync(kFull, vw, max(warp - 1, 0));  // unused by warp 0
  const int fe = __shfl_up_sync(kFull, f, 1);
  const long long ve = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) return wv;
  return (fe || warp == 0) ? ve : combine_of<kOp>(wv, ve);
}

// A thread's rows of a run in the gather: warp w's rows [w * 512, w * 512
// + 512), 32 contiguous rows a step (a warp's load is 256 contiguous bytes).
constexpr int kSteps = kSegAggRunRows / kSegAggWarps / 32;

__device__ __forceinline__ int step_row(int j) {
  return (threadIdx.x >> 5) * (kSegAggRunRows / kSegAggWarps) + 32 * j + (threadIdx.x & 31);
}

// One gathered fold's column over a thread's rows of a run, in registers:
// its words (none for a count) and its validity (true where it has none),
// loaded a fold ahead of its use.
struct Column {
  long long v[kSteps];
  bool ok[kSteps];
};

// Issues the loads of fold k's column over rows [r0, r0 + len) (every row:
// the ranks are not needed to load).
__device__ __forceinline__ void load_column(const SegAggParams& p, int k, long long r0, int len,
                                            Column& c) {
  const int col = p.fold_cols[k];
  const long long* x =
      p.fold_ops[k] == SA_COUNT ? nullptr : static_cast<const long long*>(p.values[col]);
  const bool* valid = p.valids[col];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int i = step_row(j);
    c.v[j] = x != nullptr && i < len ? __ldg(x + r0 + i) : 0;
    c.ok[j] = valid == nullptr || i >= len || valid[r0 + i];
  }
}

// The first fold from k on that gathers a column, or n_folds.
__device__ __forceinline__ int next_gathered(const SegAggParams& p, int k) {
  while (k < p.n_folds && !gathers(p, k)) ++k;
  return k;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Copies the group ids of rows [r0, r0 + len) into shared memory without
// waiting (cp.async: the next run's, issued while this run folds): 16
// bytes a copy where the ids' words allow it, else 4.
__device__ __forceinline__ void stage_gid(const SegAggParams& p, long long r0, int len,
                                          int32_t* gid) {
  const int quads = p.vec ? len / 4 : 0;
  for (int q = threadIdx.x; q < quads; q += kSegAggThreads) {
    cp_async16(gid + 4 * q, p.gid + r0 + 4 * q);
  }
  for (int i = 4 * quads + threadIdx.x; i < len; i += kSegAggThreads) {
    cp_async4(gid + i, p.gid + r0 + i);
  }
}

// Rows [row, row + 4) of a bool array as the four bytes of a word (null:
// all 1; 0 past ``avail``): one 4-byte load where the run allows it.
__device__ __forceinline__ uint32_t mask4(const bool* a, long long row, int avail, bool vec) {
  if (a == nullptr) return 0x01010101u;
  if (vec && avail >= 4) return __ldg(reinterpret_cast<const uint32_t*>(a + row));
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) w |= (e < avail && a[row + e]) ? 1u << (8 * e) : 0u;
  return w;
}

// This thread's slice of a run's sorted positions.
struct Slice {
  int s0, s1;      // [s0, s1)
  int b0;          // the bin of the group open at s0
  uint64_t win;    // group-start bits from s0 on
  bool closes;     // the slice's last group ends at s1 - 1
};

// Where a run's group results go: fold k's row of the chunk's partial
// (``part + k * ld + off``: the shared-memory accumulator, or global
// scratch at the tile's groups), written by the chunk's first run and
// folded into (partial, then run) by a later one; or, direct (``part``
// null), every state field of fold k at group t0 + bin (state, then run).
struct Sink {
  long long* part;
  long long ld;   // words between two folds' rows
  long long off;  // the tile's first group in a row
  long long t0;   // the tile's first group
  bool first;     // the chunk's first run: every bin written
};

// The last bin in [lo, tile) whose start is at or before ``pos`` (off[lo]
// must be): for a group's start position, the group's bin.
__device__ __forceinline__ int bin_of(const uint16_t* off, int pos, int lo, int tile) {
  int hi = tile;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= pos) lo = mid; else hi = mid;
  }
  return lo;
}

template <int kOp>
__device__ __forceinline__ void emit(const SegAggParams& p, int k, int b, long long x,
                                     const Sink& s) {
  if (s.part == nullptr) {
    const long long g = s.t0 + b;
    const int f1 = p.fold_first[k + 1];
    for (int j0 = p.fold_first[k]; j0 < f1; j0 += 8) {  // the loads of 8 fields at once
      long long v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j0 + j < f1) v[j] = p.state[(long long)p.fold_fields[j0 + j] * p.capacity + g];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j0 + j < f1) {
          p.state[(long long)p.fold_fields[j0 + j] * p.capacity + g] = combine_of<kOp>(v[j], x);
        }
      }
    }
    return;
  }
  long long* q = s.part + (long long)k * s.ld + s.off + b;
  *q = s.first ? x : combine_of<kOp>(*q, x);
}

// The empty bins' identity, where every bin takes a word (a chunk's first
// run, or direct).
template <int kOp>
__device__ __forceinline__ void emit_empty(const SegAggParams& p, int k, const uint16_t* off,
                                           int tile, const Sink& s) {
  if (s.part != nullptr && !s.first) return;
  for (int b = threadIdx.x; b < tile; b += kSegAggThreads) {
    if (off[b + 1] == off[b]) emit<kOp>(p, k, b, identity_of<kOp>(), s);
  }
}

// One distinct fold of one run: gather the live rows' contributions to
// their ranks, fold each slice, join the slices, emit each group once.
template <int kOp>
__device__ void fold_run(const SegAggParams& p, int k, const uint16_t* rank,
                         const uint16_t* off, long long* vals, const Slice& sl, int* sf,
                         long long* sv, int tile, int len, const Sink& sink, Column& col,
                         int next_k, long long next_r0, int next_len) {
  // each live row's contribution (the identity, or for a count 0, where
  // its validity is off) to its rank; then the next gathered fold's loads
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int i = step_row(j);
    const unsigned r = i < len ? rank[i] : kSegAggDead;
    if (r == kSegAggDead) continue;
    if constexpr (kOp == SA_COUNT) vals[r] = col.ok[j] ? 1 : 0;
    else vals[r] = col.ok[j] ? col.v[j] : identity_of<kOp>();
  }
  __syncthreads();
  if (next_k < p.n_folds) load_column(p, next_k, next_r0, next_len, col);

  // this slice in order: each group from the identity, emitted when it
  // starts and ends inside the slice; the group open at s0 (the head)
  // waits for the carry.  The positions between two group starts fold in
  // a tight loop.
  long long acc = identity_of<kOp>();
  long long head = acc;
  bool head_ends = false;
  bool own = false;  // the open group started inside the slice
  int gb = sl.b0;    // its bin
  const int n = sl.s1 - sl.s0;
  const long long* xs = vals + sl.s0;
  uint64_t w = n > 0 ? sl.win & ((2ull << (n - 1)) - 1ull) : 0ull;  // the starts inside the slice
  int i = 0;
  for (;;) {
    const int e = w ? __ffsll((long long)w) - 1 : n;  // the next start, or the slice's end
    {  // two chains (even and odd positions), then their sum: half the dependent adds
      long long a1 = identity_of<kOp>();
#pragma unroll 2
      for (; i + 1 < e; i += 2) {
        acc = raw_of<kOp>(acc, xs[i]);
        a1 = raw_of<kOp>(a1, xs[i + 1]);
      }
      if (i < e) acc = raw_of<kOp>(acc, xs[i++]);
      acc = canon_of<kOp>(raw_of<kOp>(acc, a1));
    }
    if (e >= n) break;
    if (e > 0) {  // the group before ends at e - 1
      if (own) {
        emit<kOp>(p, k, gb, acc, sink);
      } else {
        head = acc;
        head_ends = true;
      }
      gb = bin_of(off, sl.s0 + e, gb, tile);
    }
    own = true;
    acc = identity_of<kOp>();
    w &= w - 1ull;
  }
  int f = 1;
  long long tail = identity_of<kOp>();
  if (sl.s0 < sl.s1) {
    if (sl.closes) {
      if (own) {
        emit<kOp>(p, k, gb, acc, sink);
      } else {
        head = acc;
        head_ends = true;
      }
    } else {
      f = own ? 1 : 0;
      tail = acc;
    }
  }
  // after its barrier every thread is done with vals: the next fold's
  // gather may overwrite them
  const long long carry = slice_carry<kOp>(f, tail, sf, sv);
  if (head_ends) emit<kOp>(p, k, sl.b0, combine_of<kOp>(carry, head), sink);
  emit_empty<kOp>(p, k, off, tile, sink);
}

// Pass 1 of one CTA: chunk rows [c0, c1) (whole runs from c0) for the group
// tile starting at t0, into the chunk's partial ``out`` ([n_folds,
// capacity]) or, when ``out`` is null, into the state.
static __device__ void chunk_pass(const SegAggParams& p, long long c0, long long c1, long long t0,
                                  long long* out, unsigned char* smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = (int)min((long long)p.tile, p.capacity - t0);
  const int W = p.rank_warps;
  uint16_t* rank = reinterpret_cast<uint16_t*>(smem + lay::kRank);
  uint16_t* off = reinterpret_cast<uint16_t*>(smem + lay::kOff);
  uint32_t* starts = reinterpret_cast<uint32_t*>(smem + lay::kStarts);
  int* sf = reinterpret_cast<int*>(smem + lay::kScan);
  uint32_t* wsum = reinterpret_cast<uint32_t*>(sf + kSegAggWarps);
  long long* sv = reinterpret_cast<long long*>(wsum + kSegAggWarps);
  uint16_t* key = reinterpret_cast<uint16_t*>(smem + lay::kU);
  uint16_t* hist = reinterpret_cast<uint16_t*>(smem + lay::kHist);  // [rank warp][bin]
  uint32_t* hist32 = reinterpret_cast<uint32_t*>(hist);
  long long* vals = reinterpret_cast<long long*>(smem + lay::kU);
  int32_t* sgid = reinterpret_cast<int32_t*>(smem + lay::kGid);
  const int nbits = 32 - __clz(tile - 1);  // bits of the largest key (0 for one group)
  const unsigned lt = (1u << lane) - 1u;
  Column col;  // the next gathered fold's column, loaded a fold ahead
  bool col_ahead = false;  // col holds this run's first gathered column
  // the chunk's partial: in shared memory where it fits (copied out at the
  // end), else in place in global scratch
  const bool in_smem = out != nullptr && acc_in_smem(p.n_folds, p.tile);
  Sink sink;
  sink.part = in_smem ? reinterpret_cast<long long*>(smem + lay::kAcc) : out;
  sink.ld = in_smem ? tile : p.capacity;
  sink.off = in_smem ? 0 : t0;
  sink.t0 = t0;

  for (long long r0 = c0; r0 < c1; r0 += kSegAggRunRows) {
    const int len = (int)min((long long)kSegAggRunRows, c1 - r0);
    sink.first = r0 == c0;
    for (int e = tid; e < (W * tile + 1) / 2; e += kSegAggThreads) hist32[e] = 0u;
    for (int w = tid; w < kSegAggRunRows / 32 + 2; w += kSegAggThreads) starts[w] = 0u;
    const int g0 = next_gathered(p, 0);
    if (!col_ahead && g0 < p.n_folds) load_column(p, g0, r0, len, col);
    col_ahead = false;
    // keys: the group within the tile, or kSegAggDead, from the staged ids
    // (the first run's staged now, a later run's while the run before it
    // folded) and the masks
    if (sink.first) stage_gid(p, r0, len, sgid);
    const bool vec = p.vec != 0;
    uint32_t m[kSegAggQuads];
#pragma unroll
    for (int u = 0; u < kSegAggQuads; ++u) {
      const int i = 4 * (tid + u * kSegAggThreads);
      const int avail = len - i;
      m[u] = avail > 0 ? mask4(p.tail, r0 + i, avail, vec) & mask4(p.pred, r0 + i, avail, vec) &
                             mask4(p.pvalid, r0 + i, avail, vec)
                       : 0u;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kSegAggQuads; ++u) {
      const int i = 4 * (tid + u * kSegAggThreads);
      if (i >= len) continue;
      const int4 g = *reinterpret_cast<const int4*>(sgid + i);
      const int gg[4] = {g.x, g.y, g.z, g.w};
      uint32_t kk[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long kv = (long long)gg[e] - t0;
        const bool on = i + e < len && ((m[u] >> (8 * e)) & 0xffu) && kv >= 0 && kv < tile;
        kk[e] = on ? (uint32_t)kv : kSegAggDead;
      }
      *reinterpret_cast<uint2*>(key + i) = make_uint2(kk[0] | kk[1] << 16, kk[2] | kk[3] << 16);
    }
    __syncthreads();
    if (r0 + kSegAggRunRows < c1) {  // the next run's ids, while this one folds
      stage_gid(p, r0 + kSegAggRunRows, (int)min((long long)kSegAggRunRows, c1 - r0 - kSegAggRunRows),
                sgid);
    }
    // each rank warp's rows in order: a row's rank among its warp's rows of
    // its bin, each warp's count of each bin
    const int rw = (len + W * 32 - 1) / (W * 32) * 32;
    if (warp < W) {
      const int w0 = min(len, warp * rw);
      const int w1 = min(len, w0 + rw);
      uint16_t* h = hist + warp * tile;
      for (int base = w0; base < w1; base += 32) {
        const int i = base + lane;
        const unsigned k = i < w1 ? key[i] : kSegAggDead;
        const bool live = k != kSegAggDead;
        unsigned peers = __ballot_sync(kFull, live);  // the live lanes of k
        for (int b = 0; b < nbits; ++b) {
          const bool bit = (k >> b) & 1u;
          const unsigned bal = __ballot_sync(kFull, bit);
          peers &= bit ? bal : ~bal;
        }
        unsigned r = kSegAggDead;
        if (live) r = h[k] + __popc(peers & lt);
        __syncwarp();
        if (live && (peers & lt) == 0u) h[k] += (uint16_t)__popc(peers);
        if (i < w1) rank[i] = (uint16_t)r;
        __syncwarp();
      }
    }
    __syncthreads();
    // each bin's counters to their exclusive prefix over the rank warps, its
    // size to off; then off to the bins' starts
    for (int b = tid; b < tile; b += kSegAggThreads) {
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
    if (warp < W) {  // each rank warp's rows: their bin's start and the earlier warps' rows
      const int w1 = min(len, min(len, warp * rw) + rw);
      const uint16_t* h = hist + warp * tile;
      for (int i = min(len, warp * rw) + lane; i < w1; i += 32) {
        const unsigned k = key[i];
        if (k != kSegAggDead) rank[i] += off[k] + h[k];
      }
    }
    for (int b = tid; b < tile; b += kSegAggThreads) {
      const int o = off[b];
      if (off[b + 1] > o) atomicOr(&starts[o >> 5], 1u << (o & 31));
    }
    __syncthreads();
    if (L == 0 && !sink.first && out != nullptr) continue;  // nothing to fold in

    // this thread's slice of the sorted positions (an odd length: the
    // lanes' 8-byte reads spread over the banks) and the group open at s0
    Slice sl;
    const int S = (L + kSegAggThreads - 1) / kSegAggThreads | 1;
    sl.s0 = min(L, tid * S);
    sl.s1 = min(L, sl.s0 + S);
    sl.b0 = 0;
    sl.win = 0ull;
    sl.closes = true;
    if (sl.s0 < L) {
      sl.b0 = bin_of(off, sl.s0, 0, tile);
      sl.win = ((uint64_t)starts[sl.s0 >> 5] | (uint64_t)starts[(sl.s0 >> 5) + 1] << 32) >>
               (sl.s0 & 31);
      sl.closes = sl.s1 >= L || ((starts[sl.s1 >> 5] >> (sl.s1 & 31)) & 1u);
    }

    for (int k = 0; k < p.n_folds; ++k) {
      if (!gathers(p, k)) {  // a count of the row mask: the bins' sizes
        for (int b = tid; b < tile; b += kSegAggThreads) {
          const int c = (int)off[b + 1] - (int)off[b];
          if (c > 0 || out == nullptr || sink.first) emit<SA_COUNT>(p, k, b, c, sink);
        }
        continue;
      }
      // the next gathered fold: this run's, else the next run's first
      int nk = next_gathered(p, k + 1);
      long long nr0 = r0;
      int nlen = len;
      if (nk >= p.n_folds && r0 + kSegAggRunRows < c1) {
        nk = g0;
        nr0 = r0 + kSegAggRunRows;
        nlen = (int)min((long long)kSegAggRunRows, c1 - nr0);
        col_ahead = true;
      }
#define SEG_AGG_FOLD(OP) \
  fold_run<OP>(p, k, rank, off, vals, sl, sf, sv, tile, len, sink, col, nk, nr0, nlen)
      switch (p.fold_ops[k]) {
        case SA_COUNT: SEG_AGG_FOLD(SA_COUNT); break;
        case SA_ADD_F64: SEG_AGG_FOLD(SA_ADD_F64); break;
        case SA_ADD_I64: SEG_AGG_FOLD(SA_ADD_I64); break;
        case SA_MIN_F64: SEG_AGG_FOLD(SA_MIN_F64); break;
        case SA_MAX_F64: SEG_AGG_FOLD(SA_MAX_F64); break;
        case SA_MIN_I64: SEG_AGG_FOLD(SA_MIN_I64); break;
        default: SEG_AGG_FOLD(SA_MAX_I64); break;
      }
#undef SEG_AGG_FOLD
    }
    __syncthreads();  // the next run's keys overwrite the sorted values
  }
  if (in_smem) {  // the chunk's partial to its scratch
    __syncthreads();
    const long long* a = sink.part;
    for (int i = tid; i < p.n_folds * tile; i += kSegAggThreads) {
      const int k = i / tile;
      out[(long long)k * p.capacity + t0 + (i - k * tile)] = a[i];
    }
  }
}

// ``acc`` (a state word) folded with the n chunk partials at ``src``
// (``stride`` words apart) in chunk order; the next 8 partials' loads are
// in flight while the current 8 fold.
template <int kOp>
__device__ __forceinline__ long long merge_chain(long long acc, const long long* src,
                                                 long long stride, int n) {
  constexpr int kU = 8;
  long long x[kU];
#pragma unroll
  for (int j = 0; j < kU; ++j) x[j] = j < n ? src[(long long)j * stride] : 0;
  for (int c = 0; c < n; c += kU) {
    long long y[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j) y[j] = c + kU + j < n ? src[(long long)(c + kU + j) * stride] : 0;
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      if (c + j < n) acc = combine_of<kOp>(acc, x[j]);
    }
#pragma unroll
    for (int j = 0; j < kU; ++j) x[j] = y[j];
  }
  return acc;
}

// Pass 2 for word i of the state ([n_fields, capacity] flattened): the
// state, then the p.n_chunks partials of p.partial in chunk order.
__device__ __forceinline__ void merge_word(const SegAggParams& p, long long i) {
  const int f = (int)(i / p.capacity);
  const long long g = i - (long long)f * p.capacity;
  const long long* src = p.partial + (long long)p.field_fold[f] * p.capacity + g;
  const long long stride = (long long)p.n_folds * p.capacity;
  long long acc = p.state[i];
  switch (p.ops[f]) {
    case SA_ADD_F64: acc = merge_chain<SA_ADD_F64>(acc, src, stride, p.n_chunks); break;
    case SA_MIN_F64: acc = merge_chain<SA_MIN_F64>(acc, src, stride, p.n_chunks); break;
    case SA_MAX_F64: acc = merge_chain<SA_MAX_F64>(acc, src, stride, p.n_chunks); break;
    case SA_MIN_I64: acc = merge_chain<SA_MIN_I64>(acc, src, stride, p.n_chunks); break;
    case SA_MAX_I64: acc = merge_chain<SA_MAX_I64>(acc, src, stride, p.n_chunks); break;
    default: acc = merge_chain<SA_ADD_I64>(acc, src, stride, p.n_chunks); break;  // counts too
  }
  p.state[i] = acc;
}

}  // namespace seg_agg
