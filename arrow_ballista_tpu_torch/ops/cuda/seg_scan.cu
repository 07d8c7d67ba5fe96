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
// Bound: bytes (perm, the flags or keys, every column's gather through
// perm, the outputs); a gather through a random permutation costs a 32-byte
// sector for each 8-byte word.  Design: one launch.  A CTA takes tiles of
// T = 256 x R consecutive scan positions from an atomic ticket (so a tile
// waits only on tiles that have started), R from the column count
// (seg_scan.h:scan_plan), and for each tile:
//   1. reads perm, then the keys or flags and every column's element
//      through perm, once and coalesced, into shared memory;
//   2. scans each column within the tile from shared memory: R positions a
//      thread in registers, then warp shuffles of the (value, starts)
//      operator, with the op fixed at compile time (no switch in a row
//      loop); each warp's total goes to shared memory and each warp's
//      prefix is the left fold of the warps before it;
//   3. publishes the tile's total of every column, then looks back for its
//      carry: the nearest earlier tile that has published its inclusive
//      prefix (a tile that holds a segment start publishes it at once),
//      then a left fold, in tile order, of the totals of the tiles after
//      it (read 128 tiles a round into shared memory, folded by one lane a
//      column).  An inclusive prefix is itself that fold, so the carry's
//      bits do not depend on which tile was ready first, and two runs give
//      the same bits.  A published word goes out as two halves under the
//      call's tag (put_word), so no fence orders it before its status word;
//   4. writes each position's value (carry, warp prefix and local scan)
//      coalesced, or, for the sorted aggregate, merges each segment's
//      total at its last row into the running state (one thread owns each
//      segment end, so no two writes meet).
// The status words persist across calls (the binding keeps them for each
// stream) and carry the call's tag, so a call clears nothing; the last CTA
// to finish resets the ticket.  Integer atomics only hand out tiles; no
// library scan is called.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "agg_ops.cuh"
#include "seg_scan.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kScanThreads / 32;
constexpr unsigned kAgg = 1;  // status: the tile's total is published
constexpr unsigned kInc = 2;  // status: its inclusive prefix is published
constexpr int kNone = 0x7fffffff;  // no segment starts
constexpr int kMaxDevices = 64;

// How a column's element is read (one loop per kind; seg_scan.h ScanSrc
// and ScanWidth).
enum LoadKind : int {
  LK_IOTA, LK_AUX, LK_COUNT, LK_WORD, LK_I64_F64, LK_F32_F64, LK_F32_DF,
  LK_I32, LK_F32_PAIR, LK_ORD_PAIR,
};

struct ScanArgs {
  SegScanParams p;
  unsigned* ticket;  // [0] the next tile, [1] the CTAs that have finished
  unsigned* status;  // [n_tiles]: tag << 2 | kAgg or kInc
  // [n_tiles][n_cols][2] each tile's total and inclusive prefix, a column's
  // word as two tagged halves (put_word)
  unsigned long long* agg;
  unsigned long long* inc;
  long long n_tiles;
  int rows;          // R
  int tile;          // T
  int8_t kind[kScanMaxCols];    // LoadKind
  long long ident[kScanMaxCols];  // the fold's identity (a null's element)
};

// The fixed part of a CTA's shared memory (kScanFixedBytes).
struct ScanShared {
  long long wv[kScanMaxCols][kWarps];   // each warp's inclusive total
  long long wex[kScanMaxCols][kWarps];  // the fold of the warps before it
  long long agg[kScanMaxCols];          // the tile's total
  long long carry[kScanMaxCols];        // the fold of the tiles before it
  int fsw[kWarps];                      // each warp's first start (tile position)
  int nb_perm[2];                       // perm at positions P0 - 1 and P0 + live
  long long tile;
  int fs;                               // the tile's first start
  int carry_on;                         // the carry applies before fs
};
static_assert(sizeof(ScanShared) <= kScanFixedBytes, "fixed shared region");

// ---------------------------------------------------------------- folds
// agg_ops::combine with the op fixed at compile time (the same arithmetic,
// so the same bits: a NaN sum keeps the add's own NaN, as there).
template <int kOp>
__device__ __forceinline__ long long comb(long long a, long long b) {
  using namespace agg_ops;
  if constexpr (kOp == SA_DF32) {
    return df32_combine(a, b);
  } else if constexpr (kOp == SA_UMIN_U64) {
    return (unsigned long long)a < (unsigned long long)b ? a : b;
  } else if constexpr (kOp == SA_UMAX_U64) {
    return (unsigned long long)a > (unsigned long long)b ? a : b;
  } else if constexpr (kOp == SA_ADD_F64) {
    return as_word(as_f64(a) + as_f64(b));
  } else if constexpr (kOp == SA_MIN_F64) {
    return as_word(min_nan(as_f64(a), as_f64(b)));
  } else if constexpr (kOp == SA_MAX_F64) {
    return as_word(max_nan(as_f64(a), as_f64(b)));
  } else if constexpr (kOp == SA_MIN_I64) {
    return a < b ? a : b;
  } else if constexpr (kOp == SA_MAX_I64) {
    return a > b ? a : b;
  } else {  // SA_ADD_I64, SA_COUNT: two's-complement wrap
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
}

template <int kOp>
using OpTag = std::integral_constant<int, kOp>;

// Calls f(OpTag<op>) with the column's op as a compile-time constant.
template <typename F>
__device__ __forceinline__ void with_op(int op, F&& f) {
  switch (op) {
    case SA_ADD_F64: f(OpTag<SA_ADD_F64>{}); return;
    case SA_MIN_F64: f(OpTag<SA_MIN_F64>{}); return;
    case SA_MAX_F64: f(OpTag<SA_MAX_F64>{}); return;
    case SA_MIN_I64: f(OpTag<SA_MIN_I64>{}); return;
    case SA_MAX_I64: f(OpTag<SA_MAX_I64>{}); return;
    case SA_DF32: f(OpTag<SA_DF32>{}); return;
    case SA_UMIN_U64: f(OpTag<SA_UMIN_U64>{}); return;
    case SA_UMAX_U64: f(OpTag<SA_UMAX_U64>{}); return;
    default: f(OpTag<SA_ADD_I64>{}); return;  // SA_ADD_I64, SA_COUNT
  }
}

template <typename F>
__device__ __forceinline__ void with_kind(int kind, F&& f) {
  switch (kind) {
    case LK_IOTA: f(OpTag<LK_IOTA>{}); return;
    case LK_AUX: f(OpTag<LK_AUX>{}); return;
    case LK_COUNT: f(OpTag<LK_COUNT>{}); return;
    case LK_I64_F64: f(OpTag<LK_I64_F64>{}); return;
    case LK_F32_F64: f(OpTag<LK_F32_F64>{}); return;
    case LK_F32_DF: f(OpTag<LK_F32_DF>{}); return;
    case LK_I32: f(OpTag<LK_I32>{}); return;
    case LK_F32_PAIR: f(OpTag<LK_F32_PAIR>{}); return;
    case LK_ORD_PAIR: f(OpTag<LK_ORD_PAIR>{}); return;
    default: f(OpTag<LK_WORD>{}); return;
  }
}

// ------------------------------------------------------- memory helpers
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A published word travels as two 64-bit halves, each its 32 bits under
// the call's tag: a half is written and read whole, so a reader that finds
// both halves tagged has the word, with no fence on either side (a status
// word seen before its values only makes the reader read again).
__device__ __forceinline__ void put_word(unsigned long long* p, unsigned tag, long long v) {
  const unsigned long long t = (unsigned long long)tag << 32;
  st_relaxed(p, t | (unsigned)v);
  st_relaxed(p + 1, t | (unsigned)((unsigned long long)v >> 32));
}


__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ long long row_of(const SegScanParams& p, long long e) {
  return p.reverse ? p.n - 1 - e : e;
}

__device__ __forceinline__ int perm_at(const SegScanParams& p, long long r) {
  return p.perm ? p.perm[r] : (int)r;
}

// ------------------------------------------------------------- elements
template <int kKind>
__device__ __forceinline__ long long element(const SegScanParams& p, int c, int j,
                                             long long r, long long ident) {
  if constexpr (kKind == LK_IOTA) {
    return r;
  } else if constexpr (kKind == LK_AUX) {
    return p.aux[r] ? 1 : 0;
  } else {
    const bool* vm = p.valid[c];
    const bool ok = vm == nullptr || vm[j];
    if constexpr (kKind == LK_COUNT) {
      return ok ? 1 : 0;
    } else {
      long long w;
      if constexpr (kKind == LK_WORD) {
        w = static_cast<const long long*>(p.values[c])[j];
      } else if constexpr (kKind == LK_I64_F64) {
        w = agg_ops::as_word((double)static_cast<const long long*>(p.values[c])[j]);
      } else if constexpr (kKind == LK_F32_F64) {
        w = agg_ops::as_word((double)static_cast<const float*>(p.values[c])[j]);
      } else if constexpr (kKind == LK_F32_DF) {
        w = agg_ops::df32_word(static_cast<const float*>(p.values[c])[j], 0.0f);
      } else if constexpr (kKind == LK_I32) {
        w = (long long)static_cast<const int32_t*>(p.values[c])[j];
      } else if constexpr (kKind == LK_F32_PAIR) {
        float s, e;
        x32_ops::two_sum(static_cast<const float*>(p.values[c])[j],
                         static_cast<const float*>(p.values2[c])[j], &s, &e);
        w = agg_ops::df32_word(s, e);
      } else {  // LK_ORD_PAIR
        w = (long long)x32_ops::ord_join(static_cast<const int32_t*>(p.values[c])[j],
                                         static_cast<const int32_t*>(p.values2[c])[j]);
      }
      return ok ? w : ident;
    }
  }
}

// Column c's elements of the tile, position i by thread i mod 256 (the R
// loads of a thread in flight together); positions past the last row take
// the identity.
template <int kKind>
__device__ __forceinline__ void load_col(const ScanArgs& a, int c, const int* perm_s,
                                         long long p0, int live, long long (&x)[kScanMaxRows]) {
  const long long ident = a.ident[c];
#pragma unroll
  for (int k = 0; k < kScanMaxRows; ++k) {
    const int i = threadIdx.x + k * kScanThreads;
    x[k] = ident;
    if (k < a.rows && i < live) {
      x[k] = element<kKind>(a.p, c, perm_s[i], row_of(a.p, p0 + i), ident);
    }
  }
}

__device__ __forceinline__ void load_any(const ScanArgs& a, int c, const int* perm_s,
                                         long long p0, int live, long long (&x)[kScanMaxRows]) {
  with_kind(a.kind[c], [&](auto kind) {
    load_col<decltype(kind)::value>(a, c, perm_s, p0, live, x);
  });
}

__device__ __forceinline__ void store_col(int rows, long long* col,
                                          const long long (&x)[kScanMaxRows]) {
#pragma unroll
  for (int k = 0; k < kScanMaxRows; ++k) {
    if (k < rows) col[pad(threadIdx.x + k * kScanThreads)] = x[k];
  }
}

// Every column's elements into shared memory, the next column's loads
// issued before this column's stores wait on its own (two register sets
// that trade places, so no copy waits on a load).
__device__ __forceinline__ void gather_all(const ScanArgs& a, long long* cols, int padded,
                                           const int* perm_s, long long p0, int live) {
  const int nc = a.p.n_cols;
  long long x[kScanMaxRows], y[kScanMaxRows];
  load_any(a, 0, perm_s, p0, live, x);
  for (int c = 0; c < nc; c += 2) {
    if (c + 1 < nc) load_any(a, c + 1, perm_s, p0, live, y);
    store_col(a.rows, cols + (long long)c * padded, x);
    if (c + 1 < nc) {
      if (c + 2 < nc) load_any(a, c + 2, perm_s, p0, live, x);
      store_col(a.rows, cols + (long long)(c + 1) * padded, y);
    }
  }
}

// ---------------------------------------------------------- tile scans
// Per thread, what the (value, starts) operator needs of the start flags,
// the same for every column.
struct StartMasks {
  unsigned pre;   // bit k: no start at this thread's positions 0..k
  unsigned lane;  // bit s: shuffle step s (distance 2^s) folds the lane below in
};

// Column c's scan within the tile: each thread's R positions, then the
// warp's lanes; the warp-local inclusive values go back to shared memory
// and each warp's total to ScanShared::wv.
template <int kOp>
__device__ __forceinline__ void local_scan(long long* col, int rows, unsigned sbits,
                                           StartMasks m, long long* wv) {
  const int lane = threadIdx.x & 31;
  const int base = threadIdx.x * rows;
  long long x[kScanMaxRows];
  long long acc = 0;
#pragma unroll
  for (int k = 0; k < kScanMaxRows; ++k) {
    if (k < rows) {
      const long long v = col[pad(base + k)];
      acc = (k == 0 || ((sbits >> k) & 1u)) ? v : comb<kOp>(acc, v);
      x[k] = acc;
    }
  }
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const long long o = __shfl_up_sync(kFull, acc, 1 << s);
    if ((m.lane >> s) & 1u) acc = comb<kOp>(o, acc);
  }
  const long long ex = __shfl_up_sync(kFull, acc, 1);
#pragma unroll
  for (int k = 0; k < kScanMaxRows; ++k) {
    if (k < rows) {
      if (lane > 0 && ((m.pre >> k) & 1u)) x[k] = comb<kOp>(ex, x[k]);
      col[pad(base + k)] = x[k];
    }
  }
  if (lane == 31) wv[threadIdx.x >> 5] = acc;
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

// Column c's final values: the warp prefix before the warp's first start,
// the carry before the tile's first start, then out[row] (coalesced), or
// the state merge at each segment end with a live key.
template <int kOp>
__device__ __forceinline__ void finish(const ScanArgs& a, int c, const long long* col,
                                       const ScanShared& s, const int* ks, long long p0,
                                       int live) {
  const SegScanParams& p = a.p;
  const int warp_shift = 5 + (a.rows == 8 ? 3 : a.rows == 4 ? 2 : a.rows == 2 ? 1 : 0);
  long long* out = p.out[c];
  const bool merge = p.state != nullptr || p.state32 != nullptr;
  const long long carry = s.carry[c];
#pragma unroll
  for (int k = 0; k < kScanMaxRows; ++k) {
    const int i = threadIdx.x + k * kScanThreads;
    if (k >= a.rows || i >= live) continue;
    long long v = col[pad(i)];
    const int w = i >> warp_shift;
    if (w > 0 && i < s.fsw[w]) v = comb<kOp>(s.wex[c][w], v);
    if (s.carry_on && i < s.fs) v = comb<kOp>(carry, v);
    if (out != nullptr) out[row_of(p, p0 + i)] = v;
    // sorted aggregate (forward, keys): the segment ends at the last row
    // or before a change of key
    if (merge && (p0 + i == p.n - 1 || ks[i + 2] != ks[i + 1]) && ks[i + 1] < p.capacity) {
      const int key = ks[i + 1];
      for (int f = 0; f < p.n_fields; ++f) {
        if (p.field_col[f] != c) continue;
        if (p.state32 != nullptr) {
          merge_x32(p, f, key, v);
        } else {
          long long* st = p.state + (long long)f * p.capacity + key;
          *st = agg_ops::combine(p.field_op[f], *st, v);
        }
      }
    }
  }
}

// A word's two halves (put_word) as read: whole once both carry the tag.
__device__ __forceinline__ bool tagged(unsigned long long lo, unsigned long long hi,
                                       unsigned tag) {
  return (unsigned)(lo >> 32) == tag && (unsigned)(hi >> 32) == tag;
}

__device__ __forceinline__ long long joined(unsigned long long lo, unsigned long long hi) {
  return (long long)((hi << 32) | (lo & 0xffffffffull));
}

__device__ __forceinline__ long long get_word(const unsigned long long* p, unsigned tag) {
  for (int nap = 0;; nap = nap < 256 ? nap + 32 : nap) {
    const unsigned long long lo = ld_relaxed(p), hi = ld_relaxed(p + 1);
    if (tagged(lo, hi, tag)) return joined(lo, hi);
    __nanosleep(nap);
  }
}

constexpr int kLookTiles = 4;  // totals a lane stages a round (128 tiles a column)

// The nearest tile p < t that has published its inclusive prefix, once every
// tile after it has published its total (warp 0, 32 status words a round).
__device__ __forceinline__ long long find_inclusive(const ScanArgs& a, long long t) {
  const int lane = threadIdx.x & 31;
  const unsigned tag = a.p.tag;
  long long j = t - 1;  // the window's top
  for (int nap = 0;;) {
    const long long q = j - lane;
    const unsigned w = q >= 0 ? ld_relaxed(a.status + q) : 0u;
    const bool ready = (w >> 2) == tag;
    const unsigned stop = __ballot_sync(kFull, ready && (w & 3u) == kInc);
    const unsigned got = __ballot_sync(kFull, ready);
    if (stop != 0) {
      const int f = __ffs(stop) - 1;
      const unsigned below = (1u << f) - 1u;
      if ((got & below) == below) return j - f;
    } else if (got == kFull) {
      j -= 32;
      continue;
    }
    __nanosleep(nap);
    nap = nap < 256 ? nap + 32 : nap;
  }
}

// The carry into tile t (warp 0): the left fold, in tile order, of tile
// p's inclusive prefix and the totals of tiles p + 1 .. t - 1 (p from
// find_inclusive).  Column by column, the lanes stage up to ``window``
// totals in ``buf`` (the tile's perm, no longer needed: 4T bytes), each
// lane's loads in flight together, then lane c folds them in order.
__device__ void look_back(const ScanArgs& a, long long t, ScanShared& s, long long* buf) {
  const int lane = threadIdx.x & 31;
  const unsigned tag = a.p.tag;
  const int nc = a.p.n_cols;
  const int window = min(32 * kLookTiles, a.tile / (2 * nc));  // >= 4: T >= 256, nc <= 32
  const long long p = find_inclusive(a, t);
  if (lane < nc) s.carry[lane] = get_word(a.inc + 2 * (p * nc + lane), tag);
  for (long long base = p + 1; base < t; base += window) {
    const int cnt = t - base < window ? (int)(t - base) : window;
    for (int c = 0; c < nc; ++c) {
      unsigned long long h[2 * kLookTiles];
#pragma unroll
      for (int u = 0; u < kLookTiles; ++u) {
        const int i = lane + 32 * u;
        const unsigned long long* w = a.agg + 2 * ((base + i) * nc + c);
        h[2 * u] = i < cnt ? __ldcg(w) : 0ull;
        h[2 * u + 1] = i < cnt ? __ldcg(w + 1) : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kLookTiles; ++u) {
        const int i = lane + 32 * u;
        if (i >= cnt) continue;
        buf[c * window + i] = tagged(h[2 * u], h[2 * u + 1], tag)
                                  ? joined(h[2 * u], h[2 * u + 1])
                                  : get_word(a.agg + 2 * ((base + i) * nc + c), tag);
      }
    }
    __syncwarp();
    if (lane < nc) {
      with_op(a.p.op[lane], [&](auto op) {
        long long acc = s.carry[lane];
        const long long* col = buf + lane * window;
        for (int i = 0; i < cnt; ++i) acc = comb<decltype(op)::value>(acc, col[i]);
        s.carry[lane] = acc;
      });
    }
    __syncwarp();
  }
}

// Warp 0 publishes the tile's totals (its inclusive prefix at once when
// the tile holds a start or is the first), finds its carry when a row
// before its first start needs one, and then publishes its inclusive
// prefix.
__device__ void publish(const ScanArgs& a, long long t, ScanShared& s, long long* buf) {
  const int lane = threadIdx.x & 31;
  const int nc = a.p.n_cols;
  int fs = kNone;
  for (int w = 0; w < kWarps; ++w) fs = min(fs, s.fsw[w]);
  const bool holds = fs != kNone;
  const bool first_inc = t == 0 || holds;
  const unsigned tag = a.p.tag;
  if (lane < nc) put_word((first_inc ? a.inc : a.agg) + 2 * (t * nc + lane), tag, s.agg[lane]);
  __syncwarp();
  if (lane == 0) st_relaxed(a.status + t, tag << 2 | (first_inc ? kInc : kAgg));
  const bool carry_on = t > 0 && fs > 0;
  if (carry_on) {
    look_back(a, t, s, buf);
    if (!first_inc) {
      if (lane < nc) {
        put_word(a.inc + 2 * (t * nc + lane), tag,
                 agg_ops::combine(a.p.op[lane], s.carry[lane], s.agg[lane]));
      }
      __syncwarp();
      if (lane == 0) st_relaxed(a.status + t, tag << 2 | kInc);
    }
  }
  if (lane == 0) {
    s.fs = fs;
    s.carry_on = carry_on ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kScanThreads, 3) ss_scan(const __grid_constant__ ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanShared& s = *reinterpret_cast<ScanShared*>(smem_raw);
  const SegScanParams& p = a.p;
  const int T = a.tile, R = a.rows, nc = p.n_cols;
  const int padded = T + T / 16;
  long long* cols = reinterpret_cast<long long*>(smem_raw + kScanFixedBytes);
  int* perm_s = reinterpret_cast<int*>(cols + (long long)nc * padded);
  int* ks = perm_s + T;  // ks[i + 1]: the key at tile position i
  uint8_t* st = reinterpret_cast<uint8_t*>(ks + T + 2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool by_key = p.key != nullptr;

  for (;;) {
    if (tid == 0) s.tile = (long long)atomicAdd(a.ticket, 1u);
    __syncthreads();
    const long long t = s.tile;
    if (t >= a.n_tiles) break;
    const long long p0 = t * T;
    const int live = p.n - p0 < T ? (int)(p.n - p0) : T;

    // 1. perm (and the flags), coalesced; the perm of each neighbour
#pragma unroll
    for (int k = 0; k < kScanMaxRows; ++k) {
      const int i = tid + k * kScanThreads;
      if (k < R && i < live) {
        const long long e = p0 + i;
        perm_s[i] = perm_at(p, row_of(p, e));
        if (!by_key) st[i] = e == 0 || p.flag[p.reverse ? p.n - e : e] != 0;
      }
    }
    if (by_key && tid == 0 && p0 > 0) s.nb_perm[0] = perm_at(p, row_of(p, p0 - 1));
    if (by_key && tid == 32 && p0 + live < p.n) s.nb_perm[1] = perm_at(p, row_of(p, p0 + live));
    __syncthreads();

    // 2. the keys and every column's elements through perm
    if (by_key) {
#pragma unroll
      for (int k = 0; k < kScanMaxRows; ++k) {
        const int i = tid + k * kScanThreads;
        if (k < R && i < live) ks[i + 1] = p.key[perm_s[i]];
      }
      if (tid == 0) ks[0] = p0 > 0 ? p.key[s.nb_perm[0]] : 0;
      if (tid == 32) ks[live + 1] = p0 + live < p.n ? p.key[s.nb_perm[1]] : 0;
    }
    gather_all(a, cols, padded, perm_s, p0, live);
    __syncthreads();

    // 3. the start flags of this thread's R positions, then each column's
    // scan within the tile
    const int base = tid * R;
    unsigned sbits = 0;
    for (int k = 0; k < R; ++k) {
      const int i = base + k;
      if (i >= live) break;
      const bool start = by_key ? (p0 + i == 0 || ks[i + 1] != ks[i]) : st[i] != 0;
      sbits |= (start ? 1u : 0u) << k;
    }
    StartMasks m;
    m.pre = sbits ? (1u << (__ffs(sbits) - 1)) - 1u : kFull;
    {
      // the lane steps of a warp scan of the start bits: step s folds
      // lane - 2^s in unless a start lies in the lanes it covers so far
      bool has = sbits != 0;
      m.lane = 0;
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const bool o = __shfl_up_sync(kFull, has, 1 << q);
        if (lane >= (1 << q)) {
          if (!has) m.lane |= 1u << q;
          has = has || o;
        }
      }
    }
    {
      const int first = sbits ? base + __ffs(sbits) - 1 : kNone;
      const int w_first = (int)__reduce_min_sync(kFull, (unsigned)first);
      if (lane == 0) s.fsw[warp] = w_first;
    }
    for (int c = 0; c < nc; ++c) {
      long long* col = cols + (long long)c * padded;
      with_op(p.op[c], [&](auto op) {
        local_scan<decltype(op)::value>(col, R, sbits, m, s.wv[c]);
      });
    }
    __syncthreads();

    // each warp's prefix and the tile's total, column by column (left
    // folds over the warps)
    for (int idx = tid; idx < nc * kWarps; idx += kScanThreads) {
      const int c = idx / kWarps, w = idx % kWarps;
      const int op = p.op[c];
      long long acc = 0;
      for (int u = 0; u < w; ++u) {
        const long long v = s.wv[c][u];
        acc = (u == 0 || s.fsw[u] != kNone) ? v : agg_ops::combine(op, acc, v);
      }
      s.wex[c][w] = acc;
      if (w == kWarps - 1) {
        const long long v = s.wv[c][w];
        s.agg[c] = s.fsw[w] != kNone ? v : agg_ops::combine(op, acc, v);
      }
    }
    __syncthreads();

    // 4. publish, look back for the carry, then the final values
    if (warp == 0) publish(a, t, s, reinterpret_cast<long long*>(perm_s));
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const long long* col = cols + (long long)c * padded;
      with_op(p.op[c], [&](auto op) {
        finish<decltype(op)::value>(a, c, col, s, ks, p0, live);
      });
    }
    __syncthreads();
  }
  // the last CTA out resets the ticket for the next call on the stream
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(a.ticket + 1, 1u) == gridDim.x - 1) {
      atomicExch(a.ticket, 0u);
      atomicExch(a.ticket + 1, 0u);
    }
  }
}

int load_kind(const SegScanParams& p, int c) {
  switch (p.src[c]) {
    case SS_IOTA: return LK_IOTA;
    case SS_AUX: return LK_AUX;
    case SS_COUNT: return LK_COUNT;
    default: break;
  }
  const int op = p.op[c];
  switch (p.width[c]) {
    case SW_F32: return op == SA_DF32 ? LK_F32_DF : LK_F32_F64;
    case SW_I32: return LK_I32;
    case SW_F32_PAIR: return LK_F32_PAIR;
    case SW_ORD_PAIR: return LK_ORD_PAIR;
    default:
      return p.in_i64[c] && (op == SA_ADD_F64 || op == SA_MIN_F64 || op == SA_MAX_F64)
                 ? LK_I64_F64
                 : LK_WORD;
  }
}

long long identity_word(int op) {
  switch (op) {
    case SA_MIN_F64: return 0x7ff0000000000000LL;              // +inf
    case SA_MAX_F64: return (long long)0xfff0000000000000ULL;  // -inf
    case SA_MIN_I64: return 0x7fffffffffffffffLL;
    case SA_MAX_I64: return (long long)0x8000000000000000ULL;
    case SA_UMIN_U64: return -1LL;  // the largest unsigned word
    default: return 0;
  }
}

// Once a device and shape: the shared-memory limit and the CTAs an SM.
int ctas_per_sm(int dev, int rows, int n_cols) {
  static std::atomic<int> ctas[kMaxDevices][4][kScanMaxCols + 1];
  if (dev < 0 || dev >= kMaxDevices) return 1;
  const int r = rows == 8 ? 3 : rows == 4 ? 2 : rows == 2 ? 1 : 0;
  int c = ctas[dev][r][n_cols].load(std::memory_order_relaxed);
  if (c > 0) return c;
  cudaFuncSetAttribute(ss_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kScanSmemBudgetWide);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c, ss_scan, kScanThreads,
                                                scan_smem_bytes(rows, n_cols));
  c = c > 0 ? c : 1;
  ctas[dev][r][n_cols].store(c, std::memory_order_relaxed);
  return c;
}

int sm_count(int* dev) {
  int sms = 0;
  cudaGetDevice(dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, *dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

extern "C" long long seg_scan_tiles(long long n, int n_cols) {
  const ScanPlan pl = scan_plan(n, n_cols);
  return (n + pl.tile - 1) / pl.tile;
}

extern "C" cudaError_t seg_scan_launch(const SegScanParams* params, cudaStream_t stream) {
  const SegScanParams& p = *params;
  if (p.n == 0 || p.n_cols == 0) return cudaSuccess;
  if (p.n_cols > kScanMaxCols || p.tag == 0 || p.tag >= kScanTagMax) {
    return cudaErrorInvalidValue;
  }
  const ScanPlan pl = scan_plan(p.n, p.n_cols);
  ScanArgs a{};
  a.p = p;
  a.rows = pl.rows;
  a.tile = pl.tile;
  a.n_tiles = (p.n + pl.tile - 1) / pl.tile;
  if (a.n_tiles > p.status_cap || 4 * a.n_tiles * p.n_cols > p.value_cap) {
    return cudaErrorInvalidValue;
  }
  a.ticket = p.words;
  a.status = p.words + kScanHeaderWords;
  a.agg = reinterpret_cast<unsigned long long*>(p.values_scratch);
  a.inc = a.agg + 2 * a.n_tiles * p.n_cols;
  for (int c = 0; c < p.n_cols; ++c) {
    a.kind[c] = (int8_t)load_kind(p, c);
    a.ident[c] = identity_word(p.op[c]);
  }
  if (p.fresh) {  // the whole buffer: no word may carry a tag before its call
    const size_t bytes = sizeof(unsigned) * (size_t)(kScanHeaderWords + p.status_cap) +
                         sizeof(long long) * (size_t)p.value_cap;
    const cudaError_t err = cudaMemsetAsync(p.words, 0, bytes, stream);
    if (err != cudaSuccess) return err;
  }
  int dev = 0;
  const long long sms = sm_count(&dev);
  const long long most = sms * ctas_per_sm(dev, pl.rows, p.n_cols);
  const unsigned grid = (unsigned)(a.n_tiles < most ? a.n_tiles : most);
  ss_scan<<<grid, kScanThreads, pl.smem, stream>>>(a);
  return cudaGetLastError();
}

extern "C" cudaError_t seg_scan_describe(long long n, int n_cols, long long* out) {
  if (n_cols < 1 || n_cols > kScanMaxCols) return cudaErrorInvalidValue;
  const ScanPlan pl = scan_plan(n, n_cols);
  int dev = 0;
  const long long sms = sm_count(&dev);
  const int ctas = ctas_per_sm(dev, pl.rows, n_cols);
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, ss_scan);
  if (err != cudaSuccess) return err;
  const long long tiles = n > 0 ? (n + pl.tile - 1) / pl.tile : 0;
  out[0] = pl.threads;
  out[1] = pl.rows;
  out[2] = pl.tile;
  out[3] = pl.smem;
  out[4] = attr.numRegs;
  out[5] = (long long)attr.localSizeBytes;
  out[6] = ctas;
  out[7] = tiles < sms * ctas ? tiles : sms * ctas;
  return cudaGetLastError();
}
