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
// Bound: bytes.  A pass must read the carried key and row index once and
// write them once: 16 B a row for a 32-bit key.  Design:
//   * one read of every key column gives each column's bounds and the
//     256-bin histogram of each of its bytes (shared-memory atomics; a
//     byte or word the same on a whole warp is one add).  The counts do
//     not depend on the permutation, so one plan kernel reads them before
//     any pass and marks every pass whose digit is the same on all rows to
//     be skipped: pad flags, null ranks, and the high bytes of small keys
//     (line numbers, dates, group ids) cost an empty launch each.  The
//     plan stays on the device, so the host never waits for it;
//   * keys are carried as 32-bit words.  Where the columns' spans (largest
//     less least flipped value) fit 64 bits together and the columns would
//     need two or more words, one more read packs every column's span into
//     one key of one or two words (order kept: fields most significant
//     first, constant bits dropped), with its own histograms, and the
//     passes run over it: the window's key set is 8 passes and one gathered
//     word, not 12 and six.  Else an int32 column is one word and an int64
//     column its low word, then its high one.  The first pass of a word
//     reads it from its source through the current permutation (the row
//     itself in the sort's first pass), and a word none of whose bytes run
//     is never read.  The last pass of a word writes only the row index;
//   * a pass is one kernel ("onesweep", Adinets and Merrill 2022): a CTA
//     takes 6144-row tiles from an atomic counter, so a tile only waits on
//     tiles that have started.  It reads the tile's words once, coalesced,
//     ranks the digit in shared memory (each warp owns a contiguous run of
//     rows and ranks 32-row chunks by ballots of the digit's bits; warps
//     are offset in warp order, so rows keep their order), publishes its
//     256 digit counts as 64-bit status words, scatters the tile into
//     shared memory in digit order with its row indices, looks back over
//     earlier tiles (eight at a time) for each digit's exclusive prefix
//     (the digit's start from the histogram), publishes its inclusive
//     prefix and writes the tile in runs: consecutive threads write
//     consecutive rows of one digit.  Status words are tagged with the pass, so one
//     memset a sort clears them for every pass;
//   * a sort of at most kRadixSmallMax rows is one launch of one CTA: the
//     row index (16 bits) and the current word stay in shared memory,
//     and each pass ranks from registers and writes back in place.  A byte
//     runs unless the AND and OR of the word agree on it (the histogram's
//     test, without the histogram).
// Integer atomics only count, bound or hand out tiles (their order cannot
// change the result); no library sort or scan is called (no cub::Device*,
// no torch.sort): the scans and the look-back are written here.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "radix_sort.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kRadixThreads / 32;
constexpr int kSmallWarps = kRadixSmallThreads / 32;
constexpr unsigned kAgg = 1;  // status word: the tile's own count
constexpr unsigned kInc = 2;  // status word: the count of every tile up to it
constexpr int kMaxDevices = 64;
constexpr int kSlots = kRadixPackedSlots;

// The packed key's layout, decided on the device from the bounds.
struct SortLayout {
  int packed;  // the passes run over the packed key
  int words;   // its 32-bit words a row (1 or 2)
  unsigned long long least[kRadixMaxKeys];  // each column's least flipped value
  int width[kRadixMaxKeys];                 // bits of its span (0: constant)
  int offset[kRadixMaxKeys];                // its lowest bit in the packed key
};
constexpr size_t kLayoutBytes = 1024;
static_assert(sizeof(SortLayout) <= kLayoutBytes, "layout region");

__device__ __forceinline__ unsigned long long flip_key(const void* col,
                                                       int bytes, long long i) {
  if (bytes == 4) {
    const unsigned v = static_cast<const unsigned*>(col)[i];
    return (unsigned long long)(v ^ 0x80000000u);
  }
  const unsigned long long v = static_cast<const unsigned long long*>(col)[i];
  return v ^ 0x8000000000000000ULL;
}

// The lanes of the warp whose digit equals this lane's: nine ballots, one
// a bit of the digit and one for the rows past n (digit 0x100).  (On the
// H100 __match_any_sync costs about 30 SM cycles a warp; the ballots a
// few.)
__device__ __forceinline__ unsigned warp_peers(unsigned d) {
  unsigned m = kFull;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const unsigned bit = (d >> b) & 1u;
    const unsigned bal = __ballot_sync(kFull, bit);
    m &= bit ? bal : ~bal;
  }
  return m;
}

// Adds one 32-bit word of each live lane to the histograms of its four
// bytes (sh[0..3]): one add when the word, or a byte, is the same on every
// live lane; else one a lane.
__device__ __forceinline__ void bin_word(unsigned word, bool live, unsigned lanes,
                                         int lane, unsigned (*sh)[256]) {
  const unsigned first = __shfl_sync(kFull, word, 0);
  if (__all_sync(kFull, !live || word == first)) {
    if (lane < 4) atomicAdd(&sh[lane][(first >> (8 * lane)) & 0xffu], (unsigned)__popc(lanes));
    return;
  }
  for (int b = 0; b < 4; ++b) {
    const unsigned bin = (word >> (8 * b)) & 0xffu;
    const unsigned f = __shfl_sync(kFull, bin, 0);
    if (__all_sync(kFull, !live || bin == f)) {
      if (lane == 0) atomicAdd(&sh[b][f], (unsigned)__popc(lanes));
    } else if (live) {
      atomicAdd(&sh[b][bin], 1u);
    }
  }
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int d = 16; d; d >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, d);
    v = o > v ? o : v;
  }
  return v;
}

// Key column blockIdx.y, read once: the histogram of every byte, added
// into hist[column][byte][256], and its bounds, into bounds[2 * column]
// (the largest complement of a flipped value, so that 0 starts it) and
// bounds[2 * column + 1] (the largest flipped value).
__global__ void rs_histogram(const RadixSortParams p, unsigned* hist,
                             unsigned long long* bounds) {
  const int k = blockIdx.y;
  const void* col = p.keys[k];
  const int bytes = p.key_bytes[k];
  const long long n = p.n;
  __shared__ unsigned sh[8][256];
  __shared__ unsigned long long red[2][8];
  for (int i = threadIdx.x; i < 8 * 256; i += blockDim.x) (&sh[0][0])[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned long long most = 0, least_c = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool live = i < n;
    const unsigned long long u = live ? flip_key(col, bytes, i) : 0;
    if (live) {
      most = u > most ? u : most;
      least_c = ~u > least_c ? ~u : least_c;
    }
    const unsigned lanes = __ballot_sync(kFull, live);
    for (int w = 0; w < bytes / 4; ++w) {
      bin_word((unsigned)(u >> (32 * w)), live, lanes, lane, &sh[4 * w]);
    }
  }
  most = warp_max(most);
  least_c = warp_max(least_c);
  if (lane == 0) {
    red[0][threadIdx.x >> 5] = least_c;
    red[1][threadIdx.x >> 5] = most;
  }
  __syncthreads();
  unsigned* h = hist + (size_t)k * 8 * 256;
  for (int i = threadIdx.x; i < bytes * 256; i += blockDim.x) {
    const unsigned c = (&sh[0][0])[i];
    if (c) atomicAdd(&h[i], c);
  }
  if (threadIdx.x < 2) {
    unsigned long long v = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      v = red[threadIdx.x][w] > v ? red[threadIdx.x][w] : v;
    }
    atomicMax(&bounds[2 * k + threadIdx.x], v);
  }
}

// The packed key's layout from the bounds: fields most significant first,
// the last column's at bit 0.  Packing pays where the spans fit 64 bits
// and the columns' own passes would read two or more words.
__device__ void make_layout(const RadixSortParams& p, const unsigned long long* bounds,
                            SortLayout* l) {
  int bits = 0, words_read = 0;
  for (int k = p.n_keys - 1; k >= 0; --k) {
    const unsigned long long least = ~bounds[2 * k], most = bounds[2 * k + 1];
    const unsigned long long span = most - least;
    const int w = span ? 64 - __clzll((long long)span) : 0;
    l->least[k] = least;
    l->width[k] = w;
    l->offset[k] = bits < 64 ? bits : 0;
    bits += w;
    if (w) words_read += (p.key_bytes[k] == 8 && ((most ^ least) >> 32)) ? 2 : 1;
  }
  l->packed = bits <= 64 && words_read >= 2;
  l->words = bits > 32 ? 2 : 1;
}

// Every row's packed key (when the layout packs), and the histograms of
// its bytes into hist8[byte][256].  Every block derives the layout; block
// 0 also stores it for the plan.
__global__ void rs_pack(const RadixSortParams p, const unsigned long long* bounds,
                        SortLayout* layout, unsigned long long* packed, unsigned* hist8) {
  __shared__ SortLayout l;
  __shared__ unsigned sh[kSlots][256];
  if (threadIdx.x == 0) make_layout(p, bounds, &l);
  for (int i = threadIdx.x; i < kSlots * 256; i += blockDim.x) (&sh[0][0])[i] = 0;
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) *layout = l;
  if (!l.packed) return;
  const int lane = threadIdx.x & 31;
  const long long n = p.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool live = i < n;
    unsigned long long c = 0;
    if (live) {
      for (int k = 0; k < p.n_keys; ++k) {
        if (l.width[k]) c |= (flip_key(p.keys[k], p.key_bytes[k], i) - l.least[k]) << l.offset[k];
      }
      if (l.words == 2) {
        packed[i] = c;
      } else {
        reinterpret_cast<unsigned*>(packed)[i] = (unsigned)c;
      }
    }
    const unsigned lanes = __ballot_sync(kFull, live);
    for (int w = 0; w < l.words; ++w) {
      bin_word((unsigned)(c >> (32 * w)), live, lanes, lane, &sh[4 * w]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * l.words * 256; i += blockDim.x) {
    const unsigned v = (&sh[0][0])[i];
    if (v) atomicAdd(&hist8[i], v);
  }
}

// The sort's device plan (see radix_sort.h for its layout).  Slots go in
// LSD order, four to a 32-bit word: the packed key's words, then the
// columns' (the last key first, each key's bytes from the least
// significant); only one of the two sets runs.  The buffers alternate
// with every pass that runs, starting so that the last one lands in
// buffer 0 (the output).
__global__ void rs_plan(const RadixSortParams p, const SortLayout* layout,
                        const unsigned* hist8, const unsigned* hist, int* plan) {
  __shared__ unsigned char runs[kSlots + kRadixMaxKeys * 8];
  const bool packed = layout->packed;
  const int words = layout->words;
  // one bucket holds every row: this digit cannot reorder anything
  for (int c = 0; c < kSlots; ++c) {
    int one = 1;
    if (packed && c < 4 * words) one = __syncthreads_or(hist8[c * 256 + threadIdx.x] == (unsigned)p.n);
    if (threadIdx.x == 0) runs[c] = !one;
  }
  int c = kSlots;
  for (int k = p.n_keys - 1; k >= 0; --k) {
    for (int d = 0; d < p.key_bytes[k]; ++d, ++c) {
      int one = 1;
      if (!packed) {
        one = __syncthreads_or(hist[((size_t)k * 8 + d) * 256 + threadIdx.x] == (unsigned)p.n);
      }
      if (threadIdx.x == 0) runs[c] = !one;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int n_run = 0;
  for (int i = 0; i < c; ++i) n_run += runs[i];
  plan[0] = n_run;
  int cur = n_run & 1;
  bool started = false;
  for (int w0 = 0; w0 < c; w0 += 4) {
    int first = -1, last = -1;
    for (int b = 0; b < 4; ++b) {
      if (!runs[w0 + b]) continue;
      if (first < 0) first = b;
      last = b;
    }
    for (int b = 0; b < 4; ++b) {
      if (!runs[w0 + b]) {
        plan[1 + w0 + b] = -1;
        continue;
      }
      int f = cur;
      if (b == first) f |= kPlanGather;
      if (!started) f |= kPlanIdentity;
      if (b != last) f |= kPlanKeyOut;
      plan[1 + w0 + b] = f;
      started = true;
      cur ^= 1;
    }
  }
  plan[1 + c] = words;
}

// The row order when no pass runs.
__global__ void rs_iota_if_none(long long n, const int* plan, int32_t* out) {
  if (plan[0] != 0) return;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = (int32_t)i;
  }
}

// Block-wide exclusive scan of one value per thread (every thread of the
// block calls it); returns the thread's prefix and the block total.
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sums[32];
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

// ------------------------------------------------------------ one pass
struct PassArgs {
  const unsigned* col;    // the word's source as 32-bit words
  int stride;             // words a row of the source: 1 or 2 ...
  const int* stride_dev;  // ... or, when set, read on the device (the packed key)
  int word;               // the word of the row this pass reads: 0 low, 1 high
  unsigned flip;          // the sign bit, on a column's most significant word
  int shift;              // the digit's place in the word: 0, 8, 16 or 24
  long long n;
  long long n_tiles;
  const int* plan;        // this slot's plan word
  const unsigned* hist;   // this slot's 256 digit counts
  int32_t* perm[2];       // the permutation buffers (0 is the output)
  unsigned* key[2];       // the carried word
  unsigned long long* status;  // [n_tiles][256] look-back words
  unsigned* counter;      // this pass's tile counter
  unsigned tag;           // this pass's status tag (slot + 1)
};

struct PassShared {
  unsigned key[kRadixTile];                // the tile in digit order
  int32_t perm[kRadixTile];
  unsigned short wofs[kWarps][256];        // per warp and digit: count, then offset
  unsigned gadj[256];                      // output row of tile row i of digit d: gadj[d] + i
  unsigned dstart[256];                    // the digit's first output row
  long long tile;
};

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(unsigned tag, unsigned kind,
                                                          unsigned count) {
  return ((unsigned long long)(tag << 2 | kind) << 32) | count;
}

// Rows of digit d in the tiles before t: their aggregates summed back to
// the first inclusive prefix (tile 0 publishes one at once).  Eight
// predecessors are read at a time, so a walk of k tiles waits on k / 8
// round trips to L2, not k.
__device__ unsigned look_back(const unsigned long long* status, long long t, int d,
                              unsigned tag) {
  constexpr int kLook = 8;
  const unsigned agg = tag << 2 | kAgg, inc = tag << 2 | kInc;
  unsigned excl = 0;
  long long j = t - 1;
  for (;;) {
    unsigned long long w[kLook];
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      w[q] = j - q >= 0 ? ld_relaxed(status + (j - q) * 256 + d) : 0ULL;
    }
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      const unsigned got = (unsigned)(w[q] >> 32);
      if (got == inc) return excl + (unsigned)w[q];
      if (got != agg) break;  // not published yet: read again from here
      excl += (unsigned)w[q];
      --j;
    }
  }
}

__global__ void __launch_bounds__(kRadixThreads, 2) rs_onesweep(const PassArgs a) {
  const int f = *a.plan;
  if (f < 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassShared& s = *reinterpret_cast<PassShared*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int src = f & 1;
  const bool gather = f & kPlanGather;
  const bool ident = f & kPlanIdentity;
  const bool key_out_on = f & kPlanKeyOut;
  const long long stride = a.stride_dev ? *a.stride_dev : a.stride;
  const int32_t* perm_in = a.perm[src];
  int32_t* perm_out = a.perm[src ^ 1];
  const unsigned* key_in = a.key[src];
  unsigned* key_out = a.key[src ^ 1];
  {
    const unsigned h = tid < 256 ? a.hist[tid] : 0u;
    unsigned total;
    const unsigned start = block_exclusive_scan(h, &total);
    if (tid < 256) s.dstart[tid] = start;
  }
  for (;;) {
    if (tid == 0) s.tile = (long long)atomicAdd(a.counter, 1u);
    for (int i = lane; i < 256; i += 32) s.wofs[warp][i] = 0;
    __syncthreads();
    const long long t = s.tile;
    if (t >= a.n_tiles) return;
    const long long base = t * kRadixTile;
    const long long r0 = base + (long long)warp * 32 * kRadixItems + lane;

    // the tile's words, read once: warp w's rows, 32-row chunk by chunk
    // (the first pass of a word gathers it through perm)
    unsigned k[kRadixItems];
#pragma unroll
    for (int i = 0; i < kRadixItems; ++i) {
      const long long r = r0 + 32 * i;
      k[i] = 0;
      if (r < a.n && !gather) k[i] = key_in[r];
      if (r < a.n && gather) {
        const long long row = ident ? r : perm_in[r];
        k[i] = a.col[row * stride + a.word] ^ a.flip;
      }
    }

    // rank within the warp, rows in order (16-bit ranks, two a register)
    unsigned rank[(kRadixItems + 1) / 2];
#pragma unroll
    for (int i = 0; i < kRadixItems; ++i) {
      const bool live = r0 + 32 * i < a.n;
      const unsigned d = live ? (k[i] >> a.shift) & 0xffu : 0x100u;
      const unsigned peers = warp_peers(d);
      const unsigned before = live ? s.wofs[warp][d] : 0u;
      const unsigned r = before + __popc(peers & lt);
      rank[i / 2] = (i & 1) ? (rank[i / 2] | r << 16) : r;
      __syncwarp();
      if (live && (__ffs(peers) - 1) == lane) {
        s.wofs[warp][d] = (unsigned short)(before + __popc(peers));
      }
      __syncwarp();
    }
    __syncthreads();

    // the tile's digit counts, published at once; each warp's offset per
    // digit inside the tile, warps in order
    unsigned cnt = 0;
    if (tid < 256) {
      for (int w = 0; w < kWarps; ++w) cnt += s.wofs[w][tid];
      st_relaxed(a.status + t * 256 + tid, status_word(a.tag, t == 0 ? kInc : kAgg, cnt));
    }
    unsigned total;
    const unsigned tstart = block_exclusive_scan(cnt, &total);
    if (tid < 256) {
      unsigned run = tstart;
      for (int w = 0; w < kWarps; ++w) {
        const unsigned c = s.wofs[w][tid];
        s.wofs[w][tid] = (unsigned short)run;
        run += c;
      }
    }
    __syncthreads();

    // the tile into shared memory in digit order, with its row indices
    // (read here, not held through the ranking)
#pragma unroll
    for (int i = 0; i < kRadixItems; ++i) {
      const long long r = r0 + 32 * i;
      if (r < a.n) {
        const unsigned pos = s.wofs[warp][(k[i] >> a.shift) & 0xffu] +
                             ((i & 1) ? rank[i / 2] >> 16 : rank[i / 2] & 0xffffu);
        s.key[pos] = k[i];
        s.perm[pos] = ident ? (int32_t)r : perm_in[r];
      }
    }
    // each digit's rows in the tiles before this one (the first 256
    // threads; the tile's words are in shared memory by now, which frees
    // the registers for eight status words at a time)
    if (tid < 256) {
      unsigned excl = 0;
      if (t > 0) {
        excl = look_back(a.status, t, tid, a.tag);
        st_relaxed(a.status + t * 256 + tid, status_word(a.tag, kInc, excl + cnt));
      }
      s.gadj[tid] = s.dstart[tid] + excl - tstart;
    }
    __syncthreads();

    // out in runs: consecutive threads, consecutive rows of one digit
    const long long left = a.n - base;
    const int rows = left < kRadixTile ? (int)left : kRadixTile;
#pragma unroll 4
    for (int i = tid; i < rows; i += kRadixThreads) {
      const unsigned kk = s.key[i];
      const unsigned pos = s.gadj[(kk >> a.shift) & 0xffu] + (unsigned)i;
      if (key_out_on) key_out[pos] = kk;
      perm_out[pos] = s.perm[i];
    }
    __syncthreads();
  }
}

// ------------------------------------------------------ the one-CTA sort
// Row r = warp * 32 * kRadixSmallItems + 32 * i + lane is item i of a
// thread.  Row indices are 16 bits, two to a register.
#define RS_IDX(i) (((i) & 1) ? (ix[(i) >> 1] >> 16) : (ix[(i) >> 1] & 0xffffu))
#define RS_SET_IDX(i, v)                                                        \
  (ix[(i) >> 1] = ((i) & 1) ? ((ix[(i) >> 1] & 0xffffu) | ((unsigned)(v) << 16)) \
                            : ((ix[(i) >> 1] & 0xffff0000u) | (unsigned)(v)))

__global__ void __launch_bounds__(kRadixSmallThreads, 1)
    rs_small(const RadixSortParams p, int32_t* perm_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned wofs[kSmallWarps][256];
  __shared__ unsigned red[2][kSmallWarps];
  const int n = (int)p.n;
  unsigned* skey = reinterpret_cast<unsigned*>(smem_raw);
  unsigned short* sidx = reinterpret_cast<unsigned short*>(skey + n);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int row0 = warp * 32 * kRadixSmallItems + lane;
  // chunks of this warp that hold a row (later ones are past n)
  const int left = n - (row0 - lane);
  const int chunks = left <= 0 ? 0 : left >= 32 * kRadixSmallItems ? kRadixSmallItems
                                                                     : (left + 31) / 32;
  unsigned k[kRadixSmallItems];
  unsigned ix[kRadixSmallItems / 2];
#pragma unroll
  for (int i = 0; i < kRadixSmallItems; ++i) {
    k[i] = 0;
    if (!(i & 1)) ix[i >> 1] = 0;
  }
#pragma unroll
  for (int i = 0; i < kRadixSmallItems; ++i) RS_SET_IDX(i, (row0 + 32 * i) & 0xffff);

  for (int kc = p.n_keys - 1; kc >= 0; --kc) {
    const unsigned* col = static_cast<const unsigned*>(p.keys[kc]);
    const int words = p.key_bytes[kc] / 4;
    for (int w = 0; w < words; ++w) {
      const unsigned flip = w == words - 1 ? 0x80000000u : 0u;
      // the word through the current order, and which of its bytes vary
      unsigned o = 0, an = kFull;
#pragma unroll
      for (int i = 0; i < kRadixSmallItems; ++i) {
        if (row0 + 32 * i < n) {
          k[i] = col[RS_IDX(i) * words + w] ^ flip;
          o |= k[i];
          an &= k[i];
        }
      }
      for (int d = 16; d; d >>= 1) {
        o |= __shfl_xor_sync(kFull, o, d);
        an &= __shfl_xor_sync(kFull, an, d);
      }
      if (lane == 0) {
        red[0][warp] = o;
        red[1][warp] = an;
      }
      __syncthreads();
      o = 0;
      an = kFull;
      for (int v = 0; v < kSmallWarps; ++v) {
        o |= red[0][v];
        an &= red[1][v];
      }
      const unsigned vary = o ^ an;
      __syncthreads();  // red is reused by the next word

      for (int b = 0; b < 4; ++b) {
        const int shift = 8 * b;
        if (!((vary >> shift) & 0xffu)) continue;
        // per-warp digit counts (atomics: the order of counting is free)
        for (int i = lane; i < 256; i += 32) wofs[warp][i] = 0;
        __syncwarp();
#pragma unroll
        for (int i = 0; i < kRadixSmallItems; ++i) {
          if (i >= chunks) break;
          const bool live = row0 + 32 * i < n;
          const unsigned d = live ? (k[i] >> shift) & 0xffu : 0x100u;
          const unsigned peers = warp_peers(d);
          if (live && (__ffs(peers) - 1) == lane) atomicAdd(&wofs[warp][d], __popc(peers));
        }
        __syncthreads();
        // each warp's first row of each digit: digits in order, then warps
        unsigned cnt = 0;
        if (tid < 256) {
          for (int v = 0; v < kSmallWarps; ++v) cnt += wofs[v][tid];
        }
        unsigned total;
        const unsigned start = block_exclusive_scan(cnt, &total);
        if (tid < 256) {
          unsigned run = start;
          for (int v = 0; v < kSmallWarps; ++v) {
            const unsigned c = wofs[v][tid];
            wofs[v][tid] = run;
            run += c;
          }
        }
        __syncthreads();
        // every row to its place (all rows are in registers), in row order
#pragma unroll
        for (int i = 0; i < kRadixSmallItems; ++i) {
          if (i >= chunks) break;
          const bool live = row0 + 32 * i < n;
          const unsigned d = live ? (k[i] >> shift) & 0xffu : 0x100u;
          const unsigned peers = warp_peers(d);
          const unsigned before = live ? wofs[warp][d] : 0u;
          __syncwarp();
          if (live && (__ffs(peers) - 1) == lane) wofs[warp][d] = before + __popc(peers);
          __syncwarp();
          if (live) {
            const unsigned pos = before + __popc(peers & lt);
            skey[pos] = k[i];
            sidx[pos] = (unsigned short)RS_IDX(i);
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kRadixSmallItems; ++i) {
          const int r = row0 + 32 * i;
          if (r < n) {
            k[i] = skey[r];
            RS_SET_IDX(i, sidx[r]);
          }
        }
        __syncthreads();  // wofs and the rows are reused by the next pass
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRadixSmallItems; ++i) {
    const int r = row0 + 32 * i;
    if (r < n) perm_out[r] = (int32_t)RS_IDX(i);
  }
}

#undef RS_IDX
#undef RS_SET_IDX

inline size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

int radix_sort_candidates_of(const RadixSortParams& p) {
  int total = 0;
  for (int k = 0; k < p.n_keys; ++k) total += p.key_bytes[k];
  return total;
}

struct Scratch {
  size_t plan, layout, bounds, hist8, hist, counters, status, perm1, key0, key1, packed,
      total;
};

// One int32 column is never packed (one word either way).
bool may_pack(int n_keys, int candidates) { return !(n_keys == 1 && candidates == 4); }

Scratch scratch_layout(long long n, int n_keys, int candidates) {
  Scratch l;
  const long long tiles = (n + kRadixTile - 1) / kRadixTile;
  l.plan = 0;
  l.layout = l.plan + align256(sizeof(int) * (size_t)(1 + kSlots + candidates + 1));
  l.bounds = l.layout + kLayoutBytes;
  l.hist8 = l.bounds + align256(sizeof(unsigned long long) * 2 * (size_t)n_keys);
  l.hist = l.hist8 + sizeof(unsigned) * kSlots * 256;
  l.counters = l.hist + sizeof(unsigned) * 8 * 256 * (size_t)n_keys;
  l.status = l.counters + align256(sizeof(unsigned) * (size_t)(kSlots + candidates));
  l.perm1 = l.status + align256(sizeof(unsigned long long) * 256 * (size_t)tiles);
  l.key0 = l.perm1 + align256(sizeof(int32_t) * (size_t)n);
  l.key1 = l.key0 + align256(sizeof(unsigned) * (size_t)n);
  l.packed = l.key1 + align256(sizeof(unsigned) * (size_t)n);
  l.total = l.packed +
            (may_pack(n_keys, candidates) ? align256(sizeof(unsigned long long) * (size_t)n) : 0);
  return l;
}

// Once a device: the kernels' shared-memory limits and the pass's CTAs
// an SM.
int pass_ctas_per_sm(int dev) {
  static std::atomic<int> ctas[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return 1;
  int c = ctas[dev].load(std::memory_order_relaxed);
  if (c > 0) return c;
  cudaFuncSetAttribute(rs_onesweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sizeof(PassShared));
  cudaFuncSetAttribute(rs_small, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kRadixSmallMax * 6);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c, rs_onesweep, kRadixThreads,
                                                sizeof(PassShared));
  c = c > 0 ? c : 1;
  ctas[dev].store(c, std::memory_order_relaxed);
  return c;
}

int sm_count(int* dev) {
  int sms = 0;
  cudaGetDevice(dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, *dev);
  return sms > 0 ? sms : 1;
}

// The launches before the passes (radix_sort_plan).
cudaError_t prepare(const RadixSortParams& p, char* base, const Scratch& l, int sms,
                    cudaStream_t stream) {
  // plan, layout, bounds, histograms, tile counters and status words
  cudaError_t err = cudaMemsetAsync(base, 0, l.perm1, stream);
  if (err != cudaSuccess) return err;
  const long long want = (p.n + 255) / 256;
  const unsigned grid = (unsigned)(want < 8LL * sms ? want : 8LL * sms);
  auto* bounds = reinterpret_cast<unsigned long long*>(base + l.bounds);
  auto* layout = reinterpret_cast<SortLayout*>(base + l.layout);
  auto* hist8 = reinterpret_cast<unsigned*>(base + l.hist8);
  auto* hist = reinterpret_cast<unsigned*>(base + l.hist);
  rs_histogram<<<dim3(grid, p.n_keys), 256, 0, stream>>>(p, hist, bounds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (may_pack(p.n_keys, radix_sort_candidates_of(p))) {
    rs_pack<<<grid, 256, 0, stream>>>(
        p, bounds, layout, reinterpret_cast<unsigned long long*>(base + l.packed), hist8);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rs_plan<<<1, 256, 0, stream>>>(p, layout, hist8, hist,
                                 reinterpret_cast<int*>(base + l.plan));
  return cudaGetLastError();
}

}  // namespace

extern "C" int radix_sort_candidates(const RadixSortParams* params) {
  return radix_sort_candidates_of(*params);
}

extern "C" size_t radix_sort_scratch_bytes(long long n, int n_keys, int candidates) {
  return scratch_layout(n, n_keys, candidates).total;
}

extern "C" cudaError_t radix_sort_plan(const RadixSortParams* params, void* scratch,
                                       size_t scratch_bytes, cudaStream_t stream) {
  const RadixSortParams& p = *params;
  const Scratch l = scratch_layout(p.n, p.n_keys, radix_sort_candidates(&p));
  if (scratch == nullptr || scratch_bytes < l.total) return cudaErrorInvalidValue;
  if (p.n <= 0) return cudaMemsetAsync(scratch, 0, sizeof(int), stream);
  int dev = 0;
  return prepare(p, static_cast<char*>(scratch), l, sm_count(&dev), stream);
}

extern "C" cudaError_t radix_sort(const RadixSortParams* params, int32_t* perm_out,
                                  void* scratch, size_t scratch_bytes, int small,
                                  cudaStream_t stream) {
  const RadixSortParams& p = *params;
  if (p.n <= 0) return cudaSuccess;
  int dev = 0;
  const int sms = sm_count(&dev);
  const int per_sm = pass_ctas_per_sm(dev);
  if (small) {
    if (p.n > kRadixSmallMax) return cudaErrorInvalidValue;
    rs_small<<<1, kRadixSmallThreads, (size_t)p.n * 6, stream>>>(p, perm_out);
    return cudaGetLastError();
  }
  const int cands = radix_sort_candidates(&p);
  const Scratch l = scratch_layout(p.n, p.n_keys, cands);
  if (scratch == nullptr || scratch_bytes < l.total) return cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  cudaError_t err = prepare(p, base, l, sms, stream);
  if (err != cudaSuccess) return err;

  const int* plan = reinterpret_cast<const int*>(base + l.plan);
  const auto* hist8 = reinterpret_cast<const unsigned*>(base + l.hist8);
  const auto* hist = reinterpret_cast<const unsigned*>(base + l.hist);
  auto* counters = reinterpret_cast<unsigned*>(base + l.counters);
  PassArgs a{};
  a.n = p.n;
  a.n_tiles = (p.n + kRadixTile - 1) / kRadixTile;
  a.perm[0] = perm_out;
  a.perm[1] = reinterpret_cast<int32_t*>(base + l.perm1);
  a.key[0] = reinterpret_cast<unsigned*>(base + l.key0);
  a.key[1] = reinterpret_cast<unsigned*>(base + l.key1);
  a.status = reinterpret_cast<unsigned long long*>(base + l.status);
  const long long most = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(a.n_tiles < most ? a.n_tiles : most);
  auto launch = [&](int slot) {
    a.plan = plan + 1 + slot;
    a.counter = counters + slot;
    a.tag = (unsigned)slot + 1;
    rs_onesweep<<<grid, kRadixThreads, sizeof(PassShared), stream>>>(a);
    return cudaGetLastError();
  };
  if (may_pack(p.n_keys, cands)) {  // the packed key's slots (skipped unless packed)
    a.col = reinterpret_cast<const unsigned*>(base + l.packed);
    a.stride_dev = plan + 1 + kSlots + cands;
    a.flip = 0;
    for (int slot = 0; slot < kSlots; ++slot) {
      a.word = slot / 4;
      a.shift = 8 * (slot % 4);
      a.hist = hist8 + (size_t)slot * 256;
      err = launch(slot);
      if (err != cudaSuccess) return err;
    }
  }
  a.stride_dev = nullptr;
  int c = 0;
  for (int k = p.n_keys - 1; k >= 0; --k) {
    const int words = p.key_bytes[k] / 4;
    for (int d = 0; d < p.key_bytes[k]; ++d, ++c) {
      a.col = static_cast<const unsigned*>(p.keys[k]);
      a.stride = words;
      a.word = d / 4;
      a.flip = a.word == words - 1 ? 0x80000000u : 0u;
      a.shift = 8 * (d % 4);
      a.hist = hist + ((size_t)k * 8 + d) * 256;
      err = launch(kSlots + c);
      if (err != cudaSuccess) return err;
    }
  }
  const long long want = (p.n + 255) / 256;
  rs_iota_if_none<<<(unsigned)(want < 4LL * sms ? want : 4LL * sms), 256, 0, stream>>>(
      p.n, plan, perm_out);
  return cudaGetLastError();
}
