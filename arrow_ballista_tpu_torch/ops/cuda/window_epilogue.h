// Launch interface of window_epilogue.cu, shared with the PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kWindowMaxKeys = 32;

// One packed output row, computed at each sorted row i and written at
// input row perm[i].  sf/sl/pf/pl are the row's segment first/last and
// peer first/last (sorted positions); a frame [i + a, i + b] is clipped to
// [sf, sl], an unbounded side taking the segment's edge.  Integer codes of
// the descriptor, one int64 [kPackFields] row per output row:
enum PackKind : int {
  WP_ROW_NUMBER = 0,    // i - sf + 1
  WP_RANK = 1,          // pf - sf + 1
  WP_AT_ROW = 2,        // x[i]
  WP_NTILE = 3,         // bucket of i among k = a buckets of its segment
  WP_AT_PEER_LAST = 4,  // x[pl]
  WP_RANGE_COUNT = 5,   // pl - sf + 1
  WP_FRAME_COUNT = 6,   // rows in the frame (count(*))
  WP_FRAME_HI = 7,      // x[clip(hi)]
  WP_FRAME_LO = 8,      // lo > sf ? x[clip(lo - 1)] : 0
  WP_FRAME_DIFF = 9,    // empty ? 0 : x@hi - (lo > sf ? x@(lo - 1) : 0)
  WP_VALUE = 10,        // values[perm[clip(src)]]        (lag/lead/first/last)
  WP_VALUE_OK = 11,     // src in the segment && valid[perm[clip(src)]]
};
enum PackValueFn : int { WV_FIRST = 0, WV_LAST = 1, WV_LAG = 2, WV_LEAD = 3 };
// descriptor fields: kind, a, b, has_a, has_b, x, values, valid (pointers
// as int64; value fns keep their fn code in has_a and offset in a), the
// x32 narrowing of the row's word into an int32 output (PackNarrow) and
// the byte width of `values` (8, or 4 for x32's f32/int32 arguments)
constexpr int kPackFields = 10;
// How an x32 pack (int32 output) keeps a row's 64-bit word.
enum PackNarrow : int {
  WN_LO32 = 0,  // the low 32 bits: counts, ranks, int32 values, a df32 pair's hi
  WN_HI32 = 1,  // the high 32 bits: a df32 pair's lo word
  WN_F32 = 2,   // an f64 word rounded to f32 bits (f32 extrema widened by K2/K3)
};

struct WindowFlagsParams {
  long long n;
  const int32_t* perm;
  const void* keys[kWindowMaxKeys];  // [n] int32 or int64, input order
  int key_bytes[kWindowMaxKeys];
  int n_keys;
  int n_part;         // the first n_part keys partition
  uint8_t* seg_flag;  // [n] sorted order: a partition starts here
  uint8_t* peer_flag; // [n]: a peer group starts here
};

struct WindowPackParams {
  long long n;
  int n_rows;
  const int32_t* perm;
  int32_t* inv;       // [n] scratch: inv[perm[i]] = i
  const long long* sf;
  const long long* sl;
  const long long* pf;
  const long long* pl;
  const long long* desc;  // [n_rows][kPackFields]
  void* out;              // [n_rows][n] input order
  int out_bytes;          // 8: int64 words (x64); 4: int32 words (x32)
};

extern "C" cudaError_t window_flags_launch(const WindowFlagsParams* params,
                                           cudaStream_t stream);
extern "C" cudaError_t window_pack_launch(const WindowPackParams* params,
                                          cudaStream_t stream);
