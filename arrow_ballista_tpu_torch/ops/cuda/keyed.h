// Launch interface of the keyed route's kernels (keyed_gids.cu,
// keyed_finish.cu, keyed_median.cu, keyed_corr.cu, keyed_fold.cu), shared
// with the PyTorch binding, and the per-kind key codes that the two
// encode kernels (keyed_gids.cu: key_encode, keyed_fold.cu:
// keyed_encode_entries) both compile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kKeyedMaxKeys = 16;
constexpr int kGidsThreads = 256;
constexpr int kGidsItems = 8;  // consecutive sorted rows per thread
constexpr int kGidsTile = kGidsThreads * kGidsItems;

// Key kinds of the encode kernels (ops/kernels.py: KEY_KINDS); KK_CODE is
// a host-coded key, whose shipped word passes through.
enum KeyKind : int8_t { KK_CODE = 0, KK_IDENT = 1, KK_BOOL = 2, KK_F32 = 3, KK_F64 = 4 };
// Value types it reads (ops/kernels.py: KEY_IN_TYPES).
enum KeyIn : int8_t { KI_I32 = 0, KI_I64 = 1, KI_F32 = 2, KI_F64 = 3, KI_BOOL = 4 };

constexpr long long kF32NullBits = (long long)(int32_t)0xFFC00001u;
constexpr long long kF64NullBits = (long long)0xFFF8000000000001ull;

#ifdef __CUDACC__
// The code of row i of one key, bit for bit the port's host encoder's:
// ident the zigzag image 2v+1 / -2v (null 0), bool null 0 / false 1 /
// true 2, floats their raw bits (null the reserved NaN), a host code its
// shipped word.
__device__ __forceinline__ long long key_code(int kind, int in_type, const void* values,
                                              const uint8_t* valid, long long i) {
  if (kind == KK_CODE) {
    return in_type == KI_I32 ? (long long)static_cast<const int32_t*>(values)[i]
                             : static_cast<const long long*>(values)[i];
  }
  long long code = 0;
  long long null_code = 0;
  switch (kind) {
    case KK_IDENT: {
      const long long v = in_type == KI_I32 ? (long long)static_cast<const int32_t*>(values)[i]
                                            : static_cast<const long long*>(values)[i];
      code = v >= 0 ? 2 * v + 1 : -2 * v;
      break;
    }
    case KK_BOOL:
      code = static_cast<const uint8_t*>(values)[i] ? 2 : 1;
      break;
    case KK_F32:
      code = (long long)static_cast<const int32_t*>(values)[i];
      null_code = kF32NullBits;
      break;
    default:  // KK_F64
      code = static_cast<const long long*>(values)[i];
      null_code = kF64NullBits;
      break;
  }
  return valid == nullptr || valid[i] != 0 ? code : null_code;
}

// The word a code is sorted as: itself, or x32's low 32 bits (signed).
__device__ __forceinline__ long long code_word(long long code, int out_bytes) {
  return out_bytes == 4 ? (long long)(int32_t)(uint32_t)(unsigned long long)code : code;
}
#endif

struct KeyEncodeParams {
  long long n;
  const uint8_t* masks[3];  // row masks ANDed together, or null (all rows)
  int32_t* inv;             // [n] 1 where a mask drops the row, else 0
  int n_keys;
  int8_t kind[kKeyedMaxKeys];
  int8_t in_type[kKeyedMaxKeys];
  const void* values[kKeyedMaxKeys];     // [n] raw key values
  const uint8_t* valid[kKeyedMaxKeys];   // [n] or null (all valid)
  void* out[kKeyedMaxKeys];              // [n] codes
  int out_bytes;  // 8: int64 codes; 4: x32's int32 codes (the code's low word)
};

struct KeyedGidsParams {
  long long n;
  const int32_t* perm;  // [n] the sort's permutation
  const int32_t* inv;   // [n] input order: 1 = dropped row
  int n_keys;
  const void* keys[kKeyedMaxKeys];  // [n] input order, 4- or 8-byte codes
  int key_bytes[kKeyedMaxKeys];
  int32_t* s2;        // [n] sorted order: group id, INT32_MAX if dropped; or null
  int32_t* gid_in;    // [n] input order: the same ids; or null
  void* sk[kKeyedMaxKeys];  // [n] sorted keys, or null
  int32_t* starts;    // [n + 1] first sorted row of each group, then the valid count
  long long* counts;  // [2] groups, valid rows
  long long n_blocks;
  long long* block;   // [2 * n_blocks] scratch: flags and valid rows per tile
};

// The keyed finish (keyed_finish.cu): one pass of at most kFinishMaxCols
// columns over the valid sorted rows into the state rows of the packed
// output, and each group's key codes into its key rows.
constexpr int kFinishMaxCols = 4;
constexpr int kFinishMaxFields = 64;
constexpr int kFinishThreads = 128;
constexpr int kFinishItems = 8;  // consecutive sorted rows per thread
constexpr int kFinishTile = kFinishThreads * kFinishItems;

struct KeyedFinishParams {
  long long n;          // sorted rows (valid rows first)
  long long capacity;
  long long n_groups;
  const int32_t* perm;    // [n] the sort's permutation
  const int32_t* s2;      // [n] sorted order: group id (valid rows)
  const int32_t* starts;  // [n_groups + 1] first sorted row of each group, then the valid count
  // the pass's columns, read at input row perm[r] (seg_scan.h's sources,
  // folds and widths: SS_VALUES or SS_COUNT, SA_*, SW_*)
  int n_cols;
  const void* values[kFinishMaxCols];
  const bool* valid[kFinishMaxCols];
  const void* values2[kFinishMaxCols];
  int8_t src[kFinishMaxCols];
  int8_t op[kFinishMaxCols];
  int8_t in_i64[kFinishMaxCols];
  int8_t width[kFinishMaxCols];
  // packed rows (rec_words > 0): column c's element word of input row j at
  // rec[j * rec_words + slot[c]], or 1 where slot[c] < 0 (a count with no
  // validity); kf_pack writes them
  int rec_words;
  int8_t slot[kFinishMaxCols];
  long long* rec;
  // state rows: row f merges column field_col[f]'s segment total into its
  // identity field_ident[f] with field_op[f] (SA_* in x64, x32's XM_*);
  // field_col -1: a row of another pass
  int n_fields;
  int8_t field_col[kFinishMaxFields];
  int8_t field_op[kFinishMaxFields];
  long long field_ident[kFinishMaxFields];
  int x32;        // int32 words, x32 merges
  // key rows key_row0 + k: the code of key k at each group's first sorted row
  int n_keys;
  int key_row0;
  const void* sk[kKeyedMaxKeys];  // [n] sorted key codes
  int key_bytes[kKeyedMaxKeys];
  void* out;      // [rows][capacity]
  int out_bytes;  // 8: int64 words; 4: x32's int32 words
  // scratch: each tile's first and last pieces, [n_tiles][n_cols] words
  long long n_tiles;
  long long* head;
  long long* tail;
};

struct KeyedMedianParams {
  long long n;
  long long capacity;
  const int32_t* perm;     // [n] sort by (inv, keys, argnull, ohi, olo)
  const int32_t* argnull;  // [n] input order: 1 where the argument is null
  const int32_t* ohi;      // [n] input order: order pair of the value
  const int32_t* olo;
  const int32_t* starts;   // [n + 1] of the gid kernel over that sort
  const long long* counts; // [2] groups, valid rows
  void* out;               // [6][capacity]
  int out_bytes;           // 8: int64 words; 4: x32's int32 words
};

// Argument types of the corr mask: f64, int64 (x64), f32 (x32's hi word).
enum CorrType : int { CT_F64 = 0, CT_I64 = 1, CT_F32 = 2 };

struct CorrMaskParams {
  long long n;
  const void* x;
  int x_type;  // CorrType
  const uint8_t* xvalid;
  const void* y;
  int y_type;
  const uint8_t* yvalid;
  uint8_t* m;  // [n] both valid and neither NaN
};

struct CorrCenterParams {
  long long n;
  long long capacity;
  const int32_t* s2;    // [n] sorted order group ids
  const int32_t* perm;  // [n]
  const void* x;
  int x_i64;
  const void* y;
  int y_i64;
  const uint8_t* m;           // [n] input order pair mask
  const long long* moments;   // [3][capacity]: n, sum x (f64 bits), sum y
  double* xy;                 // [n] sorted order products
  double* xx;
  double* yy;
};

// The x32 centring pass (the reference's x32 corr_fn): per sorted row the
// centred f32 pair values (hi - mean) + lo, their products in f32.
struct CorrCenterX32Params {
  long long n;
  long long capacity;
  const int32_t* s2;    // [n] sorted order group ids
  const int32_t* perm;  // [n]
  const float* xhi;     // [n] input order: the arguments' exact f32 pairs
  const float* xlo;
  const float* yhi;
  const float* ylo;
  const uint8_t* m;         // [n] input order pair mask
  const int32_t* moments;   // [5][capacity]: n, sum x (hi, lo), sum y (hi, lo)
  float* xy;                // [n] sorted order products
  float* xx;
  float* yy;
};

extern "C" cudaError_t key_encode_launch(const KeyEncodeParams* p, cudaStream_t s);
extern "C" long long keyed_gids_blocks(long long n);
extern "C" cudaError_t keyed_gids_launch(const KeyedGidsParams* p, cudaStream_t s);
extern "C" cudaError_t keyed_finish_launch(const KeyedFinishParams* p, cudaStream_t s);
extern "C" cudaError_t keyed_median_launch(const KeyedMedianParams* p, cudaStream_t s);
extern "C" cudaError_t corr_mask_launch(const CorrMaskParams* p, cudaStream_t s);
extern "C" cudaError_t corr_center_launch(const CorrCenterParams* p, cudaStream_t s);
extern "C" cudaError_t corr_center_x32_launch(const CorrCenterX32Params* p, cudaStream_t s);
