// Launch interface of the keyed route's kernels (keyed_gids.cu,
// keyed_finish.cu, keyed_median.cu, keyed_corr.cu), shared with the
// PyTorch binding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kKeyedMaxKeys = 16;
constexpr int kGidsThreads = 256;
constexpr int kGidsItems = 8;  // consecutive sorted rows per thread
constexpr int kGidsTile = kGidsThreads * kGidsItems;

// Key kinds of the encode kernel (ops/kernels.py: KEY_KINDS).
enum KeyKind : int8_t { KK_IDENT = 1, KK_BOOL = 2, KK_F32 = 3, KK_F64 = 4 };
// Value types it reads (ops/kernels.py: KEY_IN_TYPES).
enum KeyIn : int8_t { KI_I32 = 0, KI_I64 = 1, KI_F32 = 2, KI_F64 = 3, KI_BOOL = 4 };

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

struct KeyedKeysParams {
  long long n;  // sorted rows
  long long capacity;
  long long n_groups;
  int n_keys;
  const void* sk[kKeyedMaxKeys];  // [n] sorted key codes
  int key_bytes[kKeyedMaxKeys];
  const int32_t* starts;  // [n + 1]
  void* out;              // [n_keys][capacity]
  int out_bytes;          // 8: int64 words; 4: x32's int32 words
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
extern "C" cudaError_t keyed_keys_launch(const KeyedKeysParams* p, cudaStream_t s);
extern "C" cudaError_t keyed_median_launch(const KeyedMedianParams* p, cudaStream_t s);
extern "C" cudaError_t corr_mask_launch(const CorrMaskParams* p, cudaStream_t s);
extern "C" cudaError_t corr_center_launch(const CorrCenterParams* p, cudaStream_t s);
extern "C" cudaError_t corr_center_x32_launch(const CorrCenterX32Params* p, cudaStream_t s);
