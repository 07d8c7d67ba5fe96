// Native hash partitioner — the shuffle-write hot path.
//
// Role counterpart of the reference's BatchPartitioner
// (ballista/rust/core/src/execution_plans/shuffle_writer.rs:201-285): given
// the key columns of a record batch, produce the output-partition id of
// every row.  The algorithm MUST stay bit-identical to the Python fallback
// in exec/operators.py::hash_partition_indices — map- and reduce-side tasks
// may run in different processes and both sides re-derive the same
// assignment.
//
// Per column hash hv(i):
//   numeric  : x = (uint64)(int64)value   (floats: f64 bit pattern)
//              hv = x * 0x9E3779B97F4A7C15;  hv ^= hv >> 32
//   string   : FNV-1a 64 over the utf8 bytes
//   null     : 0xA5A5A5A5DEADBEEFULL
// Combine    : h = h * 31 + hv
// Finish     : out = h % n_partitions
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image);
// callers pass raw Arrow buffer addresses (zero-copy).

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t kNullHash = 0xA5A5A5A5DEADBEEFULL;
constexpr uint64_t kMix = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t kFnvBasis = 1469598103934665603ULL;
constexpr uint64_t kFnvPrime = 1099511628211ULL;

inline bool bit_get(const uint8_t* bits, int64_t i) {
  return (bits[i >> 3] >> (i & 7)) & 1;
}

inline uint64_t mix_int(uint64_t x) {
  uint64_t hv = x * kMix;
  hv ^= hv >> 32;
  return hv;
}

inline uint64_t fnv1a(const uint8_t* data, int64_t len) {
  uint64_t h = kFnvBasis;
  for (int64_t i = 0; i < len; ++i) {
    h = (h ^ data[i]) * kFnvPrime;
  }
  return h;
}

inline void combine(uint64_t* h, int64_t i, uint64_t hv) {
  h[i] = h[i] * 31u + hv;
}

template <typename T>
void hash_fixed_col(const uint8_t* vals, const uint8_t* validity, int64_t n,
                     uint64_t* h) {
  const T* v = reinterpret_cast<const T*>(vals);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t hv;
    if (validity != nullptr && !bit_get(validity, i)) {
      hv = kNullHash;
    } else {
      hv = mix_int(static_cast<uint64_t>(static_cast<int64_t>(v[i])));
    }
    combine(h, i, hv);
  }
}

}  // namespace

extern "C" {

// elem_size in {1,2,4,8}; signed values sign-extend to int64, unsigned
// zero-extend — matching numpy's astype(int64) in the python fallback
void abt_hash_int(const uint8_t* vals, int32_t elem_size, int32_t is_signed,
                  const uint8_t* validity, int64_t n, uint64_t* h) {
  if (is_signed) {
    switch (elem_size) {
      case 1:
        hash_fixed_col<int8_t>(vals, validity, n, h);
        break;
      case 2:
        hash_fixed_col<int16_t>(vals, validity, n, h);
        break;
      case 4:
        hash_fixed_col<int32_t>(vals, validity, n, h);
        break;
      default:
        hash_fixed_col<int64_t>(vals, validity, n, h);
    }
  } else {
    switch (elem_size) {
      case 1:
        hash_fixed_col<uint8_t>(vals, validity, n, h);
        break;
      case 2:
        hash_fixed_col<uint16_t>(vals, validity, n, h);
        break;
      case 4:
        hash_fixed_col<uint32_t>(vals, validity, n, h);
        break;
      default:
        hash_fixed_col<int64_t>(vals, validity, n, h);
    }
  }
}

void abt_hash_f64(const double* vals, const uint8_t* validity, int64_t n,
                  uint64_t* h) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t hv;
    if (validity != nullptr && !bit_get(validity, i)) {
      hv = kNullHash;
    } else {
      uint64_t bits;
      std::memcpy(&bits, &vals[i], sizeof(bits));
      hv = mix_int(bits);
    }
    combine(h, i, hv);
  }
}

void abt_hash_f32(const float* vals, const uint8_t* validity, int64_t n,
                  uint64_t* h) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t hv;
    if (validity != nullptr && !bit_get(validity, i)) {
      hv = kNullHash;
    } else {
      double d = static_cast<double>(vals[i]);
      uint64_t bits;
      std::memcpy(&bits, &d, sizeof(bits));
      hv = mix_int(bits);
    }
    combine(h, i, hv);
  }
}

// boolean columns are bit-packed; python path hashes them as int 0/1
void abt_hash_bool(const uint8_t* vals, const uint8_t* validity, int64_t n,
                   uint64_t* h) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t hv;
    if (validity != nullptr && !bit_get(validity, i)) {
      hv = kNullHash;
    } else {
      hv = mix_int(bit_get(vals, i) ? 1u : 0u);
    }
    combine(h, i, hv);
  }
}

// utf8 with 32-bit offsets (arrow `string`)
void abt_hash_str32(const int32_t* offsets, const uint8_t* data,
                    const uint8_t* validity, int64_t n, uint64_t* h) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t hv;
    if (validity != nullptr && !bit_get(validity, i)) {
      hv = kNullHash;
    } else {
      hv = fnv1a(data + offsets[i], offsets[i + 1] - offsets[i]);
    }
    combine(h, i, hv);
  }
}

// utf8 with 64-bit offsets (arrow `large_string`)
void abt_hash_str64(const int64_t* offsets, const uint8_t* data,
                    const uint8_t* validity, int64_t n, uint64_t* h) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t hv;
    if (validity != nullptr && !bit_get(validity, i)) {
      hv = kNullHash;
    } else {
      hv = fnv1a(data + offsets[i], offsets[i + 1] - offsets[i]);
    }
    combine(h, i, hv);
  }
}

void abt_finish_mod(const uint64_t* h, int64_t n, int64_t n_partitions,
                    int64_t* out) {
  const uint64_t m = static_cast<uint64_t>(n_partitions);
  for (int64_t i = 0; i < n; ++i) {
    out[i] = static_cast<int64_t>(h[i] % m);
  }
}

}  // extern "C"
