// PK-FK probe of the device join folded into the partial aggregate, for
// sm_90a.
//
// Replaces arrow_ballista_tpu/ops/kernels.py:make_join_kernel (kernel B5,
// dense form B5b and sorted form B5c) and the slot-table scatter of
// arrow_ballista_tpu/ops/stage_compiler.py:_prepare_build (B5a), with the
// reference's arithmetic:
// * build table: table[key - kmin] = row + 1 over unique build keys, 0
//   elsewhere (a zeroing pass, then one thread per key; unique keys make
//   the scatter conflict-free, so it is deterministic);
// * dense probe: rel = pkey - kmin (int64, wrapping), in bounds when
//   0 <= rel < span, slot = table[clip(rel, 0, span - 1)],
//   match = in bounds && slot > 0 && pkey valid, row = max(slot - 1, 0);
// * sorted probe: row = clip(lower_bound(bkeys, pkey), 0, m - 1),
//   match = bkeys[row] == pkey && pkey valid;
// then each build column and its validity are gathered at row (an
// unmatched row carries the values at the clamped row, as in the
// reference; its validity is ANDed with match) and the row mask becomes
// valid && match.  Values move as whole 8-, 4- or 1-byte words, so f64
// comes back bit for bit.  x32's form reads int32 keys (the probe keys
// masked into int32 range on the host, the build keys range-checked
// there) and gathers its f32 and int32 build columns as 4-byte words.
//
// Bound: bytes, the probe key, its validity and the mask once per row,
// one 4-byte slot (dense) or log2(m) 8-byte keys (sorted) per row, and
// each build column's word and validity read and written once per row.
// Design: one thread per probe row in a grid-stride loop, the binary
// search inline; no shared memory, no atomics.  The table and the sorted
// keys are read at data-dependent positions (random for an unordered
// probe), which costs a 32-byte sector per access, not 4 or 8 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "join_probe.h"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;  // 16 blocks per SM, then stride

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (unsigned)blocks;
}

__device__ __forceinline__ long long key_at(const void* keys, int bytes, long long i) {
  return bytes == 4 ? (long long)static_cast<const int32_t*>(keys)[i]
                    : static_cast<const long long*>(keys)[i];
}

__global__ void zero_table_kernel(int32_t* table, long long span) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < span; i += stride) {
    table[i] = 0;
  }
}

__global__ void build_table_kernel(JoinBuildParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < p.m; i += stride) {
    const long long rel = (long long)((unsigned long long)key_at(p.bkeys, p.key_bytes, i) -
                                      (unsigned long long)p.kmin);
    if (rel >= 0 && rel < p.span) p.table[rel] = (int32_t)(i + 1);
  }
}

__global__ void probe_kernel(JoinProbeParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < p.n; i += stride) {
    const long long key = key_at(p.pkey, p.key_bytes, i);
    long long row;
    bool match;
    if (p.table != nullptr) {
      const long long rel =
          (long long)((unsigned long long)key - (unsigned long long)p.kmin);
      const bool inb = rel >= 0 && rel < p.span;
      const long long at = rel < 0 ? 0 : (rel >= p.span ? p.span - 1 : rel);
      const int32_t slot = p.table[at];
      match = inb && slot > 0;
      row = slot > 0 ? (long long)slot - 1 : 0;
    } else {
      long long lo = 0, hi = p.m;  // first position whose key >= key
      while (lo < hi) {
        const long long mid = lo + ((hi - lo) >> 1);
        if (key_at(p.bkeys, p.key_bytes, mid) < key) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      row = lo < p.m ? lo : p.m - 1;
      match = key_at(p.bkeys, p.key_bytes, row) == key;
    }
    if (p.pkey_valid != nullptr) match = match && p.pkey_valid[i] != 0;
    for (int c = 0; c < p.n_cols; ++c) {
      if (p.val_bytes[c] == 8) {
        static_cast<long long*>(p.out_vals[c])[i] =
            static_cast<const long long*>(p.bvals[c])[row];
      } else if (p.val_bytes[c] == 4) {
        static_cast<int32_t*>(p.out_vals[c])[i] = static_cast<const int32_t*>(p.bvals[c])[row];
      } else {
        static_cast<uint8_t*>(p.out_vals[c])[i] =
            static_cast<const uint8_t*>(p.bvals[c])[row];
      }
      const bool v = p.bvalids[c] == nullptr || p.bvalids[c][row] != 0;
      p.out_valids[c][i] = (v && match) ? 1 : 0;
    }
    const bool live = p.valid == nullptr || p.valid[i] != 0;
    p.mask[i] = (live && match) ? 1 : 0;
  }
}

}  // namespace

extern "C" cudaError_t join_build_table_launch(const JoinBuildParams* params,
                                               cudaStream_t stream) {
  const JoinBuildParams& p = *params;
  if (p.span > 0) {
    zero_table_kernel<<<grid_for(p.span), kThreads, 0, stream>>>(p.table, p.span);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.m == 0) return cudaSuccess;
  build_table_kernel<<<grid_for(p.m), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

extern "C" cudaError_t join_probe_launch(const JoinProbeParams* params,
                                         cudaStream_t stream) {
  const JoinProbeParams& p = *params;
  if (p.n == 0) return cudaSuccess;
  probe_kernel<<<grid_for(p.n), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
