// Device key encode and group ids of the keyed route (B7), for sm_90a.
//
// Replaces arrow_ballista_tpu/ops/kernels.py:device_encode_keys (the
// codes of raw key columns, inside the keyed prep) and the boundary half
// of _keyed_sort_fn (key-change flags, cumsum, s2, n_groups).  The sort
// between them is K1 (radix_sort.cu), which orders (not mask, *codes)
// stably; the reference packs the same order into u64 words for XLA.
//
// key_encode: one thread per row in a grid-stride loop.  The row masks
// fold into the sort's major key (inv); each device key's code is the
// port's host encoder's, bit for bit (keyed.h: key_code, which
// keyed_fold.cu's entry-wise encode compiles too).  x32's form writes each
// code's low 32 bits (the wrapper admits only keys whose codes fit them:
// zigzag images below 2^32, f32 bits).  Bound: bytes, each input read once, inv and the codes
// written once.
//
// keyed_gids: three passes over tiles of kGidsTile sorted rows.  (1) each
// block counts the group starts (a valid row whose keys differ from the
// row before) and the valid rows of its tile; (2) one block scans the
// tile counts into tile offsets and writes n_groups, the valid count and
// starts[n_groups]; (3) each block recounts its tile with a warp-shuffle
// prefix of the per-thread counts and writes every row's group id in
// sorted order (s2) and in input order (gid_in), the sorted keys, and
// each group's first row.  Bound: bytes (the key gathers through perm are
// random reads).  Deterministic, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed.h"

namespace {

constexpr int kEncodeThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xffffffffu;

__global__ void key_encode_kernel(KeyEncodeParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < p.n;
       i += stride) {
    bool keep = true;
    for (int j = 0; j < 3; ++j) {
      if (p.masks[j] != nullptr && !p.masks[j][i]) keep = false;
    }
    p.inv[i] = keep ? 0 : 1;
    for (int k = 0; k < p.n_keys; ++k) {
      const long long w = key_code(p.kind[k], p.in_type[k], p.values[k], p.valid[k], i);
      if (p.out_bytes == 4) {
        static_cast<int32_t*>(p.out[k])[i] = (int32_t)code_word(w, 4);
      } else {
        static_cast<long long*>(p.out[k])[i] = w;
      }
    }
  }
}

__device__ __forceinline__ long long key_at(const KeyedGidsParams& p, int k,
                                            long long i) {
  return p.key_bytes[k] == 8 ? static_cast<const long long*>(p.keys[k])[i]
                             : (long long)static_cast<const int32_t*>(p.keys[k])[i];
}

// Whether sorted row r (r < n) is valid and starts a group.
__device__ __forceinline__ void flags_at(const KeyedGidsParams& p, long long r,
                                         bool* valid, bool* first) {
  const long long i = p.perm[r];
  *valid = p.inv[i] == 0;
  bool f = r == 0;
  if (!f) {
    const long long j = p.perm[r - 1];
    for (int k = 0; k < p.n_keys && !f; ++k) f = key_at(p, k, i) != key_at(p, k, j);
  }
  *first = f && *valid;
}

// Block-wide exclusive scan of one count per thread; *total gets the sum.
__device__ long long block_excl_scan(long long x, long long* total) {
  __shared__ long long warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    const long long o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nw ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += o;
    }
    if (lane < nw) warp_sums[lane] = w;
  }
  __syncthreads();
  const long long before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[nw - 1];
  __syncthreads();
  return before + incl - x;
}

__global__ void gids_count(KeyedGidsParams p) {
  const long long r0 = (long long)blockIdx.x * kGidsTile + (long long)threadIdx.x * kGidsItems;
  long long nf = 0, nv = 0;
  for (int t = 0; t < kGidsItems; ++t) {
    const long long r = r0 + t;
    if (r >= p.n) break;
    bool valid, first;
    flags_at(p, r, &valid, &first);
    nf += first ? 1 : 0;
    nv += valid ? 1 : 0;
  }
  long long tf, tv;
  block_excl_scan(nf, &tf);
  block_excl_scan(nv, &tv);
  if (threadIdx.x == 0) {
    p.block[2 * blockIdx.x] = tf;
    p.block[2 * blockIdx.x + 1] = tv;
  }
}

// One block: tile offsets (exclusive, in place), the totals, and the end
// of the last group.
__global__ void gids_offsets(KeyedGidsParams p) {
  const long long per = (p.n_blocks + blockDim.x - 1) / blockDim.x;
  const long long b0 = (long long)threadIdx.x * per;
  const long long b1 = b0 + per < p.n_blocks ? b0 + per : p.n_blocks;
  long long sf = 0, sv = 0;
  for (long long b = b0; b < b1; ++b) {
    sf += p.block[2 * b];
    sv += p.block[2 * b + 1];
  }
  long long total_f, total_v;
  long long run = block_excl_scan(sf, &total_f);
  block_excl_scan(sv, &total_v);
  for (long long b = b0; b < b1; ++b) {
    const long long c = p.block[2 * b];
    p.block[2 * b] = run;
    run += c;
  }
  if (threadIdx.x == 0) {
    p.counts[0] = total_f;
    p.counts[1] = total_v;
    p.starts[total_f] = (int32_t)total_v;
  }
}

__global__ void gids_apply(KeyedGidsParams p) {
  const long long r0 = (long long)blockIdx.x * kGidsTile + (long long)threadIdx.x * kGidsItems;
  bool valid[kGidsItems], first[kGidsItems];
  long long nf = 0;
  for (int t = 0; t < kGidsItems; ++t) {
    const long long r = r0 + t;
    valid[t] = first[t] = false;
    if (r < p.n) flags_at(p, r, &valid[t], &first[t]);
    nf += first[t] ? 1 : 0;
  }
  long long total;
  long long g = p.block[2 * blockIdx.x] + block_excl_scan(nf, &total) - 1;
  for (int t = 0; t < kGidsItems; ++t) {
    const long long r = r0 + t;
    if (r >= p.n) break;
    if (first[t]) {
      ++g;
      p.starts[g] = (int32_t)r;
    }
    const int32_t id = valid[t] ? (int32_t)g : INT32_MAX;
    const long long i = p.perm[r];
    if (p.s2 != nullptr) p.s2[r] = id;
    if (p.gid_in != nullptr) p.gid_in[i] = id;
    for (int k = 0; k < p.n_keys; ++k) {
      if (p.sk[k] == nullptr) continue;
      if (p.key_bytes[k] == 8) {
        static_cast<long long*>(p.sk[k])[r] = static_cast<const long long*>(p.keys[k])[i];
      } else {
        static_cast<int32_t*>(p.sk[k])[r] = static_cast<const int32_t*>(p.keys[k])[i];
      }
    }
  }
}

}  // namespace

extern "C" cudaError_t key_encode_launch(const KeyEncodeParams* params,
                                         cudaStream_t stream) {
  const KeyEncodeParams& p = *params;
  if (p.n == 0) return cudaSuccess;
  long long blocks = (p.n + kEncodeThreads - 1) / kEncodeThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  key_encode_kernel<<<(unsigned)blocks, kEncodeThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

extern "C" long long keyed_gids_blocks(long long n) {
  return (n + kGidsTile - 1) / kGidsTile;
}

extern "C" cudaError_t keyed_gids_launch(const KeyedGidsParams* params,
                                         cudaStream_t stream) {
  const KeyedGidsParams& p = *params;
  if (p.n_blocks > 0) {
    gids_count<<<(unsigned)p.n_blocks, kGidsThreads, 0, stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  gids_offsets<<<1, 1024, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_blocks == 0) return err;
  gids_apply<<<(unsigned)p.n_blocks, kGidsThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
