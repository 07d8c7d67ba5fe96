// PyTorch bindings of the port's CUDA kernels: fill each launch's
// parameters from the tensors, size the grids and launch on the current
// stream.  The only source of the extension that includes PyTorch's
// headers.  The Python wrappers (ops/kernels.py, ops/window_kernel.py)
// check devices, dtypes, shapes and layouts before calling in, and
// allocate every output and scratch tensor, except the segmented scan's
// look-back words, which persist here from call to call (scan_scratch).

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include <algorithm>
#include <cstring>
#include <map>
#include <mutex>
#include <utility>
#include <vector>

#include "df32_agg.h"
#include "expr_eval.h"
#include "join_probe.h"
#include "keyed.h"
#include "keyed_fold.h"
#include "mesh_reduce.h"
#include "mesh_route.h"
#include "ord_extremum.h"
#include "partition_id.h"
#include "radix_sort.h"
#include "range_extremum.h"
#include "seg_scan.h"
#include "segment_agg.h"
#include "segment_agg_entries.h"
#include "window_epilogue.h"
#include "x32_merge.h"

namespace {

// A rejected input raises ValueError, as the Python wrappers' own checks
// do: the segment aggregate's wrappers leave their per-batch checks to
// the binding, where they cost no Python time.
#define SEG_CHECK(cond, ...)                                                \
  do {                                                                      \
    if (!(cond)) throw pybind11::value_error(c10::str(__VA_ARGS__));        \
  } while (0)

// An empty tensor stands for a null (all-true) mask.
const bool* mask_ptr(const at::Tensor& t, int64_t n, const at::Device& dev,
                     const char* name) {
  if (t.numel() == 0) return nullptr;
  SEG_CHECK(t.device() == dev, name, " must be on ", dev);
  SEG_CHECK(t.scalar_type() == at::kBool, name, " must be bool");
  SEG_CHECK(t.dim() == 1 && t.size(0) == n, name, " must be [", n, "]");
  SEG_CHECK(t.is_contiguous(), name, " must be contiguous");
  return t.data_ptr<bool>();
}

int sm_count() {
  return at::cuda::getCurrentDeviceProperties()->multiProcessorCount;
}

// Fills a descriptor's per-row pointers from one entry's tensors.
void seg_agg_rows(SegAggParams& p, const at::Tensor& gid, const at::Tensor& tail,
                  const at::Tensor& pred, const at::Tensor& pvalid,
                  const std::vector<at::Tensor>& values,
                  const std::vector<at::Tensor>& valids, const at::Device& dev) {
  SEG_CHECK(gid.device() == dev && gid.scalar_type() == at::kInt &&
                  gid.dim() == 1 && gid.is_contiguous(),
              "gid must be contiguous int32 [n] on ", dev);
  const int64_t n = gid.size(0);
  const int64_t n_cols = (int64_t)values.size();
  TORCH_CHECK(n_cols == (int64_t)valids.size() && n_cols <= kSegAggMaxCols,
              "columns ", n_cols);
  p.n = n;
  p.gid = gid.data_ptr<int32_t>();
  p.tail = mask_ptr(tail, n, dev, "tail");
  p.pred = mask_ptr(pred, n, dev, "pred");
  p.pvalid = mask_ptr(pvalid, n, dev, "pvalid");
  SEG_CHECK(p.pvalid == nullptr || p.pred != nullptr, "pvalid without pred");
  for (int64_t c = 0; c < kSegAggMaxCols; ++c) {
    p.values[c] = nullptr;
    p.valids[c] = nullptr;
  }
  for (int64_t c = 0; c < n_cols; ++c) {
    const at::Tensor& v = values[c];
    p.valids[c] = mask_ptr(valids[c], n, dev, "validity");
    if (v.numel() == 0) continue;
    SEG_CHECK(v.device() == dev && (v.scalar_type() == at::kDouble || v.scalar_type() == at::kLong) &&
                  v.dim() == 1 && v.size(0) == n && v.is_contiguous(),
              "column ", c, " must be contiguous f64/i64 [", n, "] on ", dev);
    p.values[c] = v.data_ptr();
  }
}

// Fills a descriptor's fields (ops, the fold map, n_fields, n_folds,
// capacity) from the state and the wrapper's fold map; each fold's op
// must match its column, each field's op its fold's.
void seg_agg_fields(SegAggParams& p, const std::vector<at::Tensor>& values,
                    const std::vector<int64_t>& ops, const std::vector<int64_t>& field_fold,
                    const std::vector<int64_t>& fold_ops,
                    const std::vector<int64_t>& fold_cols, const at::Tensor& state) {
  const int64_t nf = state.size(0);
  const int64_t cap = state.size(1);
  const int64_t n_cols = (int64_t)values.size();
  const int64_t n_folds = (int64_t)fold_ops.size();
  SEG_CHECK(nf >= 1 && nf <= kSegAggMaxFields, "n_fields ", nf);
  SEG_CHECK(cap >= 1, "capacity ", cap);
  SEG_CHECK((int64_t)ops.size() == nf && (int64_t)field_fold.size() == nf,
              "one op and one fold per state field");
  SEG_CHECK(n_folds >= 1 && n_folds <= nf && (int64_t)fold_cols.size() == n_folds,
              "folds ", n_folds);
  for (int64_t k = 0; k < n_folds; ++k) {
    const int64_t op = fold_ops[k];
    const int64_t c = fold_cols[k];
    SEG_CHECK(op >= SA_COUNT && op <= SA_MAX_I64, "op ", op);
    SEG_CHECK(c >= -1 && c < n_cols, "fold column ", c);
    if (op != SA_COUNT) {
      SEG_CHECK(c >= 0 && p.values[c] != nullptr, "fold ", k, " needs values");
      const bool is_f64 = op == SA_ADD_F64 || op == SA_MIN_F64 || op == SA_MAX_F64;
      SEG_CHECK(values[c].scalar_type() == (is_f64 ? at::kDouble : at::kLong),
                  "fold ", k, ": value dtype does not match its op");
    }
    p.fold_ops[k] = (int8_t)op;
    p.fold_cols[k] = (int8_t)c;
  }
  for (int64_t f = 0; f < nf; ++f) {
    const int64_t k = field_fold[f];
    SEG_CHECK(k >= 0 && k < n_folds && ops[f] == fold_ops[k], "field ", f, ": fold ", k);
    p.ops[f] = (int8_t)ops[f];
    p.field_fold[f] = (int8_t)k;
  }
  int next = 0;  // the fields grouped by fold, each fold's in field order
  for (int64_t k = 0; k < n_folds; ++k) {
    p.fold_first[k] = (int8_t)next;
    for (int64_t f = 0; f < nf; ++f) {
      if (field_fold[f] == k) p.fold_fields[next++] = (int8_t)f;
    }
  }
  p.fold_first[n_folds] = (int8_t)next;
  p.n_fields = (int)nf;
  p.n_folds = (int)n_folds;
  p.capacity = cap;
}

void check_state(const at::Tensor& state) {
  SEG_CHECK(state.is_cuda(), "state must be a CUDA tensor");
  SEG_CHECK(state.scalar_type() == at::kLong && state.dim() == 2 &&
                  state.is_contiguous(),
              "state must be contiguous int64 [n_fields, capacity]");
}

void segment_agg(const at::Tensor& gid, const at::Tensor& tail,
                 const at::Tensor& pred, const at::Tensor& pvalid,
                 const std::vector<at::Tensor>& values,
                 const std::vector<at::Tensor>& valids,
                 const std::vector<int64_t>& ops, const std::vector<int64_t>& field_fold,
                 const std::vector<int64_t>& fold_ops,
                 const std::vector<int64_t>& fold_cols, at::Tensor state) {
  check_state(state);
  const at::Device dev = state.device();
  c10::cuda::CUDAGuard guard(dev);
  SegAggParams p{};
  seg_agg_rows(p, gid, tail, pred, pvalid, values, valids, dev);
  seg_agg_fields(p, values, ops, field_fold, fold_ops, fold_cols, state);
  segment_agg_plan(&p, sm_count());
  at::Tensor partial;
  if (p.n > 0 && !p.direct) {
    partial = at::empty({p.n_chunks, p.n_folds, p.capacity}, state.options());
    // int64_t is `long` here, the kernel's words `long long`: same width
    p.partial = reinterpret_cast<long long*>(partial.data_ptr<int64_t>());
  }
  p.state = reinterpret_cast<long long*>(state.data_ptr<int64_t>());

  C10_CUDA_CHECK(segment_agg_launch(&p, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Every entry folded into one state, in entry order: the chunk table of
// all entries (each cut by the one-batch rule for its own rows) and the
// entry descriptors cross to the device in one copy; the table runs in
// rounds whose chunk partials fit the scratch budget (and the grid's
// 65535 rows), each round a pass 1 and a pass 2.
void segment_agg_entries_(const std::vector<at::Tensor>& gids,
                          const std::vector<at::Tensor>& tails,
                          const std::vector<at::Tensor>& preds,
                          const std::vector<at::Tensor>& pvalids,
                          const std::vector<std::vector<at::Tensor>>& values,
                          const std::vector<std::vector<at::Tensor>>& valids,
                          const std::vector<int64_t>& ops,
                          const std::vector<int64_t>& field_fold,
                          const std::vector<int64_t>& fold_ops,
                          const std::vector<int64_t>& fold_cols, at::Tensor state) {
  check_state(state);
  const at::Device dev = state.device();
  c10::cuda::CUDAGuard guard(dev);
  const size_t n_entries = gids.size();
  SEG_CHECK(n_entries >= 1 && tails.size() == n_entries &&
                  preds.size() == n_entries && pvalids.size() == n_entries &&
                  values.size() == n_entries && valids.size() == n_entries,
              "one gid, tail, pred, pvalid, values and valids per entry");
  std::vector<SegAggParams> entries(n_entries);
  std::vector<SegAggChunk> chunks;
  const int sms = sm_count();
  for (size_t e = 0; e < n_entries; ++e) {
    SegAggParams& p = entries[e];
    p = SegAggParams{};
    seg_agg_rows(p, gids[e], tails[e], preds[e], pvalids[e], values[e], valids[e], dev);
    seg_agg_fields(p, values[e], ops, field_fold, fold_ops, fold_cols, state);
    segment_agg_plan(&p, sms);
    for (int64_t k = 0; k < p.n_chunks; ++k) {  // none for an empty entry
      SegAggChunk c{};
      c.r0 = k * p.rows_per_chunk;
      c.r1 = std::min<int64_t>(p.n, c.r0 + p.rows_per_chunk);
      c.entry = (int)e;
      chunks.push_back(c);
    }
  }
  if (chunks.empty()) return;

  // rounds: consecutive chunks whose partials fit the scratch budget
  const int64_t chunk_bytes = (int64_t)entries[0].n_folds * entries[0].capacity * 8;
  const int64_t per_round =
      std::max<int64_t>(1, std::min<int64_t>(65535, kSegAggScratchBudget / chunk_bytes));
  const int64_t total = (int64_t)chunks.size();
  const int64_t widest = std::min<int64_t>(per_round, total);

  const size_t table_bytes =
      n_entries * sizeof(SegAggParams) + chunks.size() * sizeof(SegAggChunk);
  // pinned, so the copy does not hold the host (PyTorch's host allocator
  // keeps the buffer until the copy on the stream is done)
  at::Tensor host = at::empty({(int64_t)table_bytes},
                              at::TensorOptions().dtype(at::kByte).pinned_memory(true));
  uint8_t* h = host.data_ptr<uint8_t>();
  std::memcpy(h, entries.data(), n_entries * sizeof(SegAggParams));
  std::memcpy(h + n_entries * sizeof(SegAggParams), chunks.data(),
              chunks.size() * sizeof(SegAggChunk));
  at::Tensor table = host.to(dev, /*non_blocking=*/true);
  const auto* d_entries = reinterpret_cast<const SegAggParams*>(table.data_ptr());
  const auto* d_chunks = reinterpret_cast<const SegAggChunk*>(
      static_cast<const uint8_t*>(table.data_ptr()) + n_entries * sizeof(SegAggParams));

  at::Tensor partial =
      at::empty({widest, (int64_t)entries[0].n_folds, state.size(1)}, state.options());
  SegAggParams common = entries[0];
  common.partial = reinterpret_cast<long long*>(partial.data_ptr<int64_t>());
  common.state = reinterpret_cast<long long*>(state.data_ptr<int64_t>());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  for (int64_t first = 0; first < total; first += per_round) {
    common.n_chunks = (int)std::min<int64_t>(per_round, total - first);
    C10_CUDA_CHECK(segment_agg_entries_launch(&common, d_entries, d_chunks, first, stream));
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// An empty tensor stands for a null pointer.
template <typename T>
T* opt(const at::Tensor& t) {
  return t.numel() == 0 ? nullptr : static_cast<T*>(t.data_ptr());
}

void launched(cudaError_t err) {
  C10_CUDA_CHECK(err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

RadixSortParams radix_params(const std::vector<at::Tensor>& keys) {
  RadixSortParams p{};
  TORCH_CHECK(!keys.empty() && keys.size() <= kRadixMaxKeys, "radix_sort: keys");
  p.n_keys = (int)keys.size();
  p.n = keys[0].size(0);
  for (int k = 0; k < p.n_keys; ++k) {
    p.keys[k] = keys[k].data_ptr();
    p.key_bytes[k] = (int)keys[k].element_size();
  }
  return p;
}

void radix_sort_plan_(const std::vector<at::Tensor>& keys, at::Tensor scratch) {
  c10::cuda::CUDAGuard guard(scratch.device());
  RadixSortParams p = radix_params(keys);
  launched(radix_sort_plan(&p, scratch.data_ptr(), (size_t)scratch.nbytes(),
                           at::cuda::getCurrentCUDAStream()));
}

int64_t radix_sort_scratch_bytes_(const std::vector<at::Tensor>& keys) {
  RadixSortParams p = radix_params(keys);
  return (int64_t)radix_sort_scratch_bytes(p.n, p.n_keys, radix_sort_candidates(&p));
}

void radix_sort_(const std::vector<at::Tensor>& keys, at::Tensor perm,
                 const at::Tensor& scratch, bool small) {
  c10::cuda::CUDAGuard guard(perm.device());
  RadixSortParams p = radix_params(keys);
  launched(radix_sort(&p, perm.data_ptr<int32_t>(), small ? nullptr : scratch.data_ptr(),
                      small ? 0 : (size_t)scratch.nbytes(), small,
                      at::cuda::getCurrentCUDAStream()));
}

// The look-back's words of the scans on one stream of one device, kept
// across calls (seg_scan.h: SegScanParams::words): a call takes the next
// tag, and only a new or regrown buffer is cleared.  Launches on one stream
// run in order, so one buffer a stream is never used by two scans at once.
struct ScanScratch {
  at::Tensor buf;  // int64: the header and status words, then the values
  long long status_cap = 0;
  long long value_cap = 0;
  unsigned tag = 0;
};

std::mutex g_scan_mutex;
// never freed: a tensor destroyed at exit may outlive the CUDA context
auto* g_scan_scratch = new std::map<std::pair<int, cudaStream_t>, ScanScratch>();

// Fills p.words .. p.fresh for a call of ``n_tiles`` tiles on ``dev``.
void scan_scratch(SegScanParams& p, long long n_tiles, const at::Device& dev) {
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  std::lock_guard<std::mutex> lock(g_scan_mutex);
  ScanScratch& s = (*g_scan_scratch)[{dev.index(), stream}];
  const long long values = 4 * n_tiles * p.n_cols;  // two tagged halves, two words
  p.fresh = 0;
  if (!s.buf.defined() || n_tiles > s.status_cap || values > s.value_cap) {
    s.status_cap = std::max(s.status_cap, (n_tiles + 63) / 64 * 64);
    s.value_cap = std::max(s.value_cap, values);
    const long long words = (kScanHeaderWords + s.status_cap) / 2 + s.value_cap;
    s.buf = at::empty({words}, at::TensorOptions().dtype(at::kLong).device(dev));
    p.fresh = 1;
  }
  if (++s.tag >= kScanTagMax) {
    s.tag = 1;
    p.fresh = 1;
  }
  p.words = reinterpret_cast<unsigned*>(s.buf.data_ptr<int64_t>());
  p.status_cap = s.status_cap;
  p.values_scratch = reinterpret_cast<long long*>(s.buf.data_ptr<int64_t>()) +
                     (kScanHeaderWords + s.status_cap) / 2;
  p.value_cap = s.value_cap;
  p.tag = s.tag;
}

// ``codes``: each column's src | op << 8 | in_i64 << 16 | width << 24.
void seg_scan_(int64_t n, const at::Tensor& perm, const at::Tensor& flag,
               const at::Tensor& key, const at::Tensor& aux, bool reverse,
               const std::vector<at::Tensor>& values,
               const std::vector<at::Tensor>& valids,
               const std::vector<at::Tensor>& values2,
               const std::vector<int64_t>& codes,
               const std::vector<at::Tensor>& outs, const at::Tensor& state,
               const at::Tensor& state32, const std::vector<int64_t>& field_col,
               const std::vector<int64_t>& field_op) {
  const at::Device dev = (key.numel() ? key : flag.numel() ? flag : perm).device();
  c10::cuda::CUDAGuard guard(dev);
  SegScanParams p{};
  p.n = n;
  p.perm = opt<const int32_t>(perm);
  p.flag = opt<const uint8_t>(flag);
  p.key = opt<const int32_t>(key);
  p.aux = opt<const uint8_t>(aux);
  p.reverse = reverse ? 1 : 0;
  p.n_cols = (int)codes.size();
  TORCH_CHECK(p.n_cols >= 1 && p.n_cols <= kScanMaxCols && values.size() == codes.size() &&
                  valids.size() == codes.size() && values2.size() == codes.size() &&
                  outs.size() == codes.size(),
              "seg_scan: columns");
  for (int c = 0; c < p.n_cols; ++c) {
    const int64_t code = codes[c];
    p.values[c] = opt<const void>(values[c]);
    p.valid[c] = opt<const bool>(valids[c]);
    p.values2[c] = opt<const void>(values2[c]);
    p.src[c] = (int8_t)(code & 0xff);
    p.op[c] = (int8_t)((code >> 8) & 0xff);
    p.in_i64[c] = (int8_t)((code >> 16) & 0xff);
    p.width[c] = (int8_t)((code >> 24) & 0xff);
    p.out[c] = reinterpret_cast<long long*>(opt<int64_t>(outs[c]));
  }
  p.state = reinterpret_cast<long long*>(opt<int64_t>(state));
  p.state32 = opt<int32_t>(state32);
  TORCH_CHECK(p.state == nullptr || p.state32 == nullptr, "seg_scan: two states");
  if (p.state != nullptr || p.state32 != nullptr) {
    TORCH_CHECK(p.key != nullptr && !reverse, "seg_scan: a state takes keys, forward");
    p.capacity = p.state != nullptr ? state.size(1) : state32.size(1);
    p.n_fields = (int)field_col.size();
    TORCH_CHECK(p.n_fields <= kSegAggMaxFields && field_op.size() == field_col.size(),
                "seg_scan: fields");
    for (int f = 0; f < p.n_fields; ++f) {
      p.field_col[f] = (int8_t)field_col[f];
      p.field_op[f] = (int8_t)field_op[f];
    }
  }
  if (n == 0) return;
  scan_scratch(p, seg_scan_tiles(n, p.n_cols), dev);
  launched(seg_scan_launch(&p, at::cuda::getCurrentCUDAStream()));
}

// The plan a launch over ``n`` rows of ``n_cols`` columns takes
// (seg_scan.h:scan_plan) and the kernel's registers, local bytes, CTAs an
// SM and grid at it, on the current device: (threads, rows, tile, shared
// bytes, registers, local bytes, CTAs an SM, grid).
std::vector<int64_t> seg_scan_describe_(int64_t n, int64_t n_cols) {
  long long out[8];
  launched(seg_scan_describe(n, (int)n_cols, out));
  return std::vector<int64_t>(out, out + 8);
}

void range_extremum_(int64_t op, int64_t depth, const at::Tensor& perm,
                     const at::Tensor& values, const at::Tensor& valid,
                     bool in_i64, const at::Tensor& seg_first,
                     const at::Tensor& seg_last, bool has_start, int64_t start,
                     bool has_end, int64_t end, at::Tensor table,
                     at::Tensor out) {
  c10::cuda::CUDAGuard guard(out.device());
  RangeExtremumParams p{};
  p.n = out.size(0);
  p.op = (int)op;
  p.depth = (int)depth;
  p.perm = perm.data_ptr<int32_t>();
  p.values = values.data_ptr();
  p.value_bytes = (int)values.element_size();
  p.valid = opt<const bool>(valid);
  p.in_i64 = in_i64 ? 1 : 0;
  p.seg_first = reinterpret_cast<const long long*>(seg_first.data_ptr<int64_t>());
  p.seg_last = reinterpret_cast<const long long*>(seg_last.data_ptr<int64_t>());
  p.has_start = has_start ? 1 : 0;
  p.start = start;
  p.has_end = has_end ? 1 : 0;
  p.end = end;
  p.table = reinterpret_cast<long long*>(table.data_ptr<int64_t>());
  p.out = reinterpret_cast<long long*>(out.data_ptr<int64_t>());
  launched(range_extremum_launch(&p, at::cuda::getCurrentCUDAStream()));
}

void window_flags_(const at::Tensor& perm, const std::vector<at::Tensor>& keys,
                   int64_t n_part, at::Tensor seg_flag, at::Tensor peer_flag) {
  c10::cuda::CUDAGuard guard(perm.device());
  WindowFlagsParams p{};
  p.n = perm.size(0);
  p.perm = perm.data_ptr<int32_t>();
  TORCH_CHECK(keys.size() <= kWindowMaxKeys, "window_flags: keys");
  p.n_keys = (int)keys.size();
  for (int k = 0; k < p.n_keys; ++k) {
    p.keys[k] = keys[k].data_ptr();
    p.key_bytes[k] = (int)keys[k].element_size();
  }
  p.n_part = (int)n_part;
  p.seg_flag = seg_flag.data_ptr<uint8_t>();
  p.peer_flag = peer_flag.data_ptr<uint8_t>();
  launched(window_flags_launch(&p, at::cuda::getCurrentCUDAStream()));
}

void window_pack_(const at::Tensor& perm, at::Tensor inv, const at::Tensor& sf,
                  const at::Tensor& sl, const at::Tensor& pf,
                  const at::Tensor& pl, const at::Tensor& desc,
                  at::Tensor out) {
  c10::cuda::CUDAGuard guard(out.device());
  WindowPackParams p{};
  p.n = out.size(1);
  p.n_rows = (int)out.size(0);
  p.perm = perm.data_ptr<int32_t>();
  p.inv = inv.data_ptr<int32_t>();
  p.sf = reinterpret_cast<const long long*>(opt<const int64_t>(sf));
  p.sl = reinterpret_cast<const long long*>(opt<const int64_t>(sl));
  p.pf = reinterpret_cast<const long long*>(opt<const int64_t>(pf));
  p.pl = reinterpret_cast<const long long*>(opt<const int64_t>(pl));
  p.desc = reinterpret_cast<const long long*>(desc.data_ptr<int64_t>());
  p.out = out.data_ptr();
  p.out_bytes = (int)out.element_size();
  launched(window_pack_launch(&p, at::cuda::getCurrentCUDAStream()));
}

void partition_ids_(const at::Tensor& bits, const at::Tensor& nulls,
                    int64_t n_out, at::Tensor out) {
  c10::cuda::CUDAGuard guard(out.device());
  PartitionIdParams p{};
  p.n = out.size(0);
  p.n_cols = (int)bits.size(0);
  p.bits = reinterpret_cast<const long long*>(bits.data_ptr<int64_t>());
  p.nulls = reinterpret_cast<const uint8_t*>(nulls.data_ptr<bool>());
  p.n_out = (unsigned int)n_out;
  p.out = out.data_ptr<int32_t>();
  launched(partition_id_launch(&p, at::cuda::getCurrentCUDAStream()));
}

void join_build_table_(const at::Tensor& bkeys, int64_t kmin, at::Tensor table) {
  c10::cuda::CUDAGuard guard(table.device());
  JoinBuildParams p{};
  p.m = bkeys.size(0);
  p.bkeys = bkeys.data_ptr();
  p.key_bytes = (int)bkeys.element_size();
  p.kmin = kmin;
  p.span = table.size(0);
  p.table = table.data_ptr<int32_t>();
  launched(join_build_table_launch(&p, at::cuda::getCurrentCUDAStream()));
}

// Empty tensors stand for null masks and for the form not taken.
void join_probe_(const at::Tensor& pkey, const at::Tensor& pkey_valid,
                 const at::Tensor& valid, const at::Tensor& table, int64_t kmin,
                 const at::Tensor& bkeys, const std::vector<at::Tensor>& bvals,
                 const std::vector<at::Tensor>& bvalids,
                 const std::vector<at::Tensor>& out_vals,
                 const std::vector<at::Tensor>& out_valids, at::Tensor mask) {
  c10::cuda::CUDAGuard guard(mask.device());
  TORCH_CHECK((int64_t)bvals.size() <= kJoinMaxCols, "join_probe: build columns");
  JoinProbeParams p{};
  p.n = pkey.size(0);
  p.pkey = pkey.data_ptr();
  p.key_bytes = (int)pkey.element_size();
  p.pkey_valid = opt<const uint8_t>(pkey_valid);
  p.valid = opt<const uint8_t>(valid);
  p.table = opt<const int32_t>(table);
  p.span = table.numel();
  p.kmin = kmin;
  p.bkeys = bkeys.numel() ? bkeys.data_ptr() : nullptr;
  p.m = bkeys.numel();
  p.n_cols = (int)bvals.size();
  for (int c = 0; c < p.n_cols; ++c) {
    p.bvals[c] = bvals[c].data_ptr();
    p.val_bytes[c] = (int)bvals[c].element_size();
    p.bvalids[c] = opt<const uint8_t>(bvalids[c]);
    p.out_vals[c] = out_vals[c].data_ptr();
    p.out_valids[c] = static_cast<uint8_t*>(out_valids[c].data_ptr());
  }
  p.mask = static_cast<uint8_t*>(mask.data_ptr());
  launched(join_probe_launch(&p, at::cuda::getCurrentCUDAStream()));
}

// Key codes and the sort operand of one batch; empty tensors stand for
// null masks and validities.
void key_encode_(int64_t n, const std::vector<at::Tensor>& masks, at::Tensor inv,
                 const std::vector<int64_t>& kinds,
                 const std::vector<int64_t>& in_types,
                 const std::vector<at::Tensor>& values,
                 const std::vector<at::Tensor>& valids,
                 const std::vector<at::Tensor>& outs) {
  c10::cuda::CUDAGuard guard(inv.device());
  TORCH_CHECK(masks.size() == 3, "key_encode: three masks");
  TORCH_CHECK((int64_t)kinds.size() <= kKeyedMaxKeys, "key_encode: keys");
  KeyEncodeParams p{};
  p.n = n;
  for (int j = 0; j < 3; ++j) p.masks[j] = opt<const uint8_t>(masks[j]);
  p.inv = inv.data_ptr<int32_t>();
  p.n_keys = (int)kinds.size();
  for (int k = 0; k < p.n_keys; ++k) {
    p.kind[k] = (int8_t)kinds[k];
    p.in_type[k] = (int8_t)in_types[k];
    p.values[k] = values[k].data_ptr();
    p.valid[k] = opt<const uint8_t>(valids[k]);
    p.out[k] = outs[k].data_ptr();
  }
  p.out_bytes = outs.empty() ? 8 : (int)outs[0].element_size();
  launched(key_encode_launch(&p, at::cuda::getCurrentCUDAStream()));
}

// The sort operands of every pending batch of a keyed stage in one
// launch: inv and either the folded word (comb) or one code column a key
// (outs).  Per entry: its row masks (three; empty = none) and per key its
// values (or host codes) and validity (empty = all valid).  code_bytes is
// the stage's code width (8, or x32's 4): the fold rebases the words K1
// would sort unfolded.
void keyed_encode_entries_(at::Tensor inv, at::Tensor comb, const std::vector<at::Tensor>& outs,
                           int64_t code_bytes, const std::vector<int64_t>& kinds,
                           const std::vector<int64_t>& in_types,
                           const std::vector<int64_t>& fold_min,
                           const std::vector<int64_t>& fold_shift,
                           const std::vector<std::vector<at::Tensor>>& masks,
                           const std::vector<std::vector<at::Tensor>>& values,
                           const std::vector<std::vector<at::Tensor>>& valids) {
  const at::Device dev = inv.device();
  c10::cuda::CUDAGuard guard(dev);
  const size_t n_entries = masks.size();
  TORCH_CHECK(n_entries >= 1 && n_entries <= (size_t)kFoldMaxEntries &&
                  values.size() == n_entries && valids.size() == n_entries,
              "keyed_encode_entries: 1 to ", kFoldMaxEntries, " entries");
  const int n_keys = (int)kinds.size();
  TORCH_CHECK(n_keys >= 1 && n_keys <= kKeyedMaxKeys, "keyed_encode_entries: keys");
  const bool fold = comb.numel() > 0;
  TORCH_CHECK(fold ? fold_min.size() == (size_t)n_keys && fold_shift.size() == (size_t)n_keys
                   : outs.size() == (size_t)n_keys,
              "keyed_encode_entries: a fold plan or one output a key");
  TORCH_CHECK(code_bytes == 4 || code_bytes == 8, "keyed_encode_entries: code width");
  for (const at::Tensor& o : outs) {
    TORCH_CHECK(o.element_size() == code_bytes, "keyed_encode_entries: output width");
  }
  std::vector<KeyedEntry> table(n_entries);
  long long offset = 0;
  for (size_t e = 0; e < n_entries; ++e) {
    KeyedEntry& en = table[e];
    en = KeyedEntry{};
    TORCH_CHECK(masks[e].size() == 3 && values[e].size() == (size_t)n_keys &&
                    valids[e].size() == (size_t)n_keys,
                "keyed_encode_entries: entry ", e);
    en.offset = offset;
    en.n = values[e][0].size(0);
    for (int j = 0; j < 3; ++j) en.masks[j] = opt<const uint8_t>(masks[e][j]);
    for (int k = 0; k < n_keys; ++k) {
      en.values[k] = values[e][k].data_ptr();
      en.valid[k] = opt<const uint8_t>(valids[e][k]);
      en.in_type[k] = (int8_t)in_types[e * n_keys + k];
    }
    offset += en.n;
  }
  TORCH_CHECK(offset == inv.size(0), "keyed_encode_entries: ", offset, " rows for inv of ",
              inv.size(0));
  at::Tensor d_table = at::from_blob(table.data(),
                                     {(int64_t)(n_entries * sizeof(KeyedEntry))},
                                     at::TensorOptions().dtype(at::kByte))
                           .to(dev);  // a blocking copy: `table` may go after it
  KeyedEncodeEntriesParams p{};
  p.total = offset;
  p.n_entries = (int)n_entries;
  p.entries = reinterpret_cast<const KeyedEntry*>(d_table.data_ptr());
  p.n_keys = n_keys;
  p.inv = inv.data_ptr<int32_t>();
  p.fold = fold ? 1 : 0;
  p.comb = opt<int32_t>(comb);
  p.out_bytes = (int)code_bytes;
  for (int k = 0; k < n_keys; ++k) {
    p.kind[k] = (int8_t)kinds[k];
    if (fold) {
      p.fold_min[k] = fold_min[k];
      p.fold_shift[k] = (int)fold_shift[k];
    } else {
      p.out[k] = outs[k].data_ptr();
    }
  }
  launched(keyed_encode_entries_launch(&p, at::cuda::getCurrentCUDAStream()));
}

// Each group's key codes from the folded word of its first sorted row.
void keyed_unfold_(const at::Tensor& sk, const at::Tensor& starts, int64_t n_groups,
                   const std::vector<int64_t>& fold_min,
                   const std::vector<int64_t>& fold_shift,
                   const std::vector<int64_t>& fold_width, at::Tensor out) {
  c10::cuda::CUDAGuard guard(out.device());
  const int n_keys = (int)fold_min.size();
  TORCH_CHECK(n_keys <= kKeyedMaxKeys && fold_shift.size() == (size_t)n_keys &&
                  fold_width.size() == (size_t)n_keys && out.size(0) == n_keys,
              "keyed_unfold: one plan entry a key row");
  KeyedUnfoldParams p{};
  p.capacity = out.size(1);
  p.n_groups = n_groups;
  p.sk = sk.data_ptr<int32_t>();
  p.starts = starts.data_ptr<int32_t>();
  p.n_keys = n_keys;
  for (int k = 0; k < n_keys; ++k) {
    p.fold_min[k] = fold_min[k];
    p.fold_shift[k] = (int)fold_shift[k];
    p.fold_width[k] = (int)fold_width[k];
  }
  p.out = out.data_ptr();
  p.out_bytes = (int)out.element_size();
  launched(keyed_unfold_launch(&p, at::cuda::getCurrentCUDAStream()));
}

void keyed_gids_(const at::Tensor& perm, const at::Tensor& inv,
                 const std::vector<at::Tensor>& keys, at::Tensor s2,
                 at::Tensor gid_in, const std::vector<at::Tensor>& sk,
                 at::Tensor starts, at::Tensor counts, at::Tensor block) {
  c10::cuda::CUDAGuard guard(perm.device());
  TORCH_CHECK((int64_t)keys.size() <= kKeyedMaxKeys, "keyed_gids: keys");
  KeyedGidsParams p{};
  p.n = perm.size(0);
  p.perm = perm.data_ptr<int32_t>();
  p.inv = inv.data_ptr<int32_t>();
  p.n_keys = (int)keys.size();
  for (int k = 0; k < p.n_keys; ++k) {
    p.keys[k] = keys[k].data_ptr();
    p.key_bytes[k] = (int)keys[k].element_size();
    p.sk[k] = k < (int)sk.size() ? sk[k].data_ptr() : nullptr;
  }
  p.s2 = opt<int32_t>(s2);
  p.gid_in = opt<int32_t>(gid_in);
  p.starts = starts.data_ptr<int32_t>();
  p.counts = reinterpret_cast<long long*>(counts.data_ptr<int64_t>());
  p.n_blocks = keyed_gids_blocks(p.n);
  p.block = reinterpret_cast<long long*>(block.data_ptr<int64_t>());
  launched(keyed_gids_launch(&p, at::cuda::getCurrentCUDAStream()));
}

// One pass of the keyed finish: the pass's columns reduced over the valid
// sorted rows into their state rows of ``out``, and the key rows from
// ``key_row0`` on (no column: the key rows alone).
void keyed_finish_(const at::Tensor& perm, const at::Tensor& s2, const at::Tensor& starts,
                   int64_t n_groups, const std::vector<at::Tensor>& values,
                   const std::vector<at::Tensor>& valids,
                   const std::vector<at::Tensor>& values2, const std::vector<int64_t>& src,
                   const std::vector<int64_t>& op, const std::vector<int64_t>& in_i64,
                   const std::vector<int64_t>& width, const std::vector<int64_t>& field_col,
                   const std::vector<int64_t>& field_op,
                   const std::vector<int64_t>& field_ident, bool x32,
                   const std::vector<at::Tensor>& sk, int64_t key_row0, at::Tensor out,
                   at::Tensor head, at::Tensor tail, at::Tensor rec) {
  c10::cuda::CUDAGuard guard(out.device());
  KeyedFinishParams p{};
  p.n = perm.numel();
  p.capacity = out.size(1);
  p.n_groups = n_groups;
  p.perm = opt<const int32_t>(perm);
  p.s2 = opt<const int32_t>(s2);
  p.starts = starts.data_ptr<int32_t>();
  p.n_cols = (int)src.size();
  TORCH_CHECK(p.n_cols >= 1 && p.n_cols <= kFinishMaxCols, "keyed_finish: columns");
  for (int c = 0; c < p.n_cols; ++c) {
    p.values[c] = opt<const void>(values[c]);
    p.valid[c] = opt<const bool>(valids[c]);
    p.values2[c] = opt<const void>(values2[c]);
    p.src[c] = (int8_t)src[c];
    p.op[c] = (int8_t)op[c];
    p.in_i64[c] = (int8_t)in_i64[c];
    p.width[c] = (int8_t)width[c];
  }
  // a non-empty rec: each row's element words of the columns that read
  // memory (a count with no validity reads none), packed in column order
  int n_rec = 0;
  for (int c = 0; c < p.n_cols; ++c) {
    const bool reads = p.values[c] != nullptr || p.valid[c] != nullptr;
    p.slot[c] = (int8_t)(reads ? n_rec++ : -1);
  }
  p.rec = reinterpret_cast<long long*>(opt<int64_t>(rec));
  p.rec_words = p.rec != nullptr && p.n > 0 ? (int)(rec.numel() / p.n) : 0;
  TORCH_CHECK(p.rec == nullptr || (p.rec_words >= n_rec && rec.numel() == p.n * p.rec_words),
              "keyed_finish: packed rows");
  p.n_fields = (int)field_col.size();
  TORCH_CHECK(p.n_fields <= kFinishMaxFields && field_op.size() == field_col.size() &&
                  field_ident.size() == field_col.size(),
              "keyed_finish: fields");
  for (int f = 0; f < p.n_fields; ++f) {
    p.field_col[f] = (int8_t)field_col[f];
    p.field_op[f] = (int8_t)field_op[f];
    p.field_ident[f] = field_ident[f];
  }
  p.x32 = x32 ? 1 : 0;
  TORCH_CHECK((int64_t)sk.size() <= kKeyedMaxKeys, "keyed_finish: keys");
  p.n_keys = (int)sk.size();
  p.key_row0 = (int)key_row0;
  for (int k = 0; k < p.n_keys; ++k) {
    p.sk[k] = sk[k].data_ptr();
    p.key_bytes[k] = (int)sk[k].element_size();
  }
  p.out = out.data_ptr();
  p.out_bytes = (int)out.element_size();
  p.n_tiles = (p.n + kFinishTile - 1) / kFinishTile;
  p.head = reinterpret_cast<long long*>(opt<int64_t>(head));
  p.tail = reinterpret_cast<long long*>(opt<int64_t>(tail));
  launched(keyed_finish_launch(&p, at::cuda::getCurrentCUDAStream()));
}

void keyed_median_(const at::Tensor& perm, const at::Tensor& argnull,
                   const at::Tensor& ohi, const at::Tensor& olo,
                   const at::Tensor& starts, const at::Tensor& counts,
                   at::Tensor out) {
  c10::cuda::CUDAGuard guard(out.device());
  KeyedMedianParams p{};
  p.n = perm.size(0);
  p.capacity = out.size(1);
  p.perm = perm.data_ptr<int32_t>();
  p.argnull = argnull.data_ptr<int32_t>();
  p.ohi = ohi.data_ptr<int32_t>();
  p.olo = olo.data_ptr<int32_t>();
  p.starts = starts.data_ptr<int32_t>();
  p.counts = reinterpret_cast<const long long*>(counts.data_ptr<int64_t>());
  p.out = out.data_ptr();
  p.out_bytes = (int)out.element_size();
  launched(keyed_median_launch(&p, at::cuda::getCurrentCUDAStream()));
}

void corr_mask_(const at::Tensor& x, const at::Tensor& xvalid,
                const at::Tensor& y, const at::Tensor& yvalid, at::Tensor m) {
  c10::cuda::CUDAGuard guard(m.device());
  CorrMaskParams p{};
  p.n = m.size(0);
  auto type = [](const at::Tensor& t) {
    return t.scalar_type() == at::kLong ? CT_I64 : t.scalar_type() == at::kFloat ? CT_F32 : CT_F64;
  };
  p.x = x.data_ptr();
  p.x_type = type(x);
  p.xvalid = opt<const uint8_t>(xvalid);
  p.y = y.data_ptr();
  p.y_type = type(y);
  p.yvalid = opt<const uint8_t>(yvalid);
  p.m = static_cast<uint8_t*>(m.data_ptr());
  launched(corr_mask_launch(&p, at::cuda::getCurrentCUDAStream()));
}

void corr_center_(const at::Tensor& s2, const at::Tensor& perm,
                  const at::Tensor& x, const at::Tensor& y, const at::Tensor& m,
                  const at::Tensor& moments, at::Tensor xy, at::Tensor xx,
                  at::Tensor yy) {
  c10::cuda::CUDAGuard guard(xy.device());
  CorrCenterParams p{};
  p.n = perm.size(0);
  p.capacity = moments.size(1);
  p.s2 = s2.data_ptr<int32_t>();
  p.perm = perm.data_ptr<int32_t>();
  p.x = x.data_ptr();
  p.x_i64 = x.scalar_type() == at::kLong ? 1 : 0;
  p.y = y.data_ptr();
  p.y_i64 = y.scalar_type() == at::kLong ? 1 : 0;
  p.m = static_cast<const uint8_t*>(m.data_ptr());
  p.moments = reinterpret_cast<const long long*>(moments.data_ptr<int64_t>());
  p.xy = xy.data_ptr<double>();
  p.xx = xx.data_ptr<double>();
  p.yy = yy.data_ptr<double>();
  launched(corr_center_launch(&p, at::cuda::getCurrentCUDAStream()));
}

void corr_center_x32_(const at::Tensor& s2, const at::Tensor& perm,
                      const at::Tensor& xhi, const at::Tensor& xlo,
                      const at::Tensor& yhi, const at::Tensor& ylo, const at::Tensor& m,
                      const at::Tensor& moments, at::Tensor xy, at::Tensor xx,
                      at::Tensor yy) {
  c10::cuda::CUDAGuard guard(xy.device());
  CorrCenterX32Params p{};
  p.n = perm.size(0);
  p.capacity = moments.size(1);
  p.s2 = s2.data_ptr<int32_t>();
  p.perm = perm.data_ptr<int32_t>();
  p.xhi = xhi.data_ptr<float>();
  p.xlo = xlo.data_ptr<float>();
  p.yhi = yhi.data_ptr<float>();
  p.ylo = ylo.data_ptr<float>();
  p.m = static_cast<const uint8_t*>(m.data_ptr());
  p.moments = moments.data_ptr<int32_t>();
  p.xy = xy.data_ptr<float>();
  p.xx = xx.data_ptr<float>();
  p.yy = yy.data_ptr<float>();
  launched(corr_center_x32_launch(&p, at::cuda::getCurrentCUDAStream()));
}

// One launch of the expression program: ``words`` holds the code (32-byte
// rows) and then the IN tables, ``layout`` each register's ExprRegKind
// word with ``counts`` = (uniform slots, mask slots, 8- and 4-byte tile
// registers, scratch blocks), all on the card; ``inputs`` the env tensor
// of each input slot (an empty tensor: absent, or read by no leaf) and
// ``outputs`` each store's tensor (empty: not written); ``valid_bits`` and
// ``skip_bits`` (a word of 32 bits for every 32 rows of code) mark the
// registers whose validity this batch may carry and the rows a tile skips.
// Each input a leaf reads is staged, its element size its width; the
// launch sizes the tile from these (expr_eval.h:expr_plan).  The Python
// wrapper (ops/kernels.py:expr_eval_cuda) validates the program, checks
// every tensor and aligns the staged ones first.
void expr_eval_(const at::Tensor& words, const at::Tensor& layout, int64_t n_instr,
                int64_t n_regs, const std::vector<int64_t>& counts,
                const std::vector<int64_t>& valid_bits, const std::vector<int64_t>& skip_bits,
                const std::vector<at::Tensor>& inputs,
                const std::vector<at::Tensor>& outputs, int64_t n) {
  const at::Device dev = words.device();
  c10::cuda::CUDAGuard guard(dev);
  TORCH_CHECK(words.is_cuda() && words.scalar_type() == at::kLong &&
                  words.dim() == 1 && words.is_contiguous(),
              "expr_eval: code must be a contiguous int64 CUDA tensor");
  TORCH_CHECK(n_instr >= 1 && n_instr <= kExprMaxInstr && n_regs >= 0 &&
                  n_regs <= n_instr && words.size(0) >= 4 * n_instr,
              "expr_eval: code size");
  TORCH_CHECK(layout.device() == dev && layout.scalar_type() == at::kInt &&
                  layout.dim() == 1 && layout.is_contiguous() && layout.size(0) == n_regs,
              "expr_eval: layout must be a contiguous int32 [n_regs] tensor beside the code");
  TORCH_CHECK(counts.size() == 5,
              "expr_eval: counts are (uniform, mask, wide, narrow, scratch)");
  TORCH_CHECK(inputs.size() <= (size_t)kExprMaxInputs &&
                  outputs.size() <= (size_t)kExprMaxOutputs,
              "expr_eval: too many slots");
  ExprEvalParams p{};
  const int64_t* w = words.data_ptr<int64_t>();
  p.code = reinterpret_cast<const ExprInstr*>(w);
  p.consts = reinterpret_cast<const long long*>(w + 4 * n_instr);
  p.layout = n_regs ? layout.data_ptr<int32_t>() : nullptr;
  p.n = n;
  p.n_instr = (int)n_instr;
  p.n_regs = (int)n_regs;
  p.n_uniform = (int)counts[0];
  p.n_mask = (int)counts[1];
  p.n_wide = (int)counts[2];
  p.n_narrow = (int)counts[3];
  p.n_scratch = (int)counts[4];
  const size_t n_words = (size_t)(n_instr + 31) / 32;
  TORCH_CHECK(valid_bits.size() == n_words && skip_bits.size() == n_words,
              "expr_eval: a validity and a skip word for every 32 rows of code");
  for (size_t j = 0; j < n_words; ++j) {
    p.valid_bits[j] = (unsigned)valid_bits[j];
    p.skip_bits[j] = (unsigned)skip_bits[j];
  }
  for (size_t i = 0; i < inputs.size(); ++i) {
    const at::Tensor& x = inputs[i];
    p.stage_off[i] = -1;
    if (x.numel() == 0) continue;
    const int width = (int)x.element_size();
    TORCH_CHECK(x.device() == dev && x.is_contiguous() && x.numel() >= n &&
                    (width == 1 || width == 4 || width == 8) &&
                    reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0,
                "expr_eval: an input must be contiguous, 16-byte aligned, of 1, 4 or 8-byte "
                "elements, on the code's device");
    p.in[i] = x.data_ptr();
    p.width[i] = (unsigned char)width;
    p.staged_w[width == 1 ? 0 : width == 4 ? 1 : 2] += 1;
    p.staged[p.n_staged++] = (unsigned char)i;
  }
  for (size_t i = 0; i < outputs.size(); ++i) {
    const at::Tensor& x = outputs[i];
    TORCH_CHECK(x.numel() == 0 || (x.device() == dev && x.is_contiguous()),
                "expr_eval: output on another device");
    p.out[i] = x.numel() ? x.data_ptr() : nullptr;
  }
  launched(expr_eval_launch(&p, at::cuda::getCurrentCUDAStream()));
}

// The plan a launch over ``n`` rows takes (expr_eval.h:expr_plan, from the
// sizes expr_eval_ passes: ``counts`` as there, ``staged_w`` the staged
// slots of 1, 4 and 8 bytes) and the kernel's registers a thread, local
// bytes a thread and CTAs an SM at it, on the current device: (threads,
// rows, stages, shared bytes, registers, local bytes, CTAs an SM).
std::vector<int64_t> expr_eval_describe_(int64_t n, int64_t n_regs,
                                         const std::vector<int64_t>& counts,
                                         const std::vector<int64_t>& staged_w) {
  TORCH_CHECK(counts.size() == 5 && staged_w.size() == 3,
              "expr_eval_describe: counts are (uniform, mask, wide, narrow, scratch), "
              "staged_w (1, 4, 8 bytes)");
  int c[5], w[3];
  for (int j = 0; j < 5; ++j) c[j] = (int)counts[j];
  for (int j = 0; j < 3; ++j) w[j] = (int)staged_w[j];
  long long out[7];
  launched(expr_eval_describe(n, (int)n_regs, c, w, out));
  return std::vector<int64_t>(out, out + 7);
}

void mesh_reduce_(const std::vector<at::Tensor>& states, const std::vector<int64_t>& ops,
                  at::Tensor out, bool x32) {
  c10::cuda::CUDAGuard guard(out.device());
  TORCH_CHECK(!states.empty() && states.size() <= (size_t)kMeshMaxShards,
              "mesh_reduce: shard count");
  TORCH_CHECK(ops.size() == (size_t)out.size(0) && ops.size() <= (size_t)kSegAggMaxFields,
              "mesh_reduce: field count");
  MeshReduceParams p{};
  p.n_shards = (int)states.size();
  p.n_fields = (int)out.size(0);
  p.capacity = out.size(1);
  for (int s = 0; s < p.n_shards; ++s) {
    TORCH_CHECK(states[s].device() == out.device() && states[s].sizes() == out.sizes() &&
                    states[s].scalar_type() == out.scalar_type(),
                "mesh_reduce: shard state shape, dtype or device");
    p.states[s] = states[s].data_ptr();
  }
  TORCH_CHECK(out.scalar_type() == (x32 ? at::kInt : at::kLong), "mesh_reduce: state dtype");
  for (int f = 0; f < p.n_fields; ++f) p.ops[f] = (int8_t)ops[f];
  p.x32 = x32 ? 1 : 0;
  p.out = out.data_ptr();
  launched(mesh_reduce_launch(&p, at::cuda::getCurrentCUDAStream()));
}

// D: hi, lo [n_out, capacity] f32 and cnt [n_cnt, capacity] int32 written;
// ``partial`` is the [blocks x runs a block, slots + counts, capacity]
// scratch (df32_agg_plan: ceil(block / kDfRunRows) runs a block).  The
// Python wrapper (ops/kernels.py:df32_agg_cuda) checks every tensor first.
void df32_agg_(const at::Tensor& gid, const at::Tensor& tail, const at::Tensor& pred,
               const at::Tensor& pvalid, const std::vector<at::Tensor>& values,
               const std::vector<at::Tensor>& valids, const std::vector<int64_t>& slots,
               const std::vector<int64_t>& out_a, const std::vector<int64_t>& out_b,
               const std::vector<int64_t>& counts, int64_t capacity, int64_t block,
               int64_t nb, at::Tensor hi, at::Tensor lo, at::Tensor cnt,
               at::Tensor partial) {
  const at::Device dev = gid.device();
  c10::cuda::CUDAGuard guard(dev);
  TORCH_CHECK(values.size() == valids.size() && values.size() <= (size_t)kDfMaxCols &&
                  slots.size() <= (size_t)kDfMaxCols && out_a.size() <= (size_t)kDfMaxCols &&
                  out_a.size() == out_b.size() && counts.size() <= (size_t)kDfMaxCols,
              "df32_agg: sizes");
  Df32Params p{};
  p.n = gid.size(0);
  p.gid = gid.data_ptr<int32_t>();
  p.tail = mask_ptr(tail, p.n, dev, "tail");
  p.pred = mask_ptr(pred, p.n, dev, "pred");
  p.pvalid = mask_ptr(pvalid, p.n, dev, "pvalid");
  for (size_t c = 0; c < values.size(); ++c) {
    p.values[c] = opt<const float>(values[c]);
    p.valids[c] = mask_ptr(valids[c], p.n, dev, "validity");
  }
  p.n_slots = (int)slots.size();
  for (int j = 0; j < p.n_slots; ++j) p.slot_col[j] = (int8_t)slots[j];
  p.n_out = (int)out_a.size();
  for (int k = 0; k < p.n_out; ++k) {
    p.out_a[k] = (int8_t)out_a[k];
    p.out_b[k] = (int8_t)out_b[k];
  }
  p.n_cnt = (int)counts.size();
  for (int c = 0; c < p.n_cnt; ++c) p.cnt_col[c] = (int8_t)counts[c];
  p.capacity = capacity;
  p.block = block;
  p.nb = nb;
  p.n_real = (p.n + block - 1) / block;
  TORCH_CHECK(p.n_real <= nb && nb <= (1LL << kDfMaxLevels), "df32_agg: blocks");
  df32_agg_plan(&p);
  TORCH_CHECK(p.n_real * p.runs_per_block <= 0x7fffffffLL &&
                  (p.n_out + p.n_cnt) * ((capacity + 31) / 32) * 32 <= 0x7fffffffLL,
              "df32_agg: grid");
  TORCH_CHECK(partial.numel() >= p.n_real * p.runs_per_block * (p.n_slots + p.n_cnt) * capacity,
              "df32_agg: scratch");
  p.partial = reinterpret_cast<int32_t*>(partial.data_ptr());
  p.hi = opt<float>(hi);
  p.lo = opt<float>(lo);
  p.cnt = opt<int32_t>(cnt);
  launched(df32_agg_launch(&p, at::cuda::getCurrentCUDAStream()));
}

// E: ``out`` [1 or 2, capacity] int32 written, ``keys`` [capacity] uint64
// scratch (held in an int64 tensor).
void ord_extremum_(const at::Tensor& gid, const at::Tensor& tail, const at::Tensor& pred,
                   const at::Tensor& pvalid, const at::Tensor& valid, const at::Tensor& hi,
                   const at::Tensor& lo, int64_t kind, bool is_min, at::Tensor keys,
                   at::Tensor out) {
  const at::Device dev = gid.device();
  c10::cuda::CUDAGuard guard(dev);
  OrdParams p{};
  p.n = gid.size(0);
  p.gid = gid.data_ptr<int32_t>();
  p.tail = mask_ptr(tail, p.n, dev, "tail");
  p.pred = mask_ptr(pred, p.n, dev, "pred");
  p.pvalid = mask_ptr(pvalid, p.n, dev, "pvalid");
  p.valid = mask_ptr(valid, p.n, dev, "valid");
  p.hi = static_cast<const int32_t*>(hi.data_ptr());
  p.lo = opt<const int32_t>(lo);
  TORCH_CHECK((kind == ORD_PAIR) == (p.lo != nullptr) && kind >= 0 && kind <= 2,
              "ord_extremum: kind");
  p.kind = (int)kind;
  p.is_min = is_min ? 1 : 0;
  p.capacity = keys.size(0);
  TORCH_CHECK(out.size(1) == p.capacity && out.size(0) == (kind == ORD_PAIR ? 2 : 1),
              "ord_extremum: output shape");
  p.keys = reinterpret_cast<unsigned long long*>(keys.data_ptr<int64_t>());
  p.out = out.data_ptr<int32_t>();
  launched(ord_extremum_launch(&p, at::cuda::getCurrentCUDAStream()));
}

// M: ``rows`` (one int32 [capacity] tensor per state row) merged into the
// int32 ``state`` in place.
void x32_merge_(at::Tensor state, const std::vector<int64_t>& ops,
                const std::vector<at::Tensor>& rows) {
  c10::cuda::CUDAGuard guard(state.device());
  TORCH_CHECK(state.scalar_type() == at::kInt && state.dim() == 2 && state.is_contiguous(),
              "x32_merge: state must be a contiguous int32 [n_fields, capacity]");
  TORCH_CHECK(ops.size() == (size_t)state.size(0) && rows.size() == ops.size() &&
                  ops.size() <= (size_t)kSegAggMaxFields,
              "x32_merge: field count");
  X32MergeParams p{};
  p.state = state.data_ptr<int32_t>();
  p.n_fields = (int)ops.size();
  p.capacity = state.size(1);
  for (int f = 0; f < p.n_fields; ++f) {
    TORCH_CHECK(rows[f].device() == state.device() && rows[f].numel() == p.capacity,
                "x32_merge: row shape or device");
    p.ops[f] = (int8_t)ops[f];
    p.rows[f] = rows[f].data_ptr<int32_t>();
  }
  launched(x32_merge_launch(&p, at::cuda::getCurrentCUDAStream()));
}

constexpr int64_t kMeshRouteTile = 4096;  // rows per block of the route

void mesh_route_(const at::Tensor& dest, const at::Tensor& valid,
                 const std::vector<at::Tensor>& cols, int64_t n_dev, int64_t capacity,
                 const std::vector<at::Tensor>& staged, at::Tensor staged_valid,
                 at::Tensor dropped) {
  c10::cuda::CUDAGuard guard(dest.device());
  TORCH_CHECK(cols.size() == staged.size(), "mesh_route: staged columns");
  TORCH_CHECK(n_dev >= 1 && n_dev <= kMeshRouteMaxDevs, "mesh_route: destinations");
  MeshRouteParams p{};
  p.dest = dest.data_ptr<int32_t>();
  p.valid = valid.data_ptr<bool>();
  p.n = dest.size(0);
  p.n_dev = (int)n_dev;
  p.capacity = capacity;
  p.tile = kMeshRouteTile;
  p.n_blocks = (int)((p.n + kMeshRouteTile - 1) / kMeshRouteTile);
  p.dropped = reinterpret_cast<unsigned long long*>(dropped.data_ptr<int64_t>());
  if (p.n == 0) return;
  at::Tensor counts = at::empty({n_dev, (int64_t)p.n_blocks}, dest.options().dtype(at::kLong));
  p.counts = reinterpret_cast<long long*>(counts.data_ptr<int64_t>());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  launched(mesh_route_plan(&p, stream));
  size_t g = 0;
  do {  // one scatter per group of columns; the first writes the validity
    const size_t k = std::min(cols.size() - g, (size_t)kMeshRouteMaxCols);
    p.n_cols = (int)k;
    for (size_t c = 0; c < k; ++c) {
      TORCH_CHECK(staged[g + c].scalar_type() == cols[g + c].scalar_type(),
                  "mesh_route: staged dtype");
      p.cols[c] = cols[g + c].data_ptr();
      p.staged[c] = staged[g + c].data_ptr();
      p.esize[c] = (int8_t)cols[g + c].element_size();
    }
    p.staged_valid = g == 0 ? staged_valid.data_ptr<bool>() : nullptr;
    launched(mesh_route_scatter(&p, stream));
    g += k;
  } while (g < cols.size());
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("expr_eval", &expr_eval_,
        "the expression program (filter, aggregate arguments) over one batch");
  m.def("expr_eval_describe", &expr_eval_describe_,
        "the expression launch's plan and the kernel's registers, local bytes, CTAs an SM");
  m.def("segment_agg", &segment_agg,
        "segment aggregate of one batch merged into the running state");
  m.def("segment_agg_entries", &segment_agg_entries_,
        "every retained entry's segment aggregate folded into one state");
  m.def("radix_sort_plan", &radix_sort_plan_,
        "the bounds, histograms, packing and pass plan of a stable multi-key argsort");
  m.def("radix_sort_scratch_bytes", &radix_sort_scratch_bytes_,
        "bytes of device scratch the multi-CTA argsort of these keys needs");
  m.def("radix_sort", &radix_sort_,
        "a stable multi-key argsort: one CTA (small), else one pass a digit in scratch");
  m.def("seg_scan", &seg_scan_, "inclusive segmented scan over columns");
  m.def("seg_scan_describe", &seg_scan_describe_, "the segmented scan's launch plan");
  m.def("range_extremum", &range_extremum_, "ROWS-frame min/max");
  m.def("window_flags", &window_flags_, "partition and peer start flags");
  m.def("window_pack", &window_pack_, "window outputs packed in input order");
  m.def("partition_ids", &partition_ids_, "shuffle partition id of each row");
  m.def("join_build_table", &join_build_table_, "dense slot table of unique build keys");
  m.def("join_probe", &join_probe_, "PK-FK probe: gathered build columns and the row mask");
  m.def("key_encode", &key_encode_, "keyed route: key codes and the sort operand");
  m.def("keyed_encode_entries", &keyed_encode_entries_,
        "keyed runner: every pending batch's sort operands, folded or per key");
  m.def("keyed_unfold", &keyed_unfold_, "keyed runner: each group's key codes from its word");
  m.def("keyed_gids", &keyed_gids_, "keyed route: group ids of the sorted rows");
  m.def("keyed_finish", &keyed_finish_,
        "keyed route: segment totals into the state rows, each group's key codes");
  m.def("keyed_median", &keyed_median_, "keyed route: per-group median and distinct count");
  m.def("corr_mask", &corr_mask_, "keyed corr: pairwise-valid rows");
  m.def("corr_center", &corr_center_, "keyed corr: centred products");
  m.def("corr_center_x32", &corr_center_x32_, "x32 corr centring: f32 products of the centred pairs");
  m.def("mesh_reduce", &mesh_reduce_, "mesh: shard states folded in shard order");
  m.def("df32_agg", &df32_agg_, "x32: double-float segment sums and exact counts");
  m.def("ord_extremum", &ord_extremum_, "x32: exact per-group extremum");
  m.def("x32_merge", &x32_merge_, "x32: state merge");
  m.def("mesh_route", &mesh_route_, "mesh: one shard's rows staged by destination");
}
