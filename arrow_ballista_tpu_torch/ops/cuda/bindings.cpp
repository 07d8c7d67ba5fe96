// PyTorch bindings of the port's CUDA kernels: fill each launch's
// parameters from the tensors, size the grids and launch on the current
// stream.  The only source of the extension that includes PyTorch's
// headers.  The Python wrappers (ops/kernels.py, ops/window_kernel.py)
// check devices, dtypes, shapes and layouts before calling in, and
// allocate every output and scratch tensor.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include <algorithm>
#include <vector>

#include "partition_id.h"
#include "radix_sort.h"
#include "range_extremum.h"
#include "seg_scan.h"
#include "segment_agg.h"
#include "window_epilogue.h"

namespace {

constexpr int64_t kSmemBudget = 64 << 10;      // dynamic shared memory per CTA
constexpr int64_t kScratchBudget = 256 << 20;  // chunk partials in device memory

// An empty tensor stands for a null (all-true) mask.
const bool* mask_ptr(const at::Tensor& t, int64_t n, const at::Device& dev,
                     const char* name) {
  if (t.numel() == 0) return nullptr;
  TORCH_CHECK(t.device() == dev, name, " must be on ", dev);
  TORCH_CHECK(t.scalar_type() == at::kBool, name, " must be bool");
  TORCH_CHECK(t.dim() == 1 && t.size(0) == n, name, " must be [", n, "]");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  return t.data_ptr<bool>();
}

void segment_agg(const at::Tensor& gid, const at::Tensor& tail,
                 const at::Tensor& pred, const at::Tensor& pvalid,
                 const std::vector<at::Tensor>& values,
                 const std::vector<at::Tensor>& valids,
                 const std::vector<int64_t>& ops,
                 const std::vector<int64_t>& cols, at::Tensor state) {
  TORCH_CHECK(state.is_cuda(), "state must be a CUDA tensor");
  const at::Device dev = state.device();
  c10::cuda::CUDAGuard guard(dev);
  TORCH_CHECK(state.scalar_type() == at::kLong && state.dim() == 2 &&
                  state.is_contiguous(),
              "state must be contiguous int64 [n_fields, capacity]");
  const int64_t nf = state.size(0);
  const int64_t cap = state.size(1);
  TORCH_CHECK(nf >= 1 && nf <= kSegAggMaxFields, "n_fields ", nf);
  TORCH_CHECK(cap >= 1, "capacity ", cap);
  TORCH_CHECK((int64_t)ops.size() == nf && (int64_t)cols.size() == nf,
              "one op and one column per state field");
  TORCH_CHECK(gid.device() == dev && gid.scalar_type() == at::kInt &&
                  gid.dim() == 1 && gid.is_contiguous(),
              "gid must be contiguous int32 [n] on ", dev);
  const int64_t n = gid.size(0);
  const int64_t n_cols = (int64_t)values.size();
  TORCH_CHECK(n_cols == (int64_t)valids.size() && n_cols <= kSegAggMaxCols,
              "columns ", n_cols);

  SegAggParams p{};
  p.gid = gid.data_ptr<int32_t>();
  p.tail = mask_ptr(tail, n, dev, "tail");
  p.pred = mask_ptr(pred, n, dev, "pred");
  p.pvalid = mask_ptr(pvalid, n, dev, "pvalid");
  TORCH_CHECK(p.pvalid == nullptr || p.pred != nullptr, "pvalid without pred");
  for (int64_t c = 0; c < n_cols; ++c) {
    const at::Tensor& v = values[c];
    p.valids[c] = mask_ptr(valids[c], n, dev, "validity");
    if (v.numel() == 0) continue;
    TORCH_CHECK(v.device() == dev, "value column must be on ", dev);
    TORCH_CHECK(v.scalar_type() == at::kDouble || v.scalar_type() == at::kLong,
                "value column must be float64 or int64");
    TORCH_CHECK(v.dim() == 1 && v.size(0) == n && v.is_contiguous(),
                "value column must be contiguous [", n, "]");
    p.values[c] = v.data_ptr();
  }
  for (int64_t f = 0; f < nf; ++f) {
    const int64_t op = ops[f];
    const int64_t c = cols[f];
    TORCH_CHECK(op >= SA_COUNT && op <= SA_MAX_I64, "op ", op);
    TORCH_CHECK(c >= -1 && c < n_cols, "field column ", c);
    if (op != SA_COUNT) {
      TORCH_CHECK(c >= 0 && p.values[c] != nullptr, "field ", f, " needs values");
      const bool is_f64 = op == SA_ADD_F64 || op == SA_MIN_F64 || op == SA_MAX_F64;
      TORCH_CHECK(values[c].scalar_type() == (is_f64 ? at::kDouble : at::kLong),
                  "field ", f, ": value dtype does not match its op");
    }
    p.ops[f] = (int8_t)op;
    p.cols[f] = (int8_t)c;
  }
  p.n_fields = (int)nf;
  p.n = n;
  p.capacity = cap;
  p.tile = (int)std::min<int64_t>(cap, kSmemBudget / (kSegAggWarps * nf * 8));
  TORCH_CHECK(p.tile >= 1, "state too wide for shared memory");

  // ~4 chunks per SM, each at least one pass of the CTA's warps, and no
  // more chunk partials than the scratch budget holds
  const int64_t sms = at::cuda::getCurrentDeviceProperties()->multiProcessorCount;
  const int64_t min_rows = 32 * kSegAggWarps;
  int64_t rows = std::max<int64_t>(min_rows, (n + 4 * sms - 1) / (4 * sms));
  int64_t chunks = std::max<int64_t>(1, (n + rows - 1) / rows);
  const int64_t max_chunks =
      std::max<int64_t>(1, std::min<int64_t>(65535, kScratchBudget / (nf * cap * 8)));
  if (chunks > max_chunks) {
    chunks = max_chunks;
    rows = (n + chunks - 1) / chunks;
  }
  p.n_chunks = (int)chunks;
  p.rows_per_chunk = rows;
  at::Tensor partial = at::empty({chunks, nf, cap}, state.options());
  // int64_t is `long` here, the kernel's words `long long`: same width
  p.partial = reinterpret_cast<long long*>(partial.data_ptr<int64_t>());
  p.state = reinterpret_cast<long long*>(state.data_ptr<int64_t>());

  C10_CUDA_CHECK(segment_agg_launch(&p, at::cuda::getCurrentCUDAStream()));
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

void radix_sort_plan_(const std::vector<at::Tensor>& keys, at::Tensor hist,
                      at::Tensor plan) {
  c10::cuda::CUDAGuard guard(hist.device());
  RadixSortParams p = radix_params(keys);
  p.hist = static_cast<unsigned*>(hist.data_ptr());
  launched(radix_sort_plan(&p, plan.data_ptr<int32_t>(),
                           at::cuda::getCurrentCUDAStream()));
}

void radix_sort_passes_(const std::vector<at::Tensor>& keys,
                        const at::Tensor& hist, const at::Tensor& plan,
                        at::Tensor perm, at::Tensor perm_scratch,
                        at::Tensor key_a, at::Tensor key_b, at::Tensor counts) {
  c10::cuda::CUDAGuard guard(perm.device());
  RadixSortParams p = radix_params(keys);
  p.hist = static_cast<unsigned*>(hist.data_ptr());
  p.counts = static_cast<unsigned*>(counts.data_ptr());
  p.key_buf[0] = static_cast<unsigned long long*>(key_a.data_ptr());
  p.key_buf[1] = static_cast<unsigned long long*>(key_b.data_ptr());
  p.perm_scratch = perm_scratch.data_ptr<int32_t>();
  launched(radix_sort_passes(&p, plan.data_ptr<int32_t>(),
                             perm.data_ptr<int32_t>(),
                             at::cuda::getCurrentCUDAStream()));
}

void seg_scan_(int64_t n, const at::Tensor& perm, const at::Tensor& flag,
               const at::Tensor& key, const at::Tensor& aux, bool reverse,
               const std::vector<at::Tensor>& values,
               const std::vector<at::Tensor>& valids,
               const std::vector<int64_t>& src, const std::vector<int64_t>& op,
               const std::vector<int64_t>& in_i64,
               const std::vector<at::Tensor>& outs, const at::Tensor& state,
               const std::vector<int64_t>& field_col,
               const std::vector<int64_t>& field_op, at::Tensor block_agg,
               at::Tensor block_carry, at::Tensor block_start) {
  c10::cuda::CUDAGuard guard(block_agg.device());
  SegScanParams p{};
  p.n = n;
  p.perm = opt<const int32_t>(perm);
  p.flag = opt<const uint8_t>(flag);
  p.key = opt<const int32_t>(key);
  p.aux = opt<const uint8_t>(aux);
  p.reverse = reverse ? 1 : 0;
  p.n_cols = (int)src.size();
  TORCH_CHECK(p.n_cols <= kScanMaxCols, "seg_scan: columns");
  for (int c = 0; c < p.n_cols; ++c) {
    p.values[c] = opt<const void>(values[c]);
    p.valid[c] = opt<const bool>(valids[c]);
    p.src[c] = (int8_t)src[c];
    p.op[c] = (int8_t)op[c];
    p.in_i64[c] = (int8_t)in_i64[c];
    p.out[c] = reinterpret_cast<long long*>(opt<int64_t>(outs[c]));
  }
  p.state = reinterpret_cast<long long*>(opt<int64_t>(state));
  if (p.state != nullptr) {
    p.capacity = state.size(1);
    p.n_fields = (int)field_col.size();
    TORCH_CHECK(p.n_fields <= kSegAggMaxFields, "seg_scan: fields");
    for (int f = 0; f < p.n_fields; ++f) {
      p.field_col[f] = (int8_t)field_col[f];
      p.field_op[f] = (int8_t)field_op[f];
    }
  }
  p.n_blocks = seg_scan_blocks(n);
  p.block_agg = reinterpret_cast<long long*>(block_agg.data_ptr<int64_t>());
  p.block_carry = reinterpret_cast<long long*>(block_carry.data_ptr<int64_t>());
  p.block_start = block_start.data_ptr<uint8_t>();
  launched(seg_scan_launch(&p, at::cuda::getCurrentCUDAStream()));
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
  p.values = reinterpret_cast<const long long*>(values.data_ptr());
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
  p.out = reinterpret_cast<long long*>(out.data_ptr<int64_t>());
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

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("segment_agg", &segment_agg,
        "segment aggregate of one batch merged into the running state");
  m.def("radix_sort_plan", &radix_sort_plan_,
        "byte histograms and the pass plan of a stable multi-key argsort");
  m.def("radix_sort_passes", &radix_sort_passes_,
        "the LSD passes of a stable multi-key argsort");
  m.def("seg_scan", &seg_scan_, "inclusive segmented scan over columns");
  m.def("range_extremum", &range_extremum_, "ROWS-frame min/max");
  m.def("window_flags", &window_flags_, "partition and peer start flags");
  m.def("window_pack", &window_pack_, "window outputs packed in input order");
  m.def("partition_ids", &partition_ids_, "shuffle partition id of each row");
}
