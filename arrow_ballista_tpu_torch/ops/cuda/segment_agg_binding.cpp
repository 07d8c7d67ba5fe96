// PyTorch binding of segment_agg.cu: checks the tensors, sizes the grid,
// allocates the scratch and launches on the current stream.  The only
// source of the extension that includes PyTorch's headers.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include <algorithm>
#include <vector>

#include "segment_agg.h"

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

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("segment_agg", &segment_agg,
        "segment aggregate of one batch merged into the running state");
}
