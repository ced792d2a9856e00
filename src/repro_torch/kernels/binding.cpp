// Python binding of the four graph kernels.  The only file of the
// extension that includes PyTorch's headers: the .cu sources expose
// plain C++ launch functions over raw pointers, so nvcc never parses
// torch.  Shapes, dtypes, devices and contiguity are checked by the
// Python wrappers (kernels/*/ops.py) before these are called; each
// launch function returns cudaGetLastError() right after its launch.
#include <torch/extension.h>

#include <cstdint>

int delta_apply_launch(const void* entries, const void* tile_start,
                       const void* anchor, long long anchor_stride,
                       void* out, const void* t_anchor, const void* t_query,
                       const void* row_mask, int n, int n_queries,
                       long long stream);
int edge_delta_apply_launch(const void* entries, const void* tile_start,
                            const void* anchor, long long anchor_stride,
                            void* out, const void* t_anchor,
                            const void* t_query, int e_cap, int n_queries,
                            long long stream);
long long degree_series_smem_bytes(int nb);
int degree_series_launch(const void* deg_cur, const void* events,
                         const void* tile_start, void* out, void* scratch,
                         int n, int nb, long long stream);
long long sweep_series_smem_bytes(int nb);
int sweep_series_launch(const void* deg0, const void* events,
                        const void* tile_start, const void* t_lo,
                        const void* t_last, void* out, void* scratch, int n,
                        int nb, int stride, int n_queries, long long stream);
const char* repro_cuda_error_string(int err);

namespace {

void check(int err, const char* what) {
  TORCH_CHECK(err == 0, what, ": CUDA error ", err, " (",
              repro_cuda_error_string(err), ")");
}

const void* ptr_or_null(const torch::Tensor& t) {
  return t.numel() ? t.data_ptr() : nullptr;
}

void delta_apply(torch::Tensor entries, torch::Tensor tile_start,
                 torch::Tensor anchor, int64_t anchor_stride,
                 torch::Tensor out, torch::Tensor t_anchor,
                 torch::Tensor t_query, torch::Tensor row_mask, int64_t n,
                 int64_t stream) {
  check(delta_apply_launch(ptr_or_null(entries), tile_start.data_ptr(),
                           anchor.data_ptr(), anchor_stride, out.data_ptr(),
                           t_anchor.data_ptr(), t_query.data_ptr(),
                           ptr_or_null(row_mask), (int)n,
                           (int)t_query.numel(), stream),
        "delta_apply");
}

void edge_delta_apply(torch::Tensor entries, torch::Tensor tile_start,
                      torch::Tensor anchor, int64_t anchor_stride,
                      torch::Tensor out, torch::Tensor t_anchor,
                      torch::Tensor t_query, int64_t e_cap, int64_t stream) {
  check(edge_delta_apply_launch(ptr_or_null(entries), tile_start.data_ptr(),
                                anchor.data_ptr(), anchor_stride,
                                out.data_ptr(), t_anchor.data_ptr(),
                                t_query.data_ptr(), (int)e_cap,
                                (int)t_query.numel(), stream),
        "edge_delta_apply");
}

void degree_series(torch::Tensor deg_cur, torch::Tensor events,
                   torch::Tensor tile_start, torch::Tensor out,
                   torch::Tensor scratch, int64_t nb, int64_t stream) {
  check(degree_series_launch(deg_cur.data_ptr(), ptr_or_null(events),
                             tile_start.data_ptr(), out.data_ptr(),
                             const_cast<void*>(ptr_or_null(scratch)),
                             (int)deg_cur.numel(), (int)nb, stream),
        "degree_series");
}

void sweep_series(torch::Tensor deg0, torch::Tensor events,
                  torch::Tensor tile_start, torch::Tensor t_lo,
                  torch::Tensor t_last, torch::Tensor out,
                  torch::Tensor scratch, int64_t nb, int64_t stride,
                  int64_t stream) {
  check(sweep_series_launch(deg0.data_ptr(), ptr_or_null(events),
                            tile_start.data_ptr(), t_lo.data_ptr(),
                            t_last.data_ptr(), out.data_ptr(),
                            const_cast<void*>(ptr_or_null(scratch)),
                            (int)deg0.size(1), (int)nb, (int)stride,
                            (int)t_lo.numel(), stream),
        "sweep_series");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("delta_apply", &delta_apply);
  m.def("edge_delta_apply", &edge_delta_apply);
  m.def("degree_series", &degree_series);
  m.def("degree_series_smem_bytes", &degree_series_smem_bytes);
  m.def("sweep_series", &sweep_series);
  m.def("sweep_series_smem_bytes", &sweep_series_smem_bytes);
}
