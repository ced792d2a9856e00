// Python binding of the graph and LM kernels.  The only file of the
// extension that includes PyTorch's headers: the .cu sources expose
// plain C++ launch functions over raw pointers, so nvcc never parses
// torch.  Shapes, dtypes, devices and contiguity are checked by the
// Python wrappers (kernels/*/ops.py) before these are called; each
// launch function returns cudaGetLastError() right after its launch.
// Every binding makes its output's device the current one for the
// launch: a <<<>>> launch goes to the current device, and the stream
// passed in belongs to the output's device.
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include <cstdint>

int delta_apply_launch(const void* entries, const void* tile_start,
                       const void* anchor, long long anchor_stride,
                       void* out, const void* t_anchor, const void* t_query,
                       const void* row_mask, int n_rows, int n,
                       int n_queries, long long stream);
int edge_delta_apply_launch(const void* entries, const void* tile_start,
                            const void* anchor, long long anchor_stride,
                            void* out, const void* t_anchor,
                            const void* t_query, int e_cap, int n_queries,
                            long long stream);
int degree_series_launch(const void* deg_cur, const void* events,
                         const void* tile_start, int t_k, void* out,
                         void* nets, void* sync, int n, int nb, int chunk,
                         int tiles, int n_rows, long long stream);
int sweep_work_launch(const void* tile_start, void* work, int tiles,
                      int n_rows, int chunk, long long stream);
int sweep_series_launch(const void* deg0, const void* events,
                        const void* tile_start, const void* t_lo,
                        const void* t_last, void* out, void* nets,
                        void* sync, int n, int nb, int stride, int chunk,
                        int tiles, int n_rows, int n_queries,
                        long long stream);
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* strides, int batch,
                           int hq, int hkv, int sq, int kv_len, int d,
                           int dtype, int causal, int window, float scale,
                           long long stream);
int ssd_scan_cb_stride(int chunk);
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* bm, const void* cm, const void* state0,
                    void* y, void* state, void* chunk_scratch,
                    void* cum_scratch, void* cb_scratch, int batch,
                    int seqlen, int heads, int p, int n, int chunk,
                    long long stream);
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
                 torch::Tensor t_query, torch::Tensor row_mask,
                 int64_t n_rows, int64_t n, int64_t stream) {
  const c10::cuda::CUDAGuard guard(out.device());
  check(delta_apply_launch(ptr_or_null(entries), tile_start.data_ptr(),
                           anchor.data_ptr(), anchor_stride, out.data_ptr(),
                           t_anchor.data_ptr(), t_query.data_ptr(),
                           ptr_or_null(row_mask), (int)n_rows, (int)n,
                           (int)t_query.numel(), stream),
        "delta_apply");
}

void edge_delta_apply(torch::Tensor entries, torch::Tensor tile_start,
                      torch::Tensor anchor, int64_t anchor_stride,
                      torch::Tensor out, torch::Tensor t_anchor,
                      torch::Tensor t_query, int64_t e_cap, int64_t stream) {
  const c10::cuda::CUDAGuard guard(out.device());
  check(edge_delta_apply_launch(ptr_or_null(entries), tile_start.data_ptr(),
                                anchor.data_ptr(), anchor_stride,
                                out.data_ptr(), t_anchor.data_ptr(),
                                t_query.data_ptr(), (int)e_cap,
                                (int)t_query.numel(), stream),
        "edge_delta_apply");
}

void degree_series(torch::Tensor deg_cur, torch::Tensor events,
                   torch::Tensor tile_start, int64_t t_k, torch::Tensor out,
                   torch::Tensor nets, torch::Tensor sync, int64_t nb,
                   int64_t chunk, int64_t n_rows, int64_t stream) {
  const c10::cuda::CUDAGuard guard(out.device());
  check(degree_series_launch(deg_cur.data_ptr(), ptr_or_null(events),
                             tile_start.data_ptr(), (int)t_k, out.data_ptr(),
                             const_cast<void*>(ptr_or_null(nets)),
                             const_cast<void*>(ptr_or_null(sync)),
                             (int)deg_cur.numel(), (int)nb, (int)chunk,
                             (int)tile_start.numel() - 1, (int)n_rows,
                             stream),
        "degree_series");
}

void sweep_series(torch::Tensor deg0, torch::Tensor events,
                  torch::Tensor tile_start, torch::Tensor t_lo,
                  torch::Tensor t_last, torch::Tensor out,
                  torch::Tensor nets, torch::Tensor sync, int64_t nb,
                  int64_t stride, int64_t chunk, int64_t n_rows,
                  int64_t stream) {
  const c10::cuda::CUDAGuard guard(out.device());
  check(sweep_series_launch(deg0.data_ptr(), ptr_or_null(events),
                            tile_start.data_ptr(), t_lo.data_ptr(),
                            t_last.data_ptr(), out.data_ptr(),
                            const_cast<void*>(ptr_or_null(nets)),
                            const_cast<void*>(ptr_or_null(sync)),
                            (int)deg0.size(1), (int)nb, (int)stride,
                            (int)chunk, (int)tile_start.numel() - 1,
                            (int)n_rows, (int)t_lo.numel(), stream),
        "sweep_series");
}

void sweep_work(torch::Tensor tile_start, torch::Tensor work, int64_t chunk,
                int64_t stream) {
  const c10::cuda::CUDAGuard guard(work.device());
  check(sweep_work_launch(tile_start.data_ptr(), work.data_ptr(),
                          (int)tile_start.numel() - 1, (int)work.size(0),
                          (int)chunk, stream),
        "sweep_work");
}

void flash_attention(torch::Tensor q, torch::Tensor k, torch::Tensor v,
                     torch::Tensor o, bool causal, int64_t window,
                     int64_t kv_len, double scale, int64_t stream) {
  const c10::cuda::CUDAGuard guard(o.device());
  long long strides[12];
  const torch::Tensor* ts[4] = {&q, &k, &v, &o};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) strides[3 * i + j] = ts[i]->stride(j);
  check(flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            (int)q.size(0), (int)q.size(1), (int)k.size(1), (int)q.size(2),
            (int)kv_len, (int)q.size(3),
            q.scalar_type() == torch::kBFloat16 ? 1 : 0, causal ? 1 : 0,
            (int)window, (float)scale, stream),
        "flash_attention");
}

void ssd_scan(torch::Tensor x, torch::Tensor dt, torch::Tensor a,
              torch::Tensor bm, torch::Tensor cm, torch::Tensor state0,
              torch::Tensor y, torch::Tensor state, torch::Tensor chunks,
              torch::Tensor cum, torch::Tensor cb, int64_t chunk,
              int64_t stream) {
  const c10::cuda::CUDAGuard guard(y.device());
  check(ssd_scan_launch(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                        bm.data_ptr(), cm.data_ptr(), ptr_or_null(state0),
                        y.data_ptr(), state.data_ptr(),
                        const_cast<void*>(ptr_or_null(chunks)),
                        const_cast<void*>(ptr_or_null(cum)),
                        const_cast<void*>(ptr_or_null(cb)),
                        (int)x.size(0), (int)x.size(1), (int)x.size(2),
                        (int)x.size(3), (int)bm.size(2), (int)chunk, stream),
        "ssd_scan");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("delta_apply", &delta_apply);
  m.def("edge_delta_apply", &edge_delta_apply);
  m.def("degree_series", &degree_series);
  m.def("sweep_series", &sweep_series);
  m.def("sweep_work", &sweep_work);
  m.def("flash_attention", &flash_attention);
  m.def("ssd_scan", &ssd_scan);
  m.def("ssd_scan_cb_stride", &ssd_scan_cb_stride);
}
