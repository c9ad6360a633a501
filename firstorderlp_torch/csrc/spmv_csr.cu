// spmv_csr: y = A x in f32 over a CSR matrix (A x with A's arrays,
// A^T y with the arrays of A^T), in one launch.
//
// Replaces, on the PDHG main path, the JAX package's routed matvec:
// the expand kernel (_make_expand / _expand_body,
// firstorderlp_tpu/ops/routed.py:160,73), the XLA chunk gather, and the
// reduce kernel (_make_reduce / _reduce_body, routed.py:188,127). Those
// select x entries by one-hot matrix products because gathers on the
// TPU are bound by index rate; Hopper gathers natively, so this is a
// CSR row sum over work items balanced by entries (csr_spmv.cuh: the
// items, the walk, and why it uses no atomics).
//
// Bound on an H100 SXM: bytes. Per call it must read indptr (4 (m+1)
// B), indices and values (8 nnz B), x (4 n B) and write y (4 m B):
// about 7.6 MB for the 100k-node PageRank LP (800k nnz), ~2.3 us at
// 3.35 TB/s, against 2 nnz flops (~0.02 us at 67 TFLOP/s f32). At that
// size the arrays sit in the L2 cache and the time is the launch and
// the longest block's chain of dependent loads, so the design keeps
// every item near the same size and the call at one launch; PERF.md
// has the measured times.

#include "csr_spmv.cuh"

namespace folp {

struct StoreRow {
  static constexpr int kParts = 0;
  struct In {};
  float* y;
  __device__ In load(int) const { return {}; }
  __device__ void row(int row, float sum, const In&, float*) const {
    y[row] = sum;
  }
};

}  // namespace folp

extern "C" int folp_spmv_csr(const folp::CsrArgs* a, const float* x,
                             float* y, void* stream_ptr) {
  using namespace folp;
  return launch_csr(a, x, StoreRow{y}, nullptr, (cudaStream_t)stream_ptr);
}
