// spmv_dual_step: the PDHG dual step fused into the SpMV A z, in one
// launch:
//     y+ = proj(y + sigma (b - A z)),  proj: >= 0 where is_eq == 0,
// and sum((y+ - y)^2), added in item order by the block that draws the
// launch's last ticket (csr_spmv.cuh) into sums[0]; the JAX package sums
// its `parts` outside its kernel (routed.py:798), this needs no second
// launch.
//
// Replaces the JAX package's expand kernel (_make_expand,
// firstorderlp_tpu/ops/routed.py:160) plus chunk gather plus the
// dual-step reduce kernel (_make_reduce_dual / _reduce_dual_body,
// routed.py:532,455). Same contract, CSR layout: the epilogue runs in
// registers on each row's complete sum, so y+ never makes a second
// trip through memory. sigma is read from device memory, so the host
// never waits on the step size.
//
// Bound on an H100 SXM: bytes. The SpMV's bytes (spmv_csr.cu) plus y,
// b and is_eq read (12 m B) and y+ written (4 m B): about 8.8 MB for
// the 100k-node PageRank LP, ~2.6 us at 3.35 TB/s. At that size the
// launch and the longest block's chain of loads set the time; the
// design (csr_spmv.cuh) keeps the call at one launch of blocks of about
// equal work, the dense equality row cut over many of them.

#include "csr_spmv.cuh"

namespace folp {

struct DualStepRow {
  static constexpr int kParts = 1;
  const float* y;
  const float* b;
  const float* is_eq;
  const float* sigma;
  float* y_next;
  struct In {
    float y, b, is_eq;
  };
  __device__ In load(int row) const {
    return {__ldg(y + row), __ldg(b + row), __ldg(is_eq + row)};
  }
  __device__ void row(int row, float sum, const In& in, float* part) const {
    const float cand = in.y + __ldg(sigma) * (in.b - sum);
    const float yn = in.is_eq != 0.f ? cand : fmaxf(cand, 0.f);
    y_next[row] = yn;
    const float dy = yn - in.y;
    part[0] += dy * dy;
  }
};

}  // namespace folp

extern "C" int folp_spmv_dual_step(const folp::CsrArgs* a, const float* z,
                                   const float* y, const float* b,
                                   const float* is_eq, const float* sigma,
                                   float* y_next, float* sums,
                                   void* stream_ptr) {
  using namespace folp;
  return launch_csr(a, z, DualStepRow{y, b, is_eq, sigma, y_next}, sums,
                    (cudaStream_t)stream_ptr);
}
