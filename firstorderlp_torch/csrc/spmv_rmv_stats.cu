// spmv_rmv_stats: aty+ = A^T y+ over the CSR arrays of A^T, fused with
// the PDLP step-control sums, in one launch: sum(dx (aty+ - aty_old))
// (the interaction term) into sums[0] and sum(dx^2) (the primal
// movement) into sums[1], each added in item order by the block that
// draws the launch's last ticket (csr_spmv.cuh). The JAX package sums
// its `parts` outside its kernel (routed.py:834-835).
//
// Replaces the JAX package's expand kernel (_make_expand,
// firstorderlp_tpu/ops/routed.py:160) plus chunk gather plus the
// step-control reduce kernel (_make_reduce_rmv_stats /
// _reduce_rmv_stats_body, routed.py:566,495). Same contract, CSR
// layout of A^T, epilogue in registers on each row's complete sum.
//
// Bound on an H100 SXM: bytes. The SpMV's bytes (spmv_csr.cu) plus dx
// and aty_old read (8 n B): about 8.4 MB for the 100k-node PageRank LP,
// ~2.5 us at 3.35 TB/s. At that size the launch and the longest block's
// chain of loads set the time; the design (csr_spmv.cuh) keeps the call
// at one launch of blocks of about equal work.

#include "csr_spmv.cuh"

namespace folp {

struct RmvStatsRow {
  static constexpr int kParts = 2;
  const float* dx;
  const float* aty_old;
  float* aty;
  struct In {
    float dx, aty_old;
  };
  __device__ In load(int row) const {
    return {__ldg(dx + row), __ldg(aty_old + row)};
  }
  __device__ void row(int row, float sum, const In& in, float* part) const {
    aty[row] = sum;
    part[0] += in.dx * (sum - in.aty_old);
    part[1] += in.dx * in.dx;
  }
};

}  // namespace folp

extern "C" int folp_spmv_rmv_stats(const folp::CsrArgs* a, const float* y,
                                   const float* dx, const float* aty_old,
                                   float* aty, float* sums,
                                   void* stream_ptr) {
  using namespace folp;
  return launch_csr(a, y, RmvStatsRow{dx, aty_old, aty}, sums,
                    (cudaStream_t)stream_ptr);
}
