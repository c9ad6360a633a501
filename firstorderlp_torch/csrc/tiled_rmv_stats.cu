// tiled_rmv_stats: aty+ = A^T y+ over the tile plan of A^T, fused with
// the PDLP step-control sums. When a strip's sums are complete, the
// block that completed them writes the strip of aty+ and the strip's two
// partials together: sum(dx (aty+ - aty_old)) (the interaction term)
// into parts[2 strip] and sum(dx^2) (the primal movement) into
// parts[2 strip + 1]. The block that finishes the launch's last strip
// adds each in strip order into parts[2 nstrips] and parts[2 nstrips + 1]
// (the JAX package sums `parts` outside its kernel,
// routed.py:834-835).
//
// Replaces the JAX package's fused step-control kernel
// (_make_fused_rmv_stats / _fused_rmv_stats_body,
// firstorderlp_tpu/ops/routed.py:418,310).
//
// Bound on an H100 SXM: bytes on paper, the plan's (tiled_spmv.cu) plus
// dx and aty_old read and aty+ written (12 bytes per row). At the
// 100k-node PageRank LP's size the time is the walk's chain of latencies
// (as in tiled_spmv.cu) and then the epilogue's tail: dx and aty_old are
// loaded before the walk, and the two partials of a strip and the two
// totals are each reduced over the block in one barrier pair, the
// launch's ticket drawn in the same pair (tiled_spmv.cuh).

#include "tiled_spmv.cuh"

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

extern "C" int folp_tiled_rmv_stats(FOLP_TILE_PLAN_PARAMS, const float* y,
                                    const float* dx, const float* aty_old,
                                    float* aty, float* parts,
                                    void* stream_ptr) {
  using namespace folp;
  const TilePlanArgs p = FOLP_TILE_PLAN_ARGS;
  return launch_tiled(p, y, RmvStatsRow{dx, aty_old, aty}, parts,
                      (cudaStream_t)stream_ptr);
}
