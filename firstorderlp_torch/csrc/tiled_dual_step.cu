// tiled_dual_step: the PDHG dual step fused into A z over the tile
// plan of A. When a strip's sums are complete, the block that completed
// them computes
//     y+ = proj(y + sigma (b - A z)),  proj: >= 0 where is_eq == 0,
// writes the strip of y+ and one partial of sum((y+ - y)^2) into
// parts[strip]. The block that finishes the launch's last strip adds
// the partials in strip order into parts[nstrips], so the caller gets
// the sum without a second launch (the JAX package sums `parts` outside
// its kernel, routed.py:798). An empty strip still has an item and a
// block, so its rows get y+ = proj(y + sigma b).
//
// Replaces the JAX package's fused dual-step kernel (_make_fused_dual /
// _fused_dual_body, firstorderlp_tpu/ops/routed.py:378,274): the
// epilogue runs once per output row, on complete sums. sigma is read
// from device memory, so the host never waits on the step size.
//
// Bound on an H100 SXM: bytes on paper, the plan's (tiled_spmv.cu) plus
// y, b and is_eq read and y+ written (16 bytes per row). At the
// 100k-node PageRank LP's size the time is the longest block's chain of
// latencies; tiled_spmv.cuh says what the design does about it.

#include "tiled_spmv.cuh"

namespace folp {

struct DualStepRow {
  static constexpr int kParts = 1;
  const float* y;
  const float* b;
  const float* is_eq;
  const float* sigma;
  float* y_next;
  struct In {
    float y, b, is_eq, sigma;
  };
  __device__ In load(int row) const {
    return {__ldg(y + row), __ldg(b + row), __ldg(is_eq + row),
            __ldg(sigma)};
  }
  __device__ void row(int row, float sum, const In& in, float* part) const {
    const float cand = in.y + in.sigma * (in.b - sum);
    const float yn = in.is_eq != 0.f ? cand : fmaxf(cand, 0.f);
    y_next[row] = yn;
    const float dy = yn - in.y;
    part[0] += dy * dy;
  }
};

}  // namespace folp

extern "C" int folp_tiled_dual_step(FOLP_TILE_PLAN_PARAMS, const float* z,
                                    const float* y, const float* b,
                                    const float* is_eq, const float* sigma,
                                    float* y_next, float* parts,
                                    void* stream_ptr) {
  using namespace folp;
  const TilePlanArgs p = FOLP_TILE_PLAN_ARGS;
  return launch_tiled(p, z, DualStepRow{y, b, is_eq, sigma, y_next}, parts,
                      (cudaStream_t)stream_ptr);
}
