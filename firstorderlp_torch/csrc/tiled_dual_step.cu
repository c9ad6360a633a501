// tiled_dual_step: the PDHG dual step fused into A z over the tile
// plan of A. When a strip's sums are complete its block computes
//     y+ = proj(y + sigma (b - A z)),  proj: >= 0 where is_eq == 0,
// writes the strip of y+ and one partial of sum((y+ - y)^2). The caller
// sums the partials with torch.sum, as the JAX package sums `parts`
// outside its kernel (routed.py:798). An empty strip still has a block,
// so its rows get y+ = proj(y + sigma b).
//
// Replaces the JAX package's fused dual-step kernel (_make_fused_dual /
// _fused_dual_body, firstorderlp_tpu/ops/routed.py:378,274): the
// epilogue runs once per output strip, on sums that never left shared
// memory. sigma is read from device memory, so the host never waits on
// the step size.
//
// Bound on an H100 SXM: bytes. The plan's bytes (tiled_spmv.cu) plus y,
// b and is_eq read and y+ written (16 bytes per row). Launch overhead
// dominates at the 100k-node PageRank LP's size.

#include "tiled_spmv.cuh"

namespace folp {

struct DualStepStrip {
  const float* y;
  const float* b;
  const float* is_eq;
  const float* sigma;
  float* y_next;
  float* parts;
  __device__ void operator()(const TilePlanArgs& p, int strip,
                             const TileShared& s) const {
    const int base = strip * p.out_strip;
    const float sig = sigma[0];
    float dy2 = 0.f;
    for (int i = threadIdx.x; i < p.out_strip; i += kTileThreads) {
      const int row = base + i;
      if (row < p.num_rows) {
        const float y_in = y[row];
        const float cand = y_in + sig * (b[row] - s.acc[i]);
        const float yn = is_eq[row] != 0.f ? cand : fmaxf(cand, 0.f);
        y_next[row] = yn;
        const float dy = yn - y_in;
        dy2 += dy * dy;
      }
    }
    const float total = block_sum(dy2, s.red);
    if (threadIdx.x == 0) parts[strip] = total;
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
  return launch_tiled(p, z, DualStepStrip{y, b, is_eq, sigma, y_next, parts},
                      (cudaStream_t)stream_ptr);
}
