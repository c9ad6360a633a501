// tiled_rmv_stats: aty+ = A^T y+ over the tile plan of A^T, fused with
// the PDLP step-control sums. When a strip's sums are complete its
// block writes the strip of aty+ and two partials:
// sum(dx (aty+ - aty_old)) (the interaction term) into parts[strip] and
// sum(dx^2) (the primal movement) into parts[nstrips + strip]. The
// caller sums the partials with torch.sum, as the JAX package sums
// `parts` (routed.py:834-835).
//
// Replaces the JAX package's fused step-control kernel
// (_make_fused_rmv_stats / _fused_rmv_stats_body,
// firstorderlp_tpu/ops/routed.py:418,310).
//
// Bound on an H100 SXM: bytes. The plan's bytes (tiled_spmv.cu) plus dx
// and aty_old read and aty+ written (12 bytes per row). Launch overhead
// dominates at the 100k-node PageRank LP's size.

#include "tiled_spmv.cuh"

namespace folp {

struct RmvStatsStrip {
  const float* dx;
  const float* aty_old;
  float* aty;
  float* parts;
  __device__ void operator()(const TilePlanArgs& p, int strip,
                             const TileShared& s) const {
    const int base = strip * p.out_strip;
    float inter = 0.f, dx2 = 0.f;
    for (int i = threadIdx.x; i < p.out_strip; i += kTileThreads) {
      const int row = base + i;
      if (row < p.num_rows) {
        const float acc = s.acc[i];
        aty[row] = acc;
        const float d = dx[row];
        inter += d * (acc - aty_old[row]);
        dx2 += d * d;
      }
    }
    const float inter_total = block_sum(inter, s.red);
    const float dx2_total = block_sum(dx2, s.red);
    if (threadIdx.x == 0) {
      parts[strip] = inter_total;
      parts[p.nstrips + strip] = dx2_total;
    }
  }
};

}  // namespace folp

extern "C" int folp_tiled_rmv_stats(FOLP_TILE_PLAN_PARAMS, const float* y,
                                    const float* dx, const float* aty_old,
                                    float* aty, float* parts,
                                    void* stream_ptr) {
  using namespace folp;
  const TilePlanArgs p = FOLP_TILE_PLAN_ARGS;
  return launch_tiled(p, y, RmvStatsStrip{dx, aty_old, aty, parts},
                      (cudaStream_t)stream_ptr);
}
