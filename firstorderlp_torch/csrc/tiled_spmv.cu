// tiled_spmv: y = A x in one launch over the tile plan of A, or A^T y
// over the tile plan of A^T.
//
// Replaces the JAX package's fused matvec kernel (_make_fused /
// _fused_body, firstorderlp_tpu/ops/routed.py:347,250): the same
// contract (one launch per product over (row-strip x column-strip)
// tiles, nothing of full length intermediate in device memory), without
// the one-hot matrix products and bf16 splits the TPU needs: every
// entry gathers its x straight from device memory and runs of equal
// rows are summed with warp shuffles (tiled_spmv.cuh).
//
// Bound on an H100 SXM: bytes on paper. Each stored entry, padding
// included, moves 8 bytes (packed index and value), plus the group
// table, the item table and both vectors: a few microseconds at 3.35
// TB/s for the 100k-node PageRank LP, whose plan sits in the L2 cache.
// What sets the time there is the longest chain of dependent loads and
// shuffles in any one block, so the work is cut into items of equal
// size, one block each, whose warps walk their entries without a
// barrier and with several steps of loads in flight (tiled_spmv.cuh).

#include "tiled_spmv.cuh"

namespace folp {

struct StoreRow {
  static constexpr int kParts = 0;
  float* y;
  struct In {};
  __device__ In load(int) const { return {}; }
  __device__ void row(int row, float sum, const In&, float*) const {
    y[row] = sum;
  }
};

}  // namespace folp

extern "C" int folp_tiled_spmv(FOLP_TILE_PLAN_PARAMS, const float* x,
                               float* y, void* stream_ptr) {
  using namespace folp;
  const TilePlanArgs p = FOLP_TILE_PLAN_ARGS;
  return launch_tiled(p, x, StoreRow{y}, nullptr, (cudaStream_t)stream_ptr);
}
