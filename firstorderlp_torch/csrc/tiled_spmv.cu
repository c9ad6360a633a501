// tiled_spmv: y = A x in one launch over the tile plan of A, or A^T y
// over the tile plan of A^T.
//
// Replaces the JAX package's fused matvec kernel (_make_fused /
// _fused_body, firstorderlp_tpu/ops/routed.py:347,250): the same
// contract (one launch per product over (row-strip x column-strip)
// tiles, one window of the input and one strip of the output per work
// group, nothing intermediate in global memory), without the one-hot
// matrix products and bf16 splits the TPU needs: the block gathers
// from its window in shared memory and sums runs of equal rows with
// warp shuffles (tiled_spmv.cuh).
//
// Bound on an H100 SXM: bytes. Each stored entry, padding included,
// moves 8 bytes (packed index and value), plus the group table and both
// vectors: a few microseconds at 3.35 TB/s for the 100k-node PageRank
// LP, so launch overhead dominates at that size. Every block also reads
// each window of the input it meets, from the L2 cache.

#include "tiled_spmv.cuh"

namespace folp {

struct StoreStrip {
  float* y;
  __device__ void operator()(const TilePlanArgs& p, int strip,
                             const TileShared& s) const {
    const int base = strip * p.out_strip;
    for (int i = threadIdx.x; i < p.out_strip; i += kTileThreads) {
      if (base + i < p.num_rows) y[base + i] = s.acc[i];
    }
  }
};

}  // namespace folp

extern "C" int folp_tiled_spmv(FOLP_TILE_PLAN_PARAMS, const float* x,
                               float* y, void* stream_ptr) {
  using namespace folp;
  const TilePlanArgs p = FOLP_TILE_PLAN_ARGS;
  return launch_tiled(p, x, StoreStrip{y}, (cudaStream_t)stream_ptr);
}
