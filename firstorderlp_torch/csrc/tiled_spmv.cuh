// Shared device code of the tile-plan kernels (tiled_spmv.cu,
// tiled_dual_step.cu, tiled_rmv_stats.cu).
//
// The plan (ops/routed.py, build_tile_plan) cuts the matrix into tiles
// of `out_strip` output rows by `in_window` input columns. A tile's
// entries are stored together, in row-major order inside the tile, and
// padded with zero entries to a whole number of groups of `group`
// entries. Each entry is one packed int32, local_col | local_row << 16,
// and one f32 value. meta holds four int32 per group: output strip,
// first-of-strip, last-of-strip, input strip. tile_ptr gives the first
// group of every stored tile, strip_tile_ptr the first stored tile of
// every output strip; an empty strip still stores one all-padding
// group, so every strip has a block, an output and an epilogue.
//
// One block owns one output strip. It keeps the strip's sums and the
// current tile's window of the input vector in shared memory, walks the
// strip's tiles in plan order and hands the finished strip to the
// caller's epilogue: one launch per product, nothing intermediate in
// global memory.
//
// Summation without atomics. The block takes kTileThreads entries of a
// tile at a time, one per thread. Local rows are sorted inside a tile,
// so equal rows are neighbours and a segmented scan over each warp
// gives every run of equal rows its sum, always in lane order. A run
// that touches neither end of its warp is the row's only run in this
// step, and its last lane adds the sum to the strip. Runs that touch a
// warp's first or last lane may continue in the neighbouring warp: each
// warp files them as two boundary items, and after a barrier warp 0
// runs the same segmented scan over the 32 items and adds each row's
// total. A second barrier ends the step. Every sum is therefore taken
// in one fixed order, and two launches on the same inputs give the same
// bits. A row of any length (the PageRank LP's equality row puts
// several thousand equal local rows into each tile of strip 0) costs
// the same five shuffle rounds per step as any other.
//
// Padding: an entry with packed index 0 that is not the first entry of
// its tile is padding (row-major order puts local (0, 0) first, and
// duplicates are summed on the host). It is given the row kNoRow, which
// sorts after every real row and is never added anywhere.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace folp {

constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / 32;
constexpr unsigned kNoRow = 0xFFFFu;  // strips hold at most 16,384 rows
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(2 * kTileWarps == 32,
              "one warp scans the two boundary items of every warp");

struct TilePlanArgs {
  const int* loc;             // (ngroups * group,) packed local indices
  const float* vals;          // (ngroups * group,)
  const int* meta;            // (ngroups, 4)
  const int* tile_ptr;        // (ntiles + 1,) first group of each tile
  const int* strip_tile_ptr;  // (nstrips + 1,) first tile of each strip
  int nstrips;
  int group;      // entries per group
  int out_strip;  // rows per output strip
  int in_window;  // columns per input window
  int num_rows;   // length of the output vector
  int num_cols;   // length of the input vector
};

// Shared memory of one block, carved from the dynamic allocation.
struct TileShared {
  float* win;      // (in_window,) the tile's window of the input
  float* acc;      // (out_strip,) the strip's sums
  float* bnd_sum;  // (32,) boundary items of one step
  unsigned* bnd_row;
  float* red;      // (kTileWarps,) scratch of block_sum
};

inline size_t tile_shared_bytes(const TilePlanArgs& p) {
  return sizeof(float) * (size_t)(p.in_window + p.out_strip + 32 + 32 +
                                  kTileWarps);
}

__device__ __forceinline__ TileShared carve_shared(const TilePlanArgs& p,
                                                   float* smem) {
  TileShared s;
  s.win = smem;
  s.acc = s.win + p.in_window;
  s.bnd_sum = s.acc + p.out_strip;
  s.bnd_row = reinterpret_cast<unsigned*>(s.bnd_sum + 32);
  s.red = reinterpret_cast<float*>(s.bnd_row + 32);
  return s;
}

// Inclusive segmented scan over one warp: lane i gets the sum of the
// values of its run of equal rows up to and including itself. Equal
// rows must be neighbours. Every lane of the warp must call this.
__device__ __forceinline__ float run_scan(float v, unsigned row, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(kFullMask, v, d);
    const unsigned row_up = __shfl_up_sync(kFullMask, row, d);
    if (lane >= d && row_up == row) v += up;
  }
  return v;
}

// Sums the strip's entries into s.acc. Ends with a barrier, so every
// thread may read s.acc afterwards.
__device__ __forceinline__ void accumulate_strip(const TilePlanArgs& p,
                                                 const float* __restrict__ x,
                                                 int strip,
                                                 const TileShared& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < p.out_strip; i += kTileThreads) s.acc[i] = 0.f;

  const int t_end = p.strip_tile_ptr[strip + 1];
  for (int t = p.strip_tile_ptr[strip]; t < t_end; ++t) {
    const int g0 = p.tile_ptr[t];
    const int e_begin = g0 * p.group;
    const int e_end = p.tile_ptr[t + 1] * p.group;
    const int in_base = p.meta[4 * g0 + 3] * p.in_window;
    const int in_len = min(p.in_window, p.num_cols - in_base);
    __syncthreads();  // the last tile's gathers are done
    for (int i = tid; i < in_len; i += kTileThreads) {
      s.win[i] = x[in_base + i];
    }
    __syncthreads();

    // The step's entries are loaded one step ahead, so the loads of the
    // next step are in flight across this step's two barriers.
    int e = e_begin + tid;
    unsigned packed = e < e_end ? (unsigned)p.loc[e] : 0u;
    float val = e < e_end ? p.vals[e] : 0.f;
    for (; e - tid < e_end; e += kTileThreads) {
      const int e_ahead = e + kTileThreads;
      const unsigned packed_ahead =
          e_ahead < e_end ? (unsigned)p.loc[e_ahead] : 0u;
      const float val_ahead = e_ahead < e_end ? p.vals[e_ahead] : 0.f;
      unsigned row = kNoRow;
      float v = 0.f;
      if (e < e_end && (packed != 0u || e == e_begin)) {
        row = packed >> 16;
        v = val * s.win[packed & 0xFFFFu];
      }
      packed = packed_ahead;
      val = val_ahead;
      v = run_scan(v, row, lane);
      const unsigned row_next = __shfl_down_sync(kFullMask, row, 1);
      const unsigned row_first = __shfl_sync(kFullMask, row, 0);
      if (lane == 31 || row_next != row) {  // last lane of its run
        if (row == row_first) {
          s.bnd_row[2 * warp] = row;
          s.bnd_sum[2 * warp] = v;
          if (lane == 31) {  // the whole warp is one run
            s.bnd_row[2 * warp + 1] = row;
            s.bnd_sum[2 * warp + 1] = 0.f;
          }
        } else if (lane == 31) {
          s.bnd_row[2 * warp + 1] = row;
          s.bnd_sum[2 * warp + 1] = v;
        } else if (row != kNoRow) {
          s.acc[row] += v;
        }
      }
      __syncthreads();
      if (warp == 0) {
        const unsigned brow = s.bnd_row[lane];
        const float total = run_scan(s.bnd_sum[lane], brow, lane);
        const unsigned brow_next = __shfl_down_sync(kFullMask, brow, 1);
        if ((lane == 31 || brow_next != brow) && brow != kNoRow) {
          s.acc[brow] += total;
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

// Block sum in a fixed order: a shuffle tree inside each warp, then
// thread 0 adds the warps' sums in warp order. Valid in thread 0. Ends
// with a barrier, so `red` may be reused at once.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFullMask, v, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kTileWarps; ++w) total += red[w];
  }
  __syncthreads();
  return total;
}

// One block per output strip: the strip's sums, then the epilogue
// `ep(p, strip, s)` once, when the strip is complete.
template <class Epilogue>
__global__ void __launch_bounds__(kTileThreads)
    tiled_strip_kernel(TilePlanArgs p, const float* __restrict__ x,
                       Epilogue ep) {
  extern __shared__ float smem[];
  const TileShared s = carve_shared(p, smem);
  accumulate_strip(p, x, blockIdx.x, s);
  ep(p, blockIdx.x, s);
}

template <class Epilogue>
inline int launch_tiled(const TilePlanArgs& p, const float* x, Epilogue ep,
                        cudaStream_t stream) {
  if (p.nstrips <= 0) return 0;
  if (p.out_strip > 16384 || p.in_window > 16384 || p.group <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = tile_shared_bytes(p);
  // Above 48 KB a block's shared memory must be asked for.
  cudaError_t err = cudaFuncSetAttribute(
      tiled_strip_kernel<Epilogue>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  tiled_strip_kernel<Epilogue>
      <<<p.nstrips, kTileThreads, bytes, stream>>>(p, x, ep);
  return (int)cudaGetLastError();
}

// The C entry points take the plan as this list of arguments.
#define FOLP_TILE_PLAN_PARAMS                                              \
  const int *loc, const float *vals, const int *meta, const int *tile_ptr, \
      const int *strip_tile_ptr, int nstrips, int group, int out_strip,    \
      int in_window, int num_rows, int num_cols
#define FOLP_TILE_PLAN_ARGS                                             \
  {loc, vals, meta, tile_ptr, strip_tile_ptr, nstrips, group, out_strip, \
   in_window, num_rows, num_cols}

}  // namespace folp
