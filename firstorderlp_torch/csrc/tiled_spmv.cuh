// Shared device code of the tile-plan kernels (tiled_spmv.cu,
// tiled_dual_step.cu, tiled_rmv_stats.cu).
//
// The plan (ops/routed.py, build_tile_plan) cuts the matrix into tiles
// of `out_strip` output rows by `in_window` input columns. A tile's
// entries are stored together, in row-major order inside the tile, and
// padded with zero entries to a whole number of groups of `group`
// entries. Each entry is one packed int32, local_col | local_row << 16,
// and one f32 value. meta holds four int32 per group: output strip,
// first-of-strip, last-of-strip, input window. An empty strip still
// stores one all-padding group, so every strip has an output and an
// epilogue.
//
// What bounds the accumulation on an H100 is not bytes but the longest
// chain of dependent latencies in any one block: the plan of the
// 100k-node PageRank LP is 8 MB and sits in the L2 cache, while its
// equality row puts an eighth of all entries into one output strip. The
// design therefore balances entries, not strips, and keeps every
// block-wide barrier out of the walk over the entries:
//
// - Work items. The host cuts each strip's run of groups into items of
//   about equal size (the `items` table: first group, index of the item
//   inside its strip, items of the strip, first scratch slot of the
//   strip; one sentinel row). A light strip is one item, a heavy strip
//   many. One block per item.
// - Warp-private sums. The block's warps share the item's entries in
//   contiguous runs of 32-entry steps, and each warp adds into its own
//   copy of the strip in shared memory, so no two warps ever touch the
//   same address and the walk needs no barrier. Local rows are sorted
//   inside a tile, so equal rows are neighbours in a step and a
//   segmented scan over the warp gives every run of equal rows its sum
//   in lane order; the run's last lane adds it to the warp's copy. A
//   row of any length costs the same five shuffle rounds a step.
// - Loads in flight. A warp loads kStepsAhead steps of packed indices,
//   values and window numbers together, one batch ahead of the batch
//   whose x it gathers and whose runs it scans, so several memory
//   latencies overlap in every warp. Two steps a batch in 32 registers
//   were as fast as four at the 100k-node size and 5-10% faster at a
//   million nodes; eight spilled and were slower at both.
// - No staging. Every entry gathers x[window base + local column]
//   straight from device memory through the read-only cache: the vector
//   lives in the L2 cache, a dense row's gathers are consecutive
//   addresses, and a sparse tile needs a few hundred of its window's
//   16,384 values. No window is copied to shared memory.
// - One fixed order for every sum, without floating-point atomics:
//   lane order in a step, step order in a warp, warp order in a block
//   (one barrier, then thread i adds the warps' copies of row i), item
//   order in a strip. A strip of one item finishes in its block. The
//   items of a split strip write their sums to `scratch` (one strip's
//   length per item, split strips only) and take an integer ticket; the
//   block that draws the strip's last ticket adds the partial strips in
//   item order, whichever block it is, and runs the epilogue. The
//   partial sums of the epilogue (kParts a strip, stored together) are
//   added the same way: a ticket per launch, and the block that finishes
//   the last strip adds them in strip order into the slots after the
//   partials. The last block of each count sets its ticket back to
//   zero, so the next launch on the stream finds the tickets as this
//   one did.
// - A short tail. After the walk, what is left is a chain of latencies,
//   so the epilogue keeps it short: in a strip of one item each thread
//   loads the epilogue's inputs of its first kAheadRows rows before the
//   walk (their latency hides under it); each warp zeroes its own copy,
//   so no barrier comes before the walk; the kParts partials of a strip
//   are reduced over the block together (block_sums: one barrier pair
//   for all of them) and thread 0 stores them and draws the launch's
//   ticket in the same barrier pair (store_sums_last_ticket); the last
//   block reduces the kParts totals together too.
//
// Padding: an entry with packed index 0 that is not the first entry of
// its group is padding (row-major order puts local (0, 0) first in its
// tile, duplicates are summed on the host, and only a tile's last
// group is padded). It is given no row and is never added anywhere.

#pragma once

#include <cuda_runtime.h>

#include "fixed_order.cuh"

namespace folp {

constexpr int kMaxTileWarps = 16;
constexpr int kStepsAhead = 2;  // steps of 32 entries loaded together
constexpr int kAheadRows = 2;   // rows a thread loads its epilogue for early
constexpr unsigned kNoKey = 0xFFFFFFFFu;

struct TilePlanArgs {
  const int* loc;     // (ngroups * group,) packed local indices
  const float* vals;  // (ngroups * group,)
  const int* meta;    // (ngroups, 4)
  const int* items;   // (nitems + 1, 4)
  float* scratch;     // (slots, out_strip) partial strips of split strips
  int* tickets;       // (nstrips + 1,) zero between launches
  int nitems;
  int nstrips;
  int group;      // entries per group
  int out_strip;  // rows per output strip
  int in_window;  // columns per input window
  int num_rows;   // length of the output vector
  int num_cols;   // length of the input vector
  int warps;      // warps per block
};

inline size_t tile_shared_bytes(const TilePlanArgs& p) {
  // the warps' copies of the strip, then two sums a warp (block_sums)
  return sizeof(float) * ((size_t)p.warps * p.out_strip + 2 * kMaxTileWarps);
}

// Inclusive segmented scan over one warp: lane i gets the sum of the
// values of its run of equal keys up to and including itself. Equal
// keys must be neighbours. Every lane of the warp must call this.
__device__ __forceinline__ float run_scan(float v, unsigned key, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(kFullMask, v, d);
    const unsigned key_up = __shfl_up_sync(kFullMask, key, d);
    if (lane >= d && key_up == key) v += up;
  }
  return v;
}

// kStepsAhead steps of one warp's entries, as loaded.
struct StepBatch {
  unsigned packed[kStepsAhead];
  float val[kStepsAhead];
  int win[kStepsAhead];
};

// Loads the batch that starts at entry `base`; a lane past `e_end`
// loads nothing and gets zeros.
__device__ __forceinline__ StepBatch load_batch(const TilePlanArgs& p,
                                                int base, int e_end,
                                                int lane) {
  StepBatch b;
#pragma unroll
  for (int k = 0; k < kStepsAhead; ++k) {
    const int e = base + 32 * k + lane;
    const bool valid = e < e_end;
    b.packed[k] = valid ? (unsigned)__ldg(p.loc + e) : 0u;
    b.val[k] = valid ? __ldg(p.vals + e) : 0.f;
    b.win[k] = valid ? __ldg(p.meta + 4 * (e / p.group) + 3) : 0;
  }
  return b;
}

// One warp adds the entries [e_begin, e_end) into `acc`, its own copy
// of the strip. The next batch's loads are started before this batch's
// gathers and scans. Every lane of the warp must call this.
__device__ __forceinline__ void accumulate_range(const TilePlanArgs& p,
                                                 const float* __restrict__ x,
                                                 int e_begin, int e_end,
                                                 float* acc, int lane) {
  StepBatch b = load_batch(p, e_begin, e_end, lane);
  for (int base = e_begin; base < e_end; base += 32 * kStepsAhead) {
    const StepBatch next =
        load_batch(p, base + 32 * kStepsAhead, e_end, lane);
    bool real[kStepsAhead];
#pragma unroll
    for (int k = 0; k < kStepsAhead; ++k) {
      const int e = base + 32 * k + lane;
      real[k] = e < e_end && (b.packed[k] != 0u || e % p.group == 0);
      const float xv =
          real[k] ? __ldg(x + (size_t)b.win[k] * p.in_window +
                          (b.packed[k] & 0xFFFFu))
                  : 0.f;
      b.val[k] = real[k] ? b.val[k] * xv : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kStepsAhead; ++k) {
      if (base + 32 * k >= e_end) break;  // the same for every lane
      const unsigned row = b.packed[k] >> 16;
      // Runs are keyed by window and row: a step may cross into the
      // next tile, where the rows start again (ops/routed.py keeps the
      // window number under 65,536).
      const unsigned key =
          real[k] ? ((unsigned)b.win[k] << 16) | row : kNoKey;
      const float v = run_scan(b.val[k], key, lane);
      const unsigned key_next = __shfl_down_sync(kFullMask, key, 1);
      const bool adds = real[k] && (lane == 31 || key_next != key);
      const int win0 = __shfl_sync(kFullMask, b.win[k], 0);
      if (__all_sync(kFullMask, !real[k] || b.win[k] == win0)) {
        // one tile: the runs' rows all differ
        if (adds) acc[row] += v;
        __syncwarp();
      } else {
        // several tiles may hold the same row: add in lane order
        for (int l = 0; l < 32; ++l) {
          if (lane == l && adds) acc[row] += v;
          __syncwarp();
        }
      }
    }
    b = next;
  }
}

// One block per item. `Epilogue` has kParts (the number of partial sums
// it takes per strip, 0 to 2), a type In of a row's epilogue inputs,
// load(row), which reads them, and row(row, sum, in, part): called once
// for every output row with the row's complete sum, by the thread that
// then holds part[kParts] for the rows it was given. `parts` (kParts > 0)
// holds the kParts partials of each strip together (kParts * nstrips),
// then the kParts totals.
template <class Epilogue>
__global__ void __launch_bounds__(32 * kMaxTileWarps)
    tiled_item_kernel(TilePlanArgs p, const float* __restrict__ x,
                      Epilogue ep, float* __restrict__ parts) {
  extern __shared__ float smem[];
  __shared__ int flag;
  constexpr int kParts = Epilogue::kParts;
  using In = typename Epilogue::In;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int warp = tid >> 5;
  float* acc = smem;  // (warps, out_strip)
  float* red = smem + (size_t)p.warps * p.out_strip;

  const int4 item = reinterpret_cast<const int4*>(p.items)[blockIdx.x];
  const int g_begin = item.x;
  const int g_end = p.items[4 * (blockIdx.x + 1)];
  const int strip = p.meta[4 * g_begin];
  const int nsplit = item.z;  // items of this strip
  const int row0 = strip * p.out_strip;
  const int rows = min(p.out_strip, p.num_rows - row0);

  // The epilogue's inputs of this thread's first kAheadRows rows, loaded
  // before the walk so that their latency hides under it. In a split
  // strip only the item that draws the strip's last ticket runs the
  // epilogue; it loads them then (as fast as loading them ahead in every
  // item of the strip, and no loads wasted).
  const bool load_ahead = nsplit == 1;
  In ahead[kAheadRows] = {};
  if (load_ahead) {
#pragma unroll
    for (int r = 0; r < kAheadRows; ++r) {
      const int i = tid + r * threads;
      if (i < rows) ahead[r] = ep.load(row0 + i);
    }
  }
  {
    // each warp zeroes and fills its own copy: no barrier before the walk
    float* mine = acc + (size_t)warp * p.out_strip;
    for (int i = tid & 31; i < p.out_strip; i += 32) mine[i] = 0.f;
    __syncwarp();
    // contiguous shares of whole steps, in warp order
    const int e0 = g_begin * p.group;
    const int e1 = g_end * p.group;
    const int steps = (e1 - e0 + 31) / 32;
    const int share = (steps + p.warps - 1) / p.warps;
    const int w_begin = min(e0 + 32 * share * warp, e1);
    const int w_end = min(w_begin + 32 * share, e1);
    accumulate_range(p, x, w_begin, w_end, mine, tid & 31);
  }
  __syncthreads();

  const float* slots = p.scratch + (size_t)item.w * p.out_strip;
  if (nsplit > 1) {
    float* mine = p.scratch + (size_t)(item.w + item.y) * p.out_strip;
    for (int i = tid; i < p.out_strip; i += threads) {
      float sum = 0.f;
      for (int w = 0; w < p.warps; ++w) sum += acc[w * p.out_strip + i];
      __stcg(mine + i, sum);
    }
    if (!last_ticket(p.tickets + strip, nsplit, &flag)) return;
  }

  float part[kParts > 0 ? kParts : 1] = {};
  auto finish = [&](int i, const In& in) {
    float sum = 0.f;
    if (nsplit > 1) {
      for (int k = 0; k < nsplit; ++k) {
        sum += __ldcg(slots + (size_t)k * p.out_strip + i);
      }
    } else {
      for (int w = 0; w < p.warps; ++w) sum += acc[w * p.out_strip + i];
    }
    ep.row(row0 + i, sum, in, part);
  };
#pragma unroll
  for (int r = 0; r < kAheadRows; ++r) {
    const int i = tid + r * threads;
    if (i < rows) finish(i, load_ahead ? ahead[r] : ep.load(row0 + i));
  }
  for (int i = tid + kAheadRows * threads; i < rows; i += threads) {
    finish(i, ep.load(row0 + i));
  }
  if constexpr (kParts > 0) {
    // the strip's partials, then the launch's ticket, in one barrier pair
    if (!store_sums_last_ticket(part, red, parts + (size_t)kParts * strip,
                                p.tickets + p.nstrips, p.nstrips, &flag)) {
      return;
    }
    float v[kParts] = {};
    for (int s = tid; s < p.nstrips; s += threads) {
      const float* from = parts + (size_t)kParts * s;
      if constexpr (kParts == 2) {
        const float2 two = __ldcg(reinterpret_cast<const float2*>(from));
        v[0] += two.x;
        v[1] += two.y;
      } else {
#pragma unroll
        for (int k = 0; k < kParts; ++k) v[k] += __ldcg(from + k);
      }
    }
    block_sums(v, red);
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < kParts; ++k) {
        parts[(size_t)kParts * p.nstrips + k] = v[k];
      }
    }
  }
}

template <class Epilogue>
inline int launch_tiled(const TilePlanArgs& p, const float* x, Epilogue ep,
                        float* parts, cudaStream_t stream) {
  if (p.nitems <= 0) return 0;
  if (p.out_strip > 16384 || p.in_window > 16384 || p.group <= 0 ||
      p.warps < 1 || p.warps > kMaxTileWarps) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = tile_shared_bytes(p);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {  // must be asked for
    cudaError_t err = cudaFuncSetAttribute(
        tiled_item_kernel<Epilogue>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  tiled_item_kernel<Epilogue>
      <<<p.nitems, 32 * p.warps, bytes, stream>>>(p, x, ep, parts);
  return (int)cudaGetLastError();
}

// The C entry points take the plan as this list of arguments.
#define FOLP_TILE_PLAN_PARAMS                                             \
  const int *loc, const float *vals, const int *meta, const int *items,   \
      float *scratch, int *tickets, int nitems, int nstrips, int group,   \
      int out_strip, int in_window, int num_rows, int num_cols, int warps
#define FOLP_TILE_PLAN_ARGS                                               \
  {loc,       vals,      meta,      items,    scratch,  tickets, nitems, \
   nstrips,   group,     out_strip, in_window, num_rows, num_cols, warps}

}  // namespace folp
