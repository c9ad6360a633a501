// eval_stats: an evaluation's statistics and termination check on the
// original (unscaled) LP, in f32 on the kernel operator, as three
// launches around the B2 products (ops/eval_stats.py holds the
// contracts and the plain versions):
//
//   F2d stats_point, over n + m: the evaluation point (the weighted
//     average where it has one and there is no numerical error, else the
//     current iterate), divided by the variable and constraint
//     rescaling: the scaled and the original points, and max |x| of the
//     original primal (the ray's norm);
//   B2: A x and A'y of the original point;
//   F2e stats_primal, over n: c.x, x.x, the bound violations, the primal
//     gradient c - A'y, the reduced costs, their violation and their
//     dual-objective contribution (with "needs an infinite bound"), a
//     non-finite x (x'Qx = sum(x * 0) is then NaN); and, where
//     infeasibility is detected, the ray x / max|x| (written out for
//     B2), its bound violations, c.ray and the homogeneous reduced costs
//     of -A'y;
//   B2: A ray;
//   F2f stats_dual, over m: the equality and inequality violations of
//     b - A x and of -A ray, b.y, the dual sign violation, y.y, max |y|;
//     then its last block finalizes: every convergence and infeasibility
//     field, the relative residuals and gap, and the termination reason
//     in check_termination_criteria's precedence (optimal, primal
//     infeasible, dual infeasible, iteration, KKT passes, time), a
//     numerical error last.
//
// Replaces XLA's fusion of the JAX package's evaluate_unscaled_stats
// (firstorderlp_tpu/models/common.py:50: iteration_stats.py:62-262,
// termination.py:98-190, and the evaluation point inline in _eval_block,
// models/pdhg.py:577 and models/mirror_prox.py:238): no pl.pallas_call.
// Every state value (the iterates, the average, the flag, the
// iteration, the KKT passes, the elapsed time) is read by pointer or
// given as a host number when the caller has one; the criteria are
// kernel arguments, so a CUDA graph of an evaluation bakes in only
// them and the shapes.
//
// Bits: every sum is accumulated in f64 over f32 terms and rounded once
// to f32 (the four-part l2 norms add their parts in f64 first), in one
// fixed order: each thread its entries in index order, a shuffle tree in
// each warp, the warps in order, then the blocks' partials in the last
// block (the one that draws the last integer ticket) by the same tree.
// The plain versions sum in torch.sum's order; two orders whose longest
// chains of additions are D1 and D2 give f64 results within
// (D1 + D2) 2^-53 sum|t| of each other, so they round to the same f32
// value bar one ulp, at odds of about (D1 + D2) 2^-29 sum|t| / |S| (the
// terms of b.y, c.x and the contributions may cancel; those of the
// squares may not). Maxima are exact in any order: the largest bits of
// |v| (a NaN's above an infinity's). Each elementwise operation and each
// step of the finalize rounds once in PyTorch's order (__fadd_rn,
// __fmul_rn, __fdiv_rn, __fsub_rn: never a contracted multiply-add),
// torch.clamp_min keeps a NaN, and every threshold is the f32 value that
// PyTorch rounds a Python float to against an f32 tensor (computed on
// the host).
//
// Bound on an H100 SXM: bytes. F2d reads 2 (n + m) floats and writes
// 2 (n + m) (4 with the scaled point); F2e reads five n-vectors and
// writes the ray; F2f reads three m-vectors, a byte a row (and A ray).
// At these sizes the three are set not by their bytes but by their
// chain of dependent steps (loads, the block's reduction, the ticket,
// the last block's reduction, F2f's finalize), so their design shortens
// that chain:
// - every 0-d input (F2f: F2e's totals too) is loaded at entry; F2d
//   issues its rescaling's loads before the 0-d inputs decide which
//   point it takes, then loads only that point (loading the iterate and
//   the average's sums both and selecting was slower); no load waits
//   behind a store;
// - the grid is one wave of the card at most (the occupancy query of the
//   device, ops/eval_stats.stats_grid and point_grid), a thread a 16-byte
//   slot of each vector (F2e, F2f: kStatsSlots slots loaded at once
//   before any arithmetic; F2d: a block a chunk of kStatsThreads slots,
//   wholly in x's part or in y's; a vector whose start is not 16-byte
//   aligned, or the last part slot, read 4 bytes at a time; is_equality
//   4 bytes a slot); F2d's outputs each start on 16 bytes
//   (ops/eval_stats.point_layout), so F2e and F2f read the point whole;
// - F2d's one maximum: the bits of max |primal| of each block with an
//   entry of x, an integer atomicMax into the device's word (exact in
//   any order; no floating-point atomic), then the ticket; the block
//   that draws the last moves the word into the norm and sets it to 0;
// - F2e's and F2f's block's shuffle trees run level by level across its
//   sums; lane k of warp 0 adds value k over the warps; lane 0 stores the
//   values value-major (partials[k * blocks + b]) and draws the ticket
//   with one release-acquire add (no separate fence);
// - in the last block warp w adds the values w, w + 8, ...: each lane
//   the blocks lane, lane + 32, ... (coalesced, loaded before they are
//   added), then a shuffle tree;
// - F2f's finalize runs in thread 0 of the last block on inputs already
//   in shared memory.

#include <cuda_runtime.h>
#include <math.h>

#include "fixed_order.cuh"

namespace folp {

constexpr int kStatsThreads = 256;
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kSlotFloats = 4;  // a 16-byte slot a thread
constexpr int kChunkFloats = 1024;  // F2d: a block's chunk of slots
static_assert(kChunkFloats == kStatsThreads * kSlotFloats,
              "a chunk is a slot a thread of one block");
constexpr int kStatsSlots = 2;  // slots a thread loads at once
constexpr int kReach = 8;  // partials a lane of the last block loads at once

// stats_primal's totals: f64 sums, then maxima and flags (as f32 values
// and 0/1 in the f64 totals).
enum PrimalTotal : int {
  kCx = 0,         // sum c x
  kXx,             // sum x x
  kLower2,         // sum of the squared lower-bound violations
  kUpper2,         // sum of the squared upper-bound violations
  kRcViolation2,   // sum (g - rc)^2, g = c - A'y
  kContribution,   // sum of the reduced costs' objective terms
  kRayC,           // sum c ray
  kContributionH,  // the homogeneous reduced costs' terms
  kPrimalSums,     // (count)
  kBoundMax = kPrimalSums,  // max of both bound violations
  kRcMax,          // max |rc|
  kRcViolationMax, // max |g - rc|
  kRayBoundMax,    // max of the ray's homogeneous bound violations
  kRcHMax,         // max |rc| of -A'y
  kRcViolationHMax,
  kNonFinite,      // some x is infinite or NaN
  kNeedsInfinite,  // some reduced cost needs an infinite bound
  kNeedsInfiniteH,
  kPrimalTotals    // (count)
};

// stats_dual's totals, likewise.
enum DualTotal : int {
  kEq2 = 0,        // sum of the squared equality violations of b - A x
  kIneq2,          // ... inequality violations
  kSign2,          // sum of the squared dual sign violations
  kBy,             // sum b y
  kYy,             // sum y y
  kDualSums,
  kRowMax = kDualSums,  // max of the row violations of b - A x
  kSignMax,        // max of the dual sign violations
  kYMax,           // max |y|
  kRayRowMax,      // max of the row violations of -A ray
  kDualTotals
};

// the convergence fields, in iteration_stats.DeviceConvergenceInfo's order
enum Conv : int {
  kPrimalObjective = 0, kDualObjective, kCorrectedDualObjective,
  kLInfPrimalResidual, kL2PrimalResidual, kLInfDualResidual,
  kL2DualResidual, kRelLInfPrimalResidual, kRelL2PrimalResidual,
  kRelLInfDualResidual, kRelL2DualResidual, kRelGap,
  kLInfPrimalVariable, kL2PrimalVariable, kLInfDualVariable,
  kL2DualVariable, kConvFields
};

// and DeviceInfeasibilityInfo's
enum Infeas : int {
  kMaxPrimalRayInfeasibility = 0, kPrimalRayLinearObjective,
  kPrimalRayQuadraticNorm, kMaxDualRayInfeasibility, kDualRayObjective,
  kInfeasFields
};

struct PointArgs {
  const float* x;
  const float* y;
  const float* sum_x;  // the average's sums, or null: the point is (x, y)
  const float* sum_y;
  const long long* count_x;
  const long long* count_y;
  const float* weight_x;
  const float* weight_y;
  const bool* numerical_error;
  const float* variable_rescaling;
  const float* constraint_rescaling;
  float* scaled_x;  // or null: not written
  float* scaled_y;
  float* primal;
  float* dual;
  float* primal_norm;
  unsigned* norm_word;  // the device's max |primal| bits, 0 between launches
  int* ticket;
  int n;
  int m;
  int blocks;  // ops/eval_stats.point_grid
};

struct PrimalArgs {
  const float* primal;
  const float* aty;
  const float* objective;
  const float* lower;
  const float* upper;
  const float* primal_norm;
  float* ray;  // or null: no infeasibility detection
  double* partials;  // (sums + maxima) x blocks, value-major
  double* totals;
  int* ticket;
  int n;
  int blocks;
};

struct DualArgs {
  const float* dual;
  const float* ax;
  const float* aray;  // or null: no infeasibility detection
  const float* rhs;
  const bool* is_equality;
  const double* primal_totals;
  const float* primal_norm;
  const float* objective_constant;
  const float* norm_c_inf;  // the norm cache of the original c and b
  const float* norm_b_inf;
  const float* norm_c_2;
  const float* norm_b_2;
  const bool* numerical_error;  // each of these four may be null: the
  const long long* iteration;   // host value below stands in
  const double* kkt_passes;
  const double* elapsed;
  double* partials;  // (sums + maxima) x blocks, value-major
  double* totals;
  float* conv;
  float* infeas;
  int* reason;
  int* ticket;
  long long iteration_value;
  long long iteration_limit;
  double kkt_value;
  double kkt_limit;
  double elapsed_value;
  double time_limit;
  float eps_ratio;  // f32 values of the criteria's Python floats
  float abs_tol;
  float rel_tol;
  float eps_primal_infeasible;
  float eps_dual_infeasible;
  int numerical_error_value;
  int l_inf;  // 1: the optimality norm is l_inf, 0: l2
  int m;
  int blocks;
};

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

__device__ __forceinline__ bool is_finite(float v) { return isfinite(v); }

// torch.clamp_min(v, 0): a NaN stays (the sign of a zero does not
// matter here: every result is squared or taken absolute).
__device__ __forceinline__ float clamp_min0(float v) {
  return v != v ? v : fmaxf(v, 0.f);
}

__device__ __forceinline__ double square(float v) {
  return static_cast<double>(__fmul_rn(v, v));
}

// torch.maximum on f32: a NaN propagates.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// A launch total as the f64 totals hold it: a sum as it is, a maximum as
// the f32 value of its bits, a flag as 0 or 1.
__device__ __forceinline__ double total_value(const double* total, int k,
                                              int sums, int maxima) {
  if (k < sums) return total[k];
  const unsigned bits = static_cast<unsigned>(total[k]);
  return k < sums + maxima ? static_cast<double>(__uint_as_float(bits))
                           : static_cast<double>(bits);
}

// ---------------------------------------------------------------------------
// 16-byte slots; F2e's and F2f's partials, the ticket, the launch's totals
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool on_16_bytes(const void* v) {
  return (reinterpret_cast<size_t>(v) & 15) == 0;
}

// Entries 4q to 4q + 3 of v (n entries): one 16-byte load where v is
// 16-byte aligned (`vec`) and the slot lies whole inside, else four
// 4-byte loads; 0 past the end (such an entry adds nothing to any
// total, and nothing is written for it).
__device__ __forceinline__ float4 load_slot(const float* __restrict__ v,
                                            int q, int n, bool vec) {
  if (vec && 4 * q + kSlotFloats <= n) {
    return __ldg(reinterpret_cast<const float4*>(v) + q);
  }
  float e[kSlotFloats];
#pragma unroll
  for (int k = 0; k < kSlotFloats; ++k) {
    const int j = 4 * q + k;
    e[k] = j < n ? __ldg(v + j) : 0.f;
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

// The flags of entries 4q to 4q + 3 as the bytes of a word, 0 past the
// end: one 4-byte load where the flags start at a 4-byte boundary
// (`word`) and the slot lies whole inside, else a byte at a time.
__device__ __forceinline__ unsigned load_flags(const bool* __restrict__ v,
                                               int q, int n, bool word) {
  if (word && 4 * q + kSlotFloats <= n) {
    return __ldg(reinterpret_cast<const unsigned*>(v) + q);
  }
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(v);
  unsigned w = 0u;
#pragma unroll
  for (int k = 0; k < kSlotFloats; ++k) {
    const int j = 4 * q + k;
    if (j < n) w |= static_cast<unsigned>(__ldg(bytes + j)) << (8 * k);
  }
  return w;
}

__device__ __forceinline__ float entry_of(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// Entries 4q to 4q + 3 of v: one 16-byte store where v is 16-byte
// aligned and the slot lies whole inside, else those below n.
__device__ __forceinline__ void store_slot(float* v, int q, int n, bool vec,
                                           const float (&e)[kSlotFloats]) {
  if (vec && 4 * q + kSlotFloats <= n) {
    reinterpret_cast<float4*>(v)[q] = make_float4(e[0], e[1], e[2], e[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kSlotFloats; ++k) {
    if (4 * q + k < n) v[4 * q + k] = e[k];
  }
}

// Where value k of block b lies in the partials of a launch of `blocks`
// blocks: value-major, so the last block reads each value's partials
// coalesced.
__device__ __forceinline__ int partial_index(int k, int b, int blocks) {
  return k * blocks + b;
}

// The ticket a block draws after its partials: an integer add with
// release and acquire semantics at device scope, so the block that draws
// the last sees every block's partials stored before its draw.
__device__ __forceinline__ int draw_release_acquire(int* ticket) {
  int drawn;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(drawn)
               : "l"(ticket)
               : "memory");
  return drawn;
}

// A block's S sums (f64) and M maxima (bits) into its partials, then the
// ticket: a shuffle tree in each warp, level by level across the sums
// (a maximum by one reduction); warp w's values to red[w * K + k]; lane
// k of warp 0 adds value k over the warps in warp order; lane 0 gathers
// the K values, stores them past the L1 cache and draws the ticket. True
// in every thread of the block that drew the last, which then sees every
// block's partials (its lane 0's acquire, then the barrier).
template <int S, int M>
__device__ __forceinline__ bool store_partials_last(double (&s)[S],
                                                    unsigned (&mx)[M],
                                                    double* red,
                                                    double* partials,
                                                    int* ticket, int* flag) {
  constexpr int K = S + M;
  static_assert(K <= 32, "a lane of warp 0 a value");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      s[k] += __shfl_down_sync(kFullMask, s[k], off);
    }
  }
#pragma unroll
  for (int k = 0; k < M; ++k) mx[k] = __reduce_max_sync(kFullMask, mx[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) red[warp * K + k] = s[k];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      red[warp * K + S + k] = static_cast<double>(mx[k]);
    }
  }
  __syncthreads();
  if (warp == 0) {
    double acc = 0.0;
    if (lane < S) {
#pragma unroll
      for (int w = 0; w < kStatsWarps; ++w) acc += red[w * K + lane];
    } else if (lane < K) {
      unsigned bits = 0u;
#pragma unroll
      for (int w = 0; w < kStatsWarps; ++w) {
        bits = max(bits, static_cast<unsigned>(red[w * K + lane]));
      }
      acc = static_cast<double>(bits);
    }
    double value[K];
#pragma unroll
    for (int k = 0; k < K; ++k) value[k] = __shfl_sync(kFullMask, acc, k);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        __stcg(partials + partial_index(k, blockIdx.x, gridDim.x), value[k]);
      }
      const bool last = draw_release_acquire(ticket) == (int)gridDim.x - 1;
      if (last) *ticket = 0;
      *flag = last;
    }
  }
  __syncthreads();
  return *flag != 0;
}

// In the last block, the launch's K = S + M totals into `total` (shared;
// a sum, or a maximum's bits, as the partials hold them): warp w adds
// the values w, w + 8, ...: each lane the blocks lane, lane + 32, ... in
// order, kReach of them loaded before they are added, then a shuffle
// tree; lane 0 writes the total. Ends with a barrier.
template <int S, int M>
__device__ __forceinline__ void launch_totals(const double* partials,
                                              double* total) {
  constexpr int K = S + M;
  constexpr int V = (K + kStatsWarps - 1) / kStatsWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int blocks = gridDim.x;
  double v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = 0.0;
  for (int b0 = lane; b0 < blocks; b0 += 32 * kReach) {
    double got[kReach][V];
#pragma unroll
    for (int r = 0; r < kReach; ++r) {
      const int b = b0 + 32 * r;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int k = warp + kStatsWarps * i;
        got[r][i] = k < K && b < blocks
                        ? __ldcg(partials + partial_index(k, b, blocks))
                        : 0.0;
      }
    }
#pragma unroll
    for (int r = 0; r < kReach; ++r) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int k = warp + kStatsWarps * i;
        v[i] = k < S ? v[i] + got[r][i] : fmax(v[i], got[r][i]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const double o = __shfl_down_sync(kFullMask, v[i], off);
      const int k = warp + kStatsWarps * i;
      v[i] = k < S ? v[i] + o : fmax(v[i], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int k = warp + kStatsWarps * i;
      if (k < K) total[k] = v[i];
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// F2d stats_point
// ---------------------------------------------------------------------------

// F2d's chunks over a part of `len` entries: kStatsThreads slots each.
__device__ __forceinline__ int point_chunks(int len) {
  return (len + kChunkFloats - 1) / kChunkFloats;
}

// Grid: a.blocks blocks (ops/eval_stats.point_grid); x's part is chunks
// 0 to point_chunks(n) - 1, y's the rest, and block b takes the chunks
// b, b + blocks, ...: thread t slot c * kStatsThreads + t of the chunk's
// part. evaluation_point: the average where it exists and there is no
// numerical error; compute_average divides by the weight, 1 for an empty
// average.
__global__ void __launch_bounds__(kStatsThreads)
    stats_point_kernel(const PointArgs a) {
  __shared__ unsigned warp_max[kStatsWarps];
  const bool avg = a.sum_x != nullptr;
  // the 0-d inputs first; only the choice of the point waits for them
  unsigned char flag = 1;
  long long count_x = 0, count_y = 0;
  float weight_x = 1.f, weight_y = 1.f;
  if (avg) {
    flag = __ldg(reinterpret_cast<const unsigned char*>(a.numerical_error));
    count_x = __ldg(a.count_x);
    count_y = __ldg(a.count_y);
    weight_x = __ldg(a.weight_x);
    weight_y = __ldg(a.weight_y);
  }
  const int x_chunks = point_chunks(a.n);
  const int chunks = x_chunks + point_chunks(a.m);
  unsigned mx = 0u;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const bool primal = c < x_chunks;
    const int len = primal ? a.n : a.m;
    const int q = (primal ? c : c - x_chunks) * kStatsThreads + threadIdx.x;
    if (kSlotFloats * q >= len) continue;
    const float* v = primal ? a.x : a.y;
    const float* sum = primal ? a.sum_x : a.sum_y;
    const float* rescale =
        primal ? a.variable_rescaling : a.constraint_rescaling;
    float* scaled = primal ? a.scaled_x : a.scaled_y;
    float* out = primal ? a.primal : a.dual;
    // the rescaling before the choice, then only the chosen vector:
    // loading both candidates and selecting was slower (PERF.md §6)
    const float4 r = load_slot(rescale, q, len, on_16_bytes(rescale));
    const bool has_avg = avg && flag == 0 && count_x > 0 && count_y > 0;
    const float* chosen = has_avg ? sum : v;
    const float4 s = load_slot(chosen, q, len, on_16_bytes(chosen));
    const float w0 = primal ? weight_x : weight_y;
    const float w = w0 > 0.f ? w0 : 1.f;
    float p[kSlotFloats], o[kSlotFloats];
#pragma unroll
    for (int k = 0; k < kSlotFloats; ++k) {
      p[k] = has_avg ? __fdiv_rn(entry_of(s, k), w) : entry_of(s, k);
      o[k] = __fdiv_rn(p[k], entry_of(r, k));
      // past the end o is 0 / 0: not an entry
      if (primal && kSlotFloats * q + k < len) mx = max(mx, abs_bits(o[k]));
    }
    if (scaled != nullptr) store_slot(scaled, q, len, on_16_bytes(scaled), p);
    store_slot(out, q, len, on_16_bytes(out), o);
  }
  if (blockIdx.x >= x_chunks) {  // no entry of x in this block
    if (x_chunks == 0 && blockIdx.x == 0 && threadIdx.x == 0) {
      *a.primal_norm = 0.f;  // max over no entry
    }
    return;
  }
  // the block's maximum into the device's word, then the ticket of the
  // blocks with an entry of x: the last moves the word into the norm
  mx = __reduce_max_sync(kFullMask, mx);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int w = 1; w < kStatsWarps; ++w) mx = max(mx, warp_max[w]);
  atomicMax(a.norm_word, mx);
  const int drawers = min(x_chunks, (int)gridDim.x);
  if (draw_release_acquire(a.ticket) != drawers - 1) return;
  *a.ticket = 0;
  *a.primal_norm = __uint_as_float(atomicExch(a.norm_word, 0u));
}

// ---------------------------------------------------------------------------
// F2e stats_primal
// ---------------------------------------------------------------------------

// reduced_costs_from_primal_gradient and the terms of
// reduced_costs_dual_objective_contribution for one component: rc, and
// (term, needs an infinite bound).
struct ReducedCost {
  float rc, term;
  bool needs_infinite;
};

__device__ __forceinline__ ReducedCost reduced_cost(float g, float l,
                                                    float u) {
  const float rc = is_finite(g > 0.f ? l : u) ? g : 0.f;
  const float bound = rc > 0.f ? l : u;
  const bool active = rc != 0.f;  // a NaN too
  const float safe = active && is_finite(bound) ? bound : 0.f;
  return {rc, __fmul_rn(safe, active ? rc : 0.f),
          active && !is_finite(bound)};
}

constexpr int kPS = kPrimalSums;
constexpr int kPM = kPrimalTotals - kPrimalSums;

// One variable's terms into the thread's sums and maxima; returns its
// ray entry (where `ray` is set).
__device__ __forceinline__ float primal_entry(float x, float c, float l,
                                              float u, float aty, float norm,
                                              bool ray, double (&s)[kPS],
                                              unsigned (&mx)[kPM]) {
  s[kCx] += static_cast<double>(__fmul_rn(c, x));
  s[kXx] += square(x);
  const float lo = clamp_min0(__fsub_rn(l, x));
  const float up = clamp_min0(__fsub_rn(x, u));
  s[kLower2] += square(lo);
  s[kUpper2] += square(up);
  mx[kBoundMax - kPS] =
      max(mx[kBoundMax - kPS], max(abs_bits(lo), abs_bits(up)));
  if (!is_finite(x)) mx[kNonFinite - kPS] = 1u;
  const float g = __fsub_rn(c, aty);
  const ReducedCost r = reduced_cost(g, l, u);
  const float violation = __fsub_rn(g, r.rc);
  s[kRcViolation2] += square(violation);
  s[kContribution] += static_cast<double>(r.term);
  mx[kRcMax - kPS] = max(mx[kRcMax - kPS], abs_bits(r.rc));
  mx[kRcViolationMax - kPS] =
      max(mx[kRcViolationMax - kPS], abs_bits(violation));
  if (r.needs_infinite) mx[kNeedsInfinite - kPS] = 1u;
  if (!ray) return 0.f;
  const float out = norm == 0.f ? x : __fdiv_rn(x, norm);
  // the homogeneous primal: finite bounds at 0, infinite ones kept
  const float hl = is_finite(l) ? 0.f : -INFINITY;
  const float hu = is_finite(u) ? 0.f : INFINITY;
  mx[kRayBoundMax - kPS] =
      max(mx[kRayBoundMax - kPS],
          max(abs_bits(clamp_min0(__fsub_rn(hl, out))),
              abs_bits(clamp_min0(__fsub_rn(out, hu)))));
  s[kRayC] += static_cast<double>(__fmul_rn(c, out));
  // the homogeneous dual: the objective at 0, so g = -A'y
  const float gh = -aty;
  const ReducedCost h = reduced_cost(gh, l, u);
  s[kContributionH] += static_cast<double>(h.term);
  mx[kRcHMax - kPS] = max(mx[kRcHMax - kPS], abs_bits(h.rc));
  mx[kRcViolationHMax - kPS] =
      max(mx[kRcViolationHMax - kPS], abs_bits(__fsub_rn(gh, h.rc)));
  if (h.needs_infinite) mx[kNeedsInfiniteH - kPS] = 1u;
  return out;
}

// Grid: a.blocks blocks (ops/eval_stats.stats_grid); thread i of the
// launch takes the slots i, i + T B, ... of the n / 4, kStatsSlots at a
// time, their loads issued first.
__global__ void __launch_bounds__(kStatsThreads)
    stats_primal_kernel(const PrimalArgs a) {
  constexpr int T = kStatsThreads;
  constexpr int U = kStatsSlots;
  constexpr int kInputs = 5;  // x, c, l, u, A'y
  __shared__ double red[kStatsWarps * kPrimalTotals];
  __shared__ double total[kPrimalTotals];
  __shared__ int last;
  const float norm = __ldg(a.primal_norm);
  const float* in[kInputs] = {a.primal, a.objective, a.lower, a.upper,
                              a.aty};
  bool vec[kInputs];
#pragma unroll
  for (int i = 0; i < kInputs; ++i) vec[i] = on_16_bytes(in[i]);
  const bool ray = a.ray != nullptr;
  const bool ray_vec = ray && on_16_bytes(a.ray);
  double s[kPS];
  unsigned mx[kPM];
#pragma unroll
  for (int k = 0; k < kPS; ++k) s[k] = 0.0;
#pragma unroll
  for (int k = 0; k < kPM; ++k) mx[k] = 0u;
  const int n = a.n;
  const int slots = (n + 3) >> 2;
  const int stride = gridDim.x * T;
  for (int q0 = blockIdx.x * T + threadIdx.x; q0 < slots; q0 += U * stride) {
    float4 v[U][kInputs];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (q0 + u * stride < slots) {
#pragma unroll
        for (int i = 0; i < kInputs; ++i) {
          v[u][i] = load_slot(in[i], q0 + u * stride, n, vec[i]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * stride;
      if (q >= slots) break;
      float r[kSlotFloats];
#pragma unroll
      for (int k = 0; k < kSlotFloats; ++k) {
        r[k] = primal_entry(entry_of(v[u][0], k), entry_of(v[u][1], k),
                            entry_of(v[u][2], k), entry_of(v[u][3], k),
                            entry_of(v[u][4], k), norm, ray, s, mx);
      }
      if (ray) store_slot(a.ray, q, n, ray_vec, r);
    }
  }
  if (!store_partials_last<kPS, kPM>(s, mx, red, a.partials, a.ticket,
                                     &last)) {
    return;
  }
  launch_totals<kPS, kPM>(a.partials, total);
  if (threadIdx.x < kPrimalTotals) {
    a.totals[threadIdx.x] =
        total_value(total, threadIdx.x, kPS, kNonFinite - kPS);
  }
}

// ---------------------------------------------------------------------------
// F2f stats_dual and the finalize
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(double v) {
  return __double2float_rn(v);
}

constexpr int kDS = kDualSums;
constexpr int kDM = kDualTotals - kDualSums;

// F2f's f32 0-d inputs, by their place in DualInputs::f
enum DualFloat : int {
  kObjectiveConstant = 0, kNormCInf, kNormBInf, kNormC2, kNormB2,
  kPrimalNormInput, kDualFloats
};

// The finalize's inputs besides the dual totals, loaded at entry.
struct DualInputs {
  double p[kPrimalTotals];  // F2e's totals
  float f[kDualFloats];
  long long iteration;
  double kkt;
  double elapsed;
  int numerical_error;
};

// Every block, at entry: warp 0's lanes F2e's totals, warp 1's the f32
// inputs, warps 2-5 one scalar each (the host value where the pointer is
// null), so each warp waits for one load before its vectors' loads.
__device__ __forceinline__ void load_dual_inputs(const DualArgs& a,
                                                 DualInputs* in) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    if (lane < kPrimalTotals) in->p[lane] = __ldg(a.primal_totals + lane);
  } else if (warp == 1) {
    if (lane < kDualFloats) {
      const float* src = lane == kObjectiveConstant ? a.objective_constant
                         : lane == kNormCInf        ? a.norm_c_inf
                         : lane == kNormBInf        ? a.norm_b_inf
                         : lane == kNormC2          ? a.norm_c_2
                         : lane == kNormB2          ? a.norm_b_2
                                                    : a.primal_norm;
      in->f[lane] = __ldg(src);
    }
  } else if (lane == 0) {
    if (warp == 2) {
      in->iteration =
          a.iteration != nullptr ? __ldg(a.iteration) : a.iteration_value;
    } else if (warp == 3) {
      in->kkt = a.kkt_passes != nullptr ? __ldg(a.kkt_passes) : a.kkt_value;
    } else if (warp == 4) {
      in->elapsed = a.elapsed != nullptr ? __ldg(a.elapsed) : a.elapsed_value;
    } else if (warp == 5) {
      in->numerical_error =
          a.numerical_error != nullptr
              ? __ldg(reinterpret_cast<const unsigned char*>(
                    a.numerical_error)) != 0
              : a.numerical_error_value != 0;
    }
  }
}

// Thread 0 of the last block: every field and the reason from the two
// launches' totals (iteration_stats.compute_convergence_information,
// compute_infeasibility_information and termination.
// check_termination_criteria, as models/common.evaluate_unscaled_stats
// composes them), each step rounded as stats_finalize_plain rounds it,
// every input read from shared memory (`raw`: the dual totals as
// launch_totals leaves them). One thread: spread over a warp's lanes, the
// selects and shuffles cost more than the divisions they spread.
__device__ void finalize(const DualArgs& a, const DualInputs& in,
                         const double* raw) {
  const double* p = in.p;
  double d[kDualTotals];
#pragma unroll
  for (int k = 0; k < kDualTotals; ++k) d[k] = total_value(raw, k, kDS, kDM);
  const float nan = __int_as_float(0x7fffffff);
  const float constant = in.f[kObjectiveConstant];
  // x'Qx of an LP, sum(x * 0): NaN where some x is not finite
  const float qx_dot_x = p[kNonFinite] != 0.0 ? nan : 0.f;
  const float half_q = __fmul_rn(0.5f, qx_dot_x);
  float* conv = a.conv;
  const float linf_pr =
      nan_max(to_f32(d[kRowMax]), to_f32(p[kBoundMax]));
  const float l2_pr = sqrtf(to_f32(
      __dadd_rn(__dadd_rn(__dadd_rn(d[kEq2], d[kIneq2]), p[kLower2]),
                p[kUpper2])));
  const float pobj =
      __fadd_rn(__fadd_rn(constant, to_f32(p[kCx])), half_q);
  const float linf_dr =
      nan_max(to_f32(d[kSignMax]), to_f32(p[kRcViolationMax]));
  const float l2_dr =
      sqrtf(to_f32(__dadd_rn(d[kSign2], p[kRcViolation2])));
  const float by = to_f32(d[kBy]);
  const float base = __fsub_rn(__fadd_rn(by, constant), half_q);
  const float contribution =
      p[kNeedsInfinite] != 0.0 ? -INFINITY : to_f32(p[kContribution]);
  const float dobj = __fadd_rn(base, contribution);
  const float gap = fabsf(__fsub_rn(pobj, dobj));
  const float abs_obj = __fadd_rn(fabsf(pobj), fabsf(dobj));
  const float norm_c_inf = in.f[kNormCInf], norm_b_inf = in.f[kNormBInf];
  const float norm_c_2 = in.f[kNormC2], norm_b_2 = in.f[kNormB2];
  conv[kPrimalObjective] = pobj;
  conv[kDualObjective] = dobj;
  conv[kCorrectedDualObjective] = linf_dr == 0.f ? dobj : -INFINITY;
  conv[kLInfPrimalResidual] = linf_pr;
  conv[kL2PrimalResidual] = l2_pr;
  conv[kLInfDualResidual] = linf_dr;
  conv[kL2DualResidual] = l2_dr;
  conv[kRelLInfPrimalResidual] =
      __fdiv_rn(linf_pr, __fadd_rn(a.eps_ratio, norm_b_inf));
  conv[kRelL2PrimalResidual] =
      __fdiv_rn(l2_pr, __fadd_rn(a.eps_ratio, norm_b_2));
  conv[kRelLInfDualResidual] =
      __fdiv_rn(linf_dr, __fadd_rn(a.eps_ratio, norm_c_inf));
  conv[kRelL2DualResidual] =
      __fdiv_rn(l2_dr, __fadd_rn(a.eps_ratio, norm_c_2));
  conv[kRelGap] = __fdiv_rn(gap, __fadd_rn(a.eps_ratio, abs_obj));
  conv[kLInfPrimalVariable] = in.f[kPrimalNormInput];
  conv[kL2PrimalVariable] = sqrtf(to_f32(p[kXx]));
  conv[kLInfDualVariable] = to_f32(d[kYMax]);
  conv[kL2DualVariable] = sqrtf(to_f32(d[kYy]));

  float f[kInfeasFields] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (a.aray != nullptr) {
    f[kMaxPrimalRayInfeasibility] =
        nan_max(to_f32(d[kRayRowMax]), to_f32(p[kRayBoundMax]));
    f[kPrimalRayLinearObjective] = to_f32(p[kRayC]);
    f[kPrimalRayQuadraticNorm] = 0.f;  // max |Q ray| of an LP
    const float linf_h =
        nan_max(to_f32(d[kSignMax]), to_f32(p[kRcViolationHMax]));
    const float contribution_h =
        p[kNeedsInfiniteH] != 0.0 ? -INFINITY : to_f32(p[kContributionH]);
    const float dobj_h =
        __fadd_rn(__fsub_rn(__fadd_rn(by, 0.f), 0.f), contribution_h);
    const float scale = nan_max(to_f32(d[kYMax]), to_f32(p[kRcHMax]));
    const float safe = scale == 0.f ? 1.f : scale;
    const float linf_dual_res = sqrtf(__fmul_rn(linf_h, linf_h));
    f[kMaxDualRayInfeasibility] =
        scale == 0.f ? 0.f : __fdiv_rn(linf_dual_res, safe);
    f[kDualRayObjective] = scale == 0.f ? 0.f : __fdiv_rn(dobj_h, safe);
  }
#pragma unroll
  for (int k = 0; k < kInfeasFields; ++k) a.infeas[k] = f[k];

  // check_termination_criteria, its precedence kept
  const float primal_err = a.l_inf ? linf_pr : l2_pr;
  const float dual_err = a.l_inf ? linf_dr : l2_dr;
  const float primal_base = a.l_inf ? norm_b_inf : norm_b_2;
  const float dual_base = a.l_inf ? norm_c_inf : norm_c_2;
  const bool optimal =
      dual_err < __fadd_rn(a.abs_tol, __fmul_rn(a.rel_tol, dual_base)) &&
      primal_err < __fadd_rn(a.abs_tol, __fmul_rn(a.rel_tol, primal_base)) &&
      gap < __fadd_rn(a.abs_tol, __fmul_rn(a.rel_tol, abs_obj));
  const float dro = f[kDualRayObjective];
  const bool primal_infeasible =
      dro > 0.f &&
      __fdiv_rn(f[kMaxDualRayInfeasibility], dro) <= a.eps_primal_infeasible;
  const float prlo = f[kPrimalRayLinearObjective];
  const float neg = -prlo;
  const bool dual_infeasible =
      prlo < 0.f &&
      __fdiv_rn(f[kMaxPrimalRayInfeasibility], neg) <=
          a.eps_dual_infeasible &&
      __fdiv_rn(f[kPrimalRayQuadraticNorm], neg) <= a.eps_dual_infeasible;
  int reason = 0;
  if (optimal) {
    reason = 1;  // TERMINATION_REASON_OPTIMAL
  } else if (primal_infeasible) {
    reason = 2;  // PRIMAL_INFEASIBLE
  } else if (dual_infeasible) {
    reason = 3;  // DUAL_INFEASIBLE
  } else if (in.iteration >= a.iteration_limit) {
    reason = 5;  // ITERATION_LIMIT
  } else if (in.kkt >= a.kkt_limit) {
    reason = 6;  // KKT_MATRIX_PASS_LIMIT
  } else if (in.elapsed >= a.time_limit) {
    reason = 4;  // TIME_LIMIT
  } else if (in.numerical_error) {
    reason = 7;  // NUMERICAL_ERROR
  }
  *a.reason = reason;
}

// One row's terms into the thread's sums and maxima (`aray`: -A ray's
// entry, where `ray` is set).
__device__ __forceinline__ void dual_entry(float y, float b, float ax,
                                           bool eq, bool ray, float aray,
                                           double (&s)[kDS],
                                           unsigned (&mx)[kDM]) {
  const float r = __fsub_rn(b, ax);
  const float eq_v = eq ? r : 0.f;
  const float ineq_v = eq ? 0.f : clamp_min0(r);
  s[kEq2] += square(eq_v);
  s[kIneq2] += square(ineq_v);
  mx[kRowMax - kDS] =
      max(mx[kRowMax - kDS], max(abs_bits(eq_v), abs_bits(ineq_v)));
  const float sign = eq ? 0.f : clamp_min0(-y);
  s[kSign2] += square(sign);
  mx[kSignMax - kDS] = max(mx[kSignMax - kDS], abs_bits(sign));
  s[kBy] += static_cast<double>(__fmul_rn(b, y));
  s[kYy] += square(y);
  mx[kYMax - kDS] = max(mx[kYMax - kDS], abs_bits(y));
  if (ray) {
    const float ra = -aray;
    mx[kRayRowMax - kDS] =
        max(mx[kRayRowMax - kDS], max(abs_bits(eq ? ra : 0.f),
                                      abs_bits(eq ? 0.f : clamp_min0(ra))));
  }
}

// Grid: as stats_primal's, over the m rows.
__global__ void __launch_bounds__(kStatsThreads)
    stats_dual_kernel(const DualArgs a) {
  constexpr int T = kStatsThreads;
  constexpr int U = kStatsSlots;
  constexpr int kInputs = 4;  // y, b, A x, A ray
  __shared__ double red[kStatsWarps * kDualTotals];
  __shared__ double total[kDualTotals];
  __shared__ DualInputs inputs;
  __shared__ int last;
  load_dual_inputs(a, &inputs);
  const bool ray = a.aray != nullptr;
  const float* in[kInputs] = {a.dual, a.rhs, a.ax, ray ? a.aray : a.ax};
  bool vec[kInputs];
#pragma unroll
  for (int i = 0; i < kInputs; ++i) vec[i] = on_16_bytes(in[i]);
  const bool word = (reinterpret_cast<size_t>(a.is_equality) & 3) == 0;
  double s[kDS];
  unsigned mx[kDM];
#pragma unroll
  for (int k = 0; k < kDS; ++k) s[k] = 0.0;
#pragma unroll
  for (int k = 0; k < kDM; ++k) mx[k] = 0u;
  const int m = a.m;
  const int slots = (m + 3) >> 2;
  const int stride = gridDim.x * T;
  for (int q0 = blockIdx.x * T + threadIdx.x; q0 < slots; q0 += U * stride) {
    float4 v[U][kInputs];
    unsigned eq[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * stride;
      if (q < slots) {
#pragma unroll
        for (int i = 0; i < kInputs - 1; ++i) {
          v[u][i] = load_slot(in[i], q, m, vec[i]);
        }
        v[u][kInputs - 1] = ray ? load_slot(in[kInputs - 1], q, m,
                                            vec[kInputs - 1])
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        eq[u] = load_flags(a.is_equality, q, m, word);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (q0 + u * stride >= slots) break;
#pragma unroll
      for (int k = 0; k < kSlotFloats; ++k) {
        dual_entry(entry_of(v[u][0], k), entry_of(v[u][1], k),
                   entry_of(v[u][2], k), ((eq[u] >> (8 * k)) & 0xffu) != 0u,
                   ray, entry_of(v[u][3], k), s, mx);
      }
    }
  }
  if (!store_partials_last<kDS, kDM>(s, mx, red, a.partials, a.ticket,
                                     &last)) {
    return;
  }
  launch_totals<kDS, kDM>(a.partials, total);
  if (threadIdx.x < kDualTotals) {
    a.totals[threadIdx.x] = total_value(total, threadIdx.x, kDS, kDM);
  }
  if (threadIdx.x == 0) finalize(a, inputs, total);
}

}  // namespace folp

// F2d launches a->blocks blocks (ops/eval_stats.point_grid).
extern "C" int folp_stats_point(const folp::PointArgs* a, void* stream_ptr) {
  using namespace folp;
  if (a->blocks < 1) return (int)cudaErrorInvalidValue;
  stats_point_kernel<<<a->blocks, kStatsThreads, 0,
                       (cudaStream_t)stream_ptr>>>(*a);
  return (int)cudaGetLastError();
}

// F2e and F2f launch a->blocks blocks (ops/eval_stats.stats_grid); the
// partials hold (sums + maxima) x blocks doubles, value-major.
extern "C" int folp_stats_primal(const folp::PrimalArgs* a,
                                 void* stream_ptr) {
  using namespace folp;
  if (a->blocks < 1) return (int)cudaErrorInvalidValue;
  stats_primal_kernel<<<a->blocks, kStatsThreads, 0,
                        (cudaStream_t)stream_ptr>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int folp_stats_dual(const folp::DualArgs* a, void* stream_ptr) {
  using namespace folp;
  if (a->blocks < 1) return (int)cudaErrorInvalidValue;
  stats_dual_kernel<<<a->blocks, kStatsThreads, 0,
                      (cudaStream_t)stream_ptr>>>(*a);
  return (int)cudaGetLastError();
}

// How many blocks of stats_primal (`kernel` 0), stats_dual (1) or
// stats_point (2) an SM of the current device holds at once, into
// *blocks.
extern "C" int folp_stats_occupancy(int kernel, int* blocks) {
  using namespace folp;
  if (kernel == 2) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, stats_point_kernel, kStatsThreads, 0);
  }
  if (kernel == 1) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, stats_dual_kernel, kStatsThreads, 0);
  }
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, stats_primal_kernel, kStatsThreads, 0);
}
