// trust_region_search: the f32 exact trust-region solve of the restart
// scheme,
//
//   argmin g'x  s.t.  l <= x <= u,  ||x - c||_w <= r,
//
// one problem a row:
//
//   F2b (F2a, the prologue, fused into it): frozen components, direction
//     d = -g / w, the knots tau (where each component meets its bound, +0
//     for one that does not move) and a = (w d) d, computed once from c,
//     g, l, u, w; the row's totals; the 31-level bisection on the float
//     bits of t for the segment that holds r^2, where r^2(t) = S(t) +
//     t^2 H(t), S(t) = sum over tau <= t of (a tau) tau and H(t) = sum
//     of a over the rest, taken kSearchBits levels a trip; then t* on
//     that segment, 0 for a zero radius or g = 0. Two paths, chosen by
//     the row's length (ops/trust_region_search.search_plan): tr_search,
//     one launch of a cluster a row, for a row whose knots the cluster's
//     shared memory holds (up to 16 x 27,264 entries); the whole-card
//     path, tr_knots and then kSearchTrips launches of tr_trip, for a
//     longer one (below, after tr_solution);
//   F2c tr_solution: x = clamp(c + t* d, l, u) and the sums of
//     g (x - c) over the columns [0, split), [split, n) and all.
//
// Replaces XLA's fusion of the JAX package's trust region
// (firstorderlp_tpu/trust_region.py:42 solve_bound_constrained_trust_region
// and :112 _t_star_bisect, vmapped at :401): no pl.pallas_call. The plain
// versions and the contract are ops/trust_region_search.py's.
//
// Bits: every per-row sum is accumulated in f64 and rounded once to f32,
// in one fixed order: each thread its entries in column order (in
// tr_search, the knots that left the bracket before the ones still in
// it; in tr_trip, the knots of the warp's list in list order), then the
// warp, the warps and the row's blocks (tr_search: its cluster;
// tr_solution and the whole-card path: the blocks' slots, added by the
// row's last block), each in a fixed tree. The terms of a sum are f32
// values of one sign, so an order whose longest chain of additions is D
// gives an f64 result within D 2^-53 |S| of the exact sum S (here D is a
// thread's entries, at most ceil(n / (blocks x threads)), plus at most 24
// levels of trees).
// Two orders round to different f32 values only where an f32 rounding
// midpoint lies between their f64 results; the midpoints lie at least
// 2^-24 |S| apart, so the odds are at most about (D1 + D2) 2^-29 a sum:
// about 2e-6 where D1 + D2 is 2^10. The kernels therefore give the plain
// versions' bits, bar a one-ulp difference at those odds that comes from
// the order of addition, not from a fault, and repeats at every run on
// that input. The order changes with a launch plan's cluster size, with
// the whole-card path's grid and between the two paths, and the same
// rule covers that. The elementwise work rounds each operation once in
// PyTorch's order (__fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn:
// never a contracted multiply-add), torch.clamp keeps its NaN rules, and
// a knot below zero (or -0) is +0.
//
// The search: the plain version bisects (lo, hi] 31 times, one test
// point a trip. A trip here tests K = 2^3 - 1 = 7 points at once: the
// test points of the bisection's next 3 levels, its decision tree
// from (lo, hi] (root: lo + (hi - lo + 1) / 2; a point's left child
// the midpoint below it, its right child the one above). The sums of
// all K come from one pass over the knots, each knot one compare and a
// predicated add for each point (no atomics, no histogram). Then the
// walk down the tree with the K predicates is the bisection's own path,
// so the trips end on the bisection's lo whether or not rounding makes
// the predicate monotone in t. Levels past the 31st change nothing (the
// bracket holds one point, or none, by then), so ceil(31 / 3) = 11 trips.
// S and H at the final lo are those of the last point the walk went
// above (or the prologue's S(+0), H(+0)), so no pass follows the trips.
//
// tr_search's design for Hopper: one thread-block cluster a row
// (cudaLaunchKernelEx; up to 16 blocks, the non-portable size, when the
// card co-schedules such clusters, else 8). Each block takes a contiguous
// slice of the row and stages its slice's (tau, a) in shared memory once
// (8 bytes an entry: about 100 KB a block for 200,001 entries over 16
// blocks); the prologue loads a round of entries ahead.
// Every point a trip tests lies in [lo, hi + 1], so a staged knot at or
// below lo stays clamped and one above hi never is: each trip adds those
// to the thread's running sums and keeps only the bracket's knots, in
// order, so the passes shrink once the bracket is inside the knots'
// range. Each trip reduces a warp's 2K sums by a butterfly that halves
// the values exchanged at each level, then the warps' in a pairwise
// tree; warp b sends the block's sums into block b's inbox (distributed
// shared memory), one cluster barrier, and warp 0 of every block adds
// its inbox's blocks in a pairwise tree, walks the K answers and hands
// its block the new bracket and test points. So a launch takes the
// prologue's barrier and one a trip (12, where one test point a trip
// took 33), and none at the exit: no block reads another's shared
// memory. The radius and every input are read from device
// memory, so nothing is read back and a CUDA graph bakes in only the
// shapes.
//
// Registers: a thread holds the 2K sums in f64 and the K test points,
// and the compiler computes both adds of a point and selects, so a trip
// costs a knot about 2K f64 adds. 512 threads a block (at most 128
// registers a thread). K = 7 at 512 threads was the fastest of the tries
// (K = 15, 1,024 threads: PERF.md).
//
// Bound on an H100 SXM: bytes for F2c (c, g read and x written a row, l,
// u, w once: about 9.6 MB, 2.9 us, for 3 rows of 200,001 at 3.35 TB/s);
// F2b reads the same inputs but x (7.2 MB, 2.1 us; 72 MB, 21.5 us, for 3
// rows of 2,000,001) and then runs its trips over shared memory with a
// cluster barrier each: its floor on the card is the trips' chain of
// barriers and f64 adds, not its bytes.
//
// The whole-card path's design: a row of 2,000,001 entries needs 74
// blocks' shared memory, more than a cluster has, and a cluster a row
// that worked the knots out again from the inputs every trip read its
// 72 MB twelve times on a third of the card. Here each launch is a grid
// of one wave (the blocks the SMs hold at once, spread over the rows),
// each warp a contiguous run of its row. tr_knots reads the inputs once,
// 16-byte loads where an input allows them (F2c's row_slot), and writes
// each warp's live knots (finite and > 0: a +0 knot is clamped at every
// test point, a knot not finite never is, and the row's totals hold
// both) to the warp's list in device memory, in column order, with the
// warp's count. Each tr_trip launch reads the lists, L2-resident once
// they shrink: a warp folds the knots at or below lo and above hi into
// its fold sums and compacts the rest in place, so a trip reads only
// the bracket's knots. A block's 2K + 2 sums go to its slot, and the
// row's last block (fixed_order.cuh's integer ticket, set back to zero
// by that block so a replay starts from zero) adds the slots in block
// order, walks the K answers and writes the row's next SweepRow, which
// the next launch reads. The kernel boundaries are the grid's barriers:
// 12 launches a call, captured in the evaluation's CUDA graph like any
// other, with nothing read back to the host.
//
// F2c's design: its bytes are a few memory latencies' worth for the
// whole card, so it needs every SM busy and every load in flight, in one
// wave. Its grid is sized from the card and not the search's clusters
// (ops/trust_region_search.solution_blocks: as many blocks as the card's
// SMs hold at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor: 3 of
// 256 threads at 74 registers), spread over the rows, at most one block
// a 256-slot run of a row; 2 and 4 blocks an SM, and 8, were slower: a
// second partial wave costs a memory latency); a block takes a
// contiguous run of its row's 16-byte slots, and a thread issues the
// loads of kSolutionSlots slots (four entries of each of the five
// inputs) before any of their arithmetic: one 16-byte load for an input
// whose row starts on a 16-byte boundary with a column stride of 1 (the
// main path's shared (N,) bounds), four 4-byte loads otherwise (c and g
// rows at an odd offset, a fleet's transposed views, read in place).
// Each entry goes to its own part of the split, so a slot may straddle
// it. A block's two f64 sums go to its (row, block) slot of `partials`;
// the row's last block, behind an integer ticket (fixed_order.cuh, set
// back to zero by that block, so a replayed graph starts from zero),
// adds the slots in one fixed tree in block order and rounds once. The
// parent took the search's cluster plan (8 blocks of 512 threads a row:
// 24 blocks at the main path's 3 rows) and walked about 49 entries a
// thread one dependent scalar load at a time: 9.5 times its bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "fixed_order.cuh"

namespace cg = cooperative_groups;

namespace folp {

constexpr unsigned kTrMask = 0xffffffffu;
constexpr int kLevels = 31;  // the bisection's levels on the bits of t
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;  // tr_search's non-portable cluster
constexpr int kSearchBits = 3;     // tr_search: bisection levels a trip
constexpr int kSearchThreads = 512;  // tr_search: threads a block
constexpr int kSolutionThreads = 256;  // tr_solution: threads a block
constexpr int kSolutionSlots = 2;  // tr_solution: slots a thread loads at once
constexpr int kSweepThreads = 256;  // tr_knots, tr_trip: threads a block
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kSweepSlots = 2;     // tr_knots: slots a lane loads at once
constexpr int kTripEntries = 4;    // tr_trip: knots a lane loads at once
constexpr int kSweepValues = 16;   // tr_trip: a block's sums (2K + 2)
// the row's last block: threads a value, each a group of the blocks
constexpr int kSweepGroups = kSweepThreads / kSweepValues;
constexpr int kSweepRowDoubles = 8;  // a row's SweepRow, in doubles

struct TrustRegionArgs {
  const float* c;
  const float* g;
  const float* lower;
  const float* upper;
  const float* weight;
  const float* radius;
  float* t_star;
  float* solution;
  float* sums;
  // tr_solution: (rows, blocks) pairs of block sums; tr_knots, tr_trip:
  // kSweepValues a block
  double* partials;
  int* tickets;      // one a row, zero between launches
  float* knots;      // tr_knots, tr_trip: each row's live (tau, a) lists
  int* counts;       // tr_knots, tr_trip: each warp's list length
  double* search;    // tr_knots, tr_trip: two SweepRows a row
  // Each input's element (row, j) at row * row_stride + j * col_stride:
  // a row stride of 0 gives every row one (n,) vector, and a transposed
  // (n, rows) view is read where it lies.
  int c_row_stride;
  int c_col_stride;
  int g_row_stride;
  int g_col_stride;
  int lower_row_stride;
  int lower_col_stride;
  int upper_row_stride;
  int upper_col_stride;
  int weight_row_stride;
  int weight_col_stride;
  int rows;
  int n;
  int split;
  int blocks;         // blocks a row (tr_search: its cluster)
};

// torch.clamp(v, lower, upper) on CUDA: a NaN value, then a NaN bound,
// is returned as it is.
__device__ __forceinline__ float tr_clamp(float v, float lower,
                                          float upper) {
  if (v != v) return v;
  if (lower != lower) return lower;
  if (upper != upper) return upper;
  return fminf(fmaxf(v, lower), upper);
}

struct Inputs {
  float c, g, lower, upper, weight;
};

__device__ __forceinline__ float load_at(const float* v, int row_stride,
                                         int col_stride, int row, int j) {
  return __ldg(v + (long long)row * row_stride + (long long)j * col_stride);
}

__device__ __forceinline__ Inputs load_inputs(const TrustRegionArgs& p,
                                              int row, int j) {
  return {load_at(p.c, p.c_row_stride, p.c_col_stride, row, j),
          load_at(p.g, p.g_row_stride, p.g_col_stride, row, j),
          load_at(p.lower, p.lower_row_stride, p.lower_col_stride, row, j),
          load_at(p.upper, p.upper_row_stride, p.upper_col_stride, row, j),
          load_at(p.weight, p.weight_row_stride, p.weight_col_stride, row,
                  j)};
}

// The movement direction: 0 for a component at a bound that the
// objective pushes outward, else -g / w.
__device__ __forceinline__ float direction_of(const Inputs& v) {
  const bool frozen = (v.c >= v.upper && v.g <= 0.f) ||
                      (v.c <= v.lower && v.g >= 0.f);
  return frozen ? 0.f : __fdiv_rn(-v.g, v.weight);
}

// (tau, a) of one component: the knot, +0 where it does not move or
// would be below zero (NaN kept), and a = (w d) d. An infinite bound
// over a finite direction is the signed infinity that the division
// rounds to, given without it: the division's slow path for an infinite
// operand cost the prologue about a third of its time.
__device__ __forceinline__ float2 knot_of(const Inputs& v) {
  const float d = direction_of(v);
  float tau = 0.f;
  if (d > 0.f || d < 0.f) {
    const float gap = __fsub_rn(d > 0.f ? v.upper : v.lower, v.c);
    if (isinf(gap) && isfinite(d)) {
      tau = signbit(gap) != signbit(d) ? -INFINITY : INFINITY;
    } else {
      tau = __fdiv_rn(gap, d);
    }
  }
  if (tau <= 0.f) tau = 0.f;
  return make_float2(tau, __fmul_rn(__fmul_rn(v.weight, d), d));
}

// K values, the first SUMS added and the rest combined by max (all >= 0).
template <int K, int SUMS>
__device__ __forceinline__ void combine(double (&a)[K],
                                        const double (&b)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = k < SUMS ? a[k] + b[k] : fmax(a[k], b[k]);
}

// A shuffle tree inside the warp: lane 0 ends with the warp's values.
template <int K, int SUMS>
__device__ __forceinline__ void warp_tree(double (&v)[K]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    double o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = __shfl_down_sync(kTrMask, v[k], off);
    combine<K, SUMS>(v, o);
  }
}

// The block's values into `slot` (warp 0, lane 0 writes): a tree in each
// warp, then one over the warps' values. `warp_buf` holds K doubles a
// warp. Every thread must call this.
template <int K, int SUMS>
__device__ __forceinline__ void block_to_slot(double (&v)[K],
                                              double* warp_buf,
                                              double* slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_tree<K, SUMS>(v);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) warp_buf[warp * K + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
    double w[K];
    const bool live = lane < (int)(blockDim.x >> 5);
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = live ? warp_buf[lane * K + k] : 0.0;
    warp_tree<K, SUMS>(w);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) slot[k] = w[k];
    }
  }
}

// The block's slice of its row: [begin, end).
__device__ __forceinline__ void slice_of(const TrustRegionArgs& p,
                                         unsigned rank, int* begin,
                                         int* end) {
  const int per = (p.n + p.blocks - 1) / p.blocks;
  const long long b = (long long)rank * per;
  const long long e = b + per;
  *begin = (int)(b < p.n ? b : p.n);
  *end = (int)(e < p.n ? e : p.n);
}

// The bisection's test point in [lo, hi]: lo itself once the bracket
// holds one point or none.
__device__ __forceinline__ int test_point(int lo, int hi) {
  return lo + ((hi - lo + 1) >> 1);
}

// The test point of node `node` (1-based, heap order: node i's children
// 2i, the bracket below its point, and 2i + 1, the one from its point
// up) of the bisection's decision tree from [lo, hi].
__device__ __forceinline__ int node_point(int lo, int hi, int node) {
  for (int b = 30 - __clz(node); b >= 0; --b) {
    const int mid = test_point(lo, hi);
    if ((node >> b) & 1) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return test_point(lo, hi);
}

// One level of the warp's butterfly over v[0, 2 HALF): each lane sends
// the half it does not keep to the lane OFFSET away and adds that lane's
// to the half it keeps, so it holds HALF values after it.
template <int HALF, int OFFSET, int N>
__device__ __forceinline__ void halve(double (&v)[N]) {
  const bool upper = (threadIdx.x & OFFSET) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const double send = upper ? v[i] : v[i + HALF];
    const double keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(kTrMask, send, OFFSET);
  }
}

// The warp's sums of 16 values a lane, every value added in one fixed
// tree: lanes 2i and 2i + 1 both return the sum of value i.
__device__ __forceinline__ double warp_butterfly(double (&v)[16]) {
  halve<8, 16>(v);
  halve<4, 8>(v);
  halve<2, 4>(v);
  halve<1, 2>(v);
  v[0] += __shfl_xor_sync(kTrMask, v[0], 1);
  return v[0];
}

// The sum of v[0, N) (N a power of two) in a fixed pairwise tree: log2 N
// dependent adds where a running sum takes N.
template <int N>
__device__ __forceinline__ double tree_sum(double (&v)[N]) {
#pragma unroll
  for (int span = 1; span < N; span *= 2) {
#pragma unroll
    for (int i = 0; i < N; i += 2 * span) v[i] += v[i + span];
  }
  return v[0];
}

// The walk down a trip's decision tree from [*lo, *hi]: bit q of
// `answers` is whether node q + 1's test point lies below r^2. Leaves
// the new bracket in *lo, *hi and returns the last node (0-based) the
// walk went above, or -1.
__device__ __forceinline__ int walk_answers(unsigned answers, int* lo,
                                            int* hi) {
  int node = 1, last = -1;
#pragma unroll
  for (int level = 0; level < kSearchBits; ++level) {
    const int mid = test_point(*lo, *hi);
    const int up = (answers >> (node - 1)) & 1;
    if (up) {
      *lo = mid;
      last = node - 1;
    } else {
      *hi = mid - 1;
    }
    node = 2 * node + up;
  }
  return last;
}

// t* from the row's totals and S, H at the search's last lo (the plain
// version's t_star_from): 0 for a radius <= 0 or g = 0.
__device__ __forceinline__ float t_star_of(float r, float s_total,
                                           float h_infinite, float tau_max,
                                           bool moving, float s_lo,
                                           float h_lo) {
  const float r2 = __fmul_rn(r, r);
  const bool any_hit =
      __fadd_rn(s_total, __fmul_rn(__fmul_rn(tau_max, tau_max),
                                   h_infinite)) >= r2;
  float room = __fsub_rn(r2, s_lo);
  if (room < 0.f) room = 0.f;
  const float t_interior = sqrtf(__fdiv_rn(room, h_lo > 0.f ? h_lo : 1.f));
  float beyond = __fsub_rn(r2, s_total);
  if (beyond < 0.f) beyond = 0.f;
  const float t_beyond =
      h_infinite > 0.f ? sqrtf(__fdiv_rn(beyond, h_infinite)) : tau_max;
  const bool degenerate = r <= 0.f || !moving;
  return degenerate ? 0.f : (any_hit ? t_interior : t_beyond);
}

// A trip's decision, from warp 0 to its block: the new bracket and
// S, H at its lo.
struct TripDecision {
  int lo, hi;
  float s_lo, h_lo;
};

__global__ void __launch_bounds__(kSearchThreads)
tr_search_kernel(const TrustRegionArgs p) {
  constexpr int BITS = kSearchBits;
  constexpr int THREADS = kSearchThreads;
  constexpr int K = (1 << BITS) - 1;  // test points a trip
  constexpr int V = 2 * K;            // S, then H, of each
  constexpr int P = 16;               // a lane's values in the butterfly
  constexpr int W = THREADS / 32;
  constexpr int TRIPS = (kLevels + BITS - 1) / BITS;
  constexpr int UNROLL = 4;  // entries a round; a round's loads in flight
  static_assert(V <= P && P >= 6, "the sums and the six totals fit P");
  static_assert(W >= kMaxCluster, "a warp sends each block its sums");

  extern __shared__ float2 knots[];  // the slice's (tau, a)
  __shared__ double warp_buf[W * P];
  __shared__ double totals_slot[6];
  // What every block of the cluster sends this one: its totals, and a
  // trip's V sums (two trips' apart, so a block may send the next trip's
  // while this one still reads the last).
  __shared__ double totals_inbox[kMaxCluster][6];
  __shared__ double totals[6];  // the cluster's, from warp 0
  __shared__ double inbox[2][kMaxCluster][V];
  __shared__ float points[K];  // the next trip's test points, from warp 0
  __shared__ TripDecision decision;

  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int begin, end;
  slice_of(p, rank, &begin, &end);

  // The prologue: (tau, a) staged, and the row's totals: S over every
  // finite knot, H over the infinite (or NaN) ones, S and H at t = +0,
  // the largest finite knot, and whether any g^2 is not zero.
  double tot[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  Inputs next[UNROLL];  // the next round's, loaded a round ahead
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = begin + threadIdx.x + u * THREADS;
    if (j < end) next[u] = load_inputs(p, row, j);
  }
  for (int j0 = begin + threadIdx.x; j0 < end; j0 += UNROLL * THREADS) {
    Inputs in[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) in[u] = next[u];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + (UNROLL + u) * THREADS;
      if (j < end) next[u] = load_inputs(p, row, j);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * THREADS;
      if (j >= end) break;
      const float2 k = knot_of(in[u]);
      knots[j - begin] = k;
      const double clamped = (double)__fmul_rn(__fmul_rn(k.y, k.x), k.x);
      if (k.x < INFINITY) {
        tot[0] += clamped;
        tot[4] = fmax(tot[4], (double)k.x);
      } else {
        tot[1] += (double)k.y;
      }
      if (k.x <= 0.f) {
        tot[2] += clamped;
      } else {
        tot[3] += (double)k.y;
      }
      if (__fmul_rn(in[u].g, in[u].g) != 0.f) tot[5] = 1.0;
    }
  }
  // The block's totals (block_to_slot: in totals_slot, from lane 0 of
  // warp 0), sent to every block of the cluster by lanes 0-5; after the
  // barrier warp 0 combines the blocks' from its own inbox in one tree
  // and hands them to the block.
  block_to_slot<6, 4>(tot, warp_buf, totals_slot);
  const int blocks = (int)cl.num_blocks();
  if (warp == 0) {
    __syncwarp();
    if (lane < 6) {
      const double mine = totals_slot[lane];
      for (int b = 0; b < blocks; ++b) {
        cl.map_shared_rank(&totals_inbox[rank][0], b)[lane] = mine;
      }
    }
  }
  cl.sync();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      tot[k] = lane < blocks ? totals_inbox[lane][k] : 0.0;
    }
    warp_tree<6, 4>(tot);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) totals[k] = tot[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 6; ++k) tot[k] = totals[k];

  const float r = __ldg(p.radius + row);
  const float r2 = __fmul_rn(r, r);
  const float s_total = __double2float_rn(tot[0]);
  const float h_infinite = __double2float_rn(tot[1]);
  const float tau_max = (float)tot[4];  // an f32 value, exactly
  const bool moving = tot[5] != 0.0;

  // The trips. Every point still to come lies in [lo, hi + 1]: a staged
  // knot at or below lo is clamped for good and one above hi (or not
  // finite) never is, so each trip moves those into the thread's `base`
  // sums and keeps the rest, in order, in the thread's slots (slot k of
  // thread i at i + k * THREADS).
  int lo = 0, hi = __float_as_int(tau_max);
  float s_lo = __double2float_rn(tot[2]), h_lo = __double2float_rn(tot[3]);
  const int count = end - begin;
  int active = count > (int)threadIdx.x
                   ? (count - (int)threadIdx.x + THREADS - 1) / THREADS
                   : 0;
  double base[2] = {0.0, 0.0};
  for (int trip = 0; trip < TRIPS; ++trip) {
    float point[K];
    if (trip == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        point[k] = __int_as_float(node_point(lo, hi, k + 1));
      }
      if (warp == 0 && lane < K) {
        points[lane] = __int_as_float(node_point(lo, hi, lane + 1));
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) point[k] = points[k];
    }
    double part[P];  // S of point k at k, H at K + k; zeros past V
#pragma unroll
    for (int v = 0; v < P; ++v) part[v] = 0.0;
    const float lo_t = __int_as_float(lo), hi_t = __int_as_float(hi);
    int kept = 0;
    for (int k = 0; k < active; ++k) {
      const float2 e = knots[threadIdx.x + k * THREADS];
      const double clamped = (double)__fmul_rn(__fmul_rn(e.y, e.x), e.x);
      if (e.x <= lo_t) {
        base[0] += clamped;
      } else if (!(e.x <= hi_t)) {
        base[1] += (double)e.y;
      } else {
        knots[threadIdx.x + kept * THREADS] = e;
        ++kept;
        const double a = (double)e.y;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (e.x <= point[q]) {
            part[q] += clamped;
          } else {
            part[K + q] += a;
          }
        }
      }
    }
    active = kept;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      part[q] += base[0];
      part[K + q] += base[1];
    }
    // The block's sums: the warp's butterfly, then in warp b lane v adds
    // value v of every warp in one pairwise tree and sends the sum to
    // block b's inbox (every warp adds alike).
    const double mine = warp_butterfly(part);
    constexpr int SPREAD = 32 / P;  // lanes a value
    if (lane % SPREAD == 0) warp_buf[warp * P + lane / SPREAD] = mine;
    __syncthreads();
    if (warp < blocks && lane < V) {
      double of_warps[W];
#pragma unroll
      for (int w = 0; w < W; ++w) of_warps[w] = warp_buf[w * P + lane];
      cl.map_shared_rank(&inbox[trip & 1][rank][0], warp)[lane] =
          tree_sum(of_warps);
    }
    cl.sync();

    // Warp 0: lane q < K adds point q's S and H over the cluster's
    // blocks (its inbox, in one pairwise tree) and tests it; then every
    // lane walks the tree down the K answers, as the bisection would one
    // level at a time.
    if (warp == 0) {
      float s = 0.f, h = 0.f;
      bool below = false;
      if (lane < K) {
        double of_s[kMaxCluster], of_h[kMaxCluster];
#pragma unroll
        for (int b = 0; b < kMaxCluster; ++b) {
          of_s[b] = b < blocks ? inbox[trip & 1][b][lane] : 0.0;
          of_h[b] = b < blocks ? inbox[trip & 1][b][K + lane] : 0.0;
        }
        s = __double2float_rn(tree_sum(of_s));
        h = __double2float_rn(tree_sum(of_h));
        const float t = points[lane];
        below = __fadd_rn(s, __fmul_rn(__fmul_rn(t, t), h)) < r2;
      }
      int new_lo = lo, new_hi = hi;
      const int last =
          walk_answers(__ballot_sync(kTrMask, below), &new_lo, &new_hi);
      const float s_at = __shfl_sync(kTrMask, s, last < 0 ? 0 : last);
      const float h_at = __shfl_sync(kTrMask, h, last < 0 ? 0 : last);
      if (lane == 0) {
        decision.lo = new_lo;
        decision.hi = new_hi;
        decision.s_lo = last < 0 ? s_lo : s_at;
        decision.h_lo = last < 0 ? h_lo : h_at;
      }
      if (lane < K) {
        points[lane] = __int_as_float(node_point(new_lo, new_hi, lane + 1));
      }
    }
    __syncthreads();
    lo = decision.lo;
    hi = decision.hi;
    s_lo = decision.s_lo;
    h_lo = decision.h_lo;
  }

  if (rank == 0 && threadIdx.x == 0) {
    p.t_star[row] =
        t_star_of(r, s_total, h_infinite, tau_max, moving, s_lo, h_lo);
  }
  // No barrier here: blocks write into each other's inboxes only before
  // the last trip's barrier, and read their own.
}

// Entries 4q to 4q + 3 of one row of an input (`v` at the row's start,
// column stride `col`): one 16-byte load where `vec` (col 1 and `v` on a
// 16-byte boundary) and the slot is whole, else 4-byte loads of the
// entries below n.
__device__ __forceinline__ float4 row_slot(const float* v, int col,
                                           bool vec, int q, int n) {
  if (vec && 4 * q + 4 <= n) {
    return __ldg(reinterpret_cast<const float4*>(v) + q);
  }
  float e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * q + k;
    e[k] = j < n ? __ldg(v + (long long)j * col) : 0.f;
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ float entry_of(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ bool on_16_bytes(const void* v) {
  return (reinterpret_cast<size_t>(v) & 15) == 0;
}

// Grid (blocks, rows): block b of a row takes its run of the row's
// ceil(n / 4) slots; thread i the slots i, i + T, ... of the run,
// kSolutionSlots at a time, their loads issued first.
__global__ void __launch_bounds__(kSolutionThreads)
tr_solution_kernel(const TrustRegionArgs p) {
  constexpr int T = kSolutionThreads;
  constexpr int U = kSolutionSlots;
  constexpr int kInputs = 5;  // c, g, lower, upper, weight
  __shared__ double warp_buf[(T / 32) * 2];
  __shared__ double total_slot[2];
  __shared__ int last;

  const int row = blockIdx.y;
  const float t = __ldg(p.t_star + row);
  const float* in[kInputs] = {
      p.c + (long long)row * p.c_row_stride,
      p.g + (long long)row * p.g_row_stride,
      p.lower + (long long)row * p.lower_row_stride,
      p.upper + (long long)row * p.upper_row_stride,
      p.weight + (long long)row * p.weight_row_stride};
  const int col[kInputs] = {p.c_col_stride, p.g_col_stride,
                            p.lower_col_stride, p.upper_col_stride,
                            p.weight_col_stride};
  bool vec[kInputs];
#pragma unroll
  for (int i = 0; i < kInputs; ++i) {
    vec[i] = col[i] == 1 && on_16_bytes(in[i]);
  }
  float* out = p.solution + (long long)row * p.n;
  const bool out_vec = on_16_bytes(out);
  const int slots = (p.n + 3) >> 2;
  const int per = (slots + p.blocks - 1) / p.blocks;
  const int begin = blockIdx.x * per;
  const int end = begin + per < slots ? begin + per : slots;

  double part[2] = {0.0, 0.0};  // [0, split), [split, n)
  for (int q0 = begin + (int)threadIdx.x; q0 < end; q0 += U * T) {
    float4 v[U][kInputs];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (q0 + u * T < end) {
#pragma unroll
        for (int i = 0; i < kInputs; ++i) {
          v[u][i] = row_slot(in[i], col[i], vec[i], q0 + u * T, p.n);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * T;
      if (q >= end) break;
      float x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * q + k;
        const Inputs e = {entry_of(v[u][0], k), entry_of(v[u][1], k),
                          entry_of(v[u][2], k), entry_of(v[u][3], k),
                          entry_of(v[u][4], k)};
        const float d = direction_of(e);
        x[k] = tr_clamp(__fadd_rn(e.c, __fmul_rn(t, d)), e.lower, e.upper);
        if (j < p.n) {
          const double term = (double)__fmul_rn(e.g, __fsub_rn(x[k], e.c));
          if (j < p.split) {
            part[0] += term;
          } else {
            part[1] += term;
          }
        }
      }
      if (out_vec && 4 * q + 4 <= p.n) {
        reinterpret_cast<float4*>(out)[q] =
            make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * q + k < p.n) out[4 * q + k] = x[k];
        }
      }
    }
  }
  // The block's sums into its slot (thread 0 writes them); then the row's
  // last block adds the row's slots: thread i those of blocks i, i + T,
  // ... in order, then one tree over the threads.
  double* row_partials = p.partials + 2LL * row * p.blocks;
  block_to_slot<2, 2>(part, warp_buf, row_partials + 2 * blockIdx.x);
  if (!last_ticket(p.tickets + row, p.blocks, &last)) return;
  double total[2] = {0.0, 0.0};
  for (int b = threadIdx.x; b < p.blocks; b += T) {
    total[0] += __ldcg(row_partials + 2 * b);
    total[1] += __ldcg(row_partials + 2 * b + 1);
  }
  block_to_slot<2, 2>(total, warp_buf, total_slot);
  if (threadIdx.x == 0) {
    p.sums[3 * row] = __double2float_rn(total_slot[0]);
    p.sums[3 * row + 1] = __double2float_rn(total_slot[1]);
    p.sums[3 * row + 2] = __double2float_rn(total_slot[0] + total_slot[1]);
  }
}

// ---------------------------------------------------------------------------
// The whole-card path (a row too long for a cluster to stage): tr_knots,
// then kSearchTrips launches of tr_trip, each a grid of (blocks, rows).
// ---------------------------------------------------------------------------

constexpr int kSearchTrips = (kLevels + kSearchBits - 1) / kSearchBits;

// A row's search between the path's launches. Two copies a row: a trip
// reads copy trip & 1 and its last block writes the other.
struct SweepRow {
  double base_s;  // S of the knots no list holds: +0, folded at or below lo
  double base_h;  // H of the rest no list holds: not finite, folded above hi
  int lo;         // the bracket's bits
  int hi;
  float s_lo;     // S and H at lo
  float h_lo;
  float s_total;  // the prologue's totals
  float h_infinite;
  float tau_max;
  int moving;     // any g^2 not zero
};
static_assert(sizeof(SweepRow) <= kSweepRowDoubles * sizeof(double),
              "a SweepRow fits its doubles");

__device__ __forceinline__ SweepRow* sweep_row(const TrustRegionArgs& p,
                                               int row, int copy) {
  return reinterpret_cast<SweepRow*>(
      p.search + ((long long)copy * p.rows + row) * kSweepRowDoubles);
}

// The run of a row's ceil(n / 4) 16-byte slots that warp `warp` of block
// `block` owns, [*begin, *end): the row cut into `blocks` runs, each run
// into kSweepWarps. The warp's list lies at 4 x begin of its row's list.
__device__ __forceinline__ void warp_run(int n, int blocks, int block,
                                         int warp, int* begin, int* end) {
  const long long slots = ((long long)n + 3) >> 2;
  const long long per_block = (slots + blocks - 1) / blocks;
  const long long per_warp = (per_block + kSweepWarps - 1) / kSweepWarps;
  const long long run = (long long)block * per_block;
  const long long run_end = min(run + per_block, slots);
  const long long e = min(run + (warp + 1) * per_warp, run_end);
  *end = (int)e;
  *begin = (int)min(run + warp * per_warp, e);
}

__device__ __forceinline__ float2* warp_list(const TrustRegionArgs& p,
                                             int row, int begin) {
  const long long slots = ((long long)p.n + 3) >> 2;
  return reinterpret_cast<float2*>(p.knots) + (long long)row * 4 * slots +
         4LL * begin;
}

__device__ __forceinline__ int* warp_count(const TrustRegionArgs& p, int row,
                                           int block, int warp) {
  return p.counts + ((long long)row * p.blocks + block) * kSweepWarps + warp;
}

__device__ __forceinline__ double* block_slot(const TrustRegionArgs& p,
                                              int row, int block) {
  return p.partials + ((long long)row * p.blocks + block) * kSweepValues;
}

// The row's last block: value t / kSweepGroups (below `values`) of the
// row's blocks' slots, added (from SUMS on, combined by max) in one fixed
// order: thread t takes the blocks t % kSweepGroups, t % kSweepGroups +
// kSweepGroups, ... in block order, then the value's kSweepGroups
// threads (neighbouring lanes of one warp) a tree of xor shuffles. Each
// of them returns the value's total.
template <int SUMS>
__device__ __forceinline__ double row_total(const double* slots, int blocks,
                                            int values) {
  const int v = threadIdx.x / kSweepGroups, g = threadIdx.x % kSweepGroups;
  const bool sum = v < SUMS;
  double acc = 0.0;
  if (v < values) {
    for (int b = g; b < blocks; b += kSweepGroups) {
      const double x = __ldcg(slots + (long long)b * kSweepValues + v);
      acc = sum ? acc + x : fmax(acc, x);
    }
  }
#pragma unroll
  for (int off = kSweepGroups / 2; off > 0; off >>= 1) {
    const double o = __shfl_xor_sync(kTrMask, acc, off);
    acc = sum ? acc + o : fmax(acc, o);
  }
  return acc;
}

// The path's first launch: each warp takes its run of its row, a lane
// kSweepSlots slots at a time with their loads issued first (row_slot:
// 16-byte loads where an input allows them), works out (tau, a) of each
// entry (knot_of) and its part of the row's six totals, and writes its
// live knots (finite, > 0) to its list in column order, their count to
// its word: a +0 knot is clamped at every test point and one not finite
// never is, so only the live ones can ever lie in the bracket. The
// row's last block (an integer ticket) adds the blocks' totals and
// writes the row's first SweepRow: the bracket [0, bits(tau_max)], S and
// H at +0, and in the base sums the knots that no list holds.
__global__ void __launch_bounds__(kSweepThreads)
tr_knots_kernel(const TrustRegionArgs p) {
  constexpr int U = kSweepSlots;
  constexpr int kInputs = 5;  // c, g, lower, upper, weight
  __shared__ double warp_buf[kSweepWarps * 6];
  __shared__ double totals[6];
  __shared__ int last;

  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* in[kInputs] = {
      p.c + (long long)row * p.c_row_stride,
      p.g + (long long)row * p.g_row_stride,
      p.lower + (long long)row * p.lower_row_stride,
      p.upper + (long long)row * p.upper_row_stride,
      p.weight + (long long)row * p.weight_row_stride};
  const int col[kInputs] = {p.c_col_stride, p.g_col_stride,
                            p.lower_col_stride, p.upper_col_stride,
                            p.weight_col_stride};
  bool vec[kInputs];
#pragma unroll
  for (int i = 0; i < kInputs; ++i) {
    vec[i] = col[i] == 1 && on_16_bytes(in[i]);
  }
  int begin, end;
  warp_run(p.n, p.blocks, blockIdx.x, warp, &begin, &end);
  float2* list = warp_list(p, row, begin);

  // S over every finite knot, H over the others, S and H at t = +0, the
  // largest finite knot, and whether any g^2 is not zero
  double tot[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  int kept = 0;
  for (int q0 = begin; q0 < end; q0 += 32 * U) {
    float4 v[U][kInputs];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * 32 + lane;
      if (q < end) {
#pragma unroll
        for (int i = 0; i < kInputs; ++i) {
          v[u][i] = row_slot(in[i], col[i], vec[i], q, p.n);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * 32 + lane;
      float2 k[4];
      unsigned live = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k[e] = make_float2(0.f, 0.f);
        if (q >= end || 4 * q + e >= p.n) continue;
        const Inputs x = {entry_of(v[u][0], e), entry_of(v[u][1], e),
                          entry_of(v[u][2], e), entry_of(v[u][3], e),
                          entry_of(v[u][4], e)};
        k[e] = knot_of(x);
        const double clamped =
            (double)__fmul_rn(__fmul_rn(k[e].y, k[e].x), k[e].x);
        if (k[e].x < INFINITY) {
          tot[0] += clamped;
          tot[4] = fmax(tot[4], (double)k[e].x);
        } else {
          tot[1] += (double)k[e].y;
        }
        if (k[e].x <= 0.f) {
          tot[2] += clamped;
        } else {
          tot[3] += (double)k[e].y;
        }
        if (__fmul_rn(x.g, x.g) != 0.f) tot[5] = 1.0;
        if (k[e].x > 0.f && k[e].x < INFINITY) live |= 1u << e;
      }
      // the lane's place in the warp's list: an inclusive scan of the
      // lanes' live counts
      const int mine = __popc(live);
      int upto = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kTrMask, upto, off);
        if (lane >= off) upto += o;
      }
      int at = kept + upto - mine;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if ((live >> e) & 1) list[at++] = k[e];
      }
      kept += __shfl_sync(kTrMask, upto, 31);
    }
  }
  if (lane == 0) *warp_count(p, row, blockIdx.x, warp) = kept;

  block_to_slot<6, 4>(tot, warp_buf, block_slot(p, row, blockIdx.x));
  if (!last_ticket(p.tickets + row, p.blocks, &last)) return;
  const double total = row_total<4>(block_slot(p, row, 0), p.blocks, 6);
  if (threadIdx.x % kSweepGroups == 0 && threadIdx.x / kSweepGroups < 6) {
    totals[threadIdx.x / kSweepGroups] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    SweepRow first;
    first.base_s = totals[2];
    first.base_h = totals[1];
    first.lo = 0;
    first.hi = __float_as_int((float)totals[4]);
    first.s_lo = __double2float_rn(totals[2]);
    first.h_lo = __double2float_rn(totals[3]);
    first.s_total = __double2float_rn(totals[0]);
    first.h_infinite = __double2float_rn(totals[1]);
    first.tau_max = (float)totals[4];  // an f32 value, exactly
    first.moving = totals[5] != 0.0;
    *sweep_row(p, row, 0) = first;
  }
}

// One trip of the path: the K = 7 test points of the bisection's next
// kSearchBits levels from the row's bracket, as tr_search_kernel's trip.
// Each warp walks its list once: a knot at or below lo goes into the
// fold's S for good, one above hi into its H, and every other adds to
// each point's S or H and stays in the list, in order (compacted in
// place), so the lists shrink as the bracket closes. The warp's
// butterfly and a tree over the warps give the block's 2K + 2 sums, into
// its slot; the row's last block (an integer ticket) adds the slots
// (row_total) and the fold to the row's base sums, tests the K points,
// walks down their answers, writes the next SweepRow and, on the last
// trip, t*.
__global__ void __launch_bounds__(kSweepThreads)
tr_trip_kernel(const TrustRegionArgs p, int trip) {
  constexpr int K = (1 << kSearchBits) - 1;
  constexpr int E = kTripEntries;
  static_assert(2 * K + 2 == kSweepValues, "a slot: 2K sums and the fold");
  static_assert(kSweepWarps == 8, "tree_sum over the warps");
  __shared__ double warp_buf[kSweepWarps * kSweepValues];
  __shared__ double totals[kSweepValues];
  __shared__ int last;

  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const SweepRow now = *sweep_row(p, row, trip & 1);
  float point[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    point[k] = __int_as_float(node_point(now.lo, now.hi, k + 1));
  }
  const float lo_t = __int_as_float(now.lo), hi_t = __int_as_float(now.hi);
  int begin, end;
  warp_run(p.n, p.blocks, blockIdx.x, warp, &begin, &end);
  float2* list = warp_list(p, row, begin);
  int* count_word = warp_count(p, row, blockIdx.x, warp);
  const int count = *count_word;

  double part[kSweepValues];  // S of point k at k, H at K + k; the fold's
#pragma unroll
  for (int v = 0; v < kSweepValues; ++v) part[v] = 0.0;
  int kept = 0;
  for (int j0 = 0; j0 < count; j0 += 32 * E) {
    float2 e[E];
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const int j = j0 + u * 32 + lane;
      e[u] = j < count ? list[j] : make_float2(0.f, 0.f);
    }
    int at[E];
    bool keep[E];
#pragma unroll
    for (int u = 0; u < E; ++u) {
      keep[u] = false;
      if (j0 + u * 32 + lane < count) {
        const double clamped =
            (double)__fmul_rn(__fmul_rn(e[u].y, e[u].x), e[u].x);
        if (e[u].x <= lo_t) {
          part[2 * K] += clamped;
        } else if (!(e[u].x <= hi_t)) {
          part[2 * K + 1] += (double)e[u].y;
        } else {
          keep[u] = true;
          const double a = (double)e[u].y;
#pragma unroll
          for (int q = 0; q < K; ++q) {
            if (e[u].x <= point[q]) {
              part[q] += clamped;
            } else {
              part[K + q] += a;
            }
          }
        }
      }
      const unsigned keeping = __ballot_sync(kTrMask, keep[u]);
      at[u] = kept + __popc(keeping & ((1u << lane) - 1u));
      kept += __popc(keeping);
    }
    __syncwarp();  // every lane has read this round before any writes
#pragma unroll
    for (int u = 0; u < E; ++u) {
      if (keep[u] && at[u] != j0 + u * 32 + lane) list[at[u]] = e[u];
    }
  }
  if (lane == 0) *count_word = kept;

  const double mine = warp_butterfly(part);
  if ((lane & 1) == 0) warp_buf[warp * kSweepValues + lane / 2] = mine;
  __syncthreads();
  if (threadIdx.x < kSweepValues) {
    double of_warps[kSweepWarps];
#pragma unroll
    for (int w = 0; w < kSweepWarps; ++w) {
      of_warps[w] = warp_buf[w * kSweepValues + threadIdx.x];
    }
    block_slot(p, row, blockIdx.x)[threadIdx.x] = tree_sum(of_warps);
  }
  if (!last_ticket(p.tickets + row, p.blocks, &last)) return;
  const double total =
      row_total<kSweepValues>(block_slot(p, row, 0), p.blocks, kSweepValues);
  if (threadIdx.x % kSweepGroups == 0) {
    totals[threadIdx.x / kSweepGroups] = total;
  }
  __syncthreads();
  if (warp != 0) return;
  const double base_s = now.base_s + totals[2 * K];
  const double base_h = now.base_h + totals[2 * K + 1];
  const float r = __ldg(p.radius + row);
  float s = 0.f, h = 0.f;
  bool below = false;
  if (lane < K) {
    s = __double2float_rn(base_s + totals[lane]);
    h = __double2float_rn(base_h + totals[K + lane]);
    const float t = __int_as_float(node_point(now.lo, now.hi, lane + 1));
    below = __fadd_rn(s, __fmul_rn(__fmul_rn(t, t), h)) < __fmul_rn(r, r);
  }
  SweepRow next = now;
  const int at = walk_answers(__ballot_sync(kTrMask, below), &next.lo,
                              &next.hi);
  const float s_at = __shfl_sync(kTrMask, s, at < 0 ? 0 : at);
  const float h_at = __shfl_sync(kTrMask, h, at < 0 ? 0 : at);
  if (lane == 0) {
    next.base_s = base_s;
    next.base_h = base_h;
    if (at >= 0) {
      next.s_lo = s_at;
      next.h_lo = h_at;
    }
    *sweep_row(p, row, (trip + 1) & 1) = next;
    if (trip == kSearchTrips - 1) {
      p.t_star[row] = t_star_of(r, next.s_total, next.h_infinite,
                                next.tau_max, next.moving != 0, next.s_lo,
                                next.h_lo);
    }
  }
}

template <typename Kernel>
int launch_clusters(Kernel kernel, const TrustRegionArgs* a, int threads,
                    size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a->blocks, a->rows, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a->blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, *a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The attributes a launch of tr_search needs, set on every launch: each
// holds for the current device only.
inline cudaError_t search_attributes(int cluster, int smem_bytes) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tr_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return err;
  }
  if (cluster > kPortableCluster) {
    return cudaFuncSetAttribute(
        tr_search_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return cudaSuccess;
}

}  // namespace folp

// F2b on a cluster a row. `smem_bytes`: the staged slice's.
extern "C" int folp_tr_search(const folp::TrustRegionArgs* a, int smem_bytes,
                              void* stream_ptr) {
  using namespace folp;
  const cudaError_t err = search_attributes(a->blocks, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return launch_clusters(tr_search_kernel, a, kSearchThreads,
                         (size_t)smem_bytes, (cudaStream_t)stream_ptr);
}

// How many clusters of `cluster` tr_search blocks, each with `smem_bytes`
// of dynamic shared memory, the current device runs at once
// (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int folp_tr_search_clusters(int cluster, int smem_bytes,
                                       int* clusters) {
  using namespace folp;
  const cudaError_t err = search_attributes(cluster, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kSearchThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, tr_search_kernel,
                                             &cfg);
}

// How many tr_solution blocks an SM of the current device holds at once,
// into *blocks.
extern "C" int folp_tr_solution_occupancy(int* blocks) {
  using namespace folp;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, tr_solution_kernel, kSolutionThreads, 0);
}

// F2c: a grid of (blocks, rows) blocks; `partials` holds 2 rows x blocks
// doubles, `tickets` one zero int a row.
extern "C" int folp_tr_solution(const folp::TrustRegionArgs* a,
                                void* stream_ptr) {
  using namespace folp;
  if (a->blocks < 1) return (int)cudaErrorInvalidValue;
  tr_solution_kernel<<<dim3(a->blocks, a->rows, 1), kSolutionThreads, 0,
                       (cudaStream_t)stream_ptr>>>(*a);
  return (int)cudaGetLastError();
}

// The whole-card path of F2b: tr_knots, then `trips` launches of tr_trip
// (the search takes kSearchTrips; fewer leave t* unwritten), grids of
// (blocks, rows) on `stream`. `partials` holds kSweepValues doubles a
// block, `tickets` one zero int a row, `knots` 4 ceil(n / 4) float2 a
// row, `counts` kSweepWarps ints a block, `search` 2 rows x
// kSweepRowDoubles doubles.
extern "C" int folp_tr_sweep(const folp::TrustRegionArgs* a, int trips,
                             void* stream_ptr) {
  using namespace folp;
  if (a->blocks < 1 || trips < 0 || trips > kSearchTrips) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(a->blocks, a->rows, 1);
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  tr_knots_kernel<<<grid, kSweepThreads, 0, stream>>>(*a);
  cudaError_t err = cudaGetLastError();
  for (int trip = 0; trip < trips && err == cudaSuccess; ++trip) {
    tr_trip_kernel<<<grid, kSweepThreads, 0, stream>>>(*a, trip);
    err = cudaGetLastError();
  }
  return (int)err;
}

// How many blocks of the whole-card path's kernels an SM of the current
// device holds at once (the fewer of the two), into *blocks.
extern "C" int folp_tr_sweep_occupancy(int* blocks) {
  using namespace folp;
  int knots = 0, trip = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &knots, tr_knots_kernel, kSweepThreads, 0);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &trip, tr_trip_kernel, kSweepThreads, 0);
  }
  *blocks = knots < trip ? knots : trip;
  return (int)err;
}
