// trust_region_search: the f32 exact trust-region solve of the restart
// scheme,
//
//   argmin g'x  s.t.  l <= x <= u,  ||x - c||_w <= r,
//
// one problem a row, as two launches:
//
//   F2b tr_search (F2a, the prologue, fused into it): frozen components,
//     direction d = -g / w, the knots tau (where each component meets its
//     bound, +0 for one that does not move) and a = (w d) d, computed
//     once from c, g, l, u, w; the row's totals; the 31-trip bisection on
//     the float bits of t for the segment that holds r^2, where
//     r^2(t) = S(t) + t^2 H(t), S(t) = sum over tau <= t of (a tau) tau
//     and H(t) = sum of a over the rest; then t* on that segment, 0 for
//     a zero radius or g = 0;
//   F2c tr_solution: x = clamp(c + t* d, l, u) and the sums of
//     g (x - c) over the columns [0, split), [split, n) and all.
//
// Replaces XLA's fusion of the JAX package's trust region
// (firstorderlp_tpu/trust_region.py:42 solve_bound_constrained_trust_region
// and :112 _t_star_bisect, vmapped at :401): no pl.pallas_call. The plain
// versions and the contract are ops/trust_region_search.py's.
//
// Bits: every per-row sum is accumulated in f64 and rounded once to f32,
// in one fixed order: each thread its entries in column order, a shuffle
// tree in each warp, one over the warps, one over the blocks of the
// row's cluster. The terms of a sum are f32 values of one sign, so an
// order whose longest chain of additions is D gives an f64 result within
// D 2^-53 |S| of the exact sum S (here D is a thread's entries, at most
// ceil(n / (blocks x threads)), plus 15 levels of trees). Two orders
// round to different f32 values only where an f32 rounding midpoint lies
// between their f64 results; the midpoints lie at least 2^-24 |S| apart,
// so the odds are at most about (D1 + D2) 2^-29 a sum: about 2e-6 where
// D1 + D2 is 2^10. The kernels therefore give the plain versions'
// bits, bar a one-ulp difference at those odds that comes from the order
// of addition, not from a fault, and repeats at every run on that input.
// The elementwise work rounds each operation once in PyTorch's order
// (__fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn: never a contracted
// multiply-add), torch.clamp keeps its NaN rules, and a knot below zero
// (or -0) is +0.
//
// Design for Hopper: one thread-block cluster a row (cudaLaunchKernelEx,
// at most 8 blocks, the portable size). Each block takes a contiguous
// slice of the row. In tr_search it stages its slice's (tau, a) in shared
// memory once (8 bytes an entry: 200,008 bytes a block for 200,001
// entries over 8 blocks), or, for a row too long for that, works them out
// again from the inputs every trip. Every t a trip tries lies in the
// bracket (lo, hi] of the trips before it, so a staged knot at or below
// lo stays clamped and one above hi never is: each trip adds those to
// the thread's running sums and keeps only the bracket's knots, in
// order, so the passes shrink once the bracket is inside the knots'
// range. Every trip each block sums its slice
// in f64 and writes its partial to its own shared memory; after
// cluster.sync() every warp of every block reads the cluster's partials
// through distributed shared memory and adds them in the same tree, so
// every thread derives the same lo and hi with no device-memory round
// trip: the 31 trips and the final parts are one launch. The radius and
// every input are read from device memory, so nothing is read back and
// a CUDA graph bakes in only the shapes.
//
// Bound on an H100 SXM: bytes for F2c (c, g read and x written a row, l,
// u, w once: about 9.6 MB, 2.9 us, for 3 rows of 200,001 at 3.35 TB/s);
// F2b reads the same inputs but x (7.2 MB, 2.1 us) and then runs 32
// passes over shared memory with a cluster barrier each: its floor on
// the card is the trips' barriers and f64 adds, not its bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace folp {

constexpr unsigned kTrMask = 0xffffffffu;
constexpr int kTrips = 31;  // bisection trips on the bits of t

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
  int cluster;        // blocks a row
  int staged;         // 1: (tau, a) kept in shared memory
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
// would be below zero (NaN kept), and a = (w d) d.
__device__ __forceinline__ float2 knot_of(const Inputs& v) {
  const float d = direction_of(v);
  float tau = 0.f;
  if (d > 0.f) {
    tau = __fdiv_rn(__fsub_rn(v.upper, v.c), d);
  } else if (d < 0.f) {
    tau = __fdiv_rn(__fsub_rn(v.lower, v.c), d);
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

// After cluster.sync(): the cluster's values in every thread of the
// calling warp, the blocks' slots read through distributed shared
// memory (lane r reads rank r's) and combined in one tree.
template <int K, int SUMS>
__device__ __forceinline__ void cluster_values(double (&v)[K],
                                               double* slot,
                                               const cg::cluster_group& cl) {
  const unsigned lane = threadIdx.x & 31;
  double w[K];
  if (lane < cl.num_blocks()) {
    const double* remote = cl.map_shared_rank(slot, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = remote[k];
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = 0.0;
  }
  warp_tree<K, SUMS>(w);
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = __shfl_sync(kTrMask, w[k], 0);
}

// The block's slice of its row: [begin, end).
__device__ __forceinline__ void slice_of(const TrustRegionArgs& p,
                                         unsigned rank, int* begin,
                                         int* end) {
  const int per = (p.n + p.cluster - 1) / p.cluster;
  const long long b = (long long)rank * per;
  const long long e = b + per;
  *begin = (int)(b < p.n ? b : p.n);
  *end = (int)(e < p.n ? e : p.n);
}

__global__ void __launch_bounds__(1024)
tr_search_kernel(const TrustRegionArgs p) {
  extern __shared__ float2 knots[];  // the slice's (tau, a), when staged
  __shared__ double warp_buf[32 * 4];
  __shared__ double totals_slot[4];
  __shared__ double trip_slot[2][2];

  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const int row = blockIdx.y;
  int begin, end;
  slice_of(p, rank, &begin, &end);

  // The prologue: (tau, a) staged, and the row's totals: S over every
  // finite knot, H over the infinite (or NaN) ones, the largest finite
  // knot, and whether any g^2 is not zero.
  double tot[4] = {0.0, 0.0, 0.0, 0.0};
  for (int j = begin + threadIdx.x; j < end; j += blockDim.x) {
    const Inputs in = load_inputs(p, row, j);
    const float2 k = knot_of(in);
    if (p.staged) knots[j - begin] = k;
    if (k.x < INFINITY) {
      tot[0] += (double)__fmul_rn(__fmul_rn(k.y, k.x), k.x);
      tot[2] = fmax(tot[2], (double)k.x);
    } else {
      tot[1] += (double)k.y;
    }
    if (__fmul_rn(in.g, in.g) != 0.f) tot[3] = 1.0;
  }
  block_to_slot<4, 2>(tot, warp_buf, totals_slot);
  cl.sync();
  cluster_values<4, 2>(tot, totals_slot, cl);

  const float r = __ldg(p.radius + row);
  const float r2 = __fmul_rn(r, r);
  const float s_total = __double2float_rn(tot[0]);
  const float h_infinite = __double2float_rn(tot[1]);
  const float tau_max = (float)tot[2];  // an f32 value, exactly
  const bool moving = tot[3] != 0.0;

  // 31 trips on the bits of t, then the parts at the last t below r^2.
  // Every t still to come lies in (lo, hi]: a staged knot at or below
  // lo is clamped for good and one above hi (or not finite) never is, so
  // each trip moves those into the thread's `base` sums and keeps the
  // rest, in order, in the thread's slots (slot k of thread i at
  // i + k * blockDim.x). Rows read from device memory every trip take
  // every entry every trip.
  int lo = 0, hi = __float_as_int(tau_max);
  float low_before = 0.f, high_before = 0.f;
  const int count = end - begin;
  int active = count > (int)threadIdx.x
                   ? (count - (int)threadIdx.x + blockDim.x - 1) / blockDim.x
                   : 0;
  double base[2] = {0.0, 0.0};
  for (int trip = 0; trip <= kTrips; ++trip) {
    const int mid = lo + ((hi - lo + 1) >> 1);
    const float t = __int_as_float(trip < kTrips ? mid : lo);
    double part[2] = {0.0, 0.0};
    if (p.staged) {
      const float lo_t = __int_as_float(lo), hi_t = __int_as_float(hi);
      int kept = 0;
      for (int k = 0; k < active; ++k) {
        const float2 e = knots[threadIdx.x + k * blockDim.x];
        const double clamped = (double)__fmul_rn(__fmul_rn(e.y, e.x), e.x);
        if (e.x <= lo_t) {
          base[0] += clamped;
        } else if (!(e.x <= hi_t)) {
          base[1] += (double)e.y;
        } else {
          knots[threadIdx.x + kept * blockDim.x] = e;
          ++kept;
          if (e.x <= t) {
            part[0] += clamped;
          } else {
            part[1] += (double)e.y;
          }
        }
      }
      active = kept;
      part[0] += base[0];
      part[1] += base[1];
    } else {
      for (int j = begin + threadIdx.x; j < end; j += blockDim.x) {
        const float2 k = knot_of(load_inputs(p, row, j));
        if (k.x <= t) {
          part[0] += (double)__fmul_rn(__fmul_rn(k.y, k.x), k.x);
        } else {
          part[1] += (double)k.y;
        }
      }
    }
    double* slot = trip_slot[trip & 1];
    block_to_slot<2, 2>(part, warp_buf, slot);
    cl.sync();
    cluster_values<2, 2>(part, slot, cl);
    const float s = __double2float_rn(part[0]);
    const float h = __double2float_rn(part[1]);
    if (trip < kTrips) {
      const bool below = __fadd_rn(s, __fmul_rn(__fmul_rn(t, t), h)) < r2;
      if (below) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    } else {
      low_before = s;
      high_before = h;
    }
  }

  if (rank == 0 && threadIdx.x == 0) {
    const bool any_hit =
        __fadd_rn(s_total, __fmul_rn(__fmul_rn(tau_max, tau_max),
                                     h_infinite)) >= r2;
    float room = __fsub_rn(r2, low_before);
    if (room < 0.f) room = 0.f;
    const float t_interior = sqrtf(
        __fdiv_rn(room, high_before > 0.f ? high_before : 1.f));
    float beyond = __fsub_rn(r2, s_total);
    if (beyond < 0.f) beyond = 0.f;
    const float t_beyond =
        h_infinite > 0.f ? sqrtf(__fdiv_rn(beyond, h_infinite)) : tau_max;
    const bool degenerate = r <= 0.f || !moving;
    p.t_star[row] = degenerate ? 0.f : (any_hit ? t_interior : t_beyond);
  }
  cl.sync();  // no block leaves while another may read its slots
}

__global__ void __launch_bounds__(512)
tr_solution_kernel(const TrustRegionArgs p) {
  __shared__ double warp_buf[32 * 2];
  __shared__ double slot[2];

  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const int row = blockIdx.y;
  int begin, end;
  slice_of(p, rank, &begin, &end);
  const float t = __ldg(p.t_star + row);
  const long long base = (long long)row * p.n;

  double part[2] = {0.0, 0.0};  // [0, split), [split, n)
  for (int j = begin + threadIdx.x; j < end; j += blockDim.x) {
    const Inputs in = load_inputs(p, row, j);
    const float d = direction_of(in);
    const float x =
        tr_clamp(__fadd_rn(in.c, __fmul_rn(t, d)), in.lower, in.upper);
    p.solution[base + j] = x;
    const double term = (double)__fmul_rn(in.g, __fsub_rn(x, in.c));
    if (j < p.split) {
      part[0] += term;
    } else {
      part[1] += term;
    }
  }
  block_to_slot<2, 2>(part, warp_buf, slot);
  cl.sync();
  if (rank == 0 && threadIdx.x < 32) {
    cluster_values<2, 2>(part, slot, cl);
    if (threadIdx.x == 0) {
      p.sums[3 * row] = __double2float_rn(part[0]);
      p.sums[3 * row + 1] = __double2float_rn(part[1]);
      p.sums[3 * row + 2] = __double2float_rn(part[0] + part[1]);
    }
  }
  cl.sync();  // no block leaves while rank 0 may read its slot
}

constexpr int kSearchThreads = 1024;
constexpr int kSolutionThreads = 512;

template <typename Kernel>
int launch_clusters(Kernel kernel, const TrustRegionArgs* a, int threads,
                    size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a->cluster, a->rows, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a->cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, *a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace folp

// F2b. `smem_bytes`: the staged slice's, 0 when not staged.
extern "C" int folp_tr_search(const folp::TrustRegionArgs* a, int smem_bytes,
                              void* stream_ptr) {
  using namespace folp;
  // Set on every launch: the attribute holds for the current device only.
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tr_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return launch_clusters(tr_search_kernel, a, kSearchThreads,
                         (size_t)smem_bytes, (cudaStream_t)stream_ptr);
}

// F2c.
extern "C" int folp_tr_solution(const folp::TrustRegionArgs* a,
                                void* stream_ptr) {
  using namespace folp;
  return launch_clusters(tr_solution_kernel, a, kSolutionThreads, 0,
                         (cudaStream_t)stream_ptr);
}
