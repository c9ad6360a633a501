// lanes_spmv (L1): y = A x for a fleet of B matrices that share one
// sparsity pattern, in f32 or f64:
//
//   y[r * B + b] = sum over entries k of row r of vals[k * B + b] *
//                  x[cols[k] * B + b]
//
// vals (nnz, B), x (cols, B) and y (rows, B), row-major and contiguous in
// B (the JAX package's minor batch axis). One launch serves A (A's CSR
// and values) or A' (the transposed CSR and the values in its order).
//
// Replaces, on the fleet path (ops/lanes.py, batch.py), the JAX
// package's shared-pattern product: XLA gathers of (1, B) rows over ELL
// planes under vmap (firstorderlp_tpu/ops/linops.py:68-129 and
// batch.py:130-181 there). No Pallas kernel computes it, and PyTorch has
// no one op for "one pattern, other values per lane"; the plain form
// (gather, then index_add_ over rows) sums with floating-point atomics on
// CUDA, which the port's determinism does not allow.
//
// Bound on an H100 SXM: bytes. A call must read the value plane
// (nnz B s), the indices and row pointers (4 nnz + 4 (rows + 1)), x
// (cols B s) and write y (rows B s): at the 128-lane 20,000-node PageRank
// fleet in f32 about 103 MB, 0.031 ms at 3.35 TB/s, against 2 nnz B
// flops (41 MFLOP, 0.0006 ms at 67 TFLOP/s). The x gather reads another
// nnz B s bytes (82 MB there) that should come from the L2 cache.
//
// What held the first version back, measured on the card (PERF.md, one
// change at a time): the value plane (82 MB) streaming through the 50 MB
// L2 that should hold x (read with a streaming hint: 14-18% faster),
// and the x gathers that missed (all gathers on one row: 8-12% faster).
// Loads waiting on their index were not the limit (the item's indices
// staged in shared memory first: 16-22% slower), nor was a ragged last
// wave (one persistent wave: 10-21% slower); a ring of shared-memory
// stages filled by cp.async, 1-13 blocks an SM, was 14-103% slower.
// Design:
// - one block of four warps per work item of routed.csr_work_items (a
//   run of short rows, or a long row or one piece of a row cut into
//   pieces); the hardware hands out the short blocks as SMs free up;
// - warp w takes the item's rows w, w + 4, ... (a piece: one row), and
//   walks a row's entries: its indices 32 at a time in one load (a lane
//   each, passed on by shuffles), then U entries' values and x rows in
//   flight at once (U in 4, 8, 16), so no load waits on the one before;
// - 16-byte lanes: a thread takes V = 16 / s lanes (float4, double2)
//   when B s is a multiple of 16 and the planes and vectors are 16-byte
//   aligned (the wrapper checks), else V = 1 (the scalar variant, a
//   template parameter of the same kernel); a warp spans a slab of 32 V
//   lanes (one entry's 512 bytes at B = 128 in f32), wider B is walked
//   slab by slab;
// - the value plane, read once, is loaded with an L2 evict-first policy
//   (and not kept in L1), the x rows with evict-last, so the values
//   stream past the x rows that the gathers read again;
// - the same sums as the first version: each lane of a row is summed by
//   one thread, in entry order, from zero. A row cut into pieces: each
//   piece's block writes its partial sums to `scratch` (slot = item
//   number) and draws an integer ticket from the counter of the row's
//   first item; the block that draws the last one adds the pieces in
//   piece order (fixed_order.cuh), a lane a thread with many loads in
//   flight, writes y and sets the counter back to zero.
// No floating-point atomics: two launches on the same inputs give the
// same bits, and the tickets are zero between launches. The scratch and
// the tickets belong to the pattern, so its products run on one stream,
// one after the other.
//
// The fleet's lane trial (ops/lanes_step.py) runs two more variants of
// the same kernel, an epilogue on each row's complete sums as a template
// parameter (the plain product's only stores them, so its bits and its
// walk are as above): L1 on A with the dual step (folp_lanes_dual_step:
// y+ written in place of A z, which never reaches memory) and L1' on A'
// with the step-control sums (folp_lanes_rmv_stats: A'y+, then each
// lane's verdict). Their per-lane sums, sum (y+ - y)^2, sum dx (A'y+ -
// A'y) and sum dx^2, are added in f64 in a fixed order (add_up_terms)
// and rounded once; the verdict is F1b's (pdhg_step.cu) lane by lane.
// Bound: the product's bytes plus the epilogue's planes (y and b in, y+
// out; x+, x and A'y in), about 0.18 and 0.20 ms at 100,000 x 128 in
// f32.

#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_order.cuh"
#include "torch_ops.cuh"

namespace folp {

constexpr int kLaneThreads = 128;
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr int kSumUnroll = 16;  // pieces loaded at once in a row's sum

// A half's constant launch arguments (ops/lanes.py _LanesArgs), built
// once per pattern half, lane count, dtype and variant.
struct LanesArgs {
  const int* indptr;
  const int* indices;
  const int* items;  // (nitems + 1, 4) routed.csr_work_items
  void* scratch;     // nitems * lanes values: the pieces' partial sums
  int* tickets;      // nitems + 1 counters, zero between launches
  int nitems;
  int lanes;
  int elem_bytes;    // 4 or 8
  int vec;           // lanes a thread: 1, or up to 16 / elem_bytes
  int unroll;        // entries a warp loads at once: 4, 8 or 16
};

// A thread's V lanes.
template <typename T, int V>
struct alignas(sizeof(T) * V) Lanes {
  T v[V];
};

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
      : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
      : "=l"(policy));
  return policy;
}

// V lanes from read-only global memory under an L2 cache policy; STREAM:
// not kept in L1 either.
template <typename T, int V, bool STREAM>
__device__ __forceinline__ Lanes<T, V> load_lanes(const T* p,
                                                  uint64_t policy);

// Both load_lanes of Lanes<T, V>: OPERANDS is the PTX type and operands,
// the rest the outputs' constraints.
#define FOLP_LOAD_LANES(T, V, OPERANDS, ...)                          \
  template <>                                                         \
  __device__ __forceinline__ Lanes<T, V> load_lanes<T, V, true>(      \
      const T* p, uint64_t policy) {                                  \
    Lanes<T, V> o;                                                    \
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint" OPERANDS        \
        : __VA_ARGS__ : "l"(p), "l"(policy));                         \
    return o;                                                         \
  }                                                                   \
  template <>                                                         \
  __device__ __forceinline__ Lanes<T, V> load_lanes<T, V, false>(     \
      const T* p, uint64_t policy) {                                  \
    Lanes<T, V> o;                                                    \
    asm("ld.global.nc.L2::cache_hint" OPERANDS                        \
        : __VA_ARGS__ : "l"(p), "l"(policy));                         \
    return o;                                                         \
  }

FOLP_LOAD_LANES(float, 4, ".v4.f32 {%0, %1, %2, %3}, [%4], %5;",
                "=f"(o.v[0]), "=f"(o.v[1]), "=f"(o.v[2]), "=f"(o.v[3]))
FOLP_LOAD_LANES(float, 2, ".v2.f32 {%0, %1}, [%2], %3;", "=f"(o.v[0]),
                "=f"(o.v[1]))
FOLP_LOAD_LANES(float, 1, ".f32 %0, [%1], %2;", "=f"(o.v[0]))
FOLP_LOAD_LANES(double, 2, ".v2.f64 {%0, %1}, [%2], %3;", "=d"(o.v[0]),
                "=d"(o.v[1]))
FOLP_LOAD_LANES(double, 1, ".f64 %0, [%1], %2;", "=d"(o.v[0]))
#undef FOLP_LOAD_LANES

template <typename T, int V>
__device__ __forceinline__ void store_lanes(T* p, const Lanes<T, V>& a) {
  *reinterpret_cast<Lanes<T, V>*>(p) = a;
}

// The sum of one lane slab of one row over entries [s0, s1), in entry
// order from zero, U entries' loads in flight at a time.
template <typename T, int V, int U>
__device__ __forceinline__ Lanes<T, V> row_sum(
    const int* __restrict__ indices, const T* __restrict__ vals,
    const T* __restrict__ x, size_t nl, int s0, int s1, int l0, bool mine,
    int lane, uint64_t stream_policy, uint64_t keep_policy) {
  Lanes<T, V> acc;
#pragma unroll
  for (int k = 0; k < V; ++k) acc.v[k] = T(0);
  for (int w0 = s0; w0 < s1; w0 += 32) {
    const int n = min(32, s1 - w0);
    const int col = lane < n ? __ldg(indices + w0 + lane) : 0;
    for (int j = 0; j < n; j += U) {
      Lanes<T, V> v[U], w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = __shfl_sync(kFullMask, col, (j + u) & 31);
        if (mine && j + u < n) {
          v[u] = load_lanes<T, V, true>(vals + (size_t)(w0 + j + u) * nl + l0,
                                        stream_policy);
          w[u] = load_lanes<T, V, false>(x + (size_t)c * nl + l0,
                                         keep_policy);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (mine && j + u < n) {
#pragma unroll
          for (int k = 0; k < V; ++k) acc.v[k] += v[u].v[k] * w[u].v[k];
        }
      }
    }
  }
  return acc;
}

// What a launch does with each output row's complete sums (a template
// parameter of lanes_item_kernel). The plain product (L1) stores them;
// the lane trial's two products (ops/lanes_step.py) run an epilogue on
// them and add per-lane terms: kParts of them a lane, each summed in
// f64 (below).
template <typename T>
struct PlainProduct {
  static constexpr int kParts = 0;
  T* y;
  template <int V>
  struct In {};
  template <int V>
  __device__ In<V> load(int, size_t, int) const {
    return {};
  }
  template <int V>
  __device__ void rows(int row, size_t nl, int l0, const Lanes<T, V>& acc,
                       const In<V>&, double*) const {
    store_lanes<T, V>(y + (size_t)row * nl + l0, acc);
  }
  __device__ void lane(int row, size_t nl, int b, T sum, float*) const {
    y[(size_t)row * nl + b] = sum;
  }
};

// The lane trial's arguments for either product (ops/lanes_step.py
// _LaneStepArgs), f32: the dual step reads y, b, is_eq, step and
// weight; the step control x+, x, A'y, dy2, active, total, step and
// weight. A lane's scalars are (B,) vectors.
struct LaneStepArgs {
  const float* y;
  const float* b;
  const bool* is_eq;  // is_eq[r * eq_row + l * eq_lane]
  const float* x_next;
  const float* x;
  const float* aty;
  const float* dy2;  // (B,): the dual step's sum of (y+ - y)^2
  const bool* active;
  const long long* total;
  const float* step;
  const float* weight;
  float* out;             // y+ (the dual step) or A'y+ (the step control)
  double* partials;       // (nitems, parts, B): an item's terms
  double* group_partials; // (groups, parts, B)
  int* group_tickets;     // groups + 1 counters, zero between launches
  float* sums;            // (parts, B), each rounded once from f64
  bool* take;             // (B,): active and accepted
  float* new_step;        // (B,)
  bool* new_error;        // (B,)
  float shrink_exponent;  // -reduction_exponent, as f32
  float grow_exponent;    // -growth_exponent, as f32
  int shrink_route;
  int grow_route;
  int eq_row;
  int eq_lane;
  int groups;
};

constexpr int kGroupItems = 64;  // items whose terms a group adds up

// L1 on A at z = 2 x+ - x with the dual step: y+ = proj(y + sigma (b -
// A z)), sigma = weight step, proj: >= 0 off the equality rows; the term
// (y+ - y)^2 a lane. The eager trial's operations, rounding for
// rounding (batch._pdhg_trial_point).
struct DualStepRows {
  static constexpr int kParts = 1;
  LaneStepArgs a;
  template <int V>
  struct In {
    Lanes<float, V> y, b;
  };
  template <int V>
  __device__ In<V> load(int row, size_t nl, int l0) const {
    const size_t at = (size_t)row * nl + l0;
    return {*reinterpret_cast<const Lanes<float, V>*>(a.y + at),
            *reinterpret_cast<const Lanes<float, V>*>(a.b + at)};
  }
  __device__ float entry(int row, int l, float ax, float y, float b,
                         float* term) const {
    const float sigma = __fmul_rn(__ldg(a.weight + l), __ldg(a.step + l));
    const float cand = __fadd_rn(y, __fmul_rn(sigma, __fsub_rn(b, ax)));
    const float yn =
        a.is_eq[(size_t)row * a.eq_row + (size_t)l * a.eq_lane]
            ? cand
            : torch_clamp_min0(cand);
    const float dy = __fsub_rn(yn, y);
    *term = __fmul_rn(dy, dy);
    return yn;
  }
  template <int V>
  __device__ void rows(int row, size_t nl, int l0, const Lanes<float, V>& acc,
                       const In<V>& in, double* wsum) const {
    Lanes<float, V> yn;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float term;
      yn.v[k] = entry(row, l0 + k, acc.v[k], in.y.v[k], in.b.v[k], &term);
      wsum[l0 + k] += (double)term;
    }
    store_lanes<float, V>(a.out + (size_t)row * nl + l0, yn);
  }
  __device__ void lane(int row, size_t nl, int l, float sum,
                       float* term) const {
    const size_t at = (size_t)row * nl + l;
    a.out[at] = entry(row, l, sum, a.y[at], a.b[at], term);
  }
  // the last block: each lane's total, rounded once
  __device__ void finish(int lanes, int p, const double* g) const {
    for (int l = threadIdx.x; l < lanes; l += kLaneThreads) {
      double v = 0.0;
#pragma unroll 8
      for (int j = 0; j < a.groups; ++j) v += __ldcg(g + (size_t)j * p + l);
      a.sums[l] = (float)v;
    }
  }
};

// L1 on A' at y+: A'y+, the terms dx (A'y+ - A'y) and dx^2 a lane (dx =
// x+ - x), and in the last block each lane's verdict: movement,
// interaction, the numerical-error flag, the accept test and the new step
// size (batch.pdhg_lane_step, rounding for rounding, from the sums
// rounded once).
struct StepControlRows {
  static constexpr int kParts = 2;
  LaneStepArgs a;
  template <int V>
  struct In {
    Lanes<float, V> xn, x, aty;
  };
  template <int V>
  __device__ In<V> load(int row, size_t nl, int l0) const {
    const size_t at = (size_t)row * nl + l0;
    return {*reinterpret_cast<const Lanes<float, V>*>(a.x_next + at),
            *reinterpret_cast<const Lanes<float, V>*>(a.x + at),
            *reinterpret_cast<const Lanes<float, V>*>(a.aty + at)};
  }
  __device__ void terms(float aty_next, float xn, float x, float aty,
                        float* term) const {
    const float dx = __fsub_rn(xn, x);
    term[0] = __fmul_rn(dx, __fsub_rn(aty_next, aty));
    term[1] = __fmul_rn(dx, dx);
  }
  template <int V>
  __device__ void rows(int row, size_t nl, int l0, const Lanes<float, V>& acc,
                       const In<V>& in, double* wsum) const {
    store_lanes<float, V>(a.out + (size_t)row * nl + l0, acc);
    const int lanes = (int)nl;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float term[2];
      terms(acc.v[k], in.xn.v[k], in.x.v[k], in.aty.v[k], term);
      wsum[l0 + k] += (double)term[0];
      wsum[lanes + l0 + k] += (double)term[1];
    }
  }
  __device__ void lane(int row, size_t nl, int l, float sum,
                       float* term) const {
    const size_t at = (size_t)row * nl + l;
    a.out[at] = sum;
    terms(sum, a.x_next[at], a.x[at], a.aty[at], term);
  }
  __device__ void finish(int lanes, int p, const double* g) const {
    for (int l = threadIdx.x; l < lanes; l += kLaneThreads) {
      double v0 = 0.0, v1 = 0.0;
#pragma unroll 8
      for (int j = 0; j < a.groups; ++j) {
        v0 += __ldcg(g + (size_t)j * p + l);
        v1 += __ldcg(g + (size_t)j * p + lanes + l);
      }
      const float interaction_sum = (float)v0, dx2 = (float)v1;
      a.sums[l] = interaction_sum;
      a.sums[lanes + l] = dx2;
      const float step = a.step[l], weight = a.weight[l], dy2 = a.dy2[l];
      const float interaction = fabsf(interaction_sum);
      const float movement =
          __fadd_rn(__fmul_rn(__fmul_rn(0.5f, weight), dx2),
                    __fmul_rn(__fmul_rn(__fdiv_rn(1.f, weight), 0.5f), dy2));
      const bool error = movement == 0.f;
      const float limit =
          interaction > 0.f ? __fdiv_rn(movement, interaction) : INFINITY;
      const bool accept = step <= limit && !error;
      const float t1 = __fadd_rn(__ll2float_rn(a.total[l] + 1), 1.f);
      const float shrink =
          __fsub_rn(1.f, torch_pow(t1, a.shrink_exponent, a.shrink_route));
      const float grow =
          __fadd_rn(torch_pow(t1, a.grow_exponent, a.grow_route), 1.f);
      a.new_step[l] = error ? step
                            : torch_minimum(__fmul_rn(shrink, limit),
                                            __fmul_rn(grow, step));
      a.new_error[l] = error;
      a.take[l] = a.active[l] && accept;
    }
  }
};

// The trial's sums of the epilogue's terms, in one fixed order without
// floating-point atomics. Each item's block adds its rows' terms, a warp
// its own rows in row order and the warps in warp order, in f64 into
// `partials` (slot = item; a row cut into pieces: its terms in its first
// item's slot, whichever block finished it, and 0 in its other pieces').
// Items are counted off in groups of kGroupItems behind one integer
// ticket each, drawn once a slot (the block that writes a slot draws its
// group's ticket after the write); the last drawer adds the group's
// slots in item order into `group_partials` and draws the launch's
// ticket; the last of those adds the groups in order and runs `finish`.
template <class Ep>
__device__ void add_up_terms(const LanesArgs& a, const Ep& ep, int4 item,
                             bool finishes, const double* wsum, int* flag) {
  constexpr int K = Ep::kParts;
  const int p = K * a.lanes;
  double* parts = ep.a.partials;
  int slot[2] = {-1, -1};
  if (item.w <= 1) {
    __syncthreads();  // every warp's sums are in
    for (int i = threadIdx.x; i < p; i += kLaneThreads) {
      double v = 0.0;
#pragma unroll
      for (int w = 0; w < kLaneWarps; ++w) v += wsum[w * p + i];
      __stcg(parts + (size_t)blockIdx.x * p + i, v);
    }
    slot[0] = blockIdx.x;
  } else {
    if (item.z != 0) {
      for (int i = threadIdx.x; i < p; i += kLaneThreads) {
        __stcg(parts + (size_t)blockIdx.x * p + i, 0.0);
      }
      slot[0] = blockIdx.x;
    }
    if (finishes) slot[1] = blockIdx.x - item.z;
  }
  for (int k = 0; k < 2; ++k) {
    if (slot[k] < 0) continue;
    const int g = slot[k] / kGroupItems;
    const int s0 = g * kGroupItems;
    const int count = min(kGroupItems, a.nitems - s0);
    if (!last_ticket(ep.a.group_tickets + g, count, flag)) continue;
    for (int i = threadIdx.x; i < p; i += kLaneThreads) {
      double v = 0.0;
#pragma unroll 8
      for (int j = 0; j < count; ++j) {
        v += __ldcg(parts + (size_t)(s0 + j) * p + i);
      }
      __stcg(ep.a.group_partials + (size_t)g * p + i, v);
    }
    if (last_ticket(ep.a.group_tickets + ep.a.groups, ep.a.groups, flag)) {
      ep.finish(a.lanes, p, ep.a.group_partials);
    }
  }
}

template <typename T, int V, int U, class Ep>
__global__ void __launch_bounds__(kLaneThreads)
    lanes_item_kernel(LanesArgs a, const T* __restrict__ vals,
                      const T* __restrict__ x, Ep ep) {
  __shared__ int flag;
  // the epilogue's sums, (warps, parts, B) doubles: each (warp, lane)
  // belongs to one thread of the warp
  extern __shared__ double wsum[];
  constexpr int kParts = Ep::kParts;
  const int4 item = reinterpret_cast<const int4*>(a.items)[blockIdx.x];
  const int4 next = reinterpret_cast<const int4*>(a.items)[blockIdx.x + 1];
  const size_t nl = (size_t)a.lanes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slab_w = 32 * V;  // lanes a slab: one warp's
  const int slabs = (a.lanes + slab_w - 1) / slab_w;
  const bool piece = item.w != 0;
  const int nseg = piece ? 1 : next.y - item.y;
  const uint64_t stream_policy = evict_first_policy();
  const uint64_t keep_policy = evict_last_policy();
  T* scratch = static_cast<T*>(a.scratch);
  if constexpr (kParts > 0) {
    for (int i = threadIdx.x; i < kLaneWarps * kParts * a.lanes;
         i += kLaneThreads) {
      wsum[i] = 0.0;
    }
    __syncthreads();
  }

  // warp w: the (row, slab) units w, w + 4, ... of the item
  for (int unit = warp; unit < nseg * slabs; unit += kLaneWarps) {
    const int s = unit / slabs;
    const int l0 = (unit - s * slabs) * slab_w + lane * V;
    const bool mine = l0 < a.lanes;
    const int s0 = piece ? item.x : __ldg(a.indptr + item.y + s);
    const int s1 = piece ? next.x : __ldg(a.indptr + item.y + s + 1);
    typename Ep::template In<V> in{};
    if (kParts > 0 && mine && item.w <= 1) {
      in = ep.template load<V>(item.y + s, nl, l0);
    }
    const Lanes<T, V> acc =
        row_sum<T, V, U>(a.indices, vals, x, nl, s0, s1, l0, mine, lane,
                         stream_policy, keep_policy);
    if (!mine) continue;
    if (item.w > 1) {
      store_lanes<T, V>(scratch + blockIdx.x * nl + l0, acc);
    } else {
      ep.template rows<V>(item.y + s, nl, l0, acc, in,
                          wsum + warp * kParts * a.lanes);
    }
  }
  bool finishes = false;
  if (item.w > 1) {
    // a piece of a row cut into item.w pieces: the last to finish adds
    // the pieces in piece order, a lane a thread
    const int first = blockIdx.x - item.z;  // the row's first item
    finishes = last_ticket(a.tickets + first, item.w, &flag);
    if (finishes) {
      const T* parts = scratch + first * nl;
      for (int b = threadIdx.x; b < a.lanes; b += kLaneThreads) {
        T sum = T(0);
        for (int p0 = 0; p0 < item.w; p0 += kSumUnroll) {
          T part[kSumUnroll];
#pragma unroll
          for (int u = 0; u < kSumUnroll; ++u) {
            if (p0 + u < item.w) part[u] = __ldcg(parts + (p0 + u) * nl + b);
          }
#pragma unroll
          for (int u = 0; u < kSumUnroll; ++u) {
            if (p0 + u < item.w) sum += part[u];
          }
        }
        float term[kParts > 0 ? kParts : 1];
        ep.lane(item.y, nl, b, sum, term);
        if constexpr (kParts > 0) {
#pragma unroll
          for (int k = 0; k < kParts; ++k) {
            __stcg(ep.a.partials + ((size_t)first * kParts + k) * nl + b,
                   (double)term[k]);
          }
        }
      }
    }
  }
  if constexpr (kParts > 0) add_up_terms(a, ep, item, finishes, wsum, &flag);
}

template <typename T, int V, class Ep>
int launch_lanes(const LanesArgs& a, const void* vals, const void* x,
                 const Ep& ep, cudaStream_t stream) {
  const T* v = static_cast<const T*>(vals);
  const T* xs = static_cast<const T*>(x);
  const size_t shared =
      Ep::kParts > 0 ? sizeof(double) * kLaneWarps * Ep::kParts * a.lanes
                     : 0;
  switch (a.unroll) {
    case 4:
      lanes_item_kernel<T, V, 4, Ep>
          <<<a.nitems, kLaneThreads, shared, stream>>>(a, v, xs, ep);
      break;
    case 8:
      lanes_item_kernel<T, V, 8, Ep>
          <<<a.nitems, kLaneThreads, shared, stream>>>(a, v, xs, ep);
      break;
    case 16:
      lanes_item_kernel<T, V, 16, Ep>
          <<<a.nitems, kLaneThreads, shared, stream>>>(a, v, xs, ep);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The lane trial's products, f32: the vector variant (4 lanes a thread)
// or the scalar one.
template <class Ep>
int launch_trial_product(const LanesArgs* args, const void* vals,
                         const void* x, const LaneStepArgs* step,
                         cudaStream_t stream) {
  const LanesArgs& a = *args;
  if (a.nitems <= 0 || a.lanes <= 0) return 0;
  if (a.elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const Ep ep{*step};
  switch (a.vec) {
    case 1: return launch_lanes<float, 1>(a, vals, x, ep, stream);
    case 4: return launch_lanes<float, 4>(a, vals, x, ep, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace folp

// args: the half's LanesArgs (its vec picks the variant); vals, x, y as
// above.
extern "C" int folp_lanes_spmv(const folp::LanesArgs* args,
                               const void* vals, const void* x, void* y,
                               void* stream_ptr) {
  using namespace folp;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const LanesArgs& a = *args;
  if (a.nitems <= 0 || a.lanes <= 0) return 0;
  if (a.elem_bytes == 4) {
    const PlainProduct<float> ep{static_cast<float*>(y)};
    switch (a.vec) {
      case 1: return launch_lanes<float, 1>(a, vals, x, ep, stream);
      case 2: return launch_lanes<float, 2>(a, vals, x, ep, stream);
      case 4: return launch_lanes<float, 4>(a, vals, x, ep, stream);
    }
  } else if (a.elem_bytes == 8) {
    const PlainProduct<double> ep{static_cast<double*>(y)};
    switch (a.vec) {
      case 1: return launch_lanes<double, 1>(a, vals, x, ep, stream);
      case 2: return launch_lanes<double, 2>(a, vals, x, ep, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The lane trial's dual step: A z (z = the extrapolated point, vals A's
// plane) with its epilogue into step->out (y+) and each lane's sum of
// (y+ - y)^2 into step->sums.
extern "C" int folp_lanes_dual_step(const folp::LanesArgs* args,
                                    const void* vals, const void* x,
                                    const folp::LaneStepArgs* step,
                                    void* stream_ptr) {
  using namespace folp;
  return launch_trial_product<DualStepRows>(args, vals, x, step,
                                            (cudaStream_t)stream_ptr);
}

// The lane trial's step control: A'y+ (vals A''s plane) into step->out,
// each lane's interaction and dx^2 sums and its verdict.
extern "C" int folp_lanes_rmv_stats(const folp::LanesArgs* args,
                                    const void* vals, const void* x,
                                    const folp::LaneStepArgs* step,
                                    void* stream_ptr) {
  using namespace folp;
  return launch_trial_product<StepControlRows>(args, vals, x, step,
                                               (cudaStream_t)stream_ptr);
}
