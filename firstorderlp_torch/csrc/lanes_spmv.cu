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

#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_order.cuh"

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

template <typename T, int V, int U>
__global__ void __launch_bounds__(kLaneThreads)
    lanes_item_kernel(LanesArgs a, const T* __restrict__ vals,
                      const T* __restrict__ x, T* __restrict__ y) {
  __shared__ int flag;
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

  // warp w: the (row, slab) units w, w + 4, ... of the item
  for (int unit = warp; unit < nseg * slabs; unit += kLaneWarps) {
    const int s = unit / slabs;
    const int l0 = (unit - s * slabs) * slab_w + lane * V;
    const bool mine = l0 < a.lanes;
    const int s0 = piece ? item.x : __ldg(a.indptr + item.y + s);
    const int s1 = piece ? next.x : __ldg(a.indptr + item.y + s + 1);
    const Lanes<T, V> acc =
        row_sum<T, V, U>(a.indices, vals, x, nl, s0, s1, l0, mine, lane,
                         stream_policy, keep_policy);
    if (!mine) continue;
    if (item.w > 1) {
      store_lanes<T, V>(scratch + blockIdx.x * nl + l0, acc);
    } else {
      store_lanes<T, V>(y + (size_t)(item.y + s) * nl + l0, acc);
    }
  }
  if (item.w <= 1) return;

  // a piece of a row cut into item.w pieces: the last to finish adds the
  // pieces in piece order, a lane a thread
  const int first = blockIdx.x - item.z;  // the row's first item
  if (!last_ticket(a.tickets + first, item.w, &flag)) return;
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
    y[(size_t)item.y * nl + b] = sum;
  }
}

template <typename T, int V>
int launch_lanes(const LanesArgs& a, const void* vals, const void* x,
                 void* y, cudaStream_t stream) {
  const T* v = static_cast<const T*>(vals);
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  switch (a.unroll) {
    case 4:
      lanes_item_kernel<T, V, 4><<<a.nitems, kLaneThreads, 0, stream>>>(
          a, v, xs, ys);
      break;
    case 8:
      lanes_item_kernel<T, V, 8><<<a.nitems, kLaneThreads, 0, stream>>>(
          a, v, xs, ys);
      break;
    case 16:
      lanes_item_kernel<T, V, 16><<<a.nitems, kLaneThreads, 0, stream>>>(
          a, v, xs, ys);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
    switch (a.vec) {
      case 1: return launch_lanes<float, 1>(a, vals, x, y, stream);
      case 2: return launch_lanes<float, 2>(a, vals, x, y, stream);
      case 4: return launch_lanes<float, 4>(a, vals, x, y, stream);
    }
  } else if (a.elem_bytes == 8) {
    switch (a.vec) {
      case 1: return launch_lanes<double, 1>(a, vals, x, y, stream);
      case 2: return launch_lanes<double, 2>(a, vals, x, y, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}
