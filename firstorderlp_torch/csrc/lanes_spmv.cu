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
// flops (41 MFLOP, 0.0006 ms at 67 TFLOP/s).
//
// Design (simple and right first; TMA, wider lanes per thread and a
// fused dual step are later work):
// - one block per work item of routed.csr_work_items: a run of short
//   rows, or a long row or one piece of a row cut into pieces;
// - the block's threads span the lanes (thread b takes lanes b,
//   b + blockDim, ...), so at B = 128 an entry's values and its x row
//   are each one contiguous 512-byte load across the block;
// - each thread sums its lane over the row's entries in entry order;
// - a row cut into pieces: each piece's block writes its B partial sums
//   to `scratch` (slot = item number) and draws an integer ticket from
//   the counter of the row's first item; the block that draws the last
//   one adds the pieces in piece order (fixed_order.cuh) and writes y,
//   and sets the counter back to zero.
// No floating-point atomics: two launches on the same inputs give the
// same bits, and the tickets are zero between launches. The tickets
// belong to the pattern, so its products run on one stream, one after
// the other.

#include <cuda_runtime.h>

#include "fixed_order.cuh"

namespace folp {

constexpr int kLaneBlockMax = 256;

template <typename T>
__global__ void __launch_bounds__(kLaneBlockMax)
    lanes_item_kernel(const int* __restrict__ indptr,
                      const int* __restrict__ indices,
                      const T* __restrict__ vals,
                      const int* __restrict__ items,
                      const T* __restrict__ x, T* __restrict__ y,
                      T* __restrict__ scratch, int* __restrict__ tickets,
                      int lanes) {
  __shared__ int flag;
  const int4 item = reinterpret_cast<const int4*>(items)[blockIdx.x];
  const int4 next = reinterpret_cast<const int4*>(items)[blockIdx.x + 1];
  const size_t nl = (size_t)lanes;

  if (item.w == 0) {
    // a run of whole short rows [item.y, next.y), one after the other
    for (int r = item.y; r < next.y; ++r) {
      const int e0 = __ldg(indptr + r);
      const int e1 = __ldg(indptr + r + 1);
      for (int b = threadIdx.x; b < lanes; b += blockDim.x) {
        T acc = T(0);
#pragma unroll 4
        for (int e = e0; e < e1; ++e) {
          acc += __ldg(vals + e * nl + b) *
                 __ldg(x + (size_t)__ldg(indices + e) * nl + b);
        }
        y[r * nl + b] = acc;
      }
    }
    return;
  }

  // one long row, or one piece of it: entries [item.x, next.x)
  const int row = item.y;
  for (int b = threadIdx.x; b < lanes; b += blockDim.x) {
    T acc = T(0);
#pragma unroll 4
    for (int e = item.x; e < next.x; ++e) {
      acc += __ldg(vals + e * nl + b) *
             __ldg(x + (size_t)__ldg(indices + e) * nl + b);
    }
    if (item.w == 1) {
      y[row * nl + b] = acc;
    } else {
      __stcg(scratch + blockIdx.x * nl + b, acc);
    }
  }
  if (item.w == 1) return;
  const int first = blockIdx.x - item.z;  // the row's first item
  if (!last_ticket(tickets + first, item.w, &flag)) return;
  for (int b = threadIdx.x; b < lanes; b += blockDim.x) {
    T sum = T(0);
    for (int k = 0; k < item.w; ++k) {
      sum += __ldcg(scratch + (first + k) * nl + b);
    }
    y[row * nl + b] = sum;
  }
}

template <typename T>
int launch_lanes(const int* indptr, const int* indices, const void* vals,
                 const int* items, int nitems, const void* x, void* y,
                 void* scratch, int* tickets, int lanes,
                 cudaStream_t stream) {
  const int threads =
      lanes >= kLaneBlockMax ? kLaneBlockMax : ((lanes + 31) / 32) * 32;
  lanes_item_kernel<T><<<nitems, threads, 0, stream>>>(
      indptr, indices, static_cast<const T*>(vals), items,
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(scratch),
      tickets, lanes);
  return (int)cudaGetLastError();
}

}  // namespace folp

// elem_bytes: 4 (f32) or 8 (f64). scratch holds nitems * lanes values.
extern "C" int folp_lanes_spmv(const int* indptr, const int* indices,
                               const void* vals, const int* items,
                               int nitems, const void* x, void* y,
                               void* scratch, int* tickets, int lanes,
                               int elem_bytes, void* stream_ptr) {
  using namespace folp;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (nitems <= 0 || lanes <= 0) return 0;
  if (elem_bytes == 4) {
    return launch_lanes<float>(indptr, indices, vals, items, nitems, x, y,
                               scratch, tickets, lanes, stream);
  }
  if (elem_bytes == 8) {
    return launch_lanes<double>(indptr, indices, vals, items, nitems, x, y,
                                scratch, tickets, lanes, stream);
  }
  return (int)cudaErrorInvalidValue;
}
