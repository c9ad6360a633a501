// Sums in one fixed order across the threads of a block and across the
// blocks of a launch, shared by the CSR kernels (csr_spmv.cuh) and the
// tile-plan kernels (tiled_spmv.cuh). No floating-point atomics: the
// only atomic is an integer ticket, so two launches on the same inputs
// give the same bits however the blocks were scheduled.

#pragma once

#include <cuda_runtime.h>

namespace folp {

constexpr unsigned kFullMask = 0xffffffffu;

// A shuffle tree inside each warp for each of the K values, then lane 0
// of warp w writes the warp's sum of value k to red[k * warps + w].
template <int K>
__device__ __forceinline__ void warp_sums_to(float (&v)[K], float* red) {
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(kFullMask, v[k], off);
    }
    if ((threadIdx.x & 31) == 0) red[k * warps + (threadIdx.x >> 5)] = v[k];
  }
}

// The warps' sums of each value, from zero in warp order (thread 0 only;
// the K chains are independent, so they overlap).
template <int K>
__device__ __forceinline__ void add_warp_sums(float (&v)[K],
                                              const float* red) {
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.f;
  for (int w = 0; w < warps; ++w) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += red[k * warps + w];
  }
}

// Block sums of K values in one fixed order each: a shuffle tree inside
// each warp, then thread 0 adds the warps' sums in warp order. One
// barrier pair for all K. The sums are valid in thread 0 (in v). Every
// thread of the block must call this; `red` holds K floats per warp.
// Ends with a barrier, so `red` may be reused at once.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float* red) {
  warp_sums_to(v, red);
  __syncthreads();
  if (threadIdx.x == 0) add_warp_sums(v, red);
  __syncthreads();
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  float s[1] = {v};
  block_sums(s, red);
  return s[0];
}

// Thread 0 only: draws a ticket from `counter` and writes to *flag
// whether it is the last of `count`; the block that draws the last also
// sets the counter back to zero.
__device__ __forceinline__ void draw_ticket(int* counter, int count,
                                            int* flag) {
  const int drawn = atomicAdd(counter, 1);
  *flag = drawn == count - 1;
  if (*flag) *counter = 0;
}

// Every thread, after thread 0's draw_ticket: true in every thread of
// the block that drew the last ticket, which then sees what the other
// blocks wrote before their draw (read it past the L1 cache, __ldcg).
__device__ __forceinline__ bool drew_last(const int* flag) {
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// Thread 0 draws a ticket from `counter`; true in every thread of the
// block that draws the last of `count`. What the block wrote before is
// visible to the block that draws the last ticket.
__device__ __forceinline__ bool last_ticket(int* counter, int count,
                                            int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) draw_ticket(counter, count, flag);
  return drew_last(flag);
}

// block_sums and last_ticket in one barrier pair, for a block whose only
// write the last block reads is its sums: thread 0 adds the warps' sums,
// stores the K sums together at out[0..K) past the L1 cache and draws
// the ticket. Returns what last_ticket returns.
template <int K>
__device__ __forceinline__ bool store_sums_last_ticket(float (&v)[K],
                                                       float* red,
                                                       float* out,
                                                       int* counter,
                                                       int count, int* flag) {
  warp_sums_to(v, red);
  __syncthreads();
  if (threadIdx.x == 0) {
    add_warp_sums(v, red);
#pragma unroll
    for (int k = 0; k < K; ++k) __stcg(out + k, v[k]);
    __threadfence();
    draw_ticket(counter, count, flag);
  }
  return drew_last(flag);
}

}  // namespace folp
