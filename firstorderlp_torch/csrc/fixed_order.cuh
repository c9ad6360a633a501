// Sums in one fixed order across the threads of a block and across the
// blocks of a launch, shared by the CSR kernels (csr_spmv.cuh) and the
// tile-plan kernels (tiled_spmv.cuh). No floating-point atomics: the
// only atomic is an integer ticket, so two launches on the same inputs
// give the same bits however the blocks were scheduled.

#pragma once

#include <cuda_runtime.h>

namespace folp {

constexpr unsigned kFullMask = 0xffffffffu;

// Block sum in a fixed order: a shuffle tree inside each warp, then
// thread 0 adds the warps' sums in warp order. Valid in thread 0. Every
// thread of the block must call this; `red` holds one float per warp.
// Ends with a barrier, so `red` may be reused at once.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFullMask, v, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    const int warps = blockDim.x >> 5;
    for (int w = 0; w < warps; ++w) total += red[w];
  }
  __syncthreads();
  return total;
}

// Thread 0 draws a ticket from `counter`; true in every thread of the
// block that draws the last of `count`, which also sets the counter
// back to zero. What the block wrote before is visible to the block
// that draws the last ticket, which must read it past the L1 cache
// (__ldcg).
__device__ __forceinline__ bool last_ticket(int* counter, int count,
                                            int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int drawn = atomicAdd(counter, 1);
    *flag = drawn == count - 1;
    if (*flag) *counter = 0;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

}  // namespace folp
