// spmv_csr: y = A x in f32 over a CSR matrix (A x with A's arrays,
// A^T y with the arrays of A^T), in one launch.
//
// Replaces, on the PDHG main path, the JAX package's routed matvec:
// the expand kernel (_make_expand / _expand_body,
// firstorderlp_tpu/ops/routed.py:160,73), the XLA chunk gather, and the
// reduce kernel (_make_reduce / _reduce_body, routed.py:188,127). Those
// select x entries by one-hot matrix products because gathers on the
// TPU are bound by index rate; Hopper gathers natively, so this is a
// CSR row sum over work items balanced by work.
//
// Bound on an H100 SXM: bytes. Per call it must read indptr (4 (m+1)
// B), indices and values (8 nnz B), x (4 n B) and write y (4 m B):
// about 7.6 MB for the 100k-node PageRank LP (800k nnz), ~2.3 us at
// 3.35 TB/s, against 2 nnz flops (~0.02 us at 67 TFLOP/s f32). Each
// gathered x entry also moves a whole 32-byte sector from the L2 cache:
// a kernel that does nothing but the gathers takes 0.0067-0.0074 ms at
// that size (PERF.md), and that is what sets this kernel's time, not the
// bytes. The walk of csr_spmv.cuh (which B3 and B4 keep) gives every
// row a trip of a group of lanes, empty rows too, with one entry a lane
// in flight; this walk takes an item's loads all at once:
//
// A work item (ops/routed.py, csr_stage_items) is a contiguous range
// [e0, e1) of entries: a run of whole rows of at most
// routed.STAGE_LONG_ROW entries each, or a longer row or a piece of one.
//
// 1. Stage (a run). Thread 0 copies the 16-byte-aligned middle of the
//    run's indices and of its values into shared memory with one bulk
//    copy each (cp.async.bulk, the TMA's 1-D form), completing on an
//    mbarrier; the head and the tail (fewer than four entries each,
//    where the range starts or ends off a 16-byte boundary) are plain
//    loads, and so are the run's row pointers. An entry e lies at slot
//    e - e0 + lo of its array, lo the entry's offset in its 16-byte
//    word (each array its own; routed.stage_copies is the same cut on
//    the host).
// 2. Gather. Thread t takes entries t, t + 256, ... kGather at a time,
//    all their x loads in flight at once, and writes each product over
//    its staged value.
// 3. Sum. Thread t sums rows t, t + 256, ..., each from zero over its
//    staged products in entry order; an empty row is a store of 0 (no
//    gather, no trip).
// A long row (or a piece) is not staged: thread t takes its entries t,
// t + 256, ..., kGather index and value loads in flight, then as many x
// loads, adds their products in that order, then block_sum; a cut
// row's pieces are added in item order behind the row's integer ticket
// (fixed_order.cuh), as in csr_spmv.cuh. So a row however long (no row
// cut: routed.csr_with_items(split_rows=False)) needs no more shared
// memory than a run.
//
// Every sum has one fixed order, which depends on the item table only,
// and no floating-point atomics, so two launches on the same inputs
// give the same bits. The scratch and the tickets belong to the matrix
// (allocated once with it, shared by the matrices built with the same
// index tensors): launches on it run on one stream, one after the
// other; the last drawer of a ticket sets it back to zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_order.cuh"

namespace folp {

constexpr int kStageThreads = 256;  // routed.ITEM_BLOCK_THREADS
constexpr int kGather = 8;          // x loads a thread has in flight

// The matrix's constant arguments for B2, built once on the host (a
// ctypes Structure of the same layout, ops/routed.py: _StageArgs).
struct StageArgs {
  const int* indptr;   // (rows + 1,)
  const int* indices;  // (nnz,)
  const float* vals;   // (nnz,)
  const int* items;    // (nitems + 1, 4), routed.csr_stage_items
  float* scratch;      // (nitems,): piece sums
  int* tickets;        // (nitems,): zero between launches
  int nitems;
  int stage;  // slots of each staged array: a multiple of 4
  int rows;   // slots of a run's row pointers: a multiple of 4
};

// Dynamic shared memory a block takes (routed.stage_item_stats'
// smem_bytes): indices, values, then the run's row pointers.
inline size_t stage_smem_bytes(const StageArgs& a) {
  return sizeof(int) * (2 * (size_t)a.stage + a.rows);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The cut of entries [e0, e1) of `src` into a head, a 16-byte-aligned
// middle [a0, a1) and a tail; lo is the slot of entry e0.
template <class T>
struct StageCut {
  int lo, a0, a1;
  __device__ StageCut(const T* src, int e0, int e1) {
    lo = static_cast<int>((reinterpret_cast<uintptr_t>(src + e0) >> 2) & 3);
    a0 = e0 + ((4 - lo) & 3);
    a1 = e1 - static_cast<int>(
                  (reinterpret_cast<uintptr_t>(src + e1) >> 2) & 3);
  }
  __device__ uint32_t middle_bytes() const {
    return a1 > a0 ? static_cast<uint32_t>(a1 - a0) * sizeof(T) : 0u;
  }
};

// Thread 0: the bulk copy of the cut's middle to dst[lo + e - e0], on
// `bar`.
template <class T>
__device__ __forceinline__ void copy_middle(const T* src, int e0,
                                            const StageCut<T>& c, T* dst,
                                            uint64_t* bar) {
  if (c.a1 <= c.a0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst + c.lo + (c.a0 - e0))),
      "l"(src + c.a0), "r"(c.middle_bytes()), "r"(smem_u32(bar))
      : "memory");
}

// Threads 0-3 load the head, threads 4-7 the tail.
template <class T>
__device__ __forceinline__ void load_ends(const T* src, int e0, int e1,
                                          const StageCut<T>& c, T* dst) {
  const int tid = threadIdx.x;
  const int head_end = min(c.a0, e1);
  const int tail_start = max(c.a1, head_end);
  const int e = tid < 4 ? e0 + tid : tail_start + tid - 4;
  if (tid < 8 && e < (tid < 4 ? head_end : e1)) {
    dst[c.lo + e - e0] = __ldg(src + e);
  }
}

__global__ void __launch_bounds__(kStageThreads)
    spmv_stage_kernel(StageArgs a, const float* __restrict__ x,
                      float* __restrict__ y) {
  extern __shared__ __align__(16) int smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[kStageThreads / 32];
  __shared__ int flag;
  int* s_idx = smem;
  float* s_val = reinterpret_cast<float*>(smem + a.stage);
  int* s_ptr = smem + 2 * a.stage;

  const int tid = threadIdx.x;
  const int4 item = reinterpret_cast<const int4*>(a.items)[blockIdx.x];
  const int4 next = reinterpret_cast<const int4*>(a.items)[blockIdx.x + 1];
  const int e0 = item.x, e1 = next.x, n = e1 - e0;
  const bool run = item.w == 0;
  const int r0 = item.y;  // a run's first row, or the long row
  if (!run) {
    // one long row, or one piece of it, walked by the whole block
    float acc = 0.f;
    for (int e = e0 + tid; e < e1; e += kStageThreads * kGather) {
      int id[kGather];
      float v[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int k = e + u * kStageThreads;
        id[u] = k < e1 ? __ldg(a.indices + k) : 0;
        v[u] = k < e1 ? __ldg(a.vals + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const float xv = __ldg(x + id[u]);
        if (e + u * kStageThreads < e1) acc += v[u] * xv;
      }
    }
    float sum = block_sum(acc, red);
    bool finishes = true;
    if (item.w > 1) {
      const int first = blockIdx.x - item.z;  // the row's first item
      if (tid == 0) __stcg(a.scratch + blockIdx.x, sum);
      finishes = last_ticket(a.tickets + first, item.w, &flag);
      if (finishes) {
        float v = 0.f;
        for (int k = tid; k < item.w; k += kStageThreads) {
          v += __ldcg(a.scratch + first + k);
        }
        sum = block_sum(v, red);
      }
    }
    if (finishes && tid == 0) y[item.y] = sum;
    return;
  }
  const int nr = next.y - r0;

  // 1. stage the run's indices, values and row pointers
  const StageCut<int> ci(a.indices, e0, e1);
  const StageCut<float> cv(a.vals, e0, e1);
  const uint32_t tx = ci.middle_bytes() + cv.middle_bytes();
  if (tid == 0 && tx != 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_u32(&bar)),
        "r"(tx)
        : "memory");
    copy_middle(a.indices, e0, ci, s_idx, &bar);
    copy_middle(a.vals, e0, cv, s_val, &bar);
  }
  load_ends(a.indices, e0, e1, ci, s_idx);
  load_ends(a.vals, e0, e1, cv, s_val);
  for (int i = tid; i <= nr; i += kStageThreads) {
    s_ptr[i] = __ldg(a.indptr + r0 + i) - e0;
  }
  __syncthreads();  // the mbarrier's init, the ends and the pointers
  if (tx != 0) {
    uint32_t ready = 0;
    while (!ready) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.b32 %0, 1, 0, p;\n}\n"
          : "=r"(ready)
          : "r"(smem_u32(&bar))
          : "memory");
    }
  }

  // 2. the products, kGather x loads in flight a thread
  const int* idx = s_idx + ci.lo;
  float* p = s_val + cv.lo;  // values, then products, in entry order
  for (int k0 = tid; k0 < n; k0 += kStageThreads * kGather) {
    int id[kGather];
    float v[kGather], xv[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int k = k0 + u * kStageThreads;
      id[u] = k < n ? idx[k] : 0;
      v[u] = k < n ? p[k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) xv[u] = __ldg(x + id[u]);
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int k = k0 + u * kStageThreads;
      if (k < n) p[k] = v[u] * xv[u];
    }
  }
  __syncthreads();

  // 3. the row sums
  for (int i = tid; i < nr; i += kStageThreads) {
    float sum = 0.f;
    const int end = s_ptr[i + 1];
    for (int k = s_ptr[i]; k < end; ++k) sum += p[k];
    y[r0 + i] = sum;
  }
}

}  // namespace folp

extern "C" int folp_spmv_csr(const folp::StageArgs* a, const float* x,
                             float* y, void* stream_ptr) {
  using namespace folp;
  if (a == nullptr || a->stage < 4 || a->stage % 4 != 0 || a->rows < 4 ||
      a->rows % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (a->nitems <= 0) return 0;  // no rows
  const size_t smem = stage_smem_bytes(*a);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spmv_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  spmv_stage_kernel<<<a->nitems, kStageThreads, smem,
                      (cudaStream_t)stream_ptr>>>(*a, x, y);
  return (int)cudaGetLastError();
}

// What the compiler gave the kernel, for the reports (routed.
// spmv_csr_attributes): registers a thread and static shared memory a
// block, whether the library was just built or loaded from the cache.
extern "C" int folp_spmv_csr_attributes(int* registers, int* static_smem) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, folp::spmv_stage_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *static_smem = (int)attr.sharedSizeBytes;
  return 0;
}
