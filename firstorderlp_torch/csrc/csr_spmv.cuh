// Shared device code of the fused CSR kernels (spmv_dual_step.cu,
// spmv_rmv_stats.cu); B2, the plain product (spmv_csr.cu), has its own
// walk and item table.
//
// A matrix is stored as CSR: int32 indptr (rows + 1), int32 indices and
// f32 values (nnz). The host (ops/routed.py, csr_work_items) cuts it
// into work items of about the same work, one block of kBlockThreads
// threads each, and describes them in `items`, four int32 per item:
//
//   [first entry, first row, index of the piece in its row, pieces]
//
// plus one sentinel row [nnz, rows, 0, 0], so item i ends where item
// i + 1 begins. An item is one of two kinds:
//
// - pieces == 0: a run of whole short rows [first row, next first row),
//   at most kMaxItemRows of them. The block stages the run's row
//   pointers in shared memory with one coalesced load, then each group
//   of TPR lanes sums one row a trip (groups take the rows in turn),
//   lane-strided, so neighbouring lanes load neighbouring entries; a
//   shuffle tree inside the group gives each row's sum. A short row has
//   at most a few trips of its group (the host picks TPR from the mean
//   row length and calls a row long past 16 trips).
// - pieces >= 1: one long row, or piece `index` of a row cut into
//   `pieces` pieces of at most the item size, walked by the whole block:
//   thread t takes entries t, t + 256, ... and the block adds the
//   threads' sums in a fixed order (block_sum). The PageRank LP's
//   equality row (100,000 entries) is many such blocks, not one.
//
// Every sum has one fixed order, without floating-point atomics, so two
// launches on the same inputs give the same bits:
// - a row's sum: lane order inside a group's trips, then the shuffle
//   tree; or thread order and the block tree for a long row;
// - a row cut into pieces: each piece's block writes its sum to
//   `scratch` (slot = item number) and draws an integer ticket from the
//   counter of the row's first item; the block that draws the last one
//   adds the pieces' sums in item order and runs the epilogue on the
//   complete sum;
// - the epilogue's partial sums (kParts of them: 1 for the dual step,
//   2 for the step control): each block adds its rows' terms
//   in the fixed order above and writes one partial per item to
//   `scratch` (a cut row's terms to its first item's slot, whichever
//   block finished it; 0 in its other pieces' slots); every block draws
//   a ticket of the launch's counter, and the one that draws the last
//   adds the partials in item order and writes the totals to `sums`.
// The last drawer of each counter sets it back to zero, so the next
// launch finds the tickets as this one did. The scratch and the tickets
// belong to the matrix (allocated once with it, shared by the matrices
// built with the same index tensors): its kernels run on the current
// stream only, one launch after the other.

#pragma once

#include <cuda_runtime.h>

#include "fixed_order.cuh"

namespace folp {

constexpr int kBlockThreads = 256;
constexpr int kMaxItemRows = 1024;  // routed.MAX_ITEM_ROWS

// The matrix's constant arguments, built once on the host (a ctypes
// Structure of the same layout, ops/routed.py: _CsrArgs).
struct CsrArgs {
  const int* indptr;   // (rows + 1,)
  const int* indices;  // (nnz,)
  const float* vals;   // (nnz,)
  const int* items;    // (nitems + 1, 4)
  float* scratch;      // (3 nitems,): piece sums, then kParts x nitems
  int* tickets;        // (nitems + 1,): zero between launches
  int nitems;
  int tpr;  // lanes per row in a run of short rows
};

// One block per item. `Epilogue` has kParts (the partial sums it adds
// up, 1 or 2), a type In of the row's epilogue inputs, load(row), which
// reads them (before a long row's walk, after a short row's), and
// row(row, sum, in, part): called once for every output row with the
// row's complete sum, by the thread that then holds part[] for the rows
// it was given.
template <int TPR, class Epilogue>
__global__ void __launch_bounds__(kBlockThreads)
    csr_item_kernel(CsrArgs a, const float* __restrict__ x, Epilogue ep,
                    float* __restrict__ sums) {
  __shared__ int row_ptr[kMaxItemRows + 1];
  __shared__ float red[kBlockThreads / 32];
  __shared__ int flag;
  constexpr int kParts = Epilogue::kParts;
  const int tid = threadIdx.x;
  const int4 item = reinterpret_cast<const int4*>(a.items)[blockIdx.x];
  const int4 next = reinterpret_cast<const int4*>(a.items)[blockIdx.x + 1];
  float part[kParts] = {};
  bool finishes = true;  // this block runs the epilogue of its rows

  if (item.w == 0) {
    // a run of whole short rows, one group of TPR lanes a row
    const int r0 = item.y;
    const int nr = next.y - r0;
    for (int i = tid; i <= nr; i += kBlockThreads) {
      row_ptr[i] = __ldg(a.indptr + r0 + i);
    }
    __syncthreads();
    constexpr int kGroups = kBlockThreads / TPR;
    const int group = tid / TPR;
    const int lane = tid & (TPR - 1);
    // Every thread makes the same number of trips: the shuffles need
    // every lane of the warp.
    for (int base = 0; base < nr; base += kGroups) {
      const int i = base + group;
      float acc = 0.f;
      if (i < nr) {
        const int end = row_ptr[i + 1];
        for (int e = row_ptr[i] + lane; e < end; e += TPR) {
          acc += __ldg(a.vals + e) * __ldg(x + __ldg(a.indices + e));
        }
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
        acc += __shfl_down_sync(kFullMask, acc, off, TPR);
      }
      if (lane == 0 && i < nr) ep.row(r0 + i, acc, ep.load(r0 + i), part);
    }
  } else {
    // one long row, or one piece of it, walked by the whole block
    typename Epilogue::In in{};
    if (tid == 0) in = ep.load(item.y);
    float acc = 0.f;
#pragma unroll 4
    for (int e = item.x + tid; e < next.x; e += kBlockThreads) {
      acc += __ldg(a.vals + e) * __ldg(x + __ldg(a.indices + e));
    }
    float sum = block_sum(acc, red);
    if (item.w > 1) {
      const int first = blockIdx.x - item.z;  // the row's first item
      if (tid == 0) __stcg(a.scratch + blockIdx.x, sum);
      finishes = last_ticket(a.tickets + first, item.w, &flag);
      if (finishes) {
        float v = 0.f;
        for (int k = tid; k < item.w; k += kBlockThreads) {
          v += __ldcg(a.scratch + first + k);
        }
        sum = block_sum(v, red);
      }
    }
    if (finishes && tid == 0) ep.row(item.y, sum, in, part);
  }

  // One partial per item. A cut row's terms go to the slot of its first
  // item, whichever block finished it, and the other pieces' slots hold
  // 0: the order of the sum below does not depend on which block drew
  // the row's last ticket.
  float* item_parts = a.scratch + a.nitems;  // (kParts, nitems)
  const bool piece = item.w > 1;
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    const float total = block_sum(part[k], red);
    float* slots = item_parts + (size_t)k * a.nitems;
    if (tid == 0) {
      if (!piece || item.z != 0) {
        __stcg(slots + blockIdx.x, piece ? 0.f : total);
      }
      if (piece && finishes) __stcg(slots + blockIdx.x - item.z, total);
    }
  }
  if (!last_ticket(a.tickets + a.nitems, a.nitems, &flag)) return;
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    float v = 0.f;
    for (int i = tid; i < a.nitems; i += kBlockThreads) {
      v += __ldcg(item_parts + (size_t)k * a.nitems + i);
    }
    const float total = block_sum(v, red);
    if (tid == 0) sums[k] = total;
  }
}

// Launches csr_item_kernel on `stream`, one block per item, into `sums`
// (kParts floats).
template <class Epilogue>
inline int launch_csr(const CsrArgs* a, const float* x, Epilogue ep,
                      float* sums, cudaStream_t stream) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  if (a->nitems <= 0) {  // no rows: the sums are empty sums
    return (int)cudaMemsetAsync(sums, 0, sizeof(float) * Epilogue::kParts,
                                stream);
  }
  const CsrArgs args = *a;
  const dim3 grid(args.nitems);
  switch (args.tpr) {
    case 2:
      csr_item_kernel<2, Epilogue>
          <<<grid, kBlockThreads, 0, stream>>>(args, x, ep, sums);
      break;
    case 4:
      csr_item_kernel<4, Epilogue>
          <<<grid, kBlockThreads, 0, stream>>>(args, x, ep, sums);
      break;
    case 8:
      csr_item_kernel<8, Epilogue>
          <<<grid, kBlockThreads, 0, stream>>>(args, x, ep, sums);
      break;
    case 16:
      csr_item_kernel<16, Epilogue>
          <<<grid, kBlockThreads, 0, stream>>>(args, x, ep, sums);
      break;
    case 32:
      csr_item_kernel<32, Epilogue>
          <<<grid, kBlockThreads, 0, stream>>>(args, x, ep, sums);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace folp
