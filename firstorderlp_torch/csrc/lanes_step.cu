// lanes_step: the fleet's PDHG lane trial around its two lane products
// (lanes_spmv.cu), as two launches, f32, every lane vector (dim, B)
// contiguous in B and every lane scalar (B,):
//
//   LF1a lane_primal_step, before L1 with the dual step:
//     x+ = clamp(x - (tau_b / omega_b) (c - A'y), l, u),
//     z = x+ + (x+ - x), and each lane's mask, batch._lane_active: no
//     termination reason, no numerical error, and the segment's start
//     or not an evaluation iteration;
//   LF1b lane_trial_epilogue, after L1' with the step-control sums:
//     where the lane takes its step (active and accepted, L1''s verdict)
//     the trial's point, else the state as it was: x, y, A'y, their
//     last moves and the average's sums (x_sum += tau x+, y_sum += tau
//     y+, weighted by the step size at entry), counts and weights; where
//     the lane is active the new step size, the flag, `total` and the
//     KKT passes (+1); and one int32 word, whether any lane is active in
//     the next trial, which the host reads back in place of the mask's
//     own reduction.
//
// Replaces, on the fleet path, the eager trial of batch.pdhg_lane_step
// (batch._pdhg_trial_point, _lane_active): about 95 PyTorch kernels a
// trial over (dim, B) planes. The JAX package has no Pallas kernel here:
// it vmaps _segment_core (firstorderlp_tpu/batch.py:162) and XLA fuses
// the trial.
//
// Bits: the eager trial's, op for op (each multiply and add its own
// rounding, never contracted into a multiply-add; torch.clamp's NaN
// rules; the int64 counters and the f64 KKT passes as PyTorch adds
// them). The selects write every lane (the state's tensors are new each
// trial: the segment's start, the evaluation's result and the fleet's
// initial state hold the old ones).
//
// Bound on an H100 SXM: bytes. LF1a reads five (n, B) planes and writes
// two (7 planes, 51.2 MB each at 100,000 x 128 in f32: 0.107 ms at 3.35
// TB/s); LF1b reads and writes four (n, B) and three (m, B) planes,
// each selected side read only where a lane of the 16-byte slot takes it
// (14 planes: 0.21 ms). Design: a thread a 16-byte slot (4 lanes of one
// row; the scalar variant, 1 lane, where B is not a multiple of 4 or a
// plane is not 16-byte aligned), the slot's loads issued before its
// arithmetic, a grid-stride loop over a grid of a few blocks an SM; the
// lane scalars in block 0.

#include <cuda_runtime.h>

#include "torch_ops.cuh"

namespace folp {

constexpr int kStepThreads = 256;
constexpr int kStepBlocksPerSm = 8;

struct LanePrimalArgs {
  const float* x;
  const float* c;
  const float* aty;
  const float* lower;
  const float* upper;
  const float* step;
  const float* weight;
  const int* reason;
  const bool* numerical_error;
  const long long* iteration;
  const long long* start;
  float* x_next;
  float* z;
  bool* active;
  long long frequency;
  long long limit;
  long long size;  // n B
  int lanes;
  int vec;  // lanes a thread: 4 or 1
};

struct LaneEpilogueArgs {
  // the trial's new values: LF1a's, L1''s and its verdict
  const float* x_next;
  const float* y_next;
  const float* aty_next;
  const bool* active;
  const bool* take;
  const float* new_step;
  const bool* new_error;
  // the state at entry
  const float* x;
  const float* y;
  const float* delta_x;
  const float* delta_y;
  const float* aty;
  const float* sum_x;
  const float* sum_y;
  const long long* count_x;
  const long long* count_y;
  const float* weight_x;
  const float* weight_y;
  const float* step;
  const bool* numerical_error;
  const long long* total;
  const long long* iteration;
  const double* kkt;
  const int* reason;
  const long long* start;
  // the new state
  float* x_out;
  float* y_out;
  float* delta_x_out;
  float* delta_y_out;
  float* aty_out;
  float* sum_x_out;
  float* sum_y_out;
  long long* count_x_out;
  long long* count_y_out;
  float* weight_x_out;
  float* weight_y_out;
  float* step_out;
  bool* numerical_error_out;
  long long* total_out;
  long long* iteration_out;
  double* kkt_out;
  int* any_active;
  long long frequency;
  long long limit;
  long long primal_size;  // n B
  long long dual_size;    // m B
  int lanes;
  int vec;  // lanes a thread: 4 or 1
};

// V lanes of one row.
template <int V>
struct Slot {
  float v[V];
};

template <int V>
__device__ __forceinline__ Slot<V> load_slot(const float* p, long long i) {
  Slot<V> s;
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
    s.v[0] = q.x;
    s.v[1] = q.y;
    s.v[2] = q.z;
    s.v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) s.v[k] = __ldg(p + i + k);
  }
  return s;
}

template <int V>
__device__ __forceinline__ void store_slot(float* p, long long i,
                                           const Slot<V>& s) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p + i) =
        make_float4(s.v[0], s.v[1], s.v[2], s.v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[i + k] = s.v[k];
  }
}

// batch._is_eval_iteration: torch.remainder's (iteration - 1) mod
// frequency, the iteration after the limit and the first ten.
__device__ __forceinline__ bool eval_iteration(long long it,
                                               long long frequency,
                                               long long limit) {
  long long r = (it - 1) % frequency;
  if (r < 0) r += frequency;
  return r == 0 || it == limit + 1 || it <= 10;
}

// batch._lane_active for one lane.
__device__ __forceinline__ bool lane_active(int reason, bool error,
                                            long long it, long long start,
                                            long long frequency,
                                            long long limit) {
  return reason == 0 && !error &&
         (it == start || !eval_iteration(it, frequency, limit));
}

template <int V>
__global__ void __launch_bounds__(kStepThreads)
    lane_primal_kernel(const LanePrimalArgs a) {
  if (blockIdx.x == 0) {
    for (int l = threadIdx.x; l < a.lanes; l += kStepThreads) {
      a.active[l] = lane_active(a.reason[l], a.numerical_error[l],
                                a.iteration[l], a.start[l], a.frequency,
                                a.limit);
    }
  }
  const long long stride = (long long)gridDim.x * kStepThreads;
  for (long long i = ((long long)blockIdx.x * kStepThreads + threadIdx.x) * V;
       i < a.size; i += stride * V) {
    const int l0 = (int)(i % a.lanes);
    const Slot<V> x = load_slot<V>(a.x, i), c = load_slot<V>(a.c, i),
                  aty = load_slot<V>(a.aty, i),
                  lower = load_slot<V>(a.lower, i),
                  upper = load_slot<V>(a.upper, i),
                  step = load_slot<V>(a.step, l0),
                  weight = load_slot<V>(a.weight, l0);
    Slot<V> xn, z;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float tau = __fdiv_rn(step.v[k], weight.v[k]);
      const float v =
          __fsub_rn(x.v[k], __fmul_rn(tau, __fsub_rn(c.v[k], aty.v[k])));
      xn.v[k] = torch_clamp(v, lower.v[k], upper.v[k]);
      z.v[k] = __fadd_rn(xn.v[k], __fsub_rn(xn.v[k], x.v[k]));
    }
    store_slot<V>(a.x_next, i, xn);
    store_slot<V>(a.z, i, z);
  }
}

// Block 0: each lane's scalars, then whether any lane runs the next
// trial.
__device__ __forceinline__ void lane_scalars(const LaneEpilogueArgs& a) {
  int any = 0;
  for (int l = threadIdx.x; l < a.lanes; l += kStepThreads) {
    const bool active = a.active[l];
    const bool take = a.take[l];
    const float step = a.step[l];
    const bool error = a.numerical_error[l];
    const long long it = a.iteration[l];
    const long long next_it = take ? it + 1 : it;
    const bool next_error = active ? a.new_error[l] : error;
    a.iteration_out[l] = next_it;
    a.count_x_out[l] = take ? a.count_x[l] + 1 : a.count_x[l];
    a.count_y_out[l] = take ? a.count_y[l] + 1 : a.count_y[l];
    a.weight_x_out[l] = take ? __fadd_rn(a.weight_x[l], step) : a.weight_x[l];
    a.weight_y_out[l] = take ? __fadd_rn(a.weight_y[l], step) : a.weight_y[l];
    a.step_out[l] = active ? a.new_step[l] : step;
    a.numerical_error_out[l] = next_error;
    a.total_out[l] = active ? a.total[l] + 1 : a.total[l];
    a.kkt_out[l] = active ? __dadd_rn(a.kkt[l], 1.0) : a.kkt[l];
    any |= lane_active(a.reason[l], next_error, next_it, a.start[l],
                       a.frequency, a.limit);
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) *a.any_active = any;
}

template <int V>
__global__ void __launch_bounds__(kStepThreads)
    lane_epilogue_kernel(const LaneEpilogueArgs a) {
  if (blockIdx.x == 0) lane_scalars(a);
  const long long stride = (long long)gridDim.x * kStepThreads * V;
  const long long end = a.primal_size + a.dual_size;
  for (long long j = ((long long)blockIdx.x * kStepThreads + threadIdx.x) * V;
       j < end; j += stride) {
    const bool primal = j < a.primal_size;
    const long long i = primal ? j : j - a.primal_size;
    const int l0 = (int)(i % a.lanes);
    bool take[V];
    bool all = true, none = true;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      take[k] = a.take[l0 + k];
      all = all && take[k];
      none = none && !take[k];
    }
    const Slot<V> step = load_slot<V>(a.step, l0);
    Slot<V> kept_move{}, next{}, side{}, kept_side{};
    if (primal) {
      const Slot<V> x = load_slot<V>(a.x, i), sum = load_slot<V>(a.sum_x, i);
      if (!none) {
        next = load_slot<V>(a.x_next, i);
        side = load_slot<V>(a.aty_next, i);
      }
      if (!all) {
        kept_move = load_slot<V>(a.delta_x, i);
        kept_side = load_slot<V>(a.aty, i);
      }
      Slot<V> xo, dxo, atyo, so;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        xo.v[k] = take[k] ? next.v[k] : x.v[k];
        dxo.v[k] = take[k] ? __fsub_rn(next.v[k], x.v[k]) : kept_move.v[k];
        atyo.v[k] = take[k] ? side.v[k] : kept_side.v[k];
        so.v[k] = take[k] ? __fadd_rn(sum.v[k], __fmul_rn(next.v[k],
                                                         step.v[k]))
                          : sum.v[k];
      }
      store_slot<V>(a.x_out, i, xo);
      store_slot<V>(a.delta_x_out, i, dxo);
      store_slot<V>(a.aty_out, i, atyo);
      store_slot<V>(a.sum_x_out, i, so);
    } else {
      const Slot<V> y = load_slot<V>(a.y, i), sum = load_slot<V>(a.sum_y, i);
      if (!none) next = load_slot<V>(a.y_next, i);
      if (!all) kept_move = load_slot<V>(a.delta_y, i);
      Slot<V> yo, dyo, so;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        yo.v[k] = take[k] ? next.v[k] : y.v[k];
        dyo.v[k] = take[k] ? __fsub_rn(next.v[k], y.v[k]) : kept_move.v[k];
        so.v[k] = take[k] ? __fadd_rn(sum.v[k], __fmul_rn(next.v[k],
                                                         step.v[k]))
                          : sum.v[k];
      }
      store_slot<V>(a.y_out, i, yo);
      store_slot<V>(a.delta_y_out, i, dyo);
      store_slot<V>(a.sum_y_out, i, so);
    }
  }
}

// A grid of at most kStepBlocksPerSm blocks on each of the H100's 132
// SMs (the loops stride over any more slots), at least one (block 0
// writes the lane scalars). A constant: asking the runtime for the SM
// count would add host calls to every launch.
inline int step_blocks(long long slots) {
  const long long want = (slots + kStepThreads - 1) / kStepThreads;
  const long long cap = 132LL * kStepBlocksPerSm;
  return (int)(want < 1 ? 1 : want < cap ? want : cap);
}

}  // namespace folp

// LF1a: x+ and z into the wrapper's (n, B) planes (16-byte aligned for
// the vector variant), each lane's mask into `active`.
extern "C" int folp_lane_primal_step(const folp::LanePrimalArgs* a,
                                     void* stream_ptr) {
  using namespace folp;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (a->lanes <= 0) return 0;
  const int blocks = step_blocks(a->size / a->vec);
  if (a->vec == 4) {
    lane_primal_kernel<4><<<blocks, kStepThreads, 0, stream>>>(*a);
  } else if (a->vec == 1) {
    lane_primal_kernel<1><<<blocks, kStepThreads, 0, stream>>>(*a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// LF1b: the new state into the wrapper's tensors and the next trial's
// any-lane word.
extern "C" int folp_lane_trial_epilogue(const folp::LaneEpilogueArgs* a,
                                        void* stream_ptr) {
  using namespace folp;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (a->lanes <= 0) return 0;
  const int blocks = step_blocks((a->primal_size + a->dual_size) / a->vec);
  if (a->vec == 4) {
    lane_epilogue_kernel<4><<<blocks, kStepThreads, 0, stream>>>(*a);
  } else if (a->vec == 1) {
    lane_epilogue_kernel<1><<<blocks, kStepThreads, 0, stream>>>(*a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
