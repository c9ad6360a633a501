// pdhg_step: PDLP's step trial around the fused dual step (B3/B6) and
// A'y+ (B4/B7), as two launches:
//
//   F1a primal_step, before B3:
//     x+ = clamp(x - (tau/omega) (c - A'y), l, u),  dx = x+ - x,
//     z = 2 x+ - x (adaptive) or x+ + (x+ - x) (constant steps),
//     sigma = omega tau, and the trial's mask (the segment's while
//     predicate: no termination reason, no numerical error, and the
//     segment's first iteration or not an evaluation iteration);
//   F1b trial_epilogue, after B4:
//     movement, interaction, the numerical-error flag, the step-size
//     limit, accept, the new step size and the counters, then the
//     accepted state where (active and accept) else the state as it
//     was: the five vectors a step moves and the average's two sums
//     (x_sum += tau x+, y_sum += tau y+, weighted by the step size at
//     entry), counts and weights.
//
// Replaces the XLA fusion of the JAX package's trial around its routed
// kernels (_take_step_adaptive, firstorderlp_tpu/models/pdhg.py:303-410,
// and _take_step_constant :412; _compute_next_primal :246): no
// pl.pallas_call. Every host number (evaluation frequency, iteration
// limit, step-size exponents) is a kernel argument, every state value is
// read by pointer, so a CUDA graph of the trial bakes in no state.
//
// Bits: the eager PyTorch trial's, op for op. Each multiply and add is
// its own rounding (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: never
// contracted into a multiply-add), in PyTorch's order; clamp and
// minimum keep torch.clamp's and torch.minimum's NaN rules; 0.5 / omega
// is reciprocal(omega) * 0.5 (Tensor.__rtruediv__); the int64 count is
// converted to f32 with round to nearest; the power is the one
// PyTorch's CUDA pow(tensor, scalar) takes for the exponent in use
// (kPow* below; powf otherwise).
//
// Bound on an H100 SXM: bytes. F1a reads five n-vectors and writes
// three (32 n B, about 1 us at 100k nodes and 3.35 TB/s); F1b reads and
// writes 4 n + 3 m floats each way on either branch (the selects read
// only the chosen side: `take` is the same for every thread). Neither
// uses shared memory; every thread works the scalars it needs out again
// from the 0-d inputs, so the trial needs no other launch.
//
// At 100k nodes both kernels' bytes take about one latency of the card's
// memory, so what counts is what waits on what, and the shape of both
// follows from that: a thread takes one 16-byte slot (four entries) of
// each vector it reads, and issues the 0-d loads and its slot's loads
// before any arithmetic. The outputs are the wrappers', each vector
// 16-byte aligned for any length; an input whose address is not (a view
// at an odd offset) is read 4 bytes at a time in the same pass
// (`aligned`), and a few threads past the slots take the n mod 4 (and
// m mod 4) entries left over.
//
// F1a's design: the slot threads load step and weight, then their slot
// of x, c, A'y, l and u, and compute tau = step / weight while those are
// in flight; sigma and the mask (four more 0-d loads and an int64
// modulo, a software routine) go to a thread past the slots and the
// tails, in the grid's last block, off every slot's path. The launch is
// 256 threads a block and one slot a thread (kPrimalThreads): 98 blocks
// at 100k nodes; 128 threads (196 blocks), two slots a thread and 512 or
// 1,024 threads were 4-19% slower (PERF.md). At 100k nodes the
// kernel sits near the floor of any kernel that reads and writes device
// memory here (PyTorch's copy of one n-vector takes about half its
// time): the parent (a grid-stride loop of 4-byte loads, 391 blocks of
// 256, block 0's thread 0 also working out the mask before its first
// entry) was within 6% of it; at a million entries it is 16% faster.
//
// F1b's design: the verdict's chain (the 0-d loads, then the pow) sits in
// front of no store. A thread takes one slot of one group's vectors (4
// n-vectors or 3 m-vectors; blocks of 128, so every SM has blocks: 391
// at 100k nodes) and issues the 0-d loads, then its slot's:
// the sums and y, which both branches read, and the accepted side. It
// stores the accepted side at once, before the verdict is known (most
// trials take their step: the stores wait only on the loads and the step
// size); a trial that does not take its step then loads the state's side
// and stores it over them, so the result is the selects' either way.

#include <cuda_runtime.h>
#include <math.h>

#include "torch_ops.cuh"

namespace folp {

constexpr int kPrimalThreads = 256;    // F1a: threads a block, a slot each
constexpr int kEpilogueThreads = 128;  // F1b: threads a block

struct PrimalStepArgs {
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
  float* dx;
  float* sigma;
  bool* active;
  long long frequency;
  long long limit;
  int n;
  int constant;
  int aligned;  // bit i: input i (x, c, aty, lower, upper) 16-byte aligned
};

struct EpilogueArgs {
  // the trial's new values: F1a's, B3's and B4's
  const float* x_next;
  const float* dx;
  const float* y_next;
  const float* aty_next;
  const float* dy2;
  const float* interaction;
  const float* dx2;
  const bool* active;
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
  const float* primal_weight;
  const bool* numerical_error;
  const long long* total;
  const long long* iteration;
  const double* kkt;
  // the new state
  float* x_out;
  float* y_out;
  float* delta_x_out;
  float* delta_y_out;
  float* aty_out;
  float* sum_x_out;
  float* sum_y_out;
  long long* counters_out;  // total, iteration, count_x, count_y
  float* scalars_out;       // step size, weight_x, weight_y
  double* kkt_out;
  bool* numerical_error_out;
  float shrink_exponent;  // -reduction_exponent, as f32
  float grow_exponent;    // -growth_exponent, as f32
  int shrink_route;
  int grow_route;
  int n;
  int m;
  int constant;
  int aligned;  // bit i: input vector i (x_next ... sum_y) 16-byte aligned
};

// Entries 4q to 4q + 3 of v: one 16-byte load where v is 16-byte aligned
// (bit `input` of `aligned`), else four 4-byte loads.
__device__ __forceinline__ float4 load4(const float* v, int q, int aligned,
                                        int input) {
  if ((aligned >> input) & 1) {
    return __ldg(reinterpret_cast<const float4*>(v) + q);
  }
  const float* e = v + 4 * q;
  return make_float4(__ldg(e), __ldg(e + 1), __ldg(e + 2), __ldg(e + 3));
}

__device__ __forceinline__ void store4(float* v, int q, float4 value) {
  reinterpret_cast<float4*>(v)[q] = value;
}

// pdhg._trial_active: (iteration - 1) % frequency == 0, the iteration
// after the limit and the first ten iterations are evaluation
// iterations.
__device__ __forceinline__ bool trial_active(const PrimalStepArgs& a) {
  const long long it = *a.iteration;
  const bool evaluation = (it - 1) % a.frequency == 0 ||
                          it == a.limit + 1 || it <= 10;
  return *a.reason == 0 && !*a.numerical_error &&
         (it == *a.start || !evaluation);
}

// F1a's inputs, by their bit in `aligned`.
enum PrimalInput : int { kPX, kPC, kPAty, kPLower, kPUpper };

// One entry of F1a: x+ = clamp(x - tau (c - A'y), l, u), dx = x+ - x and
// z = x+ + dx (constant steps) or 2 x+ - x, each rounded as PyTorch.
struct PrimalEntry {
  float x_next, z, dx;
};

__device__ __forceinline__ PrimalEntry primal_entry(float x, float c,
                                                    float aty, float lower,
                                                    float upper, float tau,
                                                    int constant) {
  const float gradient = __fsub_rn(c, aty);
  const float xn =
      torch_clamp(__fsub_rn(x, __fmul_rn(tau, gradient)), lower, upper);
  const float d = __fsub_rn(xn, x);
  return {xn, constant ? __fadd_rn(xn, d) : __fsub_rn(__fmul_rn(2.f, xn), x),
          d};
}

// A thread's slot of F1a's five inputs.
struct PrimalSlot {
  float4 x, c, aty, lower, upper;
};

__device__ __forceinline__ PrimalSlot load_primal_slot(
    const PrimalStepArgs& a, int q) {
  return {load4(a.x, q, a.aligned, kPX), load4(a.c, q, a.aligned, kPC),
          load4(a.aty, q, a.aligned, kPAty),
          load4(a.lower, q, a.aligned, kPLower),
          load4(a.upper, q, a.aligned, kPUpper)};
}

__device__ __forceinline__ void store_primal_slot(const PrimalStepArgs& a,
                                                  int q, const PrimalSlot& v,
                                                  float tau) {
  const PrimalEntry e0 = primal_entry(v.x.x, v.c.x, v.aty.x, v.lower.x,
                                      v.upper.x, tau, a.constant);
  const PrimalEntry e1 = primal_entry(v.x.y, v.c.y, v.aty.y, v.lower.y,
                                      v.upper.y, tau, a.constant);
  const PrimalEntry e2 = primal_entry(v.x.z, v.c.z, v.aty.z, v.lower.z,
                                      v.upper.z, tau, a.constant);
  const PrimalEntry e3 = primal_entry(v.x.w, v.c.w, v.aty.w, v.lower.w,
                                      v.upper.w, tau, a.constant);
  store4(a.x_next, q, make_float4(e0.x_next, e1.x_next, e2.x_next,
                                  e3.x_next));
  store4(a.z, q, make_float4(e0.z, e1.z, e2.z, e3.z));
  store4(a.dx, q, make_float4(e0.dx, e1.dx, e2.dx, e3.dx));
}

// Thread t < n / 4 takes slot t; the next three threads the entries
// 4 (n / 4) + j left over, and the one after them sigma and the mask.
__global__ void __launch_bounds__(kPrimalThreads)
primal_step_kernel(const PrimalStepArgs a) {
  const float step = __ldg(a.step), weight = __ldg(a.weight);
  const int workers = a.n >> 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < workers) {
    const PrimalSlot v = load_primal_slot(a, t);
    const float tau = __fdiv_rn(step, weight);
    store_primal_slot(a, t, v, tau);
    return;
  }
  const int extra = t - workers;
  if (extra < 3) {
    const int i = 4 * workers + extra;
    if (i < a.n) {
      const PrimalEntry e = primal_entry(
          __ldg(a.x + i), __ldg(a.c + i), __ldg(a.aty + i),
          __ldg(a.lower + i), __ldg(a.upper + i), __fdiv_rn(step, weight),
          a.constant);
      a.x_next[i] = e.x_next;
      a.z[i] = e.z;
      a.dx[i] = e.dx;
    }
  } else if (extra == 3) {
    *a.sigma = __fmul_rn(weight, step);
    *a.active = trial_active(a);
  }
}

struct Verdict {
  bool active, take, numerical_error;
  float step;
};

// The trial's 0-d inputs (every thread alike), their loads issued
// together and ahead of the vectors'.
struct TrialScalars {
  bool active, numerical_error;
  float step, weight, interaction, dx2, dy2;
  long long total;
};

__device__ __forceinline__ TrialScalars load_scalars(const EpilogueArgs& a) {
  TrialScalars s = {*a.active, *a.numerical_error, *a.step, 0.f, 0.f, 0.f,
                    0.f, *a.total};
  if (!a.constant) {
    s.weight = *a.primal_weight;
    s.interaction = *a.interaction;
    s.dx2 = *a.dx2;
    s.dy2 = *a.dy2;
  }
  return s;
}

// The 0-d state that the trial only counts up or carries over.
struct EpilogueCounters {
  long long iteration, count_x, count_y;
  float weight_x, weight_y;
  double kkt;
};

// The trial's scalar part.
__device__ __forceinline__ Verdict verdict(const EpilogueArgs& a,
                                          const TrialScalars& s) {
  if (a.constant) return {s.active, s.active, s.numerical_error, s.step};
  const float interaction = fabsf(s.interaction);
  const float movement =
      __fadd_rn(__fmul_rn(__fmul_rn(0.5f, s.weight), s.dx2),
                __fmul_rn(__fmul_rn(__fdiv_rn(1.f, s.weight), 0.5f), s.dy2));
  const bool numerical_error = movement == 0.f;
  const float limit = interaction > 0.f ? __fdiv_rn(movement, interaction)
                                        : INFINITY;
  const bool accept = s.step <= limit && !numerical_error;
  const float t1 = __fadd_rn(__ll2float_rn(s.total + 1), 1.f);
  const float shrink =
      __fsub_rn(1.f, torch_pow(t1, a.shrink_exponent, a.shrink_route));
  const float grow =
      __fadd_rn(torch_pow(t1, a.grow_exponent, a.grow_route), 1.f);
  const float next = numerical_error
                         ? s.step
                         : torch_minimum(__fmul_rn(shrink, limit),
                                         __fmul_rn(grow, s.step));
  return {s.active, s.active && accept, numerical_error, next};
}

// EpilogueArgs' input vectors, by their bit in `aligned`.
enum EpilogueInput : int {
  kXNext, kDx, kYNext, kAtyNext, kX, kY, kDeltaX, kDeltaY, kAty, kSumX,
  kSumY
};

// s + x step, each entry rounded as PyTorch's sum + x * step.
__device__ __forceinline__ float4 add_scaled(float4 s, float4 x, float step) {
  return make_float4(__fadd_rn(s.x, __fmul_rn(x.x, step)),
                     __fadd_rn(s.y, __fmul_rn(x.y, step)),
                     __fadd_rn(s.z, __fmul_rn(x.z, step)),
                     __fadd_rn(s.w, __fmul_rn(x.w, step)));
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

// A thread's slot: 16 bytes of each vector of one group. Slot q < nq is
// the n-vectors' (sum x, then x, dx, A'y of the side loaded), a later
// one the m-vectors' (sum y, y, and y+ or delta y; `side` unused).
struct EpilogueSlot {
  float4 sum, first, second, side;
};

// The loads of slot q that do not wait for the verdict: the sums and y,
// which both branches read, and the accepted side.
__device__ __forceinline__ void load_taken(const EpilogueArgs& a, int q,
                                           int nq, EpilogueSlot* v) {
  if (q < nq) {
    v->sum = load4(a.sum_x, q, a.aligned, kSumX);
    v->first = load4(a.x_next, q, a.aligned, kXNext);
    v->second = load4(a.dx, q, a.aligned, kDx);
    v->side = load4(a.aty_next, q, a.aligned, kAtyNext);
  } else {
    q -= nq;
    v->sum = load4(a.sum_y, q, a.aligned, kSumY);
    v->first = load4(a.y, q, a.aligned, kY);
    v->second = load4(a.y_next, q, a.aligned, kYNext);
  }
}

// The state's side of slot q, for a trial that does not take its step.
__device__ __forceinline__ void load_kept(const EpilogueArgs& a, int q,
                                          int nq, EpilogueSlot* v) {
  if (q < nq) {
    v->first = load4(a.x, q, a.aligned, kX);
    v->second = load4(a.delta_x, q, a.aligned, kDeltaX);
    v->side = load4(a.aty, q, a.aligned, kAty);
  } else {
    v->second = load4(a.delta_y, q - nq, a.aligned, kDeltaY);
  }
}

__device__ __forceinline__ void store_slot(const EpilogueArgs& a, int q,
                                           int nq, bool take, float step,
                                           const EpilogueSlot& v) {
  if (q < nq) {
    store4(a.x_out, q, v.first);
    store4(a.delta_x_out, q, v.second);
    store4(a.aty_out, q, v.side);
    store4(a.sum_x_out, q, take ? add_scaled(v.sum, v.first, step) : v.sum);
  } else {
    q -= nq;
    store4(a.y_out, q, take ? v.second : v.first);
    store4(a.delta_y_out, q, take ? sub4(v.second, v.first) : v.second);
    store4(a.sum_y_out, q, take ? add_scaled(v.sum, v.second, step) : v.sum);
  }
}

// One of the last n mod 4 (primal) or m mod 4 (dual) entries, index i
// of its vectors: the accepted side (`take`) or the state's.
__device__ __forceinline__ void store_tail(const EpilogueArgs& a, bool primal,
                                           int i, bool take, float step) {
  if (primal) {
    const float sx = __ldg(a.sum_x + i);
    if (take) {
      const float xn = __ldg(a.x_next + i);
      a.x_out[i] = xn;
      a.delta_x_out[i] = __ldg(a.dx + i);
      a.aty_out[i] = __ldg(a.aty_next + i);
      a.sum_x_out[i] = __fadd_rn(sx, __fmul_rn(xn, step));
    } else {
      a.x_out[i] = __ldg(a.x + i);
      a.delta_x_out[i] = __ldg(a.delta_x + i);
      a.aty_out[i] = __ldg(a.aty + i);
      a.sum_x_out[i] = sx;
    }
  } else {
    const float sy = __ldg(a.sum_y + i);
    if (take) {
      const float yn = __ldg(a.y_next + i);
      a.y_out[i] = yn;
      a.delta_y_out[i] = __fsub_rn(yn, __ldg(a.y + i));
      a.sum_y_out[i] = __fadd_rn(sy, __fmul_rn(yn, step));
    } else {
      a.y_out[i] = __ldg(a.y + i);
      a.delta_y_out[i] = __ldg(a.delta_y + i);
      a.sum_y_out[i] = sy;
    }
  }
}

// Thread t < slots takes slot t (and t + stride, ...); the grid's last 8
// threads (past the slots, but where the grid is capped) the tails,
// entries 4 (n / 4) + j and 4 (m / 4) + j.
__global__ void trial_epilogue_kernel(const EpilogueArgs a) {
  const int nq = a.n >> 2, mq = a.m >> 2, slots = nq + mq;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int tail = first - (stride - 8);
  const bool primal_tail = tail >= 0 && tail < 4 && 4 * nq + tail < a.n;
  const bool dual_tail = tail >= 4 && tail < 8 && 4 * mq + tail - 4 < a.m;
  const int tail_at = primal_tail ? 4 * nq + tail : 4 * mq + tail - 4;
  const TrialScalars s = load_scalars(a);
  // The 0-d inputs only thread 0 writes out again, loaded with the rest.
  EpilogueCounters rest = {};
  if (first == 0) {
    rest = {*a.iteration, *a.count_x, *a.count_y, *a.weight_x,
            *a.weight_y, *a.kkt};
  }
  const float step = s.step;  // the averaging weight: the entry step
  // The accepted side, stored before the verdict is known (most trials
  // take their step); a trial that does not stores the state's over it.
  EpilogueSlot slot;
  if (first < slots) {
    load_taken(a, first, nq, &slot);
    store_slot(a, first, nq, true, step, slot);
  }
  if (primal_tail || dual_tail) {
    store_tail(a, primal_tail, tail_at, true, step);
  }
  const Verdict v = verdict(a, s);
  if (first == 0) {
    a.counters_out[0] = v.active ? s.total + 1 : s.total;
    a.counters_out[1] = v.take ? rest.iteration + 1 : rest.iteration;
    a.counters_out[2] = v.take ? rest.count_x + 1 : rest.count_x;
    a.counters_out[3] = v.take ? rest.count_y + 1 : rest.count_y;
    a.scalars_out[1] =
        v.take ? __fadd_rn(rest.weight_x, step) : rest.weight_x;
    a.scalars_out[2] =
        v.take ? __fadd_rn(rest.weight_y, step) : rest.weight_y;
    *a.kkt_out = v.active ? __dadd_rn(rest.kkt, 1.0) : rest.kkt;
    if (!a.constant) {
      a.scalars_out[0] = v.active ? v.step : step;
      *a.numerical_error_out = v.active ? v.numerical_error
                                        : s.numerical_error;
    }
  }
  if (!v.take) {
    if (first < slots) {
      load_kept(a, first, nq, &slot);
      store_slot(a, first, nq, false, step, slot);
    }
    if (primal_tail || dual_tail) {
      store_tail(a, primal_tail, tail_at, false, step);
    }
  }
  for (int q = first + stride; q < slots; q += stride) {
    load_taken(a, q, nq, &slot);
    if (!v.take) load_kept(a, q, nq, &slot);
    store_slot(a, q, nq, v.take, step, slot);
  }
}

constexpr int kMaxBlocks = 4 * 132 * 8;  // a few waves of the H100's SMs

}  // namespace folp

// F1a: a thread for each of the n / 4 slots, three for the tail and one
// for sigma and the mask. The outputs must be 16-byte aligned (the
// wrapper allocates them so).
extern "C" int folp_primal_step(const folp::PrimalStepArgs* a,
                                void* stream_ptr) {
  using namespace folp;
  const int blocks = ((a->n >> 2) + 4 + kPrimalThreads - 1) / kPrimalThreads;
  primal_step_kernel<<<blocks, kPrimalThreads, 0,
                       (cudaStream_t)stream_ptr>>>(*a);
  return (int)cudaGetLastError();
}

// F1b: one thread a 16-byte slot of one group's vectors (the outputs
// must be 16-byte aligned: the wrapper allocates them so).
extern "C" int folp_trial_epilogue(const folp::EpilogueArgs* a,
                                   void* stream_ptr) {
  using namespace folp;
  const int threads = (a->n >> 2) + (a->m >> 2) + 8;  // slots, tails
  const int blocks = (threads + kEpilogueThreads - 1) / kEpilogueThreads;
  trial_epilogue_kernel<<<blocks < kMaxBlocks ? blocks : kMaxBlocks,
                          kEpilogueThreads, 0,
                          (cudaStream_t)stream_ptr>>>(*a);
  return (int)cudaGetLastError();
}
