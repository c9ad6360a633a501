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
// only the chosen side: `take` is the same for every thread). Both are
// one grid-stride pass with no shared memory; block 0 writes the 0-d
// results, every block works the scalars out again from the 0-d inputs,
// so the trial needs no other launch.

#include <cuda_runtime.h>
#include <math.h>

namespace folp {

// How PyTorch's CUDA pow(tensor, scalar) computes t^e for f32, chosen on
// the host from the exponent (ops/pdhg_step.pow_route).
enum PowRoute : int {
  kPowGeneral = 0,  // powf(t, e)
  kPowZero = 1,     // fill 1
  kPowOne = 2,      // copy
  kPowSqrt = 3,     // sqrtf
  kPowRsqrt = 4,    // rsqrtf
  kPowRecip = 5,    // 1 / t
  kPowSquare = 6,   // t t
  kPowCube = 7,     // t t t
  kPowInvSquare = 8 // 1.0 / (t t), the division in double
};

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
};

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// torch.clamp(v, lower, upper) on CUDA: a NaN value, then a NaN bound,
// is returned as it is.
__device__ __forceinline__ float torch_clamp(float v, float lower,
                                             float upper) {
  if (is_nan(v)) return v;
  if (is_nan(lower)) return lower;
  if (is_nan(upper)) return upper;
  return fminf(fmaxf(v, lower), upper);
}

// torch.minimum(a, b) on CUDA: NaN propagates, a's first.
__device__ __forceinline__ float torch_minimum(float a, float b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float torch_pow(float t, float e, int route) {
  switch (route) {
    case kPowZero: return 1.f;
    case kPowOne: return t;
    case kPowSqrt: return sqrtf(t);
    case kPowRsqrt: return rsqrtf(t);
    case kPowRecip: return __fdiv_rn(1.f, t);
    case kPowSquare: return __fmul_rn(t, t);
    case kPowCube: return __fmul_rn(__fmul_rn(t, t), t);
    case kPowInvSquare:
      return static_cast<float>(__ddiv_rn(1.0, static_cast<double>(
                                                    __fmul_rn(t, t))));
    default: return powf(t, e);
  }
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

__global__ void primal_step_kernel(const PrimalStepArgs a) {
  const float step = *a.step, weight = *a.weight;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.sigma = __fmul_rn(weight, step);
    *a.active = trial_active(a);
  }
  const float tau = __fdiv_rn(step, weight);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += gridDim.x * blockDim.x) {
    const float x = __ldg(a.x + i);
    const float gradient = __fsub_rn(__ldg(a.c + i), __ldg(a.aty + i));
    const float xn = torch_clamp(__fsub_rn(x, __fmul_rn(tau, gradient)),
                                 __ldg(a.lower + i), __ldg(a.upper + i));
    const float d = __fsub_rn(xn, x);
    a.x_next[i] = xn;
    a.dx[i] = d;
    a.z[i] = a.constant ? __fadd_rn(xn, d)
                        : __fsub_rn(__fmul_rn(2.f, xn), x);
  }
}

struct Verdict {
  bool active, take, numerical_error;
  float step;
};

// The trial's scalar part, from the 0-d inputs (every thread alike).
__device__ __forceinline__ Verdict verdict(const EpilogueArgs& a) {
  const bool active = *a.active;
  const float step = *a.step;
  if (a.constant) return {active, active, *a.numerical_error, step};
  const float weight = *a.primal_weight;
  const float interaction = fabsf(*a.interaction);
  const float movement =
      __fadd_rn(__fmul_rn(__fmul_rn(0.5f, weight), *a.dx2),
                __fmul_rn(__fmul_rn(__fdiv_rn(1.f, weight), 0.5f), *a.dy2));
  const bool numerical_error = movement == 0.f;
  const float limit = interaction > 0.f ? __fdiv_rn(movement, interaction)
                                        : INFINITY;
  const bool accept = step <= limit && !numerical_error;
  const float t1 = __fadd_rn(__ll2float_rn(*a.total + 1), 1.f);
  const float shrink =
      __fsub_rn(1.f, torch_pow(t1, a.shrink_exponent, a.shrink_route));
  const float grow =
      __fadd_rn(torch_pow(t1, a.grow_exponent, a.grow_route), 1.f);
  const float next = numerical_error
                         ? step
                         : torch_minimum(__fmul_rn(shrink, limit),
                                         __fmul_rn(grow, step));
  return {active, active && accept, numerical_error, next};
}

__global__ void trial_epilogue_kernel(const EpilogueArgs a) {
  const Verdict v = verdict(a);
  const float step = *a.step;  // the averaging weight: the entry step
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long total = *a.total, iteration = *a.iteration;
    a.counters_out[0] = v.active ? total + 1 : total;
    a.counters_out[1] = v.take ? iteration + 1 : iteration;
    a.counters_out[2] = v.take ? *a.count_x + 1 : *a.count_x;
    a.counters_out[3] = v.take ? *a.count_y + 1 : *a.count_y;
    a.scalars_out[1] = v.take ? __fadd_rn(*a.weight_x, step) : *a.weight_x;
    a.scalars_out[2] = v.take ? __fadd_rn(*a.weight_y, step) : *a.weight_y;
    *a.kkt_out = v.active ? __dadd_rn(*a.kkt, 1.0) : *a.kkt;
    if (!a.constant) {
      a.scalars_out[0] = v.active ? v.step : step;
      *a.numerical_error_out =
          v.active ? v.numerical_error : *a.numerical_error;
    }
  }
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    const float sx = __ldg(a.sum_x + i);
    if (v.take) {
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
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.m; i += stride) {
    const float sy = __ldg(a.sum_y + i);
    if (v.take) {
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

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4 * 132 * 8;  // a few waves of the H100's SMs

inline int blocks_for(int items) {
  const int blocks = (items + kThreads - 1) / kThreads;
  return blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace folp

extern "C" int folp_primal_step(const folp::PrimalStepArgs* a,
                                void* stream_ptr) {
  using namespace folp;
  primal_step_kernel<<<blocks_for(a->n), kThreads, 0,
                       (cudaStream_t)stream_ptr>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int folp_trial_epilogue(const folp::EpilogueArgs* a,
                                   void* stream_ptr) {
  using namespace folp;
  trial_epilogue_kernel<<<blocks_for(a->n > a->m ? a->n : a->m), kThreads,
                          0, (cudaStream_t)stream_ptr>>>(*a);
  return (int)cudaGetLastError();
}
