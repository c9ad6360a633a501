// PyTorch's CUDA elementwise operations on f32 with their bits, shared by
// the main path's trial (pdhg_step.cu) and the fleet's lane trial
// (lanes_step.cu, lanes_spmv.cu): torch.clamp and torch.minimum with
// their NaN rules, torch.clamp_min against 0, and the routes of
// pow(tensor, scalar). Each product and sum the callers form is its own
// rounding (__fmul_rn, __fadd_rn: never contracted into a multiply-add).

#pragma once

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

// torch.clamp_min(v, 0.0) on CUDA: a NaN is returned as it is.
__device__ __forceinline__ float torch_clamp_min0(float v) {
  return is_nan(v) ? v : fmaxf(v, 0.f);
}

}  // namespace folp
