// The error-free transformations of ops/dfloat.py and its df.add / df.mul,
// operation for operation, for the df64 kernels of the solvers
// (csrc/dfdot.cu, csrc/dfops.cu).
//
// Exact rounding: every step is written with the __f*_rn intrinsics, which
// the compiler never contracts into an FMA, and the build passes
// --fmad=false as well (kernels/_cuda.py). Eager torch runs each step of
// the chain as its own correctly rounded kernel, so a kernel that repeats
// the steps in the chain's order gives the chain's bits.

#pragma once

#include <cuda_runtime.h>

namespace {

struct df {
  float hi, lo;
};

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void quick_two_sum(float a, float b, float& s,
                                              float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float t = __fmul_rn(4097.0f, a);  // 2^12 + 1
  hi = __fsub_rn(t, __fsub_rn(t, a));
  lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  float ahi, alo, bhi, blo;
  split(a, ahi, alo);
  split(b, bhi, blo);
  e = __fsub_rn(__fmul_rn(ahi, bhi), p);
  e = __fadd_rn(e, __fmul_rn(ahi, blo));
  e = __fadd_rn(e, __fmul_rn(alo, bhi));
  e = __fadd_rn(e, __fmul_rn(alo, blo));
}

// df.add: the QD "ieee" sequence
__device__ __forceinline__ df df_add(df a, df b) {
  float s1, s2, t1, t2;
  two_sum(a.hi, b.hi, s1, s2);
  two_sum(a.lo, b.lo, t1, t2);
  s2 = __fadd_rn(s2, t1);
  quick_two_sum(s1, s2, s1, s2);
  s2 = __fadd_rn(s2, t2);
  df r;
  quick_two_sum(s1, s2, r.hi, r.lo);
  return r;
}

// df.mul: e + (a.hi * b.lo + a.lo * b.hi), grouped as written
__device__ __forceinline__ df df_mul(float ah, float al, float bh, float bl) {
  float p, e;
  two_prod(ah, bh, p, e);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(ah, bl), __fmul_rn(al, bh)));
  df r;
  quick_two_sum(p, e, r.hi, r.lo);
  return r;
}

}  // namespace
