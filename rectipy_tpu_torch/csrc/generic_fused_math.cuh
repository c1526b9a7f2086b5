// The equation language's functions for the generated tails of the generic
// fused step (dsl/cuda.py emits calls to them).  Each comes in a float
// version, for per-neuron values (the f32 tensors of the plain version), and
// a double version, for arithmetic on scalar parameters and literals alone
// (Python floats, hence doubles, in the plain version).  The semantics are
// those of rectipy_tpu_torch/dsl/expr.py: heaviside(0) = 0, NaN propagates
// through maximum/minimum, exprel fills in its removable singularity, and an
// exponent that is an integer from 1 to 4 is repeated multiplication.
//
// Plain C++ as well, so that a host compiler can check a generated tail.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define GF_FN __host__ __device__ __forceinline__
#else
#define GF_FN static inline
#endif

GF_FN float gf_sign(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : x); }
GF_FN double gf_sign(double x) { return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : x); }

GF_FN float gf_heaviside(float x) { return x > 0.f ? 1.f : 0.f; }
GF_FN double gf_heaviside(double x) { return x > 0.0 ? 1.0 : 0.0; }

GF_FN float gf_sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
GF_FN double gf_sigmoid(double x) { return 1.0 / (1.0 + exp(-x)); }

GF_FN float gf_exprel(float x) { return fabsf(x) < 1e-5f ? 1.f + x * 0.5f : expm1f(x) / x; }
GF_FN double gf_exprel(double x) { return fabs(x) < 1e-5 ? 1.0 + x * 0.5 : expm1(x) / x; }

GF_FN float gf_max(float a, float b) { return (a > b || a != a) ? a : b; }
GF_FN double gf_max(double a, double b) { return (a > b || a != a) ? a : b; }
GF_FN float gf_min(float a, float b) { return (a < b || a != a) ? a : b; }
GF_FN double gf_min(double a, double b) { return (a < b || a != a) ? a : b; }

GF_FN float gf_pow2(float x) { return x * x; }
GF_FN double gf_pow2(double x) { return x * x; }
GF_FN float gf_pow3(float x) { return (x * x) * x; }
GF_FN double gf_pow3(double x) { return (x * x) * x; }
GF_FN float gf_pow4(float x) { return ((x * x) * x) * x; }
GF_FN double gf_pow4(double x) { return ((x * x) * x) * x; }

// x^e with e a scalar parameter: the integer test happens on e's value
GF_FN float gf_pow_scalar(float x, double e) {
  if (e == 1.0) return x;
  if (e == 2.0) return gf_pow2(x);
  if (e == 3.0) return gf_pow3(x);
  if (e == 4.0) return gf_pow4(x);
  return powf(x, static_cast<float>(e));
}
GF_FN double gf_pow_scalar(double x, double e) {
  if (e == 1.0) return x;
  if (e == 2.0) return gf_pow2(x);
  if (e == 3.0) return gf_pow3(x);
  if (e == 4.0) return gf_pow4(x);
  return pow(x, e);
}
