// Fast polynomial sine/cosine as device helpers.
//
// Replaces efficient_nerf_tpu/ops/pallas/trig.py (fast_sin :30, fast_cos :44,
// fast_sincos :53), the helpers the Pallas kernels call. Cody-Waite two-term
// pi range reduction, then an odd minimax polynomial of degree 7 or 9 on
// [-pi/2, pi/2], and an even degree-8 one for the cosine of fast_sincos.
//
// Every product and sum is written with the round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts into FMAs:
// the helpers then round exactly as the plain torch version in ops/trig.py
// does, one operation at a time, and the two agree bit for bit. The double-
// angle recurrence that consumes the base pair amplifies any base difference
// by about 2^L, so exact agreement keeps the kernel and its plain version
// apart only by the matmuls' summation order. rintf rounds half to even, as
// jnp.round and torch.round do. __sinf/__cosf are never used: their error is
// far above what the recurrence can take.
//
// Bound: a few dozen f32 operations per element, far below the bytes that an
// elementwise pass moves; inside the R2L kernel they are negligible beside
// the matmuls.
#pragma once

namespace enerf {

// The constants are spelled as double literals cast to float, so that they
// round decimal -> double -> float exactly as Python floats do in ops/trig.py.
#define ENERF_F(x) ((float)(x))

__device__ __forceinline__ void trig_reduce(float y, float& r, float& r2,
                                            float& sign) {
  const float k = rintf(__fmul_rn(y, ENERF_F(0.3183098861837907)));
  r = __fsub_rn(__fsub_rn(y, __fmul_rn(k, ENERF_F(3.140625))),
                __fmul_rn(k, ENERF_F(9.676535897932e-4)));
  r2 = __fmul_rn(r, r);
  // (-1)^k, exactly as the plain version: 1 - 2 (k - 2 floor(k / 2))
  const float half = floorf(__fmul_rn(k, 0.5f));
  sign = __fsub_rn(1.0f, __fmul_rn(2.0f, __fsub_rn(k, __fmul_rn(2.0f, half))));
}

__device__ __forceinline__ float odd_poly(float r, float r2, int degree) {
  float p;
  if (degree >= 9) {
    p = __fadd_rn(ENERF_F(-1.9804754584e-4), __fmul_rn(r2, ENERF_F(2.5981089066e-6)));
    p = __fadd_rn(ENERF_F(8.3329640073e-3), __fmul_rn(r2, p));
    p = __fadd_rn(ENERF_F(-0.16666651520), __fmul_rn(r2, p));
    p = __fadd_rn(ENERF_F(0.99999998278), __fmul_rn(r2, p));
  } else {
    p = __fadd_rn(ENERF_F(0.00830629), __fmul_rn(r2, ENERF_F(-0.00018363)));
    p = __fadd_rn(ENERF_F(-0.16664824), __fmul_rn(r2, p));
    p = __fadd_rn(ENERF_F(0.9999966), __fmul_rn(r2, p));
  }
  return __fmul_rn(r, p);
}

__device__ __forceinline__ float fast_sin(float y, int degree = 7) {
  float r, r2, sign;
  trig_reduce(y, r, r2, sign);
  return __fmul_rn(odd_poly(r, r2, degree), sign);
}

__device__ __forceinline__ float fast_cos(float y, int degree = 7) {
  return fast_sin(__fadd_rn(y, ENERF_F(1.5707963267948966)), degree);
}

__device__ __forceinline__ void fast_sincos(float y, float& s, float& c,
                                            int degree = 9) {
  float r, r2, sign;
  trig_reduce(y, r, r2, sign);
  float q = __fadd_rn(ENERF_F(-1.3857421328e-3), __fmul_rn(r2, ENERF_F(2.3237633547e-5)));
  q = __fadd_rn(ENERF_F(4.1664091297e-2), __fmul_rn(r2, q));
  q = __fadd_rn(ENERF_F(-0.49999926896), __fmul_rn(r2, q));
  q = __fadd_rn(ENERF_F(0.99999996727), __fmul_rn(r2, q));
  s = __fmul_rn(odd_poly(r, r2, degree), sign);
  c = __fmul_rn(q, sign);
}

#undef ENERF_F

}  // namespace enerf
