// The conversions of the W8A8 kernels' epilogues (r2l_int8.cu, nerf_int8.cu),
// which round as their plain versions do: an s32 product sum to f32, and an
// f32 value to its int8 level.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace enerf {

// The epilogues convert every accumulator to f32 and every activation back
// to an int8 level, and Hopper converts (I2F, F2I, FRND) at a quarter of its
// f32 add and multiply rate. int32 -> f32 goes through the mantissa of
// 1.5 * 2^23 in two full-rate instructions, exact for |v| < 2^22: an int8
// product sum of W <= 256 terms is at most 256 * 127 * 127 = 4,129,024.
__device__ __forceinline__ float s32_to_f32(int v) {
  return __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.0f);
}

// The level clip(round(x), -127, 127), rounded half to even as torch.round
// rounds, in the low byte of the returned bits (two's complement): x is
// clipped first (the bounds are whole numbers, so the clip commutes with the
// rounding), then the f32 add of 1.5 * 2^23 rounds it to a whole number in
// the low mantissa bits. Three full-rate instructions, where F2I runs at a
// quarter of the rate. NaN gives -127, as fmaxf(NaN, -127) does.
__device__ __forceinline__ unsigned level_bits(float x) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(x, -127.0f), 127.0f), 12582912.0f));
}

// The same for x >= 0 (a relu's output, never NaN): clipped at 127 only.
__device__ __forceinline__ unsigned level_bits_pos(float x) {
  return __float_as_uint(__fadd_rn(fminf(x, 127.0f), 12582912.0f));
}

// Two levels as neighbouring int8 (a's in the low byte), from level_bits.
__device__ __forceinline__ unsigned short pack_levels(unsigned a, unsigned b) {
  unsigned r;
  asm("prmt.b32 %0, %1, %2, 0x0040;\n" : "=r"(r) : "r"(a), "r"(b));
  return (unsigned short)r;
}

}  // namespace enerf
