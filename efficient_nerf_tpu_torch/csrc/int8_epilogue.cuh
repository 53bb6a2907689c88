// The conversions of the W8A8 kernels' epilogues (r2l_int8.cu, nerf_int8.cu),
// which round as their plain versions do.
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

// Stores the levels clip(round(x), -127, 127) and clip(round(y), -127, 127),
// round half to even, as two neighbouring int8: __float2int_rn rounds, and
// cvt.pack.sat saturates at 127 and packs (at -128 too, which the bound -127
// applied first makes moot: the bounds are whole numbers).
__device__ __forceinline__ void store_s8x2(int8_t* p, float x, float y) {
  unsigned r;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(__float2int_rn(fmaxf(y, -127.0f))), "r"(__float2int_rn(fmaxf(x, -127.0f))),
        "r"(0));
  *reinterpret_cast<unsigned short*>(p) = (unsigned short)r;
}

}  // namespace enerf
