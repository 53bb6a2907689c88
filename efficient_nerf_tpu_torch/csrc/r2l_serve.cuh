// The parts of a 64-ray tile that the R2L serving kernels share: the bf16
// forward (r2l_forward.cu) and the W8A8 forward (r2l_int8.cu) differ only in
// their 43-block body.
//
//   rays (o, d) -> points p = o + z_s d          (exact f32, elementwise)
//     -> embed [sin_0..sin_{L-1} | cos_0..cos_{L-1} | p] in K-column blocks
//        (fast_sincos of trig.cuh once per point, then L-1 doublings)
//     -> head in_dim -> W on bf16 operands, f32 accumulation, relu, into the
//        register-resident residual stream h
//   ... body ...
//     -> tail W -> out_dim on bf16(h), f32 sums, sigmoid
//
// The head weight columns arrive permuted into the embed's block layout
// (ops/r2l_forward.py::_doubling_head_perm_np), so the embed needs no
// reordering. The points and the recurrence use the round-to-nearest
// intrinsics, so they round as the plain versions (ops/r2l_forward.py) do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "r2l_mma.cuh"
#include "trig.cuh"

namespace enerf {

// Writes the embed of rays ray0 .. ray0 + TB - 1 into emb [TB, in_pad] (bf16,
// row stride lde), one (ray, point coordinate) pair per thread and step;
// rays past B embed as zeros, and the columns past in_dim are zero. The
// caller orders these writes before their reads with a barrier.
__device__ __forceinline__ void embed_tile(__nv_bfloat16* emb, int lde,
                                           const float* rays_o, const float* rays_d,
                                           const float* z, long long ray0, int B,
                                           int n_sample, int L, int in_pad) {
  const int tid = threadIdx.x;
  const int K = 3 * n_sample, in_dim = K * (2 * L + 1);
  for (int idx = tid; idx < TB * K; idx += NTHREADS) {
    const int row = idx / K, m = idx % K;   // m = s * 3 + c
    const long long ray = ray0 + row;
    float o = 0.0f, d = 0.0f;
    if (ray < B) {
      o = rays_o[ray * 3 + m % 3];
      d = rays_d[ray * 3 + m % 3];
    }
    const float pt = __fadd_rn(o, __fmul_rn(z[m / 3], d));
    float s, c;
    fast_sincos(pt, s, c, 9);
    __nv_bfloat16* e = emb + (size_t)row * lde;
    for (int j = 0; j < L; ++j) {
      e[j * K + m] = __float2bfloat16_rn(s);
      e[(L + j) * K + m] = __float2bfloat16_rn(c);
      const float s2 = __fmul_rn(__fmul_rn(2.0f, s), c);
      c = __fsub_rn(1.0f, __fmul_rn(__fmul_rn(2.0f, s), s));
      s = s2;
    }
    e[2 * L * K + m] = __float2bfloat16_rn(pt);
  }
  const int n_pad = in_pad - in_dim;
  for (int idx = tid; idx < TB * n_pad; idx += NTHREADS)
    emb[(size_t)(idx / n_pad) * lde + in_dim + idx % n_pad] = __float2bfloat16_rn(0.0f);
}

// h = relu(emb @ head_w^T + head_b) for the columns this warp owns; head_w
// is [W, in_pad] bf16, streamed through `ring`. Ends with a block barrier
// (mma_stream's), after which emb and the ring may be reused.
__device__ __forceinline__ void head_relu(Frag& h, const __nv_bfloat16* emb, int lde,
                                          const __nv_bfloat16* head_w,
                                          const float* head_b, int in_pad, int W,
                                          __nv_bfloat16* ring) {
  const int lane = threadIdx.x % 32, t = lane % 4, n0 = (threadIdx.x / 32) * WN;
  mma_stream(emb, emb, lde, head_w, 0, in_pad, 1, W, ring, [&](int, Frag& acc) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float b0 = head_b[col], b1 = head_b[col + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[i][j][e] = fmaxf(acc[i][j][e] + ((e & 1) ? b1 : b0), 0.0f);
      }
  });
}

// out = sigmoid(a @ tail_w^T + tail_b) for the tile's rays below B, a = bf16
// of the final residual stream [TB, W] (row stride lda): one warp per (ray,
// output), f32 sums. The caller orders the writes of a before this with a
// barrier.
__device__ __forceinline__ void tail_sigmoid(const __nv_bfloat16* a, int lda,
                                             const __nv_bfloat16* tail_w,
                                             const float* tail_b, float* out,
                                             long long ray0, int B, int W, int out_dim) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int q = warp; q < TB * out_dim; q += NWARPS) {
    const int row = q / out_dim, j = q % out_dim;
    float acc = 0.0f;
    for (int n = lane; n < W; n += 32)
      acc += __bfloat162float(a[row * lda + n]) *
             __bfloat162float(tail_w[(size_t)j * W + n]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const long long ray = ray0 + row;
    if (lane == 0 && ray < B)
      out[ray * out_dim + j] = 1.0f / (1.0f + expf(-(acc + tail_b[j])));
  }
}

}  // namespace enerf
