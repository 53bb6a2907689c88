// Fused R2L training forward and backward for Hopper (sm_90a).
//
// Replaces efficient_nerf_tpu/ops/pallas/r2l_train.py::r2l_train_apply
// (:397): its forward kernel `_fwd_kernel` (:85, pallas_call :261) and its
// backward kernel `_bwd_kernel` (:115, pallas_call :323), behind the custom
// VJP that ops/r2l_train.py rebuilds as a torch.autograd.Function. Each block
// takes a tile of TB = 64 rays end to end, with the fusion boundary of the
// Pallas kernels: the embed, the 88 layers' activations and the blocks'
// inner pre-activations never reach device memory, except the 44 bf16 block
// inputs `hs` that the forward saves for the backward.
//
// Forward (r2l_train_fwd_kernel): the tile of csrc/r2l_wgmma.cuh that the
// serving forward (csrc/r2l_forward.cu) runs, with the sample points [B, K]
// (embed_L > 0, embedded here by fast_sincos and the double-angle
// recurrence) or the embedded rows [B, x_cols] (embed_L = 0) as input,
// hs[i] = bf16(h) stored by TMA before block i, and hs[n_block] = bf16(h)
// after the optional global residual (the tail's input).
//
// Backward, pass 1 of 2 (r2l_train_bwd_kernel): the activation chain. The
// tail backward with sigmoid', then the blocks in reverse with dh in f32
// registers (warp w owns columns [32 w, 32 w + 32) of the tile, as the
// forward holds h). Per block, three products of 256^2 per ray:
//   g1  = relu(h_in @ W0^T + b0)   recomputed from the bf16 h_in (mma_stream)
//   dg1 = (dg2 @ W1) * (g1 > 0)    W1 read as [k, n] (mma_stream_kn)
//   dh  += dg1 @ W0                (mma_stream_kn)
// then the head backward: the relu mask from hs[0] > 0 (in f32) and, when dx
// is asked for, the input gradient through the embed's chain rule. Rounding
// follows :143-201: dt, dg2, dg1 and dpre enter the products as bf16, their
// bias gradients sum the f32 values; g1 is rounded to bf16 as an operand.
//
// The weight gradients contract the rays, a sum across blocks, which the
// Pallas grid runs in order into VMEM-resident f32 blocks. Here it is a
// second pass (csrc/r2l_wgrad.cu): this pass writes the products' bf16
// operands, dg2, g1 and dg1 of every block ([n_block, Bp, W] each, Bp = B
// padded to a whole tile), dpre [Bp, W] and the recomputed embed [Bp,
// in_pad], each tile a contiguous run of rows, 16 bytes a thread from the
// shared tiles; and each tile's f32 column sums of the bias and tail
// gradients into a row of `part` (head_b | body_b | tail_w | tail_b). No
// global atomics: the sums are added in a fixed order by the second pass,
// so the gradients' bits do not change from run to run.
//
// Bound (W256 D88, 98,304 rays, need_dx off): forward 5,894,912 MAC a ray
// (1.159 TFLOP, 1.172 ms at 989 TFLOP/s dense bf16) plus 2.2 GB of hs
// stores, bound by operations; its design is r2l_wgmma.cuh's. Pass 1: 3 x
// 43 x 65,536 MAC a ray plus the tail (1.663 TFLOP, 1.68 ms) against 2.2 GB
// of hs read and 6.8 GB of operands written (2.69 ms at 3.35 TB/s): bound
// by bytes. The whole
// backward's operations (14,350,592 MAC a ray, 2.853 ms) are the two
// passes' together.
//
// Shared memory of the backward (W = 256, in_pad = 1024): the weight ring
// (2 x 36 KB), two h_in tiles (double buffer for the next block's hs row
// tile), g1 (later dg1) and dg2 (later dpre), bf16 rows of 264: 204 KB; the
// embed (129 KB) overlays the ring, the h_in tiles and g1 at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "r2l_mma.cuh"
#include "r2l_wgmma.cuh"
#include "trig.cuh"

namespace {

using namespace enerf;  // TB, NWARPS, ..., Frag, mma_stream (r2l_mma.cuh)

struct Weights {
  const __nv_bfloat16* head_w;     // [W, in_pad], doubling order when embed_L > 0
  const float* head_b;             // [W]
  const __nv_bfloat16* body_w;     // [n_block, 2, W, W]  ([out, in])
  const float* body_b;             // [n_block, 2, W]
  const __nv_bfloat16* tail_w;     // [out_dim, W]
  const float* tail_b;             // [out_dim]
};

struct Shape {
  int B, x_cols, embed_L, in_pad, W, n_block, out_dim, global_residual;
  int hs_rows;                     // rows between two blocks of hs (B, or more for a ray chunk)
  float res_scale;
};

struct FwdArgs {
  wg::Net net;                     // K = x_cols, L = embed_L
  const float* x;                  // [B, x_cols]
};

struct BwdArgs {
  Weights w;
  Shape s;
  const float* x;                  // [B, x_cols]
  const __nv_bfloat16* hs;         // [n_block + 1, hs_rows, W], rows 0 .. B - 1 used
  const float* dout;               // [B, out_dim]
  __nv_bfloat16* dg2s;             // [n_block, Bp, W]: the weight-gradient operands
  __nv_bfloat16* dg1s;             // [n_block, Bp, W]
  __nv_bfloat16* g1s;              // [n_block, Bp, W]
  __nv_bfloat16* dpres;            // [Bp, W]
  __nv_bfloat16* embs;             // [Bp, in_pad]
  float* part;                     // [Bp / TB, W + 2 n_block W + out_dim W + out_dim]
  float* dx;                       // [B, x_cols], or null: need_dx off
};

constexpr int MAX_OUT = 4;         // rgb, or rgb + depth

__host__ __device__ inline size_t max_sz(size_t x, size_t y) { return x > y ? x : y; }

struct BwdLayout {
  size_t ring, hbuf0, hbuf1, g1, dg2, dt, emb, dp, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int in_pad, int W) {
  const size_t tile = (size_t)TB * (W + PAD) * 2;
  BwdLayout l;
  l.ring = 0;
  l.hbuf0 = (size_t)S * ring_stage_bytes(W);
  l.hbuf1 = l.hbuf0 + tile;
  l.g1 = l.hbuf1 + tile;
  l.emb = 0;                                   // after the body only
  l.dp = l.hbuf1;                              // dx's [TB, K] f32 sums
  l.dg2 = max_sz(l.g1 + tile, (size_t)TB * (in_pad + PAD) * 2);
  l.dt = l.dg2 + tile;
  l.total = l.dt + (size_t)TB * MAX_OUT * 4;
  return l;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The [TB, in_pad] bf16 network input of rays ray0.. : the doubling embed
// [sin_0..sin_{L-1} | cos_0..cos_{L-1} | p] of the [B, K] points in K-column
// blocks (embed_L > 0), or the given rows (embed_L = 0); zeros past B and
// past the input's columns.
__device__ void embed_tile(const float* x, long long ray0, const Shape& s,
                           __nv_bfloat16* emb, int lde) {
  const int tid = threadIdx.x, K = s.x_cols, L = s.embed_L;
  int in_dim = K;
  if (L > 0) {
    in_dim = K * (2 * L + 1);
    for (int idx = tid; idx < TB * K; idx += NTHREADS) {
      const int row = idx / K, m = idx % K;
      const long long ray = ray0 + row;
      __nv_bfloat16* e = emb + (size_t)row * lde;
      wg::embed_point(ray < s.B ? x[ray * K + m] : 0.0f, m, K, L,
                      [=](int col, float v) { e[col] = __float2bfloat16_rn(v); });
    }
  } else {
    for (int idx = tid; idx < TB * K; idx += NTHREADS) {
      const int row = idx / K, col = idx % K;
      const long long ray = ray0 + row;
      emb[(size_t)row * lde + col] =
          __float2bfloat16_rn(ray < s.B ? x[ray * K + col] : 0.0f);
    }
  }
  const int n_pad = s.in_pad - in_dim;
  for (int idx = tid; idx < TB * n_pad; idx += NTHREADS)
    emb[(size_t)(idx / n_pad) * lde + in_dim + idx % n_pad] = __float2bfloat16_rn(0.0f);
}

template <int NT, bool PARTS>
__global__ void __launch_bounds__(wg::NTHREADS, 1)
    r2l_train_fwd_kernel(const __grid_constant__ wg::Maps maps, const FwdArgs p) {
  extern __shared__ __align__(128) unsigned char fwd_smem[];  // aligned to 1024 inside
  const float* x = p.x;
  const int K = p.net.K;
  // the [B, K] points (embed_L > 0), which the tile embeds, or the given
  // rows (embed_L = 0)
  wg::forward_tile<NT, true, PARTS>(maps, p.net, fwd_smem,
                             [=](long long ray, int m) { return x[ray * K + m]; });
}

template <int NT>
struct FwdKernel {
  static int launch(const wg::Maps& maps, const FwdArgs& p, unsigned grid, size_t smem,
                    bool parts, cudaStream_t stream) {
    auto kernel = parts ? r2l_train_fwd_kernel<NT, true> : r2l_train_fwd_kernel<NT, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, wg::NTHREADS, smem, stream>>>(maps, p);
    return (int)cudaGetLastError();
  }
};

// Copies hs[blk] rows ray0 .. ray0 + TB - 1 into a [TB, W + PAD] bf16 tile
// with cp.async (zeros past B). The caller commits and waits.
__device__ __forceinline__ void load_hs_tile(__nv_bfloat16* dst, const __nv_bfloat16* hs,
                                             const Shape& s, int blk, long long ray0) {
  const int W = s.W, lda = W + PAD;
  for (int q = threadIdx.x; q < TB * (W / 8); q += NTHREADS) {
    const int row = q / (W / 8), col = (q % (W / 8)) * 8;
    const long long ray = ray0 + row;
    if (ray < s.B)
      cp_async16(dst + row * lda + col, hs + ((size_t)blk * s.hs_rows + ray) * W + col);
    else
      *reinterpret_cast<uint4*>(dst + row * lda + col) = make_uint4(0, 0, 0, 0);
  }
}

// Column sums over the tile's TB rows of v * scale (each product rounded
// once, as the plain version's f32 sum of a rounded product), stored to
// gb[n0 ..], one column a lane of group 0.
__device__ __forceinline__ void col_sums_store(const Frag& v, float scale, float* gb,
                                               int n0, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) sum = __fadd_rn(sum, __fmul_rn(v[i][j][2 * hf + e], scale));
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      if (g == 0) gb[n0 + 8 * j + 2 * t + e] = sum;
    }
}

// Copies a [TB, ncols] bf16 tile (shared, row stride lds) to rows ray0 ..
// ray0 + TB - 1 of a row-major [*, ncols] array, 16 bytes a thread. Reads
// only shared memory: the caller orders it against the tile's writers.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int lds, int ncols, long long ray0) {
  const int c8 = ncols / 8;
  for (int q = threadIdx.x; q < TB * c8; q += NTHREADS) {
    const int row = q / c8, col = (q % c8) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)(ray0 + row) * ncols + col) =
        *reinterpret_cast<const uint4*>(src + row * lds + col);
  }
}

// dh (this warp's fragment) = bf16(dt) @ tail_w: out_dim exact bf16
// products summed in f32.
__device__ __forceinline__ void tail_dh(Frag& v, const float* sdt,
                                        const __nv_bfloat16* tail_w, int out_dim,
                                        int W, int n0, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * i + g + 8 * (e / 2), col = n0 + 8 * j + 2 * t + e % 2;
        float sum = 0.0f;
        for (int q = 0; q < out_dim; ++q)
          sum = __fadd_rn(sum, __fmul_rn(bf16r(sdt[row * MAX_OUT + q]),
                                         __bfloat162float(tail_w[(size_t)q * W + col])));
        v[i][j][e] = sum;
      }
}

__device__ __forceinline__ bool mask_bit(unsigned long long m, int i, int j, int e) {
  return (m >> ((i * NJ + j) * 4 + e)) & 1ull;
}

// NEED_DX: the dx chain is compiled in only where it runs. Its code in the
// same kernel made ptxas spill around the body's products and cost the
// need_dx-off pass a fifth of its time (PERF.md).
template <bool NEED_DX>
__global__ void __launch_bounds__(NTHREADS, 1) r2l_train_bwd_kernel(const BwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Shape s = p.s;  // a copy: the epilogues capture locals only
  const BwdLayout lay = bwd_layout(s.in_pad, s.W);
  const int W = s.W, lda = W + PAD, lde = s.in_pad + PAD, nb = s.n_block;
  const int od = s.out_dim, K = s.x_cols, L = s.embed_L;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + lay.ring);
  __nv_bfloat16* hbuf[2] = {reinterpret_cast<__nv_bfloat16*>(smem + lay.hbuf0),
                            reinterpret_cast<__nv_bfloat16*>(smem + lay.hbuf1)};
  __nv_bfloat16* sg1 = reinterpret_cast<__nv_bfloat16*>(smem + lay.g1);
  __nv_bfloat16* sdg2 = reinterpret_cast<__nv_bfloat16*>(smem + lay.dg2);
  float* sdt = reinterpret_cast<float*>(smem + lay.dt);
  __nv_bfloat16* emb = reinterpret_cast<__nv_bfloat16*>(smem + lay.emb);
  float* dp = reinterpret_cast<float*>(smem + lay.dp);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, n0 = warp * WN;
  const bool owns = n0 < W;
  const long long ray0 = (long long)blockIdx.x * TB;
  const size_t Bp = (size_t)gridDim.x * TB;
  const __nv_bfloat16* tail_w = p.w.tail_w;
  const float* body_b = p.w.body_b;
  const __nv_bfloat16* body_w = p.w.body_w;
  // this tile's row of column sums: head_b | body_b | tail_w | tail_b
  float* part_head_b = p.part + blockIdx.x * (size_t)(W + 2 * nb * W + od * W + od);
  float* part_body_b = part_head_b + W;
  float* part_tail_w = part_body_b + 2 * nb * W;
  float* part_tail_b = part_tail_w + od * W;

  // ---- the tail input hs[nb] and the last block's input hs[nb - 1]
  load_hs_tile(hbuf[nb & 1], p.hs, s, nb, ray0);
  load_hs_tile(hbuf[(nb - 1) & 1], p.hs, s, nb - 1, ray0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- tail: out = sigmoid(hN @ Wt^T + bt), dt = dout * out * (1 - out)
  const __nv_bfloat16* hN = hbuf[nb & 1];
  for (int q = warp; q < TB * od; q += NWARPS) {
    const int row = q / od, j = q % od;
    float acc = 0.0f;
    for (int n = lane; n < W; n += 32)
      acc += __bfloat162float(hN[row * lda + n]) * __bfloat162float(tail_w[(size_t)j * W + n]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const long long ray = ray0 + row;
      float d = 0.0f;                     // rays past B contribute nothing
      if (ray < s.B) {
        const float o = 1.0f / (1.0f + expf(-(acc + p.w.tail_b[j])));
        d = __fmul_rn(__fmul_rn(p.dout[ray * od + j], o), __fsub_rn(1.0f, o));
      }
      sdt[row * MAX_OUT + j] = d;
    }
  }
  __syncthreads();
  if (tid < od) {
    float sum = 0.0f;
    for (int r = 0; r < TB; ++r) sum += sdt[r * MAX_OUT + tid];
    part_tail_b[tid] = sum;
  }
  for (int q = tid; q < od * W; q += NTHREADS) {
    const int j = q / W, n = q % W;
    float sum = 0.0f;
    for (int r = 0; r < TB; ++r)
      sum = __fadd_rn(sum, __fmul_rn(bf16r(sdt[r * MAX_OUT + j]),
                                     __bfloat162float(hN[r * lda + n])));
    part_tail_w[q] = sum;
  }
  Frag dh;
  if (owns) tail_dh(dh, sdt, tail_w, od, W, n0, lane);
  __syncthreads();  // hN's buffer is refilled by the first block's prefetch

  // ---- residual blocks in reverse
  const float rs = s.res_scale;
  for (int blk = nb - 1; blk >= 0; --blk) {
    const __nv_bfloat16* hin = hbuf[blk & 1];
    // the next block's input; its buffer's last reader (block blk + 1) is done
    if (blk > 0) load_hs_tile(hbuf[(blk - 1) & 1], p.hs, s, blk - 1, ray0);
    cp_async_commit();
    const __nv_bfloat16* w0 = body_w + (size_t)(2 * blk) * W * W;
    const __nv_bfloat16* w1 = w0 + (size_t)W * W;
    float* gb0 = part_body_b + (size_t)(2 * blk) * W;
    float* gb1 = gb0 + W;
    const size_t lofs = (size_t)blk * Bp * W;   // this block's rows of the operands

    // dg2 = dh * res_scale: bf16 operand, f32 bias gradient
    if (owns) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = 16 * i + g + 8 * hf, col = n0 + 8 * j + 2 * t;
            store_bf16x2(sdg2 + row * lda + col, __fmul_rn(dh[i][j][2 * hf], rs),
                         __fmul_rn(dh[i][j][2 * hf + 1], rs));
          }
      col_sums_store(dh, rs, gb1, n0, lane);
    }

    // g1 = relu(h_in @ W0^T + b0) -> sg1 (bf16) and the relu mask
    unsigned long long mask = 0;
    const float* b0p = body_b + (size_t)(2 * blk) * W;
    mma_stream(hin, hin, lda, w0, 0, W, 1, W, ring, [&](int, Frag& acc) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          const float b0 = b0p[col], b1 = b0p[col + 1];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = 16 * i + g + 8 * hf;
            const float v0 = acc[i][j][2 * hf] + b0, v1 = acc[i][j][2 * hf + 1] + b1;
            if (v0 > 0.0f) mask |= 1ull << ((i * NJ + j) * 4 + 2 * hf);
            if (v1 > 0.0f) mask |= 1ull << ((i * NJ + j) * 4 + 2 * hf + 1);
            store_bf16x2(sg1 + row * lda + col, fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          }
        }
    });

    // the dW1 operands: mma_stream ended with a barrier, so g1 and dg2 are
    // complete; mma_stream_kn's first barrier orders these reads before
    // its epilogue overwrites g1 with dg1
    store_tile(p.g1s + lofs, sg1, lda, W, ray0);
    store_tile(p.dg2s + lofs, sdg2, lda, W, ray0);

    // dg1 = (dg2 @ W1) * (g1 > 0) -> sg1 (g1 is dead), bias gradient
    mma_stream_kn(sdg2, lda, w1, W, W, W, W, ring, [&](Frag& acc) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!mask_bit(mask, i, j, e)) acc[i][j][e] = 0.0f;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = 16 * i + g + 8 * hf, col = n0 + 8 * j + 2 * t;
            store_bf16x2(sg1 + row * lda + col, acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
          }
      col_sums_store(acc, 1.0f, gb0, n0, lane);
    });

    // the dW0 operand (h_in is hs itself)
    store_tile(p.dg1s + lofs, sg1, lda, W, ray0);

    // dh += dg1 @ W0
    mma_stream_kn(sg1, lda, w0, W, W, W, W, ring, [&](Frag& acc) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[i][j][e] = dh[i][j][e] + acc[i][j][e];
    });
  }

  // ---- head: global residual, relu mask from hs[0] (in f32), dpre
  if (owns) {
    if (s.global_residual) {
      Frag v;
      tail_dh(v, sdt, tail_w, od, W, n0, lane);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[i][j][e] = dh[i][j][e] + v[i][j][e];
    }
    const __nv_bfloat16* h0 = hbuf[0];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = 16 * i + g + 8 * hf, col = n0 + 8 * j + 2 * t;
          const float2 hv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(h0 + row * lda + col));
          if (!(hv.x > 0.0f)) dh[i][j][2 * hf] = 0.0f;
          if (!(hv.y > 0.0f)) dh[i][j][2 * hf + 1] = 0.0f;
          store_bf16x2(sdg2 + row * lda + col, dh[i][j][2 * hf], dh[i][j][2 * hf + 1]);
        }
    col_sums_store(dh, 1.0f, part_head_b, n0, lane);
  }
  __syncthreads();
  store_tile(p.dpres, sdg2, lda, W, ray0);

  // ---- dx = dpre @ head_w, chained through the embed when embed_L > 0
  const float* xg = p.x;
  float* dxg = p.dx;
  if (NEED_DX) {
    if (L > 0)
      for (int q = tid; q < TB * K; q += NTHREADS) dp[q] = 0.0f;
    for (int nc = 0; nc < s.in_pad; nc += W) {
      const int ncols = min(W, s.in_pad - nc);
      mma_stream_kn(sdg2, lda, p.w.head_w + nc, s.in_pad, W, ncols, W, ring,
                    [&](Frag& acc) {
        for (int i = 0; i < RT; ++i)
          for (int j = 0; j < NJ; ++j)
            for (int e = 0; e < 4; ++e) {
              const int row = 16 * i + g + 8 * (e / 2), col = n0 + 8 * j + 2 * t + e % 2;
              const long long ray = ray0 + row;
              const int n = nc + col;
              if (col >= ncols || ray >= s.B) continue;
              const float v = acc[i][j][e];
              if (L == 0) {
                if (n < K) dxg[ray * K + n] = v;
                continue;
              }
              const int b = n / K, m = n % K;
              if (b > 2 * L) continue;     // zero padding columns
              float term = v;              // identity block
              if (b < 2 * L) {
                // d sin(2^j p) = 2^j cos(2^j p) dp, d cos(2^j p) = -2^j sin(2^j p) dp
                const int jj = b % L;
                float sn, cs;
                fast_sincos(xg[ray * K + m], sn, cs, 9);
                for (int q = 0; q < jj; ++q) {
                  const float s2 = __fmul_rn(__fmul_rn(2.0f, sn), cs);
                  cs = __fsub_rn(1.0f, __fmul_rn(__fmul_rn(2.0f, sn), sn));
                  sn = s2;
                }
                const float f = (float)(1 << jj);
                term = b < L ? __fmul_rn(v, __fmul_rn(f, cs)) : -__fmul_rn(v, __fmul_rn(f, sn));
              }
              atomicAdd(dp + row * K + m, term);
            }
      });
    }
    if (L > 0)
      for (int q = tid; q < TB * K; q += NTHREADS) {
        const long long ray = ray0 + q / K;
        if (ray < s.B) dxg[ray * K + q % K] = dp[q];
      }
    __syncthreads();  // dp and the ring are overwritten by the embed
  }

  // ---- the head's weight-gradient operand: the recomputed embed
  embed_tile(xg, ray0, s, emb, lde);
  __syncthreads();
  store_tile(p.embs, emb, lde, s.in_pad, ray0);
}

bool shape_ok(const Shape& s) {
  const int in_dim = s.embed_L > 0 ? s.x_cols * (2 * s.embed_L + 1) : s.x_cols;
  return s.W % KC == 0 && s.W <= WN * NWARPS && s.in_pad % KC == 0 &&
         in_dim <= s.in_pad && s.n_block >= 1 && s.out_dim >= 1 &&
         s.out_dim <= MAX_OUT && s.x_cols >= 1;
}

Shape make_shape(int B, int x_cols, int embed_L, int in_pad, int W, int n_block,
                 int out_dim, float res_scale, int global_residual) {
  Shape s;
  s.B = B;
  s.x_cols = x_cols;
  s.embed_L = embed_L;
  s.in_pad = in_pad;
  s.W = W;
  s.n_block = n_block;
  s.out_dim = out_dim;
  s.global_residual = global_residual;
  s.hs_rows = B;
  s.res_scale = res_scale;
  return s;
}

Weights make_weights(const void* head_w, const float* head_b, const void* body_w,
                     const float* body_b, const void* tail_w, const float* tail_b) {
  Weights w;
  w.head_w = static_cast<const __nv_bfloat16*>(head_w);
  w.head_b = head_b;
  w.body_w = static_cast<const __nv_bfloat16*>(body_w);
  w.body_b = body_b;
  w.tail_w = static_cast<const __nv_bfloat16*>(tail_w);
  w.tail_b = tail_b;
  return w;
}

}  // namespace

// Bytes of dynamic shared memory a block of each kernel needs; above 232448
// the shape is not supported.
extern "C" long long r2l_train_fwd_smem_bytes(int in_pad, int W) {
  return (long long)wg::layout(in_pad, wg::round_up64(W), true).total;
}

extern "C" long long r2l_train_bwd_smem_bytes(int in_pad, int W) {
  return (long long)bwd_layout(in_pad, W).total;
}

// Both launch on `stream` and return cudaGetLastError() (0 = ok). Shapes are
// checked by the Python wrapper; the checks here guard the kernels' own
// assumptions.
extern "C" int r2l_train_fwd_launch(const float* x, const void* head_w, const float* head_b,
                                    const void* body_w, const float* body_b,
                                    const void* tail_w, const float* tail_b, float* out,
                                    void* hs, int B, int x_cols, int embed_L, int in_pad,
                                    int W, int n_block, int out_dim, float res_scale,
                                    int global_residual, void* stream) {
  if (B <= 0) return 0;
  const Shape s = make_shape(B, x_cols, embed_L, in_pad, W, n_block, out_dim, res_scale,
                             global_residual);
  if (!shape_ok(s) || !wg::tile_ok(in_pad, W, n_block, out_dim, global_residual != 0))
    return (int)cudaErrorInvalidValue;
  wg::Maps maps;  // hs [n_block + 1, B, W]: boxes of 64 columns x 64 rays
  if (!wg::weight_maps(&maps, head_w, body_w, in_pad, W, n_block) ||
      !encode(encoder(), &maps.hs, hs, W, B, n_block + 1, 2LL * W, 2LL * W * B, wg::TB))
    return (int)cudaErrorInvalidValue;
  FwdArgs p;
  p.net = wg::make_net(head_b, body_b, tail_w, tail_b, out, B, x_cols, embed_L, in_pad, W,
                       n_block, out_dim, res_scale, global_residual);
  p.x = x;
  return wg::launch_tile<FwdKernel>(maps, p, B, in_pad, W, global_residual != 0,
                                    (cudaStream_t)stream);
}

// The backward's pass 1: the scratch of pass 2 (dg2s, dg1s, g1s [n_block,
// Bp, W], dpres [Bp, W], embs [Bp, in_pad] bf16, part [Bp / 64, W + 2
// n_block W + out_dim W + out_dim] f32, Bp = B rounded up to 64; every
// element written) and dx. hs holds block b's rows at hs + b hs_rows W.
extern "C" int r2l_train_bwd_launch(const float* x, const void* hs, const float* dout,
                                    const void* head_w, const float* head_b,
                                    const void* body_w, const float* body_b,
                                    const void* tail_w, const float* tail_b,
                                    void* dg2s, void* dg1s, void* g1s, void* dpres,
                                    void* embs, float* part, float* dx, int B, int hs_rows,
                                    int x_cols, int embed_L, int in_pad, int W, int n_block,
                                    int out_dim, float res_scale, int global_residual,
                                    void* stream) {
  if (B <= 0) return 0;
  BwdArgs p;
  p.s = make_shape(B, x_cols, embed_L, in_pad, W, n_block, out_dim, res_scale,
                   global_residual);
  if (hs_rows < B) return (int)cudaErrorInvalidValue;
  p.s.hs_rows = hs_rows;
  const BwdLayout lay = bwd_layout(in_pad, W);
  // dx's [TB, K] f32 sums overlay one h_in tile and g1
  const bool dp_fits = dx == nullptr || embed_L == 0 ||
                       (size_t)TB * x_cols * 4 <= lay.dg2 - lay.dp;
  if (!shape_ok(p.s) || !dp_fits || lay.total > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  auto kernel = dx != nullptr ? r2l_train_bwd_kernel<true> : r2l_train_bwd_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  p.w = make_weights(head_w, head_b, body_w, body_b, tail_w, tail_b);
  p.x = x;
  p.hs = static_cast<const __nv_bfloat16*>(hs);
  p.dout = dout;
  p.dg2s = static_cast<__nv_bfloat16*>(dg2s);
  p.dg1s = static_cast<__nv_bfloat16*>(dg1s);
  p.g1s = static_cast<__nv_bfloat16*>(g1s);
  p.dpres = static_cast<__nv_bfloat16*>(dpres);
  p.embs = static_cast<__nv_bfloat16*>(embs);
  p.part = part;
  p.dx = dx;
  const unsigned blocks = (unsigned)((B + TB - 1) / TB);
  kernel<<<blocks, NTHREADS, lay.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
