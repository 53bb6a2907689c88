// Fused R2L inference forward for Hopper (sm_90a): rays in, rgb out.
//
// Replaces efficient_nerf_tpu/ops/pallas/r2l_forward.py::r2l_forward_fused
// (:388, its pallas_call at :505) in its production configuration: the
// double-angle embedding (fast_embed=True), f32 epilogues, no diagnostics.
// One thread block renders a tile of TB rays end to end:
//
//   rays (o, d) -> points p = o + z_s d          (exact f32, elementwise)
//     -> embed [sin_0..sin_{L-1} | cos_0..cos_{L-1} | p] in K-column blocks
//        (fast_sincos of trig.cuh once per point, then L-1 doublings)
//     -> head in_dim -> W, relu -> n_block x (lin, relu, lin, * res_scale, + h)
//     -> optional global residual (+ post-relu head output) -> tail + sigmoid
//
// The head weight columns arrive permuted into the embed's block layout
// (ops/r2l_forward.py::_doubling_head_perm_np), so the embed needs no
// reordering. Precision contract of the Pallas kernel (:251-264): every
// matmul takes bf16 operands and accumulates in f32; bias, relu, the residual
// g * res_scale + h and the global residual are f32; h is rounded to bf16
// only as a matmul operand; the tail is out_dim dot products and a sigmoid in
// f32. The points, the recurrence and the residual use the round-to-nearest
// intrinsics, so they round as the plain version (ops/r2l_forward.py) does.
//
// Bound: 11.79 MFLOP per ray at W256 D88 (2 x (1008*256 + 86*256^2 +
// 256*3)); 24 bytes of rays in and 12 of rgb out per ray, plus the 11.8 MB of
// weights once. The function is bound by tensor-core operations. The design
// keeps what the Pallas kernel kept out of device memory: the activation tile
// stays on chip through all 88 layers, and only rays and rgb touch DRAM.
//
//   * The residual stream h lives in registers. Warp w owns output columns
//     [32w, 32w + 32) of all TB rows for every layer, so each thread keeps
//     its 64 f32 values of h across the whole body (242 registers, no
//     spills); only the bf16 operand copies (a, a2) go through shared memory.
//     Eight warps with 64x32 tiles read each A fragment from shared memory
//     for four products (16 warps with 64x16 tiles measured 11% slower,
//     PERF.md).
//   * Products are mma.sync m16n8k16 bf16 -> f32 on the tensor cores, their
//     operands fetched with ldmatrix from padded (bank-conflict-free) rows.
//   * Weights stream from L2 (11.8 MB, resident in the 50 MB L2) through a
//     double buffer of KC = 64 input rows, filled with cp.async one chunk
//     ahead of the math, one continuous stream over the 86 body layers; one
//     block barrier per chunk. Each block reads every weight once per TB
//     rays: 29.5 GB of L2 reads for a 160,000-ray frame, which with the
//     mma.sync math is what bounds this version (PERF.md).
//
// wgmma, TMA and warp specialisation are later work.
//
// Shared memory (W = 256, in_pad = 1024, TB = 64): region 1 holds a and a2
// (bf16, 33 KB each), or the head's weight buffers while the embed is live;
// region 2 holds the embed (bf16, 129 KB), then h0 (f32, 64 KB) and the
// body's weight buffers (2 x 36 KB): 208 KB of the 227 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "trig.cuh"

namespace {

constexpr int TB = 64;             // rays per block
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RT = TB / 16;        // 16-row tiles per block
constexpr int WN = 32;             // output columns per warp
constexpr int NJ = WN / 8;         // 8-column mma tiles per warp
constexpr int KC = 64;             // input rows of a weight chunk
constexpr int S = 2;               // weight ring stages
constexpr int PAD = 8;             // bf16 row padding: rows 16 B apart in banks
constexpr int LDS = KC + PAD;      // row stride of a ring stage
constexpr int MAX_SMEM = 232448;   // 227 KB, the opt-in limit of sm_90

struct Args {
  const float* rays_o;             // [B, 3]
  const float* rays_d;             // [B, 3]
  const float* z;                  // [n_sample] depths
  const __nv_bfloat16* head_w;     // [W, in_pad], columns permuted, zero padded
  const float* head_b;             // [W]
  const __nv_bfloat16* body_w;     // [n_block, 2, W, W]  ([out, in])
  const float* body_b;             // [n_block, 2, W]
  const __nv_bfloat16* tail_w;     // [out_dim, W]
  const float* tail_b;             // [out_dim]
  float* out;                      // [B, out_dim]
  int B, n_sample, L, in_pad, W, n_block, out_dim, global_residual;
  float res_scale;
};

struct Layout {
  size_t a, a2, head_ring, emb, h0, body_ring, total;
};

__host__ __device__ inline size_t max_sz(size_t x, size_t y) { return x > y ? x : y; }

__host__ __device__ inline Layout smem_layout(int in_pad, int W) {
  const size_t lda = W + PAD, lde = in_pad + PAD;
  const size_t ring = (size_t)S * W * LDS * 2;
  const size_t r1 = max_sz((size_t)2 * TB * lda * 2, ring);
  const size_t r2 = max_sz((size_t)TB * lde * 2, (size_t)TB * W * 4 + ring);
  Layout l;
  l.a = 0;
  l.a2 = (size_t)TB * lda * 2;
  l.head_ring = 0;
  l.emb = r1;
  l.h0 = r1;
  l.body_ring = r1 + (size_t)TB * W * 4;
  l.total = r1 + r2;
  return l;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Accumulator fragment of warp w, thread (g = lane / 4, t = lane % 4):
// acc[i][j][e] is output row 16 i + g + 8 (e / 2), column WN w + 8 j + 2 t +
// e % 2.
typedef float Frag[RT][NJ][4];

// Runs n_layers layers X_l[TB, K] @ W_l^T, W_l = Wg + l * layer_stride a
// [W, K] bf16 matrix in global memory, X_l = X0 for even l and X1 for odd l
// (bf16 in shared memory, row stride ldx). The weights stream through `ring`
// in chunks of KC input rows, S - 1 chunks ahead; at the end of layer l each
// warp that owns columns calls epi(l, acc).
template <class Epi>
__device__ __forceinline__ void mma_stream(const __nv_bfloat16* X0,
                                           const __nv_bfloat16* X1, int ldx,
                                           const __nv_bfloat16* Wg,
                                           size_t layer_stride, int K,
                                           int n_layers, int W,
                                           __nv_bfloat16* ring, Epi epi) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kchunks = K / KC, total = n_layers * kchunks;
  const bool owns = warp * WN < W;  // other warps only help to load
  const int n0 = warp * WN;

  auto load_chunk = [&](int c) {
    if (c < total) {
      const int l = c / kchunks, kc = c % kchunks;
      const __nv_bfloat16* src = Wg + (size_t)l * layer_stride + (size_t)kc * KC;
      __nv_bfloat16* dst = ring + (size_t)(c % S) * W * LDS;
      for (int q = tid; q < W * (KC / 8); q += NTHREADS) {
        const int r = q / (KC / 8), piece = q % (KC / 8);
        cp_async16(dst + r * LDS + piece * 8, src + (size_t)r * K + piece * 8);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  for (int c = 0; c < S - 1; ++c) load_chunk(c);
  Frag acc;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int c = 0; c < total; ++c) {
    cp_async_wait<S - 2>();  // chunk c has landed (this thread's copies) ...
    __syncthreads();         // ... everyone's, and stage (c - 1) % S is free
    load_chunk(c + S - 1);
    const int l = c / kchunks, kc = c % kchunks;
    if (owns) {
      const __nv_bfloat16* X = (l & 1) ? X1 : X0;
      const __nv_bfloat16* st = ring + (size_t)(c % S) * W * LDS;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        // B for columns n0 + 16 jj .. + 15: matrices (n lo, k lo),
        // (n lo, k hi), (n hi, k lo), (n hi, k hi)
        unsigned b[NJ / 2][4];
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj)
          ldmatrix_x4(b[jj], st + (n0 + 16 * jj + (lane / 16) * 8 + lane % 8) * LDS +
                                 kk + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          unsigned a[4];
          ldmatrix_x4(a, X + (size_t)(16 * i + lane % 16) * ldx + kc * KC + kk +
                             (lane / 16) * 8);
#pragma unroll
          for (int jj = 0; jj < NJ / 2; ++jj) {
            mma_bf16(acc[i][2 * jj], a, b[jj][0], b[jj][1]);
            mma_bf16(acc[i][2 * jj + 1], a, b[jj][2], b[jj][3]);
          }
        }
      }
    }
    if (kc == kchunks - 1) {
      if (owns) epi(l, acc);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(NTHREADS, 1) r2l_forward_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = smem_layout(p.in_pad, p.W);
  const int W = p.W, lda = W + PAD, lde = p.in_pad + PAD;
  __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem + lay.a);
  __nv_bfloat16* a2 = reinterpret_cast<__nv_bfloat16*>(smem + lay.a2);
  __nv_bfloat16* emb = reinterpret_cast<__nv_bfloat16*>(smem + lay.emb);
  float* h0 = reinterpret_cast<float*>(smem + lay.h0);
  __nv_bfloat16* head_ring = reinterpret_cast<__nv_bfloat16*>(smem + lay.head_ring);
  __nv_bfloat16* body_ring = reinterpret_cast<__nv_bfloat16*>(smem + lay.body_ring);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, n0 = warp * WN;
  const long long ray0 = (long long)blockIdx.x * TB;

  // ---- embedding: one (ray, point coordinate) pair per thread and step
  const int K = 3 * p.n_sample, L = p.L, in_dim = K * (2 * L + 1);
  for (int idx = tid; idx < TB * K; idx += NTHREADS) {
    const int row = idx / K, m = idx % K;   // m = s * 3 + c
    const long long ray = ray0 + row;
    float o = 0.0f, d = 0.0f;               // rays past B embed as zeros
    if (ray < p.B) {
      o = p.rays_o[ray * 3 + m % 3];
      d = p.rays_d[ray * 3 + m % 3];
    }
    const float pt = __fadd_rn(o, __fmul_rn(p.z[m / 3], d));
    float s, c;
    enerf::fast_sincos(pt, s, c, 9);
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
  const int n_pad = p.in_pad - in_dim;
  for (int idx = tid; idx < TB * n_pad; idx += NTHREADS)
    emb[(size_t)(idx / n_pad) * lde + in_dim + idx % n_pad] = __float2bfloat16_rn(0.0f);
  // (mma_stream's first barrier orders these writes before the head reads)

  // ---- head + relu into the register-resident residual stream h
  // (the epilogues capture locals, never the kernel parameter itself)
  const float* head_b = p.head_b;
  const float* body_b = p.body_b;
  Frag h;
  mma_stream(emb, emb, lde, p.head_w, 0, p.in_pad, 1, W, head_ring,
             [&](int, Frag& acc) {
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
  __syncthreads();  // the embed and the head ring are dead from here on
  if (n0 < W) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = 16 * i + g + 8 * hf, col = n0 + 8 * j + 2 * t;
          store_bf16x2(a + row * lda + col, h[i][j][2 * hf], h[i][j][2 * hf + 1]);
          if (p.global_residual)
            *reinterpret_cast<float2*>(h0 + row * W + col) =
                make_float2(h[i][j][2 * hf], h[i][j][2 * hf + 1]);
        }
  }
  // (the body stream's first barrier orders these writes before its reads)

  // ---- residual blocks, one stream of 2 n_block layers:
  //   even l: a2 = bf16(relu(a @ w1 + b1))
  //   odd l:  h = (a2 @ w2 + b2) * res_scale + h;  a = bf16(h)
  const float rs = p.res_scale;
  mma_stream(a, a2, lda, p.body_w, (size_t)W * W, W, 2 * p.n_block, W, body_ring,
             [&](int l, Frag& acc) {
               const float* bias = body_b + (size_t)l * W;
#pragma unroll
               for (int i = 0; i < RT; ++i)
#pragma unroll
                 for (int j = 0; j < NJ; ++j) {
                   const int col = n0 + 8 * j + 2 * t;
                   const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
                   for (int hf = 0; hf < 2; ++hf) {
                     const int row = 16 * i + g + 8 * hf;
                     const float v0 = acc[i][j][2 * hf] + b0;
                     const float v1 = acc[i][j][2 * hf + 1] + b1;
                     if ((l & 1) == 0) {
                       store_bf16x2(a2 + row * lda + col, fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
                     } else {
                       // rounded as the plain version rounds it (no FMA)
                       float& h0v = h[i][j][2 * hf];
                       float& h1v = h[i][j][2 * hf + 1];
                       h0v = __fadd_rn(__fmul_rn(v0, rs), h0v);
                       h1v = __fadd_rn(__fmul_rn(v1, rs), h1v);
                       store_bf16x2(a + row * lda + col, h0v, h1v);
                     }
                   }
                 }
             });

  // ---- optional global residual (+ h0), then the tail reads bf16(h) from a
  if (p.global_residual && n0 < W) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = 16 * i + g + 8 * hf, col = n0 + 8 * j + 2 * t;
          const float2 r = *reinterpret_cast<const float2*>(h0 + row * W + col);
          store_bf16x2(a + row * lda + col, h[i][j][2 * hf] + r.x,
                       h[i][j][2 * hf + 1] + r.y);
        }
  }
  __syncthreads();

  // ---- tail and sigmoid: one warp per (ray, output)
  for (int q = warp; q < TB * p.out_dim; q += NWARPS) {
    const int row = q / p.out_dim, j = q % p.out_dim;
    float acc = 0.0f;
    for (int n = lane; n < W; n += 32)
      acc += __bfloat162float(a[row * lda + n]) *
             __bfloat162float(p.tail_w[(size_t)j * W + n]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const long long ray = ray0 + row;
    if (lane == 0 && ray < p.B)
      p.out[ray * p.out_dim + j] = 1.0f / (1.0f + expf(-(acc + p.tail_b[j])));
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs; above 232448 the shape is
// not supported.
extern "C" long long r2l_forward_smem_bytes(int in_pad, int W) {
  return (long long)smem_layout(in_pad, W).total;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// Shapes are checked by the Python wrapper; the checks here guard the
// kernel's own assumptions.
extern "C" int r2l_forward_launch(const float* rays_o, const float* rays_d,
                                  const float* z, const void* head_w,
                                  const float* head_b, const void* body_w,
                                  const float* body_b, const void* tail_w,
                                  const float* tail_b, float* out, int B,
                                  int n_sample, int L, int in_pad, int W,
                                  int n_block, int out_dim, float res_scale,
                                  int global_residual, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = smem_layout(in_pad, W).total;
  if (W % WN != 0 || W > WN * NWARPS || in_pad % KC != 0 ||
      in_pad < 3 * n_sample * (2 * L + 1) || n_block < 1 || out_dim < 1 ||
      smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      r2l_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args p;
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.z = z;
  p.head_w = static_cast<const __nv_bfloat16*>(head_w);
  p.head_b = head_b;
  p.body_w = static_cast<const __nv_bfloat16*>(body_w);
  p.body_b = body_b;
  p.tail_w = static_cast<const __nv_bfloat16*>(tail_w);
  p.tail_b = tail_b;
  p.out = out;
  p.B = B;
  p.n_sample = n_sample;
  p.L = L;
  p.in_pad = in_pad;
  p.W = W;
  p.n_block = n_block;
  p.out_dim = out_dim;
  p.global_residual = global_residual;
  p.res_scale = res_scale;
  const unsigned blocks = (unsigned)((B + TB - 1) / TB);
  r2l_forward_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
