// W8A8 R2L inference forward for Hopper (sm_90a): rays in, rgb out, with the
// 43-block residual body on the int8 tensor cores.
//
// Replaces efficient_nerf_tpu/ops/pallas/r2l_int8.py::r2l_forward_int8
// (:230, its pallas_call at :280), in both of its modes: static activation
// scales (act_scales given, the served mode) and per-row dynamic scales
// (act_scales absent). One thread block renders a tile of TB = 64 rays end to
// end. The embed, the bf16 head and the bf16 tail with its sigmoid are the
// bf16 kernel's (r2l_serve.cuh); only the body differs:
//
//   per block b (weights q0, q1: int8 [W, W] in nn.Linear's [out, in]
//   layout, per-output-row scales sw0, sw1; acc = int32 products):
//   static:   t  = acc(q(h * inv0) @ q0) * (dqs0 * inv1) + b0 * inv1
//             qg = clip(round(relu(t)))
//             g  = acc(qg @ q1) * dqs1 + b1
//   dynamic:  g  = relu(acc(q(h / sh) @ q0) * (sh * sw0) + b0)
//             g  = acc(q(g / sg) @ q1) * (sg * sw1) + b1
//   both:     h  = g * res_scale + h
//
// with dqs_j = act_scales[b, j] * sw_j and inv_j = 1 / act_scales[b, j]
// (_int8_block_math, :82-115), sh and sg per row: max(max |row|, 1e-12) / 127.
// q(x) = clip(round(x), -127, 127).
//
// Rounding contract, so that the body adds no noise of its own against the
// plain version (ops/r2l_int8.py::r2l_forward_int8_ref): an int32 sum of at
// most 256 products of |x| <= 127 is below 2^24, so its conversion to f32 is
// exact, and the plain version's f32 matmul of the same int8 values is exact
// in any summation order. The epilogues round each multiply and add on its own
// (__fmul_rn, __fadd_rn: no FMA contraction), round to a level half to even
// and clip it at +-127 (as torch.round and torch.clamp), divide with
// __fdiv_rn, and make the folded constants (dqs0 * inv1, b0 * inv1) in the
// plain version's order.
// Kernel and plain version then differ only where the bf16 head's f32 sum (or
// the tail's) lands one ulp apart and that ulp moves a value across a rounding
// boundary of the quantizer: one int8 level of one activation, which costs
// about act_scale * |w| in the next product and, through the residual stream,
// a few 1e-3 of the rgb at most (chip_smoke.py prints the share of such rays).
//
// Bound: at a 160,000-ray frame the body is 43 * 2 * 256^2 MAC * 2 * 160,000
// = 1.804 T int8 operations (0.911 ms at 1,979 TOPS) and the head 82.6 GFLOP
// of bf16 (0.084 ms at 989 TFLOP/s); 5.6 MB of int8 weights, 0.5 MB of bf16
// head and 36 B of rays and rgb a ray: bound by operations, 0.995 ms.
//
// Design, from the bf16 kernel (r2l_forward.cu, PERF.md):
//   * The residual stream h stays in f32 registers: warp w owns columns
//     [32w, 32w + 32) of all 64 rows for every layer. Only the int8 operand
//     tiles (q(h), q(g)) go through shared memory.
//   * Products are mma.sync m16n8k32 s8 x s8 -> s32. An int8 fragment of
//     m16n8k32 holds the same bytes at the same places as a bf16 fragment of
//     m16n8k16, so ldmatrix (b16) loads both operands from padded rows; the
//     [out, in] weight rows are K-contiguous, which is the `col` B operand.
//   * The int8 weights stream from L2 (5.6 MB) through a cp.async double
//     buffer of KC8 = 128 input bytes a row: the same 32 KB a stage as the
//     bf16 ring, for twice the contraction depth.
//   * Dynamic mode needs each row's max over all W columns, which the warps
//     share: a shuffle max inside each warp, then a [64 x 8] exchange of
//     partial maxima through shared memory and one block barrier, twice a
//     block. The scales are not kept in registers: each epilogue recomputes
//     them from the partial maxima.
//
// wgmma (s8), TMA and clusters are later work.
//
// Shared memory (W = 256, in_pad = 1024): region 1 holds the head's weight
// ring while the head runs, then q(h), q(g) (int8, 17 KB each), the partial
// row maxima and the bf16 tail input (33 KB); region 2 holds the embed (bf16,
// 129 KB), then h0 (f32, 64 KB) and the int8 weight ring (2 x 36 KB): 208 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "r2l_mma.cuh"
#include "r2l_serve.cuh"

namespace {

using namespace enerf;  // TB, NWARPS, ..., Frag, mma_stream, embed_tile, ...

constexpr int KC8 = 128;            // input bytes of a weight chunk's rows
constexpr int S8 = 2;               // int8 weight ring stages
constexpr int PAD8 = 16;            // int8 row padding: rows 16 B apart in banks
constexpr int LDS8 = KC8 + PAD8;    // row stride of a ring stage [W, KC8]

typedef int IFrag[RT][NJ][4];       // int32 accumulators, laid out as Frag

struct Args {
  const float* rays_o;             // [B, 3]
  const float* rays_d;             // [B, 3]
  const float* z;                  // [n_sample] depths
  const __nv_bfloat16* head_w;     // [W, in_pad], columns permuted, zero padded
  const float* head_b;             // [W]
  const int8_t* body_qw;           // [n_block, 2, W, W]  ([out, in])
  const float* body_sw;            // [n_block, 2, W] per-output-row weight scales
  const float* body_b;             // [n_block, 2, W]
  const float* act_scales;         // [n_block, 2] (static mode) or null (dynamic)
  const __nv_bfloat16* tail_w;     // [out_dim, W]
  const float* tail_b;             // [out_dim]
  float* out;                      // [B, out_dim]
  int B, n_sample, L, in_pad, W, n_block, out_dim, global_residual;
  float res_scale;
};

struct Layout {
  size_t head_ring, qh, qg, pmax_h, pmax_g, a, emb, h0, ring, total;
};

__host__ __device__ inline size_t max_sz(size_t x, size_t y) { return x > y ? x : y; }

__host__ __device__ inline Layout smem_layout(int in_pad, int W) {
  const size_t ldq = W + PAD8, lda = W + PAD, lde = in_pad + PAD;
  const size_t pmax = (size_t)TB * NWARPS * 4;
  Layout l;
  l.head_ring = 0;
  l.qh = 0;
  l.qg = l.qh + TB * ldq;
  l.pmax_h = l.qg + TB * ldq;
  l.pmax_g = l.pmax_h + pmax;
  l.a = l.pmax_g + pmax;
  const size_t r1 = max_sz((size_t)S * ring_stage_bytes(W), l.a + (size_t)TB * lda * 2);
  l.emb = r1;
  l.h0 = r1;
  l.ring = r1 + (size_t)TB * W * 4;
  l.total = r1 + max_sz((size_t)TB * lde * 2, (size_t)TB * W * 4 + (size_t)S8 * W * LDS8);
  return l;
}

// Input bytes of a weight chunk: KC8, or the largest of 64 and 32 that
// divides a narrower W.
__device__ __forceinline__ int chunk_bytes(int K) {
  return K % KC8 == 0 ? KC8 : (K % 64 == 0 ? 64 : 32);
}

// c += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulators
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Calls f(i, j, hf, row, col) for each pair of neighbouring values that the
// calling thread holds in a Frag: [i][j][2 hf] sits at (row, col) of the
// tile and [i][j][2 hf + 1] at (row, col + 1).
template <class F>
__device__ __forceinline__ void for_each_pair(F f) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n0 = (threadIdx.x / 32) * WN;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) f(i, j, hf, 16 * i + g + 8 * hf, n0 + 8 * j + 2 * t);
}

// Runs the 2 n_block int8 layers X_l[TB, W] @ W_l^T (W_l = Wg + l W W, int8
// [W, W], [out, in]), X_l = X0 for even l and X1 for odd l (int8 in shared
// memory, row stride ldx), int32 accumulation. The weights stream through
// `ring` in chunks of chunk_bytes(W) input bytes, S8 - 1 chunks ahead. At the
// end of layer l EVERY warp calls epi(l, acc, owns) (the dynamic mode's
// epilogues hold block barriers); owns says whether the warp owns columns.
// Ends with a block barrier.
template <class Epi>
__device__ __forceinline__ void mma_stream_s8(const int8_t* X0, const int8_t* X1, int ldx,
                                              const int8_t* Wg, int n_layers, int W,
                                              int8_t* ring, Epi epi) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kcb = chunk_bytes(W), kchunks = W / kcb, total = n_layers * kchunks;
  const bool owns = warp * WN < W;
  const int n0 = warp * WN;
  const size_t stage = (size_t)W * LDS8;

  auto load_chunk = [&](int c) {
    if (c < total) {
      const int l = c / kchunks, kc = c % kchunks;
      const int8_t* src = Wg + (size_t)l * W * W + (size_t)kc * kcb;
      int8_t* dst = ring + (size_t)(c % S8) * stage;
      const int pieces = kcb / 16;
      for (int q = tid; q < W * pieces; q += NTHREADS) {
        const int r = q / pieces, piece = q % pieces;
        cp_async16(dst + r * LDS8 + piece * 16, src + (size_t)r * W + piece * 16);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  for (int c = 0; c < S8 - 1; ++c) load_chunk(c);
  IFrag acc;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int c = 0; c < total; ++c) {
    cp_async_wait<S8 - 2>();  // chunk c has landed (this thread's copies) ...
    __syncthreads();         // ... everyone's, and stage (c - 1) % S8 is free
    load_chunk(c + S8 - 1);
    const int l = c / kchunks, kc = c % kchunks;
    if (owns) {
      const int8_t* X = (l & 1) ? X1 : X0;
      const int8_t* st = ring + (size_t)(c % S8) * stage;
#pragma unroll 4
      for (int kk = 0; kk < kcb; kk += 32) {
        // B for columns n0 + 16 jj .. + 15: matrices (n lo, k lo), (n lo,
        // k hi), (n hi, k lo), (n hi, k hi), 16 bytes of k each
        unsigned b[NJ / 2][4];
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj)
          ldmatrix_x4(b[jj], st + (n0 + 16 * jj + (lane / 16) * 8 + lane % 8) * LDS8 +
                                 kk + ((lane / 8) % 2) * 16);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          unsigned a[4];
          ldmatrix_x4(a, X + (size_t)(16 * i + lane % 16) * ldx + kc * kcb + kk +
                             (lane / 16) * 16);
#pragma unroll
          for (int jj = 0; jj < NJ / 2; ++jj) {
            mma_s8(acc[i][2 * jj], a, b[jj][0], b[jj][1]);
            mma_s8(acc[i][2 * jj + 1], a, b[jj][2], b[jj][3]);
          }
        }
      }
    }
    if (kc == kchunks - 1) {
      epi(l, acc, owns);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Dynamic mode: writes this warp's max of v(i, j, e) over its 32 columns for
// each of the 64 rows into pmax[row * NWARPS + warp], then a block barrier.
// Every warp calls it; warps that own no columns only join the barrier.
template <class V>
__device__ __forceinline__ void exchange_row_max(float* pmax, bool owns, V v) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if (owns) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float m = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          m = fmaxf(m, fmaxf(fabsf(v(i, j, 2 * hf)), fabsf(v(i, j, 2 * hf + 1))));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (t == 0) pmax[(16 * i + g + 8 * hf) * NWARPS + warp] = m;
      }
  }
  __syncthreads();
}

// s[i][hf] = the dynamic scale max(max |row|, 1e-12) / 127 of the thread's
// row 16 i + g + 8 hf, from the partial maxima of the nw warps that own
// columns (a max: exact in any order).
__device__ __forceinline__ void row_scales(float (&s)[RT][2], const float* pmax, int nw) {
  const int g = (threadIdx.x % 32) / 4;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* pm = pmax + (16 * i + g + 8 * hf) * NWARPS;
      float m = pm[0];
      for (int w = 1; w < nw; ++w) m = fmaxf(m, pm[w]);
      s[i][hf] = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
    }
}

template <bool kDynamic>
__global__ void __launch_bounds__(NTHREADS, 1) r2l_int8_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = smem_layout(p.in_pad, p.W);
  const int W = p.W, ldq = W + PAD8, lda = W + PAD, lde = p.in_pad + PAD;
  const int nw = W / WN;
  int8_t* qh = reinterpret_cast<int8_t*>(smem + lay.qh);
  int8_t* qg = reinterpret_cast<int8_t*>(smem + lay.qg);
  float* pmax_h = reinterpret_cast<float*>(smem + lay.pmax_h);
  float* pmax_g = reinterpret_cast<float*>(smem + lay.pmax_g);
  __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem + lay.a);
  __nv_bfloat16* emb = reinterpret_cast<__nv_bfloat16*>(smem + lay.emb);
  float* h0 = reinterpret_cast<float*>(smem + lay.h0);
  __nv_bfloat16* head_ring = reinterpret_cast<__nv_bfloat16*>(smem + lay.head_ring);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + lay.ring);
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4, n0 = warp * WN;
  const bool owns_cols = n0 < W;
  const long long ray0 = (long long)blockIdx.x * TB;
  // (the epilogues capture locals, never the kernel parameter itself)
  const float* body_sw = p.body_sw;
  const float* body_b = p.body_b;
  const float* act = p.act_scales;
  const float rs = p.res_scale;
  const int n_block = p.n_block;

  // ---- embed, then the bf16 head + relu into the residual stream h
  embed_tile(emb, lde, p.rays_o, p.rays_d, p.z, ray0, p.B, p.n_sample, p.L, p.in_pad);
  Frag h;
  head_relu(h, emb, lde, p.head_w, p.head_b, p.in_pad, W, head_ring);
  // (head_relu ends with a barrier: the embed and the head ring are dead)

  // qh = q(h * inv_s[b, 0]) (static) or q(h / sh) (dynamic), the input of
  // block b; called by every warp
  auto quantize_h = [&](int b, bool owns) {
    if (kDynamic) {
      exchange_row_max(pmax_h, owns, [&](int i, int j, int e) { return h[i][j][e]; });
      if (!owns) return;
      float s[RT][2];
      row_scales(s, pmax_h, nw);
      for_each_pair([&](int i, int j, int hf, int row, int col) {
        store_s8x2(qh + row * ldq + col, __fdiv_rn(h[i][j][2 * hf], s[i][hf]),
                   __fdiv_rn(h[i][j][2 * hf + 1], s[i][hf]));
      });
    } else if (owns) {
      const float inv = __frcp_rn(act[2 * b]);
      for_each_pair([&](int i, int j, int hf, int row, int col) {
        store_s8x2(qh + row * ldq + col, __fmul_rn(h[i][j][2 * hf], inv),
                   __fmul_rn(h[i][j][2 * hf + 1], inv));
      });
    }
  };

  // ---- h0 for the global residual, and q(h) for block 0
  if (owns_cols && p.global_residual)
    for_each_pair([&](int i, int j, int hf, int row, int col) {
      *reinterpret_cast<float2*>(h0 + row * W + col) =
          make_float2(h[i][j][2 * hf], h[i][j][2 * hf + 1]);
    });
  quantize_h(0, owns_cols);
  // (the body stream's first barrier orders these writes before its reads)

  // ---- the residual blocks, one stream of 2 n_block int8 layers:
  //   even l = 2b: qg = q(g), g from acc(qh @ q0)
  //   odd  l:      h = g * res_scale + h, g from acc(qg @ q1); qh = q(h)
  mma_stream_s8(qh, qg, ldq, p.body_qw, 2 * n_block, W, ring,
                [&](int l, IFrag& acc, bool owns) {
    const int b = l / 2;
    const float* sw = body_sw + (size_t)l * W;
    const float* bias = body_b + (size_t)l * W;
    if ((l & 1) == 0) {
      if (kDynamic) {
        // g = relu(acc * (sh * sw0) + b0), made twice: for the row max, and
        // after the exchange for its quantization
        float sh[RT][2];
        if (owns) row_scales(sh, pmax_h, nw);
        auto g_at = [&](int i, int j, int e) {
          const int col = n0 + 8 * j + 2 * t + (e & 1);
          const float dq = __fmul_rn(sh[i][e / 2], sw[col]);
          return fmaxf(__fadd_rn(__fmul_rn(s32_to_f32(acc[i][j][e]), dq), bias[col]), 0.0f);
        };
        exchange_row_max(pmax_g, owns, g_at);
        if (!owns) return;
        float sg[RT][2];
        row_scales(sg, pmax_g, nw);
        for_each_pair([&](int i, int j, int hf, int row, int col) {
          store_s8x2(qg + row * ldq + col, __fdiv_rn(g_at(i, j, 2 * hf), sg[i][hf]),
                     __fdiv_rn(g_at(i, j, 2 * hf + 1), sg[i][hf]));
        });
      } else if (owns) {
        // t = acc * (dqs0 * inv1) + b0 * inv1;  qg = q(relu(t))
        const float s0 = act[2 * b], inv1 = __frcp_rn(act[2 * b + 1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          float c0[2], c1[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            c0[e] = __fmul_rn(__fmul_rn(s0, sw[col + e]), inv1);
            c1[e] = __fmul_rn(bias[col + e], inv1);
          }
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              float q[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                q[e] = fmaxf(
                    __fadd_rn(__fmul_rn(s32_to_f32(acc[i][j][2 * hf + e]), c0[e]), c1[e]), 0.0f);
              store_s8x2(qg + (16 * i + (threadIdx.x % 32) / 4 + 8 * hf) * ldq + col, q[0],
                         q[1]);
            }
        }
      }
      return;
    }
    // odd layer: g = acc * dq1 + b1, dq1 = s1 * sw1 (s1 = act_scales[b, 1],
    // or the row's sg); h = g * res_scale + h
    if (owns) {
      float sg[RT][2];
      if (kDynamic) row_scales(sg, pmax_g, nw);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + 8 * j + 2 * t;
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float s1 = kDynamic ? sg[i][hf] : act[2 * b + 1];
              const float dq = __fmul_rn(s1, sw[col + e]);
              const float g =
                  __fadd_rn(__fmul_rn(s32_to_f32(acc[i][j][2 * hf + e]), dq), bias[col + e]);
              float& hv = h[i][j][2 * hf + e];
              hv = __fadd_rn(__fmul_rn(g, rs), hv);
            }
      }
    }
    if (b + 1 < n_block) quantize_h(b + 1, owns);  // the last block's h goes to the tail
  });

  // ---- a = bf16(h [+ h0]) for the tail (the stream ended with a barrier)
  if (owns_cols)
    for_each_pair([&](int i, int j, int hf, int row, int col) {
      float x = h[i][j][2 * hf], y = h[i][j][2 * hf + 1];
      if (p.global_residual) {
        const float2 r = *reinterpret_cast<const float2*>(h0 + row * W + col);
        x += r.x;
        y += r.y;
      }
      store_bf16x2(a + row * lda + col, x, y);
    });
  __syncthreads();
  tail_sigmoid(a, lda, p.tail_w, p.tail_b, p.out, ray0, p.B, W, p.out_dim);
}

}  // namespace

// Bytes of dynamic shared memory one block needs; above 232448 the shape is
// not supported.
extern "C" long long r2l_int8_smem_bytes(int in_pad, int W) {
  return (long long)smem_layout(in_pad, W).total;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// act_scales null selects the dynamic per-row mode. Shapes are checked by the
// Python wrapper; the checks here guard the kernel's own assumptions.
extern "C" int r2l_int8_launch(const float* rays_o, const float* rays_d, const float* z,
                               const void* head_w, const float* head_b,
                               const void* body_qw, const float* body_sw,
                               const float* body_b, const float* act_scales,
                               const void* tail_w, const float* tail_b, float* out,
                               int B, int n_sample, int L, int in_pad, int W,
                               int n_block, int out_dim, float res_scale,
                               int global_residual, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = smem_layout(in_pad, W).total;
  if (W % WN != 0 || W > WN * NWARPS || in_pad % KC != 0 ||
      in_pad < 3 * n_sample * (2 * L + 1) || n_block < 1 || out_dim < 1 ||
      smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.z = z;
  p.head_w = static_cast<const __nv_bfloat16*>(head_w);
  p.head_b = head_b;
  p.body_qw = static_cast<const int8_t*>(body_qw);
  p.body_sw = body_sw;
  p.body_b = body_b;
  p.act_scales = act_scales;
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
  const auto kernel = act_scales ? r2l_int8_kernel<false> : r2l_int8_kernel<true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
