// The teacher field eval over one tile of TM = 128 points on mma.sync, the
// tile of the W8A8 field-eval kernel (nerf_int8.cu); the bf16 field-eval and
// whole-ray kernels run the wgmma tile of nerf_wgmma.cuh. The field is the
// reference NeRF MLP with the viewdir branch:
//
//   point x -> embed [x, sin(2^0 x), cos(2^0 x), ...] (63-d at L 10): y = x 2^l
//              exact in f32, then fast_sin(y + phase) of trig.cuh (degree 7)
//              with phase pi/2 for the cos columns; the identity columns pass
//              y through
//     -> layer 0, in_pad -> W, relu
//     -> layers 1..D-1, W -> W, relu; the layer after the skip adds the
//        embed's own product (x @ skip_x_w + h @ W, two products, one sum)
//     -> alpha head (bf16 h, f32 sums) and feature head (+ bias, rounded to
//        bf16, no relu)
//     -> view layer W -> W/2: feat @ views_h_w + hv_d[ray] + views_b, relu,
//        where hv_d = bf16(dirs_emb) @ views_d_w is computed once per ray of
//        the tile (view_rays: 27 x W/2 multiply-adds a ray, on the CUDA cores)
//     -> rgb head W/2 -> 3 on bf16(hv), f32 sums;
//        raw = (rgb + out_b[0:3], alpha + out_b[3]).
//
// One tile runs on a block of 8 warps (r2l_mma.cuh's NWARPS): each warp owns
// 32 output columns of all 128 rows, 128 f32 (or int32) accumulators a
// thread. The products are mma.sync: m16n8k16 bf16 -> f32, and for int8
// weights m16n8k32 s8 -> s32 (nerf_int8.cu), whose fragments hold the same
// bytes at the same places, so one ldmatrix addressing serves both. The
// weights do not fit the 227 KB of shared memory, so they stream from L2
// through a double buffer of 128-byte row chunks (64 bf16 or 128 int8 input
// columns) by cp.async, one chunk ahead of the math, as ONE continuous stream
// over every product of the tile (a table of segments), so that no layer
// starts with an empty pipeline. One activation tile [128, W] in shared
// memory (bf16, or int8 levels) is overwritten in place by each layer's
// epilogue, after a block barrier; the embed tile stays until the skip layer
// has read it, then holds the alpha and rgb partial sums, which the last body
// layer's and the view layer's epilogues sum from their registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "r2l_mma.cuh"
#include "trig.cuh"

namespace enerf {

constexpr int TM = 128;           // points per tile
constexpr int MT = TM / 16;       // 16-row tiles per tile
constexpr int MAX_SEGS = 16;      // product segments: D + 3 at most
constexpr int CHUNK_B = 2 * KC;   // bytes of each weight row a ring stage holds
constexpr int LDS_B = 2 * LDS;    // byte stride of a ring stage's rows
constexpr int PAD8 = 16;          // int8 activation rows: 16 B apart in banks

// One weight a product streams: [n, ldw bytes] ([out, in]), of which the
// bytes [0, kchunks * CHUNK_B) of each row are read, against the embed tile
// (a = 0) or the activation tile (a = 1). layer >= 0: an epilogue follows
// this segment; -1: the next segment adds to the same sums. s8: int8 weights
// against the int8 activation tile. keep: the epilogue leaves its sums in
// the registers for the next segment to add to.
struct Seg {
  const unsigned char* w;
  int ldw, kchunks, n, a, layer, s8, keep;
};

// One model's operands besides the streamed weights (bf16, [out, in]).
struct Field {
  const __nv_bfloat16* pts0_b;     // [W]
  const __nv_bfloat16* body_b;     // [D - 1, W]
  const __nv_bfloat16* feat_b;     // [W]
  const __nv_bfloat16* views_d_w;  // [half, ev]
  const __nv_bfloat16* views_b;    // [half]
  const __nv_bfloat16* rgb_w;      // [3, half]
  const __nv_bfloat16* alpha_w;    // [W]
  const float* out_b;              // [4]
  int in_ch, in_pad, ev, W, half, depth, n_segs;
  Seg segs[MAX_SEGS];
};

struct Layout {
  size_t x, act, ring, hvd, rowray, total;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) / 128 * 128; }

// Shared memory of one tile; nr rays' view contributions.
__host__ __device__ inline Layout field_layout(int in_pad, int W, int half, int nr) {
  const size_t xs = (size_t)TM * (in_pad + PAD) * 2;
  const size_t parts = (size_t)NWARPS * TM * 4 * 4;  // alpha [8][TM], rgb [8][TM][3]
  Layout l;
  l.x = 0;
  l.act = align128(xs > parts ? xs : parts);
  l.ring = l.act + align128((size_t)TM * (W + PAD) * 2);
  l.hvd = l.ring + (size_t)2 * W * LDS_B;
  l.rowray = l.hvd + align128((size_t)nr * half * 4);
  l.total = l.rowray + TM * 4;
  return l;
}

// The tile's shared memory.
struct Tile {
  __nv_bfloat16* X;     // embed [TM, in_pad + PAD]
  unsigned char* A;     // activations: bf16 [TM, W + PAD] or int8 [TM, W + PAD8]
  unsigned char* ring;  // 2 stages of [W, LDS_B] bytes
  float* hvd;           // [rays][half] view contributions
  int* rowray;          // [TM] row -> ray of hvd
  float* alpha_part;    // [NWARPS][TM], in the embed's region after the skip
  float* rgb_part;      // [NWARPS][TM][3]
};

__device__ inline Tile field_tile(unsigned char* smem, const Layout& l) {
  Tile t;
  t.X = reinterpret_cast<__nv_bfloat16*>(smem + l.x);
  t.A = smem + l.act;
  t.ring = smem + l.ring;
  t.hvd = reinterpret_cast<float*>(smem + l.hvd);
  t.rowray = reinterpret_cast<int*>(smem + l.rowray);
  t.alpha_part = reinterpret_cast<float*>(smem + l.x);
  t.rgb_part = t.alpha_part + NWARPS * TM;
  return t;
}

typedef float TileFrag[MT][NJ][4];

__device__ __forceinline__ void tile_zero(TileFrag& f) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[i][j][e] = 0.0f;
}

// sum of v over the 4 lanes of a quad (the lanes that share accumulator rows)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// c += a (16x32 s8, row) * b (32x8 s8, col) with s32 sums, kept as the bits
// of the f32 accumulators (the moves cost no instruction)
__device__ __forceinline__ void mma_s8(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  int d[4] = {__float_as_int(c[0]), __float_as_int(c[1]), __float_as_int(c[2]),
              __float_as_int(c[3])};
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __int_as_float(d[e]);
}

// The embed of a tile's points into X; pt(row, c) is coordinate c of the
// tile's point `row` < rows (rows past it embed as zeros).
template <class Pt>
__device__ __forceinline__ void embed_tile(__nv_bfloat16* X, int in_ch, int in_pad, int rows,
                                           Pt pt) {
  const int ldx = in_pad + PAD;
  for (int idx = threadIdx.x; idx < TM * in_pad; idx += NTHREADS) {
    const int row = idx / in_pad, e = idx % in_pad;
    float v = 0.0f;
    if (row < rows && e < in_ch) {
      const int grp = e / 3;
      const float x = pt(row, e % 3);
      if (grp == 0) {
        v = x;
      } else {
        const float y = __fmul_rn(x, (float)(1 << ((grp - 1) / 2)));  // exact
        // the sin columns add a zero phase, as the Pallas kernel does
        const float phase = ((grp - 1) % 2) ? (float)1.5707963267948966 : 0.0f;
        v = fast_sin(__fadd_rn(y, phase), 7);
      }
    }
    X[row * ldx + e] = __float2bfloat16_rn(v);
  }
}

// hvd[ray] = bf16(dirs_emb) @ views_d_w^T for nr rays; dir(ri) points at
// ray ri's ev embedded direction values.
template <class Dir>
__device__ __forceinline__ void view_rays(float* hvd, int nr, const Field& f, Dir dir) {
  for (int idx = threadIdx.x; idx < nr * f.half; idx += NTHREADS) {
    const int ri = idx / f.half, col = idx % f.half;
    const float* de = dir(ri);
    const __nv_bfloat16* wd = f.views_d_w + (size_t)col * f.ev;
    float s = 0.0f;
    for (int k = 0; k < f.ev; ++k)
      s = fmaf(__bfloat162float(__float2bfloat16_rn(de[k])), __bfloat162float(wd[k]), s);
    hvd[ri * f.half + col] = s;
  }
}

// Runs every product of f.segs over the tile: the weights stream through
// t.ring, and at the end of each segment with an epilogue, after a block
// barrier, each warp that owns columns calls epi(seg, acc). kS8 compiles the
// int8 products in. Ends with a block barrier.
template <bool kS8, class Epi>
__device__ __forceinline__ void field_products(const Field& f, const Tile& t, Epi epi) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = warp * WN;
  const int ldx = f.in_pad + PAD, lda = f.W + PAD, ldq = f.W + PAD8;
  const size_t stage = (size_t)f.W * LDS_B;

  int ls = 0, lk = 0, lc = 0;  // load cursor: segment, chunk, chunk count
  auto load_next = [&]() {
    if (ls < f.n_segs) {
      const Seg sg = f.segs[ls];
      const unsigned char* src = sg.w + (size_t)lk * CHUNK_B;
      unsigned char* dst = t.ring + (size_t)(lc & 1) * stage;
      for (int q = tid; q < sg.n * (CHUNK_B / 16); q += NTHREADS) {
        const int r = q / (CHUNK_B / 16), piece = q % (CHUNK_B / 16);
        cp_async16(dst + r * LDS_B + piece * 16, src + (size_t)r * sg.ldw + piece * 16);
      }
      if (++lk == sg.kchunks) {
        lk = 0;
        ++ls;
      }
    }
    ++lc;
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  load_next();
  TileFrag acc;
  tile_zero(acc);
  int cs = 0, ck = 0, cc = 0;  // compute cursor: segment, chunk, chunk count
  while (cs < f.n_segs) {
    cp_async_wait<0>();  // chunk cc has landed (this thread's copies) ...
    __syncthreads();     // ... everyone's, and the other stage is free
    load_next();
    const Seg sg = f.segs[cs];
    if (n0 < sg.n) {
      const unsigned char* st = t.ring + (size_t)(cc & 1) * stage;
      if (kS8 && sg.s8) {
#pragma unroll
        for (int kk = 0; kk < CHUNK_B; kk += 32) {
          // B for columns n0 + 16 jj .. + 15: matrices (n lo, k lo), (n lo,
          // k hi), (n hi, k lo), (n hi, k hi), 16 bytes of k each
          unsigned b[NJ / 2][4];
#pragma unroll
          for (int jj = 0; jj < NJ / 2; ++jj)
            ldmatrix_x4(b[jj], st + (n0 + 16 * jj + (lane / 16) * 8 + lane % 8) * LDS_B + kk +
                                   ((lane / 8) % 2) * 16);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            unsigned a[4];
            ldmatrix_x4(a, t.A + (16 * i + lane % 16) * ldq + ck * CHUNK_B + kk + (lane / 16) * 16);
#pragma unroll
            for (int jj = 0; jj < NJ / 2; ++jj) {
              mma_s8(acc[i][2 * jj], a, b[jj][0], b[jj][1]);
              mma_s8(acc[i][2 * jj + 1], a, b[jj][2], b[jj][3]);
            }
          }
        }
      } else {
        const __nv_bfloat16* Xa = sg.a ? reinterpret_cast<const __nv_bfloat16*>(t.A) : t.X;
        const int ld = sg.a ? lda : ldx;
        const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(st);
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          // B for columns n0 + 16 jj .. + 15: matrices (n lo, k lo), (n lo,
          // k hi), (n hi, k lo), (n hi, k hi)
          unsigned b[NJ / 2][4];
#pragma unroll
          for (int jj = 0; jj < NJ / 2; ++jj)
            ldmatrix_x4(b[jj], sb + (n0 + 16 * jj + (lane / 16) * 8 + lane % 8) * LDS + kk +
                                   ((lane / 8) % 2) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            unsigned a[4];
            ldmatrix_x4(a, Xa + (16 * i + lane % 16) * ld + ck * KC + kk + (lane / 16) * 8);
#pragma unroll
            for (int jj = 0; jj < NJ / 2; ++jj) {
              mma_bf16(acc[i][2 * jj], a, b[jj][0], b[jj][1]);
              mma_bf16(acc[i][2 * jj + 1], a, b[jj][2], b[jj][3]);
            }
          }
        }
      }
    }
    ++cc;
    if (++ck == sg.kchunks) {
      ck = 0;
      ++cs;
      if (sg.layer >= 0) {
        __syncthreads();  // no warp still reads the tile the epilogue overwrites
        if (n0 < sg.n) epi(sg, acc);
        if (!sg.keep) tile_zero(acc);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The bf16 field's epilogues, for the columns this warp owns: layer < D:
// relu(acc + b) -> the bf16 activation tile (the last body layer also sums
// its alpha partials); layer D: the feature head, bf16(acc + b); layer D + 1:
// the view layer, then the rgb head's partial sums.
__device__ __forceinline__ void bf16_epilogue(const Field& f, const Tile& t, int layer,
                                              TileFrag& acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, n0 = warp * WN;
  const int lda = f.W + PAD;
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(t.A);
  if (layer < f.depth) {  // relu(acc + b) -> bf16 activation tile
    const __nv_bfloat16* bias = layer == 0 ? f.pts0_b : f.body_b + (size_t)(layer - 1) * f.W;
    const bool last = layer == f.depth - 1;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float ap[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = 16 * i + g + 8 * hf;
          const __nv_bfloat162 h = __floats2bfloat162_rn(
              fmaxf(acc[i][j][2 * hf] + b0, 0.0f), fmaxf(acc[i][j][2 * hf + 1] + b1, 0.0f));
          *reinterpret_cast<__nv_bfloat162*>(A + row * lda + col) = h;
          if (last)
            ap[hf] += __low2float(h) * __bfloat162float(f.alpha_w[col]) +
                      __high2float(h) * __bfloat162float(f.alpha_w[col + 1]);
        }
      }
      if (last) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float s = quad_sum(ap[hf]);
          if (tq == 0) t.alpha_part[warp * TM + 16 * i + g + 8 * hf] = s;
        }
      }
    }
  } else if (layer == f.depth) {  // feature head: bf16(acc + b), no relu
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        const float b0 = __bfloat162float(f.feat_b[col]);
        const float b1 = __bfloat162float(f.feat_b[col + 1]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = 16 * i + g + 8 * hf;
          store_bf16x2(A + row * lda + col, acc[i][j][2 * hf] + b0, acc[i][j][2 * hf + 1] + b1);
        }
      }
  } else {  // view layer, then the rgb head's partial sums
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float rp[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 16 * i + g + 8 * hf;
        const float* hv_ray = t.hvd + t.rowray[row] * f.half;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
          // (feat @ W + hv_d[ray]) + b, in the Pallas kernel's order
          const float v0 = __fadd_rn(__fadd_rn(acc[i][j][2 * hf], hv_ray[col]),
                                     __bfloat162float(f.views_b[col]));
          const float v1 = __fadd_rn(__fadd_rn(acc[i][j][2 * hf + 1], hv_ray[col + 1]),
                                     __bfloat162float(f.views_b[col + 1]));
          const __nv_bfloat162 hv = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
#pragma unroll
          for (int c = 0; c < 3; ++c)
            rp[hf][c] += __low2float(hv) * __bfloat162float(f.rgb_w[c * f.half + col]) +
                         __high2float(hv) * __bfloat162float(f.rgb_w[c * f.half + col + 1]);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float s = quad_sum(rp[hf][c]);
          if (tq == 0) t.rgb_part[(warp * TM + 16 * i + g + 8 * hf) * 3 + c] = s;
        }
    }
  }
}

// raw = (rgb + out_b[0:3], alpha + out_b[3]) of the tile's rows < rows, from
// the partial sums: out(row, c, value) for c = 0..3 (rgb, then sigma).
template <class Out>
__device__ __forceinline__ void field_raw(const Field& f, const Tile& t, int rows, Out out) {
  const int wa = f.W / WN, wr = f.half / WN;
  for (int row = threadIdx.x; row < rows; row += NTHREADS) {
    float alpha = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f};
    for (int w = 0; w < wa; ++w) alpha += t.alpha_part[w * TM + row];
    for (int w = 0; w < wr; ++w)
      for (int c = 0; c < 3; ++c) rgb[c] += t.rgb_part[(w * TM + row) * 3 + c];
    for (int c = 0; c < 3; ++c) out(row, c, rgb[c] + f.out_b[c]);
    out(row, 3, alpha + f.out_b[3]);
  }
}

// Rays a tile of TM consecutive points can touch at S samples a ray.
inline int rays_per_tile(int S) {
  const int r = (TM - 1) / S + 2;
  return r < TM ? r : TM;
}

// Checks the shapes the tile code assumes; true when they hold.
inline bool field_shape_ok(int in_ch, int in_pad, int ev, int W, int depth, int skip) {
  return W % (2 * WN) == 0 && W <= WN * NWARPS && in_pad % KC == 0 && in_pad >= in_ch &&
         ev >= 1 && depth >= 2 && depth + 3 <= MAX_SEGS && skip >= 0 && skip + 1 < depth;
}

}  // namespace enerf
