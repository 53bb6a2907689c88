// Fused teacher field evaluation for Hopper (sm_90a): sample points and
// per-ray view directions in, raw (rgb, sigma) out.
//
// Replaces efficient_nerf_tpu/ops/pallas/nerf_forward.py::nerf_forward_fused
// (:314, its pallas_call at :410; the kernel body is _kernel :174-292), with
// the same fusion boundary: points and per-ray embedded directions go in, raw
// comes out, and no activation reaches device memory. One thread block takes
// a tile of TM = 128 consecutive points (point = ray * S + sample, so a tile
// may straddle rays) end to end:
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
//        the tile (27 x W/2 multiply-adds a ray, on the CUDA cores)
//     -> rgb head W/2 -> 3 on bf16(hv), f32 sums;
//        raw = (rgb + out_b[0:3], alpha + out_b[3]).
//
// Precision contract of the Pallas kernel: every product takes bf16 operands
// and sums in f32; the inner biases are bf16 values (pack_nerf_weights rounds
// them, as the Pallas pack does at :111-114) added in f32; out_b is f32. The
// embed rounds each operation as the plain version (ops/nerf_forward.py)
// does, so the two differ only by the order of the sums.
//
// Bound: 589,952 multiply-adds a point at W256 D8 (63x256 + 7x256^2 + 63x256
// skip rows + 256 alpha + 256^2 feature + 256x128 view + 128x3 rgb), 1.18
// MFLOP, against 12 bytes of point in and 16 of raw out: bound by tensor-core
// operations (a 400x400 frame at 64 + 192 samples is 48.3 TFLOP). The design:
//
//   * products are mma.sync m16n8k16 bf16 -> f32 (r2l_mma.cuh's fragments);
//     each warp owns 32 output columns of all 128 rows (128 f32 accumulators
//     a thread);
//   * the 1.19 MB of bf16 weights do not fit the 227 KB of shared memory, so
//     they stream from L2 through a double buffer of 64-input-column chunks
//     (cp.async, one chunk ahead of the math), as ONE continuous stream over
//     all the layers, so that no layer starts with an empty pipeline. A
//     128-point tile reads each weight once: about 127 FLOP per byte of L2;
//   * one bf16 activation tile [128, W] in shared memory is overwritten in
//     place by each layer's epilogue (after a block barrier); the embed tile
//     stays until the skip layer has read it, then holds the alpha and rgb
//     partial sums;
//   * the alpha head is summed from the last body layer's registers, the rgb
//     head from the view layer's, so neither h7 nor hv is stored again.
//
// wgmma, TMA, warp specialisation and clusters that share one weight stream
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "r2l_mma.cuh"
#include "trig.cuh"

namespace {

using namespace enerf;  // NWARPS, NTHREADS, WN, NJ, KC, PAD, LDS, MAX_SMEM, ...

constexpr int TM = 128;          // points per block
constexpr int MT = TM / 16;      // 16-row tiles per block
constexpr int MAX_SEGS = 16;     // product segments: D + 3 at most

// One weight a product streams: [n, ldw] bf16 ([out, in]), of which the
// columns [0, kchunks * KC) are read, against the embed tile (a = 0) or the
// activation tile (a = 1). layer >= 0: that layer's epilogue follows this
// segment; -1: the next segment adds to the same sums.
struct Seg {
  const __nv_bfloat16* w;
  int ldw, kchunks, n, a, layer;
};

struct Args {
  const float* pts;                 // point p, coordinate c at p * s_pt + c * s_c
  long long s_pt, s_c;
  const float* dirs;                // [N, ev] f32 embedded view directions
  const __nv_bfloat16* pts0_b;      // [W]
  const __nv_bfloat16* body_b;      // [D - 1, W]
  const __nv_bfloat16* feat_b;      // [W]
  const __nv_bfloat16* views_d_w;   // [half, ev]
  const __nv_bfloat16* views_b;     // [half]
  const __nv_bfloat16* rgb_w;       // [3, half]
  const __nv_bfloat16* alpha_w;     // [W]
  const float* out_b;               // [4]
  float* out;                       // raw of point p, channel c at p * o_pt + c * o_c
  long long o_pt, o_c, P;
  int S, in_ch, in_pad, ev, W, half, depth, nr_max, n_segs;
  Seg segs[MAX_SEGS];
};

struct Layout {
  size_t x, act, ring, hvd, rowray, total;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) / 128 * 128; }

__host__ __device__ inline Layout smem_layout(int in_pad, int W, int half, int nr_max) {
  const size_t xs = (size_t)TM * (in_pad + PAD) * 2;
  const size_t parts = (size_t)NWARPS * TM * 4 * 4;  // alpha [8][TM], rgb [8][TM][3]
  Layout l;
  l.x = 0;
  l.act = align128(xs > parts ? xs : parts);
  l.ring = l.act + align128((size_t)TM * (W + PAD) * 2);
  l.hvd = l.ring + (size_t)2 * W * LDS * 2;
  l.rowray = l.hvd + align128((size_t)nr_max * half * 4);
  l.total = l.rowray + TM * 4;
  return l;
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

// __grid_constant__: the epilogues and the segment table take the parameter's
// address without a local copy of it
__global__ void __launch_bounds__(NTHREADS, 1)
    nerf_forward_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = smem_layout(p.in_pad, p.W, p.half, p.nr_max);
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem + lay.x);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem + lay.act);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + lay.ring);
  float* hvd = reinterpret_cast<float*>(smem + lay.hvd);
  int* rowray = reinterpret_cast<int*>(smem + lay.rowray);
  // the embed's region, once the skip layer has read the embed
  float* alpha_part = reinterpret_cast<float*>(smem + lay.x);   // [NWARPS][TM]
  float* rgb_part = alpha_part + NWARPS * TM;                   // [NWARPS][TM][3]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, n0 = warp * WN;
  const int ldx = p.in_pad + PAD, lda = p.W + PAD;
  const size_t stage = (size_t)p.W * LDS;
  const long long p0 = (long long)blockIdx.x * TM;
  const long long p_end = p0 + TM < p.P ? p0 + TM : p.P;
  const long long r0 = p0 / p.S;
  const int nr = (int)((p_end - 1) / p.S - r0) + 1;

  // ---- the embed of the tile's points (rows past P embed as zeros)
  for (int idx = tid; idx < TM * p.in_pad; idx += NTHREADS) {
    const int row = idx / p.in_pad, e = idx % p.in_pad;
    const long long pt = p0 + row;
    float v = 0.0f;
    if (pt < p.P && e < p.in_ch) {
      const int grp = e / 3;
      const float x = p.pts[pt * p.s_pt + (e % 3) * p.s_c];
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
  // ---- the tile's rays: hv_d = bf16(dirs_emb) @ views_d_w^T once per ray
  for (int idx = tid; idx < nr * p.half; idx += NTHREADS) {
    const int ri = idx / p.half, col = idx % p.half;
    const float* de = p.dirs + (r0 + ri) * p.ev;
    const __nv_bfloat16* wd = p.views_d_w + (size_t)col * p.ev;
    float s = 0.0f;
    for (int k = 0; k < p.ev; ++k)
      s = fmaf(__bfloat162float(__float2bfloat16_rn(de[k])), __bfloat162float(wd[k]), s);
    hvd[ri * p.half + col] = s;
  }
  for (int row = tid; row < TM; row += NTHREADS) {
    const long long r = (p0 + row < p_end ? p0 + row : p_end - 1) / p.S;
    rowray[row] = (int)(r - r0);
  }
  // (the stream's first barrier orders these writes before their reads)

  // ---- one stream of weight chunks over every segment
  int ls = 0, lk = 0, lc = 0;  // load cursor: segment, chunk, chunk count
  auto load_next = [&]() {
    if (ls < p.n_segs) {
      const Seg sg = p.segs[ls];
      const __nv_bfloat16* src = sg.w + (size_t)lk * KC;
      __nv_bfloat16* dst = ring + (size_t)(lc & 1) * stage;
      for (int q = tid; q < sg.n * (KC / 8); q += NTHREADS) {
        const int r = q / (KC / 8), piece = q % (KC / 8);
        cp_async16(dst + r * LDS + piece * 8, src + (size_t)r * sg.ldw + piece * 8);
      }
      if (++lk == sg.kchunks) {
        lk = 0;
        ++ls;
      }
    }
    ++lc;
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  // epilogues, for the columns this warp owns; each runs after a block
  // barrier, so it may overwrite the activation tile in place
  auto epilogue = [&](int layer, TileFrag& acc) {
    if (layer < p.depth) {  // relu(acc + b) -> bf16 activation tile
      const __nv_bfloat16* bias =
          layer == 0 ? p.pts0_b : p.body_b + (size_t)(layer - 1) * p.W;
      const bool last = layer == p.depth - 1;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float ap[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = 16 * i + g + 8 * hf;
            const __nv_bfloat162 h = __floats2bfloat162_rn(
                fmaxf(acc[i][j][2 * hf] + b0, 0.0f), fmaxf(acc[i][j][2 * hf + 1] + b1, 0.0f));
            *reinterpret_cast<__nv_bfloat162*>(A + row * lda + col) = h;
            if (last)
              ap[hf] += __low2float(h) * __bfloat162float(p.alpha_w[col]) +
                        __high2float(h) * __bfloat162float(p.alpha_w[col + 1]);
          }
        }
        if (last) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float s = quad_sum(ap[hf]);
            if (t == 0) alpha_part[warp * TM + 16 * i + g + 8 * hf] = s;
          }
        }
      }
    } else if (layer == p.depth) {  // feature head: bf16(acc + b), no relu
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          const float b0 = __bfloat162float(p.feat_b[col]);
          const float b1 = __bfloat162float(p.feat_b[col + 1]);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = 16 * i + g + 8 * hf;
            store_bf16x2(A + row * lda + col, acc[i][j][2 * hf] + b0,
                         acc[i][j][2 * hf + 1] + b1);
          }
        }
    } else {  // view layer, then the rgb head's partial sums
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float rp[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = 16 * i + g + 8 * hf;
          const float* hv_ray = hvd + rowray[row] * p.half;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            // (feat @ W + hv_d[ray]) + b, in the Pallas kernel's order
            const float v0 = __fadd_rn(__fadd_rn(acc[i][j][2 * hf], hv_ray[col]),
                                       __bfloat162float(p.views_b[col]));
            const float v1 = __fadd_rn(__fadd_rn(acc[i][j][2 * hf + 1], hv_ray[col + 1]),
                                       __bfloat162float(p.views_b[col + 1]));
            const __nv_bfloat162 hv = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
#pragma unroll
            for (int c = 0; c < 3; ++c)
              rp[hf][c] += __low2float(hv) * __bfloat162float(p.rgb_w[c * p.half + col]) +
                           __high2float(hv) * __bfloat162float(p.rgb_w[c * p.half + col + 1]);
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float s = quad_sum(rp[hf][c]);
            if (t == 0) rgb_part[(warp * TM + 16 * i + g + 8 * hf) * 3 + c] = s;
          }
      }
    }
  };

  load_next();
  TileFrag acc;
  tile_zero(acc);
  int cs = 0, ck = 0, cc = 0;  // compute cursor: segment, chunk, chunk count
  while (cs < p.n_segs) {
    cp_async_wait<0>();  // chunk cc has landed (this thread's copies) ...
    __syncthreads();     // ... everyone's, and the other stage is free
    load_next();
    const Seg sg = p.segs[cs];
    if (n0 < sg.n) {
      const __nv_bfloat16* Xa = sg.a ? A : X;
      const int ld = sg.a ? lda : ldx;
      const __nv_bfloat16* st = ring + (size_t)(cc & 1) * stage;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        // B for columns n0 + 16 jj .. + 15: matrices (n lo, k lo), (n lo,
        // k hi), (n hi, k lo), (n hi, k hi)
        unsigned b[NJ / 2][4];
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj)
          ldmatrix_x4(b[jj], st + (n0 + 16 * jj + (lane / 16) * 8 + lane % 8) * LDS + kk +
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
    ++cc;
    if (++ck == sg.kchunks) {
      ck = 0;
      ++cs;
      if (sg.layer >= 0) {
        __syncthreads();  // no warp still reads the tile the epilogue overwrites
        if (n0 < sg.n) epilogue(sg.layer, acc);
        tile_zero(acc);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- raw = (rgb + out_b[0:3], alpha + out_b[3])
  const int wa = p.W / WN, wr = p.half / WN;
  for (int row = tid; row < TM; row += NTHREADS) {
    const long long pt = p0 + row;
    if (pt >= p.P) continue;
    float alpha = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f};
    for (int w = 0; w < wa; ++w) alpha += alpha_part[w * TM + row];
    for (int w = 0; w < wr; ++w)
      for (int c = 0; c < 3; ++c) rgb[c] += rgb_part[(w * TM + row) * 3 + c];
    for (int c = 0; c < 3; ++c) p.out[pt * p.o_pt + c * p.o_c] = rgb[c] + p.out_b[c];
    p.out[pt * p.o_pt + 3 * p.o_c] = alpha + p.out_b[3];
  }
}

}  // namespace

// Rays a tile of TM points can touch at S samples a ray.
static int rays_per_tile(int S) {
  const int r = (TM - 1) / S + 2;
  return r < TM ? r : TM;
}

// Bytes of dynamic shared memory one block needs; above 232448 the shape is
// not supported.
extern "C" long long nerf_forward_smem_bytes(int in_pad, int W, int S) {
  return (long long)smem_layout(in_pad, W, W / 2, rays_per_tile(S)).total;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// Shapes are checked by the Python wrapper; the checks here guard the
// kernel's own assumptions. Weights are nn.Linear's [out, in] layout, bf16:
// pts0_w and skip_x_w [W, in_pad] (zero past in_ch), body_w [D-1, W, W] (the
// hidden-state columns of the layer after the skip), feat_w [W, W],
// views_h_w [W/2, W].
extern "C" int nerf_forward_launch(
    const float* pts, long long s_pt, long long s_c, const float* dirs,
    const void* pts0_w, const void* pts0_b, const void* body_w, const void* body_b,
    const void* skip_x_w, const void* feat_w, const void* feat_b,
    const void* views_h_w, const void* views_d_w, const void* views_b,
    const void* rgb_w, const void* alpha_w, const float* out_b, float* out,
    long long o_pt, long long o_c, long long P, int S, int in_ch, int in_pad,
    int ev, int W, int depth, int skip, void* stream) {
  if (P <= 0) return 0;
  const int half = W / 2, nr_max = rays_per_tile(S);
  const size_t smem = smem_layout(in_pad, W, half, nr_max).total;
  if (W % (2 * WN) != 0 || W > WN * NWARPS || in_pad % KC != 0 || in_pad < in_ch ||
      S < 1 || ev < 1 || depth < 2 || depth + 3 > MAX_SEGS || skip < 0 ||
      skip + 1 >= depth || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      nerf_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  typedef const __nv_bfloat16* BP;
  Args a;
  a.pts = pts;
  a.s_pt = s_pt;
  a.s_c = s_c;
  a.dirs = dirs;
  a.pts0_b = static_cast<BP>(pts0_b);
  a.body_b = static_cast<BP>(body_b);
  a.feat_b = static_cast<BP>(feat_b);
  a.views_d_w = static_cast<BP>(views_d_w);
  a.views_b = static_cast<BP>(views_b);
  a.rgb_w = static_cast<BP>(rgb_w);
  a.alpha_w = static_cast<BP>(alpha_w);
  a.out_b = out_b;
  a.out = out;
  a.o_pt = o_pt;
  a.o_c = o_c;
  a.P = P;
  a.S = S;
  a.in_ch = in_ch;
  a.in_pad = in_pad;
  a.ev = ev;
  a.W = W;
  a.half = half;
  a.depth = depth;
  a.nr_max = nr_max;
  int n = 0;
  auto seg = [&](const void* w, int ldw, int k, int rows, int src, int layer) {
    a.segs[n++] = Seg{static_cast<BP>(w), ldw, k / KC, rows, src, layer};
  };
  seg(pts0_w, in_pad, in_pad, W, 0, 0);
  for (int i = 1; i < depth; ++i) {
    const bool after_skip = i == skip + 1;
    seg(static_cast<BP>(body_w) + (size_t)(i - 1) * W * W, W, W, W, 1, after_skip ? -1 : i);
    if (after_skip) seg(skip_x_w, in_pad, in_pad, W, 0, i);
  }
  seg(feat_w, W, W, W, 1, depth);
  seg(views_h_w, W, W, half, 1, depth + 1);
  a.n_segs = n;

  const unsigned blocks = (unsigned)((P + TM - 1) / TM);
  nerf_forward_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
