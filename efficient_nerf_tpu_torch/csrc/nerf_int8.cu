// W8A8 teacher field evaluation for Hopper (sm_90a): sample points and
// per-ray view directions in, raw (rgb, sigma) out, with the 7 hidden layers
// and the feature head on the int8 tensor cores.
//
// Replaces efficient_nerf_tpu/ops/pallas/nerf_int8.py::nerf_forward_int8
// (:210, its pallas_call at :306; the kernel body is _kernel :114-207). The
// tile, the embed, the weight stream, the view branch and the heads are
// those of nerf_field.cuh's bf16 path; only the body and the feature head
// differ. With per-output-row weight scales sw, static
// activation scales s[0..D-1] and the folded constants that the wrapper makes
// once per call (ops/nerf_int8.py::_fold, :245-259 of the Pallas wrapper):
//
//   h0  = relu(bf16 product of layer 0 + b0)          q = lv(h0 * inv_s0)
//   layer i < D-1 (folded, relu commutes with the positive next scale):
//         t = acc(q @ qw_i) * dqs_i + b_i [+ bf16 product of the skip rows]
//         q = lv(relu(t))
//   layer D-1 (unfolded): h = relu(acc * dqs + b [+ skip]); the alpha head on
//         bf16(h); q = lv(h * inv_s[D-1])
//   feat = bf16(acc(q @ feat_qw) * feat_dqs + feat_b)
//
// with dqs_i = s[i-1] * sw_i * fold_i, b_i = bias_i * fold_i, fold_i =
// 1 / s[i] (1 for the last layer), the skip rows' bf16 weights folded and
// rounded to bf16 again, lv(x) = clip(round(x), -127, 127).
//
// Rounding contract (r2l_int8.cu's, its header :24-37): an int32 sum of at
// most 256 products of |x| <= 127 is below 2^22, so its conversion to f32 is
// exact, and the plain version's f32 matmul of the same int8 values is exact
// in any order. The epilogues round each multiply and add on its own
// (__fmul_rn, __fadd_rn: no FMA contraction), round a level half to even and
// clip it at +-127, as torch.round and torch.clamp do. The kernel and its
// plain version (ops/nerf_int8.py::nerf_forward_int8_ref) then differ only
// where a bf16 product's f32 sum (layer 0, the skip rows, the heads, the view
// layer) lands an ulp apart and that ulp moves a value across a rounding
// boundary of the quantizer. The skip rows' product adds onto the layer's
// dequantized sum inside the tensor cores (t + sum, where the plain version
// sums the product first): an ulp of the same kind.
//
// Bound: per point 524,288 int8 multiply-adds (7 x 256^2 + 256^2) and 65,664
// bf16 (63 x 256 twice, 256, 256 x 128, 128 x 3) at W256 D8: at 1,979 TOPS and
// 989 TFLOP/s, a coarse chunk (2.10 M points) 1.111 + 0.278 = 1.39 ms, a fine
// chunk (6.29 M) 3.333 + 0.835 = 4.17 ms, a 400x400 frame 27.1 ms against
// the bf16 kernel's 48.9. Bound by operations. The design is the bf16
// kernel's: the int8 weights (0.5 MB a tile against 1.19 MB of bf16) stream
// through the same ring, 128 int8 input columns a chunk; the int8 activation
// tile is [128, W] bytes, half the bf16 tile, in the same region, which the
// feature head's bf16 output then takes over.
#include "int8_epilogue.cuh"
#include "nerf_field.cuh"

namespace {

using namespace enerf;

struct Args {
  const float* pts;                 // point p, coordinate c at p * s_pt + c * s_c
  long long s_pt, s_c;
  const float* dirs;                // [N, ev] f32 embedded view directions
  float* out;                       // raw of point p, channel c at p * o_pt + c * o_c
  long long o_pt, o_c, P;
  int S, nr_max;
  const float* body_dqs;            // [D - 1, W] folded dequantization scales
  const float* body_b;              // [D - 1, W] folded f32 biases
  const float* feat_dqs;            // [W]
  const float* feat_b;              // [W] f32
  const float* invs;                // [2]: 1 / s[0], 1 / s[D - 1]
  Field f;                          // the bf16 operands; body_b and feat_b unread
};

// an s32 sum kept in the bits of an f32 accumulator, as f32 (exact)
__device__ __forceinline__ float sum_to_f32(float bits) {
  return s32_to_f32(__float_as_int(bits));
}

__global__ void __launch_bounds__(NTHREADS, 1)
    nerf_int8_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Field& f = p.f;
  const Tile t = field_tile(smem, field_layout(f.in_pad, f.W, f.half, p.nr_max));
  const long long p0 = (long long)blockIdx.x * TM;
  const long long p_end = p0 + TM < p.P ? p0 + TM : p.P;
  const long long r0 = p0 / p.S;
  const int nr = (int)((p_end - 1) / p.S - r0) + 1;
  const int rows = (int)(p_end - p0);

  embed_tile(t.X, f.in_ch, f.in_pad, rows,
             [&](int row, int c) { return p.pts[(p0 + row) * p.s_pt + c * p.s_c]; });
  view_rays(t.hvd, nr, f, [&](int ri) { return p.dirs + (r0 + ri) * f.ev; });
  for (int row = threadIdx.x; row < TM; row += NTHREADS) {
    const long long r = (p0 + row < p_end ? p0 + row : p_end - 1) / p.S;
    t.rowray[row] = (int)(r - r0);
  }
  // (the stream's first barrier orders these writes before their reads)

  const int D = f.depth, W = f.W, ldq = W + PAD8, lda = W + PAD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, n0 = warp * WN;
  int8_t* Q = reinterpret_cast<int8_t*>(t.A);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(t.A);
  field_products<true>(f, t, [&](const Seg& sg, TileFrag& acc) {
    const int L = sg.layer;
    if (L == 0) {  // h0 = relu(acc + b0), q = lv(h0 * inv_s0)
      const float inv0 = p.invs[0];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
          const float b0 = __bfloat162float(f.pts0_b[col]), b1 = __bfloat162float(f.pts0_b[col + 1]);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            store_s8x2(Q + (16 * i + g + 8 * hf) * ldq + col,
                       __fmul_rn(fmaxf(acc[i][j][2 * hf] + b0, 0.0f), inv0),
                       __fmul_rn(fmaxf(acc[i][j][2 * hf + 1] + b1, 0.0f), inv0));
        }
      return;
    }
    if (L < D) {
      const float* dqs = p.body_dqs + (size_t)(L - 1) * W;
      const float* bias = p.body_b + (size_t)(L - 1) * W;
      if (sg.s8 && sg.keep) {  // t = acc * dqs + b, then the skip rows' product adds
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] = __fadd_rn(__fmul_rn(sum_to_f32(acc[i][j][e]), dqs[col + e % 2]),
                                       bias[col + e % 2]);
        }
        return;
      }
      const bool last = L == D - 1;
      const float finv = p.invs[1];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float ap[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a = acc[i][j][2 * hf + e];
              // the skip layer's sums are f32 already (dequantized, plus the
              // skip rows' product)
              v[e] = fmaxf(sg.s8 ? __fadd_rn(__fmul_rn(sum_to_f32(a), dqs[col + e]), bias[col + e])
                                 : a,
                           0.0f);
            }
            int8_t* q = Q + (16 * i + g + 8 * hf) * ldq + col;
            if (!last) {
              store_s8x2(q, v[0], v[1]);
            } else {
              const __nv_bfloat162 hb = __floats2bfloat162_rn(v[0], v[1]);
              ap[hf] += __low2float(hb) * __bfloat162float(f.alpha_w[col]) +
                        __high2float(hb) * __bfloat162float(f.alpha_w[col + 1]);
              store_s8x2(q, __fmul_rn(v[0], finv), __fmul_rn(v[1], finv));
            }
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
      return;
    }
    if (L == D) {  // feat = bf16(acc * feat_dqs + feat_b) over the int8 tile
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            store_bf16x2(A + (16 * i + g + 8 * hf) * lda + col,
                         __fadd_rn(__fmul_rn(sum_to_f32(acc[i][j][2 * hf]), p.feat_dqs[col]),
                                   p.feat_b[col]),
                         __fadd_rn(__fmul_rn(sum_to_f32(acc[i][j][2 * hf + 1]),
                                             p.feat_dqs[col + 1]),
                                   p.feat_b[col + 1]));
        }
      return;
    }
    bf16_epilogue(f, t, L, acc);  // the view layer and the rgb head
  });
  field_raw(f, t, rows, [&](int row, int c, float v) {
    p.out[(p0 + row) * p.o_pt + c * p.o_c] = v;
  });
}

}  // namespace

// Bytes of dynamic shared memory one block needs; above 232448 the shape is
// not supported.
extern "C" long long nerf_int8_smem_bytes(int in_pad, int W, int S) {
  return (long long)field_layout(in_pad, W, W / 2, rays_per_tile(S)).total;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// Shapes are checked by the Python wrapper; the checks here guard the
// kernel's own assumptions. body_qw [D-1, W, W] and feat_qw [W, W] are int8
// in nn.Linear's [out, in] layout; pts0_w and the folded skip_x_w [W, in_pad]
// and views_h_w [W/2, W] bf16.
extern "C" int nerf_int8_launch(
    const float* pts, long long s_pt, long long s_c, const float* dirs,
    const void* pts0_w, const void* pts0_b, const void* body_qw, const float* body_dqs,
    const float* body_b, const void* skip_x_w, const void* feat_qw, const float* feat_dqs,
    const float* feat_b, const float* invs, const void* views_h_w, const void* views_d_w,
    const void* views_b, const void* rgb_w, const void* alpha_w, const float* out_b,
    float* out, long long o_pt, long long o_c, long long P, int S, int in_ch, int in_pad,
    int ev, int W, int depth, int skip, void* stream) {
  if (P <= 0) return 0;
  const int half = W / 2, nr_max = rays_per_tile(S);
  const size_t smem = field_layout(in_pad, W, half, nr_max).total;
  if (!field_shape_ok(in_ch, in_pad, ev, W, depth, skip) || W % CHUNK_B != 0 || S < 1 ||
      smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      nerf_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  typedef const __nv_bfloat16* BP;
  typedef const unsigned char* UP;
  Args a;
  a.pts = pts;
  a.s_pt = s_pt;
  a.s_c = s_c;
  a.dirs = dirs;
  a.out = out;
  a.o_pt = o_pt;
  a.o_c = o_c;
  a.P = P;
  a.S = S;
  a.nr_max = nr_max;
  a.body_dqs = body_dqs;
  a.body_b = body_b;
  a.feat_dqs = feat_dqs;
  a.feat_b = feat_b;
  a.invs = invs;
  Field& f = a.f;
  f.pts0_b = static_cast<BP>(pts0_b);
  f.body_b = nullptr;
  f.feat_b = nullptr;
  f.views_d_w = static_cast<BP>(views_d_w);
  f.views_b = static_cast<BP>(views_b);
  f.rgb_w = static_cast<BP>(rgb_w);
  f.alpha_w = static_cast<BP>(alpha_w);
  f.out_b = out_b;
  f.in_ch = in_ch;
  f.in_pad = in_pad;
  f.ev = ev;
  f.W = W;
  f.half = half;
  f.depth = depth;
  int n = 0;
  // (weight, bytes of a row, rows, source tile, epilogue, int8, keep sums)
  auto seg = [&](const void* w, int k_bytes, int rows, int src, int layer, int s8, int keep) {
    f.segs[n++] = Seg{static_cast<UP>(w), k_bytes, k_bytes / CHUNK_B, rows, src, layer, s8, keep};
  };
  seg(pts0_w, 2 * in_pad, W, 0, 0, 0, 0);
  for (int i = 1; i < depth; ++i) {
    const bool after_skip = i == skip + 1;
    seg(static_cast<UP>(body_qw) + (size_t)(i - 1) * W * W, W, W, 1, i, 1, after_skip);
    if (after_skip) seg(skip_x_w, 2 * in_pad, W, 0, i, 0, 0);
  }
  seg(feat_qw, W, W, 1, depth, 1, 0);
  seg(views_h_w, 2 * W, half, 1, depth + 1, 0, 0);
  f.n_segs = n;

  const unsigned blocks = (unsigned)((P + TM - 1) / TM);
  nerf_int8_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
