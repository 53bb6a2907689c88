// The whole-ray teacher render for Hopper (sm_90a): rays in, the eight
// per-ray RenderResult fields out, one launch a chunk.
//
// Replaces efficient_nerf_tpu/ops/pallas/nerf_frame.py::nerf_render_rays_fused
// (:394, its pallas_call at :479; the kernel body is _kernel :147-376), with
// its fusion boundary: rays, their embedded view directions and the constant
// depths go in, rgb, disp, acc, depth, rgb0, disp0, acc0 and z_std come out,
// and nothing between (points, raw fields, weights, fine depths) reaches
// device memory. One block takes R rays (R even: at 64 coarse samples two
// rays fill one 128-point tile, and at 192 they fill three):
//
//   1. points o + z d, one rounding each (__fmul_rn, then __fadd_rn: the
//      composed path's separate multiply and add; an FMA would move a point
//      by an ulp, which the 2^9 frequency of the embed amplifies);
//   2. the coarse field at the S_c constant depths, tile by tile through
//      nerf_field.cuh (the bf16 field of nerf_forward.cu), into a shared
//      raw [R, S_c, 4];
//   3. the composite, one thread a ray: dists x |d| with a 1e10 last
//      interval, alpha = 1 - exp(-relu(sigma) dist), the transmittance as a
//      sequential exclusive product of 1 - alpha + 1e-10, sigmoid rgb, the
//      white background, disp = 1 / max(1e-10, depth / acc), NaN where acc
//      is 0 (as torch.maximum keeps a NaN);
//   4. the inverse CDF of the interior weights (pdf_walk of sample_pdf.cuh,
//      bit for bit the sampler kernel's walk) and z_std (ddof 0);
//   5. a serial two-pointer merge of the sorted coarse and fine depths: the
//      sorted list that the Pallas kernel's bitonic network gives (a lane
//      trick of the TPU);
//   6. the fine field at the S_c + S_f merged depths, with the fine model's
//      weights; 7. its composite; 8. the eight fields.
//
// The per-ray glue keeps its state in shared memory (raw, weights, depths,
// the coarse results): the field's tile already takes all 255 registers.
//
// Bound: the two field evals' operations, as the field-eval kernel's (10.008
// ms a 32,768-ray chunk at W256 D8, 64 + 128 samples, 48.87 ms a 400x400
// frame); about 150 bytes a ray in and 48 out. The glue is O(S) a ray on one
// thread, small beside the 4 tiles of field eval a block runs at R = 2.
#include "nerf_field.cuh"
#include "sample_pdf.cuh"

namespace {

using namespace enerf;

constexpr int OUT_CH = 12;  // rgb(3) disp acc depth rgb0(3) disp0 acc0 z_std

struct Args {
  const float* rays_o;   // [N, 3]
  const float* rays_d;   // [N, 3]
  const float* dirs;     // [N, ev] embedded view directions
  const float* zc;       // [S_c] coarse depths
  const float* bins;     // [S_c - 1] their midpoints
  const float* u;        // [S_f] levels
  float* out;            // [N, OUT_CH]
  float* taps_w;         // [N, S_c] coarse weights, or null
  float* taps_z;         // [N, S_f] fine depths, or null
  long long N;
  int R, S_c, S_f, white_bkgd;
  Field fc, ff;          // coarse and fine models (the same shapes)
};

// Offsets (bytes) of the glue's arrays after the tile's shared memory.
struct Glue {
  size_t o, d, nd, zc, bins, u, zall, raw, wc, zf, res, total;
};

__host__ __device__ inline Glue glue_layout(size_t base, int R, int S_c, int S_f) {
  const size_t S = (size_t)S_c + S_f;
  Glue g;
  g.o = base;
  g.d = g.o + (size_t)R * 3 * 4;
  g.nd = g.d + (size_t)R * 3 * 4;
  g.zc = g.nd + (size_t)R * 4;
  g.bins = g.zc + (size_t)S_c * 4;
  g.u = g.bins + (size_t)(S_c - 1) * 4;
  g.zall = g.u + (size_t)S_f * 4;
  g.raw = g.zall + (size_t)R * S * 4;
  g.wc = g.raw + (size_t)R * S * 4 * 4;
  g.zf = g.wc + (size_t)R * S_c * 4;
  g.res = g.zf + (size_t)R * S_f * 4;
  g.total = g.res + (size_t)R * OUT_CH * 4;
  return g;
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// One ray's composite: raw [S][4] at depths z [S] -> res = (rgb, disp, acc,
// depth); the weights into w when it is not null.
__device__ void composite(const float* raw, const float* z, int S, float normd, bool white,
                          float* w, float (&res)[6]) {
  float T = 1.0f, acc = 0.0f, dep = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < S; ++s) {
    const float dz = s + 1 < S ? __fsub_rn(z[s + 1], z[s]) : 1e10f;
    const float sigma = fmaxf(raw[4 * s + 3], 0.0f);
    const float alpha = __fsub_rn(1.0f, expf(__fmul_rn(-sigma, __fmul_rn(dz, normd))));
    const float ws = __fmul_rn(alpha, T);
    T = __fmul_rn(T, __fadd_rn(__fsub_rn(1.0f, alpha), 1e-10f));
    if (w) w[s] = ws;
    for (int c = 0; c < 3; ++c) rgb[c] = __fadd_rn(rgb[c], __fmul_rn(ws, sigmoid(raw[4 * s + c])));
    dep = __fadd_rn(dep, __fmul_rn(ws, z[s]));
    acc = __fadd_rn(acc, ws);
  }
  const float ratio = __fdiv_rn(dep, acc);
  const float m = ratio != ratio ? ratio : fmaxf(1e-10f, ratio);
  for (int c = 0; c < 3; ++c) res[c] = white ? __fadd_rn(rgb[c], __fsub_rn(1.0f, acc)) : rgb[c];
  res[3] = __fdiv_rn(1.0f, m);
  res[4] = acc;
  res[5] = dep;
}

__global__ void __launch_bounds__(NTHREADS, 1)
    nerf_frame_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = p.R, S_c = p.S_c, S_f = p.S_f, S = S_c + S_f;
  const Layout lay = field_layout(p.fc.in_pad, p.fc.W, p.fc.half, R);
  const Tile t = field_tile(smem, lay);
  const Glue gl = glue_layout(lay.total, R, S_c, S_f);
  float* so = reinterpret_cast<float*>(smem + gl.o);
  float* sd = reinterpret_cast<float*>(smem + gl.d);
  float* snd = reinterpret_cast<float*>(smem + gl.nd);
  float* szc = reinterpret_cast<float*>(smem + gl.zc);
  float* sbins = reinterpret_cast<float*>(smem + gl.bins);
  float* su = reinterpret_cast<float*>(smem + gl.u);
  float* szall = reinterpret_cast<float*>(smem + gl.zall);
  float* sraw = reinterpret_cast<float*>(smem + gl.raw);
  float* swc = reinterpret_cast<float*>(smem + gl.wc);
  float* szf = reinterpret_cast<float*>(smem + gl.zf);
  float* sres = reinterpret_cast<float*>(smem + gl.res);
  const int tid = threadIdx.x;
  const long long ray0 = (long long)blockIdx.x * R;

  // the block's rays; a ragged block's missing rays are unit-z rays from the
  // origin (the Pallas wrapper's pad rays), computed and never written
  for (int r = tid; r < R; r += NTHREADS) {
    const long long ray = ray0 + r;
    float d[3] = {0.0f, 0.0f, 1.0f};
    for (int c = 0; c < 3; ++c) {
      so[r * 3 + c] = ray < p.N ? p.rays_o[ray * 3 + c] : 0.0f;
      if (ray < p.N) d[c] = p.rays_d[ray * 3 + c];
      sd[r * 3 + c] = d[c];
    }
    snd[r] = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                                  __fmul_rn(d[2], d[2])));
  }
  for (int i = tid; i < S_c; i += NTHREADS) szc[i] = p.zc[i];
  for (int i = tid; i < S_c - 1; i += NTHREADS) sbins[i] = p.bins[i];
  for (int i = tid; i < S_f; i += NTHREADS) su[i] = p.u[i];
  __syncthreads();

  const long long last = p.N - 1;
  auto dir = [&](int ri) {
    const long long ray = ray0 + ri < p.N ? ray0 + ri : last;
    return p.dirs + ray * p.fc.ev;
  };
  // one field eval over the block's rays at S_p depths each (z + r * z_stride
  // holds ray r's) -> sraw [R, S_p, 4]
  auto pass = [&](const Field& f, int S_p, const float* z, int z_stride) {
    view_rays(t.hvd, R, f, dir);
    const int P = R * S_p;
    for (int p0 = 0; p0 < P; p0 += TM) {
      const int rows = P - p0 < TM ? P - p0 : TM;
      for (int row = tid; row < TM; row += NTHREADS)
        t.rowray[row] = (p0 + (row < rows ? row : rows - 1)) / S_p;
      embed_tile(t.X, f.in_ch, f.in_pad, rows, [&](int row, int c) {
        const int pt = p0 + row, r = pt / S_p;
        return __fadd_rn(so[r * 3 + c], __fmul_rn(sd[r * 3 + c], z[r * z_stride + pt % S_p]));
      });
      field_products<false>(f, t, [&](const Seg& sg, TileFrag& acc) {
        bf16_epilogue(f, t, sg.layer, acc);
      });
      field_raw(f, t, rows, [&](int row, int c, float v) { sraw[(p0 + row) * 4 + c] = v; });
      __syncthreads();  // the partial sums are read before the next embed
    }
  };

  pass(p.fc, S_c, szc, 0);
  // coarse composite, inverse CDF, z_std and merge: one thread a ray
  for (int r = tid; r < R; r += NTHREADS) {
    float res[6];
    composite(sraw + (size_t)r * S_c * 4, szc, S_c, snd[r], p.white_bkgd, swc + r * S_c, res);
    float* out = sres + r * OUT_CH;
    for (int c = 0; c < 3; ++c) out[6 + c] = res[c];
    out[9] = res[3];
    out[10] = res[4];
    float* zf = szf + r * S_f;
    pdf_walk(sbins, swc + r * S_c + 1, S_c - 1, su, S_f, zf);
    float sum = 0.0f, ss = 0.0f;
    for (int j = 0; j < S_f; ++j) sum = __fadd_rn(sum, zf[j]);
    const float mean = __fdiv_rn(sum, (float)S_f);
    for (int j = 0; j < S_f; ++j) {
      const float dz = __fsub_rn(zf[j], mean);
      ss = __fadd_rn(ss, __fmul_rn(dz, dz));
    }
    out[11] = __fsqrt_rn(__fdiv_rn(ss, (float)S_f));
    float* za = szall + r * S;
    for (int k = 0, a = 0, b = 0; k < S; ++k)
      za[k] = (b >= S_f || (a < S_c && szc[a] <= zf[b])) ? szc[a++] : zf[b++];
  }
  __syncthreads();

  pass(p.ff, S, szall, S);
  for (int r = tid; r < R; r += NTHREADS) {
    float res[6];
    composite(sraw + (size_t)r * S * 4, szall + r * S, S, snd[r], p.white_bkgd, nullptr, res);
    float* out = sres + r * OUT_CH;
    for (int c = 0; c < 6; ++c) out[c] = res[c];
    const long long ray = ray0 + r;
    if (ray < p.N) {
      for (int c = 0; c < OUT_CH; ++c) p.out[ray * OUT_CH + c] = out[c];
      if (p.taps_w)
        for (int s = 0; s < S_c; ++s) p.taps_w[ray * S_c + s] = swc[r * S_c + s];
      if (p.taps_z)
        for (int j = 0; j < S_f; ++j) p.taps_z[ray * S_f + j] = szf[r * S_f + j];
    }
  }
}

// One model's operands in ops/nerf_forward.py's _OPERANDS order (pts0_w,
// pts0_b, body_w, body_b, skip_x_w, feat_w, feat_b, views_h_w, views_d_w,
// views_b, rgb_w, alpha_w), then out_b.
void fill_field(Field& f, const void* const* w, int in_ch, int in_pad, int ev, int W,
                int depth, int skip) {
  typedef const __nv_bfloat16* BP;
  f.pts0_b = static_cast<BP>(w[1]);
  f.body_b = static_cast<BP>(w[3]);
  f.feat_b = static_cast<BP>(w[6]);
  f.views_d_w = static_cast<BP>(w[8]);
  f.views_b = static_cast<BP>(w[9]);
  f.rgb_w = static_cast<BP>(w[10]);
  f.alpha_w = static_cast<BP>(w[11]);
  f.out_b = static_cast<const float*>(w[12]);
  f.in_ch = in_ch;
  f.in_pad = in_pad;
  f.ev = ev;
  f.W = W;
  f.half = W / 2;
  f.depth = depth;
  f.n_segs = bf16_segments(f.segs, w[0], w[2], w[4], w[5], w[7], in_pad, W, depth, skip);
}

}  // namespace

// Bytes of dynamic shared memory one block of R rays needs; above 232448
// the shape is not supported.
extern "C" long long nerf_frame_smem_bytes(int in_pad, int W, int R, int S_c, int S_f) {
  return (long long)glue_layout(field_layout(in_pad, W, W / 2, R).total, R, S_c, S_f).total;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// wc, wf: the coarse and the fine model's 13 operands (fill_field's order),
// with the same shapes; taps_w / taps_z null unless the caller asks for the
// coarse weights and fine depths. Shapes are checked by the Python wrapper.
extern "C" int nerf_frame_launch(const float* rays_o, const float* rays_d, const float* dirs,
                                 const float* zc, const float* bins, const float* u, float* out,
                                 float* taps_w, float* taps_z, long long N, int R, int S_c,
                                 int S_f, int white_bkgd, const void* const* wc,
                                 const void* const* wf, int in_ch, int in_pad, int ev, int W,
                                 int depth, int skip_c, int skip_f, void* stream) {
  if (N <= 0) return 0;
  const size_t smem = (size_t)nerf_frame_smem_bytes(in_pad, W, R, S_c, S_f);
  if (!field_shape_ok(in_ch, in_pad, ev, W, depth, skip_c) ||
      !field_shape_ok(in_ch, in_pad, ev, W, depth, skip_f) || R < 1 || R > NTHREADS ||
      S_c < 3 || S_f < 1 || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      nerf_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.rays_o = rays_o;
  a.rays_d = rays_d;
  a.dirs = dirs;
  a.zc = zc;
  a.bins = bins;
  a.u = u;
  a.out = out;
  a.taps_w = taps_w;
  a.taps_z = taps_z;
  a.N = N;
  a.R = R;
  a.S_c = S_c;
  a.S_f = S_f;
  a.white_bkgd = white_bkgd;
  fill_field(a.fc, wc, in_ch, in_pad, ev, W, depth, skip_c);
  fill_field(a.ff, wf, in_ch, in_pad, ev, W, depth, skip_f);
  const unsigned blocks = (unsigned)((N + R - 1) / R);
  nerf_frame_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
