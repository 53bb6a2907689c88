// The whole-ray teacher render for Hopper (sm_90a): rays in, the eight
// per-ray RenderResult fields out, one launch a chunk.
//
// Replaces efficient_nerf_tpu/ops/pallas/nerf_frame.py::nerf_render_rays_fused
// (:394, its pallas_call at :479; the kernel body is _kernel :147-376), with
// its fusion boundary: rays, their embedded view directions and the constant
// depths go in, rgb, disp, acc, depth, rgb0, disp0, acc0 and z_std come out,
// and nothing between (points, raw fields, weights, fine depths) reaches
// device memory. A block takes groups of R rays (the wrapper's R: an even
// count whose coarse samples fill two 128-point tiles, 4 at 64 samples),
// one after another (persistent blocks, one per SM at W256):
//
//   1. points o + z d, one rounding each (__fmul_rn, then __fadd_rn: the
//      composed path's separate multiply and add; an FMA would move a point
//      by an ulp, which the 2^9 frequency of the embed amplifies);
//   2. the coarse field at the S_c constant depths, tile by tile through
//      the tile of nerf_wgmma.cuh (the field-eval kernel's, nerf_forward.cu),
//      into a shared raw [R, S_c, 4];
//   3. the composite, one warp a ray: each lane takes S / 32 consecutive
//      samples (dists x |d| with a 1e10 last interval, alpha = 1 - exp(
//      -relu(sigma) dist), sigmoid rgb), the transmittance is the exclusive
//      product of 1 - alpha + 1e-10 (within a lane in order, across lanes by
//      a shuffle scan), the sums are shuffle sums; the white background,
//      disp = 1 / max(1e-10, depth / acc), NaN where acc is 0 (as
//      torch.maximum keeps a NaN);
//   4. the inverse CDF of the interior weights by the sampler kernel's
//      warp routine (pdf_warp of sample_pdf.cuh: the CDF summed in order,
//      the levels spread over the lanes), so the fine depths are the
//      sampler kernel's bit for bit, and z_std (ddof 0);
//   5. the merge of the sorted coarse and fine depths by rank: each depth's
//      place is its index plus the count of the other list's depths before
//      it (coarse first on a tie, as a two-pointer merge takes them): the
//      sorted list that the Pallas kernel's bitonic network gives;
//   6. the fine field at the S_c + S_f merged depths, with the fine model's
//      weights; 7. its composite; 8. the eight fields.
//
// Bound: the two field evals' operations, as the field-eval kernel's (10.008
// ms a 32,768-ray chunk at W256 D8, 64 + 128 samples, 48.87 ms a 400x400
// frame); about 150 bytes a ray in and 48 out. The weight stream runs on
// from the coarse tiles into the fine ones and into the next group's (the
// ring loads the next model's first chunks while the glue runs); the glue is
// O(S) a ray spread over a warp, small beside the 8 tiles of field eval a
// group takes at R = 4.
#include <string.h>

#include "nerf_wgmma.cuh"
#include "sample_pdf.cuh"

namespace {

using namespace enerf;

constexpr int OUT_CH = 12;  // rgb(3) disp acc depth rgb0(3) disp0 acc0 z_std
constexpr unsigned FULL = 0xffffffffu;

// Offsets (bytes) of the glue's arrays in the tile's extra region.
struct Glue {
  size_t o, d, nd, zc, bins, u, zall, raw, wc, zf, cdf, res, total;
};

inline Glue glue_layout(int R, int S_c, int S_f) {
  const size_t S = (size_t)S_c + S_f;
  Glue g;
  g.o = 0;
  g.d = g.o + (size_t)R * 3 * 4;
  g.nd = g.d + (size_t)R * 3 * 4;
  g.zc = g.nd + (size_t)R * 4;
  g.bins = g.zc + (size_t)S_c * 4;
  g.u = g.bins + (size_t)(S_c - 1) * 4;
  g.zall = g.u + (size_t)S_f * 4;
  g.raw = g.zall + (size_t)R * S * 4;
  g.wc = g.raw + (size_t)R * S * 4 * 4;
  g.zf = g.wc + (size_t)R * S_c * 4;
  g.cdf = g.zf + (size_t)R * S_f * 4;
  g.res = g.cdf + (size_t)R * S_c * 4;
  g.total = g.res + (size_t)R * OUT_CH * 4;
  return g;
}

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
  // the glue's and the tile's shared memory, made by the host and read from
  // the parameters where used: across the field tiles this kernel's
  // registers are full, and offsets computed on the device spilled (PERF.md)
  Glue gl;
  nw::Layout lay;
  nw::Shape s;
  nw::Model fc, ff;      // coarse and fine models (the same shapes)
};

inline nw::Layout frame_layout(const nw::Shape& s, int R, int S_c, int S_f) {
  return nw::layout(s, (size_t)R * (s.W / 2) * 4, glue_layout(R, S_c, S_f).total);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// One ray's composite by one warp: raw [S][4] at depths z [S] -> res = (rgb,
// disp, acc, depth) in every lane; the weights into w when it is not null.
__device__ void composite_warp(const float* raw, const float* z, int S, float normd, bool white,
                               float* w, float (&res)[6]) {
  const int lane = threadIdx.x % 32, per = (S + 31) / 32;
  const int lo = lane * per < S ? lane * per : S, hi = lo + per < S ? lo + per : S;
  auto alpha_of = [&](int s) {
    const float dz = s + 1 < S ? __fsub_rn(z[s + 1], z[s]) : 1e10f;
    const float sigma = fmaxf(raw[4 * s + 3], 0.0f);
    return __fsub_rn(1.0f, expf(__fmul_rn(-sigma, __fmul_rn(dz, normd))));
  };
  float prod = 1.0f;
  for (int s = lo; s < hi; ++s) prod = __fmul_rn(prod, __fadd_rn(__fsub_rn(1.0f, alpha_of(s)), 1e-10f));
  // the transmittance before this lane's samples: the product of the lanes
  // before it
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(FULL, prod, off);
    if (lane >= off) prod = __fmul_rn(v, prod);
  }
  float T = __shfl_up_sync(FULL, prod, 1);
  if (lane == 0) T = 1.0f;
  float acc = 0.0f, dep = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f};
  for (int s = lo; s < hi; ++s) {
    const float alpha = alpha_of(s);
    const float ws = __fmul_rn(alpha, T);
    T = __fmul_rn(T, __fadd_rn(__fsub_rn(1.0f, alpha), 1e-10f));
    if (w) w[s] = ws;
    for (int c = 0; c < 3; ++c) rgb[c] = __fadd_rn(rgb[c], __fmul_rn(ws, sigmoid(raw[4 * s + c])));
    dep = __fadd_rn(dep, __fmul_rn(ws, z[s]));
    acc = __fadd_rn(acc, ws);
  }
  for (int c = 0; c < 3; ++c) rgb[c] = warp_sum(rgb[c]);
  dep = warp_sum(dep);
  acc = warp_sum(acc);
  const float ratio = __fdiv_rn(dep, acc);
  const float m = ratio != ratio ? ratio : fmaxf(1e-10f, ratio);
  for (int c = 0; c < 3; ++c) res[c] = white ? __fadd_rn(rgb[c], __fsub_rn(1.0f, acc)) : rgb[c];
  res[3] = __fdiv_rn(1.0f, m);
  res[4] = acc;
  res[5] = dep;
}

// Count of the n sorted values v[i] < x (below) or <= x (!below).
__device__ __forceinline__ int rank_in(const float* v, int n, float x, bool below) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (below ? v[mid] < x : v[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One warpgroup's rows of a pass's tile: points p0 .. p0 + rows - 1 of the
// block's R rays at S_p depths each (z + r * z_stride holds ray r's).
struct Rows {
  const float *so, *sd, *z, *hvd;
  float* raw;
  int p0, rows, S_p, z_stride, half;
  __device__ float pt(int row, int c) const {
    const int q = p0 + row, r = q / S_p;
    return __fadd_rn(so[r * 3 + c], __fmul_rn(sd[r * 3 + c], z[r * z_stride + q % S_p]));
  }
  __device__ const float* hv(int row) const {
    if (rows <= 0) return hvd;
    return hvd + ((p0 + (row < rows ? row : rows - 1)) / S_p) * half;
  }
  __device__ void out(int row, int c, float v) const { raw[(p0 + row) * 4 + c] = v; }
};

template <int W>
__global__ void __launch_bounds__(nw::NTHREADS, 1)
    nerf_frame_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int R = p.R, S_c = p.S_c, S_f = p.S_f, S = S_c + S_f, half = W / 2;
  const nw::Smem sm = nw::smem_of(smem_raw, p.lay);
  unsigned char* const ex = sm.extra;
#define GLUE(a) reinterpret_cast<float*>(ex + p.gl.a)
  float *const so = GLUE(o), *const sd = GLUE(d), *const snd = GLUE(nd), *const szc = GLUE(zc);
  float *const sbins = GLUE(bins), *const su = GLUE(u), *const szall = GLUE(zall);
  float *const sraw = GLUE(raw), *const swc = GLUE(wc), *const szf = GLUE(zf);
  float *const scdf = GLUE(cdf), *const sres = GLUE(res);
#undef GLUE
  const int tid = threadIdx.x, wgi = tid / 128, warp = tid / 32, lane = tid % 32;
  const long long groups = (p.N + R - 1) / R;
  const int ng = (int)((groups - blockIdx.x + gridDim.x - 1) / gridDim.x);  // this block's

  // the weight stream: each ray group's coarse tiles, then its fine tiles
  const int ntc = (R * S_c + nw::TM - 1) / nw::TM, ntf = (R * S + nw::TM - 1) / nw::TM;
  nw::Stream<> st;
  st.m0 = &p.fc;
  st.m1 = &p.ff;
  st.s = p.s;
  st.cpt = nw::chunks_per_tile(p.s);
  st.period = ntc + ntf;
  st.split = ntc;
  st.total = ng * st.period * st.cpt;
  nw::ring_start(st, sm);
  for (int i = tid; i < S_c; i += nw::NTHREADS) szc[i] = p.zc[i];
  for (int i = tid; i < S_c - 1; i += nw::NTHREADS) sbins[i] = p.bins[i];
  for (int i = tid; i < S_f; i += nw::NTHREADS) su[i] = p.u[i];
  nw::Cursor k = {0, 0, 0u};

  for (int gi = 0; gi < ng; ++gi) {
    const long long ray0 = (blockIdx.x + (long long)gi * gridDim.x) * R;
    // the group's rays; a ragged group's missing rays are unit-z rays from
    // the origin (the Pallas wrapper's pad rays), computed and never written
    for (int r = tid; r < R; r += nw::NTHREADS) {
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
    const long long last = p.N - 1;
    auto dir = [&](int ri) {
      const long long ray = ray0 + ri < p.N ? ray0 + ri : last;
      return p.dirs + ray * p.s.ev;
    };
    nw::view_rows(sm.hvd, R, half, p.s.ev, p.fc.views_d_w, tid, nw::NTHREADS, dir);
    nw::load_consts(p.fc, p.s, sm, tid, nw::NTHREADS);
    __syncthreads();

    // the coarse pass, its glue, the fine pass: one field eval over the
    // group's rays at S_p depths each (z + r * z_stride holds ray r's) ->
    // sraw [R, S_p, 4]
    for (int fine = 0; fine < 2; ++fine) {
      const int S_p = fine ? S : S_c, P = R * S_p;
      for (int p0 = 0; p0 < P; p0 += nw::TM) {
        Rows src;
        src.so = so;
        src.sd = sd;
        src.z = fine ? szall : szc;
        src.hvd = sm.hvd;
        src.raw = sraw;
        src.p0 = p0 + nw::ROWS * wgi;
        src.rows = P - src.p0 <= 0 ? 0 : P - src.p0 < nw::ROWS ? P - src.p0 : nw::ROWS;
        src.S_p = S_p;
        src.z_stride = fine ? S : 0;
        src.half = half;
        nw::field_tile<W>(fine ? p.ff : p.fc, st, sm, k, src);
      }
      __syncthreads();
      if (fine) break;
      // the fine model's view rows and epilogue operands (the coarse pass
      // has read its own)
      nw::view_rows(sm.hvd, R, half, p.s.ev, p.ff.views_d_w, tid, nw::NTHREADS, dir);
      nw::load_consts(p.ff, p.s, sm, tid, nw::NTHREADS);
      // coarse composite, inverse CDF, z_std and merge: one warp a ray
      for (int r = warp; r < R; r += nw::NTHREADS / 32) {
        float res[6];
        float* w = swc + r * S_c;
        composite_warp(sraw + (size_t)r * S_c * 4, szc, S_c, snd[r], p.white_bkgd, w, res);
        float* out = sres + r * OUT_CH;
        if (lane == 0) {
          for (int c = 0; c < 3; ++c) out[6 + c] = res[c];
          out[9] = res[3];
          out[10] = res[4];
        }
        __syncwarp();
        // the inverse CDF of the interior weights: the sampler kernel's warp
        // routine, so that the fine depths are its bit for bit
        float* zf = szf + r * S_f;
        float sum = 0.0f;
        pdf_warp(sbins, w + 1, scdf + r * S_c, S_c - 1, su, S_f, lane, zf);
        for (int j = lane; j < S_f; j += 32) sum = __fadd_rn(sum, zf[j]);
        const float mean = __fdiv_rn(warp_sum(sum), (float)S_f);
        float ss = 0.0f;
        for (int j = lane; j < S_f; j += 32) {
          const float dz = __fsub_rn(zf[j], mean);
          ss = __fadd_rn(ss, __fmul_rn(dz, dz));
        }
        ss = warp_sum(ss);
        if (lane == 0) out[11] = __fsqrt_rn(__fdiv_rn(ss, (float)S_f));
        __syncwarp();
        // the merge by rank
        float* za = szall + r * S;
        for (int a = lane; a < S_c; a += 32) za[a + rank_in(zf, S_f, szc[a], true)] = szc[a];
        for (int b = lane; b < S_f; b += 32) za[b + rank_in(szc, S_c, zf[b], false)] = zf[b];
      }
      __syncthreads();
    }

    // the fine composite and the eight fields
    for (int r = warp; r < R; r += nw::NTHREADS / 32) {
      float res[6];
      composite_warp(sraw + (size_t)r * S * 4, szall + r * S, S, snd[r], p.white_bkgd, nullptr,
                     res);
      float* out = sres + r * OUT_CH;
      if (lane == 0)
        for (int c = 0; c < 6; ++c) out[c] = res[c];
      __syncwarp();
      const long long ray = ray0 + r;
      if (ray < p.N) {
        if (lane < OUT_CH) p.out[ray * OUT_CH + lane] = out[lane];
        if (p.taps_w)
          for (int s = lane; s < S_c; s += 32) p.taps_w[ray * S_c + s] = swc[r * S_c + s];
        if (p.taps_z)
          for (int j = lane; j < S_f; j += 32) p.taps_z[ray * S_f + j] = szf[r * S_f + j];
      }
    }
    __syncthreads();  // the group's shared arrays are read before the next group's writes
  }
}

template <int W>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = nerf_frame_kernel<W>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (a.N + a.R - 1) / a.R;
  const int resident = nw::resident_blocks(kernel, smem);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(groups < resident ? groups : resident);
  kernel<<<grid, nw::NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block of R rays needs; above 232448
// the shape is not supported.
extern "C" long long nerf_frame_smem_bytes(int in_pad, int W, int depth, int R, int S_c,
                                           int S_f) {
  const nw::Shape s = {in_pad, in_pad, 1, W, depth};
  const nw::Layout l = frame_layout(s, R, S_c, S_f);
  return (long long)(l.ns >= 2 && l.total <= (size_t)nw::MAX_SMEM ? l.total : nw::MAX_SMEM + 1);
}

// The weight ring's stages at that shape.
extern "C" int nerf_frame_ring_stages(int in_pad, int W, int depth, int R, int S_c, int S_f) {
  const nw::Shape s = {in_pad, in_pad, 1, W, depth};
  return frame_layout(s, R, S_c, S_f).ns;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// wc, wf: the coarse and the fine model's 13 operands (nw::make_model's
// order), with the same shapes; taps_w / taps_z null unless the caller asks
// for the coarse weights and fine depths. Shapes are checked by the Python
// wrapper.
extern "C" int nerf_frame_launch(const float* rays_o, const float* rays_d, const float* dirs,
                                 const float* zc, const float* bins, const float* u, float* out,
                                 float* taps_w, float* taps_z, long long N, int R, int S_c,
                                 int S_f, int white_bkgd, const void* const* wc,
                                 const void* const* wf, int in_ch, int in_pad, int ev, int W,
                                 int depth, int skip_c, int skip_f, void* stream) {
  if (N <= 0) return 0;
  Args a;
  memset(&a, 0, sizeof(a));
  a.s = nw::Shape{in_ch, in_pad, ev, W, depth};
  const size_t smem = (size_t)nerf_frame_smem_bytes(in_pad, W, depth, R, S_c, S_f);
  if (!nw::shape_ok(a.s, skip_c) || !nw::shape_ok(a.s, skip_f) || R < 1 || S_c < 3 ||
      S_f < 1 || smem > (size_t)nw::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (!nw::make_model(&a.fc, wc, a.s, skip_c) || !nw::make_model(&a.ff, wf, a.s, skip_f))
    return (int)cudaErrorInvalidValue;
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
  a.gl = glue_layout(R, S_c, S_f);
  a.lay = frame_layout(a.s, R, S_c, S_f);
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 64: return launch<64>(a, smem, st);
    case 128: return launch<128>(a, smem, st);
    case 192: return launch<192>(a, smem, st);
    case 256: return launch<256>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
