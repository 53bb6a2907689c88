// Fused teacher field evaluation for Hopper (sm_90a): sample points and
// per-ray view directions in, raw (rgb, sigma) out.
//
// Replaces efficient_nerf_tpu/ops/pallas/nerf_forward.py::nerf_forward_fused
// (:314, its pallas_call at :410; the kernel body is _kernel :174-292), with
// the same fusion boundary: points and per-ray embedded directions go in, raw
// comes out, and no activation reaches device memory. One thread block takes
// a tile of TM = 128 consecutive points (point = ray * S + sample, so a tile
// may straddle rays) end to end, through the field of nerf_field.cuh (embed,
// 8 layers with the skip, alpha and feature heads, view layer, rgb head).
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
// operations (a 400x400 frame at 64 + 192 samples is 48.3 TFLOP). The design
// (nerf_field.cuh): mma.sync m16n8k16 bf16 -> f32 from 8 warps, the 1.19 MB of
// bf16 weights streamed from L2 as one continuous cp.async stream over all 11
// products, about 127 FLOP per byte of L2 at 128-point tiles; the activation
// tile overwritten in place; the heads summed from registers.
//
// wgmma, TMA, warp specialisation and clusters that share one weight stream
// are later work.
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
  Field f;
};

// __grid_constant__: the epilogues and the segment table take the parameter's
// address without a local copy of it
__global__ void __launch_bounds__(NTHREADS, 1)
    nerf_forward_kernel(const __grid_constant__ Args p) {
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
  field_products<false>(f, t, [&](const Seg& sg, TileFrag& acc) {
    bf16_epilogue(f, t, sg.layer, acc);
  });
  field_raw(f, t, rows, [&](int row, int c, float v) {
    p.out[(p0 + row) * p.o_pt + c * p.o_c] = v;
  });
}

}  // namespace

// Bytes of dynamic shared memory one block needs; above 232448 the shape is
// not supported.
extern "C" long long nerf_forward_smem_bytes(int in_pad, int W, int S) {
  return (long long)field_layout(in_pad, W, W / 2, rays_per_tile(S)).total;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// Shapes are checked by the Python wrapper; the checks here guard the
// kernel's own assumptions. Weights are nn.Linear's [out, in] layout, bf16
// (bf16_segments).
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
  const size_t smem = field_layout(in_pad, W, half, nr_max).total;
  if (!field_shape_ok(in_ch, in_pad, ev, W, depth, skip) || S < 1 || smem > (size_t)MAX_SMEM)
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
  a.out = out;
  a.o_pt = o_pt;
  a.o_c = o_c;
  a.P = P;
  a.S = S;
  a.nr_max = nr_max;
  Field& f = a.f;
  f.pts0_b = static_cast<BP>(pts0_b);
  f.body_b = static_cast<BP>(body_b);
  f.feat_b = static_cast<BP>(feat_b);
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
  f.n_segs = bf16_segments(f.segs, pts0_w, body_w, skip_x_w, feat_w, views_h_w, in_pad, W,
                           depth, skip);

  const unsigned blocks = (unsigned)((P + TM - 1) / TM);
  nerf_forward_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
