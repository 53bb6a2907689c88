// Fused teacher field evaluation for Hopper (sm_90a): sample points and
// per-ray view directions in, raw (rgb, sigma) out.
//
// Replaces efficient_nerf_tpu/ops/pallas/nerf_forward.py::nerf_forward_fused
// (:314, its pallas_call at :410; the kernel body is _kernel :174-292), with
// the same fusion boundary: points and per-ray embedded directions go in, raw
// comes out, and no activation reaches device memory. Each tile of TM = 128
// consecutive points (point = ray * S + sample, so a tile may straddle rays)
// runs end to end through the field of nerf_wgmma.cuh (embed, 8 layers with
// the skip, alpha and feature heads, view layer, rgb head).
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
// operations (2.502 ms for a 32,768-ray chunk at 64 samples, 7.506 at 192, at
// 989 TFLOP/s). Second to it is the weight stream: each 128-point tile reads
// the 1.17 MB of bf16 weights from L2, 58 GB for a fine chunk. The design
// (nerf_wgmma.cuh): wgmma from two warpgroups that split the tile's rows, so
// that one's epilogues run under the other's products; the weights by TMA
// into a ring that neither warpgroup waits on to load; persistent blocks
// (one per SM at W256), so that the ring streams on from tile to tile. This
// file holds the kernel's arguments and its launch.
#include <string.h>

#include "nerf_wgmma.cuh"

namespace {

using namespace enerf;

struct Args {
  const float* pts;                 // point p, coordinate c at p * s_pt + c * s_c
  long long s_pt, s_c;
  const float* dirs;                // [N, ev] f32 embedded view directions
  float* out;                       // raw of point p, channel c at p * o_pt + c * o_c
  long long o_pt, o_c, P;
  int S, nr_wg;                     // samples a ray; rays a warpgroup's rows can touch
  nw::Shape s;
  nw::Model m;
};

__host__ __device__ inline nw::Layout forward_layout(const nw::Shape& s, int S) {
  return nw::layout(s, (size_t)2 * nw::rays_per_rows(S) * (s.W / 2) * 4, 0);
}

// __grid_constant__: the tile takes the tensor maps' and the model's
// addresses without a local copy of them
template <int W>
__global__ void __launch_bounds__(nw::NTHREADS, 1)
    nerf_forward_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const nw::Smem sm = nw::smem_of(smem_raw, forward_layout(p.s, p.S));
  nw::point_tiles<W>(
      p, sm, [&] { nw::load_consts(p.m, p.s, sm, threadIdx.x, nw::NTHREADS); },
      [&](const nw::Stream<>& st, nw::Cursor& k, nw::Rows<Args>& src) {
        nw::field_tile<W>(p.m, st, sm, k, src);
      });
}

}  // namespace

// Bytes of dynamic shared memory one block needs; above 232448 the shape is
// not supported.
extern "C" long long nerf_forward_smem_bytes(int in_pad, int W, int depth, int S) {
  const nw::Shape s = {in_pad, in_pad, 1, W, depth};
  const nw::Layout l = forward_layout(s, S);
  return (long long)(l.ns >= 2 && l.total <= (size_t)nw::MAX_SMEM ? l.total : nw::MAX_SMEM + 1);
}

// The weight ring's stages at that shape.
extern "C" int nerf_forward_ring_stages(int in_pad, int W, int depth, int S) {
  const nw::Shape s = {in_pad, in_pad, 1, W, depth};
  return forward_layout(s, S).ns;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// Shapes are checked by the Python wrapper; the checks here guard the
// kernel's own assumptions. Weights are nn.Linear's [out, in] layout, bf16.
extern "C" int nerf_forward_launch(
    const float* pts, long long s_pt, long long s_c, const float* dirs,
    const void* pts0_w, const void* pts0_b, const void* body_w, const void* body_b,
    const void* skip_x_w, const void* feat_w, const void* feat_b,
    const void* views_h_w, const void* views_d_w, const void* views_b,
    const void* rgb_w, const void* alpha_w, const float* out_b, float* out,
    long long o_pt, long long o_c, long long P, int S, int in_ch, int in_pad,
    int ev, int W, int depth, int skip, void* stream) {
  if (P <= 0) return 0;
  Args a;
  memset(&a, 0, sizeof(a));
  a.s = nw::Shape{in_ch, in_pad, ev, W, depth};
  const size_t smem = (size_t)nerf_forward_smem_bytes(in_pad, W, depth, S);
  if (!nw::shape_ok(a.s, skip) || S < 1 || smem > (size_t)nw::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const void* w[13] = {pts0_w, pts0_b, body_w, body_b, skip_x_w, feat_w, feat_b,
                       views_h_w, views_d_w, views_b, rgb_w, alpha_w, out_b};
  if (!nw::make_model(&a.m, w, a.s, skip)) return (int)cudaErrorInvalidValue;
  a.pts = pts;
  a.s_pt = s_pt;
  a.s_c = s_c;
  a.dirs = dirs;
  a.out = out;
  a.o_pt = o_pt;
  a.o_c = o_c;
  a.P = P;
  a.S = S;
  a.nr_wg = nw::rays_per_rows(S);
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 64: return nw::launch_tiles(nerf_forward_kernel<64>, a, smem, st);
    case 128: return nw::launch_tiles(nerf_forward_kernel<128>, a, smem, st);
    case 192: return nw::launch_tiles(nerf_forward_kernel<192>, a, smem, st);
    case 256: return nw::launch_tiles(nerf_forward_kernel<256>, a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
