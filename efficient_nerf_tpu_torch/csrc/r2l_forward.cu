// Fused R2L inference forward for Hopper (sm_90a): rays in, rgb out.
//
// Replaces efficient_nerf_tpu/ops/pallas/r2l_forward.py::r2l_forward_fused
// (:388, its pallas_call at :505) in its production configuration: the
// double-angle embedding (fast_embed=True), f32 epilogues, no diagnostics.
// One thread block renders a tile of 64 rays end to end:
//
//   rays (o, d) -> points p = o + z_s d (exact f32) -> doubling embed
//     -> head + relu -> n_block x (lin, relu, lin, * res_scale, + h)
//     -> optional global residual (+ post-relu head output) -> tail, sigmoid
//
// Precision contract of the Pallas kernel (:251-264): every matmul takes
// bf16 operands and accumulates in f32; bias, relu, the residual g *
// res_scale + h and the global residual are f32; h is rounded to bf16 only
// as a matmul operand; the tail is out_dim dot products and a sigmoid in
// f32. The points, the embed and the residual use the round-to-nearest
// intrinsics, so they round as the plain version (ops/r2l_forward.py) does.
//
// Bound: 11.79 MFLOP per ray at W256 D88 (2 x (1008*256 + 86*256^2 +
// 256*3)); 24 bytes of rays in and 12 of rgb out per ray, plus the 11.8 MB of
// weights once. The function is bound by tensor-core operations. The tile
// (csrc/r2l_wgmma.cuh, shared with the training forward) keeps the
// activations on chip through all 88 layers and streams the weights from L2
// by TMA into a 3-stage ring under wgmma products from two warpgroups, and
// no block barrier waits on a weight chunk. This file holds the rays'
// points and the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

#include "r2l_wgmma.cuh"

namespace {

using namespace enerf;

struct Args {
  wg::Net net;                     // K = 3 n_sample point coordinates a ray, embedded
  const float* rays_o;             // [B, 3]
  const float* rays_d;             // [B, 3]
  const float* z;                  // [n_sample] depths
};

template <int NT, bool PARTS>
__global__ void __launch_bounds__(wg::NTHREADS, 1)
    r2l_forward_kernel(const __grid_constant__ wg::Maps maps, const Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const float *rays_o = p.rays_o, *rays_d = p.rays_d, *z = p.z;
  // coordinate m = s * 3 + c of the ray's points o + z_s d
  wg::forward_tile<NT, false, PARTS>(maps, p.net, smem, [=](long long ray, int m) {
    return __fadd_rn(rays_o[ray * 3 + m % 3], __fmul_rn(z[m / 3], rays_d[ray * 3 + m % 3]));
  });
}

template <int NT>
struct Kernel {
  static int launch(const wg::Maps& maps, const Args& p, unsigned grid, size_t smem,
                    bool parts, cudaStream_t stream) {
    auto kernel = parts ? r2l_forward_kernel<NT, true> : r2l_forward_kernel<NT, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, wg::NTHREADS, smem, stream>>>(maps, p);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Bytes of dynamic shared memory one block needs (with the global
// residual's h0); above 232448 the shape is not supported. A wide input
// does not raise it: the head then runs in parts.
extern "C" long long r2l_forward_smem_bytes(int in_pad, int W) {
  return (long long)wg::layout(in_pad, wg::round_up64(W), true).total;
}

// The kernel's instantiation for (in_pad, W): wg::tile_kind.
extern "C" int r2l_forward_tile_kind(int in_pad, int W) { return wg::tile_kind(in_pad, W); }

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
  if (!wg::tile_ok(in_pad, W, n_block, out_dim, global_residual != 0) ||
      in_pad < 3 * n_sample * (2 * L + 1))
    return (int)cudaErrorInvalidValue;
  wg::Maps maps;
  memset(&maps, 0, sizeof(maps));  // hs: not stored
  if (!wg::weight_maps(&maps, head_w, body_w, in_pad, W, n_block))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.net = wg::make_net(head_b, body_b, tail_w, tail_b, out, B, 3 * n_sample, L, in_pad, W,
                       n_block, out_dim, res_scale, global_residual);
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.z = z;
  return wg::launch_tile<Kernel>(maps, p, B, in_pad, W, global_residual != 0,
                                 (cudaStream_t)stream);
}
