// W8A8 R2L inference forward for Hopper (sm_90a): rays in, rgb out, with the
// 43-block residual body on the int8 tensor cores.
//
// Replaces efficient_nerf_tpu/ops/pallas/r2l_int8.py::r2l_forward_int8
// (:230, its pallas_call at :280), in both of its modes: static activation
// scales (act_scales given, the served mode) and per-row dynamic scales
// (act_scales absent). One thread block renders a tile of TB = 64 rays end to
// end. The embed, the bf16 head and the bf16 tail with its sigmoid are the
// bf16 kernel's (the tile of r2l_wgmma.cuh); only the body differs:
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
// Design: the bf16 serving kernel's tile (r2l_wgmma.cuh, forward_tile with Q
// Q_STATIC or Q_DYNAMIC): two warpgroups that split each layer's output
// columns, one TMA weight ring of 3 stages that carries the head's bf16
// chunks and then the body's [Wp, 128] int8 chunks, one block barrier a
// layer (two in the dynamic mode, whose row maxima the two warpgroups
// exchange through shared memory), and products by s8 wgmma (m64nNTk32,
// NT = Wp / 2, wgmma_s8.cuh) on the int8 A panels q(h) and q(g), [64, 128]
// each with the 128-byte swizzle. The residual stream h stays in f32
// registers through all 43 blocks. A width that is not a multiple of 128
// (W96: one 128-column chunk) reads TMA's zeros past column W, and its
// levels past W meet those zero weights.
//
// Shared memory (W = 256, in_pad = 1024): the ring, 3 x 32 KB; the embed
// (128 KB), which q(h) and q(g) (16 KB each, the tail's bf16 input a over
// both at the end), h0 (f32, 64 KB), the prefetched scales and biases (4
// KB) and the row maxima (1 KB) overlay once the head has read it: 225 KB.
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

template <int NT, bool PARTS, int Q>
__global__ void __launch_bounds__(wg::NTHREADS, 1)
    r2l_int8_kernel(const __grid_constant__ wg::Maps maps, const Args p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const float *rays_o = p.rays_o, *rays_d = p.rays_d, *z = p.z;
  // coordinate m = s * 3 + c of the ray's points o + z_s d
  wg::forward_tile<NT, false, PARTS, Q>(maps, p.net, smem, [=](long long ray, int m) {
    return __fadd_rn(rays_o[ray * 3 + m % 3], __fmul_rn(z[m / 3], rays_d[ray * 3 + m % 3]));
  });
}

template <int NT>
struct Kernel {
  static int launch(const wg::Maps& maps, const Args& p, unsigned grid, size_t smem,
                    bool parts, cudaStream_t stream) {
    const bool dyn = p.net.act_scales == nullptr;
    auto kernel = dyn ? (parts ? r2l_int8_kernel<NT, true, wg::Q_DYNAMIC>
                               : r2l_int8_kernel<NT, false, wg::Q_DYNAMIC>)
                      : (parts ? r2l_int8_kernel<NT, true, wg::Q_STATIC>
                               : r2l_int8_kernel<NT, false, wg::Q_STATIC>);
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
extern "C" long long r2l_int8_smem_bytes(int in_pad, int W) {
  return (long long)wg::layout(in_pad, wg::round_up64(W), true, true).total;
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
  if (!wg::tile_ok(in_pad, W, n_block, out_dim, global_residual != 0, true) ||
      in_pad < 3 * n_sample * (2 * L + 1))
    return (int)cudaErrorInvalidValue;
  wg::Maps maps;
  memset(&maps, 0, sizeof(maps));  // hs: not stored
  if (!wg::weight_maps(&maps, head_w, body_qw, in_pad, W, n_block, 1))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.net = wg::make_net(head_b, body_b, tail_w, tail_b, out, B, 3 * n_sample, L, in_pad, W,
                       n_block, out_dim, res_scale, global_residual);
  p.net.body_sw = body_sw;
  p.net.act_scales = act_scales;
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.z = z;
  return wg::launch_tile<Kernel>(maps, p, B, in_pad, W, global_residual != 0,
                                 (cudaStream_t)stream, true);
}
