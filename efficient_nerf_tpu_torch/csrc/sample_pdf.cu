// Deterministic inverse-CDF importance sampling for Hopper (sm_90a): coarse
// bin edges and weights in, sorted fine depths out.
//
// Replaces efficient_nerf_tpu/ops/pallas/sample_pdf.py::sample_pdf_det_fused
// (:123, its pallas_call at :138), with the semantics of its _kernel in the
// wrapper's default use_roll=False form (:29-80):
//
//   w = weights + 1e-5; pdf = w / sum(w) (a true division);
//   the CDF accumulated sequentially, cdf_hi = cdf_lo + pdf_i: that order is
//   semantics, since the denom < 1e-5 guard reads cdf_hi - cdf_lo;
//   level u in [cdf_lo, cdf_hi) of interval i:
//     t = (u - cdf_lo) / denom, val = b_lo + t (b_hi - b_lo);
//   u >= cdf_last takes bins[C-1], and the top level u >= 1 is pinned to it.
//
// One thread walks one ray (pdf_walk of sample_pdf.cuh, which the whole-ray
// kernel nerf_frame.cu also runs, so that the two agree bit for bit).
//
// Bound: 4 (2C - 1 + n) bytes a ray in and out (about 1 KB at C 63, n 128,
// the fine pass of the lego config): bound by bytes. One thread walks one ray;
// a block of 32 rays stages its rows through shared memory so that the loads
// and the stores are coalesced (rows are padded to odd strides, so that the
// threads of a warp, one row each, hit distinct banks).
#include <cuda_runtime.h>

#include "sample_pdf.cuh"

namespace {

using enerf::pdf_walk;

constexpr int TR = 32;  // rays (threads) per block

__host__ __device__ inline size_t smem_floats(int C, int n) {
  // bins and weights at row stride C, outputs at n + 1 (odd for C = 63),
  // then the n levels
  return (size_t)TR * (2 * C + n + 1) + n;
}

__global__ void __launch_bounds__(TR) sample_pdf_det_kernel(
    const float* __restrict__ bins, const float* __restrict__ weights,
    const float* __restrict__ u, float* __restrict__ out, long long N, int C, int n) {
  extern __shared__ float sm[];
  float* sb = sm;                       // [TR][C] bins
  float* sw = sb + TR * C;              // [TR][C] weights (C - 1 used)
  float* so = sw + TR * C;              // [TR][n + 1] samples
  float* su = so + TR * (n + 1);        // [n] levels
  const int tid = threadIdx.x;
  const long long ray0 = (long long)blockIdx.x * TR;
  const int rows = (int)(N - ray0 < TR ? N - ray0 : TR);

  for (int e = tid; e < rows * C; e += TR) sb[e] = bins[ray0 * C + e];
  for (int e = tid; e < rows * (C - 1); e += TR)
    sw[(e / (C - 1)) * C + e % (C - 1)] = weights[ray0 * (C - 1) + e];
  for (int e = tid; e < n; e += TR) su[e] = u[e];
  __syncthreads();

  if (tid < rows) pdf_walk(sb + tid * C, sw + tid * C, C, su, n, so + tid * (n + 1));
  __syncthreads();
  for (int e = tid; e < rows * n; e += TR) out[ray0 * n + e] = so[(e / n) * (n + 1) + e % n];
}

}  // namespace

// Bytes of dynamic shared memory one block needs; above 232448 the shape is
// not supported.
extern "C" long long sample_pdf_smem_bytes(int C, int n) {
  return (long long)(smem_floats(C, n) * sizeof(float));
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// bins [N, C], weights [N, C - 1], u [n] sorted levels, out [N, n]; all f32
// and contiguous (checked by the Python wrapper).
extern "C" int sample_pdf_det_launch(const float* bins, const float* weights,
                                     const float* u, float* out, long long N, int C,
                                     int n, void* stream) {
  if (N <= 0) return 0;
  const size_t smem = smem_floats(C, n) * sizeof(float);
  if (C < 2 || n < 1 || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sample_pdf_det_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((N + TR - 1) / TR);
  sample_pdf_det_kernel<<<blocks, TR, smem, (cudaStream_t)stream>>>(bins, weights, u, out,
                                                                     N, C, n);
  return (int)cudaGetLastError();
}
