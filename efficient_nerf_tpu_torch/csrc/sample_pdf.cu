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
// Bound: 4 (2C - 1 + n) bytes a ray in and out (about 1 KB at C 63, n 128,
// the fine pass of the lego config; 33.2 MB a 32,768-ray chunk, 0.0099 ms at
// 3.35 TB/s): bound by bytes. The design: one warp a ray (pdf_warp of
// sample_pdf.cuh, which the whole-ray kernel nerf_frame.cu also runs, so
// that the two agree bit for bit). Blocks of WARPS warps, as many as are
// resident, stride over the rays and stage the n levels once; each warp
// loads its ray's C edges and C - 1 weights into its own row of shared
// memory, neighbouring lanes on neighbouring words (coalesced, and no bank
// conflict: a warp's row is contiguous), builds the CDF beside them (the
// total by every lane and the sequential sum by lane 0 in order, the
// divisions over the lanes) and spreads the n levels over its lanes, each a
// binary search of the CDF, the stores coalesced. The two sums in order take
// a warp instruction a weight each, and with them the kernel is bound by its
// instructions, not its bytes: without them it takes about two thirds of
// its time (chip_breakdown.py --kernel sampler, PERF.md). A lane a level
// range (one search, then a walk) with the samples staged for wider stores,
// and the next ray's row copied by cp.async during this one's, measured the
// same and are not kept.
#include <cuda_runtime.h>

#include "sample_pdf.cuh"

namespace {

using enerf::pdf_warp;

constexpr int WARPS = 8;  // rays a block works on at a time, one a warp

// A warp's row: C edges, C - 1 weights, then their C - 1 CDF values.
__host__ __device__ inline size_t smem_floats(int C, int n) {
  return (size_t)WARPS * (3 * C - 2) + n;
}

__global__ void __launch_bounds__(WARPS * 32) sample_pdf_det_kernel(
    const float* __restrict__ bins, const float* __restrict__ weights,
    const float* __restrict__ u, float* __restrict__ out, long long N, int C, int n) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* su = sm;                                  // [n] levels
  float* sb = su + n + (size_t)warp * (3 * C - 2); // this warp's [C] edges
  float* sw = sb + C;                              // [C - 1] weights
  float* sc = sw + C - 1;                          // [C - 1] CDF
  for (int e = threadIdx.x; e < n; e += WARPS * 32) su[e] = u[e];
  __syncthreads();
  for (long long ray = (long long)blockIdx.x * WARPS + warp; ray < N;
       ray += (long long)gridDim.x * WARPS) {
    for (int i = lane; i < C; i += 32) sb[i] = bins[ray * C + i];
    for (int i = lane; i < C - 1; i += 32) sw[i] = weights[ray * (C - 1) + i];
    __syncwarp();
    pdf_warp(sb, sw, sc, C, su, n, lane, out + ray * n);
    __syncwarp();  // the row is reloaded for the next ray
  }
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
  cudaError_t err;
  // above 48 KB only (C in the hundreds): the call costs the host more than
  // the kernel takes at the main path's shape
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(sample_pdf_det_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return (int)err;
  // persistent blocks: as many as are resident at once (the occupancy of
  // the last shared-memory size asked, kept), or fewer for a small N
  static size_t known_smem = 0;
  static int known_per_sm = 0;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if (smem != known_smem) {
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sample_pdf_det_kernel,
                                                             WARPS * 32, smem)) != cudaSuccess)
      return (int)err;
    known_per_sm = per_sm > 0 ? per_sm : 1;
    known_smem = smem;
  }
  const long long want = (N + WARPS - 1) / WARPS;
  const long long resident = (long long)sms * known_per_sm;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  sample_pdf_det_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(bins, weights, u,
                                                                            out, N, C, n);
  return (int)cudaGetLastError();
}
