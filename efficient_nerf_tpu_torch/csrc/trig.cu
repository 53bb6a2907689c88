// A kernel that only calls the fast_sincos device helper of trig.cuh, one
// thread per element, so that the helper can be held against its plain torch
// version (ops/trig.py) on the card. The R2L kernel inlines the same helper.
//
// Bound: 4 bytes read and 8 written per element; the kernel is bound by
// memory bandwidth.
#include <cuda_runtime.h>

#include "trig.cuh"

namespace {

__global__ void fast_sincos_kernel(const float* __restrict__ y,
                                   float* __restrict__ s,
                                   float* __restrict__ c, long long n,
                                   int degree) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sv, cv;
  enerf::fast_sincos(y[i], sv, cv, degree);
  s[i] = sv;
  c[i] = cv;
}

}  // namespace

extern "C" int fast_sincos_launch(const float* y, float* s, float* c,
                                  long long n, int degree, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  fast_sincos_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      y, s, c, n, degree);
  return (int)cudaGetLastError();
}
