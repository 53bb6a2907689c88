// The deterministic inverse CDF of one ray, one warp a ray: the sampler
// kernel (sample_pdf.cu) and the whole-ray kernel's glue (nerf_frame.cu) run
// the same routine, so that both draw the same fine depths bit for bit from
// the same weights and levels.
//
// The Pallas kernel tests every interval against every level and sums the
// masked values. The intervals [cdf_lo, cdf_hi) are disjoint and in order, so
// at most one matches a level: the first interval with u < cdf_hi, which a
// binary search over the CDF finds for each level on its own: O(C + n log C)
// a ray spread over the lanes instead of O(C n), and the same value bit for
// bit (every operation is the round-to-nearest intrinsic the plain version's
// torch ops round as).
#pragma once

namespace enerf {

// pdf_warp's sample for one level u, given the CDF: cdf[i] is cdf_hi of
// interval i (the pdfs summed in order from 0), for the C - 1 intervals of
// the C edges b. A level in [cdf_lo, cdf_hi) of interval i takes b_lo + (u -
// cdf_lo) / denom * (b_hi - b_lo) with denom < 1e-5 read as 1; u >= cdf_last
// takes b[C - 1], and the top level u >= 1 is pinned to it.
__device__ __forceinline__ float pdf_level(const float* b, const float* cdf, int C, float u) {
  const int nw = C - 1;
  int lo = 0, hi = nw;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (u < cdf[mid])
      hi = mid;
    else
      lo = mid + 1;
  }
  if (lo == nw || u >= 1.0f) return b[C - 1];  // the tail, and the top level
  const float cdf_lo = lo > 0 ? cdf[lo - 1] : 0.0f;
  float denom = __fsub_rn(cdf[lo], cdf_lo);
  if (denom < 1e-5f) denom = 1.0f;
  const float b_lo = b[lo], span = __fsub_rn(b[lo + 1], b_lo);
  return cdf_lo <= u ? __fadd_rn(b_lo, __fmul_rn(__fdiv_rn(__fsub_rn(u, cdf_lo), denom), span))
                     : 0.0f;
}

// One ray by the 32 lanes of a warp, which all call it: b its C bin edges, w
// its C - 1 weights, su the n sorted levels (all in shared memory); cdf
// C - 1 other floats of the warp's shared memory; o the n samples. w =
// weights + 1e-5, pdf = w / sum(w), the CDF accumulated sequentially: the
// order of both sums is semantics (the denom < 1e-5 guard reads cdf_hi -
// cdf_lo), so every lane sums the total in order, the lanes divide, and lane
// 0 accumulates in order. Then the levels j = lane, lane + 32, ... A call,
// not inlined: inlined into the whole-ray kernel, whose field tile runs at
// 255 registers, it moved ptxas's allocation there and cost that kernel 13%
// (PERF.md).
static __device__ __noinline__ void pdf_warp(const float* b, const float* w, float* cdf, int C,
                                             const float* su, int n, int lane, float* o) {
  float total = 0.0f;
#pragma unroll 8
  for (int i = 0; i < C - 1; ++i) total = __fadd_rn(total, __fadd_rn(w[i], 1e-5f));
  for (int i = lane; i < C - 1; i += 32) cdf[i] = __fdiv_rn(__fadd_rn(w[i], 1e-5f), total);
  __syncwarp();
  if (lane == 0) {
    float cdf_lo = 0.0f;
#pragma unroll 8
    for (int i = 0; i < C - 1; ++i) cdf[i] = cdf_lo = __fadd_rn(cdf_lo, cdf[i]);
  }
  __syncwarp();
  for (int j = lane; j < n; j += 32) o[j] = pdf_level(b, cdf, C, su[j]);
}

}  // namespace enerf
