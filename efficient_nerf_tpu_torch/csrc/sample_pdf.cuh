// The deterministic inverse CDF of one ray, shared by the sampler kernel
// (sample_pdf.cu) and the whole-ray kernel (nerf_frame.cu), so that both draw
// the same fine depths bit for bit from the same weights and levels.
//
// The Pallas kernel tests every interval against every level and sums the
// masked values. The intervals [cdf_lo, cdf_hi) are disjoint and in order, so
// at most one matches a level, and over the sorted levels (u = linspace) a
// walk of two pointers finds the same interval: O(C + n) a ray instead of
// O(C n), and the same value bit for bit (every operation is the
// round-to-nearest intrinsic the plain version's torch ops round as).
#pragma once

namespace enerf {

// b: the ray's C bin edges; w: its C - 1 weights; su: the n sorted levels;
// o: the n samples. w = weights + 1e-5; pdf = w / sum(w); the CDF
// accumulated sequentially; a level in [cdf_lo, cdf_hi) of interval i takes
// b_lo + (u - cdf_lo) / denom * (b_hi - b_lo) with denom < 1e-5 read as 1;
// u >= cdf_last takes b[C - 1], and the top level u >= 1 is pinned to it.
__device__ __forceinline__ void pdf_walk(const float* b, const float* w, int C, const float* su,
                                         int n, float* o) {
  const float top = b[C - 1];
  float total = 0.0f;
  for (int i = 0; i < C - 1; ++i) total = __fadd_rn(total, __fadd_rn(w[i], 1e-5f));
  float cdf_lo = 0.0f;
  int j = 0;
  for (int i = 0; i < C - 1; ++i) {
    const float pdf = __fdiv_rn(__fadd_rn(w[i], 1e-5f), total);
    const float cdf_hi = __fadd_rn(cdf_lo, pdf);
    float denom = __fsub_rn(cdf_hi, cdf_lo);
    if (denom < 1e-5f) denom = 1.0f;
    const float b_lo = b[i], span = __fsub_rn(b[i + 1], b_lo);
    for (; j < n && su[j] < cdf_hi; ++j) {
      const float uj = su[j];
      float v = 0.0f;  // a level below the interval matches none
      if (cdf_lo <= uj)
        v = __fadd_rn(b_lo, __fmul_rn(__fdiv_rn(__fsub_rn(uj, cdf_lo), denom), span));
      o[j] = uj >= 1.0f ? top : v;
    }
    cdf_lo = cdf_hi;
  }
  for (; j < n; ++j) o[j] = top;  // u >= cdf_last: the tail (and u >= 1)
}

}  // namespace enerf
