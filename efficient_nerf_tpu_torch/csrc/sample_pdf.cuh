// The deterministic inverse CDF of one ray: the sampler kernel's walk
// (sample_pdf.cu), and the same walk split by level for the whole-ray kernel
// (nerf_frame.cu), so that both draw the same fine depths bit for bit from
// the same weights and levels.
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

// pdf_walk's sample for one level u, given the CDF as the walk accumulates
// it: cdf[i] is its cdf_hi of interval i (the pdfs summed in order from 0),
// for the C - 1 intervals of the C edges b. Over sorted levels the walk
// gives level u the first interval with u < cdf_hi; a binary search finds
// the same interval, and the same operations give the same value, so levels
// can be spread over threads.
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

}  // namespace enerf
