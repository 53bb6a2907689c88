// W8A8 teacher field evaluation for Hopper (sm_90a): sample points and
// per-ray view directions in, raw (rgb, sigma) out, with the 7 hidden layers
// and the feature head on the int8 tensor cores.
//
// Replaces efficient_nerf_tpu/ops/pallas/nerf_int8.py::nerf_forward_int8
// (:210, its pallas_call at :306; the kernel body is _kernel :114-207). The
// tile, the embed, the weight stream, the view branch and the heads are
// those of the bf16 field tile (nerf_wgmma.cuh); only the body and the
// feature head differ. With per-output-row weight scales sw, static
// activation scales s[0..D-1] and the folded constants that the wrapper makes
// once per call (ops/nerf_int8.py::_fold, :245-259 of the Pallas wrapper):
//
//   h0  = relu(bf16 product of layer 0 + b0)          q = lv(h0 * inv_s0)
//   layer i < D-1 (folded, relu commutes with the positive next scale):
//         t = acc(q @ qw_i) * dqs_i + b_i [+ bf16 product of the skip rows]
//         q = lv(relu(t))
//   layer D-1 (unfolded): h = relu(acc * dqs + b [+ skip]); the alpha head on
//         bf16(h); q = lv(h * inv_s[D-1])
//   feat = bf16(acc(q @ feat_qw) * feat_dqs + feat_b)
//
// with dqs_i = s[i-1] * sw_i * fold_i, b_i = bias_i * fold_i, fold_i =
// 1 / s[i] (1 for the last layer), the skip rows' bf16 weights folded and
// rounded to bf16 again, lv(x) = clip(round(x), -127, 127).
//
// Rounding contract (r2l_int8.cu's, its header :24-37): an int32 sum of at
// most 256 products of |x| <= 127 is below 2^22, so its conversion to f32 is
// exact, and the plain version's f32 matmul of the same int8 values is exact
// in any order. The epilogues round each multiply and add on its own
// (__fmul_rn, __fadd_rn: no FMA contraction), round a level half to even and
// clip it at +-127, as torch.round and torch.clamp do. The kernel and its
// plain version (ops/nerf_int8.py::nerf_forward_int8_ref) then differ only
// where a bf16 product's f32 sum (layer 0, the skip rows, the heads, the view
// layer) lands an ulp apart and that ulp moves a value across a rounding
// boundary of the quantizer. The skip rows' product adds onto the layer's
// dequantized sum inside the tensor cores (t + sum, where the plain version
// sums the product first): an ulp of the same kind.
//
// Bound: per point 524,288 int8 multiply-adds (7 x 256^2 + 256^2) and 65,664
// bf16 (63 x 256 twice, 256, 256 x 128, 128 x 3) at W256 D8: at 1,979 TOPS and
// 989 TFLOP/s, a coarse chunk (2.10 M points) 1.111 + 0.278 = 1.39 ms, a fine
// chunk (6.29 M) 3.333 + 0.835 = 4.17 ms, a 400x400 frame 27.1 ms against
// the bf16 kernel's 48.9. Bound by operations. The design is the bf16 field
// tile's (nerf_wgmma.cuh: two warpgroups that split the tile's 128 rows,
// persistent blocks, a TMA weight ring that the second releasing warpgroup
// reloads) with s8 wgmma (m64nWk32, wgmma_s8.cuh) for the body and the
// feature head. The ring carries one mixed stream a tile: bf16 [W, 64]
// chunks of layer 0, the skip rows and the view layer, and int8 [W, 128]
// chunks of the body and the feature head, 32 KB a stage either way (22
// chunks, 0.66 MB, a tile at W256 D8 against the bf16 tile's 38 and 1.18
// MB). A warpgroup's int8 levels [64, W] take the first half of its own
// rows' bf16 activation tile, its embed the second half, and the feature
// head's bf16 output all of it once the products have read both; so one
// warpgroup never writes where the other's products read. At W256 a layer
// runs in two parts of 128 output columns, each its products and then its
// epilogue (64 sums a thread live, not 128). The epilogues read their f32
// scales and biases from shared memory (load_consts_int8).
// Not here: turns on the tensor cores (two named barriers, so that one
// warpgroup's products run under the other's epilogue) measured 9% slower,
// and deadlock where a layer has more chunks than the ring has stages.
#include <string.h>

#include "int8_epilogue.cuh"
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
  nw::Shape s;                      // s8 = 1
  nw::Model m;                      // body and feat: int8 maps; body_b, feat_b unread
  const float* body_dqs;            // [D - 1, W] folded dequantization scales
  const float* body_b;              // [D - 1, W] folded f32 biases
  const float* feat_dqs;            // [W]
  const float* feat_b;              // [W] f32
  const float* invs;                // [2]: 1 / s[0], 1 / s[D - 1]
};

__host__ __device__ inline nw::Layout int8_layout(const nw::Shape& s, int S) {
  return nw::layout(s, (size_t)2 * nw::rays_per_rows(S) * (s.W / 2) * 4, 0);
}

// The epilogues' vectors into sm.consts (nw::vec_words each): layer 0's
// bias, the body's dqs_1 .. dqs_{D-1}, then b_1 .. b_{D-1}, feat_dqs,
// feat_b; then the heads as load_consts puts them (alpha_w, views_b, rgb_w).
__device__ __forceinline__ void load_consts_int8(const Args& p, const nw::Smem& sm) {
  const int W = p.s.W, D = p.s.depth, half = W / 2, tid = threadIdx.x, n = nw::NTHREADS;
  const int vw = nw::vec_words(W), vh = nw::vec_words(half);
  float* v = reinterpret_cast<float*>(sm.consts);
  nw::put_vec(v, p.m.pts0_b, W, tid, n);
  for (int i = 1; i < D; ++i) {
    nw::put_vec(v + i * vw, p.body_dqs + (size_t)(i - 1) * W, W, tid, n);
    nw::put_vec(v + (D - 1 + i) * vw, p.body_b + (size_t)(i - 1) * W, W, tid, n);
  }
  nw::put_vec(v + (2 * D - 1) * vw, p.feat_dqs, W, tid, n);
  nw::put_vec(v + 2 * D * vw, p.feat_b, W, tid, n);
  float* heads = v + (2 * D + 1) * vw;
  nw::put_vec(heads, p.m.alpha_w, W, tid, n);
  nw::put_vec(heads + vw, p.m.views_b, half, tid, n);
  for (int c = 0; c < 3; ++c)
    nw::put_vec(heads + vw + (1 + c) * vh, p.m.rgb_w + (size_t)c * half, half, tid, n);
}

// Compile-time ints for the parts of a split layer.
template <int V>
struct Int {
  static constexpr int value = V;
};

// For each of this thread's column pairs in panels P0 .. P0 + NP - 1 (64
// columns each) of its two rows: v(i, c0, c1), the value (>= 0) of
// accumulator i (of NP * 32) from its columns' entries of the vectors c0
// and c1; with ALPHA, this thread's part of the alpha head on bf16(v), and
// then v * scale; the levels of pair (m, pn) of both rows as one word (row
// r0 in the low half) to sink(m, pn, word).
template <int W, int P0, int NP, bool ALPHA, class V, class Sink>
__device__ __forceinline__ void levels(const float* c0, const float* c1, const float* alpha_w,
                                       float scale, float (&ap)[2], V v, Sink sink) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const nw::Slot<W> a(c0, t, m), b(c1, t, m);
    nw::Slot<W> w = a;
    if (ALPHA) w = nw::Slot<W>(alpha_w, t, m);
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
      const int i = 4 * (8 * pl + m);
      const float2 ca = a.pair(P0 + pl), cb = b.pair(P0 + pl);
      unsigned word = 0;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float x = v(i + 2 * hf, ca.x, cb.x), y = v(i + 2 * hf + 1, ca.y, cb.y);
        if (ALPHA) {
          const unsigned h = nw::bf16x2<false>(x, y);
          const float2 aw = w.pair(P0 + pl);
          ap[hf] += nw::lo_f(h) * aw.x + nw::hi_f(h) * aw.y;
          x = __fmul_rn(x, scale);
          y = __fmul_rn(y, scale);
        }
        word |= (unsigned)pack_levels(level_bits_pos(x), level_bits_pos(y)) << (16 * hf);
      }
      sink(m, P0 + pl, word);
    }
  }
}

// Stores levels' word (m, pn) into q's swizzled [64, 128] int8 panels: thread
// (warp w, lane 4 g + t) holds rows 16 w + g and + 8 and, of each 16-byte
// chunk of a panel's 128-byte rows, the bytes 8 (m % 2) + 2 t, + 1 (column
// 64 pn + 8 m + 2 t: chunk 4 (pn % 2) + m / 2 of panel pn / 2), which the
// 128-byte swizzle puts at chunk ^ g.
__device__ __forceinline__ void store_levels(int8_t* q, int m, int pn, unsigned word) {
  const int tw = threadIdx.x % 128, lane = threadIdx.x % 32, g = lane / 4;
  unsigned char* at = reinterpret_cast<unsigned char*>(q) + (16 * (tw / 32) + g) * nw::KC8 +
                      2 * (lane % 4) + (pn / 2) * nw::PANEL8 +
                      (((4 * (pn % 2) + m / 2) ^ g) << 4) + 8 * (m % 2);
  *reinterpret_cast<unsigned short*>(at) = (unsigned short)word;
  *reinterpret_cast<unsigned short*>(at + 8 * nw::KC8) = (unsigned short)(word >> 16);
}

// acc = acc8 * dqs + b (f32, rounded as the plain version rounds it), the
// skip layer's t, onto which the skip rows' bf16 products then add.
template <int W>
__device__ __forceinline__ void dequantize(float (&acc)[W / 2], const int (&acc8)[W / 2],
                                           const float* dqs, const float* bias) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const nw::Slot<W> a(dqs, t, m), b(bias, t, m);
#pragma unroll
    for (int pn = 0; pn < W / nw::KC; ++pn) {
      const int i = 4 * (8 * pn + m);
      const float2 ca = a.pair(pn), cb = b.pair(pn);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i + e] = __fadd_rn(__fmul_rn(s32_to_f32(acc8[i + e]), e % 2 ? ca.y : ca.x),
                               e % 2 ? cb.y : cb.x);
    }
  }
}

// feat = bf16(acc8 * feat_dqs + feat_b) of panels P0 .. P0 + NP - 1 into
// this warpgroup's bf16 activation panels (nw::epilogue's addressing),
// which the view layer reads.
template <int W, int P0, int NP>
__device__ __forceinline__ void feat_store(const int (&acc8)[NP * 32], const float* dqs,
                                           const float* bias, __nv_bfloat16* act) {
  const int tw = threadIdx.x % 128, lane = threadIdx.x % 32, t = lane % 4, g = lane / 4;
  unsigned* row0 = reinterpret_cast<unsigned*>(act + (16 * (tw / 32) + g) * nw::KC + 2 * t);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const nw::Slot<W> a(dqs, t, m), b(bias, t, m);
    unsigned* at = row0 + ((m ^ g) << 2);
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
      const int i = 4 * (8 * pl + m), pn = P0 + pl;
      const float2 ca = a.pair(pn), cb = b.pair(pn);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        at[pn * nw::PANEL / 2 + hf * 8 * nw::KC / 2] = nw::bf16x2<false>(
            __fadd_rn(__fmul_rn(s32_to_f32(acc8[i + 2 * hf]), ca.x), cb.x),
            __fadd_rn(__fmul_rn(s32_to_f32(acc8[i + 2 * hf + 1]), ca.y), cb.y));
    }
  }
}

// The int8 field over one tile, by both warpgroups, each over its own 64
// rows (src: nw::field_tile's). At W256 each layer but the skip layer runs
// in two parts of 128 output columns (SPLIT): a part's products, then its
// epilogue, so that 64 sums a thread are live and not 128, which left the
// epilogues too few registers and spilled (PERF.md). The first part's
// products keep the layer's chunks in the ring for the second's; its levels
// wait in 16 registers until the second part's products have read q. (The
// skip layer in two parts too, its int8 chunks and its embed rows' chunk
// held together, gave the tile a 192-byte stack frame and took twice as
// long, PERF.md.)
template <int W, class Src>
__device__ __forceinline__ void field_tile_int8(const Args& p, const nw::Stream<true>& st,
                                                const nw::Smem& sm, nw::Cursor& k, Src& src) {
  constexpr int SPLIT = W == 256 ? 2 : 1, NH = W / SPLIT, NP = NH / nw::KC;
  const nw::Shape& s = st.s;
  const int wgi = threadIdx.x / 128, D = s.depth, skip = p.m.skip;
  const int kin = s.in_pad / nw::KC, kq = W / nw::KC8, vw = nw::vec_words(W);
  const float* consts = reinterpret_cast<const float*>(sm.consts);
  const float* heads = consts + (2 * D + 1) * vw;  // alpha_w, views_b, rgb_w
  __nv_bfloat16* act = sm.act + (size_t)wgi * nw::ROWS * W;
  int8_t* q = reinterpret_cast<int8_t*>(act);  // the levels: the rows' first W / 2 bf16
  __nv_bfloat16* x = sm.x + (size_t)wgi * nw::x_stride(s);
  nw::embed_rows(s, src, x, sm.pts + wgi * nw::ROWS * 3, wgi);

  float ap[2] = {0.0f, 0.0f};
  bool lost = false;
  const float inv0 = p.invs[0], finv = p.invs[1];
  auto end_epilogue = [&] {
    fence_proxy_async();  // the writes reach the next products' reads
    nw::bar_wg(wgi);
  };
  // A layer in SPLIT parts: part(Int<h>(), keep, sink) runs part h's
  // products (keep: all but the last) and levels; the levels of the first
  // part wait in `saved` until the last part's products have read q.
  auto split_levels = [&](auto part) {
    unsigned saved[8 * NP];
    if (SPLIT == 2)
      part(Int<0>(), true, [&](int m, int pn, unsigned w) { saved[m * NP + pn] = w; });
    part(Int<SPLIT - 1>(), false,
         [&](int m, int pn, unsigned w) { store_levels(q, m, pn, w); });
    if (SPLIT == 2)
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) store_levels(q, m, pl, saved[m * NP + pl]);
    end_epilogue();
  };

  // ---- layer 0 (bf16): q = lv(relu(acc + b0) * inv_s0)
  split_levels([&](auto hc, bool keep, auto sink) {
    constexpr int H = decltype(hc)::value;
    float acc[NH / 2];
    nw::products<NH>(acc, x, kin, false, st, sm, k, lost, H * NH, keep);
    levels<W, H * NP, NP, false>(
        consts, consts, heads, 0.0f, ap,
        [&](int i, float b, float) { return __fmul_rn(fmaxf(acc[i] + b, 0.0f), inv0); }, sink);
  });

  // ---- the body: t = acc * dqs + b [+ the skip rows' product]; q = lv(relu(t)),
  // at D - 1 h = relu(t), the alpha head on bf16(h) and q = lv(h * inv_s[D-1])
  for (int i = 1; i < D; ++i) {
    const float *dq = consts + i * vw, *bb = consts + (D - 1 + i) * vw;
    if (i == skip + 1) {
      // in one part: t into the f32 sums, onto which the bf16 products add
      // (products' wgmma.fence orders these register writes before them)
      float acc[W / 2];
      int acc8[W / 2];
      nw::products_s8<W>(acc8, q, kq, st, sm, k, lost);
      dequantize<W>(acc, acc8, dq, bb);
      nw::products<W>(acc, x, kin, true, st, sm, k, lost);
      auto relu_acc = [&](int j, float, float) { return fmaxf(acc[j], 0.0f); };
      auto sink = [&](int m, int pn, unsigned w) { store_levels(q, m, pn, w); };
      if (i < D - 1)
        levels<W, 0, W / nw::KC, false>(dq, bb, heads, 0.0f, ap, relu_acc, sink);
      else
        levels<W, 0, W / nw::KC, true>(dq, bb, heads, finv, ap, relu_acc, sink);
      end_epilogue();
      continue;
    }
    split_levels([&](auto hc, bool keep, auto sink) {
      constexpr int H = decltype(hc)::value;
      int acc8[NH / 2];
      nw::products_s8<NH>(acc8, q, kq, st, sm, k, lost, H * NH, keep);
      auto relu_t = [&](int j, float d, float b) {
        return fmaxf(__fadd_rn(__fmul_rn(s32_to_f32(acc8[j]), d), b), 0.0f);
      };
      if (i < D - 1)
        levels<W, H * NP, NP, false>(dq, bb, heads, 0.0f, ap, relu_t, sink);
      else
        levels<W, H * NP, NP, true>(dq, bb, heads, finv, ap, relu_t, sink);
    });
  }
  const float alpha[2] = {nw::quad_sum(ap[0]), nw::quad_sum(ap[1])};

  // ---- the feature head: bf16(acc * feat_dqs + feat_b) over the rows' act,
  // the last part first: its output lies past q (on the dead embed), so the
  // first part's products still read q whole
  auto feat_part = [&](auto hc, bool keep) {
    constexpr int H = decltype(hc)::value;
    int acc8[NH / 2];
    nw::products_s8<NH>(acc8, q, kq, st, sm, k, lost, H * NH, keep);
    feat_store<W, H * NP, NP>(acc8, consts + (2 * D - 1) * vw, consts + 2 * D * vw, act);
  };
  feat_part(Int<SPLIT - 1>(), SPLIT == 2);
  if (SPLIT == 2) feat_part(Int<0>(), false);
  end_epilogue();

  // ---- the view layer, then the rgb head
  nw::view_head<W>(p.m, st, sm, k, src, act, heads, alpha, lost);
}

// __grid_constant__: the tile takes the tensor maps' and the model's
// addresses without a local copy of them
template <int W>
__global__ void __launch_bounds__(nw::NTHREADS, 1)
    nerf_int8_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const nw::Smem sm = nw::smem_of(smem_raw, int8_layout(p.s, p.S));
  nw::point_tiles<W, true>(
      p, sm, [&] { load_consts_int8(p, sm); },
      [&](const nw::Stream<true>& st, nw::Cursor& k, nw::Rows<Args>& src) {
        field_tile_int8<W>(p, st, sm, k, src);
      });
}

}  // namespace

// Bytes of dynamic shared memory one block needs; above 232448 the shape is
// not supported.
extern "C" long long nerf_int8_smem_bytes(int in_pad, int W, int depth, int S) {
  const nw::Shape s = {in_pad, in_pad, 1, W, depth, 1};
  const nw::Layout l = int8_layout(s, S);
  return (long long)(l.ns >= 2 && l.total <= (size_t)nw::MAX_SMEM ? l.total : nw::MAX_SMEM + 1);
}

// The weight ring's stages at that shape.
extern "C" int nerf_int8_ring_stages(int in_pad, int W, int depth, int S) {
  const nw::Shape s = {in_pad, in_pad, 1, W, depth, 1};
  return int8_layout(s, S).ns;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// Shapes are checked by the Python wrapper; the checks here guard the
// kernel's own assumptions. body_qw [D-1, W, W] and feat_qw [W, W] are int8
// in nn.Linear's [out, in] layout; pts0_w and the folded skip_x_w [W, in_pad]
// and views_h_w [W/2, W] bf16.
extern "C" int nerf_int8_launch(
    const float* pts, long long s_pt, long long s_c, const float* dirs,
    const void* pts0_w, const void* pts0_b, const void* body_qw, const float* body_dqs,
    const float* body_b, const void* skip_x_w, const void* feat_qw, const float* feat_dqs,
    const float* feat_b, const float* invs, const void* views_h_w, const void* views_d_w,
    const void* views_b, const void* rgb_w, const void* alpha_w, const float* out_b,
    float* out, long long o_pt, long long o_c, long long P, int S, int in_ch, int in_pad,
    int ev, int W, int depth, int skip, void* stream) {
  if (P <= 0) return 0;
  Args a;
  memset(&a, 0, sizeof(a));
  a.s = nw::Shape{in_ch, in_pad, ev, W, depth, 1};
  const size_t smem = (size_t)nerf_int8_smem_bytes(in_pad, W, depth, S);
  if (!nw::shape_ok(a.s, skip) || S < 1 || smem > (size_t)nw::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  typedef const __nv_bfloat16* BP;
  nw::Model& m = a.m;
  m.pts0_b = static_cast<BP>(pts0_b);
  m.views_d_w = static_cast<BP>(views_d_w);
  m.views_b = static_cast<BP>(views_b);
  m.rgb_w = static_cast<BP>(rgb_w);
  m.alpha_w = static_cast<BP>(alpha_w);
  m.out_b = out_b;
  m.skip = skip;
  EncodeTiled fn = encoder();
  if (fn == nullptr ||
      !encode(fn, &m.pts0, pts0_w, in_pad, W, 1, 2LL * in_pad, 2LL * in_pad * W, W) ||
      !encode(fn, &m.body, body_qw, W, W, depth - 1, W, (long long)W * W, W, 1) ||
      !encode(fn, &m.skip_x, skip_x_w, in_pad, W, 1, 2LL * in_pad, 2LL * in_pad * W, W) ||
      !encode(fn, &m.feat, feat_qw, W, W, 1, W, (long long)W * W, W, 1) ||
      !encode(fn, &m.views_h, views_h_w, W, W / 2, 1, 2LL * W, 2LL * W * W / 2, W / 2))
    return (int)cudaErrorInvalidValue;
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
  a.body_dqs = body_dqs;
  a.body_b = body_b;
  a.feat_dqs = feat_dqs;
  a.feat_b = feat_b;
  a.invs = invs;
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 128: return nw::launch_tiles(nerf_int8_kernel<128>, a, smem, st);
    case 256: return nw::launch_tiles(nerf_int8_kernel<256>, a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
