// The teacher field on Hopper's asynchronous machinery: one tile of TM = 128
// points that the field-eval kernel (nerf_forward.cu) and the whole-ray
// kernel (nerf_frame.cu) run in bf16, and the W8A8 field-eval kernel
// (nerf_int8.cu) with int8 body layers and feature head (the Shape's s8: the
// ring then carries 128-column int8 chunks of those layers between the bf16
// chunks of layer 0, the skip rows and the view layer). The bf16 field:
//
//   point x -> embed [x, sin(2^0 x), cos(2^0 x), ...] (63-d at L 10): y = x 2^l
//              exact in f32, then fast_sin(y + phase) of trig.cuh (degree 7),
//              phase pi/2 for the cos columns; the identity columns pass y
//     -> layer 0, in_pad -> W, relu
//     -> layers 1..D-1, W -> W, relu; layer skip + 1 adds x @ skip_x_w to the
//        same sums
//     -> alpha head on bf16(h) with f32 sums; feature head, + bias, rounded to
//        bf16, no relu
//     -> view layer: feat @ views_h_w + hv_d[ray] + views_b, relu, where
//        hv_d = bf16(dirs_emb) @ views_d_w is computed once per ray by the
//        caller
//     -> rgb head on bf16(hv), f32 sums; raw = (rgb + out_b[0:3], alpha +
//        out_b[3]).
//
// Precision contract of the Pallas kernel (nerf_forward.cu): bf16 operands,
// f32 sums, bf16 inner biases added in f32, f32 out_b. Only the order of the
// sums differs from the plain version (ops/nerf_forward.py).
//
// The design:
//   * Row-split warpgroups. A block is two warpgroups (256 threads), and
//     warpgroup g owns rows [64 g, 64 g + 64) of the tile and every output
//     column: it issues wgmma.mma_async m64nNk16 (bf16 in, f32 out; N = W
//     for the body and the feature head, W / 2 for the view layer), A its
//     own 64 rows of the activation tile, B the ring stage. Each warpgroup
//     reads and writes only its own rows (embed, activations, view rows,
//     raw), so the epilogue that overwrites its tile in place needs
//     wgmma.wait_group 0, then after its stores a generic-to-async proxy
//     fence and a 128-thread named barrier, and no block barrier: the two
//     warpgroups meet only in the weight ring. A row's W columns lie in the
//     4 threads of a quad, so the alpha and rgb heads are quad shuffles in
//     registers. An epilogue is f32 bias adds (the biases staged once in
//     shared memory as f32, four columns a 16-byte load), one
//     cvt.rn.relu.bf16x2 and one 4-byte store a pair.
//   * A TMA weight ring of ns stages (as many as fit, up to MAX_STAGES: 4 at
//     W256 beside the few view rows of 64 or more samples a ray; fewer where
//     a tile straddles many rays), each a [W, 64] bf16 chunk: one box with the
//     128-byte swizzle from 3-D tensor maps over pack_nerf_weights's own
//     tensors (pts0_w, body_w, skip_x_w, feat_w, views_h_w). A tile streams
//     2 in_pad / 64 + (D + 1) W / 64 chunks (38 at W256 D8, in_pad 64), the
//     1.17 MB of weights. Each stage has a full mbarrier (the copy's bytes)
//     and an arrival counter: the warpgroup whose release of a stage is the
//     second of its round (an acq_rel atomic in shared memory) loads the
//     chunk ns ahead into it at once. So no thread waits for a stage to
//     free: a loader that waits (r2l_wgmma.cuh's thread 0) would hold its
//     warpgroup to the slower one, chunk by chunk, and a loader that defers
//     a load starved r2l_wgmma.cuh's ring (PERF.md).
//   * The stream runs on across tiles: the field-eval kernel's blocks are
//     persistent (one per SM at W256, tiles blockIdx.x + i gridDim.x), and
//     the whole-ray kernel's run from a ray group's coarse tiles into its
//     fine ones and on into the next group's, so no tile starts on an empty
//     ring.
//   * Not here: activations in registers as the next layer's A fragments
//     (wgmma with A from registers), which would drop the activation tile,
//     its stores and barriers. At W256 a thread then holds 128 f32 sums and
//     64 A registers; ptxas spilled and fenced every such wgmma, and the
//     kernel measured slower (PERF.md; the code is in commit 2e585a6).
//
// Shared memory (W256, in_pad 64): the ring, ns x 32 KB; the activation tile
// as swizzled [64, 64] panels, 64 KB; the embed, 16 KB (it stays until the
// skip layer has read it); the points, 1.5 KB; the epilogues' f32 biases and
// head weights, 13 KB at D8; the caller's view rows and extra region; the
// barriers. With ns = 4 and two rays' view rows: 224 KB. The int8 tile's
// epilogues take twice the vectors (a dequantization scale beside each
// bias: 21 KB at D8), and its embed moves into the second half of each
// warpgroup's activation rows, which its int8 levels leave free until the
// feature head's bf16 output takes them: 218 KB with 4 stages.
#pragma once

#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "r2l_tma.cuh"
#include "r2l_wgmma.cuh"  // wg::swz, wg::desc, wg::Wgmma<32 ... 128>, the wgmma fences
#include "trig.cuh"
#include "wgmma_s8.cuh"

namespace enerf {
namespace wg {

// The field's wider products: m64n192k16 and m64n256k16 (W192 and W256
// body layers)
template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "
      "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
  }
};

}  // namespace wg

namespace nw {

constexpr int TM = 128;              // points a tile
constexpr int ROWS = 64;             // of which a warpgroup owns one wgmma M
constexpr int NTHREADS = 256;        // two warpgroups
constexpr int KC = 64;               // contraction columns of a chunk (128 bytes)
constexpr int KC8 = 128;             // the same of an int8 chunk (128 bytes)
constexpr int PANEL = ROWS * KC;     // bf16 of one swizzled [64, 64] panel (8 KB)
constexpr int PANEL8 = ROWS * KC8;   // bytes of one swizzled [64, 128] int8 panel (8 KB)
constexpr int MAX_STAGES = 8;
constexpr int MAX_SMEM = 232448;     // 227 KB, the opt-in limit of sm_90
constexpr int MAX_DEPTH = 13;

// One model: tensor maps over the weights that stream, [layer][out][in] read
// in boxes of 128 bytes of input columns x all output rows (body and feat
// int8 in the s8 shape), and the other operands (bf16 unless noted; the int8
// kernel reads none of body_b and feat_b).
struct Model {
  CUtensorMap pts0, body, skip_x, feat, views_h;
  const __nv_bfloat16* pts0_b;     // [W]
  const __nv_bfloat16* body_b;     // [D - 1, W]
  const __nv_bfloat16* feat_b;     // [W]
  const __nv_bfloat16* views_d_w;  // [W / 2, ev]
  const __nv_bfloat16* views_b;    // [W / 2]
  const __nv_bfloat16* rgb_w;      // [3, W / 2]
  const __nv_bfloat16* alpha_w;    // [W]
  const float* out_b;              // [4], f32
  int skip;
};

// The shapes a block's models share; s8: int8 body layers and feature head.
struct Shape {
  int in_ch, in_pad, ev, W, depth, s8;
};

// log2 of the input columns of a body or feature-head chunk (a shift: the
// loading thread divides by it for every chunk)
__host__ __device__ inline int body_lkc(const Shape& s) { return s.s8 ? 7 : 6; }

__host__ __device__ inline int chunks_per_tile(const Shape& s) {
  return 2 * (s.in_pad / KC) + s.depth * (s.W >> body_lkc(s)) + s.W / KC;
}

// The int8 tile's embed fits the half of a warpgroup's activation rows that
// its int8 levels leave free.
__host__ __device__ inline bool x_in_act(const Shape& s) {
  return s.s8 && 2 * s.in_pad <= s.W;
}

// bf16 between the two warpgroups' embed panels.
__host__ __device__ inline int x_stride(const Shape& s) {
  return x_in_act(s) ? ROWS * s.W : ROWS * s.in_pad;
}

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

// Byte offsets from a 1024-aligned base; `total` includes the slack that
// aligns the dynamic shared memory to 1024 (the swizzle's period). ns is
// the most stages that fit, at most MAX_STAGES; below 2 the shape does not
// fit.
struct Layout {
  size_t ring, act, x, pts, consts, hvd, extra, full, freed, total;
  int ns;
};

// The epilogues' layout of an n-column vector (load_consts): f32, the two
// columns 8 (8 p + m) + 2 t, + 1 that quad column t holds of 16-byte chunk
// m of panel p < vec_panels(n) at [t][m][p][2], each (t, m) a slot of
// vec_slot(n) words (one or two 16-byte loads), each t's row padded by 4
// words so that the four t read other banks.
__host__ __device__ constexpr int vec_panels(int n) { return (n + 63) / 64; }
__host__ __device__ constexpr int vec_slot(int n) { return vec_panels(n) <= 2 ? 4 : 8; }
__host__ __device__ constexpr int vec_stride(int n) { return 8 * vec_slot(n) + 4; }
__host__ __device__ constexpr int vec_words(int n) { return 4 * vec_stride(n); }

// Words of one model's vectors: D + 1 biases (layer 0, the body, the
// feature head) and alpha_w, of W columns; views_b and rgb_w's 3 rows, of
// W / 2. The int8 tile has a dequantization scale beside each bias but
// layer 0's (its load_consts).
__host__ __device__ inline int consts_words(const Shape& s) {
  return (s.s8 ? 2 * s.depth + 2 : s.depth + 2) * vec_words(s.W) + 4 * vec_words(s.W / 2);
}

__host__ __device__ inline Layout layout(const Shape& s, size_t hvd_bytes, size_t extra_bytes) {
  const size_t stage = (size_t)s.W * KC * 2, act = (size_t)2 * ROWS * s.W * 2;
  const size_t x = x_in_act(s) ? 0 : (size_t)2 * ROWS * s.in_pad * 2;
  const size_t pts = (size_t)2 * ROWS * 3 * 4;
  const size_t consts = (size_t)consts_words(s) * 4;
  const size_t rest =
      act + x + pts + consts + align16(hvd_bytes) + align16(extra_bytes) + 1024;
  const size_t per = stage + sizeof(uint64_t) + sizeof(unsigned);
  long long ns = rest < (size_t)MAX_SMEM ? (long long)((MAX_SMEM - rest) / per) : 0;
  if (ns > MAX_STAGES) ns = MAX_STAGES;
  if (ns < 2) ns = 2;  // reported too large below
  Layout l;
  l.ns = (int)ns;
  l.ring = 0;
  l.act = ns * stage;
  l.x = x_in_act(s) ? l.act + (size_t)ROWS * s.W : l.act + act;
  l.pts = l.act + act + x;
  l.consts = l.pts + pts;
  l.hvd = l.consts + consts;
  l.extra = l.hvd + align16(hvd_bytes);
  l.full = l.extra + align16(extra_bytes);
  l.freed = l.full + ns * sizeof(uint64_t);
  l.total = l.freed + ns * sizeof(unsigned) + 1024;
  return l;
}

// The block's shared memory.
struct Smem {
  __nv_bfloat16* ring;   // ns stages of [W, 64]
  __nv_bfloat16* act;    // warpgroup g's W / 64 panels at g 64 W
  __nv_bfloat16* x;      // warpgroup g's in_pad / 64 panels at g x_stride(s)
  float* pts;            // warpgroup g's [64][3] at g 192
  unsigned* consts;      // the model's biases and head weights (load_consts)
  float* hvd;            // the caller's view rows
  unsigned char* extra;  // the caller's region
  uint64_t* full;        // [ns]
  unsigned* freed;       // [ns] releases of each stage
  int ns;
};

__device__ __forceinline__ Smem smem_of(unsigned char* raw, const Layout& l) {
  unsigned char* base = raw + ((1024 - (tma_smem_addr(raw) & 1023)) & 1023);
  Smem m;
  m.ring = reinterpret_cast<__nv_bfloat16*>(base + l.ring);
  m.act = reinterpret_cast<__nv_bfloat16*>(base + l.act);
  m.x = reinterpret_cast<__nv_bfloat16*>(base + l.x);
  m.pts = reinterpret_cast<float*>(base + l.pts);
  m.consts = reinterpret_cast<unsigned*>(base + l.consts);
  m.hvd = reinterpret_cast<float*>(base + l.hvd);
  m.extra = base + l.extra;
  m.full = reinterpret_cast<uint64_t*>(base + l.full);
  m.freed = reinterpret_cast<unsigned*>(base + l.freed);
  m.ns = l.ns;
  return m;
}

// The block's weight stream: chunk n is chunk n % cpt of tile n / cpt; of
// model m0 where that tile's place in its period of tiles is below `split`,
// else of m1 (the whole-ray kernel's coarse, then fine tiles of each ray
// group); total chunks. S8: the s8 shape's stream (its body and feature
// head in int8 chunks), a template parameter so that the bf16 kernels'
// loading thread computes its chunks with constant shifts.
template <bool S8 = false>
struct Stream {
  const Model *m0, *m1;
  Shape s;
  int cpt, period, split, total;
};

// A consumer's place in the stream: its next chunk c, the chunk's stage
// and the parity of the stage's phase.
struct Cursor {
  int c, s;
  unsigned ph;
};

// Columns 2 q, 2 q + 1 of a bf16 or f32 vector, as f32.
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* v, int q) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(v)[q]);
}
__device__ __forceinline__ float2 pair_f32(const float* v, int q) {
  return reinterpret_cast<const float2*>(v)[q];
}

// The n-column vector src into v in the layout of vec_words, by `nthreads`
// threads numbered `tid`.
template <class T>
__device__ __forceinline__ void put_vec(float* v, const T* src, int n, int tid, int nthreads) {
  const int slot = vec_slot(n), stride = vec_stride(n);
  for (int q = tid; q < n / 2; q += nthreads) {
    const int j = q / 4, t = q % 4;  // columns 2 q, 2 q + 1 = 8 j + 2 t, + 1
    const float2 f = pair_f32(src, q);
    float* d = v + t * stride + (j % 8) * slot + (j / 8) * 2;
    d[0] = f.x;
    d[1] = f.y;
  }
}

// Model m's epilogue operands into sm.consts as f32 vectors (vec_words),
// by `nthreads` threads numbered `tid`: D + 1 biases (layer 0, the body,
// the feature head) and alpha_w, then views_b and rgb_w's three rows. The
// caller orders these writes after the last tile's reads and before the
// next's.
__device__ __forceinline__ void load_consts(const Model& m, const Shape& s, const Smem& sm,
                                            int tid, int nthreads) {
  const int W = s.W, half = W / 2, vw = vec_words(W), vh = vec_words(half);
  float* v = reinterpret_cast<float*>(sm.consts);
  for (int l = 0; l <= s.depth; ++l)
    put_vec(v + l * vw,
            l == 0 ? m.pts0_b : l < s.depth ? m.body_b + (size_t)(l - 1) * W : m.feat_b, W,
            tid, nthreads);
  float* heads = v + (s.depth + 1) * vw;
  put_vec(heads, m.alpha_w, W, tid, nthreads);
  put_vec(heads + vw, m.views_b, half, tid, nthreads);
  for (int c = 0; c < 3; ++c)
    put_vec(heads + vw + (1 + c) * vh, m.rgb_w + (size_t)c * half, half, tid, nthreads);
}

// Thread t's slot m of an n-column vector of load_consts: the f32 pairs of
// its columns in panels 0 .. 3, as {x, y} of slot element 2 p, 2 p + 1.
template <int N>
struct Slot {
  float4 a, b;
  __device__ __forceinline__ Slot(const float* v, int t, int m) {
    const float* p = v + t * vec_stride(N) + m * vec_slot(N);
    a = *reinterpret_cast<const float4*>(p);
    if (vec_slot(N) == 8) b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ float2 pair(int pn) const {
    return pn == 0 ? make_float2(a.x, a.y)
                   : pn == 1 ? make_float2(a.z, a.w) : pn == 2 ? make_float2(b.x, b.y)
                                                               : make_float2(b.z, b.w);
  }
};

using wg::bf16x2;

__device__ __forceinline__ float lo_f(unsigned h) { return __uint_as_float(h << 16); }
__device__ __forceinline__ float hi_f(unsigned h) { return __uint_as_float(h & 0xffff0000u); }

__device__ __forceinline__ void bar_wg(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
}

// Chunk q of a tile's stream of model m into dst, completing on bar: layer
// 0 (in_pad / 64 chunks), the body layers (W / 64, or W / 128 with S8, each; layer skip + 1
// then its embed rows, in_pad / 64), the feature head, the view layer (W / 2
// rows). A box is 128 bytes of each of its rows, bf16 or int8.
template <bool S8>
__device__ __forceinline__ void load_chunk(const Model& m, const Shape& s, int q,
                                           __nv_bfloat16* dst, uint64_t* bar) {
  constexpr int lkb = S8 ? 7 : 6;  // log2 of a body chunk's input columns
  const int kin = s.in_pad / KC, kw = s.W >> lkb;
  const CUtensorMap* map = nullptr;
  int col = 0, layer = 0, rows = s.W;  // col: the box's first input column
  if (q < kin) {
    map = &m.pts0;
    col = q * KC;
  } else {
    q -= kin;
    for (int i = 1; i < s.depth && map == nullptr; ++i) {
      if (q < kw) {
        map = &m.body;
        col = q << lkb;
        layer = i - 1;
      } else {
        q -= kw;
        if (i == m.skip + 1) {
          if (q < kin) {
            map = &m.skip_x;
            col = q * KC;
          } else {
            q -= kin;
          }
        }
      }
    }
    if (map == nullptr) {
      if (q < kw) {
        map = &m.feat;
        col = q << lkb;
      } else {
        map = &m.views_h;
        col = (q - kw) * KC;
        rows = s.W / 2;
      }
    }
  }
  mbar_arrive_expect_tx(bar, rows * 128);
  tma_box(dst, map, col, 0, layer, bar);
}

// Loads chunk n of the stream into its stage (nothing past the end).
template <bool S8>
__device__ __forceinline__ void load(const Stream<S8>& st, const Smem& sm, int n) {
  if (n >= st.total) return;
  const int tile = n / st.cpt, stg = n % sm.ns;
  load_chunk<S8>(tile % st.period < st.split ? *st.m0 : *st.m1, st.s, n - tile * st.cpt,
             sm.ring + (size_t)stg * st.s.W * KC, &sm.full[stg]);
}

// The barriers and the first ns chunks, by thread 0; ends with a block
// barrier.
template <bool S8>
__device__ __forceinline__ void ring_start(const Stream<S8>& st, const Smem& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < sm.ns; ++s) {
      mbar_init(&sm.full[s], 1);  // the loading thread's arrival, plus the bytes
      sm.freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int n = 0; n < sm.ns; ++n) load(st, sm, n);
  }
  __syncthreads();
}

// This warpgroup has read chunk c (stage stg). The second warpgroup to
// release a stage in its round loads the chunk ns ahead into it.
template <bool S8>
__device__ __forceinline__ void release(const Stream<S8>& st, const Smem& sm, int c, int stg) {
  if (threadIdx.x % 128 == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_block> freed(sm.freed[stg]);
    if (freed.fetch_add(1u, cuda::memory_order_acq_rel) & 1u) load(st, sm, c + sm.ns);
  }
}

// Waits for the phase of parity `parity` of a stage's full barrier. A wait
// of about ten seconds means a lost copy: it sets `lost` and returns, and
// the tile traps at its end, when no wgmma is in flight (ptxas injects a
// wait for the accumulators before a trap that a wgmma in flight could
// reach, which cost the products 12%, PERF.md).
__device__ __forceinline__ void ring_wait(uint64_t* bar, unsigned parity, bool& lost) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tma_smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) {
      lost = true;
      return;
    }
  }
}

// acc (+)= A[64, 64 nk] @ (the stream's next nk chunks)^T, A in swizzled
// panels of shared memory; the sums start from acc with `carry`, else from
// zero. The products take the chunks' rows row0 .. row0 + N - 1 (output
// columns); keep leaves the chunks in the ring and the cursor before them,
// for products of their other rows.
template <int N, bool S8>
__device__ __forceinline__ void products(float (&acc)[N / 2], const __nv_bfloat16* A, int nk,
                                         bool carry, const Stream<S8>& st, const Smem& sm,
                                         Cursor& k, bool& lost, int row0 = 0,
                                         bool keep = false) {
  const Cursor k0 = k;
  int prev_c = 0, prev_s = 0;
  for (int kc = 0; kc < nk; ++kc) {
    ring_wait(&sm.full[k.s], k.ph, lost);
    const uint64_t da = wg::desc(A + kc * PANEL);
    const uint64_t db = wg::desc(sm.ring + (size_t)k.s * st.s.W * KC + row0 * KC);
    wg::wgmma_fence();
#pragma unroll
    for (int j = 0; j < KC / 16; ++j)
      wg::Wgmma<N>::run(acc, da + 2 * j, db + 2 * j, carry || kc + j > 0);
    wg::wgmma_commit();
    if (kc > 0 && !keep) {
      wg::wgmma_wait<1>();  // the chunk before this one has been read
      release(st, sm, prev_c, prev_s);
    }
    prev_c = k.c;
    prev_s = k.s;
    ++k.c;
    if (++k.s == sm.ns) {
      k.s = 0;
      k.ph ^= 1u;
    }
  }
  wg::wgmma_wait<0>();
  if (keep)
    k = k0;
  else
    release(st, sm, prev_c, prev_s);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) wg::fence_reg(acc[i]);
}

// acc = A[64, 128 nk] @ (the stream's next nk int8 chunks)^T, s8 x s8 -> s32,
// A in swizzled [64, 128] int8 panels of shared memory: products' ring walk
// with 4 k32 steps of 32 bytes a chunk, row0 and keep as products' (no
// release then, and the cursor back before the chunks). The first step
// writes acc without reading it (WgmmaS8::first), so that no earlier sums
// stay live into it.
template <int N>
__device__ __forceinline__ void products_s8(int (&acc)[N / 2], const int8_t* A, int nk,
                                            const Stream<true>& st, const Smem& sm, Cursor& k,
                                            bool& lost, int row0 = 0, bool keep = false) {
  const Cursor k0 = k;
  int prev_c = 0, prev_s = 0;
  auto chunk = [&](int kc, bool first) {
    ring_wait(&sm.full[k.s], k.ph, lost);
    const uint64_t da = wg::desc(A + kc * PANEL8);
    const uint64_t db = wg::desc(sm.ring + (size_t)k.s * st.s.W * KC + row0 * KC);
    wg::wgmma_fence();
    if (first)
      wg::WgmmaS8<N>::first(acc, da, db);
    else
      wg::WgmmaS8<N>::run(acc, da, db, 1);
#pragma unroll
    for (int j = 1; j < KC8 / 32; ++j) wg::WgmmaS8<N>::run(acc, da + 2 * j, db + 2 * j, 1);
    wg::wgmma_commit();
    if (kc > 0 && !keep) {
      wg::wgmma_wait<1>();  // the chunk before this one has been read
      release(st, sm, prev_c, prev_s);
    }
    prev_c = k.c;
    prev_s = k.s;
    ++k.c;
    if (++k.s == sm.ns) {
      k.s = 0;
      k.ph ^= 1u;
    }
  };
  chunk(0, true);
  for (int kc = 1; kc < nk; ++kc) chunk(kc, false);
  wg::wgmma_wait<0>();
  if (keep)
    k = k0;
  else
    release(st, sm, prev_c, prev_s);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) wg::fence_reg(acc[i]);
}

// acc + bias -> this warpgroup's activation panels as bf16 (RELU: relu
// first); with ALPHA, also this thread's part of the alpha head on those
// bf16 values for its two rows. bias and alpha_w: W-column vectors of
// load_consts. Thread (warp w, lane 4 g + t) holds rows 16 w + g and + 8,
// and of each 16-byte chunk m of a panel's 128-byte rows the columns 2 t,
// 2 t + 1; the 128-byte swizzle puts chunk m of those rows at chunk m ^ g.
template <int W, bool RELU, bool ALPHA>
__device__ __forceinline__ void epilogue(const float (&acc)[W / 2], const float* bias,
                                         const float* alpha_w, __nv_bfloat16* act, int wgi,
                                         float (&ap)[2]) {
  const int tw = threadIdx.x % 128, lane = threadIdx.x % 32, t = lane % 4, g = lane / 4;
  unsigned* row0 = reinterpret_cast<unsigned*>(act + (16 * (tw / 32) + g) * KC + 2 * t);
  // (no barrier first: once wgmma.wait_group 0 returns in any of its
  // threads, the warpgroup's products have read the panels)
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const Slot<W> b(bias, t, m);
    Slot<W> w = b;
    if (ALPHA) w = Slot<W>(alpha_w, t, m);
    unsigned* at = row0 + ((m ^ g) << 2);  // chunk m of row r0, in 4-byte words
#pragma unroll
    for (int pn = 0; pn < W / KC; ++pn) {
      const int i = 4 * (8 * pn + m);
      const float2 bp = b.pair(pn);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const unsigned h = bf16x2<RELU>(acc[i + 2 * hf] + bp.x, acc[i + 2 * hf + 1] + bp.y);
        at[pn * PANEL / 2 + hf * 8 * KC / 2] = h;
        if (ALPHA) {
          const float2 aw = w.pair(pn);
          ap[hf] += lo_f(h) * aw.x + hi_f(h) * aw.y;
        }
      }
    }
  }
  fence_proxy_async();  // the writes reach the next products' reads
  bar_wg(wgi);
}

// sum of v over the 4 lanes of a quad (the threads of one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The embed of this warpgroup's rows into its panels x (zeros past src.rows
// and in_ch) by its 128 threads, ending with the warpgroup barrier that
// orders it before the products; pts: the warpgroup's [64][3] points.
template <class Src>
__device__ __forceinline__ void embed_rows(const Shape& s, Src& src, __nv_bfloat16* x,
                                           float* pts, int wgi) {
  const int tw = threadIdx.x % 128, kin = s.in_pad / KC, rows = src.rows;
  if (tw < ROWS)
    for (int c = 0; c < 3; ++c) pts[tw * 3 + c] = tw < rows ? src.pt(tw, c) : 0.0f;
  bar_wg(wgi);
  for (int q = 0; q < kin; ++q) {
    const int e = q * KC + tw % KC, grp = e / 3, c = e % 3;
    const bool live = e < s.in_ch;
    const float freq = grp > 0 ? (float)(1 << ((grp - 1) / 2)) : 1.0f;
    // the sin columns add a zero phase, as the Pallas kernel does
    const float phase = (grp > 0 && (grp - 1) % 2) ? (float)1.5707963267948966 : 0.0f;
    for (int row = tw / KC; row < ROWS; row += 128 / KC) {
      float v = 0.0f;
      if (live && row < rows) {
        const float xv = pts[row * 3 + c];
        v = grp == 0 ? xv : fast_sin(__fadd_rn(__fmul_rn(xv, freq), phase), 7);  // exact y
      }
      x[wg::swz(row, e)] = __float2bfloat16_rn(v);
    }
  }
  fence_proxy_async();
  bar_wg(wgi);
}

// The view layer over this warpgroup's rows (A its bf16 feature panels act),
// then the rgb head; raw out by the quad (lane t of a row's quad stores
// channel t, alpha[hf] the sigma of row r0 + 8 hf). heads: alpha_w, then
// views_b and rgb_w's rows (load_consts). Traps on a lost copy of the
// tile's stream.
template <int W, class Src, bool S8>
__device__ __forceinline__ void view_head(const Model& m, const Stream<S8>& st, const Smem& sm,
                                          Cursor& k, Src& src, const __nv_bfloat16* act,
                                          const float* heads, const float (&alpha)[2],
                                          bool& lost) {
  constexpr int HALF = W / 2;
  const int tw = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int t = lane % 4, r0 = 16 * (tw / 32) + lane / 4, rows = src.rows;
  float accv[HALF / 2];
  products<HALF>(accv, act, W / KC, false, st, sm, k, lost);
  if (lost) __trap();  // a lost copy fails the launch instead of hanging the card
  const float* hvr[2] = {src.hv(r0), src.hv(r0 + 8)};
  const float* views_b = heads + vec_words(W);
  float rp[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
  for (int mc = 0; mc < (HALF < KC ? HALF / 8 : 8); ++mc) {
    const Slot<HALF> vb(views_b, t, mc), w0(views_b + vec_words(HALF), t, mc),
        w1(views_b + 2 * vec_words(HALF), t, mc), w2(views_b + 3 * vec_words(HALF), t, mc);
#pragma unroll
    for (int pn = 0; pn < vec_panels(HALF); ++pn) {
      if (8 * pn + mc >= HALF / 8) continue;  // W192: 96 columns, a panel and a half
      const int i = 4 * (8 * pn + mc), col = 8 * (8 * pn + mc) + 2 * t;
      const float2 b = vb.pair(pn), wr = w0.pair(pn), wgn = w1.pair(pn), wb = w2.pair(pn);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 hd = *reinterpret_cast<const float2*>(hvr[hf] + col);
        // (feat @ W + hv_d[ray]) + b, in the Pallas kernel's order
        const unsigned h = bf16x2<true>(__fadd_rn(__fadd_rn(accv[i + 2 * hf], hd.x), b.x),
                                        __fadd_rn(__fadd_rn(accv[i + 2 * hf + 1], hd.y), b.y));
        const float h0 = lo_f(h), h1 = hi_f(h);
        rp[hf][0] += h0 * wr.x + h1 * wr.y;
        rp[hf][1] += h0 * wgn.x + h1 * wgn.y;
        rp[hf][2] += h0 * wb.x + h1 * wb.y;
      }
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float r = quad_sum(rp[hf][0]), g = quad_sum(rp[hf][1]), b = quad_sum(rp[hf][2]);
    const int row = r0 + 8 * hf;
    if (row < rows) {
      const float v = t == 0 ? r : t == 1 ? g : t == 2 ? b : alpha[hf];
      src.out(row, t, v + m.out_b[t]);
    }
  }
}

// The field over one tile, by both warpgroups, each over its own 64 rows.
// src (this warpgroup's rows) gives: rows, the rows that hold points;
// pt(row, c), coordinate c of the point of row < rows; hv(row), the f32
// view row [W / 2] of the row's ray (for rows past `rows`, any view row of
// the caller's); out(row, c, v), raw channel c (rgb, then sigma) of row <
// rows. The
// caller orders its writes of what hv reads before this call's epilogues
// (a warpgroup or block barrier), and after the reads of the last call.
template <int W, class Src>
__device__ __forceinline__ void field_tile(const Model& m, const Stream<>& st, const Smem& sm,
                                           Cursor& k, Src& src) {
  const Shape& s = st.s;
  const int wgi = threadIdx.x / 128;
  const int kin = s.in_pad / KC, vw = vec_words(W);
  const float* consts = reinterpret_cast<const float*>(sm.consts);
  const float* heads = consts + (s.depth + 1) * vw;  // alpha_w, views_b, rgb_w
  __nv_bfloat16* act = sm.act + (size_t)wgi * ROWS * W;
  __nv_bfloat16* x = sm.x + (size_t)wgi * ROWS * s.in_pad;
  embed_rows(s, src, x, sm.pts + wgi * ROWS * 3, wgi);

  // ---- layer 0, the body (the skip's embed rows into the same sums), the
  // alpha head from the last body layer's epilogue
  float acc[W / 2];
  float ap[2] = {0.0f, 0.0f};
  bool lost = false;
  products<W>(acc, x, kin, false, st, sm, k, lost);
  epilogue<W, true, false>(acc, consts, heads, act, wgi, ap);
  for (int i = 1; i < s.depth; ++i) {
    products<W>(acc, act, W / KC, false, st, sm, k, lost);
    if (i == m.skip + 1) products<W>(acc, x, kin, true, st, sm, k, lost);
    if (i == s.depth - 1)
      epilogue<W, true, true>(acc, consts + i * vw, heads, act, wgi, ap);
    else
      epilogue<W, true, false>(acc, consts + i * vw, heads, act, wgi, ap);
  }
  const float alpha[2] = {quad_sum(ap[0]), quad_sum(ap[1])};

  // ---- the feature head: bf16(acc + b), no relu
  products<W>(acc, act, W / KC, false, st, sm, k, lost);
  epilogue<W, false, false>(acc, consts + s.depth * vw, heads, act, wgi, ap);

  // ---- the view layer, then the rgb head
  view_head<W>(m, st, sm, k, src, act, heads, alpha, lost);
}

// hvd[ri] = bf16(dirs_emb) @ views_d_w^T for nr rays, by `nthreads` threads
// numbered `tid`; dir(ri) points at ray ri's ev embedded direction values.
template <class Dir>
__device__ __forceinline__ void view_rows(float* hvd, int nr, int half, int ev,
                                          const __nv_bfloat16* views_d_w, int tid, int nthreads,
                                          Dir dir) {
  for (int idx = tid; idx < nr * half; idx += nthreads) {
    const int ri = idx / half, col = idx % half;
    const float* de = dir(ri);
    const __nv_bfloat16* wd = views_d_w + (size_t)col * ev;
    float s = 0.0f;
#pragma unroll 9
    for (int kk = 0; kk < ev; ++kk)
      s = fmaf(__bfloat162float(__float2bfloat16_rn(de[kk])), __bfloat162float(wd[kk]), s);
    hvd[ri * half + col] = s;
  }
}

// Rays that 64 consecutive points can touch at S samples a ray.
__host__ __device__ inline int rays_per_rows(int S) {
  const int r = (ROWS - 1) / S + 2;
  return r < ROWS ? r : ROWS;
}

// One warpgroup's rows of a tile of a field-eval kernel (nerf_forward.cu,
// nerf_int8.cu): points p0 .. p0 + rows - 1, their view rows from ray r0
// on. A, the kernel's arguments: point q's coordinate c at pts[q * s_pt + c
// * s_c], raw channel c at out[q * o_pt + c * o_c], S samples a ray, the
// Shape s.
template <class A>
struct Rows {
  const A* p;
  long long p0, r0;
  int rows;
  const float* hvd;
  __device__ float pt(int row, int c) const { return p->pts[(p0 + row) * p->s_pt + c * p->s_c]; }
  __device__ const float* hv(int row) const {
    if (rows <= 0) return hvd;
    const long long q = p0 + (row < rows ? row : rows - 1);
    return hvd + (q / p->S - r0) * (p->s.W / 2);
  }
  __device__ void out(int row, int c, float v) const {
    p->out[(p0 + row) * p->o_pt + c * p->o_c] = v;
  }
};

// The field-eval kernels' walk: persistent blocks over the tiles of the P
// points of p (tiles blockIdx.x + i gridDim.x), one weight stream across
// them. consts() writes the model's epilogue operands (before the ring's
// first block barrier); for each tile, each warpgroup makes its rows' view
// rows (dirs [N, ev], room for nr_wg rays a warpgroup), then tile(st, k,
// src) runs the field on them. S8: the s8 shape's stream.
template <int W, bool S8 = false, class A, class Consts, class Tile>
__device__ __forceinline__ void point_tiles(const A& p, const Smem& sm, Consts consts,
                                            Tile tile) {
  const long long tiles = (p.P + TM - 1) / TM;
  const int nt = (int)((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);  // this block's
  Stream<S8> st;
  st.m0 = st.m1 = &p.m;
  st.s = p.s;
  st.cpt = chunks_per_tile(p.s);
  st.period = st.split = nt;
  st.total = nt * st.cpt;
  consts();
  ring_start(st, sm);  // (its block barrier orders the consts' writes)

  const int wgi = threadIdx.x / 128, tw = threadIdx.x % 128, half = W / 2;
  float* hvd = sm.hvd + (size_t)wgi * p.nr_wg * half;
  Cursor k = {0, 0, 0u};
  for (int i = 0; i < nt; ++i) {
    Rows<A> src;
    src.p = &p;
    src.p0 = (blockIdx.x + (long long)i * gridDim.x) * TM + ROWS * wgi;
    const long long left = p.P - src.p0;
    src.rows = left <= 0 ? 0 : left < ROWS ? (int)left : ROWS;
    src.r0 = src.p0 / p.S;
    src.hvd = hvd;
    bar_wg(wgi);  // the last tile's view epilogue has read the view rows
    if (src.rows > 0) {
      const int nr = (int)((src.p0 + src.rows - 1) / p.S - src.r0) + 1;
      view_rows(hvd, nr, half, p.s.ev, p.m.views_d_w, tw, 128,
                [&](int ri) { return p.dirs + (src.r0 + ri) * p.s.ev; });
    }
    // (the embed's warpgroup barrier orders these writes before their reads)
    tile(st, k, src);
  }
}

// Host side: the shapes the tile takes, and one model's tensor maps.
inline bool shape_ok(const Shape& s, int skip) {
  return (s.W == 64 || s.W == 128 || s.W == 192 || s.W == 256) &&
         s.W % (1 << body_lkc(s)) == 0 &&
         s.in_pad % KC == 0 &&
         s.in_pad >= s.in_ch && s.in_ch >= 1 && s.ev >= 1 && s.depth >= 2 &&
         s.depth <= MAX_DEPTH && skip >= 0 && skip + 1 < s.depth;
}

// Fills m from one model's operands in ops/nerf_forward.py's _OPERANDS order
// (pts0_w, pts0_b, body_w, body_b, skip_x_w, feat_w, feat_b, views_h_w,
// views_d_w, views_b, rgb_w, alpha_w), then out_b; false if a tensor map
// cannot be made.
inline bool make_model(Model* m, const void* const* w, const Shape& s, int skip) {
  typedef const __nv_bfloat16* BP;
  const int W = s.W, in_pad = s.in_pad;
  m->pts0_b = static_cast<BP>(w[1]);
  m->body_b = static_cast<BP>(w[3]);
  m->feat_b = static_cast<BP>(w[6]);
  m->views_d_w = static_cast<BP>(w[8]);
  m->views_b = static_cast<BP>(w[9]);
  m->rgb_w = static_cast<BP>(w[10]);
  m->alpha_w = static_cast<BP>(w[11]);
  m->out_b = static_cast<const float*>(w[12]);
  m->skip = skip;
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         encode(fn, &m->pts0, w[0], in_pad, W, 1, 2LL * in_pad, 2LL * in_pad * W, W) &&
         encode(fn, &m->body, w[2], W, W, s.depth - 1, 2LL * W, 2LL * W * W, W) &&
         encode(fn, &m->skip_x, w[4], in_pad, W, 1, 2LL * in_pad, 2LL * in_pad * W, W) &&
         encode(fn, &m->feat, w[5], W, W, 1, 2LL * W, 2LL * W * W, W) &&
         encode(fn, &m->views_h, w[7], W, W / 2, 1, 2LL * W, 2LL * W * W / 2, W / 2);
}

// Blocks of `kernel` that fit on the card at once (persistent grids).
template <class K>
inline int resident_blocks(K kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

// Launches a field-eval kernel of arguments a on min(tiles, resident) blocks
// (persistent); returns cudaGetLastError().
template <class K, class A>
inline int launch_tiles(K kernel, const A& a, size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (a.P + TM - 1) / TM;
  const int resident = resident_blocks(kernel, smem);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace nw
}  // namespace enerf
