// The R2L forward tile on Hopper's asynchronous machinery: one header, three
// kernels. The serving forward (r2l_forward.cu, rays in, rgb out), the
// training forward (r2l_train.cu, points or rows in, rgb and the 44 bf16
// block inputs hs out) and the W8A8 serving forward (r2l_int8.cu, its body
// on s8 wgmma: the template's Q) all run
//
//   embed -> head (in_pad -> W, relu) -> n_block x (lin, relu, lin,
//   * res_scale, + h) -> optional global residual (+ h0) -> tail + sigmoid
//
// on a tile of TB = 64 rays, keeping what the Pallas kernels kept out of
// device memory: only the rays (or points) in and rgb (and hs) out reach
// HBM. Precision contract of the Pallas kernels: bf16 operands with f32
// sums; f32 bias, relu, residual h = __fadd_rn(__fmul_rn(v, rs), h), as the
// plain versions round it; bf16(h) only as an operand; an f32 tail with a
// sigmoid.
//
// Bound: the products, 2 x 64 x (in_pad W + 2 n_block W^2) FLOP a tile
// against 11.8 MB of weights that every tile reads (W256 D88). With 64 rays
// a tile the weights cross from L2 to the SMs once a tile: 29.5 GB for a
// 160,000-ray frame. The design:
//   * A TMA weight ring that no thread waits on to load. Each [Wp, 64]
//     weight chunk (Wp = W rounded up to 64; 64 contraction columns = one
//     128-byte swizzle row) is one cp.async.bulk.tensor from 3-D tensor maps
//     over head_w [W, in_pad] and body_w [2 n_block][W][W] into a ring of S
//     stages, S chunks ahead of the products, completing on the stage's full
//     mbarrier. Rows and columns past W land as zeros, so a width that is not
//     a multiple of 64 runs on zero padding. Thread 0 loads the first S
//     chunks; after that each warp, once its products have read a stage,
//     counts its release in shared memory (an acq_rel atomic), and the warp
//     whose release is the stage's eighth loads the chunk S ahead into it.
//     A loading thread that waits for the stage to be free (the design
//     before, an empty mbarrier and thread 0) holds its warpgroup to the
//     slowest warp of the other at every chunk, and one that defers a load
//     starves the ring (PERF.md: both measured slower). The loaders are
//     consumers: a producer warpgroup makes the block 384 threads, three
//     warps on each SM sub-partition, which caps ptxas at 168 registers a
//     thread in every branch (setmaxnreg moves registers at run time but
//     ptxas allocated the consumers within 168 and spilled their sums,
//     PERF.md); with 256 threads each has 255.
//   * wgmma for the products. The block's two warpgroups share the tile's 64
//     rays: warpgroup g owns output columns [g NT, g NT + NT), NT = Wp / 2,
//     of every layer and issues wgmma.mma_async m64nNTk16 (bf16 in, f32
//     out), A the activation tile in shared memory, B the ring stage, both
//     K-major in the 128-byte swizzle that TMA writes. Each thread holds NT
//     / 2 f32 sums and the NT / 2 f32 values of the residual stream h that
//     it owns, across all layers. The epilogues write a / a2 straight into
//     the swizzled layout that the next layer's A descriptor reads. Each
//     thread's biases of the next layer are loaded as the epilogue uses this
//     layer's, a layer ahead: an L2 read under the weight stream outlasts a
//     layer's products (PERF.md).
//   * Per-panel barriers where each warpgroup owns whole 64-column panels of
//     a and a2 (NT a multiple of 64: W 65-128 and 193-256; per_panel). A
//     layer's epilogue writes its panels one at a time by stmatrix (four
//     8x8 matrices of bf16 pairs, packed by cvt.rn[.relu].bf16x2), fences
//     each for the async proxy and arrives on that panel's mbarrier (one
//     arrival a warp of the owner); the next layer's products wait for panel
//     k just before their chunk k. So a warpgroup starts on its own panels
//     as soon as it has written them and on the other's as each is written,
//     and no block barrier holds both to the slower epilogue. A panel is
//     rewritten two layers on, after its owner has passed the other
//     warpgroup's signals of the layer between, which follow that warpgroup's
//     reads: a and a2 need no more barriers. At other widths (NT 32, 96) a
//     warpgroup's columns straddle a panel, and the block meets at one
//     barrier a layer. The choice is made by NT at compile time, as PARTS
//     is.
//   * Why not two tiles in flight, one's epilogue under the other's
//     products: at W256 a thread keeps 64 f32 sums and 64 f32 values of h
//     (the residual stream is f32 by the precision contract), and the tile
//     takes ~240 of 255 registers and 224 of 227 KB of shared memory; a
//     second tile doubles both, and four consumer warpgroups would cap a
//     thread at 128 registers.
//   * No cluster: each block streams every chunk alone. Two blocks that
//     share each chunk by multicast read half the weights from L2, but a
//     stage is then freed only when the warps of both have read it, and
//     three stages cannot hide that coupling across SMs: measured slower
//     (PERF.md).
//   * int8 (Q > 0): the body's two products a block are s8 wgmma (m64nNTk32,
//     wgmma_s8.cuh) on int8 A panels q(h) and q(g), [64, 128] each with the
//     128-byte swizzle, and the ring carries [Wp, 128] int8 chunks of the
//     body after the head's bf16 chunks (32 KB a stage at W256 either way).
//     The epilogues dequantize from s32 (int8_epilogue.cuh) and write the
//     next layer's levels; the residual stream h stays in f32 registers, and
//     a = bf16(h) is made once, for the tail. Each layer's f32 weight scales
//     and biases are prefetched by cp.async into shared memory during the
//     layer before (2 slots), so no epilogue waits on device memory. Dynamic
//     scales take each row's max over all W columns, which the two
//     warpgroups split: a quad shuffle, then the two warpgroups' maxima
//     through shared memory across a block barrier.
//   * hs (training): after the head and each odd layer, the a tile *is*
//     bf16(h) = hs[blk]; one thread stores it with TMA (one box a 64-column
//     panel; rows past B are not written) and waits for the store to have
//     read a before the barrier that precedes a's next write. Per-panel:
//     each warpgroup's first thread stores its own panels as the next layer
//     reads them, once their signals have come, and waits for those stores
//     to have read a before its next signal, which a's next write follows.
//
// Shared memory (W = 256, in_pad = 1024): the ring, S x 32 KB; a and a2,
// 32 KB each, and h0 (f32, 64 KB, each thread's own values), which the
// embed (64 x in_pad bf16, 128 KB) overlays during the head: 224 KB, and
// the barriers (the ring's and the panels'). A wider input (in_pad above
// 1024 at W = 256, above 1408 at W = 128) runs the head in parts (PARTS):
// the embed's columns that fit, their products, then the next columns over
// the same space, the sums carried in registers. PARTS is a template
// parameter, not a test at run time: the column test in every embed store
// slowed the one-part tile by 3% (PERF.md).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "r2l_tma.cuh"
#include "trig.cuh"
#include "wgmma_s8.cuh"

namespace enerf {
namespace wg {

constexpr int TB = 64;                  // rays a tile: one wgmma M
constexpr int NTHREADS = 256;           // two warpgroups
constexpr int KC = 64;                  // contraction columns of a chunk (128 bytes)
constexpr int S = 3;                    // ring stages
constexpr int PANEL = TB * KC;          // bf16 of one swizzled [64, 64] panel (8 KB)
constexpr int KC8 = 128;                // contraction columns of an int8 chunk (128 bytes)
constexpr int PANEL8 = TB * KC8;        // bytes of one swizzled [64, 128] int8 panel (8 KB)
constexpr int MAX_SMEM = 232448;        // 227 KB, the opt-in limit of sm_90
constexpr int NREADY = 2 * 4;           // per-panel barriers: a and a2, up to 4 panels each

// The bf16 body signals each 64-column panel of a and a2 on its own barrier
// where each warpgroup owns whole panels (NT a multiple of 64: W 65-128 and
// 193-256), and meets at a block barrier per layer otherwise.
__host__ __device__ constexpr bool per_panel(int NT) { return NT % KC == 0; }

// Tensor maps: the weights as [layer][out][in] (head: one layer), read in
// boxes of 64 input columns x Wp output rows; hs as [block][ray][col],
// written in boxes of 64 columns x 64 rays.
struct Maps {
  CUtensorMap head, body, hs;
};

// The tile's operands besides the weights that TMA streams. The network
// input is K point coordinates a ray: their doubling embed (L > 0) or the
// coordinates themselves (L = 0), zero-padded to in_pad columns.
struct Net {
  const float* head_b;             // [W]
  const float* body_b;             // [n_block, 2, W]
  const float* body_sw;            // int8: [n_block, 2, W] per-output-row weight scales
  const float* act_scales;         // int8: [n_block, 2] static scales, or null (dynamic)
  const __nv_bfloat16* tail_w;     // [out_dim, W]
  const float* tail_b;             // [out_dim]
  float* out;                      // [B, out_dim]
  int B, K, L, in_pad, W, n_block, out_dim, global_residual;
  float res_scale;
};

// The launchers' one way to fill a Net.
inline Net make_net(const float* head_b, const float* body_b, const void* tail_w,
                    const float* tail_b, float* out, int B, int K, int L, int in_pad, int W,
                    int n_block, int out_dim, float res_scale, int global_residual) {
  Net n;
  n.head_b = head_b;
  n.body_b = body_b;
  n.body_sw = nullptr;
  n.act_scales = nullptr;
  n.tail_w = static_cast<const __nv_bfloat16*>(tail_w);
  n.tail_b = tail_b;
  n.out = out;
  n.B = B;
  n.K = K;
  n.L = L;
  n.in_pad = in_pad;
  n.W = W;
  n.n_block = n_block;
  n.out_dim = out_dim;
  n.global_residual = global_residual;
  n.res_scale = res_scale;
  return n;
}

// (int8: a and a2 hold q(h) and q(g), and a overlays both for the tail;
// c8 holds the prefetched scales and biases, rmax the dynamic row maxima)
struct Layout {
  size_t ring, a, a2, h0, c8, rmax, emb, bars, total;
  int emb_cols;                    // embed columns a part of the head: all in_pad if they fit
};

__host__ __device__ inline int round_up64(int x) { return (x + 63) / 64 * 64; }
__host__ __device__ inline size_t max_sz(size_t x, size_t y) { return x > y ? x : y; }

// Byte offsets from a 1024-aligned base; `total` includes the slack that
// aligns the dynamic shared memory to 1024 (the swizzle's period). The
// embed takes what the ring and the barriers leave, at most in_pad columns.
// s8: the int8 body's regions.
__host__ __device__ inline Layout layout(int in_pad, int Wp, bool h0, bool s8 = false) {
  const size_t stage = (size_t)Wp * KC * 2, act = (size_t)TB * Wp * 2;
  const size_t q8 = (size_t)(Wp + KC8 - 1) / KC8 * PANEL8;
  const size_t a_a2 = s8 ? max_sz(2 * q8, act) : 2 * act, hb = h0 ? (size_t)TB * Wp * 4 : 0;
  const size_t c8 = s8 ? (size_t)2 * 2 * Wp * 4 : 0, rmax = s8 ? (size_t)2 * 2 * TB * 4 : 0;
  const size_t acts = a_a2 + hb + c8 + rmax;
  const size_t bars = (2 * S + NREADY) * sizeof(uint64_t), slack = 1024;
  const size_t panel = (size_t)PANEL * 2;
  const size_t room = MAX_SMEM - S * stage - bars - slack;
  size_t panels = (size_t)in_pad / KC;
  if (panels * panel > room) panels = room / panel;
  const size_t emb = panels * panel;
  Layout l;
  l.ring = 0;
  l.a = S * stage;
  l.a2 = l.a + (s8 ? q8 : act);
  l.h0 = l.a + a_a2;
  l.c8 = l.h0 + hb;
  l.rmax = l.c8 + c8;
  l.emb = l.a;
  l.emb_cols = (int)panels * KC;
  l.bars = l.a + (acts > emb ? acts : emb);
  l.total = l.bars + bars + slack;
  return l;
}

// Element offset of (row r, column c) in a [64, *] bf16 tile stored as
// [64, 64] panels of 128-byte rows whose 16-byte chunks the 128-byte
// swizzle permutes by the row's low 3 bits (as TMA writes and wgmma reads).
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * PANEL + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// Byte offset of (row r, column c) in a [64, *] int8 tile stored as [64,
// 128] panels of 128-byte rows in the same swizzle.
__device__ __forceinline__ int swz8(int r, int c) {
  return (c >> 7) * PANEL8 + r * 128 + ((((c >> 4) & 7) ^ (r & 7)) << 4) + (c & 15);
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: 8-row groups 1024 bytes apart. Adding k / 8 steps the start
// k bf16 columns (2 k int8) along a 128-byte row.
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t a = tma_smem_addr(p);
  return ((a >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from reading or writing r across the wgmma calls.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// 16 bytes from global src to shared dst by cp.async, of which the first
// `bytes` (16 or 0) are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tma_smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void st_bf16x2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// bf16x2 of (lo, hi), lo in the low half, round to nearest; with RELU,
// negatives to 0 (the same bits as rounding relu(x), for every x but NaN).
template <bool RELU>
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  unsigned r;
  if (RELU)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Four 8x8 bf16 matrices, r_m holding this thread's pair of matrix m (row
// lane / 4, columns 2 (lane % 4), + 1, as an accumulator fragment holds
// them); lane l gives the shared address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix4(unsigned addr, unsigned r0, unsigned r1, unsigned r2,
                                          unsigned r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// *p += v in shared memory, acquire-release at block scope; the old value
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "r"(tma_smem_addr(p)), "r"(v)
               : "memory");
  return old;
}

// d (+)= A[64, 16] B[16, N]^T, m64nNk16 bf16 -> f32; accumulate = 0 starts
// the sums.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
  }
};

// The doubling embed of point coordinate pt, column m of K: store(col, v)
// receives [sin_0..sin_{L-1} | cos_0..cos_{L-1} | pt] in K-column blocks,
// by fast_sincos once and L - 1 double-angle steps, rounded as the plain
// versions round them.
template <class Store>
__device__ __forceinline__ void embed_point(float pt, int m, int K, int L, Store store) {
  float s, c;
  fast_sincos(pt, s, c, 9);
  for (int j = 0; j < L; ++j) {
    store(j * K + m, s);
    store((L + j) * K + m, c);
    const float s2 = __fmul_rn(__fmul_rn(2.0f, s), c);
    c = __fsub_rn(1.0f, __fmul_rn(__fmul_rn(2.0f, s), s));
    s = s2;
  }
  store(2 * L * K + m, pt);
}

// The body's types (forward_tile's Q): bf16, or int8 with static or with
// per-row dynamic activation scales.
enum { Q_BF16 = 0, Q_STATIC = 1, Q_DYNAMIC = 2 };

// The forward of rays ray0 .. ray0 + 63 (blockIdx.x's tile) by the block's
// NTHREADS threads; point(ray, m) is coordinate m of ray's network input
// (ray < B), which the tile embeds. HS stores hs through maps.hs; PARTS
// runs the head in parts (layout's emb_cols < in_pad); Q the body's type
// (int8: maps.body over body_qw, p.body_sw and p.act_scales). Called by a
// kernel of NTHREADS threads with `smem` its dynamic shared memory of
// layout(in_pad, 2 NT, global_residual, Q != Q_BF16).total bytes.
template <int NT, bool HS, bool PARTS, int Q = Q_BF16, class Point>
__device__ __forceinline__ void forward_tile(const Maps& maps, const Net& p,
                                             unsigned char* smem_raw, Point point) {
  constexpr int WP = 2 * NT, NCH = WP / KC, NA = NT / 2;
  constexpr bool S8 = Q != Q_BF16;
  constexpr bool PP = !S8 && per_panel(NT);  // the bf16 body on per-panel barriers
  constexpr int NPW = NT / KC;               // PP: the panels a warpgroup owns
  constexpr int KB = S8 ? KC8 : KC, NB = (WP + KB - 1) / KB;  // a body layer's chunks
  unsigned char* smem = smem_raw + ((1024 - (tma_smem_addr(smem_raw) & 1023)) & 1023);
  const bool gr = p.global_residual != 0;
  const Layout lay = layout(p.in_pad, WP, gr, S8);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + lay.ring);
  __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem + lay.a);
  __nv_bfloat16* a2 = reinterpret_cast<__nv_bfloat16*>(smem + lay.a2);
  __nv_bfloat16* emb = reinterpret_cast<__nv_bfloat16*>(smem + lay.emb);
  float* h0 = reinterpret_cast<float*>(smem + lay.h0);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  unsigned* freed = reinterpret_cast<unsigned*>(full + S);  // [S] warps' releases of each stage
  uint64_t* ready = full + 2 * S;  // PP: [a, a2][NCH] panel p of a or a2 written
  const int tid = threadIdx.x;
  const long long ray0 = (long long)blockIdx.x * TB;
  const int head_chunks = p.in_pad / KC, nb = p.n_block;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);  // the loading thread's arrive, plus the bytes
      freed[s] = 0u;
    }
    if (PP)
      for (int q = 0; q < 2 * NCH; ++q) mbar_init(&ready[q], 4);  // the owner's 4 warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers exist before any copy or arrival

  // ---- the loads: every chunk of the head and the body, S chunks ahead of
  // the products; a box is 128 bytes of each of Wp rows. Thread 0 loads the
  // first S; then the warp that frees a stage last loads the next chunk into it
  const int total = head_chunks + 2 * nb * NB;
  auto issue = [&](int n) {
    if (n >= total) return;
    const int s = n % S;
    const bool head = n < head_chunks;
    const int k = head ? n : (n - head_chunks) % NB;
    const int layer = head ? 0 : (n - head_chunks) / NB;
    const CUtensorMap* map = head ? &maps.head : &maps.body;
    mbar_arrive_expect_tx(&full[s], WP * 128);
    tma_box(ring + (size_t)s * WP * KC, map, k * (head ? KC : KB), 0, layer, &full[s]);
  };
  if (tid == 0)
    for (int n = 0; n < S; ++n) issue(n);

  // ---- the products: warpgroup wg owns columns [wg NT, wg NT + NT)
  const int wgi = tid / 128, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, wr = ((tid % 128) / 32) * 16;
  const int W = p.W, col0 = wgi * NT + 2 * t;
  float acc[NA], h[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
  int c = 0;  // chunks consumed

  // this warp's products have read chunk `read`: the warp whose release is
  // the last of the stage's round loads chunk read + S into it, so that no
  // thread waits for a stage to be free
  auto release = [&](int read) {
    __syncwarp();
    if (lane == 0 && atom_add_acq_rel(&freed[read % S], 1u) % (NTHREADS / 32) ==
                         NTHREADS / 32 - 1)
      issue(read + S);
  };
  // acc (+)= X[64, 64 n] @ (the next n chunks)^T, X in swizzled panels; the
  // sums start from acc with `carry`, else from zero. PP, rdy: each chunk
  // first waits for its panel of X, signalled on rdy[k] in phase `par`; with
  // hs_blk >= 0 each warpgroup's first thread then stores its own panels of X
  // as hs[hs_blk]
  auto products = [&](const __nv_bfloat16* X, int n, bool carry, uint64_t* rdy, unsigned par,
                      int hs_blk) {
    for (int kc = 0; kc < n; ++kc, ++c) {
      const int s = c % S;
      if (PP && rdy != nullptr) {
        mbar_wait(&rdy[kc], par);
        if (HS && hs_blk >= 0 && tid % 128 == 0 && kc / NPW == wgi && KC * kc < W) {
          tma_store_box(&maps.hs, X + kc * PANEL, KC * kc, (int)ray0, hs_blk);
          if (kc % NPW == NPW - 1) bulk_commit();
        }
      }
      mbar_wait(&full[s], (c / S) & 1);
      const uint64_t da = desc(X + kc * PANEL);
      const uint64_t db = desc(ring + (size_t)s * WP * KC + wgi * NT * KC);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)
        Wgmma<NT>::run(acc, da + 2 * k, db + 2 * k, carry || kc + k > 0);
      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();  // the chunk before this one has been read
        release(c - 1);
      }
    }
    wgmma_wait<0>();
    release(c - 1);
#pragma unroll
    for (int i = 0; i < NA; ++i) fence_reg(acc[i]);
  };
  // hs[blk] = the a tile, by one thread: a 64-column panel a box
  auto store_hs = [&](int blk) {
    if (HS && tid == 0) {
      for (int q = 0; q * 64 < W; ++q)
        tma_store_box(&maps.hs, a + q * PANEL, 64 * q, (int)ray0, blk);
      bulk_commit();
    }
  };
  // ends a layer: the epilogue's writes reach the next layer's wgmma (and
  // the hs store), and the last hs store has read a
  auto end_layer = [&]() {
    fence_proxy_async();
    if (HS && tid == 0) bulk_wait_read();
    __syncthreads();
  };

  // this thread's bias pairs of a layer: bias[j] of column group j. The
  // biases (88 KB at W256 D88) do not stay in the L1 beside 227 KB of shared
  // memory, and an L2 read under the weight stream takes longer than a
  // layer's products: so each epilogue, once it has used bias[j], loads the
  // next layer's into it, a whole layer ahead of its use
  float2 bias[NT / 8];
  auto load_bias_j = [&](const float* b, int j) {
    const int col = col0 + 8 * j;
    if (b != nullptr)
      bias[j] = col < W ? __ldg(reinterpret_cast<const float2*>(b + col))
                        : make_float2(0.0f, 0.0f);
  };
  // body layer l's biases, or null past the last layer
  auto body_bias = [&](int l) -> const float* {
    return l < 2 * nb ? p.body_b + (size_t)l * W : nullptr;
  };

  // PP: the stmatrix address of lane l is row lrow of 8x8 matrix l / 8, which
  // holds rows + 8 (m & 1) of column group j + (m >> 1) for the pair (j, j +
  // 1), j even; its 16-byte chunk in the swizzled row is (j % 8) ^ lx
  const int lrow = wr + (lane & 7) + 8 * ((lane >> 3) & 1), lx = (lane >> 4) ^ (lane & 7);
  // PP: an epilogue into this warpgroup's panels of dst. pair(i) gives the
  // bf16x2 of values i, i + 1 (column group i / 4, row g + 8 ((i / 2) % 2));
  // once groups j and j + 1 are made, next(j), next(j + 1). Each panel is
  // then fenced for the async proxy and signalled on rdy by its 4 warps, so
  // that the next layer's products of that panel need not wait for the rest
  // (the hs stores of a that went before have read it by then: the next write
  // of a follows this signal)
  auto epilogue_pp = [&](__nv_bfloat16* dst, uint64_t* rdy, auto pair, auto next) {
#pragma unroll
    for (int q = 0; q < NPW; ++q) {
      const int pn = wgi * NPW + q;
      const unsigned at = tma_smem_addr(dst + pn * PANEL) + lrow * 128;
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        const int i = 4 * (8 * q + jj);
        stmatrix4(at + ((jj ^ lx) << 4), pair(i), pair(i + 2), pair(i + 4), pair(i + 6));
        next(8 * q + jj);
        next(8 * q + jj + 1);
      }
      fence_proxy_async();
      if (HS && q == 0 && tid % 128 == 0) bulk_wait_read();
      __syncwarp();
      if (lane == 0) mbar_arrive(&rdy[pn]);
    }
  };

  // columns lo .. lo + n - 1 of the tile's [64, in_pad] bf16 network input
  // into emb's swizzled panels: zeros past B and past the input's columns
  auto embed = [&](int lo, int n) {
    const int K = p.K, L = p.L, in_dim = L > 0 ? K * (2 * L + 1) : K;
    for (int idx = tid; idx < TB * K; idx += NTHREADS) {
      const int row = idx / K, m = idx % K;
      const long long ray = ray0 + row;
      const float v = ray < p.B ? point(ray, m) : 0.0f;
      auto store = [&](int col, float e) {
        if (!PARTS || (col >= lo && col < lo + n)) emb[swz(row, col - lo)] = __float2bfloat16_rn(e);
      };
      if (L > 0)
        embed_point(v, m, K, L, store);
      else
        store(m, v);
    }
    const int z0 = in_dim > lo ? in_dim : lo, n_pad = lo + n - z0;
    for (int idx = tid; idx < TB * n_pad; idx += NTHREADS)
      emb[swz(idx / n_pad, z0 - lo + idx % n_pad)] = __float2bfloat16_rn(0.0f);
  };

  // ---- the embed and the head, then relu into the residual stream h. In
  // parts, the next columns over the same space once the products of the
  // part before have read it, their products added to the same sums
  embed(0, lay.emb_cols);
  end_layer();
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) load_bias_j(p.head_b, j);
  products(emb, lay.emb_cols / KC, false, nullptr, 0u, -1);
  for (int lo = lay.emb_cols; PARTS && lo < p.in_pad; lo += lay.emb_cols) {
    const int n = p.in_pad - lo < lay.emb_cols ? p.in_pad - lo : lay.emb_cols;
    __syncthreads();
    embed(lo, n);
    end_layer();
    products(emb, n / KC, true, nullptr, 0u, -1);
  }
  __syncthreads();  // every head product has read the embed, which a, a2 and h0 overlay
  const float* first_b = S8 ? nullptr : body_bias(0);  // (the int8 body prefetches its own)
  // h = relu(acc + b): the residual stream, h0 its copy, a = bf16(h)
  auto head_pair = [&](int i) {
    const float2 b = bias[i / 4];
    h[i] = fmaxf(acc[i] + b.x, 0.0f);
    h[i + 1] = fmaxf(acc[i + 1] + b.y, 0.0f);
    if (gr) {
      h0[i * NTHREADS + tid] = h[i];
      h0[(i + 1) * NTHREADS + tid] = h[i + 1];
    }
    return bf16x2<false>(h[i], h[i + 1]);
  };
  if constexpr (PP) {
    epilogue_pp(a, ready, head_pair, [&](int j) { load_bias_j(first_b, j); });
  } else {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const unsigned v = head_pair(4 * j + 2 * hf);
        if (!S8) *reinterpret_cast<unsigned*>(a + swz(wr + g + 8 * hf, col0 + 8 * j)) = v;
      }
      load_bias_j(first_b, j);
    }
  }
  const float rs = p.res_scale;
  if constexpr (!S8) {
    if (!PP) {
      end_layer();
      store_hs(0);
    }

    // ---- residual blocks, 2 n_block layers:
    //   even l: a2 = bf16(relu(a @ w1 + b1))
    //   odd l:  h = (a2 @ w2 + b2) * res_scale + h;  a = bf16(h) = hs[(l + 1) / 2]
    // PP: layer l reads the panels of a (even) or a2 (odd) in phase (l / 2) % 2
    // of their barriers, and the even layers store hs[l / 2] = a as they read it
    for (int l = 0; l < 2 * nb; ++l) {
      const bool odd = l & 1;
      const float* next_b = body_bias(l + 1);
      auto even_pair = [&](int i) {
        const float2 b = bias[i / 4];
        return bf16x2<true>(acc[i] + b.x, acc[i + 1] + b.y);
      };
      // rounded as the plain version rounds it (no FMA)
      auto odd_pair = [&](int i) {
        const float2 b = bias[i / 4];
        h[i] = __fadd_rn(__fmul_rn(acc[i] + b.x, rs), h[i]);
        h[i + 1] = __fadd_rn(__fmul_rn(acc[i + 1] + b.y, rs), h[i + 1]);
        return bf16x2<false>(h[i], h[i + 1]);
      };
      auto next = [&](int j) { load_bias_j(next_b, j); };
      if constexpr (PP) {
        products(odd ? a2 : a, NCH, false, ready + (odd ? NCH : 0), (unsigned)(l / 2) & 1u,
                 odd ? -1 : l / 2);
        if (odd)
          epilogue_pp(a, ready, odd_pair, next);
        else
          epilogue_pp(a2, ready + NCH, even_pair, next);
      } else {
        products(odd ? a2 : a, NCH, false, nullptr, 0u, -1);
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 4 * j + 2 * hf;
            unsigned* at = reinterpret_cast<unsigned*>((odd ? a : a2) +
                                                       swz(wr + g + 8 * hf, col0 + 8 * j));
            *at = odd ? odd_pair(i) : even_pair(i);
          }
          next(j);
        }
        end_layer();
        const int blk = (l + 1) / 2;  // the block h now enters
        if (odd && (blk < nb || !gr)) store_hs(blk);
      }
    }
    if (PP) {  // the last layer's panels reach the tail (and hs[nb] without h0)
      end_layer();
      if (!gr) store_hs(nb);
    }

    // ---- optional global residual (+ h0): the tail's input, hs[nb]
    if (gr) {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * j + 2 * hf, row = wr + g + 8 * hf, col = col0 + 8 * j;
          st_bf16x2(a + swz(row, col), h[i] + h0[i * NTHREADS + tid],
                    h[i + 1] + h0[(i + 1) * NTHREADS + tid]);
        }
      end_layer();
      store_hs(nb);
    }
  } else {
    // ---- the int8 body (r2l_int8.cu's header has its math): per block b,
    //   even l = 2 b: qg = q(g), g from acc(qh @ q0) (static: folded with
    //                 the next scale; dynamic: relu, then the row's sg)
    //   odd l:        h = g * res_scale + h, g from acc(qg @ q1); qh = q(h)
    unsigned char* qh = reinterpret_cast<unsigned char*>(a);
    unsigned char* qg = reinterpret_cast<unsigned char*>(a2);
    float* c8 = reinterpret_cast<float*>(smem + lay.c8);      // [2 slots][sw, b][WP]
    float* rmax = reinterpret_cast<float*>(smem + lay.rmax);  // [h, g][warpgroup][row]
    const float* act = p.act_scales;
    int acc8[NA];
    float sh[2] = {0.0f, 0.0f}, sg[2] = {0.0f, 0.0f};  // dynamic: the rows' scales

    // layer l's weight scales and biases into slot l % 2 by cp.async (zeros
    // past W); the end of the layer before waits for them
    auto prefetch = [&](int l) {
      if (l < 2 * nb && tid < WP / 2) {
        const int v = tid / (WP / 4), col = 4 * (tid % (WP / 4));
        const float* src = (v ? p.body_b : p.body_sw) + (size_t)l * W;
        cp_async16(c8 + ((l & 1) * 2 + v) * WP + col, col < W ? src + col : src,
                   col < W ? 16 : 0);
      }
    };
    auto end_layer8 = [&]() {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      end_layer();
    };
    // acc8 = X[64, 128 NB] @ (the next NB int8 chunks)^T, X in int8 panels
    auto products8 = [&](const unsigned char* X) {
      for (int kc = 0; kc < NB; ++kc, ++c) {
        mbar_wait(&full[c % S], (c / S) & 1);
        const uint64_t da = desc(X + kc * PANEL8);
        const uint64_t db = desc(ring + (size_t)(c % S) * WP * KC + wgi * NT * KC);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KC8 / 32; ++k)
          WgmmaS8<NT>::run(acc8, da + 2 * k, db + 2 * k, kc + k > 0);
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();  // the chunk before has been read
          release(c - 1);
        }
      }
      wgmma_wait<0>();
      release(c - 1);
#pragma unroll
      for (int i = 0; i < NA; ++i) fence_reg(acc8[i]);
    };
    // s[hf] = max(max |row|, 1e-12) / 127 of this thread's rows over all W
    // columns, from m[hf], the max over its own: the quad's max, then both
    // warpgroups' through rm across a block barrier (a max: exact in any
    // order)
    auto row_scales = [&](float* rm, float (&m)[2], float (&sc)[2]) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
        m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
        if (t == 0) rm[wgi * TB + wr + g + 8 * hf] = m[hf];
      }
      __syncthreads();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = wr + g + 8 * hf;
        sc[hf] = __fdiv_rn(fmaxf(fmaxf(rm[row], rm[TB + row]), 1e-12f), 127.0f);
      }
    };
    // qh = q(h * inv_s[b, 0]) (static) or q(h / sh) (dynamic), block b's input
    auto quantize_h = [&](int b) {
      if (Q == Q_DYNAMIC) {
        float m[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < NA; ++i) m[(i / 2) % 2] = fmaxf(m[(i / 2) % 2], fabsf(h[i]));
        row_scales(rmax, m, sh);
      }
      const float inv = Q == Q_STATIC ? __frcp_rn(act[2 * b]) : 0.0f;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * j + 2 * hf, row = wr + g + 8 * hf, col = col0 + 8 * j;
          const float x = Q == Q_STATIC ? __fmul_rn(h[i], inv) : __fdiv_rn(h[i], sh[hf]);
          const float y = Q == Q_STATIC ? __fmul_rn(h[i + 1], inv) : __fdiv_rn(h[i + 1], sh[hf]);
          *reinterpret_cast<unsigned short*>(qh + swz8(row, col)) =
              pack_levels(level_bits(x), level_bits(y));
        }
    };

    prefetch(0);  // (the embed, which c8 overlays, is dead)
    quantize_h(0);
    end_layer8();
    for (int l = 0; l < 2 * nb; ++l) {
      const int b = l / 2;
      const float* csw = c8 + (l & 1) * 2 * WP;
      const float* cb = csw + WP;
      prefetch(l + 1);
      if ((l & 1) == 0) {
        products8(qh);
        if (Q == Q_STATIC) {
          // t = acc * (dqs0 * inv1) + b0 * inv1;  qg = q(relu(t))
          const float s0 = act[2 * b], inv1 = __frcp_rn(act[2 * b + 1]);
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            const int col = col0 + 8 * j;
            const float2 sw = *reinterpret_cast<const float2*>(csw + col);
            const float2 bb = *reinterpret_cast<const float2*>(cb + col);
            const float c0x = __fmul_rn(__fmul_rn(s0, sw.x), inv1);
            const float c0y = __fmul_rn(__fmul_rn(s0, sw.y), inv1);
            const float c1x = __fmul_rn(bb.x, inv1), c1y = __fmul_rn(bb.y, inv1);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int i = 4 * j + 2 * hf, row = wr + g + 8 * hf;
              const float x = fmaxf(__fadd_rn(__fmul_rn(s32_to_f32(acc8[i]), c0x), c1x), 0.0f);
              const float y =
                  fmaxf(__fadd_rn(__fmul_rn(s32_to_f32(acc8[i + 1]), c0y), c1y), 0.0f);
              *reinterpret_cast<unsigned short*>(qg + swz8(row, col)) =
                  pack_levels(level_bits_pos(x), level_bits_pos(y));
            }
          }
        } else {
          // g = relu(acc * (sh * sw0) + b0), kept in acc8's bits for its
          // quantization once the rows' max is known;  qg = q(g / sg)
          float m[2] = {0.0f, 0.0f};
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            const int col = col0 + 8 * j;
            const float2 sw = *reinterpret_cast<const float2*>(csw + col);
            const float2 bb = *reinterpret_cast<const float2*>(cb + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * j + e, hf = e / 2;
              const float dq = __fmul_rn(sh[hf], e % 2 ? sw.y : sw.x);
              const float gv = fmaxf(
                  __fadd_rn(__fmul_rn(s32_to_f32(acc8[i]), dq), e % 2 ? bb.y : bb.x), 0.0f);
              acc8[i] = __float_as_int(gv);
              m[hf] = fmaxf(m[hf], gv);
            }
          }
          row_scales(rmax + 2 * TB, m, sg);
#pragma unroll
          for (int j = 0; j < NT / 8; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int i = 4 * j + 2 * hf, row = wr + g + 8 * hf, col = col0 + 8 * j;
              *reinterpret_cast<unsigned short*>(qg + swz8(row, col)) =
                  pack_levels(level_bits_pos(__fdiv_rn(__int_as_float(acc8[i]), sg[hf])),
                              level_bits_pos(__fdiv_rn(__int_as_float(acc8[i + 1]), sg[hf])));
            }
        }
      } else {
        // g = acc * dq1 + b1, dq1 = s1 * sw1 (s1 = act_scales[b, 1], or the
        // row's sg);  h = g * res_scale + h, rounded as the plain version
        products8(qg);
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const int col = col0 + 8 * j;
          const float2 sw = *reinterpret_cast<const float2*>(csw + col);
          const float2 bb = *reinterpret_cast<const float2*>(cb + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float s1 = Q == Q_STATIC ? act[2 * b + 1] : sg[e / 2];
            const float dq = __fmul_rn(s1, e % 2 ? sw.y : sw.x);
            const float gv = __fadd_rn(__fmul_rn(s32_to_f32(acc8[i]), dq), e % 2 ? bb.y : bb.x);
            h[i] = __fadd_rn(__fmul_rn(gv, rs), h[i]);
          }
        }
        if (b + 1 < nb) quantize_h(b + 1);  // the last block's h goes to the tail
      }
      end_layer8();
    }

    // ---- a = bf16(h [+ h0]), the tail's input, over qh and qg (the last
    // layer's end: every product has read them)
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * j + 2 * hf, row = wr + g + 8 * hf, col = col0 + 8 * j;
        float x = h[i], y = h[i + 1];
        if (gr) {
          x += h0[i * NTHREADS + tid];
          y += h0[(i + 1) * NTHREADS + tid];
        }
        st_bf16x2(a + swz(row, col), x, y);
      }
    end_layer();
  }

  // ---- tail and sigmoid: one warp per (ray, output), f32 sums
  const int warp = tid / 32;
  for (int q = warp; q < TB * p.out_dim; q += NTHREADS / 32) {
    const int row = q / p.out_dim, j = q % p.out_dim;
    float sum = 0.0f;
    for (int n = lane; n < W; n += 32)
      sum += __bfloat162float(a[swz(row, n)]) * __bfloat162float(p.tail_w[(size_t)j * W + n]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const long long ray = ray0 + row;
    if (lane == 0 && ray < p.B)
      p.out[ray * p.out_dim + j] = 1.0f / (1.0f + expf(-(sum + p.tail_b[j])));
  }
  if (HS && tid % 128 == 0) bulk_wait();
}

// Shape checks of the tile, for the launchers.
inline bool tile_ok(int in_pad, int W, int n_block, int out_dim, bool h0, bool s8 = false) {
  return W % 32 == 0 && W >= 32 && W <= 256 && in_pad % KC == 0 && in_pad > 0 &&
         n_block >= 1 && out_dim >= 1 &&
         layout(in_pad, round_up64(W), h0, s8).total <= MAX_SMEM;
}

// The weights' tensor maps (head_w [W, in_pad] bf16, body_w [2 n_block, W,
// W] bf16, or int8 with body_bytes 1) in boxes of 128 bytes of columns x Wp
// rows.
inline bool weight_maps(Maps* m, const void* head_w, const void* body_w, int in_pad, int W,
                        int n_block, int body_bytes = 2) {
  EncodeTiled fn = encoder();
  const unsigned rows = (unsigned)round_up64(W);
  const long long rb = (long long)body_bytes * W;
  return fn != nullptr &&
         encode(fn, &m->head, head_w, in_pad, W, 1, 2LL * in_pad, 2LL * in_pad * W, rows) &&
         encode(fn, &m->body, body_w, W, W, 2LL * n_block, rb, rb * W, rows, body_bytes);
}

// The instantiation that launch_tile takes for (in_pad, W): bit 0 set where
// the head runs in parts (PARTS), bit 1 where the body runs on per-panel
// barriers (per_panel(NT)).
inline int tile_kind(int in_pad, int W) {
  const int wp = round_up64(W);
  return (layout(in_pad, wp, false).emb_cols < in_pad ? 1 : 0) | (per_panel(wp / 2) ? 2 : 0);
}

// Launches K<NT>'s forward_tile kernel with NT = round_up64(W) / 2 on
// ceil(B / 64) tiles, its head in parts where the input is wider than the
// embed's room; returns cudaGetLastError().
template <template <int> class K, class Arg>
int launch_tile(const Maps& maps, const Arg& arg, int B, int in_pad, int W, bool h0,
                cudaStream_t stream, bool s8 = false) {
  const Layout lay = layout(in_pad, round_up64(W), h0, s8);
  const size_t smem = lay.total;
  const bool parts = lay.emb_cols < in_pad;
  const unsigned grid = (unsigned)((B + TB - 1) / TB);
  switch (round_up64(W)) {
    case 64: return K<32>::launch(maps, arg, grid, smem, parts, stream);
    case 128: return K<64>::launch(maps, arg, grid, smem, parts, stream);
    case 192: return K<96>::launch(maps, arg, grid, smem, parts, stream);
    case 256: return K<128>::launch(maps, arg, grid, smem, parts, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wg
}  // namespace enerf
