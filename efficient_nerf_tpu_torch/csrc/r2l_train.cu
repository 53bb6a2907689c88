// Fused R2L training forward and backward for Hopper (sm_90a).
//
// Replaces efficient_nerf_tpu/ops/pallas/r2l_train.py::r2l_train_apply
// (:397): its forward kernel `_fwd_kernel` (:85, pallas_call :261) and its
// backward kernel `_bwd_kernel` (:115, pallas_call :323), behind the custom
// VJP that ops/r2l_train.py rebuilds as a torch.autograd.Function. Each block
// takes a tile of TB = 64 rays end to end, with the fusion boundary of the
// Pallas kernels: the embed, the 88 layers' activations and the blocks'
// inner pre-activations never reach device memory, except the 44 bf16 block
// inputs `hs` that the forward saves for the backward.
//
// Forward (r2l_train_fwd_kernel): the tile of csrc/r2l_wgmma.cuh that the
// serving forward (csrc/r2l_forward.cu) runs, with the sample points [B, K]
// (embed_L > 0, embedded here by fast_sincos and the double-angle
// recurrence) or the embedded rows [B, x_cols] (embed_L = 0) as input,
// hs[i] = bf16(h) stored by TMA before block i, and hs[n_block] = bf16(h)
// after the optional global residual (the tail's input).
//
// Backward, pass 1 of 2 (r2l_train_bwd_kernel): the activation chain. The
// tail backward with sigmoid', then the blocks in reverse with dh in f32
// registers. Per block, three products of W^2 per ray:
//   g1  = relu(h_in @ W0^T + b0)   recomputed from the bf16 h_in = hs[blk]
//   dg1 = (dg2 @ W1) * (g1 > 0)    dg2 = dh * res_scale
//   dh  += dg1 @ W0
// then the head backward: the relu mask from hs[0] > 0 (in f32) and, when dx
// is asked for, the input gradient through the embed's chain rule. Rounding
// follows :143-201: dt, dg2, dg1 and dpre enter the products as bf16, their
// bias gradients sum the f32 values; g1 is rounded to bf16 as an operand.
//
// The weight gradients contract the rays, a sum across blocks, which the
// Pallas grid runs in order into VMEM-resident f32 blocks. Here it is a
// second pass (csrc/r2l_wgrad.cu): this pass writes the products' bf16
// operands, dg2, g1 and dg1 of every block ([n_block, Bp, W] each, Bp = B
// padded to a whole tile), dpre [Bp, W] and the recomputed embed [Bp,
// in_pad], each tile a contiguous run of rows; and each tile's f32 column
// sums of the bias and tail gradients into a row of `part` (head_b | body_b
// | tail_w | tail_b). No global atomics: the sums are added in a fixed order
// by the second pass, so the gradients' bits do not change from run to run.
//
// Bound (W256 D88, 98,304 rays, need_dx off): forward 5,894,912 MAC a ray
// (1.159 TFLOP, 1.172 ms at 989 TFLOP/s dense bf16) plus 2.2 GB of hs
// stores, bound by operations; its design is r2l_wgmma.cuh's. Pass 1: 3 x
// 43 x 65,536 MAC a ray plus the tail (1.663 TFLOP, 1.68 ms) against 2.2 GB
// of hs read and 6.886 GB of operands written (2.726 ms at 3.35 TB/s): bound
// by bytes. Its weights cross from L2 to the SMs three times a block a tile:
// 3 x 43 x 128 KB = 16.5 MB a 64-ray tile, 25.4 GB a 98,304-ray step. The
// whole backward's operations (14,350,592 MAC a ray, 2.853 ms) are the two
// passes' together.
//
// Pass 1's design: the forward tile's machinery (r2l_wgmma.cuh, and its
// lessons there) on the chain.
//   * wgmma for the three products. The block's two warpgroups share the
//     tile's 64 rays: warpgroup g owns output columns [g NT, g NT + NT), NT =
//     W / 2, of each product (wgmma m64nNTk16, A and B K-major in the
//     128-byte swizzle). Each thread keeps its NT / 2 values of dh, the
//     sums and the 64-bit relu mask of g1 in registers.
//   * All three products read K-major weights. g1 takes W0 as it lies
//     ([out, in]: K-major for h_in @ W0^T, as the forward takes it). The two
//     [k, n] products take pack_r2l_train_weights's transposed bf16 copy of
//     the body, body_wt[l] = body_w[l]^T (11.3 MB made each step with the
//     pack), so that every product runs on the descriptors, boxes and swizzle
//     the forward proved on the card; wgmma's transpose-B with MN-major
//     descriptors would read body_w itself, but no card run has checked that
//     layout here, and the copy costs the step about as much as reading it.
//   * A TMA weight ring with mbarriers and no block barrier a chunk: thread 0
//     (one of the consumers; no producer warpgroup, no cluster, no deferred
//     loads, as r2l_wgmma.cuh says why) loads each [W, 64] chunk of W0,
//     W1^T and W0^T, block by block in reverse, by one box from 3-D tensor
//     maps over body_w and body_wt into a ring of as many stages as fit (3 at
//     W256), each with a full and an empty mbarrier. Its depth matters most:
//     2 stages took 10.1 ms a step against 7.9 for 3; 7 stages of [W, 32]
//     chunks (the 64-byte swizzle) took 9.1 against 7.5 (PERF.md).
//   * TMA for the activation tiles. hs[blk] lands by TMA (rows past B as
//     zeros) into the h tile; dg2, dg1 and dpre leave shared memory by TMA
//     stores from the swizzled tiles the products read, thread 0 waiting
//     (cp.async.bulk.wait_group.read) before a tile is rewritten. g1, which
//     no product of this pass reads, goes from the registers to g1s, 4
//     bytes a store: the h tile is then free once g1's products have read
//     it, and thread 0 stalls on no store before it loads the next hs (a g1
//     tile stored by TMA took 7.9 ms against 7.5, PERF.md).
//   * Two block barriers a block, each where a product's A is complete. A
//     block's schedule:
//       dg2 = dh rs -> dg2 tile; A; store dg2; g1 products (h tile); mask,
//       g1 -> g1s; dg1 products (dg2 tile); dg1 -> dg1 tile; B; store dg1,
//       hs[blk - 1] -> h tile; dh products (dg1 tile).
//     A also orders the dh products of the block before (both warpgroups
//     read the dg1 tile) before this block's dg1 writes, and B the products
//     that read h and dg2 before their refills; between g1's and dg1's
//     products there is none. One h tile does: the next block's hs lands
//     during the dh products.
//   * The bias sums: each warp's column sums of its 16 rows by a shuffle
//     butterfly (each step halves the values a lane keeps), its partials in
//     shared memory, added by one thread a column in a fixed order after the
//     next barrier: the same bits every run. b0 comes by cp.async into one
//     of two shared slots a block ahead.
// The dx chain (need_dx, off in the training step) keeps its product on
// r2l_mma.cuh's mma_stream_kn over the shared memory the body leaves.
//
// Shared memory of the backward (W = 256): the ring (3 x 32 KB), the h, dg2
// and dg1 tiles (32 KB each), the bias partials (2 x 4 KB), dt and b0: 204
// KB; the embed (64 x in_pad bf16, 129 KB at in_pad 1024) and dx's tiles
// overlay them at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "r2l_mma.cuh"
#include "r2l_wgmma.cuh"
#include "trig.cuh"

namespace {

using namespace enerf;  // TB, NTHREADS, ..., Frag, mma_stream_kn (r2l_mma.cuh)
static_assert(TB == wg::TB && NTHREADS == wg::NTHREADS, "one tile of 64 rays, 256 threads");

// What the backward reads of the weights besides the tensor maps.
struct Weights {
  const __nv_bfloat16* head_w;     // [W, in_pad], doubling order when embed_L > 0 (dx)
  const float* body_b;             // [n_block, 2, W]
  const __nv_bfloat16* tail_w;     // [out_dim, W]
  const float* tail_b;             // [out_dim]
};

struct Shape {
  int B, x_cols, embed_L, in_pad, W, n_block, out_dim, global_residual;
  int hs_rows;                     // rows between two blocks of hs (B, or more for a ray chunk)
  float res_scale;
};

struct FwdArgs {
  wg::Net net;                     // K = x_cols, L = embed_L
  const float* x;                  // [B, x_cols]
};

// The backward's tensor maps: the weights as [layer][out][in] in boxes of 64
// columns x W rows (body over body_w, body_t over body_wt); hs as [block][ray]
// [col] with B rays (read in boxes of 64 columns x 64 rays, zeros past B);
// the operands dg2s, dg1s as [block][ray][col] and dpres as [1][ray][col]
// with Bp rays (written in the same boxes).
struct BwdMaps {
  CUtensorMap body, body_t, hs, dg2, dg1, dpre;
};

struct BwdArgs {
  Weights w;
  Shape s;
  const float* x;                  // [B, x_cols]
  const __nv_bfloat16* hs;         // [n_block + 1, hs_rows, W], rows 0 .. B - 1 used
  const float* dout;               // [B, out_dim]
  __nv_bfloat16* g1s;              // [n_block, Bp, W]
  __nv_bfloat16* embs;             // [Bp, in_pad]
  float* part;                     // [Bp / TB, W + 2 n_block W + out_dim W + out_dim]
  float* dx;                       // [B, x_cols], or null: need_dx off
};

constexpr int MAX_OUT = 4;         // rgb, or rgb + depth
constexpr int BWD_MAX_STAGES = 6;  // weight-ring stages of the backward, at most

__host__ __device__ inline size_t max_sz(size_t x, size_t y) { return x > y ? x : y; }

// Bytes of one [64, W] bf16 tile, which is also one ring stage ([W, 64]).
__host__ __device__ constexpr size_t bwd_tile(int W) { return (size_t)TB * W * 2; }

// Bytes besides the ring: three tiles, two [4, W] f32 partial buffers, dt
// [TB, MAX_OUT] f32, two slots of W f32 biases, the barriers and the slack
// that aligns the base to 1024 (the swizzle's period).
__host__ __device__ constexpr size_t bwd_rest(int W) {
  return 3 * bwd_tile(W) + 2 * 4 * (size_t)W * 4 + (size_t)TB * MAX_OUT * 4 +
         2 * (size_t)W * 4 + (2 * BWD_MAX_STAGES + 1) * 8 + 1024;
}

// The ring's stages at width W: as many as fit, at most BWD_MAX_STAGES.
__host__ __device__ constexpr int bwd_stages(int W) {
  return (int)((MAX_SMEM - bwd_rest(W)) / bwd_tile(W)) < BWD_MAX_STAGES
             ? (int)((MAX_SMEM - bwd_rest(W)) / bwd_tile(W))
             : BWD_MAX_STAGES;
}

// Byte offsets from the 1024-aligned base. The body's regions, then what
// overlays them once the body is done: the embed [TB, in_pad + PAD], and
// dx's dpre tile [TB, W + PAD], its mma_stream_kn ring and its [TB, x_cols]
// f32 sums (these three end below the dg2 tile, which dpre's store reads
// meanwhile). The barriers come last and are overlaid by nothing.
struct BwdLayout {
  size_t ring, h, dg2, dg1, red2, red1, dt, b0, dx_a, dx_ring, dx_dp, emb, bars, total;
  int stages;
};

__host__ __device__ inline BwdLayout bwd_layout(int in_pad, int W) {
  const size_t tile = bwd_tile(W);
  BwdLayout l;
  l.stages = bwd_stages(W);
  l.ring = 0;
  l.h = l.stages * tile;
  l.dg2 = l.h + tile;
  l.dg1 = l.dg2 + tile;
  l.red2 = l.dg1 + tile;
  l.red1 = l.red2 + 4 * (size_t)W * 4;
  l.dt = l.red1 + 4 * (size_t)W * 4;
  l.b0 = l.dt + (size_t)TB * MAX_OUT * 4;
  l.dx_a = 0;
  l.dx_ring = (size_t)TB * (W + PAD) * 2;
  l.dx_dp = l.dx_ring + S * ring_stage_bytes(W);   // r2l_mma.cuh's 2-stage ring
  l.emb = 0;
  const size_t body = l.b0 + 2 * (size_t)W * 4;
  l.bars = max_sz(body, (size_t)TB * (in_pad + PAD) * 2);
  l.total = l.bars + (2 * l.stages + 1) * 8 + 1024;
  return l;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The [TB, in_pad] bf16 network input of rays ray0.. : the doubling embed
// [sin_0..sin_{L-1} | cos_0..cos_{L-1} | p] of the [B, K] points in K-column
// blocks (embed_L > 0), or the given rows (embed_L = 0); zeros past B and
// past the input's columns.
__device__ void embed_tile(const float* x, long long ray0, const Shape& s,
                           __nv_bfloat16* emb, int lde) {
  const int tid = threadIdx.x, K = s.x_cols, L = s.embed_L;
  int in_dim = K;
  if (L > 0) {
    in_dim = K * (2 * L + 1);
    for (int idx = tid; idx < TB * K; idx += NTHREADS) {
      const int row = idx / K, m = idx % K;
      const long long ray = ray0 + row;
      __nv_bfloat16* e = emb + (size_t)row * lde;
      wg::embed_point(ray < s.B ? x[ray * K + m] : 0.0f, m, K, L,
                      [=](int col, float v) { e[col] = __float2bfloat16_rn(v); });
    }
  } else {
    for (int idx = tid; idx < TB * K; idx += NTHREADS) {
      const int row = idx / K, col = idx % K;
      const long long ray = ray0 + row;
      emb[(size_t)row * lde + col] =
          __float2bfloat16_rn(ray < s.B ? x[ray * K + col] : 0.0f);
    }
  }
  const int n_pad = s.in_pad - in_dim;
  for (int idx = tid; idx < TB * n_pad; idx += NTHREADS)
    emb[(size_t)(idx / n_pad) * lde + in_dim + idx % n_pad] = __float2bfloat16_rn(0.0f);
}

template <int NT, bool PARTS>
__global__ void __launch_bounds__(wg::NTHREADS, 1)
    r2l_train_fwd_kernel(const __grid_constant__ wg::Maps maps, const FwdArgs p) {
  extern __shared__ __align__(128) unsigned char fwd_smem[];  // aligned to 1024 inside
  const float* x = p.x;
  const int K = p.net.K;
  // the [B, K] points (embed_L > 0), which the tile embeds, or the given
  // rows (embed_L = 0)
  wg::forward_tile<NT, true, PARTS>(maps, p.net, fwd_smem,
                             [=](long long ray, int m) { return x[ray * K + m]; });
}

template <int NT>
struct FwdKernel {
  static int launch(const wg::Maps& maps, const FwdArgs& p, unsigned grid, size_t smem,
                    bool parts, cudaStream_t stream) {
    auto kernel = parts ? r2l_train_fwd_kernel<NT, true> : r2l_train_fwd_kernel<NT, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, wg::NTHREADS, smem, stream>>>(maps, p);
    return (int)cudaGetLastError();
  }
};

// Copies a [TB, ncols] bf16 tile (shared, row stride lds) to rows ray0 ..
// ray0 + TB - 1 of a row-major [*, ncols] array, 16 bytes a thread. Reads
// only shared memory: the caller orders it against the tile's writers.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int lds, int ncols, long long ray0) {
  const int c8 = ncols / 8;
  for (int q = threadIdx.x; q < TB * c8; q += NTHREADS) {
    const int row = q / c8, col = (q % c8) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)(ray0 + row) * ncols + col) =
        *reinterpret_cast<const uint4*>(src + row * lds + col);
  }
}

// One step of the column sums' butterfly: v holds 2 H column values, of
// which a lane keeps the upper or the lower H and adds its partner's (lane
// ^ mask) in v[0 .. H).
template <int H, int N>
__device__ __forceinline__ void halve(float (&v)[N], bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[H + i];
    const float keep = upper ? v[H + i] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, mask));
  }
}

// The backward's pass 1 on the tile of rays blockIdx.x * 64 .., by two
// warpgroups (NT = W / 2 columns each); NEED_DX compiles the dx chain in
// only where it runs (its code in the same kernel made ptxas spill around
// the body's products, PERF.md).
template <int NT, bool NEED_DX>
__global__ void __launch_bounds__(NTHREADS, 1)
    r2l_train_bwd_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs p) {
  constexpr int WP = 2 * NT, NCH = WP / wg::KC, NA = NT / 2, NV = NT / 4;
  constexpr int ST = bwd_stages(WP);
  extern __shared__ __align__(128) unsigned char bwd_smem[];  // aligned to 1024 below
  unsigned char* smem = bwd_smem + ((1024 - (tma_smem_addr(bwd_smem) & 1023)) & 1023);
  const Shape s = p.s;  // a copy: the epilogues capture locals only
  const BwdLayout lay = bwd_layout(s.in_pad, WP);
  const int W = WP, nb = s.n_block, od = s.out_dim, K = s.x_cols, L = s.embed_L;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + lay.ring);
  __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(smem + lay.h);     // h_in
  __nv_bfloat16* sdg2 = reinterpret_cast<__nv_bfloat16*>(smem + lay.dg2); // dg2, then dpre
  __nv_bfloat16* sdg1 = reinterpret_cast<__nv_bfloat16*>(smem + lay.dg1); // hs[nb], then dg1
  float* red2 = reinterpret_cast<float*>(smem + lay.red2);  // [4 warps][W] partials of dg2 (dpre)
  float* red1 = reinterpret_cast<float*>(smem + lay.red1);  // ... of dg1
  float* sdt = reinterpret_cast<float*>(smem + lay.dt);
  float* sb0 = reinterpret_cast<float*>(smem + lay.b0);  // [2 slots][W] b0 of a block
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + ST;
  uint64_t* hbar = empty + ST;  // the h tile's loads
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wgi = tid / 128, w4 = warp % 4, g = lane / 4, t = lane % 4, wr = w4 * 16;
  const int col0 = wgi * NT + 2 * t;
  const long long ray0 = (long long)blockIdx.x * TB;
  const size_t Bp = (size_t)gridDim.x * TB;
  const __nv_bfloat16* tail_w = p.w.tail_w;
  // this tile's row of column sums: head_b | body_b | tail_w | tail_b
  float* part_head_b = p.part + blockIdx.x * (size_t)(W + 2 * nb * W + od * W + od);
  float* part_body_b = part_head_b + W;
  float* part_tail_w = part_body_b + 2 * nb * W;
  float* part_tail_b = part_tail_w + od * W;

  if (tid == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1);               // the loading thread's arrive, plus the bytes
      mbar_init(&empty[st], NTHREADS / 32);  // every warp
    }
    mbar_init(hbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers exist before any copy or arrival

  // ---- the loads, by thread 0: the weight chunks, ST ahead of the
  // products: per block in reverse, W0 (K-major), W1^T, W0^T, each [W, 64]
  const int total = nb * 3 * NCH;
  auto issue = [&](int n) {
    if (n >= total) return;
    const int st = n % ST;
    mbar_wait(&empty[st], ((n / ST) & 1) ^ 1);
    const int q = n / NCH, blk = nb - 1 - q / 3, prod = q % 3;
    mbar_arrive_expect_tx(&full[st], WP * 128);
    tma_box(ring + (size_t)st * WP * wg::KC, prod == 0 ? &maps.body : &maps.body_t,
            (n % NCH) * wg::KC, 0, 2 * blk + (prod == 1), &full[st]);
  };
  // hs[blk]'s rows of the tile into `dst` (a 64-column panel a box),
  // completing on hbar
  auto load_h = [&](__nv_bfloat16* dst, int blk) {
    for (int q = 0; q < NCH; ++q)
      tma_box(dst + q * wg::PANEL, &maps.hs, 64 * q, (int)ray0, blk, hbar);
  };
  // block blk's first bias into slot blk % 2 by cp.async, 16 bytes a
  // thread; the threads that copy wait (cp_async_wait) before the next
  // barrier
  auto prefetch_b0 = [&](int blk) {
    if (tid < W / 4)
      cp_async16(sb0 + (blk & 1) * W + 4 * tid, p.w.body_b + (size_t)(2 * blk) * W + 4 * tid);
    cp_async_commit();
  };
  // a [64, W] tile to rows ray0.. of layer `layer` of a map
  auto store_t = [&](const CUtensorMap* map, const __nv_bfloat16* src, int layer) {
    for (int q = 0; q < NCH; ++q)
      tma_store_box(map, src + q * wg::PANEL, 64 * q, (int)ray0, layer);
  };
  if (tid == 0) {
    // the tail's input and the last block's, one phase of hbar
    mbar_arrive_expect_tx(hbar, 2 * TB * WP * 2);
    load_h(sdg1, nb);
    load_h(sh, nb - 1);
    for (int n = 0; n < ST; ++n) issue(n);
  }

  // ---- the products: warpgroup wgi owns columns [wgi NT, wgi NT + NT)
  float acc[NA], dh[NA];
  // this thread's first row and column of a product (and its place among
  // the column partials), hidden from the optimizer at each epilogue: it
  // would otherwise compute the epilogues' 32 swizzled offsets once, keep
  // them across the block loop and spill them
  struct At {
    int row, col, red;
  };
  auto at = [&]() {
    At a{wr + g, col0, w4 * W + col0};
    asm volatile("" : "+r"(a.row), "+r"(a.col), "+r"(a.red));
    return a;
  };
  int c = 0;  // chunks consumed
  // frees the stage of chunk `read` once this warp's products have read it;
  // thread 0 then loads chunk read + ST
  auto release = [&](int read) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[read % ST]);
    if (tid == 0) issue(read + ST);
  };
  // acc = X[64, W] @ (the next NCH chunks)^T, X in swizzled panels
  auto products = [&](const __nv_bfloat16* X) {
    for (int kc = 0; kc < NCH; ++kc, ++c) {
      const int st = c % ST;
      mbar_wait(&full[st], (c / ST) & 1);
      const uint64_t da = wg::desc(X + kc * wg::PANEL);
      const uint64_t db = wg::desc(ring + (size_t)st * WP * wg::KC + wgi * NT * wg::KC);
      wg::wgmma_fence();
#pragma unroll
      for (int k = 0; k < wg::KC / 16; ++k)
        wg::Wgmma<NT>::run(acc, da + 2 * k, db + 2 * k, kc + k > 0);
      wg::wgmma_commit();
      if (kc > 0) {
        wg::wgmma_wait<1>();  // the chunk before this one has been read
        release(c - 1);
      }
    }
    wg::wgmma_wait<0>();
    release(c - 1);
#pragma unroll
    for (int i = 0; i < NA; ++i) wg::fence_reg(acc[i]);
  };
  // The warp's column sums over its 16 rows of the values val(i) (i the
  // index of acc and dh: row wr + g + 8 (i / 2 % 2), column col0 + 8 (i /
  // 4) + i % 2) into red[w4][col]
  auto col_partials = [&](float (&v)[NV], float* red) {
    halve<NV / 2>(v, g & 4, 16);
    halve<NV / 4>(v, g & 2, 8);
    halve<NV / 8>(v, g & 1, 4);
    const At a = at();
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) {
      const int k = (NV / 8) * g + i;  // the column k = 2 j + e this lane now holds
      red[a.red + 8 * (k / 2) + k % 2] = v[i];
    }
  };
  // after a barrier: the four warps' partials of each column added in order
  auto combine = [&](const float* red, float* dst) {
    for (int col = tid; col < W; col += NTHREADS)
      dst[col] = __fadd_rn(__fadd_rn(__fadd_rn(red[col], red[W + col]), red[2 * W + col]),
                           red[3 * W + col]);
  };
  // dh (+)= bf16(dt) @ tail_w: out_dim exact bf16 products summed in f32
  auto tail_dh = [&](bool add) {
    const At a = at();
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int row = a.row + 8 * ((i / 2) % 2), col = a.col + 8 * (i / 4) + i % 2;
      float sum = 0.0f;
      for (int q = 0; q < od; ++q)
        sum = __fadd_rn(sum, __fmul_rn(bf16r(sdt[row * MAX_OUT + q]),
                                       __bfloat162float(tail_w[(size_t)q * W + col])));
      dh[i] = add ? dh[i] + sum : sum;
    }
  };

  // ---- tail: out = sigmoid(hN @ Wt^T + bt), dt = dout * out * (1 - out)
  prefetch_b0(nb - 1);
  mbar_wait(hbar, 0);
  const __nv_bfloat16* hN = sdg1;
  for (int q = warp; q < TB * od; q += NTHREADS / 32) {
    const int row = q / od, j = q % od;
    float sum = 0.0f;
    for (int n = lane; n < W; n += 32)
      sum += __bfloat162float(hN[wg::swz(row, n)]) * __bfloat162float(tail_w[(size_t)j * W + n]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const long long ray = ray0 + row;
      float d = 0.0f;                     // rays past B contribute nothing
      if (ray < s.B) {
        const float o = 1.0f / (1.0f + expf(-(sum + p.w.tail_b[j])));
        d = __fmul_rn(__fmul_rn(p.dout[ray * od + j], o), __fsub_rn(1.0f, o));
      }
      sdt[row * MAX_OUT + j] = d;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < od) {
    float sum = 0.0f;
    for (int r = 0; r < TB; ++r) sum += sdt[r * MAX_OUT + tid];
    part_tail_b[tid] = sum;
  }
  for (int q = tid; q < od * W; q += NTHREADS) {
    const int j = q / W, n = q % W;
    float sum = 0.0f;
    for (int r = 0; r < TB; ++r)
      sum = __fadd_rn(sum, __fmul_rn(bf16r(sdt[r * MAX_OUT + j]),
                                     __bfloat162float(hN[wg::swz(r, n)])));
    part_tail_w[q] = sum;
  }
  tail_dh(false);

  // ---- residual blocks in reverse (the schedule: the header)
  const float rs = s.res_scale;
  float v[NV];
  for (int blk = nb - 1; blk >= 0; --blk) {
    // dg2 = dh * res_scale: bf16 operand, f32 bias gradient (its tile's
    // last readers, blk + 1's products and store, are done: barrier B)
    At a = at();
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * j + 2 * hf, row = a.row + 8 * hf, col = a.col + 8 * j;
        const float d0 = __fmul_rn(dh[i], rs), d1 = __fmul_rn(dh[i + 1], rs);
        wg::st_bf16x2(sdg2 + wg::swz(row, col), d0, d1);
        v[2 * j] = hf ? __fadd_rn(v[2 * j], d0) : d0;
        v[2 * j + 1] = hf ? __fadd_rn(v[2 * j + 1], d1) : d1;
      }
    col_partials(v, red2);
    fence_proxy_async();
    if (tid == 0) bulk_wait_read();  // dg1's store (blk + 1) has read its tile
    __syncthreads();  // A: dg2 is whole; both warpgroups' dh products have read dg1
    if (tid == 0) {
      store_t(&maps.dg2, sdg2, blk);
      bulk_commit();
    }
    if (blk > 0) prefetch_b0(blk - 1);  // into the slot blk + 1 read before B (blk + 1)
    combine(red2, part_body_b + (size_t)(2 * blk + 1) * W);

    // g1 = relu(h_in @ W0^T + b0): the relu mask, and g1 straight from the
    // registers to its rows of g1s (b0 from its slot: the biases, 88 KB at
    // W256 D88, do not stay in the L1 beside the tiles)
    mbar_wait(hbar, (nb - 1 - blk) & 1);
    products(sh);
    const float* b0s = sb0 + (blk & 1) * W;
    a = at();
    __nv_bfloat16* g1r = p.g1s + ((size_t)blk * Bp + ray0 + a.row) * W + a.col;
    unsigned long long mask = 0;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * j + 2 * hf;
        const float2 b = *reinterpret_cast<const float2*>(b0s + a.col + 8 * j);
        const float v0 = acc[i] + b.x, v1 = acc[i + 1] + b.y;
        if (v0 > 0.0f) mask |= 1ull << i;
        if (v1 > 0.0f) mask |= 1ull << (i + 1);
        wg::st_bf16x2(g1r + (size_t)(8 * hf) * W + 8 * j, fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      }

    // dg1 = (dg2 @ W1) * (g1 > 0): bf16 operand, f32 bias gradient
    products(sdg2);
    a = at();
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * j + 2 * hf, row = a.row + 8 * hf, col = a.col + 8 * j;
        const float d0 = (mask >> i) & 1ull ? acc[i] : 0.0f;
        const float d1 = (mask >> (i + 1)) & 1ull ? acc[i + 1] : 0.0f;
        wg::st_bf16x2(sdg1 + wg::swz(row, col), d0, d1);
        v[2 * j] = hf ? __fadd_rn(v[2 * j], d0) : d0;
        v[2 * j + 1] = hf ? __fadd_rn(v[2 * j + 1], d1) : d1;
      }
    col_partials(v, red1);
    fence_proxy_async();
    cp_async_wait<0>();              // b0 of blk - 1 has landed
    if (tid == 0) bulk_wait_read();  // dg2's store has read its tile
    __syncthreads();  // B: dg1 is whole; both warpgroups have read h_in and dg2
    if (tid == 0) {
      store_t(&maps.dg1, sdg1, blk);
      bulk_commit();
      if (blk > 0) {  // the h tile is free: the next block's input lands meanwhile
        mbar_arrive_expect_tx(hbar, TB * WP * 2);
        load_h(sh, blk - 1);
      }
    }
    combine(red1, part_body_b + (size_t)(2 * blk) * W);

    // dh += dg1 @ W0
    products(sdg1);
#pragma unroll
    for (int i = 0; i < NA; ++i) dh[i] = dh[i] + acc[i];
  }

  // ---- head: global residual, relu mask from hs[0] (in f32), dpre
  if (s.global_residual) tail_dh(true);
  const __nv_bfloat16* h0 = p.hs;  // hs[0]
  const At a = at();
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 4 * j + 2 * hf, row = a.row + 8 * hf, col = a.col + 8 * j;
      const long long ray = ray0 + row;
      float2 hv = make_float2(0.0f, 0.0f);
      if (ray < s.B)
        hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h0 + ray * W + col));
      if (!(hv.x > 0.0f)) dh[i] = 0.0f;
      if (!(hv.y > 0.0f)) dh[i + 1] = 0.0f;
      wg::st_bf16x2(sdg2 + wg::swz(row, col), dh[i], dh[i + 1]);
      v[2 * j] = hf ? __fadd_rn(v[2 * j], dh[i]) : dh[i];
      v[2 * j + 1] = hf ? __fadd_rn(v[2 * j + 1], dh[i + 1]) : dh[i + 1];
    }
  col_partials(v, red2);
  fence_proxy_async();
  __syncthreads();  // dpre is whole; every product has run (the ring and h are free)
  if (tid == 0) {
    store_t(&maps.dpre, sdg2, 0);
    bulk_commit();
  }
  combine(red2, part_head_b);

  // ---- dx = dpre @ head_w, chained through the embed when embed_L > 0,
  // on r2l_mma.cuh's warps of 32 columns over the freed ring and h tile
  const float* xg = p.x;
  float* dxg = p.dx;
  if (NEED_DX) {
    __nv_bfloat16* dpa = reinterpret_cast<__nv_bfloat16*>(smem + lay.dx_a);
    float* dp = reinterpret_cast<float*>(smem + lay.dx_dp);
    const int lda = W + PAD;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * j + 2 * hf, row = a.row + 8 * hf, col = a.col + 8 * j;
        store_bf16x2(dpa + row * lda + col, dh[i], dh[i + 1]);
      }
    if (L > 0)
      for (int q = tid; q < TB * K; q += NTHREADS) dp[q] = 0.0f;
    const int n0 = warp * WN;
    for (int nc = 0; nc < s.in_pad; nc += W) {
      const int ncols = min(W, s.in_pad - nc);
      mma_stream_kn(dpa, lda, p.w.head_w + nc, s.in_pad, W, ncols, W,
                    reinterpret_cast<__nv_bfloat16*>(smem + lay.dx_ring), [&](Frag& fr) {
        for (int i = 0; i < RT; ++i)
          for (int j = 0; j < NJ; ++j)
            for (int e = 0; e < 4; ++e) {
              const int row = 16 * i + g + 8 * (e / 2), col = n0 + 8 * j + 2 * t + e % 2;
              const long long ray = ray0 + row;
              const int n = nc + col;
              if (col >= ncols || ray >= s.B) continue;
              const float val = fr[i][j][e];
              if (L == 0) {
                if (n < K) dxg[ray * K + n] = val;
                continue;
              }
              const int b = n / K, m = n % K;
              if (b > 2 * L) continue;     // zero padding columns
              float term = val;            // identity block
              if (b < 2 * L) {
                // d sin(2^j p) = 2^j cos(2^j p) dp, d cos(2^j p) = -2^j sin(2^j p) dp
                const int jj = b % L;
                float sn, cs;
                fast_sincos(xg[ray * K + m], sn, cs, 9);
                for (int q = 0; q < jj; ++q) {
                  const float s2 = __fmul_rn(__fmul_rn(2.0f, sn), cs);
                  cs = __fsub_rn(1.0f, __fmul_rn(__fmul_rn(2.0f, sn), sn));
                  sn = s2;
                }
                const float f = (float)(1 << jj);
                term = b < L ? __fmul_rn(val, __fmul_rn(f, cs)) : -__fmul_rn(val, __fmul_rn(f, sn));
              }
              atomicAdd(dp + row * K + m, term);
            }
      });
    }
    if (L > 0)
      for (int q = tid; q < TB * K; q += NTHREADS) {
        const long long ray = ray0 + q / K;
        if (ray < s.B) dxg[ray * K + q % K] = dp[q];
      }
  }

  // ---- the head's weight-gradient operand: the recomputed embed, over
  // everything (dpre's store has read its tile)
  if (tid == 0) bulk_wait_read();
  __syncthreads();
  const int lde = s.in_pad + PAD;
  __nv_bfloat16* emb = reinterpret_cast<__nv_bfloat16*>(smem + lay.emb);
  embed_tile(xg, ray0, s, emb, lde);
  __syncthreads();
  store_tile(p.embs, emb, lde, s.in_pad, ray0);
  if (tid == 0) bulk_wait();
}

template <int NT>
int bwd_launch(const BwdMaps& maps, const BwdArgs& p, unsigned grid, size_t smem,
               cudaStream_t stream) {
  auto kernel = p.dx != nullptr ? r2l_train_bwd_kernel<NT, true> : r2l_train_bwd_kernel<NT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

bool shape_ok(const Shape& s) {
  const int in_dim = s.embed_L > 0 ? s.x_cols * (2 * s.embed_L + 1) : s.x_cols;
  return s.W % KC == 0 && s.W <= WN * NWARPS && s.in_pad % KC == 0 &&
         in_dim <= s.in_pad && s.n_block >= 1 && s.out_dim >= 1 &&
         s.out_dim <= MAX_OUT && s.x_cols >= 1;
}

Shape make_shape(int B, int x_cols, int embed_L, int in_pad, int W, int n_block,
                 int out_dim, float res_scale, int global_residual) {
  Shape s;
  s.B = B;
  s.x_cols = x_cols;
  s.embed_L = embed_L;
  s.in_pad = in_pad;
  s.W = W;
  s.n_block = n_block;
  s.out_dim = out_dim;
  s.global_residual = global_residual;
  s.hs_rows = B;
  s.res_scale = res_scale;
  return s;
}

}  // namespace

// Bytes of dynamic shared memory a block of each kernel needs; above 232448
// the shape is not supported.
extern "C" long long r2l_train_fwd_smem_bytes(int in_pad, int W) {
  return (long long)wg::layout(in_pad, wg::round_up64(W), true).total;
}

extern "C" long long r2l_train_bwd_smem_bytes(int in_pad, int W) {
  return (long long)bwd_layout(in_pad, W).total;
}

// The backward's weight-ring stages at width W (3 at W256).
extern "C" int r2l_train_bwd_stages(int W) { return bwd_stages(W); }

// Both launch on `stream` and return cudaGetLastError() (0 = ok). Shapes are
// checked by the Python wrapper; the checks here guard the kernels' own
// assumptions.
extern "C" int r2l_train_fwd_launch(const float* x, const void* head_w, const float* head_b,
                                    const void* body_w, const float* body_b,
                                    const void* tail_w, const float* tail_b, float* out,
                                    void* hs, int B, int x_cols, int embed_L, int in_pad,
                                    int W, int n_block, int out_dim, float res_scale,
                                    int global_residual, void* stream) {
  if (B <= 0) return 0;
  const Shape s = make_shape(B, x_cols, embed_L, in_pad, W, n_block, out_dim, res_scale,
                             global_residual);
  if (!shape_ok(s) || !wg::tile_ok(in_pad, W, n_block, out_dim, global_residual != 0))
    return (int)cudaErrorInvalidValue;
  wg::Maps maps;  // hs [n_block + 1, B, W]: boxes of 64 columns x 64 rays
  if (!wg::weight_maps(&maps, head_w, body_w, in_pad, W, n_block) ||
      !encode(encoder(), &maps.hs, hs, W, B, n_block + 1, 2LL * W, 2LL * W * B, wg::TB))
    return (int)cudaErrorInvalidValue;
  FwdArgs p;
  p.net = wg::make_net(head_b, body_b, tail_w, tail_b, out, B, x_cols, embed_L, in_pad, W,
                       n_block, out_dim, res_scale, global_residual);
  p.x = x;
  return wg::launch_tile<FwdKernel>(maps, p, B, in_pad, W, global_residual != 0,
                                    (cudaStream_t)stream);
}

// The backward's pass 1: the scratch of pass 2 (dg2s, dg1s, g1s [n_block,
// Bp, W], dpres [Bp, W], embs [Bp, in_pad] bf16, part [Bp / 64, W + 2
// n_block W + out_dim W + out_dim] f32, Bp = B rounded up to 64; every
// element written) and dx. hs holds block b's rows at hs + b hs_rows W;
// body_wt is body_w with each [W, W] layer transposed.
extern "C" int r2l_train_bwd_launch(const float* x, const void* hs, const float* dout,
                                    const void* head_w, const float* head_b,
                                    const void* body_w, const float* body_b,
                                    const void* tail_w, const float* tail_b,
                                    const void* body_wt, void* dg2s, void* dg1s, void* g1s,
                                    void* dpres, void* embs, float* part, float* dx, int B,
                                    int hs_rows, int x_cols, int embed_L, int in_pad, int W,
                                    int n_block, int out_dim, float res_scale,
                                    int global_residual, void* stream) {
  (void)head_b;  // the head's bias gradient is dpre's column sums
  if (B <= 0) return 0;
  BwdArgs p;
  p.s = make_shape(B, x_cols, embed_L, in_pad, W, n_block, out_dim, res_scale,
                   global_residual);
  if (hs_rows < B) return (int)cudaErrorInvalidValue;
  p.s.hs_rows = hs_rows;
  const BwdLayout lay = bwd_layout(in_pad, W);
  // dx's tiles and [TB, K] f32 sums end below the dg2 tile (dpre's store
  // reads it meanwhile)
  const bool dx_fits = dx == nullptr ||
                       lay.dx_dp + (embed_L > 0 ? (size_t)TB * x_cols * 4 : 0) <= lay.dg2;
  if (!shape_ok(p.s) || !dx_fits || lay.total > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + TB - 1) / TB);
  const long long Bp = (long long)blocks * TB;
  EncodeTiled fn = encoder();
  BwdMaps maps;
  if (fn == nullptr ||
      !encode(fn, &maps.body, body_w, W, W, 2LL * n_block, 2LL * W, 2LL * W * W, W) ||
      !encode(fn, &maps.body_t, body_wt, W, W, 2LL * n_block, 2LL * W, 2LL * W * W, W) ||
      !encode(fn, &maps.hs, hs, W, B, n_block + 1, 2LL * W, 2LL * W * hs_rows, TB) ||
      !encode(fn, &maps.dg2, dg2s, W, Bp, n_block, 2LL * W, 2LL * W * Bp, TB) ||
      !encode(fn, &maps.dg1, dg1s, W, Bp, n_block, 2LL * W, 2LL * W * Bp, TB) ||
      !encode(fn, &maps.dpre, dpres, W, Bp, 1, 2LL * W, 2LL * W * Bp, TB))
    return (int)cudaErrorInvalidValue;
  p.w.head_w = static_cast<const __nv_bfloat16*>(head_w);
  p.w.body_b = body_b;
  p.w.tail_w = static_cast<const __nv_bfloat16*>(tail_w);
  p.w.tail_b = tail_b;
  p.x = x;
  p.hs = static_cast<const __nv_bfloat16*>(hs);
  p.dout = dout;
  p.g1s = static_cast<__nv_bfloat16*>(g1s);
  p.embs = static_cast<__nv_bfloat16*>(embs);
  p.part = part;
  p.dx = dx;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 64: return bwd_launch<32>(maps, p, blocks, lay.total, st);
    case 128: return bwd_launch<64>(maps, p, blocks, lay.total, st);
    case 192: return bwd_launch<96>(maps, p, blocks, lay.total, st);
    case 256: return bwd_launch<128>(maps, p, blocks, lay.total, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
