// Tensor-core building blocks of the R2L training backward on mma.sync: pass
// 2 (r2l_wgrad.cu: mma_bf16 with ldmatrix fragments) and pass 1's dx chain
// (r2l_train.cu, need_dx only: mma_stream_kn). mma.sync m16n8k16 bf16
// products with f32 accumulators, operands fetched with ldmatrix from padded
// (bank-conflict-free) shared rows, and weights streamed from L2 through a
// cp.async ring. The forwards and pass 1's chain run on wgmma tiles
// (r2l_wgmma.cuh, nerf_wgmma.cuh, r2l_train.cu).
//
// mma_stream_kn runs 8 warps on a tile of TB = 64 rays. For a [TB, N]
// output, warp w owns columns [32 w, 32 w + 32) of all TB rows: a Frag holds
// them, 64 f32 values a thread.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace enerf {

constexpr int TB = 64;             // rays per block
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RT = TB / 16;        // 16-row tiles per block
constexpr int WN = 32;             // output columns per warp
constexpr int NJ = WN / 8;         // 8-column mma tiles per warp
constexpr int KC = 64;             // contraction rows of a weight chunk
constexpr int S = 2;               // weight ring stages
constexpr int PAD = 8;             // bf16 row padding: rows 16 B apart in banks
constexpr int MAX_SMEM = 232448;   // 227 KB, the opt-in limit of sm_90

// Bytes of one ring stage of mma_stream_kn: a [KC, W] chunk of a weight read
// as [in, out], rows padded.
__host__ __device__ inline size_t ring_stage_bytes(int W) { return (size_t)KC * (W + PAD) * 2; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each 8x8 matrix transposed on the way into registers.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Accumulator fragment of warp w, thread (g = lane / 4, t = lane % 4):
// acc[i][j][e] is output row 16 i + g + 8 (e / 2), column WN w + 8 j + 2 t +
// e % 2.
typedef float Frag[RT][NJ][4];

__device__ __forceinline__ void frag_zero(Frag& f) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[i][j][e] = 0.0f;
}

// A fragment of rows 16 i.. of a row-major [TB, K] bf16 tile X at column k0.
__device__ __forceinline__ void load_a(unsigned (&a)[4], const __nv_bfloat16* X,
                                       int ldx, int i, int k0, int lane) {
  ldmatrix_x4(a, X + (size_t)(16 * i + lane % 16) * ldx + k0 + (lane / 16) * 8);
}

// B fragments for columns n .. n + 15 and contraction rows k0 .. k0 + 15 of
// a [K, N] row-major bf16 tile (rows k): matrices (k lo, n lo), (k hi, n lo),
// (k lo, n hi), (k hi, n hi), so that b[0], b[1] feed columns n .. n + 7 and
// b[2], b[3] columns n + 8 .. n + 15.
__device__ __forceinline__ void load_b_kn(unsigned (&b)[4], const __nv_bfloat16* B,
                                          int ldb, int k0, int n, int lane) {
  const int mi = lane / 8;
  ldmatrix_x4_trans(b, B + (size_t)(k0 + (mi % 2) * 8 + lane % 8) * ldb + n +
                           (mi / 2) * 8);
}

// One product X[TB, K] @ Wk, Wk a [K, ncols] slice (row stride ldw) of a
// bf16 matrix in global memory read in its stored orientation: for an
// [out, in] weight that is dY @ W, the input gradient. Output columns are
// [0, W); columns at or past ncols read zeros. The weight streams through
// `ring` in chunks of KC rows, S - 1 chunks ahead; at the end each warp that
// owns columns calls epi(acc). Ends with a block barrier.
template <class Epi>
__device__ __forceinline__ void mma_stream_kn(const __nv_bfloat16* X, int ldx,
                                              const __nv_bfloat16* Wk, int ldw,
                                              int K, int ncols, int W,
                                              __nv_bfloat16* ring, Epi epi) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int total = K / KC, ldk = W + PAD;
  const bool owns = warp * WN < W;
  const int n0 = warp * WN;
  const size_t stage = ring_stage_bytes(W) / 2;

  auto load_chunk = [&](int c) {
    if (c < total) {
      const __nv_bfloat16* src = Wk + (size_t)c * KC * ldw;
      __nv_bfloat16* dst = ring + (size_t)(c % S) * stage;
      for (int q = tid; q < KC * (W / 8); q += NTHREADS) {
        const int r = q / (W / 8), col = (q % (W / 8)) * 8;
        if (col < ncols)
          cp_async16(dst + r * ldk + col, src + (size_t)r * ldw + col);
        else
          *reinterpret_cast<uint4*>(dst + r * ldk + col) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < S - 1; ++c) load_chunk(c);
  Frag acc;
  frag_zero(acc);
  for (int c = 0; c < total; ++c) {
    cp_async_wait<S - 2>();
    __syncthreads();
    load_chunk(c + S - 1);
    if (owns) {
      const __nv_bfloat16* st = ring + (size_t)(c % S) * stage;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        unsigned b[NJ / 2][4];
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj)
          load_b_kn(b[jj], st, ldk, kk, n0 + 16 * jj, lane);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          unsigned a[4];
          load_a(a, X, ldx, i, c * KC + kk, lane);
#pragma unroll
          for (int jj = 0; jj < NJ / 2; ++jj) {
            mma_bf16(acc[i][2 * jj], a, b[jj][0], b[jj][1]);
            mma_bf16(acc[i][2 * jj + 1], a, b[jj][2], b[jj][3]);
          }
        }
      }
    }
  }
  if (owns) epi(acc);
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace enerf
