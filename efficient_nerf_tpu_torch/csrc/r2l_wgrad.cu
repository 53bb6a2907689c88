// Weight gradients of the R2L training backward for Hopper (sm_90a): the
// second of the backward's two passes.
//
// Replaces the weight-gradient half of
// efficient_nerf_tpu/ops/pallas/r2l_train.py::_bwd_kernel (:115, pallas_call
// :323): its `grad_w` products (:132-134, :148, :163, :167, :183/:198) and the
// bias sums (:149, :164, :168, :184/:199), which the TPU grid adds tile by
// tile into VMEM-resident f32 blocks. On the card, pass 1
// (csrc/r2l_train.cu, r2l_train_bwd_kernel) walks the ray tiles in parallel
// and writes the bf16 operands of those products, dg2, g1 and dg1 of every
// block, dpre and the embed, plus each tile's f32 column sums; this pass
// contracts the rays:
//   dW1[b] = dg2[b]^T g1[b], dW0[b] = dg1[b]^T hs[b]   (86 [W, W] products)
//   dW_head = dpre^T emb                              ([W, in_pad])
// each bf16 product summed in f32, and adds the per-tile bias and tail sums.
//
// Bound (W256 D88, 98,304 rays): each body product reads two [B, 256] bf16
// operands (2 x 50.3 MB) for 2 x 256^2 x B FLOP, 128 FLOP a byte, under the
// H100's ~295 FLOP/B ridge: the pass is bound by HBM, 8.9 GB (2.66 ms at
// 3.35 TB/s), not by the tensor cores (1.16 TFLOP, 1.17 ms). So the design
// works on the loads:
//   * a unit of work is (product, 128-column output tile, ray chunk): a
//     [W, 128] f32 tile held in registers (8 warps of 64 x 64) while the ray
//     tiles of the chunk stream past; the two column tiles of one product run
//     side by side, so the row operand they share is read from HBM once and
//     from L2 the second time; persistent blocks walk the units, one a
//     block per SM, so the 180 output tiles x chunks fill all 132 SMs;
//   * operand tiles of 64 rays arrive by TMA: tensor maps over the six
//     operand arrays (3-D: columns, rays, layer), boxes of 64 rays x 64
//     columns landed with the 128-byte swizzle, so that ldmatrix.trans reads
//     them without bank conflicts; one thread of a producer warpgroup issues
//     them into a ring of WS stages, each stage completing on an mbarrier
//     (transaction bytes); the consumer warps wait on that stage's barrier
//     and release it on another, with no block barrier per stage. Rays past
//     hs's valid ones (a ragged last tile) lie outside its tensor map and
//     land as zeros. The producer warpgroup gives its registers to the
//     consumers (setmaxnreg), which hold a 64 x 64 f32 tile each;
//   * the products are mma.sync m16n8k16 with ldmatrix.trans operands (at
//     128 FLOP a byte they do not bind);
//   * no atomics: each unit stores its partial tile, and a second launch adds
//     the ray chunks' partials and the per-tile bias sums in a fixed order, so
//     two calls on the same inputs give bit-identical gradients.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "r2l_mma.cuh"

namespace {

using namespace enerf;  // TB, NWARPS, NTHREADS, mma_bf16, ldmatrix (r2l_mma.cuh)

constexpr int WS = 4;              // ring stages
constexpr int TM = 256;            // output rows of a unit: the row operand's columns (<= W)
constexpr int TN = 128;            // output columns of a unit
constexpr int BOX = TB * 64;       // bf16 elements of a 64-ray x 64-column TMA box (8 KB)
constexpr int A_TILE = TM / 64 * BOX;       // a stage: the row operand's boxes, then
constexpr int STAGE = A_TILE + TN / 64 * BOX;  // the column operand's
constexpr size_t RING_BYTES = (size_t)WS * STAGE * 2;
constexpr int NT_TMA = NTHREADS + 128;  // 2 consumer warpgroups and the producer's
constexpr int N_SEG = 6;
enum Map { M_DG2, M_DG1, M_G1, M_HS, M_DPRE, M_EMB, N_MAPS };

// Tensor maps over the operand arrays: [layer][ray][column] bf16, boxes of
// 64 columns x 64 rays x 1 layer, the 128-byte swizzle.
struct TMaps {
  CUtensorMap m[N_MAPS];
};

struct WgArgs {
  float* work;                           // [n_chunks, total_w] partial tiles
  long long total_w;                     // 2 nb W^2 + W in_pad
  int n_rt, W, in_pad, nb, chunk_rt, nt_body, nt_head, n_units;
};

// One unit: out[M, n0 .. n0 + nw) of A^T B over ray tiles t0 .. t0 + nt,
// A and B layer `layer` of the tensor maps amap and bmap.
struct Unit {
  float* out;                    // [M, N] f32, row stride N
  int M, N, n0, nw, t0, nt;
  int amap, bmap, layer;
};

__device__ Unit unit_of(const WgArgs& p, int u) {
  const int per_chunk = 2 * p.nb * p.nt_body + p.nt_head;
  const int c = u / per_chunk, r = u % per_chunk;
  const size_t WW = (size_t)p.W * p.W;
  float* work = p.work + (size_t)c * p.total_w;
  Unit q;
  q.M = p.W;
  if (r < 2 * p.nb * p.nt_body) {
    const int l = r / p.nt_body;
    q.n0 = (r % p.nt_body) * TN;
    q.N = p.W;
    q.out = work + (size_t)l * WW;
    q.layer = l / 2;
    q.amap = (l & 1) ? M_DG2 : M_DG1;   // dW1 = dg2^T g1, dW0 = dg1^T h_in
    q.bmap = (l & 1) ? M_G1 : M_HS;
  } else {                               // dW_head = dpre^T emb
    q.n0 = (r - 2 * p.nb * p.nt_body) * TN;
    q.N = p.in_pad;
    q.out = work + 2 * p.nb * WW;
    q.layer = 0;
    q.amap = M_DPRE;
    q.bmap = M_EMB;
  }
  q.nw = min(TN, q.N - q.n0);
  q.t0 = c * p.chunk_rt;
  q.nt = min(p.chunk_rt, p.n_rt - q.t0);
  return q;
}

typedef float Acc[4][8][4];  // warp (ms, ns): rows 64 ms + 16 i + g (+8), cols 64 ns + 8 j + 2 t

// The 8 columns c .. c + 7 (c a multiple of 8) of row r of a [TB, *] tile
// landed as 64-column TMA boxes of 128-byte rows, whose 16-byte chunks the
// 128-byte swizzle permutes by the row's low 3 bits.
__device__ __forceinline__ const __nv_bfloat16* tile_at(const __nv_bfloat16* tile, int r,
                                                        int c) {
  return tile + (c >> 6) * BOX + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3);
}

// acc += A^T B over one 64-ray stage: A [TB, M] and B [TB, nw] in shared
// memory, both rows by ray, so both load transposed (as mma_stream_kn's B).
__device__ __forceinline__ void stage_product(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                              Acc& acc, int ms, int ns, int lane) {
  const int mi = lane / 8;
#pragma unroll
  for (int kk = 0; kk < TB; kk += 16) {
    // B for columns 64 ns + 16 jj .., rays kk ..: matrices (k lo, n lo),
    // (k hi, n lo), (k lo, n hi), (k hi, n hi), as load_b_kn
    unsigned b[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      ldmatrix_x4_trans(b[jj], tile_at(Bs, kk + (mi % 2) * 8 + lane % 8,
                                       64 * ns + 16 * jj + (mi / 2) * 8));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // A^T fragment, rows 64 ms + 16 i (A's columns), k = rays kk ..:
      // matrices (m lo, k lo), (m hi, k lo), (m lo, k hi), (m hi, k hi)
      unsigned a[4];
      ldmatrix_x4_trans(a, tile_at(As, kk + (mi / 2) * 8 + lane % 8,
                                   64 * ms + 16 * i + (mi % 2) * 8));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        mma_bf16(acc[i][2 * jj], a, b[jj][0], b[jj][1]);
        mma_bf16(acc[i][2 * jj + 1], a, b[jj][2], b[jj][3]);
      }
    }
  }
}

__device__ __forceinline__ void acc_zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

__device__ __forceinline__ void acc_store(const Acc& acc, const Unit& q, int ms, int ns,
                                          int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 64 * ms + 16 * i + g + 8 * hf;
        const int col = q.n0 + 64 * ns + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(q.out + (size_t)row * q.N + col) =
            make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
      }
}

// ---- mbarriers and TMA
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait of about ten
// seconds means a lost copy or arrival: trap, so that the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One 64 x 64 box of a 3-D tensor map at (column c0, ray c1, layer c2).
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int c1,
                                        int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// Consumer warp (ms, ns) owns output rows 64 ms.., columns 64 ns.. of each
// unit: it waits for each stage's full barrier, multiplies, and releases
// the stage on its empty barrier.
__device__ __forceinline__ void consume(const WgArgs& p, const __nv_bfloat16* ring,
                                        uint64_t* full, uint64_t* empty, int warp, int lane) {
  const int ms = warp / 2, ns = warp % 2;
  int k = 0;
  Acc acc;
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const Unit q = unit_of(p, u);
    const bool active = 64 * ms < q.M && 64 * ns < q.nw;
    acc_zero(acc);
    for (int t = 0; t < q.nt; ++t, ++k) {
      const int s = k % WS;
      mbar_wait(&full[s], (k / WS) & 1);
      const __nv_bfloat16* As = ring + (size_t)s * STAGE;
      if (active) stage_product(As, As + A_TILE, acc, ms, ns, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (active) acc_store(acc, q, ms, ns, lane);
  }
}

// The pass: a producer warpgroup whose one thread issues TMA
// boxes into a WS-stage ring of 1024-byte-aligned stages, and two consumer
// warpgroups; full and empty mbarriers per stage.
__global__ void __launch_bounds__(NT_TMA, 1) r2l_wgrad_tma_kernel(const __grid_constant__ TMaps maps,
                                                                  const WgArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING_BYTES);
  uint64_t* empty = full + WS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WS; ++s) {
      mbar_init(&full[s], 1);            // the producer's arrive, plus the bytes
      mbar_init(&empty[s], NWARPS);      // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NWARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != NTHREADS) return;
    int k = 0;
    for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
      const Unit q = unit_of(p, u);
      const int na = q.M / 64, nbx = q.nw / 64;
      const unsigned bytes = (unsigned)((na + nbx) * BOX * 2);
      for (int t = 0; t < q.nt; ++t, ++k) {
        const int s = k % WS;
        mbar_wait(&empty[s], ((k / WS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], bytes);
        __nv_bfloat16* As = ring + (size_t)s * STAGE;
        const int ray0 = (q.t0 + t) * TB;
        for (int b = 0; b < na; ++b)
          tma_box(As + b * BOX, &maps.m[q.amap], 64 * b, ray0, q.layer, &full[s]);
        for (int b = 0; b < nbx; ++b)
          tma_box(As + A_TILE + b * BOX, &maps.m[q.bmap], q.n0 + 64 * b, ray0, q.layer,
                  &full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  consume(p, ring, full, empty, warp, lane);
}

// dst[e] (+)= sum over rows r of src[r * stride + e], the rows summed in a
// fixed order: 8 row groups, each in order, then the groups in order.
struct Seg {
  const float* src;
  float* dst;
  long long stride, len;
  int rows;
};

struct RedArgs {
  Seg s[N_SEG];
  int accumulate;
};

__global__ void __launch_bounds__(256) r2l_wgrad_reduce_kernel(const RedArgs a) {
  __shared__ float sums[8][33];
  const Seg sg = a.s[blockIdx.y];
  const long long col = (long long)blockIdx.x * 32 + threadIdx.x;
  if ((long long)blockIdx.x * 32 >= sg.len) return;  // the whole block: no barrier skipped
  float sum = 0.0f;
  if (col < sg.len)
    for (int r = threadIdx.y; r < sg.rows; r += 8) sum += sg.src[(size_t)r * sg.stride + col];
  sums[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && col < sg.len) {
    float tot = 0.0f;
#pragma unroll
    for (int y = 0; y < 8; ++y) tot += sums[y][threadIdx.x];
    sg.dst[col] = a.accumulate ? sg.dst[col] + tot : tot;
  }
}

// Ray chunks: the count whose waves of units, each a chunk of ray tiles
// plus a few tiles' worth of pipeline fill and epilogue, finish first on
// `sms` blocks; ties go to fewer chunks (less partial traffic).
int pick_chunks(int n_rt, int n_out, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int nc = 1; nc <= 32 && nc <= n_rt; ++nc) {
    const int chunk = (n_rt + nc - 1) / nc;
    const int eff = (n_rt + chunk - 1) / chunk;
    const long long units = (long long)n_out * eff;
    const long long cost = (units + sms - 1) / sms * (chunk + 4);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = eff;
    }
  }
  return best;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (the library links no libcuda), or null.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A [layers][rows][cols] bf16 array with the given strides in bytes, read
// as 64 x 64 x 1 boxes with the 128-byte swizzle; rows past `rows` read zeros.
bool encode(EncodeTiled fn, CUtensorMap* m, const void* base, long long cols, long long rows,
            long long layers, long long row_bytes, long long layer_bytes) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)layers};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)layer_bytes};
  const cuuint32_t box[3] = {64, TB, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// Floats of f32 workspace the pass needs for its ray chunks' partial tiles.
extern "C" long long r2l_wgrad_work_floats(int n_rt, int W, int in_pad, int nb) {
  const int n_out = 2 * nb * ((W + TN - 1) / TN) + (in_pad + TN - 1) / TN;
  const long long total_w = 2LL * nb * W * W + (long long)W * in_pad;
  return pick_chunks(n_rt, n_out, sm_count()) * total_w;
}

// The weight gradients of one pass-1 scratch (n_rt tiles of 64 rays, B of
// them valid), written (accumulate = 0) or added (1) into the f32 gradients.
// part: pass 1's [n_rt, P] per-tile sums, P = W + 2 nb W + out_dim W +
// out_dim (head_b | body_b | tail_w | tail_b). Returns cudaGetLastError().
extern "C" int r2l_wgrad_launch(const void* dg2, const void* dg1, const void* g1,
                                const void* hs, const void* dpre, const void* emb,
                                const float* part, float* work,
                                float* g_head_w, float* g_head_b, float* g_body_w,
                                float* g_body_b, float* g_tail_w, float* g_tail_b, int n_rt,
                                int B, int hs_rows, int W, int in_pad, int nb, int out_dim,
                                int accumulate, void* stream) {
  if (n_rt <= 0) return 0;
  if (W % 64 || W > TM || in_pad % 64 || nb < 1 || out_dim < 1 || B > n_rt * TB)
    return (int)cudaErrorInvalidValue;
  WgArgs p;
  p.work = work;
  p.total_w = 2LL * nb * W * W + (long long)W * in_pad;
  p.n_rt = n_rt;
  p.W = W;
  p.in_pad = in_pad;
  p.nb = nb;
  p.nt_body = (W + TN - 1) / TN;
  p.nt_head = (in_pad + TN - 1) / TN;
  const int sms = sm_count();
  const int n_out = 2 * nb * p.nt_body + p.nt_head;
  const int nc = pick_chunks(n_rt, n_out, sms);
  p.chunk_rt = (n_rt + nc - 1) / nc;
  p.n_units = n_out * nc;
  const unsigned grid = (unsigned)(p.n_units < sms ? p.n_units : sms);
  cudaStream_t st = (cudaStream_t)stream;
  // the ring, its barriers, and slack to align the ring to 1024 bytes
  const size_t smem = RING_BYTES + 2 * WS * sizeof(uint64_t) + 1024;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  TMaps maps;  // hs's map ends at ray B: the rays past it land as zeros
  const long long Bp = (long long)n_rt * TB, W2 = 2LL * W;
  const bool ok = encode(fn, &maps.m[M_DG2], dg2, W, Bp, nb, W2, Bp * W2) &&
                  encode(fn, &maps.m[M_DG1], dg1, W, Bp, nb, W2, Bp * W2) &&
                  encode(fn, &maps.m[M_G1], g1, W, Bp, nb, W2, Bp * W2) &&
                  encode(fn, &maps.m[M_HS], hs, W, B, nb, W2, hs_rows * W2) &&
                  encode(fn, &maps.m[M_DPRE], dpre, W, Bp, 1, W2, Bp * W2) &&
                  encode(fn, &maps.m[M_EMB], emb, in_pad, Bp, 1, 2LL * in_pad,
                         Bp * 2LL * in_pad);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(r2l_wgrad_tma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  r2l_wgrad_tma_kernel<<<grid, NT_TMA, smem, st>>>(maps, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long P_body = 2LL * nb * W, P_tail = (long long)out_dim * W;
  const long long P = W + P_body + P_tail + out_dim;
  RedArgs r;
  r.accumulate = accumulate;
  const long long WW2 = 2LL * nb * W * W;
  r.s[0] = {work, g_body_w, p.total_w, WW2, nc};
  r.s[1] = {work + WW2, g_head_w, p.total_w, (long long)W * in_pad, nc};
  r.s[2] = {part, g_head_b, P, W, n_rt};
  r.s[3] = {part + W, g_body_b, P, P_body, n_rt};
  r.s[4] = {part + W + P_body, g_tail_w, P, P_tail, n_rt};
  r.s[5] = {part + W + P_body + P_tail, g_tail_b, P, out_dim, n_rt};
  long long longest = 0;
  for (int i = 0; i < N_SEG; ++i) longest = r.s[i].len > longest ? r.s[i].len : longest;
  const dim3 rgrid((unsigned)((longest + 31) / 32), N_SEG);
  r2l_wgrad_reduce_kernel<<<rgrid, dim3(32, 8), 0, st>>>(r);
  return (int)cudaGetLastError();
}
