// mbarriers, TMA copies and tensor maps, shared by the kernels that stream
// tiles with the Tensor Memory Accelerator: the weight-gradient pass
// (r2l_wgrad.cu) and the wgmma tiles (r2l_wgmma.cuh, nerf_wgmma.cuh).
//
// Device side: mbarrier init / arrive / expect_tx / wait (with a trap on a
// lost arrival), 3-D TMA loads and stores. Host side: cuTensorMapEncodeTiled,
// looked up through the CUDA runtime's entry-point query (the libraries
// link no libcuda), and a 3-D bf16 or int8 map with the 128-byte swizzle.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace enerf {

__device__ __forceinline__ unsigned tma_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tma_smem_addr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tma_smem_addr(b)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tma_smem_addr(b)),
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
        : "r"(tma_smem_addr(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ---- TMA
// One box of a 3-D tensor map at (c0, c1, c2) into this block's shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int c1,
                                        int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(tma_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(tma_smem_addr(bar))
      : "memory");
}

// One box of shared memory stored at (c0, c1, c2) of a 3-D tensor map;
// elements outside the map are not written. Tracked by bulk groups.
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map, const void* src, int c0,
                                              int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(tma_smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The committed stores have read their shared memory (which may be
// overwritten from here on).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The committed stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads of it (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- host: tensor maps
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (the library links no libcuda), or null. The encoder fails on a host
// thread with no current context, such as an autograd worker thread of
// device 0 that has made no runtime call yet: so the current device's primary
// context is made current on the calling thread first.
inline EncodeTiled encoder() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess) return nullptr;
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

// A [layers][rows][cols] array of bf16 (elem_bytes 2) or int8 (elem_bytes 1)
// with the given strides in bytes, read and written as boxes of 128 bytes of
// a row (64 bf16 or 128 int8 columns) x box_rows x 1 with the 128-byte
// swizzle; a box reads zeros, and writes nothing, outside the array.
inline bool encode(EncodeTiled fn, CUtensorMap* m, const void* base, long long cols,
                   long long rows, long long layers, long long row_bytes,
                   long long layer_bytes, unsigned box_rows, int elem_bytes = 2) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)layers};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)layer_bytes};
  const cuuint32_t box[3] = {128u / (unsigned)elem_bytes, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(m, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace enerf
