// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels
// (ffn_fwd.cu, ffn_fwd_3xtf32.cu, the attention kernels): shared-memory addresses, mbarriers, TMA
// loads and stores, wgmma shared-memory descriptors and fences, and
// cuTensorMapEncodeTiled fetched through cudaGetDriverEntryPoint (so the
// library does not link -lcuda). Everything has internal linkage:
// each source that includes this header gets its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits for the phase of `bar` with this parity to complete. A wait of more
// than ~10 s (2^34 cycles) is a fault of the pipeline: it traps, so that the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1LL << 34))
      __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Commits this thread's TMA stores issued since its last commit as one
// bulk group, without waiting.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Commits this thread's TMA stores and waits until they are done.
__device__ __forceinline__ void tma_store_flush() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory writes before TMA (the
// async proxy) reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a tile in TMA's 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), layout B128. The same
// descriptor serves a K-major operand (a row holds 64 values along K; a
// k16 step adds 32 bytes, +2 in the descriptor's 16-byte units) and an
// MN-major one of 64 columns (a row holds 64 values along M or N; a k16
// step is 16 rows, +2048 bytes). LBO (16-byte units) is unused by both; an
// MN-major operand wider than 64 columns, stored as 64-column panels,
// gives the panel stride there.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
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

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma's issue and wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two floats -> two bf16 in one register, `lo` in the low half (lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or nullptr.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor of `type` and `rank` dimensions (innermost first, `dims`; byte
// strides of dimensions 1.. in `strides`) read or written in boxes of
// `box`, with the 128-byte swizzle and zero fill past its edges; 0 on
// success, -1 when libcuda has no encoder, -1000 - CUresult when it refuses
// the map.
int encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               int rank, const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -1;
  // cuTensorMapEncodeTiled needs a context current on the calling thread.
  // A thread that has made no runtime call yet has none (PyTorch's autograd
  // device thread, when a backward starts at a kernel's node, got
  // CUDA_ERROR_INVALID_CONTEXT for the map): cudaFree(nullptr) makes the
  // current device's primary context current first, once per thread.
  static thread_local bool bound = false;
  if (!bound) {
    cudaFree(nullptr);
    bound = true;
  }
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(ptr), dims,
                        strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

// encode_map of a bf16 tensor
int encode_bf16(CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims,
                    strides, box);
}

}  // namespace
