// Fused transformer FFN forward for Hopper (sm_90a), bf16 in and out:
//   y = GELU(x W1 + b1) W2 + b2
//
// Replaces the TPU Pallas kernel `_kernel` of occm_tpu/ops/ffn.py:50. Same
// arithmetic as it and as `_xla_ffn` (ffn.py:59-67, :100-105):
//   1. h = x W1 accumulated in fp32 on the tensor cores,
//   2. + b1 in fp32,
//   3. GELU in fp32, exact erf or the tanh form (jax.nn.gelu's formula, also
//      F.gelu(approximate="tanh")), chosen per call,
//   4. h rounded to bf16 once,
//   5. h W2 accumulated in fp32,
//   6. + b2 in fp32,
//   7. one rounding to bf16 for the output.
//
// What bounds it on an H100: operations. At M = 2392, D = 1024, F = 4096 the
// function is 4 M D F = 4.013e10 flops against 2.66e7 bytes of x, the two
// weights, the biases and y: 0.0406 ms at 989 TFLOP/s against 0.0079 ms at
// 3.35 TB/s. Only wgmma fed by TMA reaches the tensor cores' peak, and only
// a design that does each product once stays near the bound.
//
// Design: two launches of one warp-specialised GEMM with a fused epilogue,
// ordered by the stream, doing exactly the function's 4 M D F flops:
//   fc1: H[M, F] = bf16(GELU(x fc1.weight^T + b1))   (tiles 128 x 256)
//   fc2: y[M, D] = bf16(H fc2.weight^T + b2)          (tiles 128 x 256)
// The TPU kernel keeps the [512, F] hidden tile and a [512, D] fp32
// accumulator in VMEM (megabytes per core). A Hopper SM has 227 KB of shared
// memory, and one [64, 1024] fp32 accumulator alone is 256 KB, so H goes
// through a device-memory scratch that the wrapper allocates: 19.6 MB at
// M = 2392 and 39.3 MB at M = 4792, against 50 MB of L2, so fc2 reads H
// back from L2. The first version of this kernel kept h on chip by
// recomputing fc1 once per 256-column slice of the output: 2.5x the flops.
// "Split-F" (each block owns an F chunk, a second pass sums fp32 partials)
// was not taken: a block's [64, D] fp32 partial is 256 KB at D = 1024, so it
// would still split D and recompute, and S partials of M x D fp32 cost
// S * 9.8 MB each way at M = 2392 (78 MB at S = 8, ~47 us at 3.35 TB/s),
// more than the whole function's 40.6 us compute bound.
//
// One block computes one 128 x 256 output tile over the whole K (tiles of
// 128 x 128 were measured slower for both products, PERF.md):
//   - warpgroup 2 (setmaxnreg 40): one thread issues TMA loads of 128 x 64 A
//     and 256 x 64 B tiles, 128-byte swizzle, into a ring of 4 stages of
//     48 KB with full/empty mbarriers;
//   - warpgroups 0 and 1 (setmaxnreg 232): 64 rows each, two wgmma
//     m64n128k16 per k-step, fp32 accumulators in registers; a stage
//     is released as soon as the next stage's products are issued
//     (wgmma.wait_group 1);
//   - epilogue: + bias, GELU in fp32 for fc1, one bf16 rounding, staged into
//     the (now idle) ring in TMA's 128-byte-swizzled layout and written by
//     TMA stores of 64 x 64 boxes.
// Operands need no copy: x [M, D] and H [M, F] are K-major A operands, and
// fc1.weight [F, D] and fc2.weight [D, F], as nn.Linear stores them, are
// K-major B operands. TMA zero-fills the ragged last M tile (and any K or N
// past the tensor) on load and clips it on store, so no row masks remain.
// The only shape rules are TMA's: 16-byte row strides (D and F multiples of
// 8) and 16-byte aligned base addresses. The descriptors of x, H and y
// change with every call and are encoded on the host per call through
// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint (no link
// against libcuda). Tried and not kept (PERF.md): two-CTA clusters sharing
// the B tile by TMA multicast (slower in both products), and one
// persistent launch for both products with per-row-block counters (about
// twice as slow at 128 x 256 tiles). Measured times are in PERF.md.

#include <stdint.h>

#include <initializer_list>

#include "sm90.cuh"

namespace {

constexpr int kBM = 128;       // rows of a tile: two consumer warpgroups
constexpr int kBK = 64;         // depth of a stage: one 128-byte swizzle row
constexpr int kThreads = 384;   // warpgroups 0, 1 consume, 2 produces
constexpr int kStageBytesA = kBM * kBK * 2;
constexpr int kBN = 256;        // columns of a tile: two wgmma n128 products
constexpr int kBoxC = 64;       // the epilogue's TMA store box, 64 x 64
constexpr int kStages = 4;
constexpr int kStageBytes = kStageBytesA + kBN * kBK * 2;
// + 1 KB to align the ring to the 128-byte swizzle's 1024-byte period
constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
static_assert(2 * 64 * kBN * 2 <= kStages * kStageBytes,
              "the epilogue's staging must fit in the ring");

enum { kActNone = 0, kActGeluErf = 1, kActGeluTanh = 2 };

// d[64 x 128] (fp32, this warpgroup's fragment) += A[64 x 16] B[128 x 16]^T
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));  // scale-d = 1: d += a b
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActGeluTanh)
    return 0.5f * v *
           (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  if (act == kActGeluErf) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  return v;
}

// C[M, N] = act(A[M, K] B[N, K]^T + bias[N]) in bf16, one 128 x 256 tile
// per block; grid (ceil(N / 256), ceil(M / 128)).
__global__ void __launch_bounds__(kThreads, 1)
ffn_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,  // box 64 x 128
                const __grid_constant__ CUtensorMap tma_b,  // box 64 x 256
                const __grid_constant__ CUtensorMap tma_c,  // box 64 x 64
                const __nv_bfloat16* __restrict__ bias, int M, int N, int K,
                int act) {
  constexpr int kSub = kBN / 128;  // wgmma n128 products per k-step
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages;
        mbar_wait(&empty[s], ((kb / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(st, &tma_a, &full[s], kb * kBK, m0);
        tma_load_2d(st + kStageBytesA, &tma_b, &full[s], kb * kBK, n0);
      }
    }
  } else {
    // ---- consumers: 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[kSub][64];
#pragma unroll
    for (int j = 0; j < kSub; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;

    const int lane = threadIdx.x % 32;
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % kStages;
      mbar_wait(&full[s], (kb / kStages) & 1);
      const uint32_t a = smem_u32(smem + s * kStageBytes) + wg * 64 * 128;
      const uint32_t b = smem_u32(smem + s * kStageBytes + kStageBytesA);
#pragma unroll
      for (int j = 0; j < kSub; ++j) fence_acc(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // +32 bytes along K inside the swizzled 128-byte row: +2 in the
        // descriptor's 16-byte address units
        const uint64_t da = smem_desc(a) + 2 * kk;
#pragma unroll
        for (int j = 0; j < kSub; ++j)
          wgmma_m64n128k16(acc[j], da, smem_desc(b + j * 128 * 128) + 2 * kk);
      }
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < kSub; ++j) fence_acc(acc[j]);
      if (kb > 0) {  // the previous stage's products are done: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(kb - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kSub; ++j) fence_acc(acc[j]);
    // both warpgroups are done reading the ring before either overwrites it
    named_bar_sync(1, 256);

    // ---- epilogue: + bias, activation, bf16, staged as 64 x 64 boxes in
    // the 128-byte swizzle the output's TMA descriptor uses
    const int warp = (threadIdx.x % 128) / 32;
    unsigned char* cbase = smem + wg * (kBN / kBoxC) * (kBoxC * 128);
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        // wgmma's accumulator fragment: 8-column groups of 4 registers,
        // (row, col), (row, col + 1), (row + 8, col), (row + 8, col + 1)
        const int col = j * 128 + (i / 4) * 8 + (lane % 4) * 2;
        const int row = warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
        const int n = n0 + col;  // N % 8 == 0: n < N covers n + 1
        float b0 = 0.f, b1 = 0.f;
        if (n < N) {
          b0 = __bfloat162float(bias[n]);
          b1 = __bfloat162float(bias[n + 1]);
        }
        const uint32_t v = pack_bf16(activate(acc[j][i] + b0, act),
                                     activate(acc[j][i + 1] + b1, act));
        const int box = col / kBoxC, cc = col % kBoxC;
        *reinterpret_cast<uint32_t*>(
            cbase + box * (kBoxC * 128) + row * 128 +
            ((((cc >> 3) ^ (row & 7))) << 4) + (cc & 7) * 2) = v;
      }
    }
    // generic-proxy writes, then TMA (async proxy) reads them
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
    if (threadIdx.x % 128 == 0 && m0 + wg * 64 < M) {
      for (int box = 0; box < kBN / kBoxC; ++box)
        if (n0 + box * kBoxC < N)
          tma_store_2d(&tma_c, cbase + box * (kBoxC * 128), n0 + box * kBoxC,
                    m0 + wg * 64);
      tma_store_flush();
    }
  }
}

// A row-major bf16 [rows, cols] tensor read or written in boxes of
// box_rows x 64 columns (128 bytes), 128-byte swizzle; 0 on success.
int encode(CUtensorMap* map, const void* ptr, int rows, int cols,
           int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  return encode_bf16(map, ptr, 2, dims, strides, box);
}

}  // namespace

// One product of the FFN: c[m, n] = act(a[m, k] b[n, k]^T + bias[n]) in
// bf16, act 0 (none), 1 (erf GELU) or 2 (tanh GELU); a, b, c row-major,
// bias [n], all bf16, contiguous and 16-byte aligned; n and k multiples of
// 8. One launch on `stream`. Returns 0, a cudaError_t, or
// -1 / -1000 - CUresult when a TMA descriptor cannot be made.
extern "C" int occm_ffn_gemm(const void* a, const void* b, const void* bias,
                             void* c, int m, int n, int k, int act,
                             void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 8 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {a, b, bias, (const void*)c})
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb, mc;
  int err = encode(&ma, a, m, k, kBM);
  if (!err) err = encode(&mb, b, n, k, kBN);
  if (!err) err = encode(&mc, c, m, n, kBoxC);
  if (err) return err;
  // once per process (a thread-safe static), so that a launch captured
  // into a CUDA graph makes no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      ffn_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  ffn_gemm_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      ma, mb, mc, (const __nv_bfloat16*)bias, m, n, k, act);
  return (int)cudaGetLastError();
}
