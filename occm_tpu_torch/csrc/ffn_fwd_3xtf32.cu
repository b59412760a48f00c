// Fused transformer FFN forward for Hopper (sm_90a) in fp32 on the tensor
// cores, 3xTF32:
//   y = GELU(x W1 + b1) W2 + b2
//
// Replaces, in fp32, the TPU Pallas kernel `_kernel` of occm_tpu/ops/ffn.py:50
// (which runs in fp32 whenever D % 128 == 0 and F % 512 == 0,
// ffn.py:171-174), wherever D and F are multiples of 4; ffn_fwd_f32.cu (a
// SIMT sgemm) keeps every other fp32 shape, and ffn_fwd.cu bf16.
// Same arithmetic as ffn_reference (ops/ffn.py) in fp32: x W1 + b1 with
// fp32 sums, GELU in fp32 (exact erf, or the tanh form of jax.nn.gelu and
// F.gelu(approximate="tanh")), then h W2 + b2 with fp32 sums. Each product
// is three TF32 products (tf32.cuh: a_lo b_hi + a_hi b_lo + a_hi b_hi); the
// split's own error is below 2^-20 of each product. The tensor cores'
// accumulation drifts over a long sum: with one accumulator over the whole
// K, y came within 3.5e-5 - 4.7e-5 of the largest |y| of the plain version
// on an H100 at K 1000 - 4096. So each run of kFlush stages (K 256) sums
// in an accumulator of its own, added to the tile's in fp32: 4.3e-6 -
// 5.2e-6 (the SIMT kernel: 3e-6; chip_smoke.py's FFN_F32_RTOL_OF_MAX:
// 1e-4; one TF32 product alone: ~1e-3).
//
// Two launches of one GEMM with a fused epilogue, ordered by the stream, as
// ffn_fwd.cu does: fc1 + b1 + GELU into an fp32 [M, F] scratch that the
// wrapper allocates (39 MB at M 2392, F 4096: most of it stays in the 50 MB
// L2 for fc2), then fc2 + b2:
//   C[M, N] = act(A[M, K] B[N, K]^T + bias[N]),
// with A = x or h, and B = fc1.weight [F, D] or fc2.weight [D, F] as
// nn.Linear stores them. Both are K-major, which is the only major wgmma
// takes for TF32 (its transpose bits exist for 16-bit types alone), so
// neither is transposed.
//
// What bounds it on an H100: operations. At M = 2392, D = 1024, F = 4096
// the function is 4 M D F = 4.013e10 flops, which 3xTF32 issues three
// times: 0.243 ms at TF32's 495 TFLOP/s, against 0.016 ms for the 53 MB of
// x, W1, W2, the biases and y at 3.35 TB/s (and 0.60 ms at the 67 TFLOP/s
// of fp32 on the CUDA cores, the SIMT kernel's bound).
//
// Design: ffn_fwd.cu's kernel in fp32. One block of 384 threads computes a
// 128 x BN tile of C over the whole K in steps of 32 (one 128-byte swizzle
// row of fp32):
//   - warpgroup 2 (setmaxnreg 40): warp 0's lane 0 issues TMA loads of the
//     128 x 32 A and BN x 32 B tiles, 128-byte swizzle, into a ring of 3
//     stages (BN 128) or 2 (BN 192) with full/empty mbarriers; TMA
//     zero-fills the ragged M, N and K edges. Its warps 1-3 make the
//     split in shared memory as each stage lands: they read each float4
//     of the A and B tiles (16 + BN / 8 KB), write its hi back in place
//     and its lo to the stage's lo tiles, of the same swizzled layout (so
//     the split needs no index arithmetic), then a proxy fence and a
//     `ready` mbarrier. That is one read and two writes of the tiles in
//     shared memory per stage, 48 + 3 BN / 8 KB, under the previous
//     stage's products; no pass over the weights in device memory.
//   - warpgroups 0 and 1 (setmaxnreg 232), 64 rows each: per k8 step
//     three wgmma m64nBNk8 (a_lo b_hi, a_hi b_lo, a_hi b_hi), both
//     operands from shared memory through the descriptors of sm90.cuh (a
//     k8 step of TF32 is 32 bytes, +2 in the descriptor, as a bf16 k16
//     step) into the run's accumulator, BN / 2 fp32 registers a thread
//     beside the tile's BN / 2. The previous stage is released once this
//     stage's products are issued (wgmma.wait_group 1), so the next
//     stage's load and split run under them; after kFlush stages the
//     products are waited for and the run's sum added.
//   - epilogue: + bias, GELU in fp32 for fc1, stored from the accumulator
//     fragment as float2 (rows past M and columns past N masked).
// Shared memory: a stage is A, B, A lo, B lo: 2 (16 + BN / 8) KB, 64 KB at
// BN 128 and 80 KB at 192; three or two stages, + 1 KB of alignment:
// 193 / 161 KB, one block an SM. Registers (ptxas, sm_90a): 168 at launch
// at both widths, no spills (the consumers' two accumulators, 2 x 96 a
// thread at BN 192, fit the 232 of setmaxnreg; at BN 256 they would not,
// which is why the tiles stop at 192).
// Tile width: fc2 at D 1024 and M 2392 is 19 x 4 = 76 tiles of 128 x 256
// for 132 SMs, or 152 of 128 x 128: a partial wave either way. The host
// picks BN from {192, 128} per launch: the one with the least
// ceil(tiles / SMs) * BN, ties to 192 (fc2 at M 2392: 114 tiles of 192 in
// one wave; fc1 there 608 of 128 in 5 waves against 418 of 192 in 4).
// What the design leaves for later: a deeper ring at BN 192 (the split's
// lo tiles take half of shared memory); A from registers (split there,
// half the lo tiles and the A reads of two of the three products); a
// persistent grid; the h round trip through L2. Measured times are in
// PERF.md.

#include <stdint.h>

#include <initializer_list>

#include "sm90.cuh"
#include "tf32.cuh"

namespace {

constexpr int kBM = 128;       // rows of a tile: two consumer warpgroups
constexpr int kBK = 32;        // K of a stage: one 128-byte swizzle row
constexpr int kThreads = 384;  // warpgroups 0, 1 consume, 2 produces
constexpr int kTileBytesA = kBM * kBK * 4;  // 16 KB
// stages summed in one accumulator before it is added to the tile's in
// fp32 (K = 256)
constexpr int kFlush = 8;
// threads of warpgroup 2 that split the stages: its warps 1-3 (warp 0's
// lane 0 issues the TMA loads)
constexpr int kSplitters = 96;

enum { kActNone = 0, kActGeluErf = 1, kActGeluTanh = 2 };

template <int BN>
struct Geometry {
  static constexpr int kTileBytesB = BN * kBK * 4;
  static constexpr int kLoadBytes = kTileBytesA + kTileBytesB;  // TMA tx
  // A, B, then their lo tiles
  static constexpr int kStageBytes = 2 * kLoadBytes;
  // as many as fit: 3 of 64 KB at BN 128, 2 of 80 KB at 192
  static constexpr int kStages = BN <= 128 ? 3 : 2;
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 3 * kStages * 8;
};

// d[64 x N] (fp32, this warpgroup's fragment) += A[64 x 8] B[N x 8]^T, TF32,
// both operands K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da,
                                           uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
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

template <>
__device__ __forceinline__ void wgmma_tf32<192>(float (&d)[96], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, %96, %97, p, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));  // scale-d = 1: d += a b
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActGeluTanh)
    return 0.5f * v *
           (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  if (act == kActGeluErf) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  return v;
}

// n float4 of `raw` become their TF32 hi, and `lo` at the same index their
// lo; thread tid of `threads` takes every threads-th
__device__ __forceinline__ void split_tile(float4* raw, float4* lo, int n,
                                           int tid, int threads) {
  for (int i = tid; i < n; i += threads) {
    const float4 v = raw[i];
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    raw[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                         __uint_as_float(h[2]), __uint_as_float(h[3]));
    lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// C[M, N] = act(A[M, K] B[N, K]^T + bias[N]) in fp32, one 128 x BN tile per
// block; grid (ceil(N / BN), ceil(M / 128)).
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
ffn_gemm_3xtf32_kernel(const __grid_constant__ CUtensorMap tma_a,  // 32 x 128
                       const __grid_constant__ CUtensorMap tma_b,  // 32 x BN
                       const float* __restrict__ bias, float* __restrict__ c,
                       int M, int N, int K, int act) {
  using G = Geometry<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int kStages = G::kStages;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kStages * G::kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* ready = empty + kStages;  // a stage split, for the consumers

  const int wg = threadIdx.x / 128;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
      mbar_init(&ready[s], kSplitters);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      // ---- producer: one thread keeps the ring full
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages;
        mbar_wait(&empty[s], ((kb / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * G::kStageBytes;
        mbar_expect_tx(&full[s], G::kLoadBytes);
        tma_load_2d(st, &tma_a, &full[s], kb * kBK, m0);
        tma_load_2d(st + kTileBytesA, &tma_b, &full[s], kb * kBK, n0);
      }
    } else if (threadIdx.x >= 384 - kSplitters) {
      // ---- splitters: each stage as it lands, hi in place and lo beside
      // (A and B are one run of float4s, and so are their lo tiles), while
      // the consumers run the previous stage's products
      const int tid = threadIdx.x - (384 - kSplitters);
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages;
        mbar_wait(&full[s], (kb / kStages) & 1);
        unsigned char* st = smem + s * G::kStageBytes;
        split_tile(reinterpret_cast<float4*>(st),
                   reinterpret_cast<float4*>(st + G::kLoadBytes),
                   G::kLoadBytes / 16, tid, kSplitters);
        // generic-proxy writes, then wgmma (async proxy) reads them
        fence_proxy_async();
        mbar_arrive(&ready[s]);
      }
    }
    return;
  }

  // ---- consumers: 64 rows each; the products of kFlush stages go to
  // `part`, which is then added to `acc` in fp32 (the tensor cores'
  // accumulation drifts over a long sum: tf32.cuh)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;

  const int lane = threadIdx.x % 32;
  for (int k0 = 0; k0 < nk; k0 += kFlush) {
    const int k1 = k0 + kFlush < nk ? k0 + kFlush : nk;
    for (int kb = k0; kb < k1; ++kb) {
      const int s = kb % kStages;
      mbar_wait(&ready[s], (kb / kStages) & 1);
      unsigned char* st = smem + s * G::kStageBytes;
      const uint32_t a = smem_u32(st) + wg * 64 * 128;
      const uint32_t b = smem_u32(st + kTileBytesA);
      const uint32_t a_lo = a + G::kLoadBytes;
      const uint32_t b_lo = b + G::kLoadBytes;
      fence_acc(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        // +32 bytes along K inside the swizzled 128-byte row: +2 in the
        // descriptor's 16-byte address units
        const uint64_t dah = smem_desc(a) + 2 * kk;
        const uint64_t dbh = smem_desc(b) + 2 * kk;
        wgmma_tf32<BN>(part, smem_desc(a_lo) + 2 * kk, dbh);
        wgmma_tf32<BN>(part, dah, smem_desc(b_lo) + 2 * kk);
        wgmma_tf32<BN>(part, dah, dbh);
      }
      wgmma_commit();
      fence_acc(part);
      if (kb > 0) {  // the previous stage's products are done: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(kb - 1) % kStages]);
      }
    }
    // the run's sum, added to the tile's in fp32
    wgmma_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i], part[i] = 0.f;
  }

  // ---- epilogue: + bias, activation, stored from the fragment: register
  // i holds row warp * 16 + lane / 4 + 8 ((i / 2) % 2), column
  // (i / 4) * 8 + (lane % 4) * 2 + i % 2
  const int warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int m = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int n = n0 + (i / 4) * 8 + (lane % 4) * 2;  // N % 4 == 0
    if (m < M && n < N) {
      const float2 v = make_float2(activate(acc[i] + bias[n], act),
                                   activate(acc[i + 1] + bias[n + 1], act));
      *reinterpret_cast<float2*>(c + (size_t)m * N + n) = v;
    }
  }
}

// A row-major fp32 [rows, cols] tensor read in boxes of box_rows x 32
// columns (128 bytes), 128-byte swizzle; 0 on success.
int encode(CUtensorMap* map, const void* ptr, int rows, int cols,
           int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 2, dims,
                    strides, box);
}

template <int BN>
int launch(const void* a, const void* b, const void* bias, void* c, int m,
           int n, int k, int act, cudaStream_t stream) {
  using G = Geometry<BN>;
  CUtensorMap ma, mb;
  int err = encode(&ma, a, m, k, kBM);
  if (!err) err = encode(&mb, b, n, k, BN);
  if (err) return err;
  // once per process and instance (a thread-safe static), so that a launch
  // captured into a CUDA graph makes no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      ffn_gemm_3xtf32_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + BN - 1) / BN, (m + kBM - 1) / kBM);
  ffn_gemm_3xtf32_kernel<BN><<<grid, kThreads, G::kSmem, stream>>>(
      ma, mb, (const float*)bias, (float*)c, m, n, k, act);
  return (int)cudaGetLastError();
}

// SMs of the current device (0 if it cannot be read)
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

// The tile width occm_ffn_gemm_3xtf32 takes for [m, n] outputs on `sms`
// SMs: 192 or 128, whichever has the fewer tile-columns of waves
// (ceil(tiles / sms) * width), ties to 192.
extern "C" int occm_ffn_gemm_3xtf32_tile_n(int m, int n, int sms) {
  if (sms <= 0) return 192;
  const long long rows = (m + kBM - 1) / kBM;
  long long best_cost = -1;
  int best = 192;
  for (int bn : {192, 128}) {
    const long long tiles = rows * ((n + bn - 1) / bn);
    const long long cost = (tiles + sms - 1) / sms * bn;
    if (best_cost < 0 || cost < best_cost) best_cost = cost, best = bn;
  }
  return best;
}

// One product of the FFN in fp32 on the tensor cores (3xTF32):
// c[m, n] = act(a[m, k] b[n, k]^T + bias[n]), act 0 (none), 1 (erf GELU) or
// 2 (tanh GELU); a, b, c row-major and contiguous, bias [n], all fp32; a
// and b 16-byte aligned, c 8-byte aligned; n and k multiples of 4 (TMA's
// 16-byte row strides), any m >= 1. One launch on `stream`. Returns 0, a
// cudaError_t, or -1 / -1000 - CUresult when a TMA descriptor cannot be
// made.
extern "C" int occm_ffn_gemm_3xtf32(const void* a, const void* b,
                                    const void* bias, void* c, int m, int n,
                                    int k, int act, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 4 || k % 4 || act < kActNone ||
      act > kActGeluTanh || m > 65535 * kBM ||
      (reinterpret_cast<uintptr_t>(a) & 15) ||
      (reinterpret_cast<uintptr_t>(b) & 15) ||
      (reinterpret_cast<uintptr_t>(c) & 7))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (occm_ffn_gemm_3xtf32_tile_n(m, n, sm_count()) == 128)
    return launch<128>(a, b, bias, c, m, n, k, act, s);
  return launch<192>(a, b, bias, c, m, n, k, act, s);
}
