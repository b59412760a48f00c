// Fused transformer FFN forward for Hopper (sm_90a) in fp32:
//   y = GELU(x W1 + b1) W2 + b2
//
// Replaces, in fp32, the TPU Pallas kernel `_kernel` of occm_tpu/ops/ffn.py:50,
// which runs in fp32 whenever D % 128 == 0 and F % 512 == 0
// (ffn.py:171-174), at the fp32 D and F that ffn_fwd_3xtf32.cu (the
// tensor cores, 3xTF32: D and F multiples of 4, 1.9-2.3x faster at the
// model's shapes) does not take; ffn_fwd.cu takes bf16 only. Same arithmetic as it and
// as ffn_reference (ops/ffn.py) in fp32: x W1 + b1 with fp32 sums, GELU in
// fp32 (exact erf, or the tanh form of jax.nn.gelu and
// F.gelu(approximate="tanh")), then h W2 + b2 with fp32 sums. True fp32:
// every product is an FFMA on the CUDA cores (no TF32).
//
// Two launches of one GEMM with a fused epilogue, ordered by the stream, as
// the bf16 kernel does: fc1 + GELU into an fp32 [M, F] scratch that the
// wrapper allocates (39 MB at M 2392, F 4096: most of it stays in the 50 MB
// L2 for fc2), then fc2 + b2:
//   C[M, N] = act(A[M, K] B[N, K]^T + bias[N]),
// with A = x or h, and B = fc1.weight [F, D] or fc2.weight [D, F] as
// nn.Linear stores them (both K-major, so neither is transposed in memory).
//
// Design: a tiled SIMT sgemm. One block of 256 threads computes a 128 x 128
// tile of C over the whole K in steps of 8: each step's 128 x 8 slices of A
// and B are loaded from device memory into registers (one float4 a thread
// each when K % 4 == 0 and the rows are 16-byte aligned, else four masked
// element loads), stored transposed into a second shared-memory buffer
// while the first is read, and each thread accumulates an 8 x 8 sub-tile
// (rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, columns likewise with tx) in
// fp32 registers from float4 shared loads: 64 FFMAs to 4 loads. Rows and
// columns past M and N, and K past its end, are masked (zero-filled on
// load, not stored). Any M >= 1, N >= 1, K >= 1.
//
// What bounds it on an H100: operations. At M = 2392, D = 1024, F = 4096,
// fc1 + fc2 are 4 M D F = 4.013e10 flops: 0.60 ms at the fp32 peak of
// 67 TFLOP/s, against 0.015 ms for the 50 MB of x, W1, W2, the biases and y
// at 3.35 TB/s.
// What its simple design leaves on the table: the tensor cores (taken by
// ffn_fwd_3xtf32.cu wherever TMA can read the rows); fc2's grid at
// D = 1024 (152 blocks of 128 x 128 for 132 SMs, two blocks an SM: a
// partial wave); warp-tiled register blocking and deeper
// pipelines of a tuned sgemm; the h round trip through L2. The measured
// times are in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // rows of C a block
constexpr int kBN = 128;  // columns of C a block
constexpr int kBK = 8;    // K a step
constexpr int kThreads = 256;
constexpr int kPad = 4;   // shared row padding (floats)
constexpr int kActNone = 0, kActGeluErf = 1, kActGeluTanh = 2;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActGeluTanh)
    return 0.5f * v *
           (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  if (act == kActGeluErf)
    return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  return v;
}

// 4 consecutive K of row `row` (< rows) of a [rows, K] matrix from k,
// zero past the matrix
template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ m, int rows,
                                      int K, int row, int k, float (&r)[4]) {
  if (kVec) {  // K % 4 == 0 and m 16-byte aligned: a float4 or nothing
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows && k < K)
      v = *reinterpret_cast<const float4*>(m + (size_t)row * K + k);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e] = (row < rows && k + e < K) ? m[(size_t)row * K + k + e] : 0.f;
  }
}

// C[M, N] = act(A[M, K] B[N, K]^T + bias[N]); grid (ceil(N / 128),
// ceil(M / 128))
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
ffn_gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ bias, float* __restrict__ C,
                    int M, int N, int K, int act) {
  __shared__ __align__(16) float sa[2][kBK][kBM + kPad];
  __shared__ __align__(16) float sb[2][kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // loads: thread -> row tid / 2 of the tile, K quarter (tid % 2) * 4
  const int lrow = tid >> 1, lk = (tid & 1) * 4;
  // products: rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j and
  // 64 + 4 tx + j
  const int tx = tid % 16, ty = tid / 16;

  float ra[4], rb[4];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_steps = (K + kBK - 1) / kBK;
  load4<kVec>(A, M, K, m0 + lrow, lk, ra);
  load4<kVec>(B, N, K, n0 + lrow, lk, rb);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sa[0][lk + e][lrow] = ra[e];
    sb[0][lk + e][lrow] = rb[e];
  }
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < n_steps;
    if (more) {  // the next step's slices, in flight during the products
      load4<kVec>(A, M, K, m0 + lrow, (s + 1) * kBK + lk, ra);
      load4<kVec>(B, N, K, n0 + lrow, (s + 1) * kBK + lk, rb);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[cur][k][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sa[cur][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[cur][k][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sb[cur][k][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      // the other buffer was last read before the previous barrier
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sa[cur ^ 1][lk + e][lrow] = ra[e];
        sb[cur ^ 1][lk + e][lrow] = rb[e];
      }
    }
    __syncthreads();
  }

  // epilogue: + bias and the activation in fp32, rows < M, columns < N
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
    float* row = C + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n < N) row[n] = activate(acc[i][j] + bias[n], act);
    }
  }
}

}  // namespace

// One product of the FFN in fp32: c[m, n] = act(a[m, k] b[n, k]^T + bias[n]),
// act 0 (none), 1 (erf GELU) or 2 (tanh GELU); a, b, c row-major and
// contiguous, bias [n], all fp32; any m, n, k >= 1. One launch on `stream`.
// Returns 0 or a cudaError_t.
extern "C" int occm_ffn_gemm_f32(const void* a, const void* b,
                                 const void* bias, void* c, int m, int n,
                                 int k, int act, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || act < kActNone || act > kActGeluTanh ||
      m > 65535 * kBM)
    return (int)cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (vec)
    ffn_gemm_f32_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const float*)bias, (float*)c, m, n,
        k, act);
  else
    ffn_gemm_f32_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const float*)bias, (float*)c, m, n,
        k, act);
  return (int)cudaGetLastError();
}
