// One-pass LayerNorm backward for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel occm_tpu/ops/layernorm.py:46 `_bwd_kernel`.
// Per row of x [M, D] (bf16 or fp32) and its output gradient g (same dtype),
// with gamma [D] fp32:
//   mu, rstd recomputed from x in fp32 (two passes over the row in
//   registers: sum, then sum of squared deviations),
//   x_hat = (x - mu) * rstd,  gg = g * gamma,
//   dx = rstd * (gg - mean(gg) - x_hat * mean(gg * x_hat))   in x's dtype,
// and per-block partial sums of dgamma = sum g * x_hat and dbeta = sum g in
// fp32, written to [n_blocks, D] buffers that the caller sums (as the JAX
// wrapper sums its per-tile partials in XLA). No atomics, so the result is
// deterministic.
//
// Layout and grid: one block of 256 threads per kRowsPerBlock rows; each
// thread owns the columns tid, tid + 256, ... (D <= 2048) and keeps its
// gamma values and dgamma/dbeta partials in registers across the block's
// rows. The row sums are block reductions (warp shuffles, then one shared
// float per warp). Any M: the last block takes the ragged rest, so no
// padding to 512 rows as on the TPU.
//
// What bounds it on an H100: bytes. At the training shape [3588, 1024]
// bf16 it reads x and g once and writes dx once (22 MB, about 6.6 us at
// 3.35 TB/s); the partials add 225 x 1024 x 8 bytes. Loads are 2- or
// 4-byte scalar loads, coalesced across the warp; this first version is
// written to be right and simple, and its measured time is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPer = 8;  // columns per thread: D <= 2048
constexpr int kRowsPerBlock = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// sums a and b over the block; every thread gets both totals
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[kWarps]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += red[0][w];
    b += red[1][w];
  }
  __syncthreads();  // red is reused by the next call
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const T* __restrict__ g, T* __restrict__ dx,
                     float* __restrict__ dgamma_part,
                     float* __restrict__ dbeta_part, int M, int D,
                     float eps) {
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x;
  const float inv_d = 1.f / (float)D;
  float gam[kMaxPer], dga[kMaxPer], dbe[kMaxPer];
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int c = tid + i * kThreads;
    gam[i] = c < D ? gamma[c] : 0.f;
    dga[i] = 0.f;
    dbe[i] = 0.f;
  }

  const int row_end = min(M, (int)(blockIdx.x + 1) * kRowsPerBlock);
  for (int row = blockIdx.x * kRowsPerBlock; row < row_end; ++row) {
    const T* xr = x + (size_t)row * D;
    const T* gr = g + (size_t)row * D;
    float xv[kMaxPer], gv[kMaxPer];
    float sum = 0.f, unused = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int c = tid + i * kThreads;
      xv[i] = c < D ? to_f(xr[c]) : 0.f;
      gv[i] = c < D ? to_f(gr[c]) : 0.f;
      sum += xv[i];
    }
    block_sum2(sum, unused, red);
    const float mu = sum * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int c = tid + i * kThreads;
      xv[i] = c < D ? xv[i] - mu : 0.f;
      sq += xv[i] * xv[i];
    }
    unused = 0.f;
    block_sum2(sq, unused, red);
    const float rstd = rsqrtf(sq * inv_d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      xv[i] *= rstd;  // x_hat
      const float gg = gv[i] * gam[i];
      s1 += gg;
      s2 += gg * xv[i];
    }
    block_sum2(s1, s2, red);
    const float m1 = s1 * inv_d, m2 = s2 * inv_d;
    T* dr = dx + (size_t)row * D;
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int c = tid + i * kThreads;
      if (c < D) {
        dr[c] = from_f<T>(rstd * (gv[i] * gam[i] - m1 - xv[i] * m2));
        dga[i] += gv[i] * xv[i];
        dbe[i] += gv[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int c = tid + i * kThreads;
    if (c < D) {
      dgamma_part[(size_t)blockIdx.x * D + c] = dga[i];
      dbeta_part[(size_t)blockIdx.x * D + c] = dbe[i];
    }
  }
}

}  // namespace

// Number of partial rows the caller allocates for dgamma and dbeta.
extern "C" int occm_layernorm_bwd_blocks(int M) {
  return (M + kRowsPerBlock - 1) / kRowsPerBlock;
}

// x, g, dx: [M, D] of one dtype (is_bf16: bf16, else fp32); gamma [D] fp32;
// dgamma_part, dbeta_part: [occm_layernorm_bwd_blocks(M), D] fp32. Launches
// on `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int occm_layernorm_bwd(const void* x, const void* gamma,
                                  const void* g, void* dx, void* dgamma_part,
                                  void* dbeta_part, int M, int D, float eps,
                                  int is_bf16, void* stream) {
  if (M <= 0 || D <= 0 || D > kThreads * kMaxPer)
    return (int)cudaErrorInvalidValue;
  const int blocks = occm_layernorm_bwd_blocks(M);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    layernorm_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)gamma,
        (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, (float*)dgamma_part,
        (float*)dbeta_part, M, D, eps);
  } else {
    layernorm_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)gamma, (const float*)g, (float*)dx,
        (float*)dgamma_part, (float*)dbeta_part, M, D, eps);
  }
  return (int)cudaGetLastError();
}
