// Single-pass Adam over one fp32 parameter leaf, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel occm_tpu/ops/fused_adam.py:58 `_kernel`.
// Per element, the formula of `_adam_math` (fused_adam.py:40-46):
//   m <- b1 * m + (1 - b1) * g
//   v <- b2 * v + (1 - b2) * g * g
//   p <- p - (lr * m * inv_bc1) / (sqrt(v * inv_bc2) + eps)
// with the bias corrections inv_bc1 = 1 / (1 - b1^t), inv_bc2 = 1 / (1 - b2^t)
// computed on the host, as the JAX wrapper computes them outside its
// kernel. Unlike the functional JAX kernel, this one updates p, m and v in
// place: each element is read once and written once.
//
// Layout and grid: a grid-stride loop over the n elements of the leaf, 256
// threads a block; any n, so no leaf needs the JAX version's fallback for
// sizes that are not lane-aligned. IEEE division and square root (no fast
// math), so the update rounds as the plain version does. One launch per
// leaf; a multi-tensor launch over all leaves is later work.
//
// What bounds it on an H100: bytes. It reads p, m, v, g and writes p, m, v:
// 28 bytes per parameter, 8.84 GB over the 315,884,938 parameters of the
// full AModel, about 2.64 ms at 3.35 TB/s. Its measured time is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float* __restrict__ p, float* __restrict__ m,
                  float* __restrict__ v, const float* __restrict__ g,
                  int64_t n, float lr, float b1, float one_minus_b1, float b2,
                  float one_minus_b2, float eps, float inv_bc1,
                  float inv_bc2) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = g[i];
    const float mi = b1 * m[i] + one_minus_b1 * gi;
    const float vi = b2 * v[i] + one_minus_b2 * gi * gi;
    const float mhat = mi * inv_bc1;
    const float vhat = vi * inv_bc2;
    p[i] = p[i] - (lr * mhat) / (sqrtf(vhat) + eps);
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

// Updates p, m, v ([n] fp32 each) in place from g; launches on `stream` and
// returns the cudaError_t of the launch (0 on success).
extern "C" int occm_fused_adam(void* p, void* m, void* v, const void* g,
                               int64_t n, float lr, float b1,
                               float one_minus_b1, float b2,
                               float one_minus_b2, float eps, float inv_bc1,
                               float inv_bc2, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then stride
  fused_adam_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)p, (float*)m, (float*)v, (const float*)g, n, lr, b1,
      one_minus_b1, b2, one_minus_b2, eps, inv_bc1, inv_bc2);
  return (int)cudaGetLastError();
}
