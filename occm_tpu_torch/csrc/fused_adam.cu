// Single-pass Adam over many fp32 parameter leaves in one launch, for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel occm_tpu/ops/fused_adam.py:58 `_kernel`.
// Per element, the formula of `_adam_math` (fused_adam.py:40-46):
//   m <- b1 * m + (1 - b1) * g
//   v <- b2 * v + (1 - b2) * g * g
//   p <- p - (lr * m * inv_bc1) / (sqrt(v * inv_bc2) + eps)
// with the bias corrections inv_bc1 = 1 / (1 - b1^t), inv_bc2 = 1 / (1 - b2^t)
// computed on the host, as the JAX wrapper computes them outside its
// kernel. Unlike the functional JAX kernel, this one updates p, m and v in
// place: each element is read once and written once. IEEE division and
// square root (no fast math), so the update rounds as the plain version
// does.
//
// What bounds it on an H100: bytes. It reads p, m, v, g and writes p, m, v:
// 28 bytes per parameter, 8.84 GB over the 315,884,938 parameters of the
// full AModel, about 2.64 ms at 3.35 TB/s. The TPU kernel runs once per leaf
// inside one compiled step; the first version of this kernel did the
// same from eager PyTorch and spent 12-16 ms a step on the host launching
// 596 kernels, each behind a ctypes call.
//
// Design: one launch for a whole parameter list. The host splits every leaf
// into chunks of `chunk` elements (a multiple of 4) and passes a table of
// leaves by value as a kernel parameter (up to kMaxLeaves leaves, 28 KB;
// CUDA 12.1 allows 32,764 bytes of parameters): the p, m, v, g pointers,
// the element count, and the prefix sum of the chunk counts. No host-to-
// device copy, so nothing can be overwritten while a copy is in flight.
// Blocks walk the chunks in a grid-stride loop and find a chunk's leaf by a
// binary search of the prefix sums. Inside a chunk, float4 loads and stores
// where the leaf's four pointers are 16-byte aligned (chunk starts keep that
// alignment), scalar ones for the rest and the tail. The full AModel (596
// leaves with a gradient) takes one launch; longer lists take one launch
// per kMaxLeaves leaves. Its measured time is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 640;

struct AdamTable {
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  const float* g[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int32_t chunk_start[kMaxLeaves + 1];  // leaf i owns [start[i], start[i+1])
  int32_t n_leaves;
  int32_t chunk;  // elements per chunk, a multiple of 4
  float lr, b1, one_minus_b1, b2, one_minus_b2, eps, inv_bc1, inv_bc2;
};
static_assert(sizeof(AdamTable) <= 32764, "kernel parameters are limited");

__device__ __forceinline__ void adam(float& p, float& m, float& v, float g,
                                     const AdamTable& t) {
  const float mi = t.b1 * m + t.one_minus_b1 * g;
  const float vi = t.b2 * v + t.one_minus_b2 * g * g;
  const float mhat = mi * t.inv_bc1;
  const float vhat = vi * t.inv_bc2;
  p = p - (t.lr * mhat) / (sqrtf(vhat) + t.eps);
  m = mi;
  v = vi;
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const __grid_constant__ AdamTable t) {
  const int total = t.chunk_start[t.n_leaves];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    int lo = 0, hi = t.n_leaves - 1;  // the last leaf whose start <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.chunk_start[mid] <= c)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int64_t start = (int64_t)(c - t.chunk_start[lo]) * t.chunk;
    const int64_t rest = t.n[lo] - start;
    const int len = rest < t.chunk ? (int)rest : t.chunk;
    float* p = t.p[lo] + start;
    float* m = t.m[lo] + start;
    float* v = t.v[lo] + start;
    const float* g = t.g[lo] + start;
    int done = 0;
    if (((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(m) |
          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g)) &
         15) == 0) {
      for (int i = threadIdx.x; i < len / 4; i += kThreads) {
        float4 p4 = reinterpret_cast<float4*>(p)[i];
        float4 m4 = reinterpret_cast<float4*>(m)[i];
        float4 v4 = reinterpret_cast<float4*>(v)[i];
        const float4 g4 = reinterpret_cast<const float4*>(g)[i];
        adam(p4.x, m4.x, v4.x, g4.x, t);
        adam(p4.y, m4.y, v4.y, g4.y, t);
        adam(p4.z, m4.z, v4.z, g4.z, t);
        adam(p4.w, m4.w, v4.w, g4.w, t);
        reinterpret_cast<float4*>(p)[i] = p4;
        reinterpret_cast<float4*>(m)[i] = m4;
        reinterpret_cast<float4*>(v)[i] = v4;
      }
      done = len / 4 * 4;
    }
    for (int i = done + threadIdx.x; i < len; i += kThreads) {
      float pi = p[i], mi = m[i], vi = v[i];
      adam(pi, mi, vi, g[i], t);
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
  }
}

}  // namespace

// One launch over `n_leaves` leaves: leaf i is p[i], m[i], v[i] (updated in
// place) and g[i], n[i] fp32 elements each, split into chunks of `chunk`
// elements, chunks chunk_start[i] .. chunk_start[i + 1] - 1 (host arrays of
// n_leaves, resp. n_leaves + 1, entries). Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
extern "C" int occm_fused_adam(int n_leaves, const uint64_t* p,
                               const uint64_t* m, const uint64_t* v,
                               const uint64_t* g, const int64_t* n,
                               const int32_t* chunk_start, int chunk,
                               float lr, float b1, float one_minus_b1,
                               float b2, float one_minus_b2, float eps,
                               float inv_bc1, float inv_bc2, void* stream) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || chunk <= 0 || chunk % 4)
    return (int)cudaErrorInvalidValue;
  AdamTable t;
  for (int i = 0; i < n_leaves; ++i) {
    if (n[i] <= 0 || chunk_start[i + 1] - chunk_start[i] !=
                         (int32_t)((n[i] + chunk - 1) / chunk))
      return (int)cudaErrorInvalidValue;
    t.p[i] = reinterpret_cast<float*>(p[i]);
    t.m[i] = reinterpret_cast<float*>(m[i]);
    t.v[i] = reinterpret_cast<float*>(v[i]);
    t.g[i] = reinterpret_cast<const float*>(g[i]);
    t.n[i] = n[i];
  }
  if (chunk_start[0] != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= n_leaves; ++i) t.chunk_start[i] = chunk_start[i];
  t.n_leaves = n_leaves;
  t.chunk = chunk;
  t.lr = lr;
  t.b1 = b1;
  t.one_minus_b1 = one_minus_b1;
  t.b2 = b2;
  t.one_minus_b2 = one_minus_b2;
  t.eps = eps;
  t.inv_bc1 = inv_bc1;
  t.inv_bc2 = inv_bc2;
  const int total = chunk_start[n_leaves];
  const int blocks = total < 132 * 8 ? total : 132 * 8;  // 8 per SM, stride
  fused_adam_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
