// Flash-attention backward for Hopper (sm_90a): two kernels, no atomics.
//
// Replaces three TPU Pallas kernels of occm_tpu/ops/attention.py:
//   _bwd_kernel          (attention.py:79)   whole-T backward, T padded <= 512
//   _blocked_dq_kernel   (attention.py:350)  dq over a kv sweep (+ _blocked_p_ds)
//   _blocked_dkv_kernel  (attention.py:373)  dk, dv over a q sweep
// One pair covers every T, fed by the lse the forward kernel
// (flash_attn_fwd.cu) writes. The arithmetic is the blocked TPU route's:
//   - the scale is folded into q in fp32, then q is cast to bf16,
//   - S = q_s k^T accumulated in fp32, keys >= t_valid get P = 0,
//   - P = exp(S - lse) in fp32,
//   - dS = P * (dO v^T - delta), delta = rowsum(dO * O) in fp32 (computed by
//     the caller, as the TPU wrapper computes it in XLA),
//   - P and dS cast to bf16 before their products, fp32 accumulation,
//   - dq = scale * dS k and dk = scale * dS^T q (the unscaled q), dv = P^T dO.
//
// Layout: q, k, v, dO, dq, dk, dv are [BH, T, D] row-major bf16 with D = 64;
// lse and delta are [BH, T] fp32.
//
// dq kernel: grid (64-row q tile, b*h), 4 warps of 16 q rows, a loop over kv
// tiles of 64 keys. q and dO fragments stay in registers; per tile S and dP
// are mma.sync m16n8k16 accumulator fragments, dS overwrites S in place and
// is re-packed in registers as the A operand of dS k (as the forward does
// with P), so K is also stored transposed in shared memory ("col" B layout).
//
// dkv kernel: grid (64-key tile, b*h), 4 warps of 16 keys, a loop over q
// tiles of 64 rows. It computes the transposed tiles S^T = K q_s^T and
// dP^T = V dO^T directly, so that P^T and dS^T are accumulator fragments
// that feed P^T dO and dS^T q as A operands; dO and the unscaled q are
// stored transposed in shared memory for those products. K and V fragments
// stay in registers. Each block owns its dk, dv rows, so no atomics: the
// result is deterministic.
//
// Ragged T: rows and keys past T are loaded as zeros, get P = 0 and are
// never stored.
//
// What bounds it on an H100: five products of 2*T*T*D flops per (b, h)
// against q, k, v, o, dO read and dq, dk, dv written once in bf16 (lse and
// delta in fp32): at the training shape B*H = 192, T = 299 that is 1.1e10
// flop and 5.9e7 bytes, bytes-bound at about 18 us; at T >= 599 it is
// operations-bound. Like the forward, this first version uses synchronous
// loads, scalar transposed stores and mma.sync, and recomputes S and dP in
// both kernels; it is written to be right and simple, and its measured
// times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kTile = 64;     // q rows or keys per tile
constexpr int kWarps = 4;     // 16 rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;  // padded smem row: 144 bytes

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments (16 rows from r0, all of D) of a [rows][kLds] smem tile
__device__ __forceinline__ void load_a(uint32_t a[kD / 16][4],
                                       __nv_bfloat16 (*s)[kLds], int r0,
                                       int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    a[kk][0] = ld32(&s[r0 + g][kk * 16 + t * 2]);
    a[kk][1] = ld32(&s[r0 + g + 8][kk * 16 + t * 2]);
    a[kk][2] = ld32(&s[r0 + g][kk * 16 + 8 + t * 2]);
    a[kk][3] = ld32(&s[r0 + g + 8][kk * 16 + 8 + t * 2]);
  }
}

// c[nt] (16 x 8 per nt) = A (16 x D, registers) . B^T with B [64][kLds] in
// smem (row n of B is column n of the product)
__device__ __forceinline__ void mma_rows(float c[kTile / 8][4],
                                         uint32_t a[kD / 16][4],
                                         __nv_bfloat16 (*b)[kLds], int g,
                                         int t) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      mma_16816(c[nt], a[kk], ld32(&b[nt * 8 + g][kk * 16 + t * 2]),
                ld32(&b[nt * 8 + g][kk * 16 + 8 + t * 2]));
  }
}

// acc[dn] (16 x 8 per dn, D columns) += bf16(x) (16 x 64, accumulator
// fragments re-packed as A) . bt^T with bt [D][kLds] in smem (bt[d][j])
__device__ __forceinline__ void mma_acc(float acc[kD / 8][4],
                                        float x[kTile / 8][4],
                                        __nv_bfloat16 (*bt)[kLds], int g,
                                        int t) {
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    a[1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    a[2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    a[3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
      mma_16816(acc[dn], a, ld32(&bt[dn * 8 + g][kc * 16 + t * 2]),
                ld32(&bt[dn * 8 + g][kc * 16 + 8 + t * 2]));
  }
}

// rows [r0, r0 + 64) of one (b, h) slice -> row-major smem tile (times
// `scale` in fp32 then bf16 when scale != 1) and/or transposed tile;
// rows >= T are zeros
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          int r0, int T, float scale,
                                          __nv_bfloat16 (*rows)[kLds],
                                          __nv_bfloat16 (*cols)[kLds]) {
  for (int i = threadIdx.x; i < kTile * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < T)
      raw = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * kD + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
    if (cols != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[c + j][r] = e[j];
    }
    if (rows != nullptr) {
      if (scale != 1.f) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
      *reinterpret_cast<uint4*>(&rows[r][c]) = raw;
    }
  }
}

// 16 rows x D of fp32 accumulators (times `mult`) -> bf16 rows r0.. of dst
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           float acc[kD / 8][4], int row0,
                                           int T, float mult, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + h * 8;
    if (row >= T) continue;
    __nv_bfloat16* out = dst + (size_t)row * kD;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
      *reinterpret_cast<uint32_t*>(out + dn * 8 + t * 2) =
          pack_bf16(acc[dn][2 * h] * mult, acc[dn][2 * h + 1] * mult);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int T, int t_valid,
                         float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile][kLds];   // scaled q
  __shared__ __align__(16) __nv_bfloat16 sDO[kTile][kLds];
  __shared__ __align__(16) __nv_bfloat16 sK[kTile][kLds];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 sKt[kD][kLds];     // [d][key]
  __shared__ __align__(16) __nv_bfloat16 sV[kTile][kLds];   // [key][d]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, r0 = warp * 16;
  const size_t base = (size_t)blockIdx.y * T * kD;
  const size_t rbase = (size_t)blockIdx.y * T;

  load_tile(q + base, q0, T, scale, sQ, nullptr);
  load_tile(dout + base, q0, T, 1.f, sDO, nullptr);
  __syncthreads();
  uint32_t qa[kD / 16][4], da[kD / 16][4];
  load_a(qa, sQ, r0, g, t);
  load_a(da, sDO, r0, g, t);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + h * 8;
    row_lse[h] = row < T ? lse[rbase + row] : 0.f;
    row_delta[h] = row < T ? delta[rbase + row] : 0.f;
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int n_tiles = (t_valid + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kTile;
    __syncthreads();  // previous tile consumed
    load_tile(k + base, kv0, T, 1.f, sK, sKt);
    load_tile(v + base, kv0, T, 1.f, sV, nullptr);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_rows(s, qa, sK, g, t);   // S = q_s k^T
    mma_rows(dp, da, sV, g, t);  // dP = dO v^T
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kv0 + nt * 8 + t * 2 + (j & 1);
        const float p = key < t_valid ? expf(s[nt][j] - row_lse[j >> 1]) : 0.f;
        s[nt][j] = p * (dp[nt][j] - row_delta[j >> 1]);  // dS
      }
    }
    mma_acc(acc, s, sKt, g, t);  // dq += bf16(dS) k
  }
  store_rows(dq + base, acc, q0 + r0, T, scale, g, t);
}

__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int T, int t_valid,
                          float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile][kLds];   // scaled q [row][d]
  __shared__ __align__(16) __nv_bfloat16 sQt[kD][kLds];     // unscaled q [d][row]
  __shared__ __align__(16) __nv_bfloat16 sDO[kTile][kLds];  // [row][d]
  __shared__ __align__(16) __nv_bfloat16 sDOt[kD][kLds];    // [d][row]
  __shared__ float sLse[kTile], sDelta[kTile];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile, r0 = warp * 16;
  const size_t base = (size_t)blockIdx.y * T * kD;
  const size_t rbase = (size_t)blockIdx.y * T;

  // this block's K and V rows, staged through sQ / sDO into registers
  load_tile(k + base, k0, T, 1.f, sQ, nullptr);
  load_tile(v + base, k0, T, 1.f, sDO, nullptr);
  __syncthreads();
  uint32_t ka[kD / 16][4], va[kD / 16][4];
  load_a(ka, sQ, r0, g, t);
  load_a(va, sDO, r0, g, t);
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key_ok[h] = k0 + r0 + g + h * 8 < t_valid;

  float acc_k[kD / 8][4], acc_v[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    acc_k[dn][0] = acc_k[dn][1] = acc_k[dn][2] = acc_k[dn][3] = 0.f;
    acc_v[dn][0] = acc_v[dn][1] = acc_v[dn][2] = acc_v[dn][3] = 0.f;
  }

  const int n_tiles = (T + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * kTile;
    __syncthreads();  // previous tile (or the K/V staging) consumed
    load_tile(q + base, q0, T, scale, sQ, sQt);
    load_tile(dout + base, q0, T, 1.f, sDO, sDOt);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < T ? lse[rbase + row] : 0.f;
      sDelta[threadIdx.x] = row < T ? delta[rbase + row] : 0.f;
    }
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_rows(s, ka, sQ, g, t);    // S^T = k q_s^T   [key][row]
    mma_rows(dp, va, sDO, g, t);  // dP^T = v dO^T   [key][row]
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nt * 8 + t * 2 + (j & 1);  // q row within the tile
        const float p = (key_ok[j >> 1] && q0 + c < T)
                            ? expf(s[nt][j] - sLse[c]) : 0.f;
        s[nt][j] = p;                           // P^T
        dp[nt][j] = p * (dp[nt][j] - sDelta[c]);  // dS^T
      }
    }
    mma_acc(acc_v, s, sDOt, g, t);  // dv += bf16(P^T) dO
    mma_acc(acc_k, dp, sQt, g, t);  // dk += bf16(dS^T) q
  }
  store_rows(dk + base, acc_k, k0 + r0, T, scale, g, t);
  store_rows(dv + base, acc_v, k0 + r0, T, 1.f, g, t);
}

bool bad_args(int bh, int T, int t_valid, int d) {
  return d != kD || bh <= 0 || bh > 65535 || T <= 0 || t_valid <= 0 ||
         t_valid > T;
}

}  // namespace

// Each launches on `stream` and returns the cudaError_t of the launch
// (0 on success).
extern "C" int occm_flash_attn_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int T, int t_valid,
                                      int d, float scale, void* stream) {
  if (bad_args(bh, T, t_valid, d)) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kTile - 1) / kTile, bh);
  flash_attn_bwd_dq_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dq, T, t_valid, scale);
  return (int)cudaGetLastError();
}

extern "C" int occm_flash_attn_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int T,
                                       int t_valid, int d, float scale,
                                       void* stream) {
  if (bad_args(bh, T, t_valid, d)) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kTile - 1) / kTile, bh);
  flash_attn_bwd_dkv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, T, t_valid,
      scale);
  return (int)cudaGetLastError();
}
