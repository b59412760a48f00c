// Flash attention for Hopper (sm_90a) at any head dim and in fp32 or bf16:
// a forward kernel and the two backward kernels (dq, which also computes
// delta = rowsum(dO * O), then dk/dv), on the CUDA cores.
//
// Replaces, for what the wgmma kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu up to D 256 and flash_attn_panel.cu above: bf16 at
// every D that is a multiple of 8) and the 3xTF32 kernels
// (flash_attn_fwd_3xtf32.cu and flash_attn_bwd_3xtf32_*.cu: fp32 at the
// head dims of their tables, multiples of 8 from 8 to 128) do not take,
// the five TPU Pallas kernels of occm_tpu/ops/attention.py, which run
// their dots in q's dtype at any head dim D: forward and backward in fp32
// at every other D >= 1, and in bf16 at every D that is not a multiple of
// 8, with no upper limit (ops/attention.py cuda_route, cuda_bwd_route).
// They are also the "was" beside the wgmma kernels at bf16 D != 64 (the
// panel kernels too) and beside the 3xTF32 kernels, which took their
// place there:
//   _fwd_kernel          (attention.py:45)   whole-T forward
//   _bwd_kernel          (attention.py:79)   whole-T backward
//   _blocked_fwd_kernel  (attention.py:234)  online-softmax forward + lse
//   _blocked_dq_kernel   (attention.py:350)  dq over a kv sweep
//   _blocked_dkv_kernel  (attention.py:373)  dk, dv over a q sweep
// One family covers every T, as the wgmma pair does. The arithmetic is the
// blocked TPU route's, and that of flash_attention_reference /
// flash_attention_bwd_reference (ops/attention.py):
//   - the scale folded into q in fp32, then rounded to q's dtype
//     (attention.py:64, :253, :338), as the wgmma instances at D != 64 do.
//     The D = 64 wgmma instance may scale the fp32 logits instead only
//     because 2^-3 is exact; at D = 32, 80 or 128 in bf16 the two orders
//     round differently;
//   - logits and the online softmax in fp32; keys >= t_valid get no
//     probability;
//   - the unnormalised P rounded to v's dtype before P v, an fp32 sum,
//     divided by the row sum at the end; lse = m + log(max(l, 1e-30));
//   - backward: P = exp(S - lse), dS = P * (dO v^T - delta), P and dS
//     rounded to the input dtype before their products, fp32 sums;
//     dq = scale * dS k, dk = scale * dS^T q from the unscaled q, dv = P^T dO.
// fp32 is true fp32: every product is an FFMA on the CUDA cores (no TF32,
// which keeps about 3 decimal digits).
//
// Layout: q, k, v, out and dO are [B, T, H, D] read through their element
// strides (sb, st, sh, sd); [BH, T, D] is the case B = BH, H = 1. Tiles
// are copied into shared memory by cp.async (16, 8 or 4 bytes a copy, the
// widest that the base addresses, the strides and D * sizeof(T) allow; the
// copy's source size zero-fills dims >= D and rows >= T) when the head dim
// is contiguous, else by element loads, so any strides are read where they
// lie and the backward needs no copy of dO. out, dq, dk and dv are written
// contiguous as [B, T, H, D]; lse and delta are [B * H, T] fp32.
//
// Head dims: up to 256 templated on a padded bucket DP in {16, 32, 64,
// 128, 256}; the dims D..DP-1 of every tile are zero and are never
// written. Above 256 the "wide" kernels (the section "above D 256:
// panels" below) split the output into panels of 256 columns, one a
// block, and stream S's (and dP's) products over the whole D in chunks of
// 128 columns; one instance a dtype, D a runtime argument, so shared
// memory and registers do not grow with D. The grid is then
// (ceil(T / 64) * n_panels, H, B): at T 1500 x stays below its limit,
// 2^31 - 1, for any int D (bad_args checks it).
//
// Design (simple first): one block per (b, h) and 64-row tile of the
// block's own rows (q rows in the forward and dq kernels, keys in dk/dv),
// 16 x TC threads (TC = 8, or 16 for DP >= 128). The streamed tiles (k, v;
// or q, dO) of BN rows are double-buffered in shared memory with cp.async:
// tile j + 1 loads while tile j is computed. Each tile is two register-
// tiled products on the CUDA cores:
//   A: S[64, BN] = rows . streamed^T   thread (tr, tc) holds rows 4 tr..4 tr+3
//                                      and streamed rows tc + TC j, float4
//                                      loads along D;
//   B: acc[64, DP] += P[64, BN] . streamed   P (or dS) through shared memory
//                                      (rounded to T), thread (tr, tc) holds
//                                      its 4 rows x DP / TC dims in fp32
//                                      registers.
// Row statistics reduce over the TC lanes of a row with shuffles. Each
// block owns its rows of out, dq, or dk and dv: no atomics, and a repeat
// gives the same bits. As in the wgmma pair, S and dP are computed in both
// backward kernels.
//
// What bounds it on an H100: in fp32, operations at 67 TFLOP/s. At B 8,
// H 16, T 299, D 64 the forward is 4 * BH * T^2 * D = 2.929e9 flops:
// 0.044 ms (its 9.8 MB of q, k, v and out take 0.006 ms at 3.35 TB/s); the
// backward's five products 7.3e9 flops at B 12: 0.11 ms. In bf16 the same
// work is bound by bytes or by the tensor cores' 989 TFLOP/s, which this
// kernel does not use.
// What its simple design leaves on the table: the tensor cores (in fp32
// the 3xTF32 forward is 1.7-3.0x faster on the device at D 8-128 and
// T 299, the 3xTF32 backward pair 1.1-2.1x; in bf16 the wgmma instances of
// flash_attn_fwd.cu and flash_attn_bwd.cu take every D that is a
// multiple of 8 up to 128, 4-30x faster at D 16-128: all of them took
// this kernel's place there); the padded dims of D = 80 (DP 128); the exp
// and shuffles of the online softmax, which at D = 16 cost as much as the
// products; one or two blocks an SM at DP >= 128 (shared memory); and the
// recomputed S and dP of the backward. The measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;

struct Strides {
  long long sb, st, sh, sd;
};

// ---- element types: fp32 or bf16 in memory, fp32 in registers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T's precision, as a float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// 4 (or 2) consecutive elements of shared memory as floats
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// kVW consecutive elements (kVW 2 or 4) into v[0 .. kVW)
template <int kVW, typename T>
__device__ __forceinline__ void ld_vec(const T* p, float* v) {
  if constexpr (kVW == 4) {
    const float4 f = ld4(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const float2 f = ld2(p);
    v[0] = f.x, v[1] = f.y;
  }
}

// ---- cp.async: `bytes` bytes of `src` to shared `dst`, of which the first
// `valid` (0 or `bytes`) are read and the rest zero-filled

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int valid) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(kBytes), "r"(valid)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- tiling, by padded head dim

template <int DP>
struct Tile {
  static constexpr int kTC = DP >= 128 ? 16 : 8;  // threads along a row
  static constexpr int kTR = 16;                  // threads along the rows
  static constexpr int kThreads = kTR * kTC;
  static constexpr int kBM = 4 * kTR;  // the block's own rows: 4 a thread
  // streamed rows a tile (k, v; or q, dO), sized so that two or three
  // blocks of fp32 fit an SM's shared memory
  static constexpr int kBN = DP <= 32 ? 64 : (DP <= 128 ? 32 : 16);
  static constexpr int kKN = kBN / kTC;     // streamed rows a thread
  static constexpr int kDN = DP / kTC;      // head dims a thread in product B
  static constexpr int kVW = kDN < 4 ? kDN : 4;  // their vector width
  static constexpr int kLP = kBM + 4;       // row stride of P / dS (floats)
};

// shared-memory row stride in elements: 16-byte rows, padded so that the
// TC lanes' float4 loads of TC streamed rows fall in distinct banks
template <typename T, int DP>
__host__ __device__ constexpr int row_stride() {
  return DP + 16 / (int)sizeof(T);
}

// dim of element e of vector g of thread tc in product B
template <int DP>
__device__ __forceinline__ int dim_of(int g, int tc, int e) {
  using C = Tile<DP>;
  return (g * C::kTC + tc) * C::kVW + e;
}

// Copy rows [r0, r0 + R) of one (b, h) slice (base `src`, row stride st,
// dim stride sd) into shared rows of LD elements, dims [0, DP): dims >= D
// and rows >= T are zero. vec: bytes per cp.async (16, 8, 4), 0 for element
// loads. Issues but does not wait for the copies.
template <typename T, int R, int DP, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          long long sd, int r0, int T_,
                                          int D, int vec) {
  constexpr int LD = row_stride<T, DP>();
  if (vec == 0) {
    for (int c = threadIdx.x; c < R * DP; c += NT) {
      const int r = c / DP, d = c - r * DP, t = r0 + r;
      dst[r * LD + d] =
          (t < T_ && d < D) ? src[t * st + d * sd] : from_f<T>(0.f);
    }
    return;
  }
  const int epc = vec / (int)sizeof(T);  // elements a copy
  const int per_row = DP / epc;
  for (int c = threadIdx.x; c < R * per_row; c += NT) {
    const int r = c / per_row, d = (c - r * per_row) * epc, t = r0 + r;
    const bool ok = t < T_ && d < D;
    const T* s = ok ? src + t * st + d : src;
    T* o = dst + r * LD + d;
    if (vec == 16)
      cp_async<16>(o, s, ok ? 16 : 0);
    else if (vec == 8)
      cp_async<8>(o, s, ok ? 8 : 0);
    else
      cp_async<4>(o, s, ok ? 4 : 0);
  }
}

// max / sum over the TC lanes that share a row (tc is the lane's low bits)
template <int TC>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TC / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int TC>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TC / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Product A for one tile: acc[i][j] += sum_d a[4 tr + i][d] * b[tc + TC j][d]
// over shared rows a (the block's) and b (the streamed), both of stride LD,
// d over KC columns (the whole padded head dim, or one chunk of it above
// D 256). kScaleB: b's element is first multiplied by `scale` and rounded
// to T (q in the dk/dv kernel, stored unscaled).
template <typename T, int DP, bool kScaleB = false, int KC = DP>
__device__ __forceinline__ void product_a(
    float (&acc)[4][Tile<DP>::kKN], const T* a, const T* b, int tr, int tc,
    float scale = 1.f) {
  using C = Tile<DP>;
  constexpr int LD = row_stride<T, KC>();
#pragma unroll 4
  for (int d = 0; d < KC; d += 4) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(a + (4 * tr + i) * LD + d);
#pragma unroll
    for (int j = 0; j < C::kKN; ++j) {
      float4 y = ld4(b + (tc + C::kTC * j) * LD + d);
      if constexpr (kScaleB) {
        y.x = round_to<T>(y.x * scale), y.y = round_to<T>(y.y * scale);
        y.z = round_to<T>(y.z * scale), y.w = round_to<T>(y.w * scale);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = acc[i][j];
        s = fmaf(x[i].x, y.x, s);
        s = fmaf(x[i].y, y.y, s);
        s = fmaf(x[i].z, y.z, s);
        s = fmaf(x[i].w, y.w, s);
        acc[i][j] = s;
      }
    }
  }
}

// Product B for one tile: out[i][.] += sum_k p[k][4 tr + i] * v[k][dims]
// over P^T in shared memory ([BN][kLP] floats) and streamed rows v.
template <typename T, int DP>
__device__ __forceinline__ void product_b(float (&out)[4][Tile<DP>::kDN],
                                          const float* p, const T* v, int tr,
                                          int tc) {
  using C = Tile<DP>;
  constexpr int LD = row_stride<T, DP>();
#pragma unroll 2
  for (int k = 0; k < C::kBN; ++k) {
    const float4 p4 = ld4(p + k * C::kLP + 4 * tr);
    const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int g = 0; g < C::kDN / C::kVW; ++g) {
      float y[C::kVW];
      ld_vec<C::kVW>(v + k * LD + dim_of<DP>(g, tc, 0), y);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < C::kVW; ++e)
          out[i][g * C::kVW + e] = fmaf(pk[i], y[e], out[i][g * C::kVW + e]);
    }
  }
}

// Write a thread's 4 rows x DN dims (times `mul`, rounded to T) to a
// contiguous [B, T, H, D] tensor, at columns d0 + dim (a panel's, above
// D 256; 0 below).
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst,
                                           const float (&v)[4][Tile<DP>::kDN],
                                           float mul, int b, int h, int H,
                                           int T_, int D, int r0, int tr,
                                           int tc, int d0 = 0) {
  using C = Tile<DP>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + 4 * tr + i;
    if (t >= T_) continue;
    T* row = dst + (((long long)b * T_ + t) * H + h) * D + d0;
#pragma unroll
    for (int g = 0; g < C::kDN / C::kVW; ++g)
#pragma unroll
      for (int e = 0; e < C::kVW; ++e) {
        const int d = dim_of<DP>(g, tc, e);
        if (d0 + d < D) row[d] = from_f<T>(v[i][g * C::kVW + e] * mul);
      }
  }
}

// The key mask and online-softmax step of one kv tile of the forward:
// logits s of keys >= t_valid masked, p = exp(s - m) unnormalised and
// rounded to v's dtype into P^T (s_p), the running max and row sum, and
// the accumulator o rescaled.
template <typename T, int DP>
__device__ __forceinline__ void online_softmax(
    float (&s)[4][Tile<DP>::kKN], float (&o)[4][Tile<DP>::kDN],
    float (&m_run)[4], float (&l_run)[4], float* s_p, int kv0, int t_valid,
    int tr, int tc) {
  using C = Tile<DP>;
#pragma unroll
  for (int jj = 0; jj < C::kKN; ++jj)
    if (kv0 + tc + C::kTC * jj >= t_valid)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][jj] = kMasked;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = s[i][0];
#pragma unroll
    for (int jj = 1; jj < C::kKN; ++jj) mx = fmaxf(mx, s[i][jj]);
    const float m_new = fmaxf(m_run[i], row_max<C::kTC>(mx));
    const float alpha = expf(m_run[i] - m_new);
    m_run[i] = m_new;
    float l = l_run[i] * alpha;
#pragma unroll
    for (int jj = 0; jj < C::kKN; ++jj) {
      const float p = expf(s[i][jj] - m_new);
      l += p;
      s_p[(tc + C::kTC * jj) * C::kLP + 4 * tr + i] = round_to<T>(p);
    }
    l_run[i] = l;
#pragma unroll
    for (int e = 0; e < C::kDN; ++e) o[i][e] *= alpha;
  }
}

// dS of one kv tile in the dq kernel, rounded to T into dS^T (s_ds):
// P = exp(S - lse) (0 for keys >= t_valid), dS = P (dP - delta), the
// block's rows' lse and delta in s_lse, s_delta.
template <typename T, int DP>
__device__ __forceinline__ void ds_of_rows(
    const float (&s)[4][Tile<DP>::kKN], const float (&dp)[4][Tile<DP>::kKN],
    const float* s_lse, const float* s_delta, float* s_ds, int kv0,
    int t_valid, int tr, int tc) {
  using C = Tile<DP>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
#pragma unroll
    for (int jj = 0; jj < C::kKN; ++jj) {
      const bool live = kv0 + tc + C::kTC * jj < t_valid;
      const float p = live ? expf(s[i][jj] - s_lse[r]) : 0.f;
      const float ds = p * (dp[i][jj] - s_delta[r]);
      s_ds[(tc + C::kTC * jj) * C::kLP + r] = round_to<T>(ds);
    }
  }
}

// P^T and dS^T of one q tile in the dk/dv kernel, rounded to T into s_p
// and s_ds: keys >= t_valid and q rows >= T get no probability; the
// tile's lse and delta in c_lse, c_delta.
template <typename T, int DP>
__device__ __forceinline__ void p_ds_of_keys(
    const float (&s)[4][Tile<DP>::kKN], const float (&dp)[4][Tile<DP>::kKN],
    const float* c_lse, const float* c_delta, float* s_p, float* s_ds, int k0,
    int q0, int t_valid, int T_, int tr, int tc) {
  using C = Tile<DP>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool key_live = k0 + 4 * tr + i < t_valid;
#pragma unroll
    for (int jj = 0; jj < C::kKN; ++jj) {
      const int c = tc + C::kTC * jj;
      const bool live = key_live && q0 + c < T_;
      const float p = live ? expf(s[i][jj] - c_lse[c]) : 0.f;
      const float ds = p * (dp[i][jj] - c_delta[c]);
      s_p[c * C::kLP + 4 * tr + i] = round_to<T>(p);
      s_ds[c * C::kLP + 4 * tr + i] = round_to<T>(ds);
    }
  }
}

template <typename T, int DP>
constexpr int fwd_smem() {
  using C = Tile<DP>;
  return (C::kBM + 4 * C::kBN) * row_stride<T, DP>() * (int)sizeof(T) +
         C::kBN * C::kLP * 4;
}
template <typename T, int DP>
constexpr int dq_smem() {
  using C = Tile<DP>;
  return (2 * C::kBM + 4 * C::kBN) * row_stride<T, DP>() * (int)sizeof(T) +
         (C::kBN * C::kLP + 2 * C::kBM) * 4;
}
template <typename T, int DP>
constexpr int dkv_smem() {
  using C = Tile<DP>;
  return (2 * C::kBM + 4 * C::kBN) * row_stride<T, DP>() * (int)sizeof(T) +
         (2 * C::kBN * C::kLP + 4 * C::kBN) * 4;
}

// ------------------------------------------------------------------ forward
// grid (ceil(T / 64), H, B)
template <typename T, int DP>
__global__ void __launch_bounds__(Tile<DP>::kThreads)
flash_attn_generic_fwd_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              float* __restrict__ lse, int T_, int t_valid,
                              int D, Strides sq, Strides sk, Strides sv,
                              float scale, int vec) {
  using C = Tile<DP>;
  constexpr int LD = row_stride<T, DP>();
  constexpr int NT = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_k = s_q + C::kBM * LD;    // [2][BN][LD]
  T* s_v = s_k + 2 * C::kBN * LD;  // [2][BN][LD]
  float* s_p = reinterpret_cast<float*>(s_v + 2 * C::kBN * LD);  // P^T

  const int q0 = blockIdx.x * C::kBM, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const int tr = threadIdx.x / C::kTC, tc = threadIdx.x % C::kTC;
  const T* qb = q + b * sq.sb + h * sq.sh;
  const T* kb = k + b * sk.sb + h * sk.sh;
  const T* vb = v + b * sv.sb + h * sv.sh;
  const int n_tiles = (t_valid + C::kBN - 1) / C::kBN;

  load_tile<T, C::kBM, DP, NT>(s_q, qb, sq.st, sq.sd, q0, T_, D, vec);
  load_tile<T, C::kBN, DP, NT>(s_k, kb, sk.st, sk.sd, 0, T_, D, vec);
  load_tile<T, C::kBN, DP, NT>(s_v, vb, sv.st, sv.sd, 0, T_, D, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // the scale folded into q in fp32, rounded to q's dtype
  for (int c = threadIdx.x; c < C::kBM * DP; c += NT) {
    T& x = s_q[(c / DP) * LD + c % DP];
    x = from_f<T>(to_f(x) * scale);
  }
  __syncthreads();

  float o[4][C::kDN];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kMasked;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < C::kDN; ++e) o[i][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      const int nx = st ^ 1, r0 = (j + 1) * C::kBN;
      load_tile<T, C::kBN, DP, NT>(s_k + nx * C::kBN * LD, kb, sk.st, sk.sd,
                                   r0, T_, D, vec);
      load_tile<T, C::kBN, DP, NT>(s_v + nx * C::kBN * LD, vb, sv.st, sv.sd,
                                   r0, T_, D, vec);
      cp_async_commit();
    }
    const T* ck = s_k + st * C::kBN * LD;
    const T* cv = s_v + st * C::kBN * LD;
    const int kv0 = j * C::kBN;

    float s[4][C::kKN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < C::kKN; ++jj) s[i][jj] = 0.f;
    product_a<T, DP>(s, s_q, ck, tr, tc);
    online_softmax<T, DP>(s, o, m_run, l_run, s_p, kv0, t_valid, tr, tc);
    __syncthreads();
    product_b<T, DP>(o, s_p, cv, tr, tc);
    if (j + 1 < n_tiles) cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum<C::kTC>(l_run[i]);
#pragma unroll
    for (int e = 0; e < C::kDN; ++e) o[i][e] /= l;
    const int t = q0 + 4 * tr + i;
    if (tc == 0 && t < T_)
      lse[((long long)b * H + h) * T_ + t] = m_run[i] + logf(fmaxf(l, 1e-30f));
  }
  store_rows<T, DP>(out, o, 1.f, b, h, H, T_, D, q0, tr, tc);
}

// ------------------------------------------------------- backward: dq, delta
// grid (ceil(T / 64), H, B)
template <typename T, int DP>
__global__ void __launch_bounds__(Tile<DP>::kThreads)
flash_attn_generic_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    T* __restrict__ dq, int T_, int t_valid, int D, Strides sq, Strides sk,
    Strides sv, Strides so, Strides sdo, float scale, int vec) {
  using C = Tile<DP>;
  constexpr int LD = row_stride<T, DP>();
  constexpr int NT = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_do = s_q + C::kBM * LD;
  T* s_k = s_do + C::kBM * LD;     // [2][BN][LD]
  T* s_v = s_k + 2 * C::kBN * LD;  // [2][BN][LD]
  float* s_ds = reinterpret_cast<float*>(s_v + 2 * C::kBN * LD);  // dS^T
  float* s_lse = s_ds + C::kBN * C::kLP;
  float* s_delta = s_lse + C::kBM;

  const int q0 = blockIdx.x * C::kBM, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const int tr = threadIdx.x / C::kTC, tc = threadIdx.x % C::kTC;
  const T* qb = q + b * sq.sb + h * sq.sh;
  const T* kb = k + b * sk.sb + h * sk.sh;
  const T* vb = v + b * sv.sb + h * sv.sh;
  const T* ob = o + b * so.sb + h * so.sh;
  const T* dob = dout + b * sdo.sb + h * sdo.sh;
  const long long row0 = ((long long)b * H + h) * T_;
  const int n_tiles = (t_valid + C::kBN - 1) / C::kBN;

  load_tile<T, C::kBM, DP, NT>(s_q, qb, sq.st, sq.sd, q0, T_, D, vec);
  load_tile<T, C::kBM, DP, NT>(s_do, dob, sdo.st, sdo.sd, q0, T_, D, vec);
  load_tile<T, C::kBN, DP, NT>(s_k, kb, sk.st, sk.sd, 0, T_, D, vec);
  load_tile<T, C::kBN, DP, NT>(s_v, vb, sv.st, sv.sd, 0, T_, D, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int c = threadIdx.x; c < C::kBM * DP; c += NT) {
    T& x = s_q[(c / DP) * LD + c % DP];
    x = from_f<T>(to_f(x) * scale);
  }
  // delta = rowsum(dO * O) in fp32, a warp a row; O read from device
  // memory once, dO from its tile
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < C::kBM; r += NT / 32) {
      const int t = q0 + r;
      float acc = 0.f;
      if (t < T_)
        for (int d = lane; d < D; d += 32)
          acc = fmaf(to_f(s_do[r * LD + d]), to_f(ob[t * so.st + d * so.sd]),
                     acc);
      acc = row_sum<32>(acc);
      if (lane == 0) {
        s_delta[r] = acc;
        s_lse[r] = t < T_ ? lse[row0 + t] : 0.f;
        if (t < T_) delta[row0 + t] = acc;
      }
    }
  }
  __syncthreads();

  float acc[4][C::kDN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < C::kDN; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      const int nx = st ^ 1, r0 = (j + 1) * C::kBN;
      load_tile<T, C::kBN, DP, NT>(s_k + nx * C::kBN * LD, kb, sk.st, sk.sd,
                                   r0, T_, D, vec);
      load_tile<T, C::kBN, DP, NT>(s_v + nx * C::kBN * LD, vb, sv.st, sv.sd,
                                   r0, T_, D, vec);
      cp_async_commit();
    }
    const T* ck = s_k + st * C::kBN * LD;
    const T* cv = s_v + st * C::kBN * LD;
    const int kv0 = j * C::kBN;

    float s[4][C::kKN], dp[4][C::kKN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < C::kKN; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    product_a<T, DP>(s, s_q, ck, tr, tc);
    product_a<T, DP>(dp, s_do, cv, tr, tc);
    ds_of_rows<T, DP>(s, dp, s_lse, s_delta, s_ds, kv0, t_valid, tr, tc);
    __syncthreads();
    product_b<T, DP>(acc, s_ds, ck, tr, tc);
    if (j + 1 < n_tiles) cp_async_wait_all();
    __syncthreads();
  }
  store_rows<T, DP>(dq, acc, scale, b, h, H, T_, D, q0, tr, tc);
}

// ------------------------------------------------------ backward: dk and dv
// grid (ceil(T / 64), H, B): the block's rows are 64 keys, the streamed
// tiles q and dO rows
template <typename T, int DP>
__global__ void __launch_bounds__(Tile<DP>::kThreads)
flash_attn_generic_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int T_, int t_valid, int D, Strides sq, Strides sk, Strides sv,
    Strides sdo, float scale, int vec) {
  using C = Tile<DP>;
  constexpr int LD = row_stride<T, DP>();
  constexpr int NT = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + C::kBM * LD;
  T* s_q = s_v + C::kBM * LD;       // [2][BN][LD], unscaled
  T* s_do = s_q + 2 * C::kBN * LD;  // [2][BN][LD]
  float* s_p = reinterpret_cast<float*>(s_do + 2 * C::kBN * LD);  // [BN][LP]
  float* s_ds = s_p + C::kBN * C::kLP;                           // [BN][LP]
  float* s_lse = s_ds + C::kBN * C::kLP;                         // [2][BN]
  float* s_delta = s_lse + 2 * C::kBN;                           // [2][BN]

  const int k0 = blockIdx.x * C::kBM, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const int tr = threadIdx.x / C::kTC, tc = threadIdx.x % C::kTC;
  const T* qb = q + b * sq.sb + h * sq.sh;
  const T* kb = k + b * sk.sb + h * sk.sh;
  const T* vb = v + b * sv.sb + h * sv.sh;
  const T* dob = dout + b * sdo.sb + h * sdo.sh;
  const long long row0 = ((long long)b * H + h) * T_;

  float acc_k[4][C::kDN], acc_v[4][C::kDN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < C::kDN; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  // keys past t_valid get no probability: their dk and dv are zero
  const int n_tiles = k0 < t_valid ? (T_ + C::kBN - 1) / C::kBN : 0;
  auto stats = [&](int stage, int r0) {
    for (int r = threadIdx.x; r < C::kBN; r += NT) {
      const int t = r0 + r;
      s_lse[stage * C::kBN + r] = t < T_ ? lse[row0 + t] : 0.f;
      s_delta[stage * C::kBN + r] = t < T_ ? delta[row0 + t] : 0.f;
    }
  };
  if (n_tiles > 0) {
    load_tile<T, C::kBM, DP, NT>(s_k, kb, sk.st, sk.sd, k0, T_, D, vec);
    load_tile<T, C::kBM, DP, NT>(s_v, vb, sv.st, sv.sd, k0, T_, D, vec);
    load_tile<T, C::kBN, DP, NT>(s_q, qb, sq.st, sq.sd, 0, T_, D, vec);
    load_tile<T, C::kBN, DP, NT>(s_do, dob, sdo.st, sdo.sd, 0, T_, D, vec);
    cp_async_commit();
    stats(0, 0);
    cp_async_wait_all();
    __syncthreads();
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      const int nx = st ^ 1, r0 = (j + 1) * C::kBN;
      load_tile<T, C::kBN, DP, NT>(s_q + nx * C::kBN * LD, qb, sq.st, sq.sd,
                                   r0, T_, D, vec);
      load_tile<T, C::kBN, DP, NT>(s_do + nx * C::kBN * LD, dob, sdo.st,
                                   sdo.sd, r0, T_, D, vec);
      cp_async_commit();
      stats(nx, r0);
    }
    const T* cq = s_q + st * C::kBN * LD;
    const T* cdo = s_do + st * C::kBN * LD;
    const float* c_lse = s_lse + st * C::kBN;
    const float* c_delta = s_delta + st * C::kBN;
    const int q0 = j * C::kBN;

    // S^T = k (scale q)^T with q scaled and rounded as it is read,
    // dP^T = v dO^T
    float s[4][C::kKN], dp[4][C::kKN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < C::kKN; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    product_a<T, DP, true>(s, s_k, cq, tr, tc, scale);
    product_a<T, DP>(dp, s_v, cdo, tr, tc);
    p_ds_of_keys<T, DP>(s, dp, c_lse, c_delta, s_p, s_ds, k0, q0, t_valid, T_,
                        tr, tc);
    __syncthreads();
    product_b<T, DP>(acc_v, s_p, cdo, tr, tc);
    product_b<T, DP>(acc_k, s_ds, cq, tr, tc);
    if (j + 1 < n_tiles) cp_async_wait_all();
    __syncthreads();
  }
  store_rows<T, DP>(dk, acc_k, scale, b, h, H, T_, D, k0, tr, tc);
  store_rows<T, DP>(dv, acc_v, 1.f, b, h, H, T_, D, k0, tr, tc);
}

// ------------------------------------------------------ above D 256: panels
// A block owns 64 rows (q rows, or keys) and one panel of kPW output
// columns: grid (ceil(T / 64) * n_panels, H, B), the panel the fastest
// index of x, so that the blocks of one row tile run side by side and
// share their streamed tiles through the L2. S (and dP) need the whole D:
// they stream it in chunks of kKC columns, both the block's rows and the
// streamed rows, through the cp.async double buffer (a step is one chunk
// of one product of one streamed tile); the streamed tile's panel (v; k;
// q and dO) of kPW columns is loaded with the tile's first step into a
// buffer of its own, double-buffered too. Shared memory does not grow
// with D. The block's rows are reloaded every step (from the L2), and each
// of the n_panels blocks of a row tile computes the same S and dP: at
// D 512 (two panels) the forward does 1.5x the least products and the
// backward 1.67x (the seven of the pair over its five least, 2.33x).
constexpr int kPW = 256;  // a block's output columns
constexpr int kKC = 128;  // columns of a chunk of S's (or dP's) stream
using WideTile = Tile<kPW>;

// a chunk slot: the block's rows' chunk, then the streamed tile's
template <typename T>
__host__ __device__ constexpr int chunk_slot() {
  return (WideTile::kBM + WideTile::kBN) * row_stride<T, kKC>();
}
template <typename T>
__host__ __device__ constexpr int panel_elems() {
  return WideTile::kBN * row_stride<T, kPW>();
}
template <typename T>
constexpr int fwd_wide_smem() {
  return (2 * chunk_slot<T>() + 2 * panel_elems<T>()) * (int)sizeof(T) +
         WideTile::kBN * WideTile::kLP * 4;
}
template <typename T>
constexpr int dq_wide_smem() {
  return fwd_wide_smem<T>() + 2 * WideTile::kBM * 4;
}
template <typename T>
constexpr int dkv_wide_smem() {
  return (2 * chunk_slot<T>() + 4 * panel_elems<T>()) * (int)sizeof(T) +
         (2 * WideTile::kBN * WideTile::kLP + 4 * WideTile::kBN) * 4;
}

// Issues the cp.async copies of chunk c of rows [a0, a0 + 64) of `a` and
// rows [b0, b0 + BN) of `b` (each at its (b, h) base) into a chunk slot.
template <typename T>
__device__ __forceinline__ void load_chunk(T* slot, const T* a,
                                           const Strides& sa, int a0,
                                           const T* b, const Strides& sb,
                                           int b0, int c, int T_, int D,
                                           int vec) {
  using C = WideTile;
  constexpr int LDC = row_stride<T, kKC>();
  const int d0 = c * kKC;
  load_tile<T, C::kBM, kKC, C::kThreads>(slot, a + d0 * sa.sd, sa.st, sa.sd,
                                         a0, T_, D - d0, vec);
  load_tile<T, C::kBN, kKC, C::kThreads>(slot + C::kBM * LDC, b + d0 * sb.sd,
                                         sb.st, sb.sd, b0, T_, D - d0, vec);
}

// Issues the copies of a streamed tile's panel: rows [r0, r0 + BN),
// columns [d0, d0 + kPW).
template <typename T>
__device__ __forceinline__ void load_panel(T* dst, const T* src,
                                           const Strides& s, int r0, int d0,
                                           int T_, int D, int vec) {
  load_tile<T, WideTile::kBN, kPW, WideTile::kThreads>(
      dst, src + d0 * s.sd, s.st, s.sd, r0, T_, D - d0, vec);
}

// q * scale rounded to T in place over a chunk slot's 64 rows
template <typename T>
__device__ __forceinline__ void fold_chunk(T* rows, float scale) {
  constexpr int LDC = row_stride<T, kKC>();
  for (int c = threadIdx.x; c < WideTile::kBM * kKC; c += WideTile::kThreads) {
    T& x = rows[(c / kKC) * LDC + c % kKC];
    x = from_f<T>(to_f(x) * scale);
  }
}

// forward, grid (ceil(T / 64) * n_panels, H, B)
template <typename T>
__global__ void __launch_bounds__(WideTile::kThreads)
flash_attn_generic_fwd_wide_kernel(const T* __restrict__ q,
                                   const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   T* __restrict__ out,
                                   float* __restrict__ lse, int T_,
                                   int t_valid, int D, int n_panels,
                                   Strides sq, Strides sk, Strides sv,
                                   float scale, int vec) {
  using C = WideTile;
  constexpr int LDC = row_stride<T, kKC>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* slots = reinterpret_cast<T*>(smem);        // [2] chunk slots
  T* s_v = slots + 2 * chunk_slot<T>();         // [2] v panels
  float* s_p = reinterpret_cast<float*>(s_v + 2 * panel_elems<T>());

  const int panel = blockIdx.x % n_panels;
  const int q0 = blockIdx.x / n_panels * C::kBM, d0 = panel * kPW;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tr = threadIdx.x / C::kTC, tc = threadIdx.x % C::kTC;
  const T* qb = q + b * sq.sb + h * sq.sh;
  const T* kb = k + b * sk.sb + h * sk.sh;
  const T* vb = v + b * sv.sb + h * sv.sh;
  const int n_chunks = (D + kKC - 1) / kKC;
  const int n_steps = (t_valid + C::kBN - 1) / C::kBN * n_chunks;
  auto issue = [&](int step) {
    const int j = step / n_chunks, c = step % n_chunks;
    load_chunk(slots + (step & 1) * chunk_slot<T>(), qb, sq, q0, kb, sk,
               j * C::kBN, c, T_, D, vec);
    if (c == 0)
      load_panel(s_v + (j & 1) * panel_elems<T>(), vb, sv, j * C::kBN, d0,
                 T_, D, vec);
    cp_async_commit();
  };

  float o[4][C::kDN], s[4][C::kKN];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kMasked;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < C::kDN; ++e) o[i][e] = 0.f;
  }

  issue(0);
  for (int step = 0; step < n_steps; ++step) {
    const int j = step / n_chunks, c = step % n_chunks;
    cp_async_wait_all();
    __syncthreads();  // this step's copies are in; the last step's reads done
    if (step + 1 < n_steps) issue(step + 1);
    T* slot = slots + (step & 1) * chunk_slot<T>();
    // the scale folded into q in fp32, rounded to q's dtype
    fold_chunk(slot, scale);
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < C::kKN; ++jj) s[i][jj] = 0.f;
    }
    product_a<T, kPW, false, kKC>(s, slot, slot + C::kBM * LDC, tr, tc);
    if (c + 1 < n_chunks) continue;
    online_softmax<T, kPW>(s, o, m_run, l_run, s_p, j * C::kBN, t_valid, tr,
                           tc);
    __syncthreads();
    product_b<T, kPW>(o, s_p, s_v + (j & 1) * panel_elems<T>(), tr, tc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum<C::kTC>(l_run[i]);
#pragma unroll
    for (int e = 0; e < C::kDN; ++e) o[i][e] /= l;
    const int t = q0 + 4 * tr + i;
    // every panel's block computes the same lse; panel 0's writes it
    if (panel == 0 && tc == 0 && t < T_)
      lse[((long long)b * H + h) * T_ + t] = m_run[i] + logf(fmaxf(l, 1e-30f));
  }
  store_rows<T, kPW>(out, o, 1.f, b, h, H, T_, D, q0, tr, tc, d0);
}

// delta = rowsum(dO * O) in fp32 of rows [r0, r0 + 64) read from device
// memory, a warp a row, into s_delta (and lse into s_lse); panel 0's block
// also writes delta, which every panel's block computes alike.
template <typename T>
__device__ __forceinline__ void delta_rows(const T* ob, const Strides& so,
                                           const T* dob, const Strides& sdo,
                                           const float* lse, float* delta,
                                           float* s_lse, float* s_delta,
                                           long long row0, int r0, int T_,
                                           int D, bool write) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < WideTile::kBM; r += WideTile::kThreads / 32) {
    const int t = r0 + r;
    float acc = 0.f;
    if (t < T_)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(to_f(dob[t * sdo.st + d * sdo.sd]),
                   to_f(ob[t * so.st + d * so.sd]), acc);
    acc = row_sum<32>(acc);
    if (lane == 0) {
      s_delta[r] = acc;
      s_lse[r] = t < T_ ? lse[row0 + t] : 0.f;
      if (write && t < T_) delta[row0 + t] = acc;
    }
  }
}

// backward dq and delta, grid (ceil(T / 64) * n_panels, H, B): per kv tile
// the S chunks (q, k) and then the dP chunks (dO, v), then dq's panel
// += dS k's panel
template <typename T>
__global__ void __launch_bounds__(WideTile::kThreads)
flash_attn_generic_dq_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    T* __restrict__ dq, int T_, int t_valid, int D, int n_panels, Strides sq,
    Strides sk, Strides sv, Strides so, Strides sdo, float scale, int vec) {
  using C = WideTile;
  constexpr int LDC = row_stride<T, kKC>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* slots = reinterpret_cast<T*>(smem);  // [2] chunk slots
  T* s_k = slots + 2 * chunk_slot<T>();   // [2] k panels
  float* s_ds = reinterpret_cast<float*>(s_k + 2 * panel_elems<T>());
  float* s_lse = s_ds + C::kBN * C::kLP;
  float* s_delta = s_lse + C::kBM;

  const int panel = blockIdx.x % n_panels;
  const int q0 = blockIdx.x / n_panels * C::kBM, d0 = panel * kPW;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tr = threadIdx.x / C::kTC, tc = threadIdx.x % C::kTC;
  const T* qb = q + b * sq.sb + h * sq.sh;
  const T* kb = k + b * sk.sb + h * sk.sh;
  const T* vb = v + b * sv.sb + h * sv.sh;
  const T* ob = o + b * so.sb + h * so.sh;
  const T* dob = dout + b * sdo.sb + h * sdo.sh;
  const long long row0 = ((long long)b * H + h) * T_;
  const int n_chunks = (D + kKC - 1) / kKC;
  // a kv tile's steps: n_chunks of S, then n_chunks of dP
  const int per_tile = 2 * n_chunks;
  const int n_steps = (t_valid + C::kBN - 1) / C::kBN * per_tile;
  auto issue = [&](int step) {
    const int j = step / per_tile, c = step % per_tile;
    T* slot = slots + (step & 1) * chunk_slot<T>();
    if (c < n_chunks)
      load_chunk(slot, qb, sq, q0, kb, sk, j * C::kBN, c, T_, D, vec);
    else
      load_chunk(slot, dob, sdo, q0, vb, sv, j * C::kBN, c - n_chunks, T_, D,
                 vec);
    if (c == 0)
      load_panel(s_k + (j & 1) * panel_elems<T>(), kb, sk, j * C::kBN, d0,
                 T_, D, vec);
    cp_async_commit();
  };

  if (n_steps > 0) issue(0);
  delta_rows(ob, so, dob, sdo, lse, delta, s_lse, s_delta, row0, q0, T_, D,
             panel == 0);

  float acc[4][C::kDN], s[4][C::kKN], dp[4][C::kKN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < C::kDN; ++e) acc[i][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int j = step / per_tile, c = step % per_tile;
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < n_steps) issue(step + 1);
    T* slot = slots + (step & 1) * chunk_slot<T>();
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < C::kKN; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    }
    if (c < n_chunks) {
      fold_chunk(slot, scale);
      __syncthreads();
      product_a<T, kPW, false, kKC>(s, slot, slot + C::kBM * LDC, tr, tc);
      continue;
    }
    product_a<T, kPW, false, kKC>(dp, slot, slot + C::kBM * LDC, tr, tc);
    if (c + 1 < per_tile) continue;
    ds_of_rows<T, kPW>(s, dp, s_lse, s_delta, s_ds, j * C::kBN, t_valid, tr,
                       tc);
    __syncthreads();
    product_b<T, kPW>(acc, s_ds, s_k + (j & 1) * panel_elems<T>(), tr, tc);
  }
  store_rows<T, kPW>(dq, acc, scale, b, h, H, T_, D, q0, tr, tc, d0);
}

// backward dk and dv, grid (ceil(T / 64) * n_panels, H, B): the block's
// rows are 64 keys; per q tile the S^T chunks (k, q scaled as it is read)
// and then the dP^T chunks (v, dO), then dv's panel += P^T dO's panel and
// dk's panel += dS^T q's panel
template <typename T>
__global__ void __launch_bounds__(WideTile::kThreads)
flash_attn_generic_dkv_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int T_, int t_valid, int D, int n_panels, Strides sq, Strides sk,
    Strides sv, Strides sdo, float scale, int vec) {
  using C = WideTile;
  constexpr int LDC = row_stride<T, kKC>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* slots = reinterpret_cast<T*>(smem);  // [2] chunk slots
  T* s_q = slots + 2 * chunk_slot<T>();   // [2] q panels, unscaled
  T* s_do = s_q + 2 * panel_elems<T>();   // [2] dO panels
  float* s_p = reinterpret_cast<float*>(s_do + 2 * panel_elems<T>());
  float* s_ds = s_p + C::kBN * C::kLP;
  float* s_lse = s_ds + C::kBN * C::kLP;  // [2][BN]
  float* s_delta = s_lse + 2 * C::kBN;    // [2][BN]

  const int panel = blockIdx.x % n_panels;
  const int k0 = blockIdx.x / n_panels * C::kBM, d0 = panel * kPW;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tr = threadIdx.x / C::kTC, tc = threadIdx.x % C::kTC;
  const T* qb = q + b * sq.sb + h * sq.sh;
  const T* kb = k + b * sk.sb + h * sk.sh;
  const T* vb = v + b * sv.sb + h * sv.sh;
  const T* dob = dout + b * sdo.sb + h * sdo.sh;
  const long long row0 = ((long long)b * H + h) * T_;
  const int n_chunks = (D + kKC - 1) / kKC;
  const int per_tile = 2 * n_chunks;
  // keys past t_valid get no probability: their dk and dv are zero
  const int n_steps =
      k0 < t_valid ? (T_ + C::kBN - 1) / C::kBN * per_tile : 0;
  auto issue = [&](int step) {
    const int j = step / per_tile, c = step % per_tile, r0 = j * C::kBN;
    T* slot = slots + (step & 1) * chunk_slot<T>();
    if (c < n_chunks)
      load_chunk(slot, kb, sk, k0, qb, sq, r0, c, T_, D, vec);
    else
      load_chunk(slot, vb, sv, k0, dob, sdo, r0, c - n_chunks, T_, D, vec);
    if (c == 0) {
      const int st = j & 1;
      load_panel(s_q + st * panel_elems<T>(), qb, sq, r0, d0, T_, D, vec);
      load_panel(s_do + st * panel_elems<T>(), dob, sdo, r0, d0, T_, D, vec);
      for (int r = threadIdx.x; r < C::kBN; r += C::kThreads) {
        const int t = r0 + r;
        s_lse[st * C::kBN + r] = t < T_ ? lse[row0 + t] : 0.f;
        s_delta[st * C::kBN + r] = t < T_ ? delta[row0 + t] : 0.f;
      }
    }
    cp_async_commit();
  };

  float acc_k[4][C::kDN], acc_v[4][C::kDN], s[4][C::kKN], dp[4][C::kKN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < C::kDN; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  if (n_steps > 0) issue(0);
  for (int step = 0; step < n_steps; ++step) {
    const int j = step / per_tile, c = step % per_tile;
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < n_steps) issue(step + 1);
    const T* slot = slots + (step & 1) * chunk_slot<T>();
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < C::kKN; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    }
    if (c < n_chunks) {
      // S^T = k (scale q)^T, q scaled and rounded as it is read
      product_a<T, kPW, true, kKC>(s, slot, slot + C::kBM * LDC, tr, tc,
                                   scale);
      continue;
    }
    product_a<T, kPW, false, kKC>(dp, slot, slot + C::kBM * LDC, tr, tc);
    if (c + 1 < per_tile) continue;
    const int st = j & 1;
    p_ds_of_keys<T, kPW>(s, dp, s_lse + st * C::kBN, s_delta + st * C::kBN,
                         s_p, s_ds, k0, j * C::kBN, t_valid, T_, tr, tc);
    __syncthreads();
    product_b<T, kPW>(acc_v, s_p, s_do + st * panel_elems<T>(), tr, tc);
    product_b<T, kPW>(acc_k, s_ds, s_q + st * panel_elems<T>(), tr, tc);
  }
  store_rows<T, kPW>(dk, acc_k, scale, b, h, H, T_, D, k0, tr, tc, d0);
  store_rows<T, kPW>(dv, acc_v, 1.f, b, h, H, T_, D, k0, tr, tc, d0);
}

// ---------------------------------------------------------------- host side

// widest cp.async (16, 8, 4 bytes) that a tensor's base address, strides
// and row of D elements allow; 0 (element loads) if the head dim is not
// contiguous or no width fits
int copy_width(const void* p, const Strides& s, int d, int elt) {
  if (s.sd != 1) return 0;
  for (int w = 16; w >= 4; w /= 2)
    if (reinterpret_cast<uintptr_t>(p) % w == 0 && (s.sb * elt) % w == 0 &&
        (s.st * elt) % w == 0 && (s.sh * elt) % w == 0 && (d * elt) % w == 0)
      return w;
  return 0;
}

int narrower(int a, int b) { return a < b ? a : b; }

bool bad_args(int dtype, int b, int h, int T, int t_valid, int d) {
  return (dtype != 0 && dtype != 1) || b <= 0 || b > 65535 || h <= 0 ||
         h > 65535 || T <= 0 || t_valid <= 0 || t_valid > T || d < 1 ||
         (long long)((T + 63) / 64) * ((d + kPW - 1) / kPW) > 0x7fffffff;
}

// the kernel's dynamic shared memory, set once per instance (a
// thread-safe static, so a launch captured into a CUDA graph makes no
// attribute call)
template <typename Kernel>
cudaError_t smem_attr(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DP>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int b, int h, int seq, int t_valid, int d, Strides sq, Strides sk,
        Strides sv, float scale, int vec, cudaStream_t stream) {
  constexpr int smem = fwd_smem<T, DP>();
  static const cudaError_t attr =
      smem_attr(flash_attn_generic_fwd_kernel<T, DP>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq + Tile<DP>::kBM - 1) / Tile<DP>::kBM, h, b);
  flash_attn_generic_fwd_kernel<T, DP>
      <<<grid, Tile<DP>::kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, seq,
          t_valid, d, sq, sk, sv, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq, int b,
           int h, int seq, int t_valid, int d, Strides sq, Strides sk,
           Strides sv, Strides so, Strides sdo, float scale, int vec,
           cudaStream_t stream) {
  constexpr int smem = dq_smem<T, DP>();
  static const cudaError_t attr =
      smem_attr(flash_attn_generic_dq_kernel<T, DP>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq + Tile<DP>::kBM - 1) / Tile<DP>::kBM, h, b);
  flash_attn_generic_dq_kernel<T, DP>
      <<<grid, Tile<DP>::kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)o,
          (const T*)dout, (const float*)lse, (float*)delta, (T*)dq, seq,
          t_valid, d, sq, sk, sv, so, sdo, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int b,
            int h, int seq, int t_valid, int d, Strides sq, Strides sk,
            Strides sv, Strides sdo, float scale, int vec,
            cudaStream_t stream) {
  constexpr int smem = dkv_smem<T, DP>();
  static const cudaError_t attr =
      smem_attr(flash_attn_generic_dkv_kernel<T, DP>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq + Tile<DP>::kBM - 1) / Tile<DP>::kBM, h, b);
  flash_attn_generic_dkv_kernel<T, DP>
      <<<grid, Tile<DP>::kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
          (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, seq, t_valid,
          d, sq, sk, sv, sdo, scale, vec);
  return (int)cudaGetLastError();
}

// The kernels above D 256: n_panels panels of kPW columns, a block each.
template <typename T>
int fwd_wide(const void* q, const void* k, const void* v, void* out,
             void* lse, int b, int h, int seq, int t_valid, int d, Strides sq,
             Strides sk, Strides sv, float scale, int vec,
             cudaStream_t stream) {
  constexpr int smem = fwd_wide_smem<T>();
  static const cudaError_t attr =
      smem_attr(flash_attn_generic_fwd_wide_kernel<T>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_panels = (d + kPW - 1) / kPW;
  const dim3 grid((seq + WideTile::kBM - 1) / WideTile::kBM * n_panels, h, b);
  flash_attn_generic_fwd_wide_kernel<T>
      <<<grid, WideTile::kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, seq,
          t_valid, d, n_panels, sq, sk, sv, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dq_wide(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                int b, int h, int seq, int t_valid, int d, Strides sq,
                Strides sk, Strides sv, Strides so, Strides sdo, float scale,
                int vec, cudaStream_t stream) {
  constexpr int smem = dq_wide_smem<T>();
  static const cudaError_t attr =
      smem_attr(flash_attn_generic_dq_wide_kernel<T>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_panels = (d + kPW - 1) / kPW;
  const dim3 grid((seq + WideTile::kBM - 1) / WideTile::kBM * n_panels, h, b);
  flash_attn_generic_dq_wide_kernel<T>
      <<<grid, WideTile::kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)o,
          (const T*)dout, (const float*)lse, (float*)delta, (T*)dq, seq,
          t_valid, d, n_panels, sq, sk, sv, so, sdo, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dkv_wide(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int b, int h, int seq, int t_valid,
                 int d, Strides sq, Strides sk, Strides sv, Strides sdo,
                 float scale, int vec, cudaStream_t stream) {
  constexpr int smem = dkv_wide_smem<T>();
  static const cudaError_t attr =
      smem_attr(flash_attn_generic_dkv_wide_kernel<T>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_panels = (d + kPW - 1) / kPW;
  const dim3 grid((seq + WideTile::kBM - 1) / WideTile::kBM * n_panels, h, b);
  flash_attn_generic_dkv_wide_kernel<T>
      <<<grid, WideTile::kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
          (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, seq,
          t_valid, d, n_panels, sq, sk, sv, sdo, scale, vec);
  return (int)cudaGetLastError();
}

// Calls F<T, DP>::run(args...) for dtype (0 fp32, 1 bf16) and the head-dim
// bucket of d, or, above 256, F<T, 0>::run (the panel kernels).
template <template <typename, int> class F, typename... Args>
int dispatch(int dtype, int d, Args... args) {
  if (d > kPW)
    return dtype == 0 ? F<float, 0>::run(args...)
                      : F<__nv_bfloat16, 0>::run(args...);
  if (dtype == 0) {
    if (d <= 16) return F<float, 16>::run(args...);
    if (d <= 32) return F<float, 32>::run(args...);
    if (d <= 64) return F<float, 64>::run(args...);
    if (d <= 128) return F<float, 128>::run(args...);
    return F<float, 256>::run(args...);
  }
  if (d <= 16) return F<__nv_bfloat16, 16>::run(args...);
  if (d <= 32) return F<__nv_bfloat16, 32>::run(args...);
  if (d <= 64) return F<__nv_bfloat16, 64>::run(args...);
  if (d <= 128) return F<__nv_bfloat16, 128>::run(args...);
  return F<__nv_bfloat16, 256>::run(args...);
}

template <typename T, int DP>
struct Fwd {
  template <typename... A>
  static int run(A... a) {
    if constexpr (DP == 0)
      return fwd_wide<T>(a...);
    else
      return fwd<T, DP>(a...);
  }
};
template <typename T, int DP>
struct Dq {
  template <typename... A>
  static int run(A... a) {
    if constexpr (DP == 0)
      return bwd_dq_wide<T>(a...);
    else
      return bwd_dq<T, DP>(a...);
  }
};
template <typename T, int DP>
struct Dkv {
  template <typename... A>
  static int run(A... a) {
    if constexpr (DP == 0)
      return bwd_dkv_wide<T>(a...);
    else
      return bwd_dkv<T, DP>(a...);
  }
};

}  // namespace

// q, k, v: [b, T, h, d] of dtype 0 (fp32) or 1 (bf16), d >= 1, any
// element strides (sb, st, sh, sd) each; out: [b, T, h, d] contiguous, of
// the same dtype; lse: [b * h, T] fp32. Keys at index >= t_valid are
// masked; `scale` is folded into q. One launch on `stream`. Returns 0 or a
// cudaError_t.
extern "C" int occm_flash_attn_generic_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int dtype, int b, int h, int T, int t_valid, int d, long long q_sb,
    long long q_st, long long q_sh, long long q_sd, long long k_sb,
    long long k_st, long long k_sh, long long k_sd, long long v_sb,
    long long v_st, long long v_sh, long long v_sd, float scale,
    void* stream) {
  if (bad_args(dtype, b, h, T, t_valid, d)) return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_st, q_sh, q_sd}, sk{k_sb, k_st, k_sh, k_sd},
      sv{v_sb, v_st, v_sh, v_sd};
  const int elt = dtype == 0 ? 4 : 2;
  int vec = copy_width(q, sq, d, elt);
  vec = narrower(vec, copy_width(k, sk, d, elt));
  vec = narrower(vec, copy_width(v, sv, d, elt));
  return dispatch<Fwd>(dtype, d, q, k, v, out, lse, b, h, T, t_valid, d, sq,
                       sk, sv, scale, vec, (cudaStream_t)stream);
}

// q, k, v, out, dout: [b, T, h, d] as for occm_flash_attn_generic_fwd, each
// with its strides; lse: [b * h, T] fp32 from that forward; delta:
// [b * h, T] fp32, written (rowsum(dout * out)); dq: [b, T, h, d]
// contiguous, written. One launch on `stream`; returns 0 or a cudaError_t.
extern "C" int occm_flash_attn_generic_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, int dtype,
    int b, int h, int T, int t_valid, int d, long long q_sb, long long q_st,
    long long q_sh, long long q_sd, long long k_sb, long long k_st,
    long long k_sh, long long k_sd, long long v_sb, long long v_st,
    long long v_sh, long long v_sd, long long o_sb, long long o_st,
    long long o_sh, long long o_sd, long long do_sb, long long do_st,
    long long do_sh, long long do_sd, float scale, void* stream) {
  if (bad_args(dtype, b, h, T, t_valid, d)) return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_st, q_sh, q_sd}, sk{k_sb, k_st, k_sh, k_sd},
      sv{v_sb, v_st, v_sh, v_sd}, so{o_sb, o_st, o_sh, o_sd},
      sdo{do_sb, do_st, do_sh, do_sd};
  const int elt = dtype == 0 ? 4 : 2;
  int vec = copy_width(q, sq, d, elt);
  vec = narrower(vec, copy_width(k, sk, d, elt));
  vec = narrower(vec, copy_width(v, sv, d, elt));
  vec = narrower(vec, copy_width(dout, sdo, d, elt));
  return dispatch<Dq>(dtype, d, q, k, v, out, dout, lse, delta, dq, b, h, T,
                      t_valid, d, sq, sk, sv, so, sdo, scale, vec,
                      (cudaStream_t)stream);
}

// q, k, v, dout as for occm_flash_attn_generic_bwd_dq; lse and delta:
// [b * h, T] fp32 (delta as occm_flash_attn_generic_bwd_dq wrote it,
// earlier on `stream`); dk, dv: [b, T, h, d] contiguous, written. One
// launch on `stream`; returns 0 or a cudaError_t.
extern "C" int occm_flash_attn_generic_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int b,
    int h, int T, int t_valid, int d, long long q_sb, long long q_st,
    long long q_sh, long long q_sd, long long k_sb, long long k_st,
    long long k_sh, long long k_sd, long long v_sb, long long v_st,
    long long v_sh, long long v_sd, long long do_sb, long long do_st,
    long long do_sh, long long do_sd, float scale, void* stream) {
  if (bad_args(dtype, b, h, T, t_valid, d)) return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_st, q_sh, q_sd}, sk{k_sb, k_st, k_sh, k_sd},
      sv{v_sb, v_st, v_sh, v_sd}, sdo{do_sb, do_st, do_sh, do_sd};
  const int elt = dtype == 0 ? 4 : 2;
  int vec = copy_width(q, sq, d, elt);
  vec = narrower(vec, copy_width(k, sk, d, elt));
  vec = narrower(vec, copy_width(v, sv, d, elt));
  vec = narrower(vec, copy_width(dout, sdo, d, elt));
  return dispatch<Dkv>(dtype, d, q, k, v, dout, lse, delta, dk, dv, b, h, T,
                       t_valid, d, sq, sk, sv, sdo, scale, vec,
                       (cudaStream_t)stream);
}
