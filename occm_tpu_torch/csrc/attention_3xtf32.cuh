// What the 3xTF32 attention backward's two kernels share
// (flash_attn_bwd_3xtf32_dq.cu, flash_attn_bwd_3xtf32_dkv.cu, one nvcc
// each, in parallel): the tile geometry, cp.async tile loads from any
// strides, the two mma.sync product shapes in 3xTF32 (tf32.cuh), the
// accumulator store, and the host side's argument checks and head-dim
// dispatch. The design is in flash_attn_bwd_3xtf32_dq.cu's note.
// Everything has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int kRows = 64;      // the block's own rows
// rows of a streamed tile (keys in dq, q rows in dk/dv), and its n-tiles
constexpr int kStream = 64;
constexpr int kSN = kStream / 8;
// blocks an SM at most (registers: 65536 / (128 threads x blocks))
constexpr int kMaxBlocks = 2;
constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long sb, st, sh, sd;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of kBytes bytes of src to shared dst, of which the first `valid`
// (0 or kBytes) are read and the rest zero-filled
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int valid) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(kBytes), "r"(valid)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows [r0, r0 + R) of one (b, h) slice (base `src`, row stride st,
// dim stride sd) into shared rows of NP + 4 floats, dims [0, NP): dims
// >= D and rows >= T are zero. vec: bytes a cp.async (16, 8, 4), 0 for
// element loads. Issues but does not wait for the copies.
template <int R, int NP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, long long sd, int r0,
                                          int T, int D, int vec) {
  constexpr int LD = NP + 4;
  if (vec == 0) {
    for (int c = threadIdx.x; c < R * NP; c += kThreads) {
      const int r = c / NP, d = c - r * NP, t = r0 + r;
      dst[r * LD + d] = (t < T && d < D) ? src[t * st + d * sd] : 0.f;
    }
    return;
  }
  const int epc = vec / 4;  // floats a copy
  const int per_row = NP / epc;
  for (int c = threadIdx.x; c < R * per_row; c += kThreads) {
    const int r = c / per_row, d = (c - r * per_row) * epc, t = r0 + r;
    const bool ok = t < T && d < D;
    const float* s = ok ? src + t * st + d : src;
    float* o = dst + r * LD + d;
    if (vec == 16)
      cp_async<16>(o, s, ok ? 16 : 0);
    else if (vec == 8)
      cp_async<8>(o, s, ok ? 8 : 0);
    else
      cp_async<4>(o, s, ok ? 4 : 0);
  }
}

// acc[n][.] += A B^T over the head dims for this warp's 16 rows of the own
// tile `a` and the kStream rows of the streamed tile `b` (n-tiles of 8),
// 3xTF32. kScaleB: b's elements are first multiplied by `scale` in fp32
// (q in the dk/dv kernel, stored unscaled).
template <int NP, bool kScaleB = false>
__device__ __forceinline__ void product_rows(float (&acc)[kSN][4],
                                             const float* a, const float* b,
                                             int warp, int lane,
                                             float scale = 1.f) {
  constexpr int LD = NP + 4;
  const int g = lane >> 2, t = lane & 3;
  const float* ar = a + (16 * warp + g) * LD + t;
  const float* br = b + g * LD + t;
  float small[kSN][4];
#pragma unroll
  for (int n = 0; n < kSN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) small[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NP / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32(ar[8 * kk], ah[0], al[0]);
    split_tf32(ar[8 * LD + 8 * kk], ah[1], al[1]);
    split_tf32(ar[8 * kk + 4], ah[2], al[2]);
    split_tf32(ar[8 * LD + 8 * kk + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
      float y0 = br[n * 8 * LD + 8 * kk], y1 = br[n * 8 * LD + 8 * kk + 4];
      if constexpr (kScaleB) y0 *= scale, y1 *= scale;
      uint32_t bh[2], bl[2];
      split_tf32(y0, bh[0], bl[0]);
      split_tf32(y1, bh[1], bl[1]);
      mma_3xtf32(acc[n], small[n], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int n = 0; n < kSN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += small[n][e];
}

// out[n][.] += X V over the kStream streamed rows for this warp's 16 rows:
// X [16 x kStream] is the accumulator fragment of a product_rows (x[c] holds
// columns 8c + 2t, 8c + 2t + 1), V the streamed tile [kStream x NP] (NP / 8
// n-tiles of 8 head dims). k-step c reads A column j from x column
// perm(j) = 2 (j % 4) + j / 4 and B's row j from tile row 8c + perm(j).
// The tile's sum is taken in a fresh accumulator and added to out with an
// fp32 add (tf32.cuh).
template <int NP>
__device__ __forceinline__ void product_cols(float (&out)[NP / 8][4],
                                             const float (&x)[kSN][4],
                                             const float* v, int lane) {
  constexpr int LD = NP + 4;
  const int g = lane >> 2, t = lane & 3;
  const float* vr = v + 2 * t * LD + g;
  float tile[NP / 8][4], small[NP / 8][4];
#pragma unroll
  for (int n = 0; n < NP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[n][e] = small[n][e] = 0.f;
#pragma unroll
  for (int c = 0; c < kSN; ++c) {
    uint32_t ah[4], al[4];
    split_tf32(x[c][0], ah[0], al[0]);  // (g, 2t)
    split_tf32(x[c][2], ah[1], al[1]);  // (g + 8, 2t)
    split_tf32(x[c][1], ah[2], al[2]);  // (g, 2t + 1)
    split_tf32(x[c][3], ah[3], al[3]);  // (g + 8, 2t + 1)
#pragma unroll
    for (int n = 0; n < NP / 8; ++n) {
      uint32_t bh[2], bl[2];
      split_tf32(vr[8 * c * LD + 8 * n], bh[0], bl[0]);
      split_tf32(vr[(8 * c + 1) * LD + 8 * n], bh[1], bl[1]);
      mma_3xtf32(tile[n], small[n], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int n = 0; n < NP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] += tile[n][e] + small[n][e];
}

// Writes this warp's 16 rows x NP accumulator (times `mul`) to a contiguous
// [B, T, H, D] tensor: rows r0 + 16 warp + g (+ 8), columns 8n + 2t (+ 1),
// those past T or D masked (D is a multiple of 8).
template <int NP>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[NP / 8][4],
                                           float mul, int b, int h, int H,
                                           int T, int D, int r0, int warp,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 16 * warp + g + 8 * half;
    if (row >= T) continue;
    float* out = dst + (((long long)b * T + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

template <int NP>
constexpr int smem_bytes() {
  return (2 * kRows + 4 * kStream) * (NP + 4) * 4 + 4 * kRows * 4;
}

// blocks an SM: what 228 KB of shared memory (1 KB a block reserved) and
// kMaxBlocks allow
template <int NP>
constexpr int min_blocks() {
  constexpr int by_smem = 233472 / (smem_bytes<NP>() + 1024);
  return by_smem < kMaxBlocks ? (by_smem < 1 ? 1 : by_smem) : kMaxBlocks;
}


// ---------------------------------------------------------------- host side

// widest cp.async (16, 8, 4 bytes) that a tensor's base address, strides
// and row of D floats allow; 0 (element loads) if the head dim is not
// contiguous or no width fits
int copy_width(const void* p, const Strides& s, int d) {
  if (s.sd != 1) return 0;
  for (int w = 16; w >= 4; w /= 2)
    if (reinterpret_cast<uintptr_t>(p) % w == 0 && (s.sb * 4) % w == 0 &&
        (s.st * 4) % w == 0 && (s.sh * 4) % w == 0 && (d * 4) % w == 0)
      return w;
  return 0;
}

int narrower(int a, int b) { return a < b ? a : b; }

bool bad_args(int b, int h, int T, int t_valid, int d, const void* out) {
  return b <= 0 || b > 65535 || h <= 0 || h > 65535 || T <= 0 ||
         t_valid <= 0 || t_valid > T || d < 8 || d > 128 || d % 8 ||
         (reinterpret_cast<uintptr_t>(out) & 7);
}

template <template <int> class F, typename... Args>
int dispatch(int d, Args... args) {
  switch ((d + 15) / 16 * 16) {
    case 16: return F<16>::run(args...);
    case 32: return F<32>::run(args...);
    case 48: return F<48>::run(args...);
    case 64: return F<64>::run(args...);
    case 80: return F<80>::run(args...);
    case 96: return F<96>::run(args...);
    case 112: return F<112>::run(args...);
    default: return F<128>::run(args...);
  }
}

}  // namespace
