// Flash-attention forward for Hopper (sm_90a): bf16 in, fp32 softmax,
// wgmma fed by TMA.
//
// Replaces two TPU Pallas kernels of occm_tpu/ops/attention.py, which compute
// the same function and differ only in how they fit the TPU's VMEM:
//   _fwd_kernel          (attention.py:45)  whole-T forward, T padded <= 512
//   _blocked_fwd_kernel  (attention.py:234) online-softmax forward + lse
// One kernel covers every T: out = softmax(scale * q k^T, keys >= t_valid
// masked to -1e30) v, with
//   - q k^T accumulated in fp32 on the tensor cores from the unscaled bf16 q,
//     and the scale applied to the fp32 logits. For D = 64 the scale is
//     2^-3, so bf16(q * 2^-3) = bf16(q) * 2^-3 exactly and the logits equal
//     those of the TPU kernels (and of the plain version), which fold the
//     scale into q before the bf16 cast;
//   - an online softmax in fp32 over kv tiles of 64 keys, in base 2: the
//     scale and log2(e) are one multiplier and the exponent is exp2f;
//   - the unnormalised probabilities cast to bf16 for the P v product,
//   - P v accumulated in fp32 and divided by the row sum at the end,
//   - out written in bf16 and lse = m + log(max(l, 1e-30)) per row, natural
//     log, in fp32 (flash_attn_bwd.cu reads it).
//
// Layout: q, k, v are [B, T, H, D] with any strides for B, T and H (16-byte
// multiples) and D = 64 contiguous: the projections' output, read where
// they leave it through 4-d TMA maps of (D, H, T, B) with (64, 1, 64, 1)
// boxes. out is written contiguous as [B, T, H, D], so [B, T, H * D] is a
// view of it; lse is [B * H, T] fp32. The [BH, T, D] layout is the case
// B = BH, H = 1.
//
// Block: 64 q rows of one (b, h), 160 threads. Warp 4 is the producer: one
// thread loads the q tile once and the k and v tiles (64 keys x 64 dims,
// 8 KB each) into a ring of kStages stages by TMA, 128-byte swizzle, with
// full/empty mbarriers; TMA zero-fills rows past T. Warps 0-3 are one
// consumer warpgroup:
//   S = q k^T  is 4 wgmma m64n64k16 with q and k as K-major operands, as
//              they are stored;
//   P v        is 4 wgmma m64n64k16 with P from registers (the S accumulator
//              fragment rounded to bf16 is the A fragment, as in
//              FlashAttention-3) and v as an MN-major B operand (the
//              transpose bit), so v is never transposed through shared
//              memory.
// The key mask runs only on a tile that reaches t_valid. Several blocks
// share an SM (about 42 KB of shared memory each, registers capped for
// three), so one block's softmax overlaps another's wgmma. The epilogue
// stages bf16 out through the q tile's shared memory in TMA's swizzle and
// writes it with one TMA store, which clips rows past T.
//
// What bounds it on an H100: at the serving shapes (B*H = 128, T = 299 or
// 599, D = 64) the work is 4*BH*T*T*D flops (2.9 and 11.8 GFLOP) against
// 8*BH*T*D bytes of q, k, v and out (9.8 and 19.6 MB): 3 and 6 us for the
// bytes, 3 and 12 us for the tensor cores. The earlier version of this
// kernel (synchronous loads, mma.sync, v transposed one bf16 at a time
// through shared memory) ran at 6.5 % of the bf16 peak. Tried and not kept:
// issuing the next tile's q k^T before this tile's softmax (two S register
// sets, a 3-stage ring, 122 registers), FlashAttention-3's
// intra-warpgroup overlap, which measured slower at every T on the same
// card. The measured times are in PERF.md.

#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

constexpr int kBM = kTileRows;  // q rows per block: one consumer warpgroup
constexpr int kBN = kTileRows;  // keys per kv tile
constexpr int kStages = 2;      // k/v ring depth
constexpr int kThreads = 160;   // warpgroup 0 computes, warp 4 loads
// q tile, then per stage a k and a v tile, + 1 KB to align the tiles to the
// 128-byte swizzle's 1024-byte period, + the mbarriers
constexpr int kSmem =
    (1 + 2 * kStages) * kTileBytes + 1024 + (2 * kStages + 1) * 8;
constexpr float kMasked = -1e30f;

// grid (ceil(T / 64), H, B)
__global__ void __launch_bounds__(kThreads, 3)
flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap tma_q,
                      const __grid_constant__ CUtensorMap tma_k,
                      const __grid_constant__ CUtensorMap tma_v,
                      const __grid_constant__ CUtensorMap tma_o,
                      float* __restrict__ lse, int T, int t_valid,
                      float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sq = smem;  // the q tile, then the epilogue's out tile
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + (1 + 2 * kStages) * kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (t_valid + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread keeps the ring full
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_full, kTileBytes);
      tma_load_4d(sq, &tma_q, q_full, 0, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        unsigned char* st = smem + (1 + 2 * s) * kTileBytes;
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_4d(st, &tma_k, &full[s], 0, h, j * kBN, b);
        tma_load_4d(st + kTileBytes, &tma_v, &full[s], 0, h, j * kBN, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 16 q rows per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // running max of the unscaled logits and per-thread partial row sums, for
  // rows lane / 4 and lane / 4 + 8 of this warp
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};
  const uint64_t dq = smem_desc(smem_u32(sq));
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int kv0 = j * kBN;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t k_addr = smem_u32(smem + (1 + 2 * s) * kTileBytes);
    const uint64_t dk = smem_desc(k_addr);
    const uint64_t dv = smem_desc(k_addr + kTileBytes);

    // ---- S = q k^T, fp32, unscaled
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)  // +32 bytes along D per k-step
      wgmma_ss(sc, dq + 2 * kk, dk + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    // ---- key mask (last tile only), row max over the tile
    if (kv0 + kBN > t_valid) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kv0 + col(i, lane) >= t_valid) sc[i] = kMasked;
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[row_half(i)] = fmaxf(mx[row_half(i)], sc[i]);
    float alpha[2], m_scaled[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m_run[r] - mx[r]) * scale_log2);
      m_run[r] = mx[r];
      m_scaled[r] = mx[r] * scale_log2;
      l_run[r] *= alpha[r];
    }
    // ---- p = exp(scale * (s - m)), unnormalised, fp32 row sums
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -m_scaled[row_half(i)]));
      l_run[row_half(i)] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[row_half(i)];

    // ---- o += bf16(P) v: the S fragments of key columns 16c .. 16c + 15
    // are the A fragment of k-step c
    uint32_t pa[kBN / 16][4];
    pack_a(pa, sc);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c)  // +16 keys = +2048 bytes per k-step
      wgmma_rs(o, pa[c], dv + 128 * c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: full row sums, normalise, stage bf16 out in the q tile's
  // shared memory (128-byte swizzle), one TMA store; lse per row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  named_bar_sync(1, 128);  // every warp's products are done reading q
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = warp * 16 + (lane >> 2) + 8 * row_half(i);
    const int c = col(i, lane);
    const float l = l_run[row_half(i)];
    *reinterpret_cast<uint32_t*>(sq + swizzled(row, c)) =
        pack_bf16(o[i] / l, o[i + 1] / l);
  }
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (threadIdx.x == 0) {
    tma_store_4d(&tma_o, sq, 0, h, q0, b);
    tma_store_flush();
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < T)
        lse[((size_t)b * gridDim.y + h) * T + row] =
            m_run[r] * scale + logf(fmaxf(l_run[r], 1e-30f));
    }
  }
}

}  // namespace

// q, k, v: [b, T, h, d] bf16, d = 64 contiguous, element strides (sb, st,
// sh) each, multiples of 8, 16-byte aligned; out: [b, T, h, d] bf16
// contiguous; lse: [b * h, T] fp32. Keys at index >= t_valid are masked.
// One launch on `stream`. Returns 0, a cudaError_t, or -1 / -1000 - CUresult
// when a TMA descriptor cannot be made.
extern "C" int occm_flash_attn_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int b, int h, int T,
                                   int t_valid, int d, long long q_sb,
                                   long long q_st, long long q_sh,
                                   long long k_sb, long long k_st,
                                   long long k_sh, long long v_sb,
                                   long long v_st, long long v_sh, float scale,
                                   void* stream) {
  if (d != kD || b <= 0 || b > 65535 || h <= 0 || h > 65535 || T <= 0 ||
      t_valid <= 0 || t_valid > T || bad_strides(q, q_sb, q_st, q_sh) ||
      bad_strides(k, k_sb, k_st, k_sh) || bad_strides(v, v_sb, v_st, v_sh) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  int err = encode_bthd(&mq, q, b, T, h, q_sb, q_st, q_sh);
  if (!err) err = encode_bthd(&mk, k, b, T, h, k_sb, k_st, k_sh);
  if (!err) err = encode_bthd(&mv, v, b, T, h, v_sb, v_st, v_sh);
  if (!err)
    err = encode_bthd(&mo, out, b, T, h, (long long)T * h * kD,
                      (long long)h * kD, kD);
  if (err) return err;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  const dim3 grid((T + kBM - 1) / kBM, h, b);
  flash_attn_fwd_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      mq, mk, mv, mo, (float*)lse, T, t_valid, scale, scale_log2);
  return (int)cudaGetLastError();
}
