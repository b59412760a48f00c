// Flash-attention forward for Hopper (sm_90a): bf16 in, fp32 softmax,
// wgmma fed by TMA, at every head dim D that is a multiple of 8 from 8 to
// 256.
//
// Replaces two TPU Pallas kernels of occm_tpu/ops/attention.py, which compute
// the same function and differ only in how they fit the TPU's VMEM:
//   _fwd_kernel          (attention.py:45)  whole-T forward, T padded <= 512
//   _blocked_fwd_kernel  (attention.py:234) online-softmax forward + lse
// One kernel covers every T: out = softmax(scale * q k^T, keys >= t_valid
// masked to -1e30) v, with
//   - q k^T accumulated in fp32 on the tensor cores from bf16(q * scale):
//     the TPU kernels (attention.py:64, :253) and the plain version fold
//     the scale into q in fp32 and round to bf16 before the product. The
//     instances at D other than 64 and 256 do the same on the q tile in
//     shared memory (fold_scale). The D = 64 and D = 256 instances keep the
//     unscaled q and scale the fp32 logits: their scales are 2^-3 and 2^-4,
//     so bf16(q * 2^-3) = bf16(q) * 2^-3 exactly and the logits are the
//     same bits;
//   - an online softmax in fp32 over kv tiles of 64 keys, in base 2: the
//     logits' scale and log2(e) are one multiplier and the exponent is
//     exp2f;
//   - the unnormalised probabilities cast to bf16 for the P v product,
//   - P v accumulated in fp32 and divided by the row sum at the end,
//   - out written in bf16 and lse = m + log(max(l, 1e-30)) per row, natural
//     log, in fp32 (flash_attn_bwd.cu reads it).
//
// Layout: q, k, v are [B, T, H, D] with any strides for B, T and H (16-byte
// multiples) and D contiguous: the projections' output, read where they
// leave it through 4-d TMA maps of (D, H, T, B) with (64, 1, 64, 1) boxes,
// one box a 64-column panel (attention_sm90.cuh: ceil(D / 64) panels, the
// columns past D zero-filled). out is written contiguous as [B, T, H, D],
// so [B, T, H * D] is a view of it; lse is [B * H, T] fp32. The [BH, T, D]
// layout is the case B = BH, H = 1.
//
// Block: 64 q rows of one (b, h), 160 threads (up to D 128). Warp 4 is the
// producer: one thread loads the q tile once and the k and v tiles (64
// keys x D) into a ring of kStages stages by TMA, 128-byte swizzle, with
// full/empty mbarriers; TMA zero-fills rows past T. Warps 0-3 are one
// consumer warpgroup (NP = round_up(D, 16)):
//   S = q k^T  is NP / 16 wgmma m64n64k16 with q and k as K-major operands,
//              as they are stored;
//   P v        is 4 wgmma m64nNPk16 with P from registers (the S accumulator
//              fragment rounded to bf16 is the A fragment, as in
//              FlashAttention-3) and v as an MN-major B operand (the
//              transpose bit), so v is never transposed through shared
//              memory; above NP 128 each is two, of N 128 and NP - 128.
// The key mask runs only on a tile that reaches t_valid. Several blocks
// share an SM (about 42 KB of shared memory each at D <= 64, 82 KB at
// D <= 128, registers capped for three, or two above D 64), so one block's
// softmax overlaps another's wgmma. Above D 128 the tiles are three panels
// (24 KB) or four (32 KB), one block fills the SM, and a block is two
// consumer warpgroups of 64 q rows each (128 rows, 384 threads: FwdBlock)
// that share the k/v ring (144 or 192 KB with both q tiles), so that one
// warpgroup's softmax overlaps the other's wgmma and each k/v tile is
// loaded once for 128 rows; each holds the NP / 2 fp32 of its O
// accumulator in up to 240 registers a thread. On an H100 80GB HBM3 at
// 700 W that took the forward at B 8, H 16, T 1500 from 0.75 to 0.47 ms at
// D 136 and from 0.75 to 0.54 ms at D 256 against one warpgroup a block
// (probe_wide_head.py, CUDA events; PERF.md).
// The epilogue stages bf16 out through each warpgroup's q tile's shared
// memory in TMA's swizzle and writes it with one TMA store a panel, which
// clips rows past T and columns past D.
//
// What bounds it on an H100: at the serving shapes (B*H = 128, T = 299 or
// 599, D = 64) the work is 4*BH*T*T*D flops (2.9 and 11.8 GFLOP) against
// 8*BH*T*D bytes of q, k, v and out (9.8 and 19.6 MB): 3 and 6 us for the
// bytes, 3 and 12 us for the tensor cores; both grow with D. The earlier
// version of this kernel (synchronous loads, mma.sync, v transposed one
// bf16 at a time through shared memory) ran at 6.5 % of the bf16 peak.
// Tried and not kept: issuing the next tile's q k^T before this tile's
// softmax (two S register sets, a 3-stage ring, 122 registers),
// FlashAttention-3's intra-warpgroup overlap, which measured slower at
// every T on the same card. The measured times are in PERF.md.

#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

constexpr int kBN = kTileRows;  // keys per kv tile
constexpr int kStages = 2;      // k/v ring depth
constexpr float kMasked = -1e30f;
// consumer warpgroups of a block above D 128 (one below): each takes 64 q
// rows against the one k/v ring
constexpr int kWideGroups = 2;

// The block of the instance for NP: kGroups consumer warpgroups of 64 q
// rows. One group: 160 threads, warp 4 the producer. Two: 384 threads,
// warpgroup 2 the producer's (warp 8 loads, warps 9-11 idle), there for the
// registers: warp w runs on the register-file slice w % 4, so a block of 9
// warps would get 168 registers a thread; with three warpgroups the
// producer's gives its registers up (setmaxnreg) and the consumers take
// 240, as FlashAttention-3 does.
template <int NP>
struct FwdBlock {
  static constexpr int kGroups = HeadDim<NP>::kPanels > 2 ? kWideGroups : 1;
  static constexpr int kThreads = kGroups == 1 ? 160 : 384;
  static constexpr int kRows = kGroups * kTileRows;
  // the q tiles, then per stage a k and a v tile, + 1 KB to align the
  // tiles to the 128-byte swizzle's 1024-byte period, + the mbarriers
  static constexpr int kSmem =
      (kGroups + 2 * kStages) * HeadDim<NP>::kTileBytes + 1024 +
      (2 * kStages + 1) * 8;
  static constexpr int kMinBlocks =
      HeadDim<NP>::kPanels == 1 ? 3 : HeadDim<NP>::kPanels == 2 ? 2 : 1;
};

// grid (ceil(T / (64 * kGroups)), H, B). kFold: the scale is folded into
// the q tile (bf16(q * scale)) and the logits are not scaled; otherwise
// (D 64 and 256 only) the fp32 logits are scaled.
template <int NP, bool kFold>
__global__ void __launch_bounds__(FwdBlock<NP>::kThreads,
                                  FwdBlock<NP>::kMinBlocks)
flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap tma_q,
                      const __grid_constant__ CUtensorMap tma_k,
                      const __grid_constant__ CUtensorMap tma_v,
                      const __grid_constant__ CUtensorMap tma_o,
                      float* __restrict__ lse, int T, int t_valid,
                      float scale, float scale_log2) {
  using HD = HeadDim<NP>;
  constexpr int kTileBytes = HD::kTileBytes;
  constexpr int kGroups = FwdBlock<NP>::kGroups;
  constexpr int kConsumers = 128 * kGroups;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + (kGroups + 2 * kStages) * kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int q0 = blockIdx.x * FwdBlock<NP>::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (t_valid + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kGroups);  // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if constexpr (kGroups > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    // ---- producer: one thread keeps the ring full
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, kGroups * kTileBytes);
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int p = 0; p < HD::kPanels; ++p)
          tma_load_4d(smem + g * kTileBytes + p * kPanelBytes, &tma_q,
                      q_full, p * kPanelCols, h, q0 + g * kTileRows, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        unsigned char* st = smem + (kGroups + 2 * s) * kTileBytes;
        mbar_expect_tx(&full[s], 2 * kTileBytes);
#pragma unroll
        for (int p = 0; p < HD::kPanels; ++p) {
          tma_load_4d(st + p * kPanelBytes, &tma_k, &full[s], p * kPanelCols,
                      h, j * kBN, b);
          tma_load_4d(st + kTileBytes + p * kPanelBytes, &tma_v, &full[s],
                      p * kPanelCols, h, j * kBN, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup g: 64 q rows, 16 per warp
  if constexpr (kGroups > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int g = kGroups == 1 ? 0 : threadIdx.x >> 7;
  const int gtid = kGroups == 1 ? threadIdx.x : threadIdx.x & 127;
  const int bar = 1 + g;  // the group's named barrier
  const int row0 = q0 + g * kTileRows;
  unsigned char* sq = smem + g * kTileBytes;  // q, then the out tile
  const int warp = gtid >> 5;
  const int lane = threadIdx.x & 31;
  float o[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) o[i] = 0.f;
  // running max of the logits and per-thread partial row sums, for rows
  // lane / 4 and lane / 4 + 8 of this warp
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};
  const uint64_t dq = smem_desc(smem_u32(sq));
  mbar_wait(q_full, 0);
  if constexpr (kFold) {
    fold_scale<NP>(sq, scale, gtid, 128);
    fence_proxy_async();
    named_bar_sync(bar, 128);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int kv0 = j * kBN;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t k_addr =
        smem_u32(smem + (kGroups + 2 * s) * kTileBytes);
    const uint64_t dk = smem_desc(k_addr);
    const uint64_t dv = smem_desc(k_addr + kTileBytes, HD::kLbo);

    // ---- S = q k^T, fp32, the logits unscaled (or from the folded q)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD::kKSteps; ++kk)  // +32 bytes along D per k-step
      wgmma_ss(sc, dq + kstep(kk), dk + kstep(kk));
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
    for (int i = 0; i < NP / 2; ++i) o[i] *= alpha[row_half(i)];

    // ---- o += bf16(P) v: the S fragments of key columns 16c .. 16c + 15
    // are the A fragment of k-step c
    uint32_t pa[kBN / 16][4];
    pack_a(pa, sc);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c)  // +16 keys = +2048 bytes per k-step
      wgmma_rs_np<NP>(o, pa[c], dv + 128 * c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: full row sums, normalise, stage bf16 out in the q tile's
  // shared memory (128-byte swizzle), one TMA store a panel; lse per row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  named_bar_sync(bar, 128);  // every warp's products are done reading q
  if constexpr (NP > kPanelCols) {
#pragma unroll
    for (int i = 0; i < NP / 2; i += 2) {
      const float l = l_run[row_half(i)];
      *reinterpret_cast<uint32_t*>(sq + fragment_offset(i, warp, lane)) =
          pack_bf16(o[i] / l, o[i + 1] / l);
    }
  } else {  // one panel: the D = 64 kernel's arithmetic as it was
#pragma unroll
    for (int i = 0; i < NP / 2; i += 2) {
      const int row = warp * 16 + (lane >> 2) + 8 * row_half(i);
      const int c = col(i, lane);
      const float l = l_run[row_half(i)];
      *reinterpret_cast<uint32_t*>(sq + swizzled(row, c)) =
          pack_bf16(o[i] / l, o[i + 1] / l);
    }
  }
  fence_proxy_async();
  named_bar_sync(bar, 128);
  if (gtid == 0) {
#pragma unroll
    for (int p = 0; p < HD::kPanels; ++p)
      tma_store_4d(&tma_o, sq + p * kPanelBytes, p * kPanelCols, h, row0, b);
    tma_store_flush();
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < T)
        lse[((size_t)b * gridDim.y + h) * T + row] =
            (kFold ? m_run[r] : m_run[r] * scale) +
            logf(fmaxf(l_run[r], 1e-30f));
    }
  }
}

// One launch of the instance for NP, kFold.
template <int NP, bool kFold>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const CUtensorMap& mo, float* lse, int b,
           int h, int T, int t_valid, float scale, cudaStream_t stream) {
  using Block = FwdBlock<NP>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_fwd_kernel<NP, kFold>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Block::kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  // the logits' multiplier in base 2: scale * log2(e), or log2(e) alone
  // where the scale is folded into q
  const float scale_log2 =
      (float)((double)(kFold ? 1.f : scale) * 1.4426950408889634);
  const dim3 grid((T + Block::kRows - 1) / Block::kRows, h, b);
  flash_attn_fwd_kernel<NP, kFold>
      <<<grid, Block::kThreads, Block::kSmem, stream>>>(
          mq, mk, mv, mo, lse, T, t_valid, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [b, T, h, d] bf16, d a multiple of 8 from 8 to 256 and
// contiguous, element strides (sb, st, sh) each, multiples of 8, 16-byte
// aligned; out: [b, T, h, d] bf16 contiguous; lse: [b * h, T] fp32. Keys at
// index >= t_valid are masked. One launch on `stream` of the instance for
// round_up(d, 16): fold != 0 folds the scale into q, fold = 0 (taken at
// d 64 and 256 only, where the bits are the same) scales the logits.
// Returns 0, a cudaError_t, or -1 / -1000 - CUresult when a TMA descriptor
// cannot be made.
extern "C" int occm_flash_attn_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int b, int h, int T,
                                   int t_valid, int d, long long q_sb,
                                   long long q_st, long long q_sh,
                                   long long k_sb, long long k_st,
                                   long long k_sh, long long v_sb,
                                   long long v_st, long long v_sh, float scale,
                                   void* stream, int fold) {
  if (!head_dim_ok(d) || (!fold && !logits_instance(d)) || b <= 0 ||
      b > 65535 || h <= 0 || h > 65535 ||
      T <= 0 || t_valid <= 0 || t_valid > T ||
      bad_strides(q, q_sb, q_st, q_sh) || bad_strides(k, k_sb, k_st, k_sh) ||
      bad_strides(v, v_sb, v_st, v_sh) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  int err = encode_bthd(&mq, q, b, T, h, d, q_sb, q_st, q_sh);
  if (!err) err = encode_bthd(&mk, k, b, T, h, d, k_sb, k_st, k_sh);
  if (!err) err = encode_bthd(&mv, v, b, T, h, d, v_sb, v_st, v_sh);
  if (!err)
    err = encode_bthd(&mo, out, b, T, h, d, (long long)T * h * d,
                      (long long)h * d, d);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  return for_instance(d, fold, [&](auto np, auto folded) {
    return launch<decltype(np)::value, decltype(folded)::value>(
        mq, mk, mv, mo, (float*)lse, b, h, T, t_valid, scale, s);
  });
}
