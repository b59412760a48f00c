// Flash-attention backward for Hopper (sm_90a): two kernels, wgmma fed by
// TMA, no atomics, at every head dim D that is a multiple of 8 from 8 to
// 256.
//
// Replaces three TPU Pallas kernels of occm_tpu/ops/attention.py:
//   _bwd_kernel          (attention.py:79)   whole-T backward, T padded <= 512
//   _blocked_dq_kernel   (attention.py:350)  dq over a kv sweep (+ _blocked_p_ds)
//   _blocked_dkv_kernel  (attention.py:373)  dk, dv over a q sweep
// One pair covers every T, fed by the lse the forward kernel
// (flash_attn_fwd.cu) writes. The arithmetic is the blocked TPU route's:
//   - S = q k^T accumulated in fp32 from bf16(q * scale), the scale folded
//     into q in fp32 before the bf16 cast (attention.py:338). The instances
//     at D other than 64 and 256 fold it: the dq kernel on its q tile in
//     shared memory, and it writes that tile to a [B, T, H, D] scratch
//     tensor qs, which the dk/dv kernel loads beside the unscaled q. The
//     D = 64 and D = 256 instances keep the unscaled q and scale the fp32
//     logits, which gives the same bits because their scales are 2^-3 and
//     2^-4 (flash_attn_fwd.cu's header);
//   - P = exp(S - lse) in fp32 (base 2: one multiplier and exp2f),
//     keys >= t_valid get P = 0;
//   - dS = P * (dO v^T - delta), delta = rowsum(dO * O) in fp32;
//   - P and dS cast to bf16 before their products, fp32 accumulation;
//   - dq = scale * dS k and dk = scale * dS^T q (the unscaled q), dv = P^T dO.
//
// Layout: q, k, v, out and dO are [B, T, H, D] bf16 with any strides for
// B, T and H (16-byte multiples), read where they lie through 4-d TMA maps
// (64 x 64 boxes of one (b, h), one a panel: attention_sm90.cuh), as the
// forward reads q, k, v. dq, dk, dv (and qs) are written contiguous as
// [B, T, H, D] by TMA stores, which clip rows past T and columns past D, so
// [B, T, H * D] is a view of each. lse and delta are [B * H, T] fp32.
// [BH, T, D] is the case B = BH, H = 1.
//
// Both kernels: 160 threads, warp 4 the producer (TMA into a ring of
// kStages stages, 128-byte swizzle, full/empty mbarriers; TMA zero-fills
// rows past T and columns past D), warps 0-3 one consumer warpgroup on
// wgmma (NP = round_up(D, 16): products over D are NP / 16 k-steps of
// m64n64k16, products whose N is D are m64nNPk16, two above NP 128), each
// product straight from the TMA tiles, none transposed through shared
// memory. Above D 128 the dk/dv kernel is another (flash_attn_bwd_dkv_wide_
// kernel, below): two consumer warpgroups.
//
// dq kernel, grid (ceil(T / 64), H, B): 64 q rows, a loop over 64-key
// tiles. The producer loads the q, dO and out tiles once and k, v per tile.
// Before the loop the warpgroup computes delta of its 64 rows from the dO
// and out tiles and writes it to the delta buffer (the dk/dv kernel, next
// on the stream, reads it there); at D != 64 it folds the scale into the q
// tile and stores that tile to qs. Per tile:
//   S = q k^T, dP = dO v^T   both operands K-major, as stored; issued as two
//                            groups, so exp(S) runs while dP is computed;
//   dq += dS k               dS the register A operand (the S fragment,
//                            rounded), k an MN-major B operand (the
//                            transpose bit), as the forward feeds P and v.
// dk/dv kernel, grid (ceil(T / 64), H, B): 64 keys, a loop over 64-row q
// tiles. The producer loads the k and v tiles once, and per tile the q and
// dO tiles (and the qs tile at D != 64) by TMA while its 32 lanes copy the
// tile's lse (times log2 e; +inf past T, so those rows get P = 0) and delta
// into the stage with ordinary loads (TMA needs 16-byte aligned rows, and a
// [B * H, T] fp32 row of T = 299 is not). Per tile:
//   S^T = k qs^T, dP^T = v dO^T  all K-major (qs: q at D = 64);
//   P^T = exp(S^T - lse[col]), dS^T = P^T * (dP^T - delta[col]);
//   dv += P^T dO, dk += dS^T q   P^T and dS^T register A operands, dO and q
//                                MN-major B operands.
// Each block owns its rows of dq, or of dk and dv: no atomics, and a
// repeat gives the same bits. S and dP are computed in both kernels (7
// products where one kernel with atomic dq would do 5): that keeps them
// deterministic, and at the training shape the work is bound by bytes.
//
// Above D 64 a tile is two panels (16 KB): the dq kernel's 7 tiles and the
// dk/dv kernel's 8 (q, qs and dO in each of two stages) leave room for one
// block an SM, which then holds the dk and dv accumulators (2 x NP / 2
// fp32 registers a thread) with up to 255 registers; ptxas's report of
// registers and spills is in chip_smoke.py's build lines.
//
// Above D 128 a tile is three panels (24 KB) or four (32 KB). The dq
// kernel's 7 tiles take 169 or 225 KB, one block an SM with up to 255
// registers for its NP / 2 accumulator. The dk/dv accumulators (NP fp32
// registers a thread, 256 at D 256) do not fit one warpgroup, so the wide
// dk/dv kernel splits the work between two: warpgroup 0 computes S^T, P^T
// and dv += P^T dO, warpgroup 1 S^T, dP^T, dS^T and dk += dS^T q, each with
// its own NP / 2 accumulator; S^T is computed by both (5 products a tile
// where 4 would do) rather than handed across through shared memory. Its
// ring holds two stages where they fit in 227 KB (three panels, or four
// with the scale on the logits at D 256: q and dO alone) and one where
// they do not (four panels and the qs tile, D 200-248).
//
// What bounds it on an H100: at the training shape (B*H = 192, T = 299,
// D = 64) the five products are 1.1e10 flop (11 us at the bf16 peak; the
// two recomputed ones make 1.5e10) against 5.9e7 bytes of q, k, v, out, dO
// read and dq, dk, dv written once (18 us); at T >= 599 the products bound
// it. Both grow with D. The qs scratch of the instances at D != 64 adds
// one write and T / 64 reads of B*T*H*D bf16 through the L2. The measured
// times are in PERF.md.

#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

constexpr int kStages = 2;      // ring depth of the streamed tiles
constexpr int kThreads = 160;   // warpgroup 0 computes, warp 4 loads
constexpr float kLog2e = 1.4426950408889634f;
// dq kernel: q, dO, out tiles, then per stage a k and a v tile, + 1 KB to
// align the tiles to the 128-byte swizzle's 1024-byte period, + mbarriers
constexpr int kDqTiles = 3 + 2 * kStages;
template <int NP>
constexpr int dq_smem() {
  return kDqTiles * HeadDim<NP>::kTileBytes + 1024 + (2 * kStages + 1) * 8;
}
// dk/dv kernel: k, v tiles, per stage a q and a dO tile (and a qs tile
// when the scale is folded), per stage the tile's lse * log2 e and delta
// (64 + 64 fp32), + mbarriers
constexpr int kStatFloats = 2 * kTileRows;
template <bool kFold>
struct DkvStage {
  static constexpr int kTiles = kFold ? 3 : 2;
};
template <int NP, bool kFold>
constexpr int dkv_smem() {
  return (2 + kStages * DkvStage<kFold>::kTiles) * HeadDim<NP>::kTileBytes +
         1024 + kStages * kStatFloats * 4 + (2 * kStages + 1) * 8;
}

// kFold: the scale is folded into the q tile and the logits are not scaled
// (tma_qs: where the folded tile is stored); otherwise (D 64 and 256 only)
// the fp32 logits are scaled and tma_qs is unused.
template <int NP, bool kFold>
__global__ void __launch_bounds__(kThreads, HeadDim<NP>::kPanels <= 2 ? 2 : 1)
flash_attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tma_q,
                         const __grid_constant__ CUtensorMap tma_k,
                         const __grid_constant__ CUtensorMap tma_v,
                         const __grid_constant__ CUtensorMap tma_o,
                         const __grid_constant__ CUtensorMap tma_do,
                         const __grid_constant__ CUtensorMap tma_dq,
                         const float* __restrict__ lse,
                         float* __restrict__ delta, int T, int t_valid,
                         float scale, float scale_log2,
                         const __grid_constant__ CUtensorMap tma_qs) {
  using HD = HeadDim<NP>;
  constexpr int kTileBytes = HD::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sq = smem;
  unsigned char* sdo = smem + kTileBytes;
  unsigned char* so = smem + 2 * kTileBytes;  // out, then the dq tile
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDqTiles * kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* head_full = empty + kStages;

  const int q0 = blockIdx.x * kTileRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_base = ((size_t)b * gridDim.y + h) * T;
  const int n_tiles = (t_valid + kTileRows - 1) / kTileRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    mbar_init(head_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread loads the block's tiles, then keeps the
    // k/v ring full
    if (threadIdx.x == 128) {
      mbar_expect_tx(head_full, 3 * kTileBytes);
#pragma unroll
      for (int p = 0; p < HD::kPanels; ++p) {
        const int c0 = p * kPanelCols, off = p * kPanelBytes;
        tma_load_4d(sq + off, &tma_q, head_full, c0, h, q0, b);
        tma_load_4d(sdo + off, &tma_do, head_full, c0, h, q0, b);
        tma_load_4d(so + off, &tma_o, head_full, c0, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        unsigned char* st = smem + (3 + 2 * s) * kTileBytes;
        mbar_expect_tx(&full[s], 2 * kTileBytes);
#pragma unroll
        for (int p = 0; p < HD::kPanels; ++p) {
          const int c0 = p * kPanelCols, off = p * kPanelBytes;
          tma_load_4d(st + off, &tma_k, &full[s], c0, h, j * kTileRows, b);
          tma_load_4d(st + kTileBytes + off, &tma_v, &full[s], c0, h,
                      j * kTileRows, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: 16 q rows per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // lse * log2 e of this thread's fragment rows lane / 4 (+ 8); rows past T
  // are never stored
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = row < T ? lse[row_base + row] * kLog2e : INFINITY;
  }
  mbar_wait(head_full, 0);
  if constexpr (kFold) {
    // bf16(q * scale) in place, then to qs for the dk/dv kernel
    fold_scale<NP>(sq, scale, threadIdx.x, 128);
    fence_proxy_async();
    named_bar_sync(1, 128);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < HD::kPanels; ++p)
        tma_store_4d(&tma_qs, sq + p * kPanelBytes, p * kPanelCols, h, q0, b);
      tma_store_commit();  // waited for with the dq store
    }
  }

  // ---- delta = rowsum(dO * out) in fp32: lanes 2i and 2i + 1 of a warp
  // sum the two halves of its row 16 * warp + i (the columns past D are
  // zero); each thread then takes the deltas of its fragment rows from the
  // lanes that hold them
  float dl[2];
  {
    const int row = warp * 16 + (lane >> 1);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * HD::kPanels; ++j) {
      const int off =
          tile_offset(row, ((lane & 1) * 4 * HD::kPanels + j) * 8);
      const uint4 a = *reinterpret_cast<const uint4*>(sdo + off);
      const uint4 c = *reinterpret_cast<const uint4*>(so + off);
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(pa[e]);
        const float2 y = __bfloat1622float2(pc[e]);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((lane & 1) == 0 && q0 + row < T) delta[row_base + q0 + row] = sum;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      dl[r] = __shfl_sync(0xffffffffu, sum, 2 * (lane >> 2) + 16 * r);
  }

  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  const uint64_t d_q = smem_desc(smem_u32(sq));
  const uint64_t d_do = smem_desc(smem_u32(sdo));

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int kv0 = j * kTileRows;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t k_addr = smem_u32(smem + (3 + 2 * s) * kTileBytes);
    const uint64_t d_k = smem_desc(k_addr);
    const uint64_t d_kt = smem_desc(k_addr, HD::kLbo);  // k MN-major
    const uint64_t d_v = smem_desc(k_addr + kTileBytes);

    // ---- S = q k^T and dP = dO v^T, fp32, two groups
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_acc(sc);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD::kKSteps; ++kk)  // +32 bytes along D per k-step
      wgmma_ss(sc, d_q + kstep(kk), d_k + kstep(kk));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD::kKSteps; ++kk)
      wgmma_ss(dp, d_do + kstep(kk), d_v + kstep(kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sc);

    // ---- P = exp(S - lse), keys >= t_valid masked (last tile only)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse2[row_half(i)]));
    if (kv0 + kTileRows > t_valid) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kv0 + col(i, lane) >= t_valid) sc[i] = 0.f;
    }
    wgmma_wait<0>();
    fence_acc(dp);

    // ---- dS = P (dP - delta); dq += bf16(dS) k
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - dl[row_half(i)];
    uint32_t da[kTileRows / 16][4];
    pack_a(da, sc);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kTileRows / 16; ++c)  // +16 keys = +2048 bytes
      wgmma_rs_np<NP>(acc, da[c], d_kt + 128 * c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: dq * scale in bf16, staged in the out tile's shared
  // memory (128-byte swizzle), one TMA store a panel that clips rows past T
  named_bar_sync(1, 128);  // every warp is done reading the out tile
  stage_tile<NP>(so, acc, scale, warp, lane);
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < HD::kPanels; ++p)
      tma_store_4d(&tma_dq, so + p * kPanelBytes, p * kPanelCols, h, q0, b);
    tma_store_flush();
  }
}

template <int NP, bool kFold>
__global__ void __launch_bounds__(kThreads, HeadDim<NP>::kPanels == 1 ? 2 : 1)
flash_attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tma_q,
                          const __grid_constant__ CUtensorMap tma_k,
                          const __grid_constant__ CUtensorMap tma_v,
                          const __grid_constant__ CUtensorMap tma_do,
                          const __grid_constant__ CUtensorMap tma_dk,
                          const __grid_constant__ CUtensorMap tma_dv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int T, int t_valid,
                          float scale, float scale_log2,
                          const __grid_constant__ CUtensorMap tma_qs) {
  using HD = HeadDim<NP>;
  constexpr int kTileBytes = HD::kTileBytes;
  constexpr int kStageTiles = DkvStage<kFold>::kTiles;
  constexpr int kDkvTiles = 2 + kStages * kStageTiles;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sk = smem;  // k, then the dk tile
  unsigned char* sv = smem + kTileBytes;  // v, then the dv tile
  // per stage: lse * log2 e of the tile's 64 q rows, then their delta
  float* stat = reinterpret_cast<float*>(smem + kDkvTiles * kTileBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(stat + kStages * kStatFloats);
  uint64_t* empty = full + kStages;
  uint64_t* head_full = empty + kStages;

  const int k0 = blockIdx.x * kTileRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_base = ((size_t)b * gridDim.y + h) * T;
  const int n_tiles = (T + kTileRows - 1) / kTileRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the 32 producer lanes' arrivals after their lse/delta stores, and
      // lane 0's arrival with the TMA byte count
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    mbar_init(head_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: lane 0 issues the TMA loads, every lane copies
    // two rows of lse and delta
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_expect_tx(head_full, 2 * kTileBytes);
#pragma unroll
      for (int p = 0; p < HD::kPanels; ++p) {
        const int c0 = p * kPanelCols, off = p * kPanelBytes;
        tma_load_4d(sk + off, &tma_k, head_full, c0, h, k0, b);
        tma_load_4d(sv + off, &tma_v, head_full, c0, h, k0, b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int r0 = j * kTileRows;
      mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
      if (lane == 0) {
        unsigned char* st = smem + (2 + kStageTiles * s) * kTileBytes;
        mbar_expect_tx(&full[s], kStageTiles * kTileBytes);
#pragma unroll
        for (int p = 0; p < HD::kPanels; ++p) {
          const int c0 = p * kPanelCols, off = p * kPanelBytes;
          tma_load_4d(st + off, &tma_q, &full[s], c0, h, r0, b);
          tma_load_4d(st + kTileBytes + off, &tma_do, &full[s], c0, h, r0, b);
          if constexpr (kFold)
            tma_load_4d(st + 2 * kTileBytes + off, &tma_qs, &full[s], c0, h,
                        r0, b);
        }
      }
      float* st_stat = stat + s * kStatFloats;
#pragma unroll
      for (int i = 0; i < kTileRows / 32; ++i) {
        const int r = lane + 32 * i;
        const bool in = r0 + r < T;
        st_stat[r] = in ? lse[row_base + r0 + r] * kLog2e : INFINITY;
        st_stat[kTileRows + r] = in ? delta[row_base + r0 + r] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroup: 16 keys per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_ok[r] = k0 + warp * 16 + (lane >> 2) + 8 * r < t_valid;
  const bool all_keys_ok = key_ok[0] && key_ok[1];
  float acc_k[NP / 2], acc_v[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  mbar_wait(head_full, 0);
  const uint64_t d_k = smem_desc(smem_u32(sk));
  const uint64_t d_v = smem_desc(smem_u32(sv));

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t q_addr =
        smem_u32(smem + (2 + kStageTiles * s) * kTileBytes);
    const uint64_t d_q = smem_desc(q_addr, HD::kLbo);  // q MN-major
    const uint64_t d_do = smem_desc(q_addr + kTileBytes);
    const uint64_t d_dot = smem_desc(q_addr + kTileBytes, HD::kLbo);
    // S^T's q: the folded qs tile, or q (scale on the logits)
    const uint64_t d_qs =
        smem_desc(kFold ? q_addr + 2 * kTileBytes : q_addr);
    const float* st_stat = stat + s * kStatFloats;

    // ---- S^T = k q^T and dP^T = v dO^T, fp32, two groups
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_acc(sc);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD::kKSteps; ++kk)
      wgmma_ss(sc, d_k + kstep(kk), d_qs + kstep(kk));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD::kKSteps; ++kk)
      wgmma_ss(dp, d_v + kstep(kk), d_do + kstep(kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sc);

    // ---- P^T = exp(S^T - lse[col]); keys >= t_valid masked
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 l =
          *reinterpret_cast<const float2*>(st_stat + col(i, lane));
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -l.x));
      sc[i + 1] = exp2f(fmaf(sc[i + 1], scale_log2, -l.y));
    }
    if (!all_keys_ok) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!key_ok[row_half(i)]) sc[i] = 0.f;
    }
    uint32_t pa[kTileRows / 16][4];
    pack_a(pa, sc);
    wgmma_wait<0>();
    fence_acc(dp);

    // ---- dS^T = P^T (dP^T - delta[col])
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 d = *reinterpret_cast<const float2*>(
          st_stat + kTileRows + col(i, lane));
      dp[i] = sc[i] * (dp[i] - d.x);
      dp[i + 1] = sc[i + 1] * (dp[i + 1] - d.y);
    }
    uint32_t da[kTileRows / 16][4];
    pack_a(da, dp);

    // ---- dv += bf16(P^T) dO, dk += bf16(dS^T) q
    fence_acc(acc_v);
    fence_acc(acc_k);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kTileRows / 16; ++c)  // +16 q rows = +2048 bytes
      wgmma_rs<NP>(acc_v, pa[c], d_dot + 128 * c);
#pragma unroll
    for (int c = 0; c < kTileRows / 16; ++c)
      wgmma_rs<NP>(acc_k, da[c], d_q + 128 * c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_v);
    fence_acc(acc_k);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: dk * scale and dv in bf16, staged in the k and v tiles'
  // shared memory, TMA stores (one a panel) that clip rows past T
  named_bar_sync(1, 128);  // every warp's products are done reading k, v
  stage_tile<NP>(sk, acc_k, scale, warp, lane);
  stage_tile<NP>(sv, acc_v, 1.f, warp, lane);
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < HD::kPanels; ++p) {
      const int c0 = p * kPanelCols, off = p * kPanelBytes;
      tma_store_4d(&tma_dk, sk + off, c0, h, k0, b);
      tma_store_4d(&tma_dv, sv + off, c0, h, k0, b);
    }
    tma_store_flush();
  }
}

// The dk/dv kernel above NP 128: 384 threads, warp 8 the producer (as the
// kernel above: k and v once, per stage the q, dO (and qs) tiles by TMA and
// the tile's lse * log2 e and delta by its 32 lanes), warpgroup 0 dv and
// warpgroup 1 dk, each over the block's 64 keys (16 a warp). The
// producer's warpgroup (warps 9-11 idle) is there for the registers: an
// SM's register file is four slices, one a warp scheduler, and warp w runs
// on slice w % 4, so a block of 9 warps gets 168 registers a thread (three
// warps on one slice); with three warpgroups the producer's gives its
// registers up (setmaxnreg, down to 24) and the consumers take 240, as
// FlashAttention-3 does. Per q tile:
//   both:         S^T = k qs^T, P^T = exp(S^T - lse[col]), keys masked;
//   warpgroup 0:  dv += P^T dO         (P^T the register A operand);
//   warpgroup 1:  dP^T = v dO^T, dS^T = P^T (dP^T - delta[col]),
//                 dk += dS^T q         (dS^T the register A operand).
// The epilogue stages dv in the v tile and dk * scale in the k tile once
// both warpgroups are done reading them.
constexpr int kWideThreads = 384;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may take
// k and v, per stage the q, dO (and qs) tiles and the tile's lse and
// delta, + 1 KB of alignment, + mbarriers
template <int NP, bool kFold>
constexpr int dkv_wide_smem(int stages) {
  return (2 + stages * DkvStage<kFold>::kTiles) * HeadDim<NP>::kTileBytes +
         1024 + stages * kStatFloats * 4 + (2 * stages + 1) * 8;
}
template <int NP, bool kFold>
struct DkvWide {
  static constexpr int kStageTiles = DkvStage<kFold>::kTiles;
  static constexpr int kStages =
      dkv_wide_smem<NP, kFold>(2) <= kMaxSmem ? 2 : 1;
  static constexpr int kSmem = dkv_wide_smem<NP, kFold>(kStages);
  static_assert(kSmem <= kMaxSmem, "one stage must fit");
};

template <int NP, bool kFold>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_attn_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tma_q,
                               const __grid_constant__ CUtensorMap tma_k,
                               const __grid_constant__ CUtensorMap tma_v,
                               const __grid_constant__ CUtensorMap tma_do,
                               const __grid_constant__ CUtensorMap tma_dk,
                               const __grid_constant__ CUtensorMap tma_dv,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, int T,
                               int t_valid, float scale, float scale_log2,
                               const __grid_constant__ CUtensorMap tma_qs) {
  using HD = HeadDim<NP>;
  using W = DkvWide<NP, kFold>;
  constexpr int kTileBytes = HD::kTileBytes;
  constexpr int kRing = W::kStages;
  constexpr int kStageTiles = W::kStageTiles;
  constexpr int kDkvTiles = 2 + kRing * kStageTiles;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sk = smem;  // k, then the dk tile
  unsigned char* sv = smem + kTileBytes;  // v, then the dv tile
  float* stat = reinterpret_cast<float*>(smem + kDkvTiles * kTileBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(stat + kRing * kStatFloats);
  uint64_t* empty = full + kRing;
  uint64_t* head_full = empty + kRing;

  const int k0 = blockIdx.x * kTileRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_base = ((size_t)b * gridDim.y + h) * T;
  const int n_tiles = (T + kTileRows - 1) / kTileRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 33);  // 32 producer lanes + lane 0's TMA bytes
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(head_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: warp 8 loads, warps 9-11 only give their
    // registers up
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x >= 288) return;
    const int lane = threadIdx.x - 256;
    if (lane == 0) {
      mbar_expect_tx(head_full, 2 * kTileBytes);
#pragma unroll
      for (int p = 0; p < HD::kPanels; ++p) {
        const int c0 = p * kPanelCols, off = p * kPanelBytes;
        tma_load_4d(sk + off, &tma_k, head_full, c0, h, k0, b);
        tma_load_4d(sv + off, &tma_v, head_full, c0, h, k0, b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kRing;
      const int r0 = j * kTileRows;
      mbar_wait(&empty[s], ((j / kRing) & 1) ^ 1);
      if (lane == 0) {
        unsigned char* st = smem + (2 + kStageTiles * s) * kTileBytes;
        mbar_expect_tx(&full[s], kStageTiles * kTileBytes);
#pragma unroll
        for (int p = 0; p < HD::kPanels; ++p) {
          const int c0 = p * kPanelCols, off = p * kPanelBytes;
          tma_load_4d(st + off, &tma_q, &full[s], c0, h, r0, b);
          tma_load_4d(st + kTileBytes + off, &tma_do, &full[s], c0, h, r0, b);
          if constexpr (kFold)
            tma_load_4d(st + 2 * kTileBytes + off, &tma_qs, &full[s], c0, h,
                        r0, b);
        }
      }
      float* st_stat = stat + s * kStatFloats;
#pragma unroll
      for (int i = 0; i < kTileRows / 32; ++i) {
        const int r = lane + 32 * i;
        const bool in = r0 + r < T;
        st_stat[r] = in ? lse[row_base + r0 + r] * kLog2e : INFINITY;
        st_stat[kTileRows + r] = in ? delta[row_base + r0 + r] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroups 0 (dv) and 1 (dk): 16 keys per warp
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const bool dk_group = threadIdx.x >= 128;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_ok[r] = k0 + warp * 16 + (lane >> 2) + 8 * r < t_valid;
  const bool all_keys_ok = key_ok[0] && key_ok[1];
  float acc[NP / 2];  // dv, or dk
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  mbar_wait(head_full, 0);
  const uint64_t d_k = smem_desc(smem_u32(sk));
  const uint64_t d_v = smem_desc(smem_u32(sv));

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kRing;
    mbar_wait(&full[s], (j / kRing) & 1);
    const uint32_t q_addr =
        smem_u32(smem + (2 + kStageTiles * s) * kTileBytes);
    // S^T's q: the folded qs tile, or q (scale on the logits)
    const uint64_t d_qs =
        smem_desc(kFold ? q_addr + 2 * kTileBytes : q_addr);
    const float* st_stat = stat + s * kStatFloats;

    // ---- S^T = k q^T (and, in warpgroup 1, dP^T = v dO^T), fp32
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD::kKSteps; ++kk)
      wgmma_ss(sc, d_k + kstep(kk), d_qs + kstep(kk));
    wgmma_commit();
    if (!dk_group) {
      wgmma_wait<0>();
      fence_acc(sc);
      // ---- P^T = exp(S^T - lse[col]); keys >= t_valid masked
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 l =
            *reinterpret_cast<const float2*>(st_stat + col(i, lane));
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -l.x));
        sc[i + 1] = exp2f(fmaf(sc[i + 1], scale_log2, -l.y));
      }
      if (!all_keys_ok) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (!key_ok[row_half(i)]) sc[i] = 0.f;
      }
      uint32_t pa[kTileRows / 16][4];
      pack_a(pa, sc);
      // ---- dv += bf16(P^T) dO, dO an MN-major B operand
      const uint64_t d_dot = smem_desc(q_addr + kTileBytes, HD::kLbo);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kTileRows / 16; ++c)  // +16 q rows = +2048 bytes
        wgmma_rs_np<NP>(acc, pa[c], d_dot + 128 * c);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    } else {
      float dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = 0.f;
      fence_acc(dp);
      wgmma_fence();  // dp's registers were written after the first fence
      const uint64_t d_do = smem_desc(q_addr + kTileBytes);
#pragma unroll
      for (int kk = 0; kk < HD::kKSteps; ++kk)
        wgmma_ss(dp, d_v + kstep(kk), d_do + kstep(kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(sc);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 l =
            *reinterpret_cast<const float2*>(st_stat + col(i, lane));
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -l.x));
        sc[i + 1] = exp2f(fmaf(sc[i + 1], scale_log2, -l.y));
      }
      if (!all_keys_ok) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (!key_ok[row_half(i)]) sc[i] = 0.f;
      }
      wgmma_wait<0>();
      fence_acc(dp);
      // ---- dS^T = P^T (dP^T - delta[col]); dk += bf16(dS^T) q, q an
      // MN-major B operand
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 d = *reinterpret_cast<const float2*>(
            st_stat + kTileRows + col(i, lane));
        dp[i] = sc[i] * (dp[i] - d.x);
        dp[i + 1] = sc[i + 1] * (dp[i + 1] - d.y);
      }
      uint32_t da[kTileRows / 16][4];
      pack_a(da, dp);
      const uint64_t d_q = smem_desc(q_addr, HD::kLbo);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kTileRows / 16; ++c)
        wgmma_rs_np<NP>(acc, da[c], d_q + 128 * c);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: dv in the v tile, dk * scale in the k tile (bf16), once
  // both warpgroups are done reading k and v; TMA stores, one a panel
  named_bar_sync(1, 256);
  if (dk_group)
    stage_tile<NP>(sk, acc, scale, warp, lane);
  else
    stage_tile<NP>(sv, acc, 1.f, warp, lane);
  fence_proxy_async();
  named_bar_sync(1, 256);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < HD::kPanels; ++p) {
      const int c0 = p * kPanelCols, off = p * kPanelBytes;
      tma_store_4d(&tma_dk, sk + off, c0, h, k0, b);
      tma_store_4d(&tma_dv, sv + off, c0, h, k0, b);
    }
    tma_store_flush();
  }
}

// Also refuses a call that leaves the scale unfolded at a head dim whose
// scale is not a power of two, or that folds it without a qs tensor.
bool bad_args(int b, int h, int T, int t_valid, int d, bool fold,
              const void* qs) {
  return !head_dim_ok(d) || (!fold && !logits_instance(d)) ||
         (fold && (qs == nullptr || reinterpret_cast<uintptr_t>(qs) & 15)) ||
         b <= 0 || b > 65535 || h <= 0 || h > 65535 || T <= 0 ||
         t_valid <= 0 || t_valid > T;
}

// Maps of contiguous [b, T, h, d] outputs.
int encode_out(CUtensorMap* map, void* p, int b, int T, int h, int d) {
  return encode_bthd(map, p, b, T, h, d, (long long)T * h * d,
                     (long long)h * d, d);
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

// The logits' multiplier in base 2: scale * log2(e), or log2(e) alone
// where the scale is folded into q.
float log2_scale(float scale) {
  return (float)((double)scale * 1.4426950408889634);
}

struct DqArgs {
  CUtensorMap q, k, v, o, dout, dq, qs;
  const float* lse;
  float* delta;
  int b, h, T, t_valid;
  float scale;
  cudaStream_t stream;
};

template <int NP, bool kFold>
int launch_dq(const DqArgs& a) {
  constexpr int kSmem = dq_smem<NP>();
  static bool smem_set = false;
  const int err =
      set_smem(flash_attn_bwd_dq_kernel<NP, kFold>, kSmem, smem_set);
  if (err) return err;
  const dim3 grid((a.T + kTileRows - 1) / kTileRows, a.h, a.b);
  flash_attn_bwd_dq_kernel<NP, kFold><<<grid, kThreads, kSmem, a.stream>>>(
      a.q, a.k, a.v, a.o, a.dout, a.dq, a.lse, a.delta, a.T, a.t_valid,
      a.scale, log2_scale(kFold ? 1.f : a.scale), a.qs);
  return (int)cudaGetLastError();
}

struct DkvArgs {
  CUtensorMap q, k, v, dout, dk, dv, qs;
  const float* lse;
  const float* delta;
  int b, h, T, t_valid;
  float scale;
  cudaStream_t stream;
};

template <bool kFold, typename Kernel>
int launch_dkv_kernel(Kernel kernel, int smem, int threads, bool& smem_set,
                      const DkvArgs& a) {
  const int err = set_smem(kernel, smem, smem_set);
  if (err) return err;
  const dim3 grid((a.T + kTileRows - 1) / kTileRows, a.h, a.b);
  kernel<<<grid, threads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.dk, a.dv, a.lse, a.delta, a.T, a.t_valid,
      a.scale, log2_scale(kFold ? 1.f : a.scale), a.qs);
  return (int)cudaGetLastError();
}

// NP <= 128: flash_attn_bwd_dkv_kernel; above: flash_attn_bwd_dkv_wide_kernel
template <int NP, bool kFold>
int launch_dkv(const DkvArgs& a) {
  static bool smem_set = false;
  if constexpr (NP > 128)
    return launch_dkv_kernel<kFold>(flash_attn_bwd_dkv_wide_kernel<NP, kFold>,
                                    DkvWide<NP, kFold>::kSmem, kWideThreads,
                                    smem_set, a);
  else
    return launch_dkv_kernel<kFold>(flash_attn_bwd_dkv_kernel<NP, kFold>,
                                    dkv_smem<NP, kFold>(), kThreads, smem_set,
                                    a);
}

}  // namespace

// q, k, v, out, dout: [b, T, h, d] bf16, d a multiple of 8 from 8 to 256
// and contiguous, element strides (sb, st, sh) each, multiples of 8,
// 16-byte aligned; lse: [b * h, T] fp32 from the forward; delta:
// [b * h, T] fp32, written; dq: [b, T, h, d] bf16 contiguous, written.
// fold != 0: the scale is folded into q, and qs, [b, T, h, d] bf16
// contiguous, is written with bf16(q * scale) (for occm_flash_attn_bwd_dkv);
// fold = 0 (taken at d 64 and 256 only, where the bits are the same): the
// logits are scaled and qs is unused (may be null). Keys at index >=
// t_valid are masked. One launch on `stream`. Returns 0, a cudaError_t, or
// -1 / -1000 - CUresult when a TMA descriptor cannot be made.
extern "C" int occm_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* qs,
    int b, int h, int T, int t_valid, int d, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, long long do_sb, long long do_st,
    long long do_sh, float scale, void* stream, int fold) {
  if (bad_args(b, h, T, t_valid, d, fold, qs) ||
      bad_strides(q, q_sb, q_st, q_sh) || bad_strides(k, k_sb, k_st, k_sh) ||
      bad_strides(v, v_sb, v_st, v_sh) ||
      bad_strides(out, o_sb, o_st, o_sh) ||
      bad_strides(dout, do_sb, do_st, do_sh) ||
      (reinterpret_cast<uintptr_t>(dq) & 15))
    return (int)cudaErrorInvalidValue;
  DqArgs a = {};
  int err = encode_bthd(&a.q, q, b, T, h, d, q_sb, q_st, q_sh);
  if (!err) err = encode_bthd(&a.k, k, b, T, h, d, k_sb, k_st, k_sh);
  if (!err) err = encode_bthd(&a.v, v, b, T, h, d, v_sb, v_st, v_sh);
  if (!err) err = encode_bthd(&a.o, out, b, T, h, d, o_sb, o_st, o_sh);
  if (!err) err = encode_bthd(&a.dout, dout, b, T, h, d, do_sb, do_st, do_sh);
  if (!err) err = encode_out(&a.dq, dq, b, T, h, d);
  if (!err && fold) err = encode_out(&a.qs, qs, b, T, h, d);
  if (err) return err;
  a.lse = (const float*)lse;
  a.delta = (float*)delta;
  a.b = b, a.h = h, a.T = T, a.t_valid = t_valid;
  a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return for_instance(d, fold, [&](auto np, auto folded) {
    return launch_dq<decltype(np)::value, decltype(folded)::value>(a);
  });
}

// q, k, v, dout as for occm_flash_attn_bwd_dq; lse and delta: [b * h, T]
// fp32 (delta as occm_flash_attn_bwd_dq wrote it, earlier on `stream`); qs
// as occm_flash_attn_bwd_dq wrote it with the same fold (unused where
// fold = 0); dk, dv: [b, T, h, d] bf16 contiguous, written. One launch on
// `stream`; returns as occm_flash_attn_bwd_dq does.
extern "C" int occm_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* qs, void* dk, void* dv,
    int b, int h, int T, int t_valid, int d, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long do_sb,
    long long do_st, long long do_sh, float scale, void* stream, int fold) {
  if (bad_args(b, h, T, t_valid, d, fold, qs) ||
      bad_strides(q, q_sb, q_st, q_sh) || bad_strides(k, k_sb, k_st, k_sh) ||
      bad_strides(v, v_sb, v_st, v_sh) ||
      bad_strides(dout, do_sb, do_st, do_sh) ||
      (reinterpret_cast<uintptr_t>(dk) & 15) ||
      (reinterpret_cast<uintptr_t>(dv) & 15))
    return (int)cudaErrorInvalidValue;
  DkvArgs a = {};
  int err = encode_bthd(&a.q, q, b, T, h, d, q_sb, q_st, q_sh);
  if (!err) err = encode_bthd(&a.k, k, b, T, h, d, k_sb, k_st, k_sh);
  if (!err) err = encode_bthd(&a.v, v, b, T, h, d, v_sb, v_st, v_sh);
  if (!err) err = encode_bthd(&a.dout, dout, b, T, h, d, do_sb, do_st, do_sh);
  if (!err) err = encode_out(&a.dk, dk, b, T, h, d);
  if (!err) err = encode_out(&a.dv, dv, b, T, h, d);
  if (!err && fold) err = encode_out(&a.qs, const_cast<void*>(qs), b, T, h, d);
  if (err) return err;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.b = b, a.h = h, a.T = T, a.t_valid = t_valid;
  a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return for_instance(d, fold, [&](auto np, auto folded) {
    return launch_dkv<decltype(np)::value, decltype(folded)::value>(a);
  });
}
