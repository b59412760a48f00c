// Flash-attention backward for Hopper (sm_90a): two kernels, wgmma fed by
// TMA, no atomics.
//
// Replaces three TPU Pallas kernels of occm_tpu/ops/attention.py:
//   _bwd_kernel          (attention.py:79)   whole-T backward, T padded <= 512
//   _blocked_dq_kernel   (attention.py:350)  dq over a kv sweep (+ _blocked_p_ds)
//   _blocked_dkv_kernel  (attention.py:373)  dk, dv over a q sweep
// One pair covers every T, fed by the lse the forward kernel
// (flash_attn_fwd.cu) writes. The arithmetic is the blocked TPU route's:
//   - S = q k^T accumulated in fp32 from the unscaled bf16 q, the scale
//     applied to the fp32 logits: for D = 64 it is 2^-3, so this gives the
//     bits of the TPU route's folding of the scale into q before the bf16
//     cast (flash_attn_fwd.cu's header has the argument);
//   - P = exp(scale S - lse) in fp32 (base 2: one multiplier and exp2f),
//     keys >= t_valid get P = 0;
//   - dS = P * (dO v^T - delta), delta = rowsum(dO * O) in fp32;
//   - P and dS cast to bf16 before their products, fp32 accumulation;
//   - dq = scale * dS k and dk = scale * dS^T q (the unscaled q), dv = P^T dO.
//
// Layout: q, k, v, out and dO are [B, T, H, 64] bf16 with any strides for
// B, T and H (16-byte multiples), read where they lie through 4-d TMA maps
// (64 x 64 boxes of one (b, h)), as the forward reads q, k, v. dq, dk, dv
// are written contiguous as [B, T, H, 64] by TMA stores, which clip rows
// past T, so [B, T, H * 64] is a view of each. lse and delta are
// [B * H, T] fp32. [BH, T, D] is the case B = BH, H = 1.
//
// Both kernels: 160 threads, warp 4 the producer (TMA into a ring of
// kStages stages, 128-byte swizzle, full/empty mbarriers; TMA zero-fills
// rows past T), warps 0-3 one consumer warpgroup on wgmma m64n64k16, each
// product straight from the TMA tiles, none transposed through shared
// memory.
//
// dq kernel, grid (ceil(T / 64), H, B): 64 q rows, a loop over 64-key
// tiles. The producer loads the q, dO and out tiles once and k, v per tile.
// Before the loop the warpgroup computes delta of its 64 rows from the dO
// and out tiles and writes it to the delta buffer (the dk/dv kernel, next
// on the stream, reads it there). Per tile:
//   S = q k^T, dP = dO v^T   both operands K-major, as stored; issued as two
//                            groups, so exp(S) runs while dP is computed;
//   dq += dS k               dS the register A operand (the S fragment,
//                            rounded), k an MN-major B operand (the
//                            transpose bit), as the forward feeds P and v.
// dk/dv kernel, grid (ceil(T / 64), H, B): 64 keys, a loop over 64-row q
// tiles. The producer loads the k and v tiles once, and per tile the q and
// dO tiles by TMA while its 32 lanes copy the tile's lse (times log2 e;
// +inf past T, so those rows get P = 0) and delta into the stage with
// ordinary loads (TMA needs 16-byte aligned rows, and a [B * H, T] fp32
// row of T = 299 is not). Per tile:
//   S^T = k q^T, dP^T = v dO^T   all K-major;
//   P^T = exp(scale S^T - lse[col]), dS^T = P^T * (dP^T - delta[col]);
//   dv += P^T dO, dk += dS^T q   P^T and dS^T register A operands, dO and q
//                                MN-major B operands.
// Each block owns its rows of dq, or of dk and dv: no atomics, and a
// repeat gives the same bits. S and dP are computed in both kernels (7
// products where one kernel with atomic dq would do 5): that keeps them
// deterministic, and at the training shape the work is bound by bytes.
//
// What bounds it on an H100: at the training shape (B*H = 192, T = 299,
// D = 64) the five products are 1.1e10 flop (11 us at the bf16 peak; the
// two recomputed ones make 1.5e10) against 5.9e7 bytes of q, k, v, out, dO
// read and dq, dk, dv written once (18 us); at T >= 599 the products bound
// it. The measured times are in PERF.md.

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
constexpr int kDqSmem = kDqTiles * kTileBytes + 1024 + (2 * kStages + 1) * 8;
// dk/dv kernel: k, v tiles, per stage a q and a dO tile, per stage the
// tile's lse * log2 e and delta (64 + 64 fp32), + mbarriers
constexpr int kDkvTiles = 2 + 2 * kStages;
constexpr int kStatFloats = 2 * kTileRows;
constexpr int kDkvSmem = kDkvTiles * kTileBytes + 1024 +
                         kStages * kStatFloats * 4 + (2 * kStages + 1) * 8;

__global__ void __launch_bounds__(kThreads, 2)
flash_attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tma_q,
                         const __grid_constant__ CUtensorMap tma_k,
                         const __grid_constant__ CUtensorMap tma_v,
                         const __grid_constant__ CUtensorMap tma_o,
                         const __grid_constant__ CUtensorMap tma_do,
                         const __grid_constant__ CUtensorMap tma_dq,
                         const float* __restrict__ lse,
                         float* __restrict__ delta, int T, int t_valid,
                         float scale, float scale_log2) {
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
      tma_load_4d(sq, &tma_q, head_full, 0, h, q0, b);
      tma_load_4d(sdo, &tma_do, head_full, 0, h, q0, b);
      tma_load_4d(so, &tma_o, head_full, 0, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        unsigned char* st = smem + (3 + 2 * s) * kTileBytes;
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_4d(st, &tma_k, &full[s], 0, h, j * kTileRows, b);
        tma_load_4d(st + kTileBytes, &tma_v, &full[s], 0, h, j * kTileRows,
                    b);
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

  // ---- delta = rowsum(dO * out) in fp32: lanes 2i and 2i + 1 of a warp
  // sum the two halves of its row 16 * warp + i; each thread then takes the
  // deltas of its fragment rows from the lanes that hold them
  float dl[2];
  {
    const int row = warp * 16 + (lane >> 1);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int off = swizzled(row, ((lane & 1) * 4 + j) * 8);
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

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint64_t d_q = smem_desc(smem_u32(sq));
  const uint64_t d_do = smem_desc(smem_u32(sdo));

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int kv0 = j * kTileRows;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t k_addr = smem_u32(smem + (3 + 2 * s) * kTileBytes);
    const uint64_t d_k = smem_desc(k_addr);
    const uint64_t d_v = smem_desc(k_addr + kTileBytes);

    // ---- S = q k^T and dP = dO v^T, fp32, two groups
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_acc(sc);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)  // +32 bytes along D per k-step
      wgmma_ss(sc, d_q + 2 * kk, d_k + 2 * kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dp, d_do + 2 * kk, d_v + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sc);

    // ---- P = exp(scale S - lse), keys >= t_valid masked (last tile only)
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
      wgmma_rs(acc, da[c], d_k + 128 * c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: dq * scale in bf16, staged in the out tile's shared
  // memory (128-byte swizzle), one TMA store that clips rows past T
  named_bar_sync(1, 128);  // every warp is done reading the out tile
  stage_tile(so, acc, scale, warp, lane);
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (threadIdx.x == 0) {
    tma_store_4d(&tma_dq, so, 0, h, q0, b);
    tma_store_flush();
  }
}

__global__ void __launch_bounds__(kThreads, 2)
flash_attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tma_q,
                          const __grid_constant__ CUtensorMap tma_k,
                          const __grid_constant__ CUtensorMap tma_v,
                          const __grid_constant__ CUtensorMap tma_do,
                          const __grid_constant__ CUtensorMap tma_dk,
                          const __grid_constant__ CUtensorMap tma_dv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int T, int t_valid,
                          float scale, float scale_log2) {
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
      tma_load_4d(sk, &tma_k, head_full, 0, h, k0, b);
      tma_load_4d(sv, &tma_v, head_full, 0, h, k0, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int r0 = j * kTileRows;
      mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
      if (lane == 0) {
        unsigned char* st = smem + (2 + 2 * s) * kTileBytes;
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_4d(st, &tma_q, &full[s], 0, h, r0, b);
        tma_load_4d(st + kTileBytes, &tma_do, &full[s], 0, h, r0, b);
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
  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
  mbar_wait(head_full, 0);
  const uint64_t d_k = smem_desc(smem_u32(sk));
  const uint64_t d_v = smem_desc(smem_u32(sv));

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t q_addr = smem_u32(smem + (2 + 2 * s) * kTileBytes);
    const uint64_t d_q = smem_desc(q_addr);
    const uint64_t d_do = smem_desc(q_addr + kTileBytes);
    const float* st_stat = stat + s * kStatFloats;

    // ---- S^T = k q^T and dP^T = v dO^T, fp32, two groups
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_acc(sc);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(sc, d_k + 2 * kk, d_q + 2 * kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dp, d_v + 2 * kk, d_do + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sc);

    // ---- P^T = exp(scale S^T - lse[col]); keys >= t_valid masked
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
      wgmma_rs(acc_v, pa[c], d_do + 128 * c);
#pragma unroll
    for (int c = 0; c < kTileRows / 16; ++c)
      wgmma_rs(acc_k, da[c], d_q + 128 * c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_v);
    fence_acc(acc_k);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: dk * scale and dv in bf16, staged in the k and v tiles'
  // shared memory, two TMA stores that clip rows past T
  named_bar_sync(1, 128);  // every warp's products are done reading k, v
  stage_tile(sk, acc_k, scale, warp, lane);
  stage_tile(sv, acc_v, 1.f, warp, lane);
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (threadIdx.x == 0) {
    tma_store_4d(&tma_dk, sk, 0, h, k0, b);
    tma_store_4d(&tma_dv, sv, 0, h, k0, b);
    tma_store_flush();
  }
}

bool bad_args(int b, int h, int T, int t_valid, int d) {
  return d != kD || b <= 0 || b > 65535 || h <= 0 || h > 65535 || T <= 0 ||
         t_valid <= 0 || t_valid > T;
}

// Maps of contiguous [b, T, h, 64] outputs.
int encode_out(CUtensorMap* map, void* p, int b, int T, int h) {
  return encode_bthd(map, p, b, T, h, (long long)T * h * kD, (long long)h * kD,
                     kD);
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

float log2_scale(float scale) {
  return (float)((double)scale * 1.4426950408889634);
}

}  // namespace

// q, k, v, out, dout: [b, T, h, d] bf16, d = 64 contiguous, element strides
// (sb, st, sh) each, multiples of 8, 16-byte aligned; lse: [b * h, T] fp32
// from the forward; delta: [b * h, T] fp32, written; dq: [b, T, h, d] bf16
// contiguous, written. Keys at index >= t_valid are masked. One launch on
// `stream`. Returns 0, a cudaError_t, or -1 / -1000 - CUresult when a TMA
// descriptor cannot be made.
extern "C" int occm_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, int b, int h,
    int T, int t_valid, int d, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, long long do_sb, long long do_st, long long do_sh,
    float scale, void* stream) {
  if (bad_args(b, h, T, t_valid, d) || bad_strides(q, q_sb, q_st, q_sh) ||
      bad_strides(k, k_sb, k_st, k_sh) || bad_strides(v, v_sb, v_st, v_sh) ||
      bad_strides(out, o_sb, o_st, o_sh) ||
      bad_strides(dout, do_sb, do_st, do_sh) ||
      (reinterpret_cast<uintptr_t>(dq) & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo, mdo, mdq;
  int err = encode_bthd(&mq, q, b, T, h, q_sb, q_st, q_sh);
  if (!err) err = encode_bthd(&mk, k, b, T, h, k_sb, k_st, k_sh);
  if (!err) err = encode_bthd(&mv, v, b, T, h, v_sb, v_st, v_sh);
  if (!err) err = encode_bthd(&mo, out, b, T, h, o_sb, o_st, o_sh);
  if (!err) err = encode_bthd(&mdo, dout, b, T, h, do_sb, do_st, do_sh);
  if (!err) err = encode_out(&mdq, dq, b, T, h);
  if (err) return err;
  static bool smem_set = false;
  err = set_smem(flash_attn_bwd_dq_kernel, kDqSmem, smem_set);
  if (err) return err;
  const dim3 grid((T + kTileRows - 1) / kTileRows, h, b);
  flash_attn_bwd_dq_kernel<<<grid, kThreads, kDqSmem, (cudaStream_t)stream>>>(
      mq, mk, mv, mo, mdo, mdq, (const float*)lse, (float*)delta, T, t_valid,
      scale, log2_scale(scale));
  return (int)cudaGetLastError();
}

// q, k, v, dout as for occm_flash_attn_bwd_dq; lse and delta: [b * h, T]
// fp32 (delta as occm_flash_attn_bwd_dq wrote it, earlier on `stream`);
// dk, dv: [b, T, h, d] bf16 contiguous, written. One launch on `stream`;
// returns as occm_flash_attn_bwd_dq does.
extern "C" int occm_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int h,
    int T, int t_valid, int d, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long do_sb, long long do_st,
    long long do_sh, float scale, void* stream) {
  if (bad_args(b, h, T, t_valid, d) || bad_strides(q, q_sb, q_st, q_sh) ||
      bad_strides(k, k_sb, k_st, k_sh) || bad_strides(v, v_sb, v_st, v_sh) ||
      bad_strides(dout, do_sb, do_st, do_sh) ||
      (reinterpret_cast<uintptr_t>(dk) & 15) ||
      (reinterpret_cast<uintptr_t>(dv) & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  int err = encode_bthd(&mq, q, b, T, h, q_sb, q_st, q_sh);
  if (!err) err = encode_bthd(&mk, k, b, T, h, k_sb, k_st, k_sh);
  if (!err) err = encode_bthd(&mv, v, b, T, h, v_sb, v_st, v_sh);
  if (!err) err = encode_bthd(&mdo, dout, b, T, h, do_sb, do_st, do_sh);
  if (!err) err = encode_out(&mdk, dk, b, T, h);
  if (!err) err = encode_out(&mdv, dv, b, T, h);
  if (err) return err;
  static bool smem_set = false;
  err = set_smem(flash_attn_bwd_dkv_kernel, kDkvSmem, smem_set);
  if (err) return err;
  const dim3 grid((T + kTileRows - 1) / kTileRows, h, b);
  flash_attn_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem,
                              (cudaStream_t)stream>>>(
      mq, mk, mv, mdo, mdk, mdv, (const float*)lse, (const float*)delta, T,
      t_valid, scale, log2_scale(scale));
  return (int)cudaGetLastError();
}
