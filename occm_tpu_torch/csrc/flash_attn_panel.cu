// Flash attention for Hopper (sm_90a) in bf16 at head dims above 256 (a
// multiple of 8): the forward and the two backward kernels (dq, which also
// computes delta = rowsum(dO * O), then dk/dv), wgmma fed by TMA, with the
// output split along D into panels, one a block.
//
// Replaces, at those head dims, the five TPU Pallas kernels of
// occm_tpu/ops/attention.py, which take any D:
//   _fwd_kernel          (attention.py:45)   whole-T forward
//   _bwd_kernel          (attention.py:79)   whole-T backward
//   _blocked_fwd_kernel  (attention.py:234)  online-softmax forward + lse
//   _blocked_dq_kernel   (attention.py:350)  dq over a kv sweep
//   _blocked_dkv_kernel  (attention.py:373)  dk, dv over a q sweep
// flash_attn_fwd.cu and flash_attn_bwd.cu take D up to 256: their tiles
// hold the whole head dim (the dq kernel's seven 64-row tiles fill 225 of
// an SM's 227 KB at D 256), a thread's accumulator holds NP / 2 fp32 (128
// at D 256), and one wgmma's N ends at 256. The arithmetic here is theirs
// (flash_attn_fwd.cu's and flash_attn_bwd.cu's headers), with the scale
// always folded into q in fp32 before the bf16 cast, as the TPU kernels
// and the plain versions fold it: at D 1024 (scale 2^-5) that gives the
// bits of scaling the logits too.
//
// Panels: n_panels = ceil(D / PW) blocks share a row tile, each owning the
// output columns [PW p, PW p + PW): PW = 256, or 192 where that does as
// well (round_up(ceil(D / ceil(D / 256)), 64): D 264-384 and 520-576 take
// 192, D 512 and 1024 256). PW is a multiple of 64, so a panel's TMA boxes
// never cross into its neighbour's columns; columns past D are zero-filled
// on loads and clipped on stores. Two instances a kernel (PW 192, 256),
// each with a runtime loop over D.
//
// Layout: q, k, v, out and dO are [B, T, H, D] bf16 with any strides for
// B, T and H (16-byte multiples) and D contiguous, read through 4-d TMA
// maps in 64 x 64 boxes (attention_sm90.cuh); out, dq, dk, dv are written
// contiguous as [B, T, H, D] by TMA stores; lse and delta are [B * H, T]
// fp32. [BH, T, D] is the case B = BH, H = 1.
//
// Design. S = q k^T (and in the backward dP = dO v^T) runs over the whole
// D as a runtime loop of 64-column steps: a producer thread streams the
// step's 64-column panels (q and k; in the backward q, k, dO and v) by TMA
// through a ring of stages; the consumers fold the scale into the q panel
// in shared memory (fold_scale) and issue the step's four k16 wgmma, which
// run while the next stage is folded. The products whose N is the panel
// (P v; dS k; P^T dO, dS^T q) read a panel tile of PW columns of the
// streamed rows, loaded once a tile after the tile's stream (one buffer:
// its load overlaps the stream's last stages), as an MN-major B operand
// with P or dS from registers, as in flash_attn_fwd.cu. So shared memory
// does not grow with D:
//   forward: ring 4 x (q, k) 64-column panels (64 KB), v's panel tile
//            (24 / 32 KB), out staged in the ring: 97 KB at PW 256;
//            64 q rows, 160 threads (warp 4 the producer);
//   dq:      ring 3 x (q, k, dO, v) panels (96 KB), k's panel tile:
//            129 KB; 64 q rows, 160 threads; delta from O and dO read
//            from device memory, a warp a row;
//   dk/dv:   ring 3 x (k, q, v, dO) panels (96 KB), the panel tiles of dO
//            and of the unscaled q and the tile's lse and delta: 161 KB;
//            64 keys, 384 threads: warpgroup 0 S^T, P^T and dv, warpgroup
//            1 S^T, dP^T, dS^T and dk, each with its PW / 2 fp32
//            accumulator (as flash_attn_bwd.cu's wide dk/dv kernel), both
//            fold each q panel; warpgroup 2 the producer's (warp 8 loads,
//            the rest give their registers up: setmaxnreg 24 / 240).
// The accumulators stay within 128 fp32 registers a thread. Each block
// owns its rows and columns of out, dq, or dk and dv: no atomics, and a
// repeat gives the same bits. lse and delta come out equal in every
// panel's block (the same S and the same sums give the same bits); panel
// 0's block writes them.
//
// What it recomputes: every panel's block computes the same S (and dP),
// and the block's own rows are streamed again for every tile (from the
// L2). With n panels the forward's products are (2 n + 2) / 4 of its
// least: 1.5x at D 512 (two panels), 2.5x at D 1024 (four); the backward's
// (4 n + 3) / 5 against its five least products: 2.2x at D 512 (the
// pair at D <= 256 does 1.4x). One S shared by two consumer warpgroups
// through shared memory would remove the forward's; that is left to later
// work.
// What bounds it on an H100: at B 8, H 2, T 599, D 512 the forward's least
// work is 4 * BH * T^2 * D = 1.18e10 flop (0.012 ms at 989 TFLOP/s) against
// 8 * BH * T * D = 39 MB of q, k, v and out (0.012 ms at 3.35 TB/s). The
// measured times are in PERF.md.

#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

constexpr int kBN = kTileRows;  // keys (or q rows) of a streamed tile
constexpr int kFwdRing = 4;     // forward: stages of (q, k) panels
constexpr int kBwdRing = 3;     // backward: stages of four panels
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may take

// The panel of PW columns (192 or 256): its tile geometry and the 64-column
// boxes of panel p that lie within D.
template <int PW>
struct Panel {
  static_assert(PW % kPanelCols == 0 && PW <= 256, "PW: 64..256 by 64");
  using HD = HeadDim<PW>;
  static constexpr int kBoxes = PW / kPanelCols;
  static constexpr int kTileBytes = HD::kTileBytes;
};
template <int PW>
__device__ __forceinline__ int boxes_within(int d0, int D) {
  const int n = (D - d0 + kPanelCols - 1) / kPanelCols;
  return n < Panel<PW>::kBoxes ? n : Panel<PW>::kBoxes;
}

// forward: the ring, v's panel tile, + 1 KB to align to the 128-byte
// swizzle's 1024-byte period, + mbarriers (full, empty, v_full, v_empty)
template <int PW>
constexpr int fwd_smem() {
  return kFwdRing * 2 * kPanelBytes + Panel<PW>::kTileBytes + 1024 +
         (2 * kFwdRing + 2) * 8;
}
// dq: the ring, k's panel tile, + alignment, + mbarriers
template <int PW>
constexpr int dq_smem() {
  return kBwdRing * 4 * kPanelBytes + Panel<PW>::kTileBytes + 1024 +
         (2 * kBwdRing + 2) * 8;
}
// dk/dv: the ring, the dO and q panel tiles, the tile's lse * log2 e and
// delta (64 + 64 fp32), + alignment, + mbarriers
template <int PW>
constexpr int dkv_smem() {
  return kBwdRing * 4 * kPanelBytes + 2 * Panel<PW>::kTileBytes + 1024 +
         2 * kTileRows * 4 + (2 * kBwdRing + 2) * 8;
}
static_assert(fwd_smem<256>() <= kMaxSmem && dq_smem<256>() <= kMaxSmem &&
                  dkv_smem<256>() <= kMaxSmem,
              "the panel kernels' shared memory must fit a block");

// S (+)= one 64-column step of a product over D: four k16 wgmma of
// m64n64k16, both operands K-major panels as TMA stores them.
__device__ __forceinline__ void step_ss(float (&acc)[32], uint32_t a,
                                        uint32_t b) {
  const uint64_t da = smem_desc(a), db = smem_desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc, da + kstep(kk), db + kstep(kk));
}

// Releases stage `s` of a ring once this warp's wgmma reading it are done.
__device__ __forceinline__ void release(uint64_t* empty, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[s]);
}

// ------------------------------------------------------------------ forward
// grid (ceil(T / 64) * n_panels, H, B), the panel the fastest index of x
template <int PW>
__global__ void __launch_bounds__(160, 1)
flash_attn_fwd_panel_kernel(const __grid_constant__ CUtensorMap tma_q,
                            const __grid_constant__ CUtensorMap tma_k,
                            const __grid_constant__ CUtensorMap tma_v,
                            const __grid_constant__ CUtensorMap tma_o,
                            float* __restrict__ lse, int T, int t_valid,
                            int D, int n_panels, float scale) {
  using P = Panel<PW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* ring = smem;  // stage s: q, k panels; at the end: out
  unsigned char* sv = ring + kFwdRing * 2 * kPanelBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + P::kTileBytes);
  uint64_t* empty = full + kFwdRing;
  uint64_t* v_full = empty + kFwdRing;
  uint64_t* v_empty = v_full + 1;

  const int panel = blockIdx.x % n_panels;
  const int q0 = blockIdx.x / n_panels * kTileRows, d0 = panel * PW;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (t_valid + kBN - 1) / kBN;
  const int n_steps = (D + kPanelCols - 1) / kPanelCols;
  const int boxes = boxes_within<PW>(d0, D);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: per kv tile the (q, k) panels of every 64-column step,
    // then v's panel tile
    if (threadIdx.x == 128) {
      int it = 0;
      for (int j = 0; j < n_tiles; ++j) {
        for (int d = 0; d < n_steps; ++d, ++it) {
          const int s = it % kFwdRing;
          mbar_wait(&empty[s], ((it / kFwdRing) & 1) ^ 1);
          unsigned char* st = ring + s * 2 * kPanelBytes;
          mbar_expect_tx(&full[s], 2 * kPanelBytes);
          tma_load_4d(st, &tma_q, &full[s], d * kPanelCols, h, q0, b);
          tma_load_4d(st + kPanelBytes, &tma_k, &full[s], d * kPanelCols, h,
                      j * kBN, b);
        }
        mbar_wait(v_empty, (j & 1) ^ 1);
        mbar_expect_tx(v_full, boxes * kPanelBytes);
        for (int p = 0; p < boxes; ++p)
          tma_load_4d(sv + p * kPanelBytes, &tma_v, v_full,
                      d0 + p * kPanelCols, h, j * kBN, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 q rows, 16 per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float o[PW / 2];
#pragma unroll
  for (int i = 0; i < PW / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};
  const uint64_t dv = smem_desc(smem_u32(sv), P::HD::kLbo);  // v MN-major
  int it = 0;

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBN;
    // ---- S = bf16(q * scale) k^T over D, a 64-column step a stage
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_acc(sc);
    int prev = -1;
    for (int d = 0; d < n_steps; ++d, ++it) {
      const int s = it % kFwdRing;
      unsigned char* st = ring + s * 2 * kPanelBytes;
      mbar_wait(&full[s], (it / kFwdRing) & 1);
      fold_scale<kPanelCols>(st, scale, threadIdx.x, 128);
      fence_proxy_async();
      named_bar_sync(1, 128);
      wgmma_fence();
      step_ss(sc, smem_u32(st), smem_u32(st + kPanelBytes));
      wgmma_commit();
      if (prev >= 0) {  // the previous stage's wgmma are done
        wgmma_wait<1>();
        release(empty, prev, lane);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(sc);
    release(empty, prev, lane);

    // ---- key mask (last tile only), online softmax in base 2 (the scale
    // is in q: the multiplier is log2 e alone)
    if (kv0 + kBN > t_valid) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kv0 + col(i, lane) >= t_valid) sc[i] = kMasked;
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[row_half(i)] = fmaxf(mx[row_half(i)], sc[i]);
    float alpha[2], m_scaled[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m_run[r] - mx[r]) * kLog2e);
      m_run[r] = mx[r];
      m_scaled[r] = mx[r] * kLog2e;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2f(fmaf(sc[i], kLog2e, -m_scaled[row_half(i)]));
      l_run[row_half(i)] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < PW / 2; ++i) o[i] *= alpha[row_half(i)];

    // ---- o += bf16(P) v's panel
    uint32_t pa[kBN / 16][4];
    pack_a(pa, sc);
    mbar_wait(v_full, j & 1);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c)  // +16 keys = +2048 bytes per k-step
      wgmma_rs_np<PW>(o, pa[c], dv + 128 * c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    release(v_empty, 0, lane);
  }

  // ---- epilogue: full row sums, normalise, stage bf16 out in the ring
  // (every stage has been read), one TMA store a box within D; lse from
  // panel 0's block
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  named_bar_sync(1, 128);
#pragma unroll
  for (int i = 0; i < PW / 2; i += 2) {
    const float l = l_run[row_half(i)];
    *reinterpret_cast<uint32_t*>(ring + fragment_offset(i, warp, lane)) =
        pack_bf16(o[i] / l, o[i + 1] / l);
  }
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (threadIdx.x == 0) {
    for (int p = 0; p < boxes; ++p)
      tma_store_4d(&tma_o, ring + p * kPanelBytes, d0 + p * kPanelCols, h,
                   q0, b);
    tma_store_flush();
  }
  if (panel == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < T)
        lse[((size_t)b * gridDim.y + h) * T + row] =
            m_run[r] + logf(fmaxf(l_run[r], 1e-30f));
    }
  }
}

// ------------------------------------------------------- backward: dq, delta
// grid (ceil(T / 64) * n_panels, H, B). Per kv tile the producer streams
// the (q, k, dO, v) panels of every 64-column step, then k's panel tile.
template <int PW>
__global__ void __launch_bounds__(160, 1)
flash_attn_bwd_dq_panel_kernel(
    const __grid_constant__ CUtensorMap tma_q,
    const __grid_constant__ CUtensorMap tma_k,
    const __grid_constant__ CUtensorMap tma_v,
    const __grid_constant__ CUtensorMap tma_do,
    const __grid_constant__ CUtensorMap tma_dq,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    long long o_sb, long long o_st, long long o_sh, long long do_sb,
    long long do_st, long long do_sh, const float* __restrict__ lse,
    float* __restrict__ delta, int T, int t_valid, int D, int n_panels,
    float scale) {
  using P = Panel<PW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* ring = smem;  // stage s: q, k, dO, v panels; then dq
  unsigned char* sk = ring + kBwdRing * 4 * kPanelBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sk + P::kTileBytes);
  uint64_t* empty = full + kBwdRing;
  uint64_t* k_full = empty + kBwdRing;
  uint64_t* k_empty = k_full + 1;

  const int panel = blockIdx.x % n_panels;
  const int q0 = blockIdx.x / n_panels * kTileRows, d0 = panel * PW;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t row_base = ((size_t)b * gridDim.y + h) * T;
  const int n_tiles = (t_valid + kBN - 1) / kBN;
  const int n_steps = (D + kPanelCols - 1) / kPanelCols;
  const int boxes = boxes_within<PW>(d0, D);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(k_full, 1);
    mbar_init(k_empty, 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      int it = 0;
      for (int j = 0; j < n_tiles; ++j) {
        for (int d = 0; d < n_steps; ++d, ++it) {
          const int s = it % kBwdRing;
          const int c0 = d * kPanelCols;
          mbar_wait(&empty[s], ((it / kBwdRing) & 1) ^ 1);
          unsigned char* st = ring + s * 4 * kPanelBytes;
          mbar_expect_tx(&full[s], 4 * kPanelBytes);
          tma_load_4d(st, &tma_q, &full[s], c0, h, q0, b);
          tma_load_4d(st + kPanelBytes, &tma_k, &full[s], c0, h, j * kBN, b);
          tma_load_4d(st + 2 * kPanelBytes, &tma_do, &full[s], c0, h, q0, b);
          tma_load_4d(st + 3 * kPanelBytes, &tma_v, &full[s], c0, h, j * kBN,
                      b);
        }
        mbar_wait(k_empty, (j & 1) ^ 1);
        mbar_expect_tx(k_full, boxes * kPanelBytes);
        for (int p = 0; p < boxes; ++p)
          tma_load_4d(sk + p * kPanelBytes, &tma_k, k_full,
                      d0 + p * kPanelCols, h, j * kBN, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 16 q rows per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // lse * log2 e of this thread's fragment rows lane / 4 (+ 8)
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = row < T ? lse[row_base + row] * kLog2e : INFINITY;
  }
  // delta = rowsum(dO * out) in fp32 over D, read from device memory: a warp
  // a row, 8 bf16 a lane a load; every lane ends with the row's sum (a
  // butterfly), and the lanes of the row's fragment keep it
  float dl[2] = {0.f, 0.f};
  for (int i = 0; i < 16; ++i) {
    const int row = q0 + warp * 16 + i;
    float sum = 0.f;
    if (row < T) {
      const __nv_bfloat16* po = o + b * o_sb + row * o_st + h * o_sh;
      const __nv_bfloat16* pd = dout + b * do_sb + row * do_st + h * do_sh;
      for (int c = lane * 8; c < D; c += 256) {
        const uint4 a = *reinterpret_cast<const uint4*>(pd + c);
        const uint4 x = *reinterpret_cast<const uint4*>(po + c);
        const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* px = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 u = __bfloat1622float2(pa[e]);
          const float2 w = __bfloat1622float2(px[e]);
          sum = fmaf(u.x, w.x, sum);
          sum = fmaf(u.y, w.y, sum);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if ((lane >> 2) == i) dl[0] = sum;
    if ((lane >> 2) + 8 == i) dl[1] = sum;
    if (panel == 0 && lane == 0 && row < T) delta[row_base + row] = sum;
  }

  float acc[PW / 2];
#pragma unroll
  for (int i = 0; i < PW / 2; ++i) acc[i] = 0.f;
  const uint64_t d_kt = smem_desc(smem_u32(sk), P::HD::kLbo);  // k MN-major
  int it = 0;

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBN;
    // ---- S = bf16(q * scale) k^T and dP = dO v^T over D
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_acc(sc);
    fence_acc(dp);
    int prev = -1;
    for (int d = 0; d < n_steps; ++d, ++it) {
      const int s = it % kBwdRing;
      unsigned char* st = ring + s * 4 * kPanelBytes;
      mbar_wait(&full[s], (it / kBwdRing) & 1);
      fold_scale<kPanelCols>(st, scale, threadIdx.x, 128);
      fence_proxy_async();
      named_bar_sync(1, 128);
      const uint32_t a = smem_u32(st);
      wgmma_fence();
      step_ss(sc, a, a + kPanelBytes);
      step_ss(dp, a + 2 * kPanelBytes, a + 3 * kPanelBytes);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        release(empty, prev, lane);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    release(empty, prev, lane);

    // ---- P = exp(S - lse) (keys >= t_valid masked), dS = P (dP - delta)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sc[i] = exp2f(fmaf(sc[i], kLog2e, -lse2[row_half(i)]));
    if (kv0 + kBN > t_valid) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kv0 + col(i, lane) >= t_valid) sc[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - dl[row_half(i)];

    // ---- dq's panel += bf16(dS) k's panel
    uint32_t da[kBN / 16][4];
    pack_a(da, sc);
    mbar_wait(k_full, j & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c)
      wgmma_rs_np<PW>(acc, da[c], d_kt + 128 * c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    release(k_empty, 0, lane);
  }

  // ---- epilogue: dq * scale in bf16 staged in the ring, TMA stores
  named_bar_sync(1, 128);
  stage_tile<PW>(ring, acc, scale, warp, lane);
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (threadIdx.x == 0) {
    for (int p = 0; p < boxes; ++p)
      tma_store_4d(&tma_dq, ring + p * kPanelBytes, d0 + p * kPanelCols, h,
                   q0, b);
    tma_store_flush();
  }
}

// --------------------------------------------------- backward: dk and dv
// grid (ceil(T / 64) * n_panels, H, B): the block's rows are 64 keys. Per
// q tile the producer streams the (k, q, v, dO) panels of every 64-column
// step, then the panel tiles of dO and q and the tile's lse and delta.
template <int PW>
__global__ void __launch_bounds__(384, 1)
flash_attn_bwd_dkv_panel_kernel(const __grid_constant__ CUtensorMap tma_q,
                                const __grid_constant__ CUtensorMap tma_k,
                                const __grid_constant__ CUtensorMap tma_v,
                                const __grid_constant__ CUtensorMap tma_do,
                                const __grid_constant__ CUtensorMap tma_dk,
                                const __grid_constant__ CUtensorMap tma_dv,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta, int T,
                                int t_valid, int D, int n_panels,
                                float scale) {
  using P = Panel<PW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* ring = smem;  // stage s: k, q, v, dO panels
  unsigned char* sdo = ring + kBwdRing * 4 * kPanelBytes;  // then dv
  unsigned char* sq = sdo + P::kTileBytes;  // unscaled; then dk
  // lse * log2 e of the tile's 64 q rows, then their delta
  float* stat = reinterpret_cast<float*>(sq + P::kTileBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(stat + 2 * kTileRows);
  uint64_t* empty = full + kBwdRing;
  uint64_t* t_full = empty + kBwdRing;
  uint64_t* t_empty = t_full + 1;

  const int panel = blockIdx.x % n_panels;
  const int k0 = blockIdx.x / n_panels * kTileRows, d0 = panel * PW;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t row_base = ((size_t)b * gridDim.y + h) * T;
  const int n_tiles = (T + kBN - 1) / kBN;
  const int n_steps = (D + kPanelCols - 1) / kPanelCols;
  const int boxes = boxes_within<PW>(d0, D);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    // the 32 producer lanes' arrivals after their lse / delta stores, and
    // lane 0's with the TMA byte count
    mbar_init(t_full, 33);
    mbar_init(t_empty, 8);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: warp 8 loads, warps 9-11 only give their
    // registers up
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x >= 288) return;
    const int lane = threadIdx.x - 256;
    int it = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int r0 = j * kBN;
      if (lane == 0) {
        for (int d = 0; d < n_steps; ++d, ++it) {
          const int s = it % kBwdRing;
          const int c0 = d * kPanelCols;
          mbar_wait(&empty[s], ((it / kBwdRing) & 1) ^ 1);
          unsigned char* st = ring + s * 4 * kPanelBytes;
          mbar_expect_tx(&full[s], 4 * kPanelBytes);
          tma_load_4d(st, &tma_k, &full[s], c0, h, k0, b);
          tma_load_4d(st + kPanelBytes, &tma_q, &full[s], c0, h, r0, b);
          tma_load_4d(st + 2 * kPanelBytes, &tma_v, &full[s], c0, h, k0, b);
          tma_load_4d(st + 3 * kPanelBytes, &tma_do, &full[s], c0, h, r0, b);
        }
      }
      mbar_wait(t_empty, (j & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(t_full, 2 * boxes * kPanelBytes);
        for (int p = 0; p < boxes; ++p) {
          const int c0 = d0 + p * kPanelCols;
          tma_load_4d(sdo + p * kPanelBytes, &tma_do, t_full, c0, h, r0, b);
          tma_load_4d(sq + p * kPanelBytes, &tma_q, t_full, c0, h, r0, b);
        }
      }
#pragma unroll
      for (int i = 0; i < kTileRows / 32; ++i) {
        const int r = lane + 32 * i;
        const bool in = r0 + r < T;
        stat[r] = in ? lse[row_base + r0 + r] * kLog2e : INFINITY;
        stat[kTileRows + r] = in ? delta[row_base + r0 + r] : 0.f;
      }
      mbar_arrive(t_full);
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
  float acc[PW / 2];  // dv's panel, or dk's
#pragma unroll
  for (int i = 0; i < PW / 2; ++i) acc[i] = 0.f;
  // dO's (or q's) panel tile as an MN-major B operand
  const uint64_t d_bt =
      smem_desc(smem_u32(dk_group ? sq : sdo), P::HD::kLbo);
  int it = 0;

  for (int j = 0; j < n_tiles; ++j) {
    // ---- S^T = k bf16(q * scale)^T (both groups) and dP^T = v dO^T
    // (group 1) over D
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_acc(sc);
    fence_acc(dp);
    int prev = -1;
    for (int d = 0; d < n_steps; ++d, ++it) {
      const int s = it % kBwdRing;
      unsigned char* st = ring + s * 4 * kPanelBytes;
      mbar_wait(&full[s], (it / kBwdRing) & 1);
      fold_scale<kPanelCols>(st + kPanelBytes, scale, threadIdx.x, 256);
      fence_proxy_async();
      named_bar_sync(1, 256);
      const uint32_t a = smem_u32(st);
      wgmma_fence();
      step_ss(sc, a, a + kPanelBytes);
      if (dk_group) step_ss(dp, a + 2 * kPanelBytes, a + 3 * kPanelBytes);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        release(empty, prev, lane);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    release(empty, prev, lane);

    // ---- P^T = exp(S^T - lse[col]); keys >= t_valid masked
    mbar_wait(t_full, j & 1);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 l = *reinterpret_cast<const float2*>(stat + col(i, lane));
      sc[i] = exp2f(fmaf(sc[i], kLog2e, -l.x));
      sc[i + 1] = exp2f(fmaf(sc[i + 1], kLog2e, -l.y));
    }
    if (!all_keys_ok) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!key_ok[row_half(i)]) sc[i] = 0.f;
    }
    if (dk_group) {
      // ---- dS^T = P^T (dP^T - delta[col])
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 dl =
            *reinterpret_cast<const float2*>(stat + kTileRows + col(i, lane));
        sc[i] *= dp[i] - dl.x;
        sc[i + 1] *= dp[i + 1] - dl.y;
      }
    }
    // ---- dv's panel += bf16(P^T) dO's panel (group 0), dk's panel +=
    // bf16(dS^T) q's panel (group 1)
    uint32_t pa[kTileRows / 16][4];
    pack_a(pa, sc);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kTileRows / 16; ++c)  // +16 q rows = +2048 bytes
      wgmma_rs_np<PW>(acc, pa[c], d_bt + 128 * c);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    release(t_empty, 0, lane);
  }

  // ---- epilogue: dv in dO's panel tile, dk * scale in q's (bf16), once
  // both groups are done reading them; one TMA store a box within D
  named_bar_sync(1, 256);
  stage_tile<PW>(dk_group ? sq : sdo, acc, dk_group ? scale : 1.f, warp,
                 lane);
  fence_proxy_async();
  named_bar_sync(1, 256);
  if (threadIdx.x == 0) {
    for (int p = 0; p < boxes; ++p) {
      const int c0 = d0 + p * kPanelCols, off = p * kPanelBytes;
      tma_store_4d(&tma_dk, sq + off, c0, h, k0, b);
      tma_store_4d(&tma_dv, sdo + off, c0, h, k0, b);
    }
    tma_store_flush();
  }
}

// ---------------------------------------------------------------- host side

// The panel width of head dim d (above 256): 192 where ceil(d / 192)
// panels are as few as ceil(d / 256), else 256.
int panel_width(int d) {
  const int n = (d + 255) / 256;
  return (d + n - 1) / n <= 192 ? 192 : 256;
}

bool bad_args(int b, int h, int T, int t_valid, int d) {
  return d <= 256 || d % 8 != 0 || b <= 0 || b > 65535 || h <= 0 ||
         h > 65535 || T <= 0 || t_valid <= 0 || t_valid > T ||
         (long long)((T + 63) / 64) * ((d + 191) / 192) > 0x7fffffff;
}

int encode_out(CUtensorMap* map, void* p, int b, int T, int h, int d) {
  return encode_bthd(map, p, b, T, h, d, (long long)T * h * d,
                     (long long)h * d, d);
}

// Sets an instance's dynamic shared memory once (a thread-safe static in
// each caller, so a launch captured into a CUDA graph makes no attribute
// call).
template <typename Kernel>
cudaError_t smem_attr(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

dim3 panel_grid(int T, int d, int pw, int h, int b) {
  return dim3((T + kTileRows - 1) / kTileRows * ((d + pw - 1) / pw), h, b);
}

template <int PW>
int launch_fwd(const CUtensorMap& mq, const CUtensorMap& mk,
               const CUtensorMap& mv, const CUtensorMap& mo, float* lse,
               int b, int h, int T, int t_valid, int d, float scale,
               cudaStream_t stream) {
  constexpr int smem = fwd_smem<PW>();
  static const cudaError_t attr =
      smem_attr(flash_attn_fwd_panel_kernel<PW>, smem);
  if (attr != cudaSuccess) return (int)attr;
  flash_attn_fwd_panel_kernel<PW>
      <<<panel_grid(T, d, PW, h, b), 160, smem, stream>>>(
          mq, mk, mv, mo, lse, T, t_valid, d, (d + PW - 1) / PW, scale);
  return (int)cudaGetLastError();
}

struct DqArgs {
  CUtensorMap q, k, v, dout, dq;
  const __nv_bfloat16 *o, *dout_ptr;
  long long o_sb, o_st, o_sh, do_sb, do_st, do_sh;
  const float* lse;
  float* delta;
  int b, h, T, t_valid, d;
  float scale;
  cudaStream_t stream;
};

template <int PW>
int launch_dq(const DqArgs& a) {
  constexpr int smem = dq_smem<PW>();
  static const cudaError_t attr =
      smem_attr(flash_attn_bwd_dq_panel_kernel<PW>, smem);
  if (attr != cudaSuccess) return (int)attr;
  flash_attn_bwd_dq_panel_kernel<PW>
      <<<panel_grid(a.T, a.d, PW, a.h, a.b), 160, smem, a.stream>>>(
          a.q, a.k, a.v, a.dout, a.dq, a.o, a.dout_ptr, a.o_sb, a.o_st,
          a.o_sh, a.do_sb, a.do_st, a.do_sh, a.lse, a.delta, a.T, a.t_valid,
          a.d, (a.d + PW - 1) / PW, a.scale);
  return (int)cudaGetLastError();
}

struct DkvArgs {
  CUtensorMap q, k, v, dout, dk, dv;
  const float* lse;
  const float* delta;
  int b, h, T, t_valid, d;
  float scale;
  cudaStream_t stream;
};

template <int PW>
int launch_dkv(const DkvArgs& a) {
  constexpr int smem = dkv_smem<PW>();
  static const cudaError_t attr =
      smem_attr(flash_attn_bwd_dkv_panel_kernel<PW>, smem);
  if (attr != cudaSuccess) return (int)attr;
  flash_attn_bwd_dkv_panel_kernel<PW>
      <<<panel_grid(a.T, a.d, PW, a.h, a.b), 384, smem, a.stream>>>(
          a.q, a.k, a.v, a.dout, a.dk, a.dv, a.lse, a.delta, a.T, a.t_valid,
          a.d, (a.d + PW - 1) / PW, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [b, T, h, d] bf16, d a multiple of 8 above 256 and contiguous,
// element strides (sb, st, sh) each, multiples of 8, 16-byte aligned; out:
// [b, T, h, d] bf16 contiguous; lse: [b * h, T] fp32. Keys at index >=
// t_valid are masked; `scale` is folded into q. One launch on `stream`.
// Returns 0, a cudaError_t, or -1 / -1000 - CUresult when a TMA descriptor
// cannot be made.
extern "C" int occm_flash_attn_panel_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int b,
    int h, int T, int t_valid, int d, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, float scale,
    void* stream) {
  if (bad_args(b, h, T, t_valid, d) || bad_strides(q, q_sb, q_st, q_sh) ||
      bad_strides(k, k_sb, k_st, k_sh) || bad_strides(v, v_sb, v_st, v_sh) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  int err = encode_bthd(&mq, q, b, T, h, d, q_sb, q_st, q_sh);
  if (!err) err = encode_bthd(&mk, k, b, T, h, d, k_sb, k_st, k_sh);
  if (!err) err = encode_bthd(&mv, v, b, T, h, d, v_sb, v_st, v_sh);
  if (!err) err = encode_out(&mo, out, b, T, h, d);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  return panel_width(d) == 192
             ? launch_fwd<192>(mq, mk, mv, mo, (float*)lse, b, h, T, t_valid,
                               d, scale, s)
             : launch_fwd<256>(mq, mk, mv, mo, (float*)lse, b, h, T, t_valid,
                               d, scale, s);
}

// q, k, v, out, dout: [b, T, h, d] as for occm_flash_attn_panel_fwd, each
// with its strides; lse: [b * h, T] fp32 from the forward; delta:
// [b * h, T] fp32, written (rowsum(dout * out)); dq: [b, T, h, d] bf16
// contiguous, written. One launch on `stream`; returns as
// occm_flash_attn_panel_fwd does.
extern "C" int occm_flash_attn_panel_bwd_dq(
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
  DqArgs a = {};
  int err = encode_bthd(&a.q, q, b, T, h, d, q_sb, q_st, q_sh);
  if (!err) err = encode_bthd(&a.k, k, b, T, h, d, k_sb, k_st, k_sh);
  if (!err) err = encode_bthd(&a.v, v, b, T, h, d, v_sb, v_st, v_sh);
  if (!err) err = encode_bthd(&a.dout, dout, b, T, h, d, do_sb, do_st, do_sh);
  if (!err) err = encode_out(&a.dq, dq, b, T, h, d);
  if (err) return err;
  a.o = (const __nv_bfloat16*)out;
  a.dout_ptr = (const __nv_bfloat16*)dout;
  a.o_sb = o_sb, a.o_st = o_st, a.o_sh = o_sh;
  a.do_sb = do_sb, a.do_st = do_st, a.do_sh = do_sh;
  a.lse = (const float*)lse;
  a.delta = (float*)delta;
  a.b = b, a.h = h, a.T = T, a.t_valid = t_valid, a.d = d;
  a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return panel_width(d) == 192 ? launch_dq<192>(a) : launch_dq<256>(a);
}

// q, k, v, dout as for occm_flash_attn_panel_bwd_dq; lse and delta:
// [b * h, T] fp32 (delta as occm_flash_attn_panel_bwd_dq wrote it, earlier
// on `stream`); dk, dv: [b, T, h, d] bf16 contiguous, written. One launch
// on `stream`; returns as occm_flash_attn_panel_fwd does.
extern "C" int occm_flash_attn_panel_bwd_dkv(
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
  DkvArgs a = {};
  int err = encode_bthd(&a.q, q, b, T, h, d, q_sb, q_st, q_sh);
  if (!err) err = encode_bthd(&a.k, k, b, T, h, d, k_sb, k_st, k_sh);
  if (!err) err = encode_bthd(&a.v, v, b, T, h, d, v_sb, v_st, v_sh);
  if (!err) err = encode_bthd(&a.dout, dout, b, T, h, d, do_sb, do_st, do_sh);
  if (!err) err = encode_out(&a.dk, dk, b, T, h, d);
  if (!err) err = encode_out(&a.dv, dv, b, T, h, d);
  if (err) return err;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.b = b, a.h = h, a.T = T, a.t_valid = t_valid, a.d = d;
  a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return panel_width(d) == 192 ? launch_dkv<192>(a) : launch_dkv<256>(a);
}
