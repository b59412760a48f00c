// Flash-attention forward for Hopper (sm_90a) in fp32 on the tensor cores,
// 3xTF32: wgmma fed by TMA, at every head dim D that is a multiple of 8
// from 8 to 128 that ops/attention.py's forward route gives it.
//
// Replaces, in fp32, the two TPU Pallas forward kernels of
// occm_tpu/ops/attention.py, which compute the same function and differ
// only in how they fit the TPU's VMEM:
//   _fwd_kernel          (attention.py:45)  whole-T forward
//   _blocked_fwd_kernel  (attention.py:234) online-softmax forward + lse
// in place of the generic forward (flash_attn_generic.cu, FFMA on the CUDA
// cores), which keeps the fp32 head dims this kernel does not take. One
// kernel covers every T. The arithmetic is flash_attention_reference's
// (ops/attention.py) in fp32:
//   - qs = q * scale in fp32 (the scale folded into q, attention.py:253);
//     S = qs k^T with fp32 sums; keys >= t_valid masked to -1e30;
//   - an online softmax in fp32 over kv tiles of 64 keys, in base 2 (the
//     exponent is exp2f of S log2 e - m log2 e);
//   - the unnormalised P times v summed in fp32, divided by the row sum at
//     the end;
//   - lse = m + log(max(l, 1e-30)) per row, natural log, [B * H, T] fp32,
//     which the 3xTF32 backward reads.
// Every product is three TF32 products (tf32.cuh): x = hi + lo with hi = x
// with its 13 low mantissa bits cleared and lo = x - hi; a b is taken as
// a_hi b_hi into one accumulator and a_hi b_lo + a_lo b_hi into a small one
// of its own, added at the end of the product. Each kv tile's P v is
// summed in fresh accumulators and added to the running O in fp32
// (O <- alpha O + tile), so the tensor cores' own accumulation never runs
// over more than 64 keys (tf32.cuh).
// Where hi lives: the tensor cores truncate the 13 bits TF32 drops
// (probe_3xtf32.py on an H100, mma.sync and wgmma alike), so an fp32
// operand's raw bits read as its hi. The k tile as TMA lays it down is
// its own hi (the split writes only its lo tile), the transposed v tile's
// hi is v's raw values, and P's hi fragment is P's raw bits; only q, scaled
// first, is written back.
//
// Layout: q, k, v are [B, T, H, D] fp32 with any strides for B, T and H
// (16-byte multiples) and D contiguous: the projections' output, read where
// they leave it through 4-d TMA maps of (D, H, T, B) with (32, 1, 64, 1)
// boxes, one box a panel of 64 rows x 32 fp32 (one 128-byte swizzle span
// a row; ceil(NP / 32) panels a tile, the columns past D zero-filled).
// out is written contiguous as [B, T, H, D]; [BH, T, D] is the case
// B = BH, H = 1.
//
// Operand majors: TF32 wgmma takes both operands K-major only. S = qs k^T
// reads q and k K-major as TMA lays them down (the head dim is K). For
// O += P v the K axis is the keys: P comes from the S accumulator in
// registers (the A operand), and v is written transposed, K-major, once a
// tile. The accumulator fragment (rows g, g + 8; columns 2t, 2t + 1 of
// each 8) is not the A fragment of a k8 step (columns t, t + 4), so A's
// column j of k-step c is key 8c + perm(j), perm(j) = 2 (j % 4) + j / 4,
// and the transposed v tile holds key 8c + perm(j) at position j: the sum
// over the 8 keys is the same, and no register moves between threads (the
// mma.sync form of this is flash_attn_bwd_3xtf32_dq.cu's).
//
// Block: 64 q rows a consumer warpgroup, kWG of them (two at NP =
// round_up(D, 16) <= 64, one above), and one producer warpgroup:
//   - its warp 0, lane 0 loads the q tiles once and the k and v tiles of
//     each kv tile into a ring of kStages stages by TMA (full / empty
//     mbarriers); TMA zero-fills rows past T;
//   - its warps 1-3 split each stage as it lands (`ready` mbarrier): k's lo
//     tile, of the same swizzled layout as k, and v into transposed hi
//     and lo tiles [NP rows x 64 keys] (two 32-key panels
//     of the 128-byte swizzle, keys permuted as above; a warp's 32 lanes
//     take 32 keys of one 4-column group, so its reads and writes are
//     free of bank conflicts), while the consumers compute the previous
//     stage;
//   - each consumer warpgroup scales and splits its own q tile once, then
//     per kv tile: S in NP / 8 k8 steps of three wgmma m64n64k8 (q and k
//     hi / lo from shared memory), the mask (only on a tile that reaches
//     t_valid), the online softmax, P split in registers, and P v in 8 k8
//     steps of three wgmma m64nNk8 with A from registers (N = NP, or 64
//     then NP - 64 above 64 columns, so that the tile's two accumulators
//     stay within the register budget). A warpgroup whose 64 rows all lie
//     past T only passes the stages on.
// The epilogue divides by the row sum and stores out from the accumulator
// fragment as float2 (rows past T and columns past D masked), and lse.
//
// Shared memory (TB = a 64-row tile, ceil(NP / 32) x 8 KB; VB = a
// transposed v tile, NP x 256 bytes): q hi and lo 2 kWG TB, and per stage
// k, k lo, v and the transposed v hi and lo, 3 TB + 2 VB, + 1 KB of
// alignment + the mbarriers: at NP 16 / 32 / 48 / 64 (two consumer
// warpgroups, two stages) 97 / 113 / 209 / 225 KB; at NP 80 / 96 / 112 /
// 128 (one, one stage) 161 / 169 / 217 / 225 KB. Registers (ptxas,
// sm_90a): 168 at launch at NP 16-64 (384 threads; setmaxnreg gives the
// consumers 232 and the producer 40), no spills; 241 / 255 / 255 / 255 at
// NP 80 / 96 / 112 / 128 (256 threads), spilling 8 bytes at 112 and 220
// at 128. One block an SM at every NP (registers allow one block of 384
// threads; from NP 48 shared memory allows one too).
//
// What bounds it on an H100: operations. At B 8, H 16, T 299, D 64 the
// function is 4 BH T^2 D = 2.929e9 flops, which 3xTF32 issues three
// times: 0.0178 ms at TF32's 495 TFLOP/s, against 0.012 ms for the 39 MB of
// q, k, v, out and lse at 3.35 TB/s (0.044 ms at fp32's 67 TFLOP/s on the
// CUDA cores, the generic kernel's bound). It takes 0.063 ms there and
// 0.999 ms at T 1500 (28 % and 45 % of the bound; PERF.md). What limits
// it, from probe_3xtf32.py's one-edit variants on the same card: with one
// product a k-step (hi hi only, in S and P v) it takes 0.048 / 0.694 ms,
// and with no split pass (the splitting warps write nothing) 0.050 /
// 0.744 ms: the two small products and the split in shared memory each
// cost about a quarter of its time; the softmax and the split of P run
// between a warpgroup's products (two warpgroups overlap them where
// NP <= 64), and S reads both operands from shared memory. Above NP 64
// one stage leaves a tile's load and split unhidden.

#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

constexpr int kRows = 64;        // q rows of a consumer warpgroup
constexpr int kKeys = 64;        // keys of a kv tile
constexpr int kPanelF32 = 32;    // fp32 columns of a 128-byte swizzle panel
constexpr int kSplitters = 96;   // the producer warpgroup's warps 1-3
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;  // a block's shared memory on an H100

// q tiles, `stages` stages, + 1 KB to align the tiles to the 128-byte
// swizzle's 1024-byte period, + the mbarriers
constexpr int fwd3_smem(int q_bytes, int stage_bytes, int stages) {
  return q_bytes + stages * stage_bytes + 1024 + (3 * stages + 1) * 8;
}

// The geometry of head dims padded to NP columns (NP a multiple of 16,
// 16..128).
template <int NP>
struct Fwd3 {
  static_assert(NP % 16 == 0 && NP >= 16 && NP <= 128, "NP: 16..128 by 16");
  static constexpr int kWG = NP <= 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kPanels = (NP + kPanelF32 - 1) / kPanelF32;
  static constexpr int kTB = kPanels * kPanelBytes;  // a 64-row tile
  static constexpr int kVB = NP * 256;  // a transposed v tile
  static constexpr int kQBytes = 2 * kWG * kTB;  // q hi, q lo
  static constexpr int kStageBytes = 3 * kTB + 2 * kVB;
  static constexpr int kStages =
      fwd3_smem(kQBytes, kStageBytes, 2) <= kSmemLimit ? 2 : 1;
  static constexpr int kSmem = fwd3_smem(kQBytes, kStageBytes, kStages);
  static_assert(kSmem <= kSmemLimit, "shared memory");
  // offsets in a stage: k as loaded (its own hi), k lo, v as loaded,
  // v^T hi, v^T lo
  static constexpr int kKLo = kTB, kV = 2 * kTB, kVtHi = 3 * kTB,
                       kVtLo = 3 * kTB + kVB;
};

// d[64 x 64] (fp32, this warpgroup's fragment) += A[64 x 8] B[64 x 8]^T,
// TF32, both operands K-major in shared memory
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));  // scale-d = 1: d += a b
}

// d[64 x N] += A[64 x 8] B[N x 8]^T, TF32, A from registers (this thread's
// a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of its
// warp's 16 rows), B K-major in shared memory; N = 16..64 by 16.
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_tf32<16>(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<48>(float (&d)[24],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Byte offset of element (row, c) of a 64-row fp32 tile of 32-column panels
// in TMA's 128-byte swizzle: 16-byte chunk c / 4 of a row sits at chunk
// (c / 4) ^ (row % 8).
__device__ __forceinline__ int f32_offset(int row, int c) {
  return (c >> 5) * kPanelBytes + row * 128 +
         ((((c & 31) >> 2) ^ (row & 7)) << 4) + (c & 3) * 4;
}

// The TF32 lo of fp32 x (x - hi, exact); x's raw bits read as its hi
__device__ __forceinline__ float lo_tf32(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// n float4 of `raw` times `mult` (q's scale, or 1) have their TF32 lo
// written to `lo` at the same index and, where `mult` is not 1, their
// product written back in place (its raw bits read as its hi); thread tid
// of `threads` takes every threads-th
template <bool kScale>
__device__ __forceinline__ void split_tile(float4* raw, float4* lo, int n,
                                           float mult, int tid,
                                           int threads) {
  for (int i = tid; i < n; i += threads) {
    float4 v = raw[i];
    if constexpr (kScale) {
      v = make_float4(v.x * mult, v.y * mult, v.z * mult, v.w * mult);
      raw[i] = v;
    }
    lo[i] = make_float4(lo_tf32(v.x), lo_tf32(v.y), lo_tf32(v.z),
                        lo_tf32(v.w));
  }
}

// The v tile as loaded (64 keys x NP of 32-column panels) split into its
// transpose's hi (v's raw values) and lo tiles: NP rows (head dims) x 64
// keys, as two
// 32-key panels of NP rows in the 128-byte swizzle, key 8c + perm(j) at
// position 8c + j (perm(j) = 2 (j % 4) + j / 4). Consecutive threads take
// consecutive keys of one 4-column group: their float4 reads cover the 8
// swizzled chunks and their 4-byte writes the 32 banks of one row.
template <int NP>
__device__ __forceinline__ void split_v(const unsigned char* v,
                                        unsigned char* vt_hi,
                                        unsigned char* vt_lo, int tid) {
  for (int i = tid; i < kKeys * NP / 4; i += kSplitters) {
    const int key = i % kKeys, n0 = (i / kKeys) * 4;
    const float4 x =
        *reinterpret_cast<const float4*>(v + f32_offset(key, n0));
    // position of the key: within its group of 8, key r sits at j with
    // perm(j) = r
    const int pos = (key & ~7) + ((key & 7) >> 1) + 4 * (key & 1);
    const int base = (pos >> 5) * (NP * 128) + (((pos & 31) & 3) << 2);
    const int chunk = (pos & 31) >> 2;
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + e;
      const int off = base + n * 128 + ((chunk ^ (n & 7)) << 4);
      *reinterpret_cast<float*>(vt_hi + off) = xs[e];
      *reinterpret_cast<float*>(vt_lo + off) = lo_tf32(xs[e]);
    }
  }
}

// o[C0 / 2 ..] += P[64 x 64 keys] v[64 keys x N] for head-dim columns
// C0 .. C0 + N - 1, 3xTF32: k-step c's A is P's hi or lo fragment of keys
// 8c + perm(j), B the transposed v's rows C0.. of the same keys; the
// tile's sum in fresh accumulators, added to o in fp32.
template <int NP, int C0, int N>
__device__ __forceinline__ void pv_product(float (&o)[NP / 2],
                                           const uint32_t (&p_hi)[8][4],
                                           const uint32_t (&p_lo)[8][4],
                                           uint32_t vt_hi, uint32_t vt_lo) {
  float tile[N / 2], small[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) tile[i] = small[i] = 0.f;
  fence_acc(tile);
  fence_acc(small);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kKeys / 8; ++c) {
    // key panel c / 4, +32 bytes a k8 step within it, rows C0..
    const uint32_t off = (c >> 2) * (NP * 128) + C0 * 128;
    const uint64_t dh = smem_desc(vt_hi + off) + (c & 3) * 2;
    const uint64_t dl = smem_desc(vt_lo + off) + (c & 3) * 2;
    wgmma_rs_tf32<N>(small, p_lo[c], dh);
    wgmma_rs_tf32<N>(small, p_hi[c], dl);
    wgmma_rs_tf32<N>(tile, p_hi[c], dh);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(tile);
  fence_acc(small);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) o[C0 / 2 + i] += tile[i] + small[i];
}

// grid (ceil(T / (64 kWG)), H, B); out [B, T, H, D] contiguous
template <int NP>
__global__ void __launch_bounds__(Fwd3<NP>::kThreads, 1)
flash_attn_fwd_3xtf32_kernel(const __grid_constant__ CUtensorMap tma_q,
                             const __grid_constant__ CUtensorMap tma_k,
                             const __grid_constant__ CUtensorMap tma_v,
                             float* __restrict__ out,
                             float* __restrict__ lse, int T, int t_valid,
                             int D, float scale) {
  using G = Fwd3<NP>;
  constexpr int kWG = G::kWG, kStages = G::kStages, kTB = G::kTB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* stages = smem + G::kQBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + kStages * G::kStageBytes);
  uint64_t* ready = full + kStages;  // a stage split, for the consumers
  uint64_t* empty = ready + kStages;
  uint64_t* q_full = empty + kStages;

  const int q0 = blockIdx.x * kRows * kWG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (t_valid + kKeys - 1) / kKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSplitters);
      mbar_init(&empty[s], 4 * kWG);  // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kWG) {
    if constexpr (kWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int tid = threadIdx.x - 128 * kWG;
    if (tid == 0) {
      // ---- producer: the q tiles once, then the ring of k and v tiles
      mbar_expect_tx(q_full, kWG * kTB);
      for (int w = 0; w < kWG; ++w)
#pragma unroll
        for (int p = 0; p < G::kPanels; ++p)
          tma_load_4d(smem + w * kTB + p * kPanelBytes, &tma_q, q_full,
                      p * kPanelF32, h, q0 + w * kRows, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        unsigned char* st = stages + s * G::kStageBytes;
        mbar_expect_tx(&full[s], 2 * kTB);
#pragma unroll
        for (int p = 0; p < G::kPanels; ++p) {
          tma_load_4d(st + p * kPanelBytes, &tma_k, &full[s], p * kPanelF32,
                      h, j * kKeys, b);
          tma_load_4d(st + G::kV + p * kPanelBytes, &tma_v, &full[s],
                      p * kPanelF32, h, j * kKeys, b);
        }
      }
    } else if (tid >= 128 - kSplitters) {
      // ---- splitters: each stage as it lands, while the consumers
      // compute the previous one
      const int sid = tid - (128 - kSplitters);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&full[s], (j / kStages) & 1);
        unsigned char* st = stages + s * G::kStageBytes;
        split_tile<false>(reinterpret_cast<float4*>(st),
                          reinterpret_cast<float4*>(st + G::kKLo), kTB / 16,
                          1.f, sid, kSplitters);
        split_v<NP>(st + G::kV, st + G::kVtHi, st + G::kVtLo, sid);
        // generic-proxy writes, then wgmma (async proxy) reads them
        fence_proxy_async();
        mbar_arrive(&ready[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: q rows q0 + 64 wg ..
  if constexpr (kWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int row0 = q0 + wg * kRows;
  const bool idle = row0 >= T;  // every row of this warpgroup past T
  unsigned char* q_hi = smem + wg * kTB;
  unsigned char* q_lo = smem + (kWG + wg) * kTB;
  mbar_wait(q_full, 0);
  if (!idle) {
    // qs = q * scale in fp32, split once
    split_tile<true>(reinterpret_cast<float4*>(q_hi),
                     reinterpret_cast<float4*>(q_lo), kTB / 16, scale,
                     threadIdx.x & 127, 128);
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
  }
  const uint64_t dqh = smem_desc(smem_u32(q_hi));
  const uint64_t dql = smem_desc(smem_u32(q_lo));

  float o[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) o[i] = 0.f;
  // running max of the logits and per-thread partial row sums, for rows
  // lane / 4 and lane / 4 + 8 of this warp
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(&ready[s], (j / kStages) & 1);
    if (!idle) {
      const int kv0 = j * kKeys;
      unsigned char* st = stages + s * G::kStageBytes;
      const uint64_t dkh = smem_desc(smem_u32(st));
      const uint64_t dkl = smem_desc(smem_u32(st + G::kKLo));

      // ---- S = qs k^T: hi hi into sc, hi lo + lo hi into ss
      float sc[32], ss[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = ss[i] = 0.f;
      fence_acc(sc);
      fence_acc(ss);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 8; ++kk) {  // +32 bytes along D a k8 step
        wgmma_ss_tf32(ss, dql + kstep(kk), dkh + kstep(kk));
        wgmma_ss_tf32(ss, dqh + kstep(kk), dkl + kstep(kk));
        wgmma_ss_tf32(sc, dqh + kstep(kk), dkh + kstep(kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(ss);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] += ss[i];

      // ---- key mask (the tile that reaches t_valid), row max
      if (kv0 + kKeys > t_valid) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (kv0 + col(i, lane) >= t_valid) sc[i] = kMasked;
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[row_half(i)] = fmaxf(mx[row_half(i)], sc[i]);
      float alpha[2], m_log2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m_run[r] - mx[r]) * kLog2e);
        m_run[r] = mx[r];
        m_log2[r] = mx[r] * kLog2e;
        l_run[r] *= alpha[r];
      }
      // ---- p = exp(s - m), unnormalised, fp32 row sums
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = exp2f(fmaf(sc[i], kLog2e, -m_log2[row_half(i)]));
        l_run[row_half(i)] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) o[i] *= alpha[row_half(i)];

      // ---- P split into A fragments: k-step c's a0..a3 are keys
      // 8c + 2t (rows g, g + 8), then 8c + 2t + 1 (rows g, g + 8); the hi
      // fragment is P's raw bits
      uint32_t p_hi[8][4], p_lo[8][4];
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[4 * c + (e >> 1) + 2 * (e & 1)];
          p_hi[c][e] = __float_as_uint(x);
          p_lo[c][e] = __float_as_uint(lo_tf32(x));
        }
      // ---- o += P v
      const uint32_t vt_hi = smem_u32(st + G::kVtHi);
      const uint32_t vt_lo = smem_u32(st + G::kVtLo);
      if constexpr (NP <= 64) {
        pv_product<NP, 0, NP>(o, p_hi, p_lo, vt_hi, vt_lo);
      } else {
        pv_product<NP, 0, 64>(o, p_hi, p_lo, vt_hi, vt_lo);
        pv_product<NP, 64, NP - 64>(o, p_hi, p_lo, vt_hi, vt_lo);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (idle) return;

  // ---- epilogue: full row sums, out = o / l as float2, lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int H = gridDim.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= T) continue;
    float* dst = out + (((size_t)b * T + row) * H + h) * D;
    const float inv = 1.f / l_run[r];
#pragma unroll
    for (int i = 2 * r; i < NP / 2; i += 4) {  // registers of row half r
      const int c = col(i, lane);
      if (c < D)
        *reinterpret_cast<float2*>(dst + c) =
            make_float2(o[i] * inv, o[i + 1] * inv);
    }
    if ((lane & 3) == 0)
      lse[((size_t)b * H + h) * T + row] =
          m_run[r] + logf(fmaxf(l_run[r], 1e-30f));
  }
}

// A [B, T, H, d] fp32 tensor with element strides sb, st, sh (d contiguous)
// in boxes of 32 d x 64 t of one (b, h): one box a panel, columns d and up
// zero-filled.
int encode_bthd_f32(CUtensorMap* map, const void* ptr, int b, int t, int h,
                    int d, long long sb, long long st, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 4, (cuuint64_t)st * 4,
                                 (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {(cuuint32_t)kPanelF32, 1, (cuuint32_t)kRows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 4, dims,
                    strides, box);
}

bool bad_f32_strides(const void* p, long long sb, long long st,
                     long long sh) {
  return (reinterpret_cast<uintptr_t>(p) & 15) || sb <= 0 || st <= 0 ||
         sh <= 0 || (sb | st | sh) & 3;
}

// One launch of the instance for NP.
template <int NP>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, float* out, float* lse, int b, int h,
           int T, int t_valid, int d, float scale, cudaStream_t stream) {
  using G = Fwd3<NP>;
  // once per process and instance (a thread-safe static), so that a launch
  // captured into a CUDA graph makes no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_fwd_3xtf32_kernel<NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int rows = kRows * G::kWG;
  const dim3 grid((T + rows - 1) / rows, h, b);
  flash_attn_fwd_3xtf32_kernel<NP><<<grid, G::kThreads, G::kSmem, stream>>>(
      mq, mk, mv, out, lse, T, t_valid, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [b, T, h, d] fp32, d a multiple of 8 from 8 to 128 and
// contiguous, element strides (sb, st, sh) each, multiples of 4, 16-byte
// aligned; out: [b, T, h, d] fp32 contiguous, 8-byte aligned; lse:
// [b * h, T] fp32. Keys at index >= t_valid are masked. One launch on
// `stream` of the instance for round_up(d, 16). Returns 0, a cudaError_t,
// or -1 / -1000 - CUresult when a TMA descriptor cannot be made.
extern "C" int occm_flash_attn_3xtf32_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int b,
    int h, int T, int t_valid, int d, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, float scale,
    void* stream) {
  if (!head_dim_ok(d, 128) || b <= 0 || b > 65535 || h <= 0 || h > 65535 ||
      T <= 0 || t_valid <= 0 || t_valid > T ||
      bad_f32_strides(q, q_sb, q_st, q_sh) ||
      bad_f32_strides(k, k_sb, k_st, k_sh) ||
      bad_f32_strides(v, v_sb, v_st, v_sh) ||
      (reinterpret_cast<uintptr_t>(out) & 7))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = encode_bthd_f32(&mq, q, b, T, h, d, q_sb, q_st, q_sh);
  if (!err) err = encode_bthd_f32(&mk, k, b, T, h, d, k_sb, k_st, k_sh);
  if (!err) err = encode_bthd_f32(&mv, v, b, T, h, d, v_sb, v_st, v_sh);
  if (err) return err;
  return for_head_dim<128>(d, [&](auto np) {
    return launch<decltype(np)::value>(mq, mk, mv, (float*)out, (float*)lse,
                                       b, h, T, t_valid, d, scale,
                                       (cudaStream_t)stream);
  });
}
