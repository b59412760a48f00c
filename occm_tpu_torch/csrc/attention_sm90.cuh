// What the attention kernels (flash_attn_fwd.cu, flash_attn_bwd.cu) share:
// bf16 tiles of 64 rows (q rows or keys) of a [B, T, H, D] tensor, read and
// written by TMA in the 128-byte swizzle as 64-column panels, wgmma with
// fp32 accumulators (both operands in shared memory, or A from registers),
// and the layout of the accumulator fragment. Everything has internal
// linkage.
//
// Head dims: the kernels are templates over NP = round_up(D, 16), the
// columns their products run over, for every D that is a multiple of 8
// from 8 to 256. A tile holds ceil(NP / 64) panels of 64 rows x 64 columns
// (8 KB each, one 128-byte swizzle span a row); TMA zero-fills the columns
// D..64 * panels - 1 of each tile, so they add nothing to a product. A
// product over D (q k^T, dO v^T) is NP / 16 k-steps, four to a panel; a
// product whose N is D (P v, dS k, P^T dO, dS^T q) is one wgmma m64nNPk16
// a k-step with its MN-major B operand spanning the panels through the
// descriptor's leading byte offset (the panel stride), as FlashAttention-3
// spans D 128, or above NP 128 two of them (wgmma_rs_np: the first two
// panels at N 128, the rest at N NP - 128). D = 64 is one panel and
// m64n64k16 throughout.
//
// The scale 1/sqrt(D): the instances <NP, true> fold it into q in fp32
// before the bf16 cast, as the TPU kernels do; <64, false> and <256, false>
// keep the unscaled q and scale the fp32 logits, which gives the same bits
// where the scale is a power of two (2^-3, 2^-4), and saves the backward
// its folded-q scratch tensor (for_instance).

#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kTileRows = 64;   // rows (q rows or keys) of a tile
constexpr int kPanelCols = 64;  // bf16 columns of a 128-byte swizzle panel
constexpr int kPanelBytes = kTileRows * kPanelCols * 2;  // 8 KB

// The tile geometry of head dims padded to NP columns (NP a multiple of 16,
// 16..256).
template <int NP>
struct HeadDim {
  static_assert(NP % 16 == 0 && NP >= 16 && NP <= 256, "NP: 16..256 by 16");
  static constexpr int kPanels = (NP + kPanelCols - 1) / kPanelCols;
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  static constexpr int kKSteps = NP / 16;  // k16 steps of a product over D
  // the wgmma descriptor's leading byte offset (16-byte units) of an
  // MN-major operand: the panel stride, unused by one panel
  static constexpr uint32_t kLbo = kPanels > 1 ? kPanelBytes / 16 : 1;
};

// Descriptor offset (16-byte units) of k-step kk of a K-major operand over
// D: +32 bytes a step within a panel, the next panel after four steps.
__device__ __forceinline__ uint64_t kstep(int kk) {
  return (kk >> 2) * (kPanelBytes / 16) + (kk & 3) * 2;
}

// d[64 x 64] (fp32, this warpgroup's fragment) += A[64 x 16] B[16 x 64],
// A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));  // scale-d = 1: d += a b
}

// d[64 x N] += A[64 x 16] B[16 x N], A from registers (this thread's four
// bf16x2 of the m16n8k16-shaped fragment of its warp's 16 rows), B MN-major
// in shared memory (transpose bit set); N = 16..128 by 16.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x NP] += A[64 x 16] B[16 x NP] as wgmma_rs, for NP = 16..256 by 16:
// one wgmma up to N 128; above it two, the first 128 columns (panels 0-1,
// registers 0-63) and the other NP - 128 (from panel 2 on, registers 64..),
// which together are the fragment of m64nNPk16. Both read the same A.
template <int NP>
__device__ __forceinline__ void wgmma_rs_np(float (&d)[NP / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (NP <= 128) {
    wgmma_rs<NP>(d, a, db);
  } else {
    wgmma_rs<128>(*reinterpret_cast<float(*)[64]>(&d[0]), a, db);
    wgmma_rs<NP - 128>(*reinterpret_cast<float(*)[NP / 2 - 64]>(&d[64]), a,
                       db + 2 * kPanelBytes / 16);
  }
}

// The accumulator fragment of wgmma m64nNk16 (fp32): register i of a thread
// holds row warp * 16 + lane / 4 + 8 * row_half(i), column col(i).
__device__ __forceinline__ int row_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int col(int i, int lane) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
}

// The fragment's key (or q-row) columns 16c .. 16c + 15, rounded to bf16,
// are the register A fragment of k-step c of a product over those columns
// (as FlashAttention-3 feeds P to P v).
__device__ __forceinline__ void pack_a(uint32_t (&a)[kTileRows / 16][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int c = 0; c < kTileRows / 16; ++c) {
    a[c][0] = pack_bf16(x[8 * c + 0], x[8 * c + 1]);
    a[c][1] = pack_bf16(x[8 * c + 2], x[8 * c + 3]);
    a[c][2] = pack_bf16(x[8 * c + 4], x[8 * c + 5]);
    a[c][3] = pack_bf16(x[8 * c + 6], x[8 * c + 7]);
  }
}

// Byte offset of element (row, c) of a 64 x 64 bf16 panel in TMA's 128-byte
// swizzle: 16-byte chunk c / 8 of a row sits at chunk (c / 8) ^ (row % 8).
__device__ __forceinline__ int swizzled(int row, int c) {
  return row * 128 + (((c >> 3) ^ (row & 7)) << 4) + (c & 7) * 2;
}

// Byte offset of element (row, c) of a tile of 64-column panels.
__device__ __forceinline__ int tile_offset(int row, int c) {
  return (c >> 6) * kPanelBytes + swizzled(row, c & 63);
}

// Byte offset in a tile of register pair (i, i + 1) of this thread's
// fragment of a 64 x N accumulator (N > 64): panel i / 32, whose offsets
// are those of a 64 x 64 tile.
__device__ __forceinline__ int fragment_offset(int i, int warp, int lane) {
  const int row = warp * 16 + (lane >> 2) + 8 * row_half(i);
  return (i >> 5) * kPanelBytes + swizzled(row, col(i & 31, lane));
}

// Writes this thread's fragment of a 64 x N fp32 accumulator, times `mult`
// and rounded to bf16, into a swizzled tile for TMA stores. (N <= 64 keeps
// the one-panel arithmetic of the D = 64 kernels as it was.)
template <int N>
__device__ __forceinline__ void stage_tile(unsigned char* tile,
                                           const float (&acc)[N / 2],
                                           float mult, int warp, int lane) {
  if constexpr (N > kPanelCols) {
#pragma unroll
    for (int i = 0; i < N / 2; i += 2)
      *reinterpret_cast<uint32_t*>(tile + fragment_offset(i, warp, lane)) =
          pack_bf16(acc[i] * mult, acc[i + 1] * mult);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; i += 2) {
      const int row = warp * 16 + (lane >> 2) + 8 * row_half(i);
      *reinterpret_cast<uint32_t*>(tile + swizzled(row, col(i, lane))) =
          pack_bf16(acc[i] * mult, acc[i + 1] * mult);
    }
  }
}

// q * scale rounded to bf16 in place, over the first NP columns of a tile
// that TMA has loaded (the zero-filled columns stay zero): the scale folded
// into q in fp32 before the bf16 products, as the TPU kernels and the plain
// version fold it. Thread `tid` of `threads` takes every threads-th 16-byte
// chunk; the caller orders the writes before wgmma reads them
// (fence_proxy_async, then a barrier).
template <int NP>
__device__ __forceinline__ void fold_scale(unsigned char* tile, float scale,
                                           int tid, int threads) {
  constexpr int kRowChunks = NP / 8;
  for (int i = tid; i < kTileRows * kRowChunks; i += threads) {
    uint4* p = reinterpret_cast<uint4*>(
        tile + tile_offset(i / kRowChunks, (i % kRowChunks) * 8));
    uint4 u = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      w[e] = pack_bf16(f.x * scale, f.y * scale);
    }
    *p = u;
  }
}

// A [B, T, H, d] bf16 tensor with element strides sb, st, sh (d contiguous)
// in boxes of 64 d x 64 t of one (b, h): one box a panel, columns d and up
// zero-filled on loads and clipped on stores.
inline int encode_bthd(CUtensorMap* map, const void* ptr, int b, int t, int h,
                       int d, long long sb, long long st, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanelCols, 1, (cuuint32_t)kTileRows,
                             1};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

inline bool bad_strides(const void* p, long long sb, long long st,
                        long long sh) {
  return (reinterpret_cast<uintptr_t>(p) & 15) || sb <= 0 || st <= 0 ||
         sh <= 0 || (sb | st | sh) & 7;
}

// Whether the wgmma kernels take head dim d: a multiple of 8 from 8 to
// max_d (256 for bf16, 128 for the 3xTF32 forward).
inline bool head_dim_ok(int d, int max_d = 256) {
  return d >= 8 && d <= max_d && d % 8 == 0;
}

template <int NP>
using Np = std::integral_constant<int, NP>;

// f(Np<NP>{}) where NP <= kMaxNP, else cudaErrorInvalidValue (never
// reached past head_dim_ok), so that no instance above kMaxNP is compiled.
template <int NP, int kMaxNP, typename F>
int instance_upto(F& f) {
  if constexpr (NP <= kMaxNP)
    return f(Np<NP>{});
  else
    return (int)cudaErrorInvalidValue;
}

// f(Np<round_up(d, 16)>{}): the instance of a head dim that head_dim_ok
// takes, compiled for NP up to kMaxNP.
template <int kMaxNP = 256, typename F>
int for_head_dim(int d, F f) {
  switch ((d + 15) / 16 * 16) {
    case 16: return instance_upto<16, kMaxNP>(f);
    case 32: return instance_upto<32, kMaxNP>(f);
    case 48: return instance_upto<48, kMaxNP>(f);
    case 64: return instance_upto<64, kMaxNP>(f);
    case 80: return instance_upto<80, kMaxNP>(f);
    case 96: return instance_upto<96, kMaxNP>(f);
    case 112: return instance_upto<112, kMaxNP>(f);
    case 128: return instance_upto<128, kMaxNP>(f);
    case 144: return instance_upto<144, kMaxNP>(f);
    case 160: return instance_upto<160, kMaxNP>(f);
    case 176: return instance_upto<176, kMaxNP>(f);
    case 192: return instance_upto<192, kMaxNP>(f);
    case 208: return instance_upto<208, kMaxNP>(f);
    case 224: return instance_upto<224, kMaxNP>(f);
    case 240: return instance_upto<240, kMaxNP>(f);
    case 256: return instance_upto<256, kMaxNP>(f);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Whether head dim d takes the instance that scales the fp32 logits
// (fold = false): d 64 and 256, whose scales 2^-3 and 2^-4 give the folded
// q's bits.
inline bool logits_instance(int d) { return d == 64 || d == 256; }

// f(Np<NP>{}, std::bool_constant<fold>{}): the instance of head dim d, the
// scale folded into q (fold) or on the logits (where logits_instance(d)).
template <typename F>
int for_instance(int d, bool fold, F f) {
  if (!fold)
    return d == 64 ? f(Np<64>{}, std::false_type{})
                   : f(Np<256>{}, std::false_type{});
  return for_head_dim(d, [&](auto np) { return f(np, std::true_type{}); });
}

// The shared memory of a launch rounded up to the 128-byte swizzle's
// 1024-byte period.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

}  // namespace
