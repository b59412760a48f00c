// What the attention kernels (flash_attn_fwd.cu, flash_attn_bwd.cu) share:
// 64 x 64 bf16 tiles of a [B, T, H, 64] tensor read and written by TMA in
// the 128-byte swizzle, wgmma m64n64k16 with fp32 accumulators (both
// operands in shared memory, or A from registers), and the layout of the
// accumulator fragment. Everything has internal linkage.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int kD = 64;                   // head dim
constexpr int kTileRows = 64;            // rows (q rows or keys) of a tile
constexpr int kTileBytes = kTileRows * kD * 2;  // one bf16 tile: 8 KB

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

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (this thread's four
// bf16x2 of the m16n8k16-shaped fragment of its warp's 16 rows), B MN-major
// in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// Byte offset of element (row, c) of a 64 x 64 bf16 tile in TMA's 128-byte
// swizzle: 16-byte chunk c / 8 of a row sits at chunk (c / 8) ^ (row % 8).
__device__ __forceinline__ int swizzled(int row, int c) {
  return row * 128 + (((c >> 3) ^ (row & 7)) << 4) + (c & 7) * 2;
}

// Writes this thread's fragment of a 64 x 64 fp32 accumulator, times
// `mult` and rounded to bf16, into a swizzled tile for one TMA store.
__device__ __forceinline__ void stage_tile(unsigned char* tile,
                                           const float (&acc)[32], float mult,
                                           int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = warp * 16 + (lane >> 2) + 8 * row_half(i);
    *reinterpret_cast<uint32_t*>(tile + swizzled(row, col(i, lane))) =
        pack_bf16(acc[i] * mult, acc[i + 1] * mult);
  }
}

// A [B, T, H, 64] bf16 tensor with element strides sb, st, sh (D contiguous)
// in boxes of 64 t x 64 d of one (b, h).
inline int encode_bthd(CUtensorMap* map, const void* ptr, int b, int t, int h,
                       long long sb, long long st, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)h, (cuuint64_t)t,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kD, 1, (cuuint32_t)kTileRows, 1};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

inline bool bad_strides(const void* p, long long sb, long long st,
                        long long sh) {
  return (reinterpret_cast<uintptr_t>(p) & 15) || sb <= 0 || st <= 0 ||
         sh <= 0 || (sb | st | sh) & 7;
}

// The shared memory of a launch rounded up to the 128-byte swizzle's
// 1024-byte period.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

}  // namespace
