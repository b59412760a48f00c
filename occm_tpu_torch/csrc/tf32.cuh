// 3xTF32: fp32 products on the tensor cores at close to fp32 accuracy, for
// the kernels that take fp32 (ffn_fwd_3xtf32.cu, flash_attn_bwd_3xtf32_*.cu).
//
// A tensor-core product reads TF32: fp32's sign and exponent with a 10-bit
// mantissa, about three decimal digits. Each fp32 operand x is split into
// x = hi + lo: hi is x with its 13 low mantissa bits cleared, a TF32 value
// exactly, and lo = x - hi, exact in fp32 and below 2^-10 |x|; the tensor
// cores read lo's leading 11 bits, which leaves at most 2^-20 |x| of x out.
// They truncate the bits they drop: on an H100 mma.sync m16n8k8 and wgmma
// m64n8k8 both read 1 + m 2^-14 (m = 0..63, either sign) as 1 + m 2^-14
// truncated to TF32, ties and all (probe_3xtf32.py), so x's raw fp32 bits
// read as its hi (flash_attn_fwd_3xtf32.cu writes only the lo tiles). Then
//   a b = a_hi b_hi + a_hi b_lo + a_lo b_hi + a_lo b_lo,
// and the kernels issue the first three terms. The dropped a_lo b_lo is
// below 2^-20 |a b|, where one TF32 product alone is off by up to
// 2^-10 |a b|.
// The tensor cores' fp32 accumulation does not round to nearest, and its
// error grows with the number of products added to one accumulator: on an
// H100 the attention backward's gradients summed over T = 1500 keys in one
// accumulator were off by up to 2.3e-5 of their largest value, where the
// FFMA kernel's read 1e-7 (PERF.md). The attention kernels therefore sum
// each 64-row tile's products in a fresh accumulator and add it to the
// running sum with an fp32 add, and keep the two small terms in an
// accumulator of their own, so that the large one takes one tensor-core
// rounding a k-step, not three; the FFN kernel adds a fresh accumulator
// to the tile's every 8 k-stages (K 256).
// Everything has internal linkage.

#pragma once

#include <stdint.h>

namespace {

// x = hi + lo: hi is x with its 13 low mantissa bits cleared (TF32
// exactly), lo = x - hi (exact in fp32); both as fp32 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d[16 x 8] += a[16 x 8] b[8 x 8], TF32 operands, fp32 accumulator, one
// warp (mma.sync m16n8k8, A row-major, B column-major). Fragments, with
// g = lane / 4 and t = lane % 4: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0 (g, 2t),
// d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in 3xTF32: the hi-hi term into d, the lo-hi and hi-lo terms into
// `small` (about 2^-10 of d, so its own rounding is negligible); the
// caller adds small to d at the end of the sum
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], float (&small)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(small, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(small, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

}  // namespace
