// Fused transformer FFN forward for Hopper (sm_90a), bf16 in and out:
//   y = GELU(x W1 + b1) W2 + b2
//
// Replaces the TPU Pallas kernel `_kernel` of occm_tpu/ops/ffn.py:50. Same
// arithmetic as it and as `_xla_ffn` (ffn.py:59-67, :100-105):
//   1. h = x W1 accumulated in fp32 on the tensor cores,
//   2. + b1 in fp32,
//   3. GELU in fp32, exact erf or the tanh form (jax.nn.gelu's formula, also
//      F.gelu(approximate="tanh")), chosen per call,
//   4. h rounded to bf16,
//   5. h W2 accumulated in fp32,
//   6. + b2 in fp32,
//   7. one rounding to bf16 for the output.
// The [M, F] hidden activation never goes to device memory.
//
// Layout: x [M, D] row-major; the weights as nn.Linear stores them, row-major
// fc1.weight [F, D] (= W1^T) and fc2.weight [D, F] (= W2^T), which is exactly
// the "col" B operand of mma.sync ... row.col; b1 [F], b2 [D]; y [M, D]. D and
// F are multiples of 64, D <= 1024. Rows >= M are loaded as zeros and never
// stored (the TPU wrapper pads M to 512 and crops instead).
//
// Where the TPU design does not carry over: the TPU kernel keeps one
// [512, 1024] fp32 accumulator (2 MB of VMEM) across a sequential sweep over
// F. A Hopper block has at most 227 KB of shared memory, and a [64, 1024]
// fp32 accumulator alone is 256 KB, so one block cannot own whole output
// rows. Here a block of 8 warps owns a 64-row tile of x and a 256-column
// slice of the output; grid (ceil(M/64), ceil(D/256)), 152 blocks at
// M = 2392. The x tile stays in shared memory for the whole block
// (64 x 1024 bf16, 132 KB with padding). The block loops over F in tiles of
// 64: s = x W1[:, tile] over K = D with W1 streamed in cp.async
// double-buffered 64 x 64 chunks; + b1, GELU, bf16 into a 64 x 64 shared
// tile h; then acc[64 x 256] += h W2[tile, slice], the fp32 accumulator in
// registers (64 a thread). Each block starts its F sweep at its own tile,
// so the blocks do not all stream the same weight lines at once. The
// epilogue adds b2, rounds and stores. Each block owns its outputs: no
// atomics, deterministic. 197 KB of shared memory at D = 1024: one block
// per SM.
//
// What bounds it on an H100: operations. At M = 2392, D = 1024, F = 4096 the
// function is 4 M D F = 4.013e10 flops against 2.66e7 bytes of x, the two
// weights, the biases and y: 0.0406 ms at 989 TFLOP/s against 0.0079 ms at
// 3.35 TB/s. This first version recomputes fc1 once per 256-column slice of
// the output (4 times at D = 1024), so it does 2.5x the function's flops, and
// it uses mma.sync rather than wgmma fed by TMA, which is what the tensor
// cores' peak needs; both are a later PR's work (the split-F design, each
// block owning an F chunk and writing fp32 partials that a second pass
// sums, does no recompute). A 4-deep cp.async ring with ldmatrix fragment
// loads measured slower than this double buffer. Its measured times are in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // rows of x per block
constexpr int kBN = 256;       // output columns per block
constexpr int kBF = 64;        // hidden columns per step of the F loop
constexpr int kBK = 64;        // depth of one streamed W1 chunk
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxD = 1024;    // the x tile must fit in shared memory
constexpr int kPad = 8;        // +16 bytes a row: conflict-free fragment loads
constexpr int kLdt = kBK + kPad;  // row stride of the W1, W2 and h tiles

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> two bf16 in one register, `lo` in the low half (lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float gelu(float v, int approximate) {
  if (approximate)
    return 0.5f * v *
           (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// A fragment (rows r, r + 8; columns k .. k + 15) of a row-major bf16 tile
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s,
                                       int ld, int r, int k, int g, int t) {
  a[0] = ld32(s + (r + g) * ld + k + t * 2);
  a[1] = ld32(s + (r + g + 8) * ld + k + t * 2);
  a[2] = ld32(s + (r + g) * ld + k + 8 + t * 2);
  a[3] = ld32(s + (r + g + 8) * ld + k + 8 + t * 2);
}

size_t smem_bytes(int d) {
  return sizeof(__nv_bfloat16) *
         ((size_t)kBM * (d + kPad) + 2 * kBF * kLdt + kBN * kLdt + kBM * kLdt);
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_fwd_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w1,   // fc1.weight [F, D]
               const __nv_bfloat16* __restrict__ b1,   // [F]
               const __nv_bfloat16* __restrict__ w2,   // fc2.weight [D, F]
               const __nv_bfloat16* __restrict__ b2,   // [D]
               __nv_bfloat16* __restrict__ y, int M, int D, int F,
               int approximate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = D + kPad;
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBM][ldx]
  __nv_bfloat16* sW1 = sX + kBM * ldx;     // [2][kBF][kLdt]: W1 chunk, f rows
  __nv_bfloat16* sW2 = sW1 + 2 * kBF * kLdt;  // [kBN][kLdt]: W2 tile, d rows
  __nv_bfloat16* sH = sW2 + kBN * kLdt;       // [kBM][kLdt]: GELU(h), bf16

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int m0 = blockIdx.x * kBM;
  const int d0 = blockIdx.y * kBN;
  const int n_out = min(kBN, D - d0);  // this block's output columns
  const int r0 = (warp & 3) * 16;      // the warp's 16 rows, both products
  const int c1 = (warp >> 2) * 32;     // its 32 hidden columns in fc1
  const int c2 = (warp >> 2) * 128;    // its 128 output columns in fc2
  const int nK = D / kBK;
  const int nF = F / kBF;

  // ---- the x tile, once; rows past M are zeros
  for (int i = tid; i < kBM * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    __nv_bfloat16* dst = sX + r * ldx + c;
    if (m0 + r < M)
      cp_async16(dst, x + (size_t)(m0 + r) * D + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }

  float acc[kBN / 2 / 8][4];  // the warp's 16 x 128 outputs, fp32
#pragma unroll
  for (int nt = 0; nt < kBN / 2 / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  // blocks start their F sweep at different tiles, so that they do not all
  // read the same W1 and W2 lines of L2 at the same time
  const int ft_start = (blockIdx.x + blockIdx.y * gridDim.x) % nF;
  for (int ft = 0; ft < nF; ++ft) {
    const int f0 = ((ft + ft_start) % nF) * kBF;
    __syncthreads();  // the previous step's products are done with every tile
    // W2 tile [d0 .. d0 + n_out) x [f0 .. f0 + 64) and W1 chunk 0, one group
    for (int i = tid; i < kBN * (kBF / 8); i += kThreads) {
      const int r = i / (kBF / 8), c = (i % (kBF / 8)) * 8;
      if (r < n_out)
        cp_async16(sW2 + r * kLdt + c, w2 + (size_t)(d0 + r) * F + f0 + c);
    }
    for (int i = tid; i < kBF * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      cp_async16(sW1 + r * kLdt + c, w1 + (size_t)(f0 + r) * D + c);
    }
    cp_async_commit();

    // ---- s = x W1[:, f0 .. f0 + 64): the warp's 16 rows x 32 columns
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int kc = 0; kc < nK; ++kc) {
      cp_async_wait_all();  // chunk kc (and at kc = 0 the W2 tile and x)
      __syncthreads();      // visible to all; chunk kc - 1's buffer is free
      if (kc + 1 < nK) {
        __nv_bfloat16* dst = sW1 + ((kc + 1) & 1) * kBF * kLdt;
        const int k0 = (kc + 1) * kBK;
        for (int i = tid; i < kBF * (kBK / 8); i += kThreads) {
          const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
          cp_async16(dst + r * kLdt + c, w1 + (size_t)(f0 + r) * D + k0 + c);
        }
        cp_async_commit();
      }
      const __nv_bfloat16* w1s = sW1 + (kc & 1) * kBF * kLdt;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[4];
        load_a(a, sX, ldx, r0, kc * kBK + kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat16* b = w1s + (c1 + nt * 8 + g) * kLdt + kk * 16 + t * 2;
          mma_16816(s[nt], a, ld32(b), ld32(b + 8));
        }
      }
    }

    // ---- + b1, GELU in fp32, bf16 into the shared h tile
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = c1 + nt * 8 + t * 2;
      const float bias0 = __bfloat162float(b1[f0 + col]);
      const float bias1 = __bfloat162float(b1[f0 + col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(sH + (r0 + g + h * 8) * kLdt + col) =
            pack_bf16(gelu(s[nt][2 * h] + bias0, approximate),
                      gelu(s[nt][2 * h + 1] + bias1, approximate));
    }
    __syncthreads();

    // ---- acc += h W2[f0 .. f0 + 64, slice]: the warp's 16 rows x 128 columns
#pragma unroll
    for (int kk = 0; kk < kBF / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sH, kLdt, r0, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < kBN / 2 / 8; ++nt) {
        if (c2 + nt * 8 < n_out) {  // warp-uniform
          const __nv_bfloat16* b = sW2 + (c2 + nt * 8 + g) * kLdt + kk * 16 + t * 2;
          mma_16816(acc[nt], a, ld32(b), ld32(b + 8));
        }
      }
    }
  }

  // ---- epilogue: + b2 in fp32, one bf16 rounding, rows below M
#pragma unroll
  for (int nt = 0; nt < kBN / 2 / 8; ++nt) {
    if (c2 + nt * 8 >= n_out) continue;
    const int d = d0 + c2 + nt * 8 + t * 2;
    const float bias0 = __bfloat162float(b2[d]);
    const float bias1 = __bfloat162float(b2[d + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + g + h * 8;
      if (row < M)
        *reinterpret_cast<uint32_t*>(y + (size_t)row * D + d) =
            pack_bf16(acc[nt][2 * h] + bias0, acc[nt][2 * h + 1] + bias1);
    }
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int occm_ffn_fwd(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* y, int m,
                            int d, int f, int approximate, void* stream) {
  if (m <= 0 || d <= 0 || f <= 0 || d % 64 || f % 64 || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + kBM - 1) / kBM, (d + kBN - 1) / kBN);
  ffn_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w1,
      (const __nv_bfloat16*)b1, (const __nv_bfloat16*)w2,
      (const __nv_bfloat16*)b2, (__nv_bfloat16*)y, m, d, f, approximate);
  return (int)cudaGetLastError();
}
