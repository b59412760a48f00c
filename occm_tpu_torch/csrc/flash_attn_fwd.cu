// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces two TPU Pallas kernels of occm_tpu/ops/attention.py, which compute
// the same function and differ only in how they fit the TPU's VMEM:
//   _fwd_kernel          (attention.py:45)  whole-T forward, T padded <= 512
//   _blocked_fwd_kernel  (attention.py:234) online-softmax forward + lse
// One kernel covers both: out = softmax(scale * q k^T, keys >= t_valid masked
// to -1e30) v, with
//   - the scale folded into q in fp32 before the bf16 cast,
//   - q k^T accumulated in fp32 on the tensor cores,
//   - an online softmax in fp32 over kv tiles of 64 keys,
//   - the unnormalised probabilities cast to bf16 for the P v product,
//   - P v accumulated in fp32 and divided by the row sum at the end,
//   - out written in bf16 and lse = m + log(max(l, 1e-30)) per row in fp32.
//
// Layout: q, k, v, out are [BH, T, D] row-major bf16 with D = 64; lse is
// [BH, T] fp32. Grid: one block of 4 warps per (64-row q tile, b*h); the kv
// sweep is a loop inside the block, in place of the TPU's sequential grid
// axis. Each warp owns 16 q rows; S and O live in registers as mma.sync
// m16n8k16 fragments, and the S accumulator fragment is re-packed in
// registers as the A operand of P v (no shared-memory round trip for P).
// Rows past T are loaded as zeros and never stored.
//
// What bounds it on an H100: at the serving shapes (B*H = 128, T = 299 or
// 599, D = 64) the work is 4*BH*T*T*D flops (2.9 and 11.8 GFLOP) against
// 8*BH*T*D bytes of q, k, v and out (9.8 and 19.6 MB): about 3 us for either
// bound at T = 299 and 12 us of tensor-core time at T = 599. This first
// version uses synchronous loads and mma.sync, which cannot reach the
// tensor-core peak (that needs wgmma fed by TMA, with loads overlapping the
// math); it is written to be right and simple, and its measured times are
// in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBM = 64;       // q rows per block
constexpr int kBN = 64;       // keys per kv tile
constexpr int kWarps = 4;     // 16 q rows per warp
constexpr int kLds = kD + 8;  // padded smem row: 144 bytes, conflict-free fragment loads

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kWarps * 32)
flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse,
                      int T, int t_valid, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBM][kLds];
  __shared__ __align__(16) __nv_bfloat16 sK[kBN][kLds];
  __shared__ __align__(16) __nv_bfloat16 sVt[kD][kLds];  // V transposed: [d][key]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int q0 = blockIdx.x * kBM;
  const size_t base = (size_t)blockIdx.y * T * kD;

  // ---- q tile -> smem, scale folded in fp32 before the bf16 cast
  for (int i = tid; i < kBM * (kD / 8); i += kWarps * 32) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < T) {
      raw = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * kD + c);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(&sQ[r][c]) = raw;
  }
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    qa[kk][0] = ld32(&sQ[r0 + g][kk * 16 + t * 2]);
    qa[kk][1] = ld32(&sQ[r0 + g + 8][kk * 16 + t * 2]);
    qa[kk][2] = ld32(&sQ[r0 + g][kk * 16 + 8 + t * 2]);
    qa[kk][3] = ld32(&sQ[r0 + g + 8][kk * 16 + 8 + t * 2]);
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  // running max and (per-thread partial) sum for rows g and g + 8
  float m_run[2] = {-1e30f, -1e30f};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (t_valid + kBN - 1) / kBN;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kBN;
    __syncthreads();  // previous tile's fragments are consumed
    for (int i = tid; i < kBN * (kD / 8); i += kWarps * 32) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (kv0 + r < T) {
        const size_t off = base + (size_t)(kv0 + r) * kD + c;
        kr = *reinterpret_cast<const uint4*>(k + off);
        vr = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&sK[r][c]) = kr;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[c + j][r] = ve[j];
    }
    __syncthreads();

    // ---- S = q k^T for this warp's 16 rows x 64 keys, fp32
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        mma_16816(s[nt], qa[kk], ld32(&sK[nt * 8 + g][kk * 16 + t * 2]),
                  ld32(&sK[nt * 8 + g][kk * 16 + 8 + t * 2]));
    }

    // ---- key mask, row max over the tile
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kv0 + nt * 8 + t * 2 + (j & 1);
        if (key >= t_valid) s[nt][j] = -1e30f;
        mx[j >> 1] = fmaxf(mx[j >> 1], s[nt][j]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[nt][j] = expf(s[nt][j] - m_run[j >> 1]);
        l_run[j >> 1] += s[nt][j];
      }
    }
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // ---- acc += bf16(P) v; the S fragments of key tiles 2c, 2c+1 are the
    // A fragment of key chunk c
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn)
        mma_16816(acc[dn], pa, ld32(&sVt[dn * 8 + g][kc * 16 + t * 2]),
                  ld32(&sVt[dn * 8 + g][kc * 16 + 8 + t * 2]));
    }
  }

  // ---- epilogue: full row sums, normalise, store out and lse
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + h * 8;
    if (row >= T) continue;
    const float inv = 1.f / l_run[h];
    __nv_bfloat16* orow = out + base + (size_t)row * kD;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + t * 2) =
          pack_bf16(acc[dn][2 * h] * inv, acc[dn][2 * h + 1] * inv);
    if (t == 0)
      lse[(size_t)blockIdx.y * T + row] = m_run[h] + logf(fmaxf(l_run[h], 1e-30f));
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int occm_flash_attn_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int bh, int T,
                                   int t_valid, int d, float scale,
                                   void* stream) {
  if (d != kD || bh <= 0 || bh > 65535 || T <= 0 || t_valid <= 0 || t_valid > T)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kBM - 1) / kBM, bh);
  flash_attn_fwd_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)lse, T, t_valid,
      scale);
  return (int)cudaGetLastError();
}
