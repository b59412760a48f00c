// Flash-attention backward for Hopper (sm_90a) in fp32 on the tensor cores,
// 3xTF32: two kernels, dq (which also computes delta = rowsum(dO * O)) then
// dk/dv, no atomics, at every head dim D that is a multiple of 8 from 8 to
// 128 that ops/attention.py's backward route gives them. This file holds
// the dq kernel and the pair's design note; flash_attn_bwd_3xtf32_dkv.cu
// the dk/dv kernel; attention_3xtf32.cuh what the two share (two sources,
// so that nvcc builds their 8 instances each in parallel).
//
// Replaces, in fp32, three TPU Pallas kernels of occm_tpu/ops/attention.py:
//   _bwd_kernel          (attention.py:79)   whole-T backward
//   _blocked_dq_kernel   (attention.py:350)  dq over a kv sweep
//   _blocked_dkv_kernel  (attention.py:373)  dk, dv over a q sweep
// in place of the generic pair (flash_attn_generic.cu, FFMA on the CUDA
// cores), which keeps the fp32 head dims this pair does not take. One pair
// covers every T, fed by the lse of the generic forward. The arithmetic is
// flash_attention_bwd_reference's (ops/attention.py) in fp32:
//   - qs = q * scale in fp32 (the scale folded into q, attention.py:338);
//     S = qs k^T with fp32 sums;
//   - P = exp(S - lse) in fp32 (base 2: exp2(S log2 e - lse log2 e)),
//     keys >= t_valid get P = 0;
//   - dS = P (dO v^T - delta), delta = rowsum(dO * O) in fp32;
//   - dq = scale * dS k, dk = scale * dS^T q (the unscaled q), dv = P^T dO.
// Every product is three TF32 products (tf32.cuh: a_lo b_hi + a_hi b_lo +
// a_hi b_hi, fp32 accumulators), close to fp32's accuracy; one TF32 product
// alone would be off by 2^-11.
//
// Operand majors: wgmma takes TF32 operands K-major only, and three of the
// five products (dq = dS k, dv = P^T dO, dk = dS^T q) have a loaded operand
// whose K is the row (T) axis. This pair uses mma.sync m16n8k8 instead,
// which takes both operands from registers: each thread loads its fragment
// elements from the shared-memory tiles by hand in whatever order a product
// needs, so no tile is transposed and no operand is stored twice. The price
// is mma.sync's lower peak, and the split of every loaded element in
// registers (a mask and a subtraction, tf32.cuh). The kernel's own operands P
// and dS come from the accumulators of S and dP: their fragment (rows g,
// g + 8; columns 2t, 2t + 1) is not mma's A fragment (columns t, t + 4), so
// a k-step of 8 keys takes A column j from accumulator column
// perm(j) = 2 (j % 4) + j / 4, and B's k rows are read in the same order
// (rows 2t and 2t + 1 as b0, b1). The sum is the same; no shuffle.
//
// Layout: q, k, v, out and dO are [B, T, H, D] fp32 read through their
// element strides (sb, st, sh, sd); [BH, T, D] is the case B = BH, H = 1.
// Tiles of 64 rows are copied into shared memory by cp.async (16, 8 or 4
// bytes a copy, the widest that the base addresses and strides allow;
// columns D..NP - 1 and rows past T zero-filled), else by element loads, so
// any strides are read where they lie (an expanded dO too) and nothing is
// copied. dq, dk and dv are written contiguous as [B, T, H, D]; lse and
// delta are [B * H, T] fp32. Rows of a tile are NP + 4 floats apart
// (NP = round_up(D, 16)): every fragment load of a warp (8 rows x 4 columns,
// or 4 row pairs x 8 columns) then falls in 32 distinct banks.
//
// Both kernels: 128 threads, 4 warps of 16 rows each (q rows in dq, keys in
// dk/dv), a block per 64-row tile of its own rows and (b, h); the streamed
// tiles (k and v, or q and dO, and their lse and delta) double-buffered by
// cp.async: tile j + 1 loads while tile j is computed.
// dq kernel, per 64-key tile: S = qs k^T and dP = dO v^T (A from the own
// tiles, B = k, v rows), P and dS in the S registers, dq += dS k (A from
// registers, B = k rows 2t, 2t + 1; the tile's sum in a fresh accumulator,
// added to dq's in fp32: the tensor cores' own accumulation drifts over a
// long sum, tf32.cuh). Before the loop q is scaled in place
// and delta of the 64 rows computed (a warp a row, O read from device
// memory) and written for the dk/dv kernel, next on the stream.
// dk/dv kernel, per 64-row q tile: S^T = k qs^T (q scaled as its fragment
// is read), dP^T = v dO^T, P^T and dS^T in registers, dv += P^T dO,
// dk += dS^T q.
// Shared memory: 6 tiles of 64 x (NP + 4) fp32 (own 2, streamed 2 x 2),
// + 64 floats of delta (dq) or 2 x 128 of lse and delta (dk/dv): 104.4 KB at
// D 64, two blocks an SM; 30.7 KB at D 16; 203 KB at D 128, one block.
// Registers (ptxas, sm_90a): dq 90 / 227 / 255 at D 16 / 64 / 128, dk/dv
// 179 / 255 / 255; spill stores 0 but dk/dv at D 64 (36 bytes) and both
// kernels from D 96 (dq 48-132 bytes, dk/dv 384-1152): the dk and dv
// accumulators, the tile's sum and its small terms take NP / 2 registers
// each.
// S and dP are computed in both kernels (7 products where one kernel with
// atomic dq would do 5): that keeps the pair deterministic, as the bf16
// pair is.
//
// What bounds it on an H100: at the training shape (B*H = 192, T = 299,
// D = 64) the five products are 1.099e10 flops, which 3xTF32 issues three
// times: 0.0666 ms at TF32's 495 TFLOP/s (0.164 ms at fp32's 67 on the CUDA
// cores); the 1.18e8 bytes of q, k, v, out, dO, dq, dk, dv take 0.035 ms.
// The pair issues 7 products (S and dP twice), 3 x 1.54e10 TF32 flops a
// call there; at 0.516 ms (PERF.md) that is 90 TFLOP/s, 18 % of TF32's
// peak, with 8 warps an SM: the mma.sync chains and the splits' loads
// leave the tensor cores idle most of the time.
// What the design leaves for later: wgmma (A from registers for dS and P^T,
// a transposed copy of the loaded tile in shared memory for k, dO and q),
// the recomputed S and dP, the split of the streamed tiles once per tile
// instead of per load, and one block an SM above D 64. The measured times
// are in PERF.md.


#include "attention_3xtf32.cuh"

namespace {

// ------------------------------------------------------- backward: dq, delta
// grid (ceil(T / 64), H, B)
template <int NP>
__global__ void __launch_bounds__(kThreads, min_blocks<NP>())
flash_attn_3xtf32_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int T, int t_valid,
    int D, Strides sq, Strides sk, Strides sv, Strides so, Strides sdo,
    float scale, int vec) {
  constexpr int LD = NP + 4;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_do = s_q + kRows * LD;
  float* s_k = s_do + kRows * LD;        // [2][kStream][LD]
  float* s_v = s_k + 2 * kStream * LD;   // [2][kStream][LD]
  float* s_delta = s_v + 2 * kStream * LD;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = q + b * sq.sb + h * sq.sh;
  const float* kb = k + b * sk.sb + h * sk.sh;
  const float* vb = v + b * sv.sb + h * sv.sh;
  const float* ob = o + b * so.sb + h * so.sh;
  const float* dob = dout + b * sdo.sb + h * sdo.sh;
  const long long row0 = ((long long)b * H + h) * T;
  const int n_tiles = (t_valid + kStream - 1) / kStream;

  load_tile<kRows, NP>(s_q, qb, sq.st, sq.sd, q0, T, D, vec);
  load_tile<kRows, NP>(s_do, dob, sdo.st, sdo.sd, q0, T, D, vec);
  load_tile<kStream, NP>(s_k, kb, sk.st, sk.sd, 0, T, D, vec);
  load_tile<kStream, NP>(s_v, vb, sv.st, sv.sd, 0, T, D, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // the scale folded into q in fp32
  for (int c = threadIdx.x; c < kRows * NP; c += kThreads)
    s_q[(c / NP) * LD + c % NP] *= scale;
  // delta = rowsum(dO * O) in fp32, a warp a row; O read from device
  // memory once, dO from its tile
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int t = q0 + r;
    float acc = 0.f;
    if (t < T)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(s_do[r * LD + d], ob[t * so.st + d * so.sd], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      s_delta[r] = acc;
      if (t < T) delta[row0 + t] = acc;
    }
  }
  __syncthreads();

  // this thread's rows of the S fragment: 16 warp + g and + 8
  const int g = lane >> 2, tq = lane & 3;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    lse_r[r] = q0 + row < T ? lse[row0 + q0 + row] * kLog2e : 0.f;
    delta_r[r] = s_delta[row];
  }

  float acc[NP / 8][4];
#pragma unroll
  for (int n = 0; n < NP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      const int nx = st ^ 1, r0 = (j + 1) * kStream;
      load_tile<kStream, NP>(s_k + nx * kStream * LD, kb, sk.st, sk.sd, r0,
                             T, D, vec);
      load_tile<kStream, NP>(s_v + nx * kStream * LD, vb, sv.st, sv.sd, r0,
                             T, D, vec);
      cp_async_commit();
    }
    const float* ck = s_k + st * kStream * LD;
    const float* cv = s_v + st * kStream * LD;
    const int kv0 = j * kStream;

    float s[kSN][4], dp[kSN][4];
#pragma unroll
    for (int n = 0; n < kSN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    product_rows<NP>(s, s_q, ck, warp, lane);
    product_rows<NP>(dp, s_do, cv, warp, lane);
    // P = exp(S - lse), keys >= t_valid masked; dS = P (dP - delta), in s
#pragma unroll
    for (int n = 0; n < kSN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + 8 * n + 2 * tq + (e & 1);
        const float p =
            key < t_valid ? exp2f(fmaf(s[n][e], kLog2e, -lse_r[e >> 1])) : 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[e >> 1]);
      }
    product_cols<NP>(acc, s, ck, lane);  // dq += dS k
    if (j + 1 < n_tiles) cp_async_wait_all();
    __syncthreads();
  }
  store_rows<NP>(dq, acc, scale, b, h, H, T, D, q0, warp, lane);
}

// ---------------------------------------------------------------- host side

template <int NP>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const void* lse, void* delta, void* dq_, int b,
       int h, int T, int t_valid, int d, Strides sq, Strides sk, Strides sv,
       Strides so, Strides sdo, float scale, int vec, cudaStream_t stream) {
  constexpr int smem = smem_bytes<NP>();
  // once per instance (a thread-safe static), so that a launch captured
  // into a CUDA graph makes no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_3xtf32_dq_kernel<NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((T + kRows - 1) / kRows, h, b);
  flash_attn_3xtf32_dq_kernel<NP><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, (const float*)lse, (float*)delta, (float*)dq_, T,
      t_valid, d, sq, sk, sv, so, sdo, scale, vec);
  return (int)cudaGetLastError();
}

template <int NP>
struct Dq {
  template <typename... A>
  static int run(A... a) { return dq<NP>(a...); }
};

}  // namespace

// q, k, v, out, dout: [b, T, h, d] fp32, d a multiple of 8 from 8 to 128,
// any element strides (sb, st, sh, sd) each; lse: [b * h, T] fp32 from the
// forward; delta: [b * h, T] fp32, written (rowsum(dout * out)); dq:
// [b, T, h, d] fp32 contiguous, 8-byte aligned, written. Keys at index
// >= t_valid are masked; `scale` is folded into q. One launch on `stream`;
// returns 0 or a cudaError_t.
extern "C" int occm_flash_attn_3xtf32_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq_, int b, int h,
    int T, int t_valid, int d, long long q_sb, long long q_st, long long q_sh,
    long long q_sd, long long k_sb, long long k_st, long long k_sh,
    long long k_sd, long long v_sb, long long v_st, long long v_sh,
    long long v_sd, long long o_sb, long long o_st, long long o_sh,
    long long o_sd, long long do_sb, long long do_st, long long do_sh,
    long long do_sd, float scale, void* stream) {
  if (bad_args(b, h, T, t_valid, d, dq_)) return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_st, q_sh, q_sd}, sk{k_sb, k_st, k_sh, k_sd},
      sv{v_sb, v_st, v_sh, v_sd}, so{o_sb, o_st, o_sh, o_sd},
      sdo{do_sb, do_st, do_sh, do_sd};
  int vec = copy_width(q, sq, d);
  vec = narrower(vec, copy_width(k, sk, d));
  vec = narrower(vec, copy_width(v, sv, d));
  vec = narrower(vec, copy_width(dout, sdo, d));
  return dispatch<Dq>(d, q, k, v, out, dout, lse, delta, dq_, b, h, T,
                      t_valid, d, sq, sk, sv, so, sdo, scale, vec,
                      (cudaStream_t)stream);
}

