// The dk/dv kernel of the fp32 flash-attention backward on the tensor
// cores, 3xTF32 (mma.sync m16n8k8), launched after the dq kernel of
// flash_attn_bwd_3xtf32_dq.cu, whose delta it reads; that file's note has
// the pair's design. Built by its own nvcc, beside the dq kernel's.
//
// Replaces, in fp32, the dk and dv halves of the TPU Pallas kernels
// `_bwd_kernel` (occm_tpu/ops/attention.py:79) and `_blocked_dkv_kernel`
// (attention.py:373), in place of flash_attn_generic.cu's dk/dv kernel at
// the head dims ops/attention.py's TF32_BWD_HEAD_DIMS names.
//
// A block owns 64 keys of one (b, h) and sweeps the q rows in 64-row tiles
// (cp.async, double-buffered, with their lse * log2 e and delta): per tile
//   S^T = k qs^T     A = the own k tile, B = q rows, scaled by 1/sqrt(D) in
//                    fp32 as each fragment element is read (qs = q * scale,
//                    the plain version's rounding);
//   dP^T = v dO^T    A = the own v tile, B = dO rows;
//   P^T = exp2(S^T log2 e - lse log2 e), keys >= t_valid and q rows >= T
//   get none; dS^T = P^T (dP^T - delta);
//   dv += P^T dO, dk += dS^T q   A = P^T, dS^T from the S^T and dP^T
//                    registers, B = dO and the unscaled q, rows 2t and
//                    2t + 1 of each 8-row k-step (the fragment permutation
//                    of the dq kernel's note); each tile's sum in a fresh
//                    accumulator added in fp32 (tf32.cuh).
// dk is scaled by 1/sqrt(D) at the store. Each operand element is split
// into TF32 hi + lo as it is loaded: wgmma would take TF32 operands
// K-major only, and dv and dk read dO and q along their rows.
//
// What bounds it on an H100: its four products at B*H 192, T 299, D 64
// are 8.8e9 flops, issued three times each; it took 0.2354 ms alone
// (probe_3xtf32.py), with the non-mma work (fragment loads, splits, the
// exponentials) as long as the whole kernel: the tensor cores wait on it.
// Shared memory 104.4 KB at D 64 (k, v, and two stages of q and dO at
// 64 x (NP + 4) fp32, + 1 KB of lse and delta), two blocks an SM; ptxas:
// 179 / 255 / 255 registers at D 16 / 64 / 128, spill stores 0 / 36 /
// 1152 bytes. Left for later: as the dq kernel's note says.

#include "attention_3xtf32.cuh"

namespace {

// ------------------------------------------------------ backward: dk and dv
// grid (ceil(T / 64), H, B): the block's rows are 64 keys, the streamed
// tiles q and dO rows
template <int NP>
__global__ void __launch_bounds__(kThreads, min_blocks<NP>())
flash_attn_3xtf32_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int T, int t_valid,
    int D, Strides sq, Strides sk, Strides sv, Strides sdo, float scale,
    int vec) {
  constexpr int LD = NP + 4;
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;
  float* s_v = s_k + kRows * LD;
  float* s_q = s_v + kRows * LD;           // [2][kStream][LD], unscaled
  float* s_do = s_q + 2 * kStream * LD;    // [2][kStream][LD]
  float* s_lse = s_do + 2 * kStream * LD;  // [2][kStream]
  float* s_delta = s_lse + 2 * kStream;    // [2][kStream]

  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const float* qb = q + b * sq.sb + h * sq.sh;
  const float* kb = k + b * sk.sb + h * sk.sh;
  const float* vb = v + b * sv.sb + h * sv.sh;
  const float* dob = dout + b * sdo.sb + h * sdo.sh;
  const long long row0 = ((long long)b * H + h) * T;

  float acc_k[NP / 8][4], acc_v[NP / 8][4];
#pragma unroll
  for (int n = 0; n < NP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // keys past t_valid get no probability: their dk and dv are zero
  const int n_tiles = k0 < t_valid ? (T + kStream - 1) / kStream : 0;
  auto stats = [&](int stage, int r0) {
    for (int r = threadIdx.x; r < kStream; r += kThreads) {
      const int t = r0 + r;
      s_lse[stage * kStream + r] = t < T ? lse[row0 + t] * kLog2e : 0.f;
      s_delta[stage * kStream + r] = t < T ? delta[row0 + t] : 0.f;
    }
  };
  if (n_tiles > 0) {
    load_tile<kRows, NP>(s_k, kb, sk.st, sk.sd, k0, T, D, vec);
    load_tile<kRows, NP>(s_v, vb, sv.st, sv.sd, k0, T, D, vec);
    load_tile<kStream, NP>(s_q, qb, sq.st, sq.sd, 0, T, D, vec);
    load_tile<kStream, NP>(s_do, dob, sdo.st, sdo.sd, 0, T, D, vec);
    cp_async_commit();
    stats(0, 0);
    cp_async_wait_all();
    __syncthreads();
  }
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_ok[r] = k0 + 16 * warp + g + 8 * r < t_valid;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      const int nx = st ^ 1, r0 = (j + 1) * kStream;
      load_tile<kStream, NP>(s_q + nx * kStream * LD, qb, sq.st, sq.sd, r0,
                             T, D, vec);
      load_tile<kStream, NP>(s_do + nx * kStream * LD, dob, sdo.st, sdo.sd,
                             r0, T, D, vec);
      cp_async_commit();
      stats(nx, r0);
    }
    const float* cq = s_q + st * kStream * LD;
    const float* cdo = s_do + st * kStream * LD;
    const float* c_lse = s_lse + st * kStream;
    const float* c_delta = s_delta + st * kStream;
    const int q0 = j * kStream;

    // S^T = k (scale q)^T with q scaled as it is read, dP^T = v dO^T
    float s[kSN][4], dp[kSN][4];
#pragma unroll
    for (int n = 0; n < kSN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    product_rows<NP, true>(s, s_k, cq, warp, lane, scale);
    product_rows<NP>(dp, s_v, cdo, warp, lane);
    // P^T = exp(S^T - lse[col]) and dS^T = P^T (dP^T - delta[col]); keys
    // >= t_valid and q rows >= T get no probability
#pragma unroll
    for (int n = 0; n < kSN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * tq + (e & 1);
        const bool live = key_ok[e >> 1] && q0 + c < T;
        const float p = live ? exp2f(fmaf(s[n][e], kLog2e, -c_lse[c])) : 0.f;
        dp[n][e] = p * (dp[n][e] - c_delta[c]);
        s[n][e] = p;
      }
    product_cols<NP>(acc_v, s, cdo, lane);  // dv += P^T dO
    product_cols<NP>(acc_k, dp, cq, lane);  // dk += dS^T q
    if (j + 1 < n_tiles) cp_async_wait_all();
    __syncthreads();
  }
  store_rows<NP>(dk, acc_k, scale, b, h, H, T, D, k0, warp, lane);
  store_rows<NP>(dv, acc_v, 1.f, b, h, H, T, D, k0, warp, lane);
}

// ---------------------------------------------------------------- host side

template <int NP>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int b, int h,
        int T, int t_valid, int d, Strides sq, Strides sk, Strides sv,
        Strides sdo, float scale, int vec, cudaStream_t stream) {
  constexpr int smem = smem_bytes<NP>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_3xtf32_dkv_kernel<NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((T + kRows - 1) / kRows, h, b);
  flash_attn_3xtf32_dkv_kernel<NP><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, T,
      t_valid, d, sq, sk, sv, sdo, scale, vec);
  return (int)cudaGetLastError();
}

template <int NP>
struct Dkv {
  template <typename... A>
  static int run(A... a) { return dkv<NP>(a...); }
};

}  // namespace

// q, k, v, dout as for occm_flash_attn_3xtf32_bwd_dq; lse and delta:
// [b * h, T] fp32 (delta as occm_flash_attn_3xtf32_bwd_dq wrote it, earlier
// on `stream`); dk, dv: [b, T, h, d] fp32 contiguous, 8-byte aligned,
// written. One launch on `stream`; returns 0 or a cudaError_t.
extern "C" int occm_flash_attn_3xtf32_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int h,
    int T, int t_valid, int d, long long q_sb, long long q_st, long long q_sh,
    long long q_sd, long long k_sb, long long k_st, long long k_sh,
    long long k_sd, long long v_sb, long long v_st, long long v_sh,
    long long v_sd, long long do_sb, long long do_st, long long do_sh,
    long long do_sd, float scale, void* stream) {
  if (bad_args(b, h, T, t_valid, d, dk) ||
      (reinterpret_cast<uintptr_t>(dv) & 7))
    return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_st, q_sh, q_sd}, sk{k_sb, k_st, k_sh, k_sd},
      sv{v_sb, v_st, v_sh, v_sd}, sdo{do_sb, do_st, do_sh, do_sd};
  int vec = copy_width(q, sq, d);
  vec = narrower(vec, copy_width(k, sk, d));
  vec = narrower(vec, copy_width(v, sv, d));
  vec = narrower(vec, copy_width(dout, sdo, d));
  return dispatch<Dkv>(d, q, k, v, dout, lse, delta, dk, dv, b, h, T, t_valid,
                       d, sq, sk, sv, sdo, scale, vec, (cudaStream_t)stream);
}
