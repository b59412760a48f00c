// One-pass LayerNorm backward for Hopper (sm_90a), one launch per call.
//
// Replaces the TPU Pallas kernel occm_tpu/ops/layernorm.py:46 `_bwd_kernel`.
// Per row of x [M, D] (bf16 or fp32) and its output gradient g (same dtype),
// with gamma [D] fp32:
//   mu, rstd recomputed from x in fp32 (two passes over the row in
//   registers: sum, then sum of squared deviations),
//   x_hat = (x - mu) * rstd,  gg = g * gamma,
//   dx = rstd * (gg - mean(gg) - x_hat * mean(gg * x_hat))   in x's dtype,
// and dgamma = sum_M g * x_hat, dbeta = sum_M g in fp32, final, from the
// same launch (the TPU wrapper sums per-tile partials in XLA).
//
// What bounds it on an H100: bytes. At the training shape [3588, 1024]
// bf16 it reads x and g once and writes dx once: 22 MB, 6.6 us at
// 3.35 TB/s; the arithmetic is ~12 flops per element.
//
// Design:
//   - One warp per row. A lane owns the columns of its 16-byte vectors
//     (vector i of a row is lane i % 32's), loads and stores 16 bytes at a
//     time (8 bf16 or 4 fp32; D that is not a multiple of that, or a
//     misaligned row, takes element loads instead), and keeps x and g of
//     the row as loaded. Row statistics are warp shuffles only: no
//     __syncthreads() in the row loop. For D <= 32 vectors' worth of lanes
//     (1024 bf16 or fp32) the next row's x and g are loaded before the
//     current row is computed, so two rows are in flight per warp.
//   - Persistent grid: as many blocks of 8 warps as fit on the SMs at once;
//     warp w of the grid takes rows w, w + 8 * blocks, ...
//   - dgamma/dbeta: each lane keeps its columns' partial sums in registers
//     over its rows. The block sums its 8 warps' partials through shared
//     memory in warp order and writes one partial per block. Then a ticket
//     per group of kGroup blocks (an atomic counter, after __threadfence())
//     elects the group's last block, which sums the group's partials in
//     block order; a second ticket elects the last group, which sums the
//     group sums in group order into dgamma and dbeta. Every election resets
//     its counter, so the scratch is ready for the next launch. No value is
//     ever added by an atomic, so two runs give identical bits. (One
//     last block for all partials would read 132 x 8 KB through one SM,
//     about 8 us at one SM's share of L2 bandwidth, more than the rows
//     take; two levels of ~16 read 128 KB each.)
//   - Partials are stored in lane order (slot (i * E + e) * 32 + lane for
//     element e of lane vector i), so that warps write shared memory and
//     blocks read and write them without bank conflicts or strided global
//     accesses; only the final write maps slots back to columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <mutex>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 16;         // blocks per group of the dgamma/dbeta sum
constexpr int kMaxBlocksPerSm = 2;

// elements per 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (int)sizeof(T);
}

__device__ __forceinline__ uint32_t word(const uint4& u, int w) {
  return w == 0 ? u.x : w == 1 ? u.y : w == 2 ? u.z : u.w;
}

// element e of a 16-byte vector, as fp32
template <typename T>
__device__ __forceinline__ float get(const uint4& u, int e);
template <>
__device__ __forceinline__ float get<float>(const uint4& u, int e) {
  return __uint_as_float(word(u, e));
}
template <>
__device__ __forceinline__ float get<__nv_bfloat16>(const uint4& u, int e) {
  const uint32_t w = word(u, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// elements c .. c + vec_elems - 1 of a row, zero past D; `vec`: the row is
// 16-byte aligned and D a multiple of the vector
__device__ __forceinline__ uint4 load16(const float* row, int c, int D,
                                        bool vec) {
  if (vec)
    return c < D ? __ldg(reinterpret_cast<const uint4*>(row + c))
                 : make_uint4(0, 0, 0, 0);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = c + e < D ? __float_as_uint(__ldg(row + c + e)) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 load16(const __nv_bfloat16* row, int c, int D,
                                        bool vec) {
  if (vec)
    return c < D ? __ldg(reinterpret_cast<const uint4*>(row + c))
                 : make_uint4(0, 0, 0, 0);
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = c + 2 * e < D ? __ldg(r + c + 2 * e) : 0u;
    const uint32_t hi = c + 2 * e + 1 < D ? __ldg(r + c + 2 * e + 1) : 0u;
    w[e] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(float* row, int c, int D, bool vec,
                                        const float (&f)[4]) {
  if (c >= D) return;
  if (vec) {
    *reinterpret_cast<float4*>(row + c) = make_float4(f[0], f[1], f[2], f[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < D) row[c + e] = f[e];
}
__device__ __forceinline__ void store16(__nv_bfloat16* row, int c, int D,
                                        bool vec, const float (&f)[8]) {
  if (c >= D) return;
  if (vec) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      w[e] = *reinterpret_cast<uint32_t*>(&v);
    }
    *reinterpret_cast<uint4*>(row + c) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (c + e < D) row[c + e] = __float2bfloat16(f[e]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums the `n` consecutive partials of `slots` floats at src, in order, into
// dst (one thread per slot, the block's threads striding over the slots);
// reads through L2, as other blocks wrote them.
__device__ __forceinline__ void sum_partials(const float* src, int n,
                                             int slots, float* dst) {
  for (int s = threadIdx.x; s < slots; s += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc += __ldcg(src + (size_t)k * slots + s);
    dst[s] = acc;
  }
}

// Elects the last block to arrive at `ticket` among `n`, after this block's
// global writes are visible; the elected block resets the ticket and sees
// every other block's writes.
__device__ __forceinline__ bool last_to_arrive(unsigned int* ticket,
                                               unsigned int n) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == n - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// grid: blocks of kThreads; dynamic shared memory kWarps * 2 * S floats
// with S = kVec * vec_elems<T>() * 32 slots. scratch: tickets (one per
// group, then one for the groups), then [blocks][2][S] block partials,
// then [groups][2][S] group partials.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 1)
layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const T* __restrict__ g, T* __restrict__ dx,
                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                     unsigned int* __restrict__ tickets,
                     float* __restrict__ part, float* __restrict__ gpart,
                     int M, int D, float eps, bool vec) {
  constexpr int kE = vec_elems<T>();
  constexpr int kN = kVec * kE;  // elements per lane
  constexpr int kS = kN * 32;    // slots: columns of a row, lane-ordered
  constexpr bool kPrefetch = kN <= 32;
  extern __shared__ float sp[];  // [kWarps][2][kS]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float inv_d = 1.f / (float)D;

  float gam[kN], dga[kN], dbe[kN];
#pragma unroll
  for (int i = 0; i < kVec; ++i)
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int c = (i * 32 + lane) * kE + e;
      gam[i * kE + e] = c < D ? __ldg(gamma + c) : 0.f;
      dga[i * kE + e] = 0.f;
      dbe[i * kE + e] = 0.f;
    }

  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
  uint4 xr[kVec], gr[kVec];
  if (row < M) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      xr[i] = load16(x + (size_t)row * D, (i * 32 + lane) * kE, D, vec);
      gr[i] = load16(g + (size_t)row * D, (i * 32 + lane) * kE, D, vec);
    }
  }
  for (; row < M; row += stride) {
    const int next = row + stride;
    uint4 xn[kVec], gn[kVec];
    if (kPrefetch && next < M) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        xn[i] = load16(x + (size_t)next * D, (i * 32 + lane) * kE, D, vec);
        gn[i] = load16(g + (size_t)next * D, (i * 32 + lane) * kE, D, vec);
      }
    }
    // ---- statistics: elements past D are loaded as 0
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
#pragma unroll
      for (int e = 0; e < kE; ++e) sum += get<T>(xr[i], e);
    const float mu = warp_sum(sum) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float dv = get<T>(xr[i], e) - mu;
        if ((i * 32 + lane) * kE + e < D) sq += dv * dv;
      }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float gg = get<T>(gr[i], e) * gam[i * kE + e];
        s1 += gg;
        s2 += gg * ((get<T>(xr[i], e) - mu) * rstd);
      }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float m1 = s1 * inv_d, m2 = s2 * inv_d;
    // ---- dx, and this lane's dgamma/dbeta partials
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float f[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float gv = get<T>(gr[i], e);
        const float xh = (get<T>(xr[i], e) - mu) * rstd;
        f[e] = rstd * (gv * gam[i * kE + e] - m1 - xh * m2);
        dga[i * kE + e] += gv * xh;
        dbe[i * kE + e] += gv;
      }
      store16(dx + (size_t)row * D, (i * 32 + lane) * kE, D, vec, f);
    }
    if (kPrefetch) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        xr[i] = xn[i];
        gr[i] = gn[i];
      }
    } else if (next < M) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        xr[i] = load16(x + (size_t)next * D, (i * 32 + lane) * kE, D, vec);
        gr[i] = load16(g + (size_t)next * D, (i * 32 + lane) * kE, D, vec);
      }
    }
  }

  // ---- block partial: the 8 warps' partials summed in warp order
  float* mine = sp + warp * 2 * kS;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    mine[j * 32 + lane] = dga[j];
    mine[kS + j * 32 + lane] = dbe[j];
  }
  __syncthreads();
  float* bpart = part + (size_t)blockIdx.x * 2 * kS;
  for (int s = threadIdx.x; s < 2 * kS; s += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += sp[w * 2 * kS + s];
    bpart[s] = acc;
  }

  // ---- the group's last block sums the group, the last group the groups
  const int n_groups = (gridDim.x + kGroup - 1) / kGroup;
  const int grp = blockIdx.x / kGroup;
  const int in_group = min(kGroup, (int)gridDim.x - grp * kGroup);
  if (!last_to_arrive(tickets + grp, in_group)) return;
  sum_partials(part + (size_t)grp * kGroup * 2 * kS, in_group, 2 * kS,
               gpart + (size_t)grp * 2 * kS);
  if (!last_to_arrive(tickets + n_groups, n_groups)) return;
  for (int s = threadIdx.x; s < 2 * kS; s += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < n_groups; ++k)
      acc += __ldcg(gpart + (size_t)k * 2 * kS + s);
    const int slot = s % kS;  // (i * kE + e) * 32 + lane
    const int c = ((slot / (kE * 32)) * 32 + slot % 32) * kE +
                  (slot / 32) % kE;
    if (c < D) (s < kS ? dgamma : dbeta)[c] = acc;
  }
}

// The kernel instance for (dtype, D): kVec, the 16-byte vectors per lane,
// is the least instantiated value that covers D.
struct Plan {
  const void* fn;
  int slots;  // S
  int smem;   // dynamic shared memory bytes
};

template <typename T, int kVec>
Plan plan_of() {
  constexpr int kS = kVec * vec_elems<T>() * 32;
  return {reinterpret_cast<const void*>(&layernorm_bwd_kernel<T, kVec>), kS,
          kWarps * 2 * kS * (int)sizeof(float)};
}

bool make_plan(int D, int is_bf16, Plan* p) {
  if (D <= 0 || D > 2048) return false;
  if (is_bf16) {
    const int v = (D + 8 * 32 - 1) / (8 * 32);
    *p = v <= 1   ? plan_of<__nv_bfloat16, 1>()
         : v <= 2 ? plan_of<__nv_bfloat16, 2>()
         : v <= 4 ? plan_of<__nv_bfloat16, 4>()
         : v <= 5 ? plan_of<__nv_bfloat16, 5>()
                  : plan_of<__nv_bfloat16, 8>();
  } else {
    const int v = (D + 4 * 32 - 1) / (4 * 32);
    *p = v <= 1    ? plan_of<float, 1>()
         : v <= 2  ? plan_of<float, 2>()
         : v <= 4  ? plan_of<float, 4>()
         : v <= 8  ? plan_of<float, 8>()
         : v <= 10 ? plan_of<float, 10>()
                   : plan_of<float, 16>();
  }
  return true;
}

// Blocks of an instance that fit on the current card at once, at most
// kMaxBlocksPerSm per SM (0 on error); asked of the runtime once per
// (instance, device).
int blocks_that_fit(const Plan& p) {
  struct Entry {
    const void* fn;
    int dev, fit;
  };
  static Entry cache[64];
  static int n = 0;
  static std::mutex mu;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i)
    if (cache[i].fn == p.fn && cache[i].dev == dev) return cache[i].fit;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           p.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.fn, kThreads,
                                                    p.smem) != cudaSuccess ||
      per_sm < 1)
    return 0;
  const int fit = sms * std::min(per_sm, kMaxBlocksPerSm);
  if (n < 64) cache[n++] = {p.fn, dev, fit};
  return fit;
}

// Blocks of the persistent grid for M rows: as many as fit, and no more
// than the rows need (0 on error).
int grid_blocks(const Plan& p, int M) {
  const int fit = blocks_that_fit(p);
  return fit ? std::min(fit, (M + kWarps - 1) / kWarps) : 0;
}

int groups_of(int blocks) { return (blocks + kGroup - 1) / kGroup; }

// the tickets, rounded up to 16 bytes, before the partials
long long ticket_bytes(int blocks) {
  return ((groups_of(blocks) + 1) * 4 + 15) / 16 * 16;
}

long long scratch_bytes(const Plan& p, int blocks) {
  return ticket_bytes(blocks) +
         (long long)(blocks + groups_of(blocks)) * 2 * p.slots * 4;
}

}  // namespace

// Bytes of the scratch occm_layernorm_bwd needs for M rows of width D (its
// tickets must be zero before the first launch; every launch leaves them
// zero); -1 for a shape the kernel does not take.
extern "C" long long occm_layernorm_bwd_scratch_bytes(int M, int D,
                                                      int is_bf16) {
  Plan p;
  if (M <= 0 || !make_plan(D, is_bf16, &p)) return -1;
  const int blocks = grid_blocks(p, M);
  return blocks ? scratch_bytes(p, blocks) : -1;
}

// x, g, dx: [M, D] of one dtype (is_bf16: bf16, else fp32), rows contiguous;
// gamma [D] fp32; dgamma, dbeta [D] fp32, written final. `scratch` (of
// `scratch_bytes` >= occm_layernorm_bwd_scratch_bytes) is reused across
// launches on one stream. One launch on `stream`; returns the cudaError_t of
// the launch (0 on success).
extern "C" int occm_layernorm_bwd(const void* x, const void* gamma,
                                  const void* g, void* dx, void* dgamma,
                                  void* dbeta, void* scratch,
                                  long long scratch_size, int M, int D,
                                  float eps, int is_bf16, void* stream) {
  Plan p;
  if (M <= 0 || !make_plan(D, is_bf16, &p)) return (int)cudaErrorInvalidValue;
  const int blocks = grid_blocks(p, M);
  if (blocks == 0 || scratch_size < scratch_bytes(p, blocks) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15))
    return (int)cudaErrorInvalidValue;
  unsigned int* tickets = static_cast<unsigned int*>(scratch);
  float* part = reinterpret_cast<float*>(static_cast<char*>(scratch) +
                                         ticket_bytes(blocks));
  float* gpart = part + (size_t)blocks * 2 * p.slots;
  bool vec = D % (is_bf16 ? 8 : 4) == 0;
  for (const void* ptr : {x, g, (const void*)dx})
    vec = vec && !(reinterpret_cast<uintptr_t>(ptr) & 15);
  void* args[] = {&x,       &gamma, &g, &dx, &dgamma, &dbeta,
                  &tickets, &part,  &gpart, &M, &D, &eps, &vec};
  const cudaError_t e =
      cudaLaunchKernel(p.fn, dim3(blocks), dim3(kThreads), args, p.smem,
                       (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
