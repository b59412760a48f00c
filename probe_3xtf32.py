"""What bounds the 3xTF32 kernels on the card.

Builds variants of the attention forward
(`occm_tpu_torch/csrc/flash_attn_fwd_3xtf32.cu`), of the attention
backward (`occm_tpu_torch/csrc/flash_attn_bwd_3xtf32_dq.cu`, `_dkv.cu`
and their `attention_3xtf32.cuh`) and of
`occm_tpu_torch/csrc/ffn_fwd_3xtf32.cu`, each with one edit of its sources
in a temporary directory, and times them (CUDA events) against the
unedited sources on the same inputs:

- whether the tensor cores truncate or round the 13 mantissa bits of an
  fp32 operand that TF32 drops: x = 1 + m 2^-14 (m = 0..63, and -x) times
  1.0 through mma.sync m16n8k8 and wgmma m64n8k8 (both operands in shared
  memory), each product's result held against x truncated, rounded to
  nearest even and rounded to nearest with ties away;
- the mma.sync m16n8k8 TF32 rate alone: blocks of 4, 8 and 16 warps, each
  warp issuing eight independent chains of the kernels' `mma_tf32`;
- the attention forward at B 8, H 16, T 299 and 1500, D 64 (and the tiny
  model's D 16, H 4, and D 128): as built; with one product a k-step (hi
  hi only, in S and in P v: what the two small terms cost); without the
  split pass (the splitting warps wait for each stage and signal it,
  writing nothing);
- the attention backward's dq and dk/dv kernels at B 12, H 16, T 299 and
  1500, D 64 (and the tiny model's D 16, H 4, and D 128): as built; with
  one product a k-step (hi hi only: what the two small terms and their
  splits cost); with every mma.sync replaced by four FFMAs on the same
  registers (what the rest of the kernel costs); with 32-row streamed
  tiles at up to 3 and 4 blocks an SM;
- the FFN's fc1 product at M 2392, K 1024, N 4096: as built; one product
  a k8 step; without the split (the splitting warps wait for each stage
  and signal it, writing nothing); both.

Run on a machine with a CUDA card and nvcc, from the repository's root:
`python3 probe_3xtf32.py` (about 7 minutes, most of it nvcc). It prints
the card's name and power limit first; a variant's error is against the
unedited kernel (an edited one computes something else on purpose).
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import sys
import tempfile

MMA_BENCH = r'''
#include <stdint.h>
#include "tf32.cuh"
__global__ void bench(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                   threadIdx.x + 3};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(d[j], a, a[0] + j, a[1]);
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_bench(void* out, int blocks, int threads, int iters) {
  bench<<<blocks, threads>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
'''

ROUNDING_PROBE = r'''
#include <stdint.h>
#include "sm90.cuh"
#include "tf32.cuh"
// x[m] at A(m, 0), 1.0 at B(0, 0), every other element 0: D(m, 0) is the
// tensor cores' reading of x[m]. One warp of mma.sync m16n8k8 (16 rows).
__global__ void mma_sync_read(const float* x, float* out) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const uint32_t a[4] = {t == 0 ? __float_as_uint(x[g]) : 0u,
                         t == 0 ? __float_as_uint(x[g + 8]) : 0u, 0u, 0u};
  const uint32_t b0 = (t == 0 && g == 0) ? __float_as_uint(1.f) : 0u;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, a, b0, 0u);
  if (t == 0) out[g] = d[0], out[g + 8] = d[2];
}
// One warpgroup of wgmma m64n8k8, A [64 x 8] and B [8 x 8] K-major in
// shared memory in the 128-byte swizzle (64 rows).
__global__ void wgmma_read(const float* x, float* out) {
  __shared__ __align__(1024) unsigned char buf[9 * 1024];
  unsigned char* a = buf;
  unsigned char* b = buf + 8192;
  for (int i = threadIdx.x; i < 9 * 256; i += 128)
    reinterpret_cast<float*>(buf)[i] = 0.f;
  __syncthreads();
  if (threadIdx.x < 64)  // row m's first 16-byte chunk sits at chunk m % 8
    *reinterpret_cast<float*>(a + threadIdx.x * 128 +
                              ((threadIdx.x & 7) << 4)) = x[threadIdx.x];
  if (threadIdx.x == 0) *reinterpret_cast<float*>(b) = 1.f;
  fence_proxy_async();
  __syncthreads();
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  fence_acc(d);
  wgmma_fence();
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(smem_desc(smem_u32(a))), "l"(smem_desc(smem_u32(b))), "r"(1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(d);
  const int row = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  if ((threadIdx.x & 3) == 0) out[row] = d[0], out[row + 8] = d[2];
}
extern "C" int run_reads(const void* x, void* out_mma, void* out_wgmma) {
  mma_sync_read<<<1, 32>>>((const float*)x, (float*)out_mma);
  wgmma_read<<<1, 128>>>((const float*)x, (float*)out_wgmma);
  return (int)cudaGetLastError();
}
'''

FWD = "flash_attn_fwd_3xtf32.cu"
FWD_ONE_PRODUCT = [
    (FWD, "        wgmma_ss_tf32(ss, dql + kstep(kk), dkh + kstep(kk));\n"
          "        wgmma_ss_tf32(ss, dqh + kstep(kk), dkl + kstep(kk));\n", ""),
    (FWD, "    wgmma_rs_tf32<N>(small, p_lo[c], dh);\n"
          "    wgmma_rs_tf32<N>(small, p_hi[c], dl);\n", "")]
FWD_NO_SPLIT = [
    (FWD, """        split_tile<false>(reinterpret_cast<float4*>(st),
                          reinterpret_cast<float4*>(st + G::kKLo), kTB / 16,
                          1.f, sid, kSplitters);
        split_v<NP>(st + G::kV, st + G::kVtHi, st + G::kVtLo, sid);
""", "")]


def tf32_readings(x):
    """x (fp32, numpy) read as TF32 three ways: truncated, rounded to
    nearest even, rounded to nearest with ties away from zero."""
    import numpy as np

    bits = x.view(np.uint32).astype(np.int64)
    low = bits & 0x1FFF
    trunc = bits & ~0x1FFF
    up = trunc + 0x2000
    even = np.where((low > 0x1000) | ((low == 0x1000) & (trunc & 0x2000 > 0)),
                    up, trunc)
    away = np.where(low >= 0x1000, up, trunc)
    return {name: v.astype(np.uint32).view(np.float32)
            for name, v in (("truncated", trunc), ("nearest even", even),
                            ("nearest, ties away", away))}


ATTN = "attention_3xtf32.cuh"
ATTN_SOURCES = ["flash_attn_bwd_3xtf32_dq.cu", "flash_attn_bwd_3xtf32_dkv.cu"]
FFN = "ffn_fwd_3xtf32.cu"
ONE_PRODUCT = ("tf32.cuh",
               "  mma_tf32(small, a_lo, b_hi[0], b_hi[1]);\n"
               "  mma_tf32(small, a_hi, b_lo[0], b_lo[1]);\n", "")
NO_MMA = ("tf32.cuh", '''  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));''',
          '''  d[0] = fmaf(__uint_as_float(a[0]), __uint_as_float(b0), d[0]);
  d[1] = fmaf(__uint_as_float(a[1]), __uint_as_float(b1), d[1]);
  d[2] = fmaf(__uint_as_float(a[2]), __uint_as_float(b0), d[2]);
  d[3] = fmaf(__uint_as_float(a[3]), __uint_as_float(b1), d[3]);''')


def tiles(rows, blocks):
    return [(ATTN, "constexpr int kStream = 64;",
             f"constexpr int kStream = {rows};"),
            (ATTN, "constexpr int kMaxBlocks = 2;",
             f"constexpr int kMaxBlocks = {blocks};")]


FFN_ONE_PRODUCT = (FFN, "        wgmma_tf32<BN>(part, smem_desc(a_lo) + 2 * kk,"
                        " dbh);\n        wgmma_tf32<BN>(part, dah, "
                        "smem_desc(b_lo) + 2 * kk);\n", "")
FFN_NO_SPLIT = (FFN, '''        split_tile(reinterpret_cast<float4*>(st),
                   reinterpret_cast<float4*>(st + G::kLoadBytes),
                   G::kLoadBytes / 16, tid, kSplitters);''', "")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_3xtf32.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from occm_tpu_torch.ops import _build, attention

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    nvcc = _build._nvcc()
    tmp = tempfile.mkdtemp(prefix="probe_3xtf32_")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def build(name, files, edits=(), extra=None):
        d = os.path.join(tmp, name)
        shutil.copytree(_build.CSRC_DIR, d)
        for f, old, new in edits:
            path = os.path.join(d, f)
            s = open(path).read()
            if old not in s:
                raise RuntimeError(f"{name}: {f} no longer holds the text "
                                   "this probe edits")
            open(path, "w").write(s.replace(old, new))
        if extra:
            open(os.path.join(d, extra[0]), "w").write(extra[1])
        so = os.path.join(d, "lib.so")
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:6], "-shared", "-o", so,
                        *(os.path.join(d, f) for f in files)], check=True,
                       capture_output=True)
        return ctypes.CDLL(so)

    def ms(fn, iters):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    try:
        # ---- how the tensor cores read the bits TF32 drops
        import numpy as np

        lib = build("rounding", ["rounding.cu"],
                    extra=("rounding.cu", ROUNDING_PROBE))
        lib.run_reads.argtypes = [p, p, p]
        for sign in (1.0, -1.0):
            x = (sign * (1.0 + np.arange(64) * 2.0 ** -14)).astype(
                np.float32)
            xs = torch.from_numpy(x).cuda()
            got = {"mma.sync m16n8k8": torch.zeros(16, device="cuda"),
                   "wgmma m64n8k8": torch.zeros(64, device="cuda")}
            if lib.run_reads(xs.data_ptr(), got["mma.sync m16n8k8"]
                             .data_ptr(), got["wgmma m64n8k8"].data_ptr()):
                raise RuntimeError("the rounding probe's launch failed")
            torch.cuda.synchronize()
            rules = tf32_readings(x)
            for inst, out in got.items():
                out = out.cpu().numpy()
                n = len(out)
                match = [name for name, want in rules.items()
                         if np.array_equal(out, want[:n])]
                print(f"[probe] {inst} TF32 reads 1 + m 2^-14 "
                      f"(m = 0..{n - 1}, sign {sign:+.0f}) as: "
                      f"{match or 'none of the three rules'}; "
                      f"m = 8, 24: {out[8]!r}, "
                      f"{out[24] if n > 24 else '-'}", flush=True)

        # ---- the mma.sync TF32 rate
        lib = build("mma", ["bench.cu"], extra=("bench.cu", MMA_BENCH))
        lib.run_bench.argtypes = [p, i, i, i]
        out = torch.empty(132 * 4 * 16 * 32, device="cuda")
        for warps in (4, 8, 16):
            iters = 4096
            t = ms(lambda: lib.run_bench(out.data_ptr(), 132 * 4, warps * 32,
                                         iters), 5)
            macs = 132 * 4 * warps * iters * 8 * 16 * 8 * 8
            print(f"[probe] mma.sync m16n8k8 TF32, 528 blocks of {warps} "
                  f"warps: {2 * macs / t / 1e9:.1f} TFLOP/s", flush=True)

        # ---- the attention forward
        gen = torch.Generator(device="cuda").manual_seed(0)
        fwd_cases = []
        for b, h, t, d in ((8, 16, 299, 64), (8, 16, 1500, 64),
                           (8, 4, 299, 16), (8, 16, 299, 128)):
            qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda")
            fwd_cases.append((b, h, t, d, *qkv.unbind(2)))
        want = {}
        for name, edits in (("as built", []),
                            ("one product", FWD_ONE_PRODUCT),
                            ("no split pass", FWD_NO_SPLIT)):
            lib = build("fwd_" + name.replace(" ", "_"), [FWD], edits)
            lib.occm_flash_attn_3xtf32_fwd.argtypes = [
                *[p] * 5, *[i] * 5, *[ll] * 9, ctypes.c_float, p]
            for b, h, t, d, q, k, v in fwd_cases:
                out = torch.empty((b, t, h, d), device="cuda")
                lse = torch.empty((b * h, t), device="cuda")
                stream = torch.cuda.current_stream().cuda_stream

                def fwd():
                    return lib.occm_flash_attn_3xtf32_fwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), b, h, t, t, d,
                        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        1.0 / math.sqrt(d), stream)

                if fwd():
                    raise RuntimeError(f"forward {name}: a launch failed")
                torch.cuda.synchronize()
                ref = want.setdefault((t, d, h), out.clone())
                err = ((out - ref).abs().max() / ref.abs().max()).item()
                t_ms = ms(fwd, 5 if t > 600 else 20)
                print(f"[probe] attention forward, {name}: B {b}, H {h}, "
                      f"T {t}, D {d}: {t_ms:.4f} ms, "
                      f"{3 * 4 * b * h * t * t * d / t_ms / 1e9:.1f} "
                      "TFLOP/s of the three TF32 products; max error "
                      f"against the unedited kernel {err:.2e} of the "
                      "largest |value|", flush=True)

        # ---- the attention backward
        cases = []
        for b, h, t, d in ((12, 16, 299, 64), (12, 16, 1500, 64),
                           (12, 4, 299, 16), (12, 16, 299, 128)):
            qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda")
            q, k, v = qkv.unbind(2)
            o, lse = attention.flash_attention_fwd(q, k, v, t)
            do = torch.randn((b, t, h, d), generator=gen, device="cuda")
            cases.append(dict(b=b, h=h, t=t, d=d, q=q, k=k, v=v, o=o,
                              lse=lse, do=do,
                              want=attention.flash_attention_bwd(
                                  q, k, v, o, lse, do, t)))
        for name, edits in (("as built", []), ("one product", [ONE_PRODUCT]),
                            ("no mma.sync", [NO_MMA]),
                            ("32-row tiles, 3 blocks", tiles(32, 3)),
                            ("32-row tiles, 4 blocks", tiles(32, 4))):
            lib = build(name.replace(" ", "_").replace(",", ""),
                        ATTN_SOURCES, edits)
            lib.occm_flash_attn_3xtf32_bwd_dq.argtypes = [
                *[p] * 8, *[i] * 5, *[ll] * 20, ctypes.c_float, p]
            lib.occm_flash_attn_3xtf32_bwd_dkv.argtypes = [
                *[p] * 8, *[i] * 5, *[ll] * 16, ctypes.c_float, p]
            for c in cases:
                b, h, t, d = c["b"], c["h"], c["t"], c["d"]
                grads = [torch.empty((b, t, h, d), device="cuda")
                         for _ in range(3)]
                delta = torch.empty((b * h, t), device="cuda")
                ptr = {n: c[n].data_ptr() for n in ("q", "k", "v", "o", "do",
                                                    "lse")}
                st5 = [s for n in ("q", "k", "v", "o", "do")
                       for s in c[n].stride()]
                st4 = [s for n in ("q", "k", "v", "do") for s in c[n].stride()]
                stream = torch.cuda.current_stream().cuda_stream
                scale = 1.0 / math.sqrt(d)

                def dq():
                    return lib.occm_flash_attn_3xtf32_bwd_dq(
                        ptr["q"], ptr["k"], ptr["v"], ptr["o"], ptr["do"],
                        ptr["lse"], delta.data_ptr(), grads[0].data_ptr(), b,
                        h, t, t, d, *st5, scale, stream)

                def dkv():
                    return lib.occm_flash_attn_3xtf32_bwd_dkv(
                        ptr["q"], ptr["k"], ptr["v"], ptr["do"], ptr["lse"],
                        delta.data_ptr(), grads[1].data_ptr(),
                        grads[2].data_ptr(), b, h, t, t, d, *st4, scale,
                        stream)

                if dq() or dkv():
                    raise RuntimeError(f"{name}: a launch failed")
                torch.cuda.synchronize()
                err = max(((g - w).abs().max() / w.abs().max()).item()
                          for g, w in zip(grads, c["want"]))
                iters = 5 if t > 600 else 20
                t_dq, t_dkv = ms(dq, iters), ms(dkv, iters)
                print(f"[probe] attention backward, {name}: B {b}, H {h}, "
                      f"T {t}, D {d}: dq {t_dq:.4f} ms + dk/dv {t_dkv:.4f} "
                      f"ms = {t_dq + t_dkv:.4f} ms; max error against the "
                      f"unedited kernel {err:.2e} of the largest |value|",
                      flush=True)

        # ---- the FFN's fc1
        m, k, n = 2392, 1024, 4096
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = 0.02 * torch.randn((n, k), generator=gen, device="cuda")
        bias = torch.zeros(n, device="cuda")
        for name, edits in (("as built", []),
                            ("one product", [FFN_ONE_PRODUCT]),
                            ("no split pass", [FFN_NO_SPLIT]),
                            ("one product, no split pass",
                             [FFN_ONE_PRODUCT, FFN_NO_SPLIT])):
            lib = build("ffn_" + name.replace(" ", "_").replace(",", ""),
                        [FFN], edits)
            lib.occm_ffn_gemm_3xtf32.argtypes = [p, p, p, p, i, i, i, i, p]
            y = torch.empty((m, n), device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def fc1():
                return lib.occm_ffn_gemm_3xtf32(
                    x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    y.data_ptr(), m, n, k, 0, stream)

            if fc1():
                raise RuntimeError(f"FFN {name}: the launch failed")
            t = ms(fc1, 20)
            print(f"[probe] FFN fc1, {name}: M {m}, K {k}, N {n}: {t:.4f} "
                  f"ms, {3 * 2 * m * k * n / t / 1e9:.1f} TFLOP/s of the "
                  "three TF32 products", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
