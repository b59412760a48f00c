"""What the bf16 attention kernels above head dim 128 gain from their design.

Builds variants of the wgmma attention forward
(`occm_tpu_torch/csrc/flash_attn_fwd.cu`) and backward
(`occm_tpu_torch/csrc/flash_attn_bwd.cu`), each with one edit of its
sources in a temporary directory (all built at once, one nvcc each), and
times them (CUDA events, in turns: as built, variant, variant, as built)
against the unedited sources on the same inputs:

- the forward at B 8, H 16, T 299 and 1500, D 136, 192 and 256: as built
  (two consumer warpgroups of 64 q rows a block sharing the k/v ring above
  D 128) and with one consumer warpgroup a block (the design of the
  instances up to D 128);
- the backward's dq and dk/dv kernels at B 12, H 16, T 299 and 1500,
  D 136, 192, 248 and 256: as built (a two-stage ring in the wide dk/dv
  kernel where it fits in 227 KB, one stage at D 200-248) and with one
  stage everywhere (what the second stage buys);
- the dk/dv kernel at D 80 and 128: as built (one consumer warpgroup
  holding both accumulators) and the wide kernel (two consumer
  warpgroups, S^T computed by both) taking every round_up(D, 16) above
  64.

Run on a machine with a CUDA card and nvcc, from the repository's root:
`python3 probe_wide_head.py` (about 2 minutes, most of it nvcc). It prints
the card's name and power limit first; a variant's error is against the
unedited kernel (both compute the same function, so it should read 0).
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import sys
import tempfile

FWD = "flash_attn_fwd.cu"
BWD = "flash_attn_bwd.cu"
ONE_GROUP = (FWD, "constexpr int kWideGroups = 2;",
             "constexpr int kWideGroups = 1;")
ONE_STAGE = (BWD, "      dkv_wide_smem<NP, kFold>(2) <= kMaxSmem ? 2 : 1;",
             "      1;")
WIDE_FROM_80 = (BWD, "  if constexpr (NP > 128)\n",
                "  if constexpr (NP > 64)\n")
VARIANTS = {"fwd as built": (FWD, []),
            "fwd one consumer warpgroup": (FWD, [ONE_GROUP]),
            "bwd as built": (BWD, []),
            "bwd one-stage dk/dv ring": (BWD, [ONE_STAGE]),
            "bwd wide dk/dv kernel above D 64": (BWD, [WIDE_FROM_80])}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_wide_head.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from occm_tpu_torch.ops import _build
    from occm_tpu_torch.ops.attention import LOGITS_SCALE_HEAD_DIMS

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    nvcc = _build._nvcc()
    tmp = tempfile.mkdtemp(prefix="probe_wide_head_")
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)

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
        # ---- every variant built at once
        procs, libs = {}, {}
        for name, (src, edits) in VARIANTS.items():
            d = os.path.join(tmp, name.replace(" ", "_"))
            shutil.copytree(_build.CSRC_DIR, d)
            for fname, old, new in edits:
                path = os.path.join(d, fname)
                s = open(path).read()
                if old not in s:
                    raise RuntimeError(f"{name}: {fname} no longer holds the "
                                       "text this probe edits")
                open(path, "w").write(s.replace(old, new))
            so = os.path.join(d, "lib.so")
            procs[name] = (so, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS[:6], "-shared", "-o", so,
                 os.path.join(d, src)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        for name, (so, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"{name}: nvcc failed\n{out}\n{err}")
            libs[name] = lib = ctypes.CDLL(so)
            if name.startswith("fwd"):
                lib.occm_flash_attn_fwd.argtypes = [
                    *[p] * 5, *[i] * 5, *[ll] * 9, f, p, i]
            else:
                lib.occm_flash_attn_bwd_dq.argtypes = [
                    *[p] * 9, *[i] * 5, *[ll] * 15, f, p, i]
                lib.occm_flash_attn_bwd_dkv.argtypes = [
                    *[p] * 9, *[i] * 5, *[ll] * 12, f, p, i]
        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator(device="cuda").manual_seed(0)

        # ---- the forward
        for d in (136, 192, 256):
            for t in (299, 1500):
                b, h = 8, 16
                q, k, v = torch.randn(
                    (b, t, 3, h, d), generator=gen,
                    device="cuda").to(torch.bfloat16).unbind(2)
                fold = int(d not in LOGITS_SCALE_HEAD_DIMS)
                outs = {}

                def fwd(name):
                    out = outs.setdefault(name, torch.empty(
                        (b, t, h, d), dtype=torch.bfloat16, device="cuda"))
                    lse = torch.empty((b * h, t), device="cuda")
                    return lambda: libs[name].occm_flash_attn_fwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), b, h, t, t, d,
                        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        1.0 / math.sqrt(d), stream, fold)

                a, z = fwd("fwd as built"), fwd("fwd one consumer warpgroup")
                if a() or z():
                    raise RuntimeError(f"forward D {d} T {t}: a launch "
                                       "failed")
                torch.cuda.synchronize()
                err = (outs["fwd one consumer warpgroup"].float()
                       - outs["fwd as built"].float()).abs().max().item()
                iters = 10 if t > 600 else 40
                times = [ms(fn, iters) for fn in (a, z, z, a)]
                print(f"[probe] attention forward B {b}, H {h}, T {t}, D {d}:"
                      f" as built (two consumer warpgroups) "
                      f"{times[0]:.4f} / {times[3]:.4f} ms, one consumer "
                      f"warpgroup {times[1]:.4f} / {times[2]:.4f} ms; max "
                      f"|difference| {err:.2e}", flush=True)

        # ---- the backward
        for d, variant in ((136, "bwd one-stage dk/dv ring"),
                           (192, "bwd one-stage dk/dv ring"),
                           (248, "bwd one-stage dk/dv ring"),
                           (256, "bwd one-stage dk/dv ring"),
                           (80, "bwd wide dk/dv kernel above D 64"),
                           (128, "bwd wide dk/dv kernel above D 64")):
            for t in (299, 1500):
                b, h = 12, 16
                q, k, v, o, do = torch.randn(
                    (b, t, 5, h, d), generator=gen,
                    device="cuda").to(torch.bfloat16).unbind(2)
                lse = torch.randn((b * h, t), generator=gen,
                                  device="cuda").abs() + 5.0
                fold = int(d not in LOGITS_SCALE_HEAD_DIMS)
                grads = {}

                def bwd(name):
                    g = grads.setdefault(name, [torch.empty(
                        (b, t, h, d), dtype=torch.bfloat16, device="cuda")
                        for _ in range(4)])
                    delta = torch.empty((b * h, t), device="cuda")
                    qs = g[3].data_ptr() if fold else None
                    st5 = [s for x in (q, k, v, o, do) for s in x.stride()[:3]]
                    st4 = [s for x in (q, k, v, do) for s in x.stride()[:3]]
                    lib, scale = libs[name], 1.0 / math.sqrt(d)

                    def dq():
                        return lib.occm_flash_attn_bwd_dq(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(), g[0].data_ptr(), qs, b, h, t,
                            t, d, *st5, scale, stream, fold)

                    def dkv():
                        return lib.occm_flash_attn_bwd_dkv(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                            qs, g[1].data_ptr(), g[2].data_ptr(), b, h, t, t,
                            d, *st4, scale, stream, fold)

                    return dq, dkv

                a, z = bwd("bwd as built"), bwd(variant)
                if a[0]() or a[1]() or z[0]() or z[1]():
                    raise RuntimeError(f"backward D {d} T {t}: a launch "
                                       "failed")
                torch.cuda.synchronize()
                err = max((x.float() - y.float()).abs().max().item()
                          for x, y in zip(grads["bwd as built"][:3],
                                          grads[variant]))
                iters = 5 if t > 600 else 20
                dq_ms = ms(a[0], iters)
                times = [ms(fn, iters) for fn in (a[1], z[1], z[1], a[1])]
                print(f"[probe] attention backward B {b}, H {h}, T {t}, "
                      f"D {d}: dq {dq_ms:.4f} ms; dk/dv as built "
                      f"{times[0]:.4f} / {times[3]:.4f} ms, {variant[4:]} "
                      f"{times[1]:.4f} / {times[2]:.4f} ms; max |difference| "
                      f"{err:.2e}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
