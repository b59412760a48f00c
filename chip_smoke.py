#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/H100 port (`occm_tpu_torch`).

    python3 chip_smoke.py                 # every phase, one CUDA card
    python3 chip_smoke.py --profile       # every phase + device time by kernel
    python3 chip_smoke.py --kernels-only  # phases 1-3 only
    python3 chip_smoke.py --controls-only # phases 1, 2 and 8 only

Phases (any failure ends the run with a non-zero exit and no last line):

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit and turns TF32 off for the comparisons.
2. build: compiles occm_tpu_torch/csrc/*.cu with nvcc (sm_90a), one nvcc
   per source in parallel, prints ptxas's registers and spills, and counts
   the HGMMA (wgmma) instructions of the FFN kernel and of the attention
   forward, backward dq and backward dk/dv kernels in the library's SASS
   (cuobjdump -sass); fails if any of the four has none.
3. kernels, each against its plain PyTorch version on the card on the same
   inputs, with the wrapper's time (CUDA events), the kernel's own device
   time (torch.profiler), and the plain, library and bound times:
   - flash_attn_fwd at B=8, H=16, D=64, bf16, T in {201, 299, 599, 1500},
     on [B*H, T, D] and on [B, T, H, D] views of one projection output,
     which must agree bit for bit (library: SDPA);
   - flash_attn_bwd (its dq and dk/dv launches) at B=12, H=16, D=64, T in
     {201, 299, 599, 1500}, on [B, T, H, D] views of one projection output
     and on [B*H, T, D]: the two and a repeat agree bit for bit, a call is
     two device launches and nothing else, and through autograd the
     gradients come back contiguous with no copy (library: SDPA
     forward+backward minus forward);
   - layernorm_bwd at [3588, 1024] bf16 (library:
     aten.native_layer_norm_backward) and at [1000, 1000] and [3588, 1280]:
     one device launch a call, a repeat identical bit for bit;
   - fused_adam over leaves of odd sizes (1, 3, 1027, two chunks + 3, a
     None gradient, a leaf 4 bytes past a 16-byte boundary), then over
     every leaf of the full AModel in one launch (library:
     torch.optim.Adam(fused=True).step());
   - ffn_fwd at M in {1608, 2392, 3588, 4792}, D 1024, F 4096, bf16, erf
     and tanh GELU, and at M = 1000 (a ragged tile), D = 1280, F = 5120
     (past the earlier kernel's width limit) and M = 1000, D = 1000,
     F = 4000 (partial K and N tiles) (library: the port's ffn_impl="xla"
     sequence, F.linear, F.gelu, F.linear).
4. the tiny model (XLSRConfig.tiny(): fp32, head dim 16, which the CUDA
   attention kernels do not take) scored on the card under auto
   attention: plain attention, no flash launch, agreement with the CPU,
   and a pinned flash impl raises. Then scoring and evaluation at full
   width (XLSR-300M + AASIST, random
   weights from seed 0, saved as a reference-named .pt):
   `occm_tpu_torch.cli.oc_classifier` in 1c2 and 2c2 mode on a synthetic
   ASVspoof-shaped tree (6 bonafide + 2 spoof train rows, 16 eval
   utterances of 3-13 s in 11 length buckets); checks the artefacts, the
   score lines and the attention kernel's launches per batch. Then the
   same eval set through OneClassScorer with ffn_impl="pallas": 24 ffn_fwd
   launches per batch, distances within a stated bound of the CLI's. EER
   and confusion matrix of the score files; utterances/s per bucket of
   1-13 s at a full batch of 8, attention xla vs flash (the measurement
   behind impl_select's AUTO_FLASH_MIN_SAMPLES), and ffn xla vs pallas at
   6 and 12 s.
5. serving: the same checkpoint served over HTTP by
   `occm_tpu_torch.cli.oc_server` from the reference embedding and
   threshold that phase 4 wrote: a 4 s WAV, a 6 s raw-PCM and a 12 s WAV
   request plus 8 concurrent 6 s requests. Checks every response, that the
   forward kernel launched 24 times (one per layer) for every batch of a
   flash bucket, and that the flash scores agree with the plain-attention
   scores.
6. training through the CLI: `occm_tpu_torch.cli.oc_training.main` at full
   width on the fixture's 6-7 s waves, --cut 96000 (flash attention
   through auto), one epoch. Checks every step's loss is finite, the
   attention kernels' launches per step (and that the backward copied no
   dO), and that aasist_vocoded_0.pt
   loads strictly into the port's AModel.
7. training through `train()`: 3 steps with every kernel (flash attention,
   ln_impl="pallas", ffn_impl="pallas", optimizer="fused_adam", AASIST
   dropouts zeroed), then the same 3 steps from the same weights and
   batches in the plain configuration (xla attention, LayerNorm and FFN,
   torch Adam). Checks each kernel's launches per step and the per-step
   losses within a stated bound; prints step times and peak memory.
8. the training controls at full width (12 x 6 s, flash attention,
   ln_impl and ffn_impl "pallas", remat, AASIST dropouts zeroed unless
   said), each against the eager loop from the same weights and batches
   under deterministic algorithms, with loss bounds derived in
   `loss_bound` from two backward passes:
   - steps_per_dispatch = 3 over 6 batches (2 chunks) with fused_adam:
     one CUDA graph launch per chunk, the capture recording 3 x each
     kernel's launches of an eager step, the profiler's device launches
     per step equal for eager, a graph of 1 step and a graph of 3 steps;
     step wall ms, device-busy share (the union of the device events'
     intervals over the host window), capture time and peak memory;
   - the same with adam under a cosine schedule (warmup 1, decay 5): the
     lr each captured step read, back from the device, is the schedule's;
   - the same with adam and AASIST's default dropouts: every loss and the
     final weights bit for bit (fresh masks on every replay);
   - grad_accum = 2 at groups_per_step = 2: on two meta-batches equal to
     its definition (the mean of the two meta-batches' own gradients), on
     one meta-batch twice equal to the 24-utterance step (the gradient the
     update read within LOSS_RTOL of its norm, each updated weight within
     the bound that Adam's first update gives from the two gradients);
     each kernel twice its per-micro-batch count;
   - resume through `oc_training.main` (--checkpoint_every_steps 2, the
     CLI's default model with dropout on): SIGTERM from the on_step hook
     after step 2 saves and returns, --resume finishes the epoch bit for
     bit as an uninterrupted run, and the step-2 checkpoint is replaced
     and deleted; then the same with --steps_per_dispatch 3 (SIGTERM
     after the first chunk), again bit for bit as the eager run;
   - the bytes of dropout masks that remat holds with every XLSR rate on.
9. with --profile only: device time by kernel (torch.profiler) for full
   batches of 8 in the two flash buckets, for a 6 s batch with
   ffn_impl="pallas", and for one full training step (12 x 6 s).
10. prints {"kernels": [...]}, then {"ok": true, "device": {...}} last.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

B, H, D = 8, 16, 64
KERNEL_TS = (201, 299, 599, 1500)
# T of the two flash buckets of the main path: 96 000 and 192 000 samples
MAIN_PATH_TS = (299, 599)
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
TRAIN_B = 12  # utterances in one training step: one meta-batch

# Kernel vs plain version: the plain version runs in fp32 on the same bf16
# inputs, so the kernel's own roundings show as error: P cast to bf16
# before P·V (relative 2^-9 per probability) and the bf16 output (relative
# 2^-9). With q, k, v ~ N(0, 1) the outputs are weighted means of v rows,
# |out| <= max|v| ~ 4.5, so both roundings stay below 4.5 * 2^-8 ~ 1.8e-2.
OUT_ATOL = 2e-2
# lse is fp32 on both sides; only the summation order differs.
LSE_ATOL = 1e-3
# Flash vs plain attention through the whole 24-layer model: both run bf16
# activations, and the two paths round P at different places (unnormalised
# vs normalised probabilities), a relative 2^-9 per layer that the residual
# stream carries through 24 layers; the distance to the reference is a norm
# over 160 embedding values. A relative bound of 5e-2 holds that drift and
# fails on any structural fault (a wrong mask, layout or scale moves the
# distance by far more).
SCORE_RTOL = 5e-2
# Fused FFN kernel vs its plain version on the same bf16 inputs: the plain
# version repeats the kernel's two bf16 roundings (the hidden activation and
# the output), so the two differ only by the order of the fp32 sums, which
# can flip one rounding of an output by one bf16 ulp (at most 2^-7 of its
# magnitude) or one rounding of a hidden element (an effect on y some 2^-8
# times smaller). A bound of 2^-7 of the largest |y| holds that and fails on
# a wrong fragment, tile or bias (those move whole rows or columns).
FFN_RTOL_OF_MAX = 2.0 ** -7
# M of the FFN check: 8 x T at 4, 6 and 12 s (serving and scoring batches),
# 12 x 299 (a training step at 6 s); M = 2392 is the kernels line's shape
FFN_MS = (8 * 201, 8 * 299, 12 * 299, 8 * 599)
FFN_MAIN_M = 8 * 299
# edge shapes (M, D, F): a ragged last row tile, a width past the earlier
# kernel's D <= 1024 limit, and D, F that are not multiples of the 64-deep
# k-steps or the 256-wide output tiles (TMA zero-fills the partial K and N
# tiles on load and clips N on store)
FFN_EDGES = ((1000, 1024, 4096), (FFN_MAIN_M, 1280, 5120), (1000, 1000, 4000))
# Training, step 1: the same forward as the serving check's, through the
# same 24 layers, plus the LayerNorm kernel's bf16 output: relative 5e-2 of
# the loss (later steps add an Adam term, see phase_train).
LOSS_RTOL = 5e-2

SR = 16000


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, names, iters: int = 20, warmup: int = 3,
              tries: int = 5):
    """Device time of fn's own kernels per call: torch.profiler's CUDA
    events over `iters` calls, those whose name holds one of `names` summed
    and divided by `iters`. Returns (ms, their launches per call, all
    device launches per call).

    fn launches the same kernels on every call, so a session whose event
    counts are not multiples of `iters` has lost records: on the H100 a
    rare session records no device event, or drops a few, with or without
    CUPTI's teardown between sessions. Such a session is repeated, up to
    `tries` sessions in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, own, every = 0.0, 0, 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            every += 1
            if any(n in e.name for n in names):
                us += e.time_range.elapsed_us()
                own += 1
        if every and every % iters == 0 and own % iters == 0:
            break
        print(f"[profile] session {attempt} of {tries} for {names} lost "
              f"records: {every} device events, {own} of them named, over "
              f"{iters} calls", file=sys.stderr, flush=True)
    else:
        fail(f"profile: {tries} sessions for {names} all lost records")
    if own == 0:
        fail(f"profile: no device event named {names} "
             f"({every / iters} device events a call)")
    return us / iters / 1e3, own / iters, every / iters


def library_device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of every kernel one library call launches."""
    return device_ms(fn, ("",), iters, warmup)[0]


def attention_bound(bh: int, t: int, d: int):
    """Least time for one forward on an H100: (bound_ms, bound_by, flops,
    bytes). Two products of 2*T*T*D flops per (b, h); q, k, v read once
    and out written once in bf16, lse written once in fp32."""
    flops = 4.0 * bh * t * t * d
    nbytes = 4.0 * bh * t * d * 2 + bh * t * 4
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


# ------------------------------------------------------------- phase 1, 2

def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA "
             "card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return smi[0]


def phase_build():
    from occm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"[build] {_build.library_path()} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f}"
          " s)", flush=True)
    for line in _build.build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print(f"[build]   {line.strip()}", flush=True)
    # the FFN and the three attention kernels must run on wgmma: count
    # HGMMA in their SASS
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.library_path()],
                          capture_output=True, text=True, check=True).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "HGMMA" in line:
            hgmma[fn] = hgmma.get(fn, 0) + 1
    print(f"[build] HGMMA instructions in the library's SASS: {hgmma}",
          flush=True)
    for kernel in ("ffn_gemm_kernel", "flash_attn_fwd_kernel",
                   "flash_attn_bwd_dq_kernel", "flash_attn_bwd_dkv_kernel"):
        if not any(kernel in f for f in hgmma):
            fail(f"the SASS of {kernel} holds no HGMMA: {hgmma}")
    return hgmma


# ----------------------------------------------------------------- phase 3

def phase_kernels():
    """flash_attn_fwd at every KERNEL_TS on both layouts: [B*H, T, D]
    contiguous, and [B, T, H, D] views of one [B, T, 3, H, D] projection
    output (the layout the model hands it), each against the plain version;
    the two layouts must give the same bits."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.ops.attention import (
        flash_attention_fwd, flash_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for t in KERNEL_TS:
        qkv = torch.randn((B, t, 3, H, D), generator=gen,
                          device="cuda").to(torch.bfloat16)
        q4, k4, v4 = qkv.unbind(2)  # strided [B, T, H, D] views

        def flat(x):
            return x.permute(0, 2, 1, 3).reshape(B * H, t, D).contiguous()

        q, k, v = flat(q4), flat(k4), flat(v4)
        out, lse = flash_attention_fwd(q, k, v, t)
        out4, lse4 = flash_attention_fwd(q4, k4, v4, t)
        torch.cuda.synchronize()
        if not (out4.shape == (B, t, H, D) and out4.is_contiguous()
                and torch.equal(flat(out4), out) and torch.equal(lse4, lse)):
            fail(f"flash_attn_fwd T={t}: [B, T, H, D] views and [B*H, T, D] "
                 "give different results")
        ref_out, ref_lse = flash_attention_reference(
            q.float(), k.float(), v.float(), t)
        err = (out.float() - ref_out).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if not (math.isfinite(err) and err <= OUT_ATOL):
            fail(f"flash_attn_fwd T={t}: max |out - plain| = {err} > "
                 f"{OUT_ATOL}")
        if not (math.isfinite(lse_err) and lse_err <= LSE_ATOL):
            fail(f"flash_attn_fwd T={t}: max |lse - plain| = {lse_err} > "
                 f"{LSE_ATOL}")
        ms = cuda_ms(lambda: flash_attention_fwd(q4, k4, v4, t))
        ms_flat = cuda_ms(lambda: flash_attention_fwd(q, k, v, t))
        dev_ms, _, _ = device_ms(lambda: flash_attention_fwd(q4, k4, v4, t),
                                 ("flash_attn_fwd",))
        qf, kf, vf = q.float(), k.float(), v.float()
        plain_ms = cuda_ms(lambda: flash_attention_reference(qf, kf, vf, t),
                           iters=5)
        q3, k3, v3 = (x.view(B, H, t, D) for x in (q, k, v))
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q3, k3, v3))
        lib_dev_ms = library_device_ms(
            lambda: F.scaled_dot_product_attention(q3, k3, v3))
        bound_ms, bound_by, flops, nbytes = attention_bound(B * H, t, D)
        row = dict(T=t, max_abs_err=err, lse_max_abs_err=lse_err, ms=ms,
                   ms_bh_t_d=ms_flat, device_ms=dev_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_device_ms=lib_dev_ms,
                   bound_ms=bound_ms,
                   bound_by=bound_by, flops=flops, bytes=nbytes)
        rows.append(row)
        print(f"[kernel] flash_attn_fwd B={B} H={H} T={t} D={D}: "
              f"max_err {err:.3e} (bound {OUT_ATOL}), lse_err "
              f"{lse_err:.3e}, [B, T, H, D] views = [B*H, T, D] bit for bit; "
              f"wrapper {ms:.4f} ms on the views ({ms_flat:.4f} on "
              f"[B*H, T, D]), device {dev_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms (device {lib_dev_ms:.4f}), bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops:.4g} flop, "
              f"{nbytes:.4g} B)", flush=True)
    return rows


# Backward kernel vs its plain version on the same bf16 inputs: the plain
# version repeats the kernel's casts (P and dS to bf16 before their
# products), so the two differ only by fp32 summation order, which can move
# one bf16 rounding of P, dS or an output by one ulp (2^-8 relative). A
# bound of 2^-6 of the largest |value| of each gradient holds that and
# fails on a wrong fragment, mask or scale (those move whole rows).
BWD_RTOL_OF_MAX = 2.0 ** -6
# LayerNorm backward: dx is written in bf16 (one rounding, 2^-8 relative, a
# flip of it 2^-7 of the largest |dx|); dgamma and dbeta are fp32 sums over
# 3588 rows in another order (each term equal to ~1e-6 relative), so 1e-4
# of the largest |value|.
LN_DX_RTOL_OF_MAX = 2.0 ** -7
LN_DPARAM_RTOL_OF_MAX = 1e-4
# Fused Adam: the same fp32 formula, IEEE sqrt and division on both sides;
# they differ by fused multiply-adds at most, a few ulp of p (|p| < 8:
# ulp 5e-7), of m and of v.
ADAM_ATOL = 2e-6
LN_SHAPE = (12 * 299, 1024)  # [meta-batch x frames at 6 s, d_model]
# edge shapes: D not a multiple of the kernel's 256-column lane sweep, and
# D past 1024 (the kernel's wider instance)
LN_EDGES = ((1000, 1000), (12 * 299, 1280))


def attention_bwd_bound(bh: int, t: int, d: int):
    """Least time for one backward on an H100: five products of 2*T*T*D
    flops per (b, h); q, k, v, o, dO read and dq, dk, dv written once in
    bf16, lse read once in fp32 (delta is the kernels' own intermediate)."""
    flops = 10.0 * bh * t * t * d
    nbytes = 8.0 * bh * t * d * 2 + bh * t * 4
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def bytes_bound(nbytes: float, flops: float = 0.0,
                peak_flops: float = PEAK_FP32_FLOPS):
    t_ops = flops / peak_flops
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check_attention_autograd(q4, k4, v4, do4, want, t):
    """`flash_attention` on CUDA [B, T, H, D] views: q, k and v get
    contiguous gradients, through one launch of each backward kernel and no
    copy, equal bit for bit to the backward wrapper's `want`; a dO that
    the TMA maps cannot read (the expanded ones of `out.sum()`) costs one
    counted copy and gives the gradients of the same dO made contiguous."""
    import torch

    from occm_tpu_torch.ops import attention

    q, k, v = (x.detach().requires_grad_() for x in (q4, k4, v4))
    before = (attention.BWD_DQ_LAUNCHES, attention.BWD_DKV_LAUNCHES,
              attention.BWD_DOUT_COPIES)
    grads = torch.autograd.grad(attention.flash_attention(q, k, v),
                                (q, k, v), do4)
    torch.cuda.synchronize()
    if (attention.BWD_DQ_LAUNCHES - before[0],
            attention.BWD_DKV_LAUNCHES - before[1],
            attention.BWD_DOUT_COPIES - before[2]) != (1, 1, 0):
        fail("flash_attention backward did not launch each backward kernel "
             "once without a copy")
    for name, g, w in zip(("q", "k", "v"), grads, want):
        if not (g.shape == q4.shape and g.is_contiguous()):
            fail(f"flash_attention: {name}'s gradient is not contiguous "
                 f"{tuple(q4.shape)}: {tuple(g.shape)} {g.stride()}")
        if not torch.equal(g, w):
            fail(f"flash_attention: {name}'s gradient is not the kernel's")
    out = attention.flash_attention(q, k, v)
    before = attention.BWD_DOUT_COPIES
    summed = torch.autograd.grad(out.sum(), (q, k, v), retain_graph=True)
    ones = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    torch.cuda.synchronize()
    if attention.BWD_DOUT_COPIES - before != 1:
        fail("flash_attention: an expanded dO was not copied once")
    if not all(torch.equal(a, b) for a, b in zip(summed, ones)):
        fail("flash_attention: the gradients of out.sum() are not those of "
             "a contiguous dO of ones")
    print(f"[kernel] flash_attention autograd on cuda at T={t}: q, k, v "
          "gradients are the backward kernels', contiguous [B, T, H, D], no "
          "copy; an expanded dO costs one counted copy", flush=True)


def phase_attention_bwd():
    """flash_attn_bwd at every KERNEL_TS, B = TRAIN_B, on [B, T, H, D]
    views of one [B, T, 3 * H * D] projection output (the layout the model
    hands it, read in place) and on [B*H, T, D] copies: the two give the
    same bits, a repeat gives the same bits, one call is two device
    launches (dq, dk/dv) and nothing else, and the gradients are within
    BWD_RTOL_OF_MAX of the plain version's."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd)

    gen = torch.Generator(device="cuda").manual_seed(1)
    bt, ht = TRAIN_B, H
    rows = []
    for t in KERNEL_TS:
        qkv = torch.randn((bt, t, 3 * ht * D), generator=gen,
                          device="cuda").to(torch.bfloat16)
        q4, k4, v4 = qkv.view(bt, t, 3, ht, D).unbind(2)
        do4 = torch.randn((bt, t, ht, D), generator=gen,
                          device="cuda").to(torch.bfloat16)
        out4, lse = flash_attention_fwd(q4, k4, v4, t)

        def flat(x):
            return x.permute(0, 2, 1, 3).reshape(bt * ht, t, D).contiguous()

        q, k, v, out, do = (flat(x) for x in (q4, k4, v4, out4, do4))
        got4 = flash_attention_bwd(q4, k4, v4, out4, lse, do4, t)
        again = flash_attention_bwd(q4, k4, v4, out4, lse, do4, t)
        got = flash_attention_bwd(q, k, v, out, lse, do, t)
        torch.cuda.synchronize()
        for name, a, b, c in zip(("dq", "dk", "dv"), got4, again, got):
            if not (a.shape == q4.shape and a.is_contiguous()):
                fail(f"flash_attn_bwd T={t}: {name} is not contiguous "
                     f"[B, T, H, D]: {tuple(a.shape)} {a.stride()}")
            if not torch.equal(a, b):
                fail(f"flash_attn_bwd T={t}: two calls give different {name}")
            if not torch.equal(flat(a), c):
                fail(f"flash_attn_bwd T={t}: [B, T, H, D] views and "
                     f"[B*H, T, D] give different {name}")
        want = flash_attention_bwd_reference(q, k, v, out, lse, do, t)
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            if not (math.isfinite(err) and err <= BWD_RTOL_OF_MAX * scale):
                fail(f"flash_attn_bwd T={t}: max |{name} - plain| = {err} > "
                     f"{BWD_RTOL_OF_MAX} * {scale}")
            errs.append((name, err, scale))
        if t == MAIN_PATH_TS[0]:
            check_attention_autograd(q4, k4, v4, do4, got4, t)
        ms = cuda_ms(lambda: flash_attention_bwd(q4, k4, v4, out4, lse, do4,
                                                 t))
        ms_flat = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                                      t))
        dev_ms, own, every = device_ms(
            lambda: flash_attention_bwd(q4, k4, v4, out4, lse, do4, t),
            ("flash_attn_bwd",))
        if (own, every) != (2, 2):
            fail(f"flash_attn_bwd T={t}: {every} device launches a call "
                 f"({own} of the kernels), want 2 (dq, dk/dv) and no other")
        dq_ms, dkv_ms = (device_ms(
            lambda: flash_attention_bwd(q4, k4, v4, out4, lse, do4, t),
            (name,))[0] for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"))
        plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(
            q, k, v, out, lse, do, t), iters=3, warmup=1)
        q3, k3, v3 = (x.view(bt, ht, t, D).detach().requires_grad_()
                      for x in (q, k, v))
        do3 = do.view(bt, ht, t, D)

        def sdpa_fwd_bwd():
            o3 = F.scaled_dot_product_attention(q3, k3, v3)
            torch.autograd.grad(o3, (q3, k3, v3), do3)

        with torch.no_grad():
            fwd_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q3, k3, v3))
        library_ms = cuda_ms(sdpa_fwd_bwd) - fwd_ms
        with torch.no_grad():
            fwd_dev_ms = library_device_ms(
                lambda: F.scaled_dot_product_attention(q3, k3, v3))
        lib_dev_ms = library_device_ms(sdpa_fwd_bwd) - fwd_dev_ms
        bound_ms, bound_by, flops, nbytes = attention_bwd_bound(bt * ht, t, D)
        row = dict(T=t, max_abs_err=max(e[1] for e in errs),
                   errors={n: e for n, e, _ in errs}, ms=ms,
                   ms_bh_t_d=ms_flat, device_ms=dev_ms,
                   device_ms_dq=dq_ms, device_ms_dkv=dkv_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_device_ms=lib_dev_ms,
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes)
        rows.append(row)
        print(f"[kernel] flash_attn_bwd B={bt} H={ht} T={t} D={D}: "
              + ", ".join(f"{n} err {e:.3e} (max |plain| {m:.3e})"
                          for n, e, m in errs)
              + f"; [B, T, H, D] views = [B*H, T, D] and repeat bit for "
              f"bit, 2 device launches a call; wrapper {ms:.4f} ms on the "
              f"views ({ms_flat:.4f} on [B*H, T, D]), device {dev_ms:.4f} ms "
              f"(dq {dq_ms:.4f} + dk/dv {dkv_ms:.4f}), plain {plain_ms:.4f} "
              f"ms, sdpa bwd "
              f"{library_ms:.4f} ms (device {lib_dev_ms:.4f}), bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops:.4g} flop, "
              f"{nbytes:.4g} B)", flush=True)
    return rows


def phase_layernorm_bwd():
    """layernorm_bwd against its plain version at LN_SHAPE and the
    LN_EDGES shapes, bf16, each timed beside its bound, plain and library
    times: every call one device launch, and dx, dgamma, dbeta of a second
    call identical bit for bit. Returns LN_SHAPE's row with every shape's
    under "per_shape"."""
    import torch

    from occm_tpu_torch.ops.layernorm import (
        layer_norm_bwd, layer_norm_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(2)
    eps = 1e-5
    rows = []
    for m, d in (LN_SHAPE,) + LN_EDGES:
        x = torch.randn((m, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        g = torch.randn((m, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        got = layer_norm_bwd(x, gamma, g, eps)
        again = layer_norm_bwd(x, gamma, g, eps)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"layernorm_bwd [{m}, {d}]: two calls differ")
        want = layer_norm_bwd_reference(x, gamma, g, eps)
        errs = {}
        for name, a, b, rtol in zip(
                ("dx", "dgamma", "dbeta"), got, want,
                (LN_DX_RTOL_OF_MAX, LN_DPARAM_RTOL_OF_MAX,
                 LN_DPARAM_RTOL_OF_MAX)):
            err = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            if not (math.isfinite(err) and err <= rtol * scale):
                fail(f"layernorm_bwd [{m}, {d}]: max |{name} - plain| = "
                     f"{err} > {rtol} * {scale}")
            errs[name] = err
        dev_ms, own, every = device_ms(
            lambda: layer_norm_bwd(x, gamma, g, eps), ("layernorm_bwd",))
        if (own, every) != (1, 1):
            fail(f"layernorm_bwd [{m}, {d}]: {every} device launches a call "
                 f"({own} of the kernel), want 1")
        ms = cuda_ms(lambda: layer_norm_bwd(x, gamma, g, eps))
        plain_ms = cuda_ms(lambda: layer_norm_bwd_reference(x, gamma, g,
                                                            eps))
        gb = gamma.to(torch.bfloat16)
        bb = torch.zeros_like(gb)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], gb, bb, eps)
        library_ms = cuda_ms(
            lambda: torch.ops.aten.native_layer_norm_backward(
                g, x, [d], mean, rstd, gb, bb, [True, True, True]))
        lib_dev_ms = library_device_ms(
            lambda: torch.ops.aten.native_layer_norm_backward(
                g, x, [d], mean, rstd, gb, bb, [True, True, True]))
        nbytes = 3.0 * m * d * 2 + 3.0 * d * 4
        flops = 12.0 * m * d
        bound_ms, bound_by = bytes_bound(nbytes, flops)
        print(f"[kernel] layernorm_bwd [{m}, {d}] bf16: "
              + ", ".join(f"{n} err {e:.3e}" for n, e in errs.items())
              + f", repeat bit-identical, 1 device launch a call, device "
              f"{dev_ms:.4f} ms, wrapper {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, aten native_layer_norm_backward {library_ms:.4f} ms "
              f"(device {lib_dev_ms:.4f}), bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops:.4g} flop, {nbytes:.4g} B)", flush=True)
        rows.append(dict(shape=[m, d], max_abs_err=max(errs.values()),
                         errors=errs, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                         bound_by=bound_by, flops=flops, bytes=nbytes))
    return dict(rows[0], per_shape=rows)


def phase_fused_adam():
    import torch

    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.ops import fused_adam
    from occm_tpu_torch.ops.fused_adam import (
        FusedAdam, adam_reference, bias_corrections_of)
    from occm_tpu_torch.utils import random_init_

    odd_err = phase_fused_adam_odd_leaves()
    model = random_init_(AModel(AASISTConfig(), XLSRConfig()), seed=0)
    params = [p.detach().to("cuda") for p in model.parameters()]
    del model
    n = sum(p.numel() for p in params)
    gen = torch.Generator(device="cuda").manual_seed(3)
    grads = [torch.randn(p.shape, generator=gen, device="cuda")
             for p in params]
    opt = FusedAdam(1e-5).init(params)
    # moments from two earlier steps, so step 3's bias corrections and
    # moment decay are exercised
    for m_, v_, g_ in zip(opt.mu, opt.nu, grads):
        m_.copy_(0.1 * g_)
        v_.copy_(0.001 * g_ * g_)
    opt.count = 2
    ref = [(p.clone(), m_.clone(), v_.clone())
           for p, m_, v_ in zip(params, opt.mu, opt.nu)]
    before = fused_adam.LAUNCHES
    opt.step(params, grads)
    torch.cuda.synchronize()
    if fused_adam.LAUNCHES - before != 1:
        fail(f"fused_adam: a step over {len(params)} leaves made "
             f"{fused_adam.LAUNCHES - before} launches, want 1")
    # the kernel read its step count (3) from the device; the plain version
    # computes the corrections from the same tensor
    if opt.count != 3:
        fail(f"fused_adam: step count {opt.count} after a step from 2")
    inv_bc1, inv_bc2 = bias_corrections_of(opt.count_t, opt.b1, opt.b2)
    err = 0.0
    for (p0, m0, v0), p, m_, v_, g_ in zip(ref, params, opt.mu, opt.nu,
                                           grads):
        adam_reference(p0, m0, v0, g_, inv_bc1, inv_bc2, opt.lr, opt.b1,
                       opt.b2, opt.eps)
        for a, b in ((p, p0), (m_, m0), (v_, v0)):
            err = max(err, (a - b).abs().max().item())
    del ref
    if not (math.isfinite(err) and err <= ADAM_ATOL):
        fail(f"fused_adam: max |p, m, v - plain| = {err} > {ADAM_ATOL}")
    ms = cuda_ms(lambda: opt.step(params, grads), iters=5, warmup=1)
    dev_ms, _, _ = device_ms(lambda: opt.step(params, grads), ("fused_adam",),
                             iters=5, warmup=1)
    m_list, v_list = opt.mu, opt.nu
    plain_ms = cuda_ms(lambda: [adam_reference(
        p, m_, v_, g_, inv_bc1, inv_bc2, opt.lr, opt.b1, opt.b2, opt.eps)
        for p, m_, v_, g_ in zip(params, m_list, v_list, grads)],
        iters=3, warmup=1)
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for lp, g_ in zip(lib_params, grads):
        lp.grad = g_
    lib_opt = torch.optim.Adam(lib_params, lr=1e-5, fused=True)
    library_ms = cuda_ms(lib_opt.step, iters=5, warmup=1)
    lib_dev_ms = library_device_ms(lib_opt.step, iters=5, warmup=1)
    del lib_opt, lib_params
    nbytes = 28.0 * n
    bound_ms, bound_by = bytes_bound(nbytes, 10.0 * n)
    print(f"[kernel] fused_adam over {len(params)} leaves, {n} fp32 params "
          f"(1 launch): max err {err:.3e} (bound {ADAM_ATOL}; odd leaves "
          f"{odd_err:.3e}), wrapper {ms:.4f} ms/step, device {dev_ms:.4f} "
          f"ms, "
          f"plain {plain_ms:.4f} ms, torch Adam(fused=True) "
          f"{library_ms:.4f} ms (device {lib_dev_ms:.4f}), bound "
          f"{bound_ms:.4f} ms ({bound_by}; {nbytes:.4g} B)", flush=True)
    return dict(leaves=len(params), params=n, max_abs_err=max(err, odd_err),
                ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes)


def phase_fused_adam_odd_leaves() -> float:
    """FusedAdam over leaves that test the kernel's edges: 1, 3 and 1027
    elements (scalar tails), a leaf of two chunks plus 3, an aligned
    [64, 128], a leaf with a None gradient (left as it is), and a leaf that
    is a view 4 bytes past a 16-byte boundary (a clone of its values into a
    buffer at storage offset 1, so the kernel takes its scalar path). One
    launch, held against adam_reference at ADAM_ATOL; returns the largest
    error."""
    import torch

    from occm_tpu_torch.ops import fused_adam
    from occm_tpu_torch.ops.fused_adam import (
        FusedAdam, adam_reference, bias_corrections_of)

    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = [(1,), (3,), (1027,), (2 * fused_adam.CHUNK + 3,), (64, 128),
              (5,), (777,)]
    none_leaf, view_leaf = 5, 6
    params = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    buf = torch.empty(params[view_leaf].numel() + 1, device="cuda")
    params[view_leaf] = buf[1:].copy_(params[view_leaf])
    if params[view_leaf].data_ptr() % 16 == 0:
        fail("the odd-leaf case's view leaf is 16-byte aligned")
    grads = [None if i == none_leaf else
             torch.randn(s, generator=gen, device="cuda")
             for i, s in enumerate(shapes)]
    opt = FusedAdam(1e-3).init(params)
    for m_, v_, g_ in zip(opt.mu, opt.nu, grads):
        if g_ is not None:
            m_.copy_(0.1 * g_)
            v_.copy_(0.001 * g_ * g_)
    opt.count = 2
    ref = [(p.clone(), m_.clone(), v_.clone())
           for p, m_, v_ in zip(params, opt.mu, opt.nu)]
    before = fused_adam.LAUNCHES
    opt.step(params, grads)
    torch.cuda.synchronize()
    if fused_adam.LAUNCHES - before != 1:
        fail("fused_adam odd leaves: not one launch")
    inv_bc1, inv_bc2 = bias_corrections_of(opt.count_t, opt.b1, opt.b2)
    err = 0.0
    for (p0, m0, v0), p, m_, v_, g_ in zip(ref, params, opt.mu, opt.nu,
                                           grads):
        if g_ is not None:
            adam_reference(p0, m0, v0, g_, inv_bc1, inv_bc2, opt.lr, opt.b1,
                           opt.b2, opt.eps)
        for a, b in ((p, p0), (m_, m0), (v_, v0)):
            err = max(err, (a - b).abs().max().item())
    if not (math.isfinite(err) and err <= ADAM_ATOL):
        fail(f"fused_adam odd leaves: max |p, m, v - plain| = {err} > "
             f"{ADAM_ATOL}")
    if not torch.equal(params[none_leaf], ref[none_leaf][0]):
        fail("fused_adam odd leaves: the leaf without a gradient moved")
    print(f"[kernel] fused_adam odd leaves {shapes} (leaf {none_leaf} "
          f"without a gradient, leaf {view_leaf} at a 4-byte offset): max "
          f"err {err:.3e} (bound {ADAM_ATOL}), 1 launch", flush=True)
    return err


def ffn_bound(m: int, d: int, f: int):
    """Least time for y = GELU(x W1 + b1) W2 + b2 on an H100: two products
    of 2 M D F flops; x, W1, W2, b1, b2 read once and y written once in
    bf16. Returns (bound_ms, bound_by, flops, bytes)."""
    flops = 4.0 * m * d * f
    nbytes = 2.0 * (2 * m * d + 2 * d * f + f + d)
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_ffn():
    """ffn_fwd against ffn_reference at the FFN_MS shapes, full width,
    erf and tanh GELU, and at the edge shapes FFN_EDGES (erf), with the
    kernel, plain, library and bound times. Library: the port's
    ffn_impl="xla" sequence, F.linear -> F.gelu -> F.linear in bf16 (three
    calls; no single PyTorch call computes the fused function)."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.ops.ffn import ffn_fwd, ffn_reference

    cfg = XLSRConfig()
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device="cuda")).to(
            torch.bfloat16)

    weights = {}

    def layer(d, f):
        """fc1.weight [F, D], fc1.bias, fc2.weight [D, F], fc2.bias, as
        the model holds them, and the JAX-layout views it passes."""
        if (d, f) not in weights:
            fc1_w, fc1_b = randn(f, d, std=0.02), randn(f, std=0.02)
            fc2_w, fc2_b = randn(d, f, std=0.02), randn(d, std=0.02)
            weights[d, f] = (fc1_w, fc1_b, fc2_w, fc2_b, fc1_w.t(),
                             fc2_w.t())
        return weights[d, f]

    cases = [(m, cfg.encoder_embed_dim, cfg.encoder_ffn_dim, approximate)
             for m in FFN_MS for approximate in (False, True)]
    cases += [(m, d, f, False) for m, d, f in FFN_EDGES]
    rows = []
    for m, d, f, approximate in cases:
        fc1_w, fc1_b, fc2_w, fc2_b, w1, w2 = layer(d, f)
        x = randn(m, d)
        y = ffn_fwd(x, w1, fc1_b, w2, fc2_b, approximate)
        torch.cuda.synchronize()
        ref = ffn_reference(x, w1, fc1_b, w2, fc2_b, approximate)
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not (y.shape == (m, d) and math.isfinite(err)
                and err <= FFN_RTOL_OF_MAX * scale):
            fail(f"ffn_fwd M={m} D={d} F={f} approximate={approximate}: "
                 f"max |y - plain| = {err} > {FFN_RTOL_OF_MAX} * {scale}")
        gelu = "tanh" if approximate else "erf"
        ms = cuda_ms(lambda: ffn_fwd(x, w1, fc1_b, w2, fc2_b, approximate))
        dev_ms, _, _ = device_ms(
            lambda: ffn_fwd(x, w1, fc1_b, w2, fc2_b, approximate),
            ("ffn_gemm_kernel",))
        plain_ms = cuda_ms(lambda: ffn_reference(
            x, w1, fc1_b, w2, fc2_b, approximate), iters=5, warmup=1)
        mode = "tanh" if approximate else "none"
        library_ms = cuda_ms(lambda: F.linear(F.gelu(
            F.linear(x, fc1_w, fc1_b), approximate=mode), fc2_w, fc2_b))
        lib_dev_ms = library_device_ms(lambda: F.linear(F.gelu(
            F.linear(x, fc1_w, fc1_b), approximate=mode), fc2_w, fc2_b))
        bound_ms, bound_by, flops, nbytes = ffn_bound(m, d, f)
        rows.append(dict(M=m, D=d, F=f, gelu=gelu, max_abs_err=err,
                         max_abs_y=scale, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                         bound_by=bound_by, flops=flops, bytes=nbytes))
        print(f"[kernel] ffn_fwd [{m}, {d}] x [{d}, {f}] bf16, {gelu}: "
              f"max_err {err:.3e} (bound {FFN_RTOL_OF_MAX} * {scale:.3e})"
              f", wrapper {ms:.4f} ms, device {dev_ms:.4f} ms (fc1 + fc2), "
              f"plain {plain_ms:.4f} ms, ffn_impl=xla sequence (F.linear, F.gelu, F.linear) "
              f"{library_ms:.4f} ms (device {lib_dev_ms:.4f}), bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops:.4g} flop, "
              f"{nbytes:.4g} B)", flush=True)
    return rows


# ------------------------------------------------------ scoring (phase 4)

def build_seed_model(workdir: str):
    """The full-width AModel with random weights from seed 0, on the card
    in eval mode, and its state dict saved as a reference-named .pt."""
    import torch

    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.utils import random_init_

    xcfg = XLSRConfig()
    t0 = time.perf_counter()
    model = random_init_(AModel(AASISTConfig(), xcfg), seed=0).to(
        "cuda").eval()
    ckpt = os.path.join(workdir, "amodel_seed0.pt")
    torch.save(model.state_dict(), ckpt)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] AModel(AASISTConfig(), XLSRConfig()): {n_params} params, "
          f"{xcfg.encoder_layers} layers d={xcfg.encoder_embed_dim} "
          f"ffn={xcfg.encoder_ffn_dim} heads={xcfg.encoder_heads} "
          f"dtype={xcfg.dtype}; init + save {time.perf_counter() - t0:.1f} s",
          flush=True)
    return model, ckpt


# The tiny model on the card against itself on the CPU: both fp32 with TF32
# off (phase 1), plain attention on both, so they differ only by the order
# of fp32 sums through two layers and the backend (relative ~1e-6); 1e-3
# of the largest |value| holds that and fails on a wrong route or layout.
TINY_RTOL_OF_MAX = 1e-3


def phase_tiny_auto():
    """The repaired fault: XLSRConfig.tiny() is fp32 with head dim 16,
    which the CUDA flash kernels do not take. On the card, auto must pick
    "xla" for it in every bucket: 4 waves of 1-2 s through
    BucketedEmbedder and make_embed_fn_factory (what oc_classifier, embed
    and oc_server run), in two buckets, score with no flash launch and
    agree with the same model on the CPU; a pinned "flash" still raises."""
    import torch

    from occm_tpu_torch.classify import (
        BucketedEmbedder, make_embed_fn_factory)
    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.ops import attention
    from occm_tpu_torch.serve import make_score_fn
    from occm_tpu_torch.utils import random_init_

    xcfg = XLSRConfig.tiny()
    model = random_init_(AModel(AASISTConfig.tiny(), xcfg), seed=0)
    rng = np.random.default_rng(3)
    waves = [synthetic_wave(rng, sec) for sec in (1.0, 1.5, 1.7, 2.0)]

    def embed(device):
        emb, logits = BucketedEmbedder(
            embed_fn_factory=make_embed_fn_factory(model, "auto",
                                                   xcfg.norm_dtype),
            bucket_step=SR, batch_size=4, device=device).embed_all(waves)
        return emb, logits

    want = embed("cpu")
    model.to("cuda")
    before = attention.LAUNCHES
    got = embed("cuda")
    if attention.LAUNCHES != before:
        fail("tiny model under auto on the card launched the flash kernel")
    for name, a, b in zip(("embeddings", "logits"), got, want):
        err = float(np.abs(a - b).max())
        scale = float(np.abs(b).max())
        if not (a.shape == b.shape and np.isfinite(a).all()
                and err <= TINY_RTOL_OF_MAX * scale):
            fail(f"tiny model under auto on the card: {name} "
                 f"{a.shape} max |cuda - cpu| = {err} > "
                 f"{TINY_RTOL_OF_MAX} * {scale}")
    try:
        make_score_fn(model, "flash")(
            torch.from_numpy(np.stack([w[:SR] for w in waves])).to("cuda"))
    except ValueError as e:
        pinned = str(e)
    else:
        fail("tiny model with a pinned flash impl did not raise on the card")
    print(f"[tiny] XLSRConfig.tiny() (fp32, head dim 16) on the card under "
          f"auto: {len(waves)} waves of 1-2 s scored through xla attention "
          f"(0 flash launches), embeddings {got[0].shape} within "
          f"{TINY_RTOL_OF_MAX} of the largest |value| of the CPU's; pinned "
          f"flash raises: {pinned}", flush=True)
    del model
    torch.cuda.empty_cache()


# Eval utterances of the scoring phase, seconds: with oc_classifier's
# default --bucket_step 16000 they fill the 3 s and 4 s buckets (plain
# attention under auto) and nine buckets of 5-13 s (the flash kernel; 11 s
# and up have T > 512 frames, the JAX package's blocked route).
EVAL_SECONDS = (3.0, 3.0, 3.6, 3.9, 4.5, 5.4, 5.9, 6.3, 7.2, 8.5, 9.6, 10.5,
                11.2, 11.9, 12.6, 13.0)
# pallas vs xla FFN distances through the whole 24-layer model: the xla path
# rounds fc1's output to bf16 before the GELU, the fused kernel applies the
# GELU in fp32 and rounds after it: a relative 2^-9 per hidden element per
# layer, carried through 24 layers as the flash-vs-xla attention rounding
# is (SCORE_RTOL's argument), so the same relative bound.
FFN_SCORE_RTOL = SCORE_RTOL
THROUGHPUT_REPS = 4


def write_eval_set(root: str, seed: int = 1):
    """A bare eval list over EVAL_SECONDS waves, trial metadata with
    labels (column 2 utt, column 6 label) and a 5-column protocol of the
    same utterances and labels."""
    from occm_tpu_torch.io.wav import write_wav

    eval_dir = os.path.join(root, "eval")
    os.makedirs(eval_dir)
    rng = np.random.default_rng(seed)
    utts, meta, proto = [], [], []
    for i, sec in enumerate(EVAL_SECONDS):
        utt = f"LA_E_{i:05d}"
        write_wav(os.path.join(eval_dir, utt + ".wav"),
                  synthetic_wave(rng, sec), SR)
        label = "spoof" if i % 2 else "bonafide"
        utts.append(utt)
        meta.append(f"LA_{i:04d} {utt} - asvspoof A09 {label} notrim eval "
                    "- - - -")
        proto.append(f"LA_{i:04d} {utt} - - {label}")
    paths = {}
    for name, lines in (("eval.txt", utts), ("metadata.txt", meta),
                        ("eval5.txt", proto)):
        paths[name] = os.path.join(root, name)
        with open(paths[name], "w") as f:
            f.write("\n".join(lines) + "\n")
    return eval_dir, paths


def flash_batches(lengths, batch: int = 8, step: int = 16000) -> int:
    """Batches the scorer runs through the flash kernel under auto for
    utterances of these sample counts: per bucket, ceil(count / batch)."""
    from occm_tpu_torch.classify.impl_select import select_attention_impl

    counts = {}
    for n in lengths:
        b = max(step, -(-n // step) * step)
        counts[b] = counts.get(b, 0) + 1
    return sum(-(-c // batch) for b, c in counts.items()
               if select_attention_impl(b) == "flash")


def utt_per_s(fns, x) -> dict:
    """Utterances per second of each fn on batch x, timed in turns
    (A B ... B A) on the host clock around synchronised runs of
    THROUGHPUT_REPS calls each."""
    import torch

    times = dict.fromkeys(fns, 0.0)
    for fn in fns.values():
        fn(x)  # warm-up: kernels, allocator pools, cuDNN plans
    for k in list(fns) + list(fns)[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(THROUGHPUT_REPS):
            fns[k](x)
        torch.cuda.synchronize()
        times[k] += time.perf_counter() - t0
    return {k: 2 * THROUGHPUT_REPS * x.shape[0] / t for k, t in times.items()}


def phase_scoring(workdir: str, model, ckpt: str, fixture):
    """Offline scoring and evaluation at full width: `oc_classifier` in
    1c2 and 2c2 mode on the fixture's train protocol and a bare eval list
    (attention auto per bucket, ffn "xla" as the CLI runs it), the same eval
    set through OneClassScorer with ffn_impl="pallas" (the fused FFN kernel)
    gated against the CLI's distances, EER and confusion matrix from the
    score files, and utterances/s per bucket. Returns the artefacts'
    directory and the kernels' launches."""
    import torch

    from occm_tpu_torch.audio import pad_numpy
    from occm_tpu_torch.classify import (
        BucketedEmbedder, OneClassScorer, make_embed_fn_factory)
    from occm_tpu_torch.classify.impl_select import (
        AUTO_FLASH_MIN_SAMPLES, select_attention_impl)
    from occm_tpu_torch.cli import oc_classifier
    from occm_tpu_torch.cli.oc_server import build_model
    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.data import ASVDataset
    from occm_tpu_torch.evaluate import calculate_eer_merged, evaluate_scores
    from occm_tpu_torch.io.scorefiles import read_comma_scores
    from occm_tpu_torch.io.wav import load_audio
    from occm_tpu_torch.serve import make_score_fn

    protocol, train_dir, _ = fixture
    root = os.path.join(workdir, "scoring")
    os.makedirs(root)
    eval_dir, paths = write_eval_set(root)
    layers = XLSRConfig().encoder_layers
    eval_ds = ASVDataset(paths["eval.txt"], eval_dir, eval=True)
    train_ds = ASVDataset(protocol, train_dir)
    eval_lens = [len(load_audio(p)[0]) for p in eval_ds.file_paths()]
    train_lens = [len(load_audio(p)[0]) for p in train_ds.file_paths()]
    n_eval, n_train = len(eval_lens), len(train_lens)
    eval_buckets = sorted({max(16000, -(-n // 16000) * 16000)
                           for n in eval_lens})
    flash_eval = flash_batches(eval_lens)
    flash_train = flash_batches(train_lens)
    print(f"[score] eval set: {n_eval} utterances of {EVAL_SECONDS[0]}-"
          f"{EVAL_SECONDS[-1]} s in buckets {eval_buckets} "
          f"({flash_eval} flash batches under auto); train protocol: "
          f"{n_train} bonafide rows (the 2 spoof rows are filtered out)",
          flush=True)

    # ---- the CLI, as a user runs it: 1c2, then 2c2
    argv = ["--pretrained-sslaasist", ckpt, "--protocol_file", protocol,
            "--dataset_dir", train_dir, "--eval_protocol_file",
            paths["eval.txt"], "--eval_dataset_dir", eval_dir]
    scores = {m: os.path.join(root, f"scores_{m}.txt") for m in ("1c2", "2c2")}
    cwd = os.getcwd()
    os.chdir(root)  # reference_embedding.npy, threshold.npy land here
    launches = {"flash_attn_fwd": 0}
    try:
        for mode, want_batches in (("1c2", flash_train + flash_eval),
                                   ("2c2", flash_eval)):
            reset_counts()
            t0 = time.perf_counter()
            oc_classifier.main(argv + ["--mode", mode, "--score_file",
                                       scores[mode]])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            if counts["flash_attn_fwd"] != layers * want_batches or \
                    counts["ffn_fwd"] != 0:
                fail(f"oc_classifier {mode}: launches {counts}, want "
                     f"flash_attn_fwd {layers * want_batches}, ffn_fwd 0")
            launches["flash_attn_fwd"] += counts["flash_attn_fwd"]
            print(f"[score] oc_classifier --mode {mode}: {wall:.1f} s "
                  "(model load included), launches "
                  f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    finally:
        os.chdir(cwd)
    for name in ("reference_embedding.npy", "threshold.npy", "distances.txt"):
        if not os.path.exists(os.path.join(root, name)):
            fail(f"oc_classifier 1c2 wrote no {name}")
    reference = np.load(os.path.join(root, "reference_embedding.npy"))
    threshold = float(np.load(os.path.join(root, "threshold.npy")))
    train_d = np.loadtxt(os.path.join(root, "distances.txt"))
    if not (reference.shape == (160,) and np.isfinite(reference).all()
            and train_d.shape == (n_train,)
            and math.isfinite(threshold) and threshold == np.float32(
                train_d.max())):
        fail(f"bad artefacts: reference {reference.shape}, threshold "
             f"{threshold}, distances {train_d}")
    lines_1c = open(scores["1c2"]).read().splitlines(keepends=True)
    d_cli = np.asarray(read_comma_scores(scores["1c2"]))
    logits = np.loadtxt(scores["2c2"])
    if len(lines_1c) != n_eval or logits.shape != (n_eval,):
        fail(f"score files: {len(lines_1c)} and {logits.shape} lines, want "
             f"{n_eval}")
    for line, d in zip(lines_1c, d_cli):
        if line != f"{d}, {int(d > threshold)} \n" or not math.isfinite(d):
            fail(f"bad 1c score line {line!r}")
    if not np.isfinite(logits).all():
        fail(f"2c logits not finite: {logits}")
    print(f"[score] artefacts: reference {reference.shape}, threshold "
          f"{threshold:.6f} (max of {n_train} train distances); 1c "
          f"distances {np.round(d_cli, 4).tolist()}; 2c logits "
          f"{np.round(logits, 4).tolist()}", flush=True)

    # ---- the fused FFN kernel's path: same checkpoint, ffn_impl="pallas"
    pallas = build_model(XLSRConfig(ffn_impl="pallas"), ckpt, False, "cuda")
    scorer = OneClassScorer(BucketedEmbedder(
        embed_fn_factory=make_embed_fn_factory(pallas), device="cuda"),
        cache_dir=root)
    pallas_file = os.path.join(root, "scores_1c2_pallas.txt")
    reset_counts()
    scorer.score_eval_set_1c(eval_ds, reference, threshold,
                             score_file=pallas_file)
    torch.cuda.synchronize()
    counts = read_counts()
    n_batches = len(eval_buckets)
    if counts["ffn_fwd"] != layers * n_batches:
        fail(f"ffn_impl=pallas scoring: ffn_fwd launched {counts['ffn_fwd']}"
             f" times over {n_batches} batches, want {layers * n_batches}")
    launches["ffn_fwd"] = counts["ffn_fwd"]
    launches["flash_attn_fwd"] += counts["flash_attn_fwd"]
    d_pallas = np.asarray(read_comma_scores(pallas_file))
    rel = np.abs(d_pallas - d_cli) / np.abs(d_cli)
    print(f"[score] ffn_impl=pallas: ffn_fwd launches {counts['ffn_fwd']} "
          f"({layers} x {n_batches} batches); distances vs the CLI's "
          f"(ffn xla): max rel diff {rel.max():.3e} (bound {FFN_SCORE_RTOL})",
          flush=True)
    if not rel.max() <= FFN_SCORE_RTOL:
        fail(f"pallas and xla FFN distances disagree: rel {rel}")

    # ---- evaluation of the score files
    res = evaluate_scores(scores["1c2"], paths["eval.txt"],
                          paths["metadata.txt"], threshold=threshold)
    utt_file = os.path.join(root, "utt_scores_2c.txt")
    with open(utt_file, "w") as f:
        for utt, lg in zip(open(paths["eval.txt"]).read().split(), logits):
            f.write(f"{utt} {float(lg)}\n")
    eer_2c, _ = calculate_eer_merged(paths["eval5.txt"], utt_file)
    for name, eer in (("1c (evaluate_scores)", res["eer"]),
                      ("2c (calculate_eer_merged)", eer_2c)):
        if not (math.isfinite(eer) and 0.0 <= eer <= 1.0):
            fail(f"EER {name} = {eer}")
    print(f"[score] EER 1c {res['eer'] * 100.0:.2f} % (threshold "
          f"{res['eer_threshold']:.6f}), 2c {eer_2c * 100.0:.2f} %; "
          f"confusion matrix {res['confusion_matrix'].tolist()} "
          "(random weights: the values only show the pipeline runs)",
          flush=True)

    # ---- utterances/s at a full batch of 8 per bucket
    rng = np.random.default_rng(7)
    rows = []
    for bucket in sorted(set(eval_buckets) | {16000, 32000}):
        x = torch.from_numpy(np.stack([pad_numpy(
            synthetic_wave(rng, bucket / SR), bucket) for _ in range(8)])
        ).to("cuda")
        fns = {"xla": make_score_fn(model, "xla"),
               "flash": make_score_fn(model, "flash")}
        if bucket in (96000, 192000):
            fns["flash+ffn_pallas"] = make_score_fn(pallas, "flash")
        row = dict(bucket=bucket, auto=select_attention_impl(bucket),
                   **utt_per_s(fns, x))
        rows.append(row)
        print(f"[score] bucket {bucket} ({bucket / SR:.0f} s), batch 8, "
              "utt/s: " + ", ".join(f"{k} {v:.2f}" for k, v in row.items()
                                    if isinstance(v, float))
              + f" (auto picks {row['auto']})", flush=True)
    wins = [r["bucket"] for r in rows if r["flash"] > r["xla"]]
    print(f"[score] flash beats xla attention in buckets {wins}; first "
          f"{wins[0] if wins else None} (AUTO_FLASH_MIN_SAMPLES "
          f"{AUTO_FLASH_MIN_SAMPLES})", flush=True)
    del pallas, scorer
    torch.cuda.empty_cache()
    return root, launches, rows


# ----------------------------------------------------------------- phase 5

def wav_bytes(x: np.ndarray, sr: int = SR) -> bytes:
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    return hdr + b"data" + struct.pack("<I", len(pcm)) + pcm


def synthetic_wave(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """A few random tones plus noise, amplitude ~0.3, 16 kHz float32."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    x = sum(rng.uniform(0.05, 0.1) * np.sin(2 * np.pi * rng.uniform(80, 4000)
                                             * t + rng.uniform(0, 6.3))
            for _ in range(4))
    x = x + 0.02 * rng.standard_normal(n)
    return x.astype(np.float32)


def post(port: int, body: bytes, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                 data=body, method="POST",
                                 headers=headers or {})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        status = resp.status
        payload = json.loads(resp.read())
    return status, payload, (time.perf_counter() - t0) * 1e3


def check_response(name, status, payload):
    if status != 200:
        fail(f"{name}: HTTP {status} {payload}")
    if not (isinstance(payload.get("score"), float)
            and math.isfinite(payload["score"])):
        fail(f"{name}: score not finite: {payload}")
    if payload.get("prediction") not in (0, 1):
        fail(f"{name}: prediction not in {{0, 1}}: {payload}")


def phase_main_path(model, ckpt: str, artifacts_dir: str):
    """Serving: `oc_server` on the checkpoint, from the reference embedding
    and threshold that the scoring phase's `oc_classifier` wrote."""
    import torch

    from occm_tpu_torch.classify.impl_select import select_attention_impl
    from occm_tpu_torch.cli import oc_server
    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.ops import attention
    from occm_tpu_torch.serve import ScoringService, make_score_fn

    dev = torch.device("cuda")
    per_batch = XLSRConfig().encoder_layers  # one kernel launch per layer
    reference = np.load(os.path.join(artifacts_dir, "reference_embedding.npy"))
    threshold = float(np.load(os.path.join(artifacts_dir, "threshold.npy")))
    print(f"[main] serving from oc_classifier's artefacts: reference "
          f"embedding {reference.shape}, threshold {threshold:.6f}",
          flush=True)
    rng = np.random.default_rng(0)

    # --- the server, as a user starts it
    attention.LAUNCHES = 0
    started = threading.Event()
    started.stop = threading.Event()
    errors = []

    def serve():
        try:
            oc_server.main([
                "--pretrained-sslaasist", ckpt,
                "--artifacts_dir", artifacts_dir, "--host", "127.0.0.1",
                "--port", "0", "--max_wait_ms", "100"], started_event=started)
        except BaseException as e:  # surfaced below, never swallowed
            errors.append(e)
            started.set()

    t0 = time.perf_counter()
    th = threading.Thread(target=serve, daemon=True)
    th.start()
    if not started.wait(900) or errors:
        fail(f"server did not start: {errors}")
    port = started.server.port
    service = started.service
    warm_launches = attention.LAUNCHES
    print(f"[main] server up on port {port} in "
          f"{time.perf_counter() - t0:.1f} s (load + warmup of "
          f"{service.buckets}); warmup launches {warm_launches}", flush=True)
    # one warmup batch per bucket; the flash buckets launch the kernel
    warm_want = per_batch * sum(select_attention_impl(b) == "flash"
                                for b in service.buckets)
    if warm_launches != warm_want:
        fail(f"warmup launched the kernel {warm_launches} times, want "
             f"{warm_want}")

    # count the device batches per bucket the batcher forms
    batches = []
    score = service.score

    def counting_score(waves):
        batches.append([service._bucket_for(len(w)) for w in waves])
        return score(waves)

    service.score = counting_score

    w4, w6, w12 = (synthetic_wave(rng, s) for s in (4.0, 6.0, 12.0))
    requests = [
        ("4s_wav", wav_bytes(w4), {}, 64600),
        ("6s_pcm", w6.astype("<f4").tobytes(), {"X-Sample-Rate": "16000"},
         96000),
        ("12s_wav", wav_bytes(w12), {}, 192000),
    ]
    results = {}
    for name, body, hdrs, bucket in requests:
        before = attention.LAUNCHES
        status, payload, ms = post(port, body, hdrs)
        check_response(name, status, payload)
        launched = attention.LAUNCHES - before
        want = per_batch if select_attention_impl(bucket) == "flash" else 0
        if launched != want:
            fail(f"{name} (bucket {bucket}): kernel launched {launched} "
                 f"times, want {want}")
        results[name] = payload["score"]
        print(f"[main] {name}: bucket {bucket}, score {payload['score']:.6f}"
              f", prediction {payload['prediction']}, latency {ms:.1f} ms "
              f"(max_wait 100 ms), kernel launches {launched}", flush=True)

    # 8 concurrent 6 s requests: one full batch. Whether all 8 reach the
    # batcher inside one max_wait window is up to the host's scheduler, so
    # a round that splits them is reported and the round is sent again
    # (at most 3 rounds); every round's launches are checked all the same.
    waves8 = [synthetic_wave(rng, 6.0) for _ in range(8)]
    for attempt in range(1, 4):
        out8 = [None] * 8
        go = threading.Barrier(8)

        def client(i):
            go.wait()
            out8[i] = post(port, waves8[i].astype("<f4").tobytes())

        n_batches0 = len(batches)
        before = attention.LAUNCHES
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.perf_counter() - t0
        for i, r in enumerate(out8):
            if r is None:
                fail(f"concurrent request {i} got no response")
            check_response(f"6s_concurrent_{i}", r[0], r[1])
        formed = batches[n_batches0:]
        launched = attention.LAUNCHES - before
        if launched != per_batch * len(formed):
            fail(f"8 x 6 s: {len(formed)} batches but {launched} launches")
        print(f"[main] 8 x 6 s concurrent, round {attempt}: batches "
              f"{[len(b) for b in formed]}, wall {wall * 1e3:.1f} ms, "
              f"{8 / wall:.3f} utt/s, latencies "
              f"{[round(r[2], 1) for r in out8]} ms, kernel launches "
              f"{launched}", flush=True)
        if max(len(b) for b in formed) == 8:
            break
    else:
        fail(f"no full batch of 8 formed in 3 rounds: {formed}")

    main_launches = attention.LAUNCHES
    started.stop.set()
    th.join(120)
    if th.is_alive() or errors:
        fail(f"server did not stop cleanly: {errors}")

    # flash (server) vs plain attention on the same waves and buckets
    plain = ScoringService(score_fn=make_score_fn(model, "xla"),
                           reference_embedding=reference,
                           threshold=threshold, buckets=service.buckets,
                           batch=8, device=dev)
    d_plain, _ = plain.score([w6, w12] + waves8)
    d_flash = np.asarray([results["6s_pcm"], results["12s_wav"]]
                         + [r[1]["score"] for r in out8])
    rel = np.abs(d_flash - d_plain) / np.abs(d_plain)
    print(f"[main] flash vs xla distances: max rel diff {rel.max():.3e} "
          f"(bound {SCORE_RTOL}); flash {d_flash[:2]}, xla {d_plain[:2]}",
          flush=True)
    if not rel.max() <= SCORE_RTOL:
        fail(f"flash and xla scores disagree: rel {rel}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main] peak device memory {peak:.2f} GiB; kernel "
          f"launches on the main path {main_launches} (warmup "
          f"{warm_launches} + requests {main_launches - warm_launches})",
          flush=True)
    return main_launches, reference


# ------------------------------------------------------------- phases 6, 7

VOCODERS = ("hifigan", "hn-sinc-nsf-hifi", "hn-sinc-nsf", "melgan",
            "waveglow")
DEVICE = "cuda"
TRAIN_CUT = 96000  # 6 s: impl_select's auto policy picks the flash kernels
TRAIN_STEPS = 3


def write_fixture(root: str, n_bona: int = 6, n_spoof: int = 2,
                  seed: int = 0):
    """An ASVspoof-shaped tree (the recipe of tests/test_cli_training.py)
    of 6-7 s waves: bonafide and spoof utterances, a train protocol, and
    the 5 vocoded copies of every bonafide one."""
    from occm_tpu_torch.io.wav import write_wav

    train_dir = os.path.join(root, "train")
    voc_dir = os.path.join(root, "vocoded")
    os.makedirs(train_dir)
    os.makedirs(voc_dir)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_bona):
        utt = f"LA_T_b{i:04d}"
        wave = synthetic_wave(rng, rng.uniform(6.0, 7.0))
        write_wav(os.path.join(train_dir, utt + ".wav"), wave, SR)
        lines.append(f"LA_{i:04d} {utt} - - bonafide")
        for voc in VOCODERS:
            noisy = wave + 0.01 * rng.standard_normal(wave.shape[0])
            write_wav(os.path.join(voc_dir, f"{voc}_{utt}.wav"), noisy, SR)
    for i in range(n_spoof):
        utt = f"LA_T_s{i:04d}"
        write_wav(os.path.join(train_dir, utt + ".wav"),
                  synthetic_wave(rng, rng.uniform(6.0, 7.0)), SR)
        lines.append(f"LA_{100 + i:04d} {utt} - A01 spoof")
    protocol = os.path.join(root, "train.txt")
    with open(protocol, "w") as f:
        f.write("\n".join(lines) + "\n")
    return protocol, train_dir, voc_dir


def reset_counts():
    from occm_tpu_torch.ops import attention, ffn, fused_adam, layernorm

    attention.LAUNCHES = 0
    attention.BWD_DQ_LAUNCHES = 0
    attention.BWD_DKV_LAUNCHES = 0
    attention.BWD_DOUT_COPIES = 0
    layernorm.LAUNCHES = 0
    fused_adam.LAUNCHES = 0
    ffn.LAUNCHES = 0


def read_counts():
    from occm_tpu_torch.ops import attention, launch_counts

    return {**launch_counts(),
            "flash_attn_bwd_dout_copies": attention.BWD_DOUT_COPIES}


class StepRecorder:
    """on_step hook: each step's loss, wall time (after a synchronize) and
    kernel launches."""

    def __init__(self):
        import torch

        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.last = read_counts()
        self.steps = []

    def __call__(self, step, metrics):
        import torch

        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = read_counts()
        self.steps.append(dict(
            step=step, loss=float(metrics["loss"]),
            closs=float(metrics["closs"]), dloss=float(metrics["dloss"]),
            ms=(now - self.t0) * 1e3,
            launches={k: counts[k] - self.last[k] for k in counts}))
        self.t0, self.last = now, counts


def check_steps(name, rec, want):
    """Every step's loss finite and its launches as `want` says."""
    if not rec.steps:
        fail(f"{name}: no training step ran")
    for st in rec.steps:
        if not all(math.isfinite(st[k]) for k in ("loss", "closs", "dloss")):
            fail(f"{name}: step {st['step']} loss not finite: {st}")
        for k, n in want.items():
            if st["launches"][k] != n:
                fail(f"{name}: step {st['step']} launched {k} "
                     f"{st['launches'][k]} times, want {n}")
        print(f"[train] {name} step {st['step']}: loss {st['loss']:.6f} "
              f"(closs {st['closs']:.6f}, dloss {st['dloss']:.6f}), "
              f"{st['ms']:.1f} ms, launches {st['launches']}", flush=True)


class ListPipeline:
    """The same batches every epoch (the kernel-vs-plain training runs)."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch=0):
        return iter(self.batches)


def phase_train(workdir: str, fixture, profile: bool):
    """Phase 6 (CLI) and phase 7 (train() with every kernel against the
    plain configuration) on the fixture tree (protocol, train_dir,
    voc_dir). Returns the launches of both runs."""
    import dataclasses

    import torch

    from occm_tpu_torch.classify.impl_select import select_attention_impl
    from occm_tpu_torch.cli import oc_training
    from occm_tpu_torch.config import (
        AASISTConfig, RawBoostConfig, TrainConfig, XLSRConfig)
    from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
    from occm_tpu_torch.losses import group_one_class_loss
    from occm_tpu_torch.models import AModel, load_reference_state_dict
    from occm_tpu_torch.ops.fused_adam import MAX_LEAVES as MAX_ADAM_LEAVES
    from occm_tpu_torch.train import train
    from occm_tpu_torch.utils.logging import MetricsLogger

    protocol, train_dir, voc_dir = fixture
    layers = XLSRConfig().encoder_layers
    launches = {}

    # ---- phase 6: the CLI, as a user runs it
    ckpt_dir = os.path.join(workdir, "ckpt")
    cwd = os.getcwd()
    os.chdir(workdir)  # loss.txt and metrics.jsonl land here
    try:
        reset_counts()
        rec = StepRecorder()
        t0 = time.perf_counter()
        oc_training.main([
            "--train_protocol_file", protocol,
            "--train_dataset_dir", train_dir, "--vocoded_dir", voc_dir,
            "--model", "aasist", "--cut", str(TRAIN_CUT), "--num_epochs", "1",
            "--compactness_weight", "0.1", "--descriptiveness_weight", "0.9",
            "--checkpoint_dir", ckpt_dir], on_step=rec)
        wall = time.perf_counter() - t0
        cli_counts = read_counts()
    finally:
        os.chdir(cwd)
    # remat (the default) runs every layer's forward twice: once in the
    # forward, once in the backward's recompute
    check_steps("cli", rec, {
        "flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
        "flash_attn_bwd_dkv": layers, "flash_attn_bwd_dout_copies": 0,
        "layernorm_bwd": 0, "fused_adam": 0, "ffn_fwd": 0})
    path = os.path.join(ckpt_dir, "aasist_vocoded_0.pt")
    model = AModel(AASISTConfig(), XLSRConfig())
    model.load_state_dict(load_reference_state_dict(path), strict=True)
    print(f"[train] cli: {len(rec.steps)} steps of 12 x {TRAIN_CUT} "
          f"samples in {wall:.1f} s (model build, data, checkpoint "
          f"included); {path} ({os.path.getsize(path) / 2**30:.2f} GiB) "
          f"loads strictly into AModel", flush=True)
    del model

    # ---- phase 7: train() with every kernel, then the plain configuration
    dataset = PFDataset(protocol, dataset_dir=train_dir, vocoded_dir=voc_dir,
                        cut=TRAIN_CUT, seed=0)
    batches = []
    for x, labels in MetaBatchPipeline(dataset, seed=0).epoch(0):
        batches.append((x, labels))
        if len(batches) == TRAIN_STEPS:
            break
    acfg = AASISTConfig(dropout=0.0, pool_dropout=0.0, head_dropout=0.0)
    impl = select_attention_impl(TRAIN_CUT)
    if impl != "flash":
        fail(f"auto attention at {TRAIN_CUT} samples is {impl!r}, not flash")
    kcfg = XLSRConfig(ln_impl="pallas", ffn_impl="pallas",
                      attention_impl=impl)
    pcfg = XLSRConfig(ln_impl="xla", attention_impl="xla")
    base = TrainConfig(cut=TRAIN_CUT, compactness_weight=0.1,
                       descriptiveness_weight=0.9, log_every=1,
                       rawboost=RawBoostConfig(algo=0))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init = AModel(acfg, kcfg).state_dict()

    # Adam's first update moves every weight by lr * sign(g) (mhat / sqrt(
    # vhat) = g / |g|), so after step 1 the two runs' weights differ only
    # where the two configurations' gradients at the initial weights differ
    # in sign, by 2 * lr there. To first order that moves the loss by at
    # most 2 * lr * sum over those weights of |g|: measured here from both
    # gradients on the first batch (before the counted runs)
    grads = {}
    for name, xcfg in (("plain", pcfg), ("kernels", kcfg)):
        model = AModel(acfg, xcfg)
        model.load_state_dict(init)
        model.to(DEVICE).train()
        emb, logits = model(torch.from_numpy(batches[0][0]).to(DEVICE),
                            generator=torch.Generator().manual_seed(0))
        loss0, _ = group_one_class_loss(
            emb, logits, torch.from_numpy(batches[0][1]).to(DEVICE), 0.1,
            0.9)
        loss0.backward()
        grads[name] = [p.grad for p in model.parameters()]
        del model, emb, logits, loss0
    flip_l1 = 0.0
    for gp, gk in zip(grads["plain"], grads["kernels"]):
        if gp is not None:
            flip = torch.sign(gp) != torch.sign(gk)
            flip_l1 += float(((gp.abs() + gk.abs()) * flip).sum())
    del grads
    torch.cuda.empty_cache()

    runs = {}
    for name, xcfg, opt in (("kernels", kcfg, "fused_adam"),
                            ("plain", pcfg, "adam")):
        cfg = dataclasses.replace(base, optimizer=opt,
                                  loss_txt=os.path.join(
                                      workdir, f"loss_{name}.txt"))
        logger = MetricsLogger(cfg.loss_txt,
                               os.path.join(workdir, f"metrics_{name}.jsonl"))
        model = AModel(acfg, xcfg)
        model.load_state_dict(init)
        leaves = sum(1 for n, _ in model.named_parameters()
                     if ".bn1." not in n)  # bn1 never runs: no gradient
        # one multi-tensor launch per MAX_LEAVES leaves: 1 for the AModel
        adam_launches = -(-leaves // MAX_ADAM_LEAVES)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rec = StepRecorder()
        if profile and name == "kernels":
            train(model, ListPipeline(batches[:1]), cfg, logger=logger,
                  num_epochs=1, device=DEVICE)  # warm-up before the profile
            phase_profile_train(model, batches[0], cfg)
            model.load_state_dict(init)
            reset_counts()
            rec = StepRecorder()
        train(model, ListPipeline(batches), cfg, logger=logger,
              num_epochs=1, device=DEVICE, on_step=rec)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if name == "kernels":
            want = {"flash_attn_fwd": 2 * layers,
                    "flash_attn_bwd_dq": layers,
                    "flash_attn_bwd_dkv": layers,
                    "flash_attn_bwd_dout_copies": 0,
                    "layernorm_bwd": 2 * layers,
                    "fused_adam": adam_launches,
                    "ffn_fwd": 2 * layers}
            kernel_counts = counts
        else:
            want = dict.fromkeys(counts, 0)
        check_steps(f"train() {name}", rec, want)
        runs[name] = rec.steps
        step_ms = [st["ms"] for st in rec.steps]
        print(f"[train] train() {name} ({opt}, attention "
              f"{xcfg.attention_impl}, ln {xcfg.ln_impl}, ffn "
              f"{xcfg.ffn_impl}): step ms "
              f"{[round(x, 1) for x in step_ms]}, peak device memory "
              f"{peak:.2f} GiB", flush=True)
        del model
        torch.cuda.empty_cache()

    # kernel vs plain losses: step 1 is a forward from identical weights,
    # where bf16 attention and LayerNorm round differently (the serving
    # check's relative 5e-2 through 24 layers); each later step adds the
    # sign-flip term above once more, doubled for the change of the
    # gradient over three steps
    for k, (a, b) in enumerate(zip(runs["kernels"], runs["plain"])):
        bound = LOSS_RTOL * abs(b["loss"]) + 2.0 * k * base.lr * flip_l1
        diff = abs(a["loss"] - b["loss"])
        print(f"[train] step {k + 1}: loss kernels {a['loss']:.6f}, plain "
              f"{b['loss']:.6f}, |diff| {diff:.3e} (bound {bound:.3e}; "
              f"sign-flip L1 {flip_l1:.4g})", flush=True)
        if not diff <= bound:
            fail(f"train(): step {k + 1} losses disagree: {diff} > {bound}")

    launches["flash_attn_fwd"] = (cli_counts["flash_attn_fwd"]
                                  + kernel_counts["flash_attn_fwd"])
    launches["flash_attn_bwd"] = (cli_counts["flash_attn_bwd_dq"]
                                  + kernel_counts["flash_attn_bwd_dq"])
    launches["layernorm_bwd"] = kernel_counts["layernorm_bwd"]
    launches["fused_adam"] = kernel_counts["fused_adam"]
    launches["ffn_fwd"] = kernel_counts["ffn_fwd"]
    return launches


# ------------------------------------------------------------------ phase 8

CONTROL_K = 3   # steps per dispatch (one CUDA graph launch per chunk)
RESUME_EVERY = 2
# device kernels of each wrapper count: ffn_fwd makes two launches a call
KERNEL_NAMES = {"flash_attn_fwd": ("flash_attn_fwd_kernel", 1),
                "flash_attn_bwd_dq": ("flash_attn_bwd_dq_kernel", 1),
                "flash_attn_bwd_dkv": ("flash_attn_bwd_dkv_kernel", 1),
                "layernorm_bwd": ("layernorm_bwd_kernel", 1),
                "fused_adam": ("fused_adam_kernel", 1),
                "ffn_fwd": ("ffn_gemm_kernel", 2)}


def union_us(intervals) -> float:
    """Length of the union of [start, end] intervals (us): the time at
    least one of them covers, so that overlapping events count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def profile_steps(fn, steps: int, label: str, want, tries: int = 3):
    """torch.profiler around fn() (which runs `steps` optimizer steps,
    ending in a synchronize): per step the host window, the device busy
    time (the union of the device events' intervals: the time at least
    one kernel, copy or set ran) and its share of the window, the device
    events' summed durations (larger than busy where they overlap), all
    device launches, and each wrapper's kernels by name, which must equal
    `want` (per step). A session that lost records (see device_ms) is
    repeated, up to `tries` sessions in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        summed_us, spans = 0.0, []
        by_kernel = dict.fromkeys(KERNEL_NAMES, 0)
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            summed_us += e.time_range.elapsed_us()
            for key, (name, _) in KERNEL_NAMES.items():
                if name in e.name:
                    by_kernel[key] += 1
        busy_ms = union_us(spans) / 1e3
        row = dict(window_ms=window_ms / steps, busy_ms=busy_ms / steps,
                   busy_share=busy_ms / window_ms,
                   summed_ms=summed_us / 1e3 / steps,
                   launches=len(spans) / steps,
                   kernels={k: n / steps for k, n in by_kernel.items()})
        print(f"[controls] profile {label}: {row['window_ms']:.3f} ms/step "
              f"host window, device busy {row['busy_ms']:.3f} ms/step "
              f"({row['busy_share']:.3f} of the window; device events' "
              f"summed durations {row['summed_ms']:.3f} ms/step), "
              f"{row['launches']:.1f} device launches/step, port kernels/"
              f"step {row['kernels']}", flush=True)
        if row["kernels"] == want:
            return row
        print(f"[profile] session {attempt} of {tries} for {label}: port "
              f"kernels/step {row['kernels']}, want {want}",
              file=sys.stderr, flush=True)
    fail(f"controls: profile {label} never showed the port's kernels "
         f"{want} a step")


class ChunkRecorder:
    """on_step hook of a graph run: per dispatch its wall ms (after a
    synchronize), its steps' losses and lrs (host reads), and the kernel
    wrappers' launch deltas."""

    def __init__(self):
        import torch

        from occm_tpu_torch.ops import launch_counts

        self.counts = launch_counts
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.last = launch_counts()
        self.dispatches = []

    def __call__(self, step, metrics):
        import torch

        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = self.counts()
        self.dispatches.append(dict(
            step=step, ms=(now - self.t0) * 1e3,
            losses=[float(v) for v in metrics["step_loss"]],
            lrs=[float(v) for v in metrics["step_lr"]],
            launches={k: counts[k] - self.last[k] for k in counts}))
        self.t0, self.last = now, counts


def loss_bound(loss: float, k: int, lr: float, flip_l1: float,
               g_l1: float) -> float:
    """Bound on |loss difference| at step k (1-based) of two runs of the
    same kernels from the same weights on the same batches, both under
    deterministic algorithms: the step-1 forward is the same computation
    (1e-6 relative for the order of its fp32 sums); each update before
    step k may differ where two backward passes give a gradient of
    opposite sign (Adam's first update is lr * sign(g): those weights
    differ by 2 lr, first-order loss effect 2 lr * flip_l1, flip_l1 the L1
    of such gradients, measured from two backward passes; 0 when the
    backward is deterministic) and by the fp32 rounding of the update (at
    most 2^-20 of lr per weight: 2 lr 2^-20 g_l1, with g_l1 the
    gradient's L1)."""
    return 1e-6 * abs(loss) + 2.0 * (k - 1) * lr * (flip_l1
                                                    + 2.0 ** -20 * g_l1)


def mask_memory() -> dict:
    """Bytes of dropout masks that remat holds until the backward (the
    masks are the rematerialised layers' inputs), drawn on the card by the
    port's own `draw_masks` for one meta-batch of 12 at the full width with
    every XLSR rate non-zero and plain attention (its probabilities are
    masked too), at the CLI's default cut and at phase 8's."""
    import dataclasses

    import torch

    from occm_tpu_torch.config import TrainConfig, XLSRConfig
    from occm_tpu_torch.models.xlsr import TransformerLayer

    cfg = dataclasses.replace(XLSRConfig(), attention_impl="xla",
                              dropout=0.1, attention_dropout=0.1,
                              activation_dropout=0.1)
    layer = TransformerLayer(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    out = {}
    for cut in (TrainConfig().cut, TRAIN_CUT):
        t = cut
        for _, kernel, stride in cfg.conv_layers:
            t = (t - kernel) // stride + 1
        x = torch.empty(TRAIN_B, t, cfg.encoder_embed_dim, device=DEVICE)
        masks = layer.draw_masks(x, "xla", gen)
        per_layer = sum(m.numel() * m.element_size() for m in masks)
        attn = masks[0].numel() * masks[0].element_size()
        out[cut] = dict(T=t, layer_mib=per_layer / 2**20,
                        attention_mib=attn / 2**20,
                        total_mib=cfg.encoder_layers * per_layer / 2**20)
        del x, masks
    print(f"[controls] dropout masks held under remat, 12 utterances, every "
          f"XLSR rate on, plain attention: {out} (none at the default rates "
          "of 0)", flush=True)
    return out


def wall_ms(fn, steps: int) -> float:
    """Host wall ms per optimizer step of fn() (which runs `steps` steps),
    between two synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def phase_train_controls(workdir: str, fixture):
    """Phase 8: the training controls at full width (12 x 6 s meta-batches,
    flash attention, ln_impl and ffn_impl "pallas", remat, AASIST dropouts
    zeroed unless said), each against the eager loop from the same weights
    and batches: steps_per_dispatch = 3 as one CUDA graph per chunk with
    fused_adam, with adam under a cosine schedule, and with adam and
    AASIST's default dropouts (bit for bit), all under deterministic
    algorithms, so that the two runs may be held to each other; the
    step's wall time, device-busy share and device launches eager and as
    graphs of 1 and 3 steps (default algorithms); grad_accum = 2; resume
    through the CLI after a SIGTERM, eager and as graphs; the dropout
    masks' memory under remat. Returns the kernel wrappers' launches of
    the phase, the graphs' replayed launches, and the measurements."""
    import dataclasses

    import torch

    from occm_tpu_torch.config import (
        AASISTConfig, RawBoostConfig, TrainConfig, XLSRConfig)
    from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
    from occm_tpu_torch.losses import group_one_class_loss
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.ops import launch_counts
    from occm_tpu_torch.train import create_train_state, train
    from occm_tpu_torch.train.graph import GraphedSteps
    from occm_tpu_torch.train.loop import train_step
    from occm_tpu_torch.utils.logging import MetricsLogger

    protocol, train_dir, voc_dir = fixture
    t_phase = time.perf_counter()
    dataset = PFDataset(protocol, dataset_dir=train_dir, vocoded_dir=voc_dir,
                        cut=TRAIN_CUT, seed=0)
    batches = list(MetaBatchPipeline(dataset, seed=0).epoch(0))
    if len(batches) != 2 * CONTROL_K:
        fail(f"controls: {len(batches)} batches, want {2 * CONTROL_K}")
    acfg = AASISTConfig(dropout=0.0, pool_dropout=0.0, head_dropout=0.0)
    xcfg = XLSRConfig(ln_impl="pallas", ffn_impl="pallas",
                      attention_impl="flash")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init = AModel(acfg, xcfg).state_dict()
    base = TrainConfig(cut=TRAIN_CUT, compactness_weight=0.1,
                       descriptiveness_weight=0.9, log_every=1,
                       rawboost=RawBoostConfig(algo=0))
    layers = XLSRConfig().encoder_layers
    per_step = {"flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
                "flash_attn_bwd_dkv": layers, "layernorm_bwd": 2 * layers,
                "fused_adam": 1, "ffn_fwd": 2 * layers}

    def model_from_init(aasist=acfg):
        model = AModel(aasist, xcfg)
        model.load_state_dict(init)
        return model

    def logger():
        return MetricsLogger(None, None)

    launches = dict.fromkeys(per_step, 0)
    graph_launches = dict.fromkeys(per_step, 0)
    timing = {}

    # ---- graph against eager, under deterministic algorithms
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        # two backward passes at the initial weights on batch 0: where
        # their gradients disagree in sign (flip_l1), and the gradient's L1
        # (the loss bounds' inputs)
        grads = []
        for _ in range(2):
            model = model_from_init().to(DEVICE).train()
            x0 = torch.from_numpy(batches[0][0]).to(DEVICE)
            emb, logits = model(x0, generator=torch.Generator(device=DEVICE))
            loss0, _ = group_one_class_loss(
                emb, logits, torch.from_numpy(batches[0][1]).to(DEVICE), 0.1,
                0.9)
            loss0.backward()
            grads.append([p.grad for p in model.parameters()])
            del model, emb, logits, loss0
        flip_l1 = g_l1 = 0.0
        for ga, gb in zip(*grads):
            if ga is not None:
                flip = torch.sign(ga) != torch.sign(gb)
                flip_l1 += float(((ga.abs() + gb.abs()) * flip).sum())
                g_l1 += float(ga.abs().sum())
        del grads
        torch.cuda.empty_cache()
        print(f"[controls] two backward passes at the initial weights "
              f"(deterministic algorithms): sign-flip L1 {flip_l1:.6g}, "
              f"gradient L1 {g_l1:.6g}", flush=True)

        def graph_vs_eager(name, cfg, aasist=acfg, exact=False):
            """6 eager steps, then the same 6 steps as 2 chunks of 3
            through one CUDA graph, from the same weights and dropout
            generator seed; each step's loss within loss_bound, or equal
            bit for bit when `exact`. Returns the graph run's
            dispatches."""
            eager_cfg = dataclasses.replace(cfg, steps_per_dispatch=1)
            graph_cfg = dataclasses.replace(cfg,
                                            steps_per_dispatch=CONTROL_K)
            each = {**per_step,
                    "fused_adam": int(cfg.optimizer == "fused_adam")}
            reset_counts()
            eager_state = create_train_state(
                model_from_init(aasist).to(DEVICE), eager_cfg)
            rec = StepRecorder()
            for x, labels in batches:
                rec(eager_state.step + 1, train_step(
                    eager_state, torch.from_numpy(x).to(DEVICE),
                    torch.from_numpy(labels).to(DEVICE), eager_cfg))
            eager_weights = {n: t.detach().clone() for n, t
                             in eager_state.model.state_dict().items()
                             } if exact else {}
            del eager_state
            eager_counts = launch_counts()
            check_steps(f"controls {name} eager", rec, {
                **each, "flash_attn_bwd_dout_copies": 0})
            torch.cuda.empty_cache()
            before = launch_counts()
            chunks = ChunkRecorder()
            state = train(model_from_init(aasist), ListPipeline(batches),
                          graph_cfg, logger=logger(), num_epochs=1,
                          device=DEVICE, on_step=chunks)
            after = launch_counts()
            runner = state.graph
            shapes = list(runner.capture_launches) if runner else []
            if len(shapes) != 1:
                fail(f"controls {name}: captured {shapes}, want one chunk "
                     "shape")
            captured = runner.capture_launches[shapes[0]]
            if runner.replays != len(chunks.dispatches) or (
                    runner.replays != 2):
                fail(f"controls {name}: {runner.replays} graph launches "
                     f"for {len(chunks.dispatches)} chunks, want one per "
                     "chunk (2)")
            for key, n in each.items():
                # the capture recorded k steps' launches; the eager
                # warm-up step before it launched one step's
                if captured[key] != CONTROL_K * n:
                    fail(f"controls {name}: the capture recorded "
                         f"{captured[key]} {key} launches, want "
                         f"{CONTROL_K} x {n}")
                if after[key] - before[key] != (CONTROL_K + 1) * n:
                    fail(f"controls {name}: {after[key] - before[key]} "
                         f"{key} wrapper calls in the graph run, want "
                         f"warm-up + capture = {(CONTROL_K + 1) * n}")
                launches[key] += (after[key] - before[key]
                                  + eager_counts[key])
                graph_launches[key] += captured[key] * runner.replays
            got = [v for d in chunks.dispatches for v in d["losses"]]
            want = [st["loss"] for st in rec.steps]
            if len(got) != len(want):
                fail(f"controls {name}: {len(got)} graph steps, {len(want)} "
                     "eager")
            worst = 0.0
            for i, (a, b) in enumerate(zip(got, want)):
                bound = 0.0 if exact else loss_bound(b, i + 1, cfg.lr,
                                                     flip_l1, g_l1)
                diff = abs(a - b)
                worst = max(worst, diff)
                print(f"[controls] {name} step {i + 1}: loss graph "
                      f"{a:.9f}, eager {b:.9f}, |diff| {diff:.3e} (bound "
                      f"{bound:.3e})", flush=True)
                if not (math.isfinite(a) and diff <= bound):
                    fail(f"controls {name}: step {i + 1} graph loss {a} vs "
                         f"eager {b}: |diff| {diff} > {bound}")
            differ = [n for n, t in state.model.state_dict().items()
                      if n in eager_weights
                      and not torch.equal(t, eager_weights[n])]
            if differ:
                fail(f"controls {name}: the graph run's final weights differ "
                     f"from the eager run's in {len(differ)} tensors, e.g. "
                     f"{differ[:3]}")
            del eager_weights
            timing[name] = dict(
                capture_s=runner.capture_seconds[shapes[0]],
                max_loss_diff=worst, bit_identical=got == want)
            print(f"[controls] {name}: largest |loss diff| {worst:.3e} "
                  f"(bit-identical: {got == want}); graph launches "
                  f"{runner.replays}, launches per replay {captured}, "
                  f"capture {runner.capture_seconds[shapes[0]]:.2f} s",
                  flush=True)
            del state, runner
            gc.collect()  # a state and its graph runner refer to each other
            torch.cuda.empty_cache()
            return chunks

        graph_vs_eager("fused_adam k=3", dataclasses.replace(
            base, optimizer="fused_adam"))
        # adam under a cosine schedule: each step's lr read back
        cos_cfg = dataclasses.replace(base, optimizer="adam",
                                      lr_schedule="cosine", warmup_steps=1,
                                      decay_steps=5)
        achunks = graph_vs_eager("adam cosine k=3", cos_cfg)
        # the CLI's model: AASIST's default dropouts, drawn in every step
        # from the state's CUDA generator. A graph that replayed its
        # capture's masks, or whose generator missed the replays' draws,
        # would part from the eager run at the second chunk
        graph_vs_eager("adam dropout k=3", dataclasses.replace(
            base, optimizer="adam"), aasist=AASISTConfig(), exact=True)
        from occm_tpu_torch.train.schedules import make_schedule

        sched = make_schedule(cos_cfg)
        lrs = [v for d in achunks.dispatches for v in d["lrs"]]
        want_lrs = [sched(i) for i in range(2 * CONTROL_K)]
        print(f"[controls] adam cosine: lr per step read from the device "
              f"{lrs}, schedule {want_lrs}", flush=True)
        if lrs != want_lrs:
            fail(f"controls: the graph's lrs {lrs} are not the schedule's "
                 f"{want_lrs}")
    finally:
        torch.use_deterministic_algorithms(False)

    # ---- the step eager, as a graph of 1 step and of 3 (fused_adam,
    # default algorithms): wall ms (no profiler), then device busy share
    # and device launches (torch.profiler)
    cfg_f = dataclasses.replace(base, optimizer="fused_adam")
    xs = np.stack([b[0] for b in batches[:CONTROL_K]])
    ls = np.stack([b[1] for b in batches[:CONTROL_K]])
    x1 = torch.from_numpy(xs[0]).to(DEVICE)
    l1 = torch.from_numpy(ls[0]).to(DEVICE)
    state = create_train_state(model_from_init().to(DEVICE), cfg_f)
    torch.cuda.reset_peak_memory_stats()

    def eager():
        for _ in range(CONTROL_K):
            train_step(state, x1, l1, cfg_f)

    eager()  # warm
    eager_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    one = GraphedSteps(state, cfg_f, 1)
    one.run(xs[:1], ls[:1])  # capture
    one_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    three = GraphedSteps(state, cfg_f, CONTROL_K)
    three.run(xs, ls)  # capture
    three_peak = torch.cuda.max_memory_allocated() / 2**30

    def graph1():
        for _ in range(CONTROL_K):
            one.run(xs[:1], ls[:1])

    runs = {"eager": eager, "graph k=1": graph1,
            "graph k=3": lambda: three.run(xs, ls)}
    walls = {label: [] for label in runs}
    for _ in range(3):  # in turns
        for label, fn in runs.items():
            walls[label].append(wall_ms(fn, CONTROL_K))
    want = {key: per_step[key] * per_call
            for key, (_, per_call) in KERNEL_NAMES.items()}
    rows = {label: profile_steps(fn, CONTROL_K, label, want)
            for label, fn in runs.items()}
    for label, row in rows.items():
        row["wall_ms"] = walls[label]
    timing["profile"] = rows
    timing["capture_s"] = {"graph k=1": list(one.capture_seconds.values()),
                           "graph k=3": list(three.capture_seconds.values())}
    timing["peak_gib"] = {"eager": eager_peak, "graph k=1 capture": one_peak,
                          "graph k=3 capture": three_peak}
    print(f"[controls] step wall ms (3 rounds, in turns) {walls}; peak "
          f"memory {timing['peak_gib']} GiB; capture s "
          f"{timing['capture_s']}", flush=True)
    del state, one, three
    gc.collect()
    torch.cuda.empty_cache()

    # ---- grad_accum = 2
    timing["grad_accum"] = phase_grad_accum(batches, base, model_from_init,
                                            per_step, launches)

    # ---- resume through the CLI after a SIGTERM
    timing["resume"] = phase_resume(workdir, fixture, launches)
    timing["mask_mib"] = mask_memory()
    timing["seconds"] = time.perf_counter() - t_phase
    print(f"[controls] phase 8 took {timing['seconds']:.1f} s", flush=True)
    return launches, graph_launches, timing


def phase_grad_accum(batches, base, model_from_init, per_step, launches):
    """grad_accum = 2 at groups_per_step = 2 (two micro-batches of 12), one
    fused_adam step from the initial weights:
    - on two different meta-batches, against its definition: each
      meta-batch's gradient from its own grad_accum = 1 pass, averaged
      (BatchNorm normalises each micro-batch with its own statistics, in
      the JAX package too, so this, not the 24-utterance pass, is the
      update accumulation must equal); the same kernels on the same
      shapes, so the gradients agree to the spread of two backward passes
      of one batch (measured here) plus one fp32 rounding of the sum;
    - on one meta-batch twice, against grad_accum = 1 on those 24
      utterances, where the batch statistics coincide and accumulation
      equals the big batch: the two differ in the shapes of their cuBLAS
      and cuDNN calls, and so in the order of fp32 sums and where bf16
      rounds, which 24 layers carry into the loss as phase 7's LOSS_RTOL
      bound says, and back through the same 24 layers into the gradient:
      the gradient the update reads is held to LOSS_RTOL of its norm (a
      missing micro-batch or a wrong share moves it by half its norm or
      more). Adam's first update is lr * g / (|g| + eps) whatever the
      gradient's scale, so each updated weight is held to the other run's
      within lr times the difference of that direction (computed from the
      two gradients) plus the roundings of the update (2^-19 lr) and of
      the weight (2^-22 |w|): the update read the gradient held above.
    Each kernel runs twice its per-micro-batch count."""
    import dataclasses

    import torch

    from occm_tpu_torch.losses import group_one_class_loss
    from occm_tpu_torch.ops import launch_counts
    from occm_tpu_torch.train import create_train_state
    from occm_tpu_torch.train.loop import train_step

    def step(x, labels, accum):
        cfg = dataclasses.replace(base, optimizer="fused_adam",
                                  groups_per_step=x.shape[0] // 12,
                                  grad_accum=accum)
        state = create_train_state(model_from_init().to(DEVICE), cfg)
        grads = {}
        apply = state.apply_gradients

        def keep_grads(lr=None):  # the gradient the update reads
            grads.update({n: p.grad.clone() for n, p
                          in state.model.named_parameters()
                          if p.grad is not None})
            apply(lr)

        state.apply_gradients = keep_grads
        before = launch_counts()
        m = train_step(state, torch.from_numpy(x).to(DEVICE),
                       torch.from_numpy(labels).to(DEVICE), cfg)
        torch.cuda.synchronize()
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        weights = {n: p.detach().clone()
                   for n, p in state.model.named_parameters()}
        return float(m["loss"]), grads, weights, counts

    def single_grads(x, labels):
        model = model_from_init().to(DEVICE).train()
        emb, logits = model(torch.from_numpy(x).to(DEVICE),
                            generator=torch.Generator(device=DEVICE))
        loss, _ = group_one_class_loss(
            emb, logits, torch.from_numpy(labels).to(DEVICE), 0.1, 0.9)
        loss.backward()
        return float(loss.detach()), {
            n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}

    (xa, la), (xb, lb) = batches[0], batches[1]
    result = {}
    # distinct meta-batches against the definition
    x2, l2 = np.concatenate([xa, xb]), np.concatenate([la, lb])
    loss, grads, _, counts = step(x2, l2, 2)
    for key, n in per_step.items():
        want = n if key == "fused_adam" else 2 * n
        if counts[key] != want:
            fail(f"grad_accum: {counts[key]} {key} launches in a step of "
                 f"two micro-batches, want {want}")
        launches[key] += counts[key]
    loss_a, ga = single_grads(xa, la)
    loss_b, gb = single_grads(xb, lb)
    _, ga2 = single_grads(xa, la)
    spread = max(float((ga[n] - ga2[n]).abs().max()) for n in ga)
    spread_rel = math.sqrt(
        sum(float(((ga[n] - ga2[n]) ** 2).sum()) for n in ga)
        / sum(float((ga[n] ** 2).sum()) for n in ga))
    worst = worst_excess = 0.0
    for n, g in grads.items():
        ref = 0.5 * ga[n] + 0.5 * gb[n]
        diff = (g - ref).abs()
        bound = spread + 2.0 ** -23 * (0.5 * ga[n].abs() + 0.5 * gb[n].abs())
        worst = max(worst, float(diff.max()))
        worst_excess = max(worst_excess, float((diff - bound).max()))
    want_loss = 0.5 * loss_a + 0.5 * loss_b
    loss_diff = abs(loss - want_loss)
    print(f"[controls] grad_accum 2 on two meta-batches: loss {loss:.9f} vs "
          f"the two passes' mean {want_loss:.9f} (|diff| {loss_diff:.3e}); "
          f"gradient max |diff| {worst:.3e} (spread of two passes "
          f"{spread:.3e}); launches {counts}", flush=True)
    if worst_excess > 0 or loss_diff > 1e-6 * abs(want_loss) + 1e-7:
        fail(f"grad_accum: accumulated gradient or loss off its definition "
             f"(gradient excess over bound {worst_excess}, loss |diff| "
             f"{loss_diff})")
    result.update(loss_diff_distinct=loss_diff, grad_diff_distinct=worst,
                  grad_spread=spread, grad_spread_rel=spread_rel)
    del grads, ga, gb, ga2
    # one meta-batch twice against the 24-utterance pass
    x2, l2 = np.concatenate([xa, xa]), np.concatenate([la, la])
    loss_acc, g_acc, w_acc, _ = step(x2, l2, 2)
    loss_big, g_big, w_big, _ = step(x2, l2, 1)
    bound = LOSS_RTOL * abs(loss_big)
    loss_diff = abs(loss_acc - loss_big)
    if sorted(g_acc) != sorted(g_big):
        fail("grad_accum vs big batch: different parameters got gradients")
    sq_diff = sum(float(((g_acc[n] - g_big[n]) ** 2).sum()) for n in g_big)
    sq_big = sum(float((g ** 2).sum()) for g in g_big.values())
    g_rel = math.sqrt(sq_diff / sq_big)
    eps, lr = 1e-8, base.lr
    w_diff = w_excess = 0.0
    for n, w in w_big.items():
        diff = (w_acc[n] - w).abs()
        if n in g_big:
            s_acc = g_acc[n] / (g_acc[n].abs() + eps)
            s_big = g_big[n] / (g_big[n].abs() + eps)
            w_bound = (lr * (s_acc - s_big).abs() + 2.0 ** -19 * lr
                       + 2.0 ** -22 * w.abs())
        else:  # no gradient in either run: the weight did not move
            w_bound = torch.zeros_like(w)
        w_diff = max(w_diff, float(diff.max()))
        w_excess = max(w_excess, float((diff - w_bound).max()))
    moved = sum(int(((w_acc[n] - w_big[n]).abs() > 1e-9).sum())
                for n in w_acc)
    total = sum(w.numel() for w in w_acc.values())
    print(f"[controls] grad_accum 2 vs 1 on one meta-batch twice: loss "
          f"{loss_acc:.9f} vs {loss_big:.9f} (|diff| {loss_diff:.3e}, bound "
          f"{bound:.3e}); gradient |diff| / |g| {g_rel:.3e} (bound "
          f"{LOSS_RTOL}; two passes of one batch {spread_rel:.3e}); updated "
          f"weights max |diff| {w_diff:.3e}, largest excess over the "
          f"update's bound {w_excess:.3e}; {moved} of {total} differ",
          flush=True)
    if not (loss_diff <= bound and g_rel <= LOSS_RTOL and w_excess <= 0.0):
        fail(f"grad_accum vs big batch: loss |diff| {loss_diff} > {bound}, "
             f"gradient |diff| / |g| {g_rel} > {LOSS_RTOL} or weights over "
             f"their bound by {w_excess}")
    result.update(loss_diff_big=loss_diff, grad_rel_diff_big=g_rel,
                  weight_diff_big=w_diff, weight_excess_big=w_excess,
                  weights_differing=moved, weights=total)
    del g_acc, g_big, w_acc, w_big
    torch.cuda.empty_cache()
    return result


def phase_resume(workdir: str, fixture, launches):
    """Resume through `oc_training.main` (the CLI's defaults: AASIST
    dropouts on, drawn from the CUDA generator, torch Adam) with
    --checkpoint_every_steps 2, under torch.use_deterministic_algorithms,
    against one uninterrupted run of 6 eager steps:
    - eager steps: a run sent SIGTERM from its on_step hook after step 2
      saves and returns; --resume finishes the epoch; steps 3-6 and the
      final weights equal the uninterrupted run's bit for bit; the step-2
      checkpoint is replaced at step 4 and deleted;
    - --steps_per_dispatch 3 (two chunks, each one CUDA graph launch): the
      SIGTERM after the first chunk saves at step 3 (the generator's state
      after a replay), --resume replays the second chunk, and all 6 steps
      and the final weights again equal the eager run's bit for bit."""
    import signal

    import torch

    from occm_tpu_torch.cli import oc_training
    from occm_tpu_torch.ops import launch_counts

    protocol, train_dir, voc_dir = fixture

    def args(ckpt_dir, *extra):
        return ["--train_protocol_file", protocol,
                "--train_dataset_dir", train_dir, "--vocoded_dir", voc_dir,
                "--model", "aasist", "--cut", str(TRAIN_CUT),
                "--num_epochs", "1", "--compactness_weight", "0.1",
                "--descriptiveness_weight", "0.9", "--checkpoint_dir",
                ckpt_dir, *extra]

    def losses_of(metrics):
        if "step_loss" in metrics:  # a chunk: each of its steps
            return [float(v) for v in metrics["step_loss"]]
        return [float(metrics["loss"])]

    def interrupted(name, stop, *extra):
        """A run sent SIGTERM after step `stop`, then --resume: the step
        it stopped at, the files it left, the resumed dispatches (step,
        losses, files seen), the files at the end, the losses before the
        stop and the final weights."""
        run_dir = os.path.join(workdir, name)
        every = ["--checkpoint_every_steps", str(RESUME_EVERY), *extra]
        first = []

        def preempt(step, metrics):
            first.extend(losses_of(metrics))
            if step == stop:
                os.kill(os.getpid(), signal.SIGTERM)

        state = oc_training.main(args(run_dir, *every), on_step=preempt)
        stopped = state.step
        del state
        gc.collect()  # a state and its graph runner refer to each other
        files_after_stop = sorted(os.listdir(run_dir))
        torch.cuda.empty_cache()
        seen = []

        def listing(step, metrics):
            seen.append((step, losses_of(metrics),
                         sorted(os.listdir(run_dir))))

        resumed = oc_training.main(args(run_dir, *every, "--resume"),
                                   on_step=listing)
        final_files = sorted(os.listdir(run_dir))
        weights = {k: v.detach().cpu() for k, v
                   in resumed.model.state_dict().items()}
        del resumed
        gc.collect()
        shutil.rmtree(run_dir)
        torch.cuda.empty_cache()
        print(f"[controls] resume {name}: stopped at step {stopped} with "
              f"{files_after_stop}; resumed steps {[s for s, _, _ in seen]}, "
              f"files seen at each {[f for _, _, f in seen]}, at the end "
              f"{final_files}; losses first {first}, resumed "
              f"{[v for _, l, _ in seen for v in l]}", flush=True)
        return stopped, files_after_stop, seen, final_files, first, weights

    def check(name, ref_losses, ref_weights, got):
        stopped, files_after_stop, seen, final_files, first, weights = got
        resumed_losses = [v for _, l, _ in seen for v in l]
        if first + resumed_losses != ref_losses:
            fail(f"resume {name}: losses {first} + {resumed_losses} differ "
                 f"from the uninterrupted run's {ref_losses}")
        differ = [k for k in weights if not torch.equal(weights[k],
                                                        ref_weights[k])]
        if differ:
            fail(f"resume {name}: final weights differ from the "
                 f"uninterrupted run's in {len(differ)} tensors, e.g. "
                 f"{differ[:3]}")
        print(f"[controls] resume {name}: the losses and the final weights "
              f"equal the uninterrupted run's bit for bit ({len(weights)} "
              f"tensors)", flush=True)

    torch.use_deterministic_algorithms(True, warn_only=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    before = launch_counts()
    try:
        ref_losses = []
        ref_dir = os.path.join(workdir, "resume_ref")
        ref = oc_training.main(args(ref_dir), on_step=lambda s, m:
                               ref_losses.extend(losses_of(m)))
        ref_weights = {k: v.detach().cpu() for k, v
                       in ref.model.state_dict().items()}
        del ref
        shutil.rmtree(ref_dir)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eager = interrupted("eager", RESUME_EVERY)
        resume_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph = interrupted("graph", CONTROL_K, "--steps_per_dispatch",
                            str(CONTROL_K))
        graph_resume_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        torch.use_deterministic_algorithms(False)
    after = launch_counts()
    for key in launches:
        launches[key] += after[key] - before[key]
    print(f"[controls] resume: uninterrupted losses {ref_losses}", flush=True)

    stopped, files_after_stop, seen, final_files, _, _ = eager
    if stopped != 2 or files_after_stop != ["aasist_vocoded_step_2.pt"]:
        fail(f"resume eager: the SIGTERM run stopped at {stopped} with "
             f"{files_after_stop}, want step 2 and its step checkpoint")
    if [s for s, _, _ in seen] != [3, 4, 5, 6]:
        fail(f"resume eager: resumed steps {[s for s, _, _ in seen]}, want "
             "3-6")
    if (seen[1][2] != ["aasist_vocoded_step_2.pt"]
            or seen[2][2] != ["aasist_vocoded_step_4.pt"]
            or final_files != ["aasist_vocoded_0.pt",
                               "aasist_vocoded_step_6.pt"]):
        fail("resume eager: the step-2 checkpoint was not replaced at step 4 "
             "and deleted")
    check("eager", ref_losses, ref_weights, eager)

    stopped, files_after_stop, seen, final_files, _, _ = graph
    if stopped != CONTROL_K or files_after_stop != [
            f"aasist_vocoded_step_{CONTROL_K}.pt"]:
        fail(f"resume graph: the SIGTERM run stopped at {stopped} with "
             f"{files_after_stop}, want step {CONTROL_K} and its step "
             "checkpoint")
    if ([s for s, _, _ in seen] != [2 * CONTROL_K]
            or seen[0][2] != [f"aasist_vocoded_step_{CONTROL_K}.pt"]
            or final_files != ["aasist_vocoded_0.pt",
                               f"aasist_vocoded_step_{2 * CONTROL_K}.pt"]):
        fail(f"resume graph: resumed dispatches {[s for s, _, _ in seen]} "
             f"and files {final_files}, want the second chunk and its step "
             "checkpoint in place of the first's")
    check("graph", ref_losses, ref_weights, graph)
    print(f"[controls] resume: interrupted + resumed wall, eager "
          f"{resume_s:.1f} s, graph {graph_resume_s:.1f} s", flush=True)
    return dict(stopped=eager[0], resume_s=resume_s,
                graph_stopped=graph[0], graph_resume_s=graph_resume_s)


# ------------------------------------------------------- optional profile

def _kernel_class(name: str) -> str:
    n = name.lower()
    for k in ("flash_attn_fwd", "flash_attn_bwd", "layernorm_bwd",
              "fused_adam"):
        if k in n:
            return f"{k} (this port)"
    if "ffn_gemm_kernel" in n:  # the FFN's two launches
        return "ffn_fwd (this port)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(s in n for s in ("conv", "cudnn", "implicit", "dgrad", "wgrad")):
        return "conv (cuDNN)"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90")):
        return "matmul (cuBLAS)"
    if "layer_norm" in n:
        return "layer_norm"
    if "copy_kernel" in n:
        return "dtype casts and layout copies"
    return "other elementwise and reductions"


def report_profile(prof, window_us: float, n: int, label: str):
    """Device time by kernel class and the top kernels, per run of `n`,
    from torch.profiler's CUDA events, with the busy share of the host's
    window."""
    import torch

    by_name, by_class, events = {}, {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        events += 1
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        cls = _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + us
    busy = sum(by_name.values())
    if busy <= 0:
        fail("profile: torch.profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"[profile] {label}, {n} runs: host window "
          f"{window_us / n / 1e3:.3f} ms/run, device busy "
          f"{busy / n / 1e3:.3f} ms/run ({busy / window_us:.3f} of the "
          f"window), {events / n:.1f} device launches/run", flush=True)
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {cls}: {us / n / 1e3:.3f} ms/run "
              f"({us / busy:.3f} of device time)", flush=True)
    for name, us in top:
        print(f"[profile]     {us / n / 1e3:9.3f} ms  {name[:110]}",
              flush=True)


def phase_profile(model, reference: np.ndarray, ckpt: str,
                  batches: int = 3):
    """Device time by kernel for full batches of 8 in the two flash
    buckets, through ScoringService as the server runs them, and for a
    6 s batch with ffn_impl="pallas" (the scoring phase's kernel path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from occm_tpu_torch.cli.oc_server import build_model
    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.serve import ScoringService, make_score_fn

    pallas = build_model(XLSRConfig(ffn_impl="pallas"), ckpt, False, "cuda")
    rng = np.random.default_rng(1)
    for seconds, bucket, m, label in (
            (6.0, 96000, model, ""), (12.0, 192000, model, ""),
            (6.0, 96000, pallas, ', ffn_impl="pallas"')):
        svc = ScoringService(score_fn=make_score_fn(m, "flash"),
                             reference_embedding=reference, threshold=0.0,
                             buckets=(bucket,), batch=8, device="cuda")
        waves = [synthetic_wave(rng, seconds) for _ in range(8)]
        svc.score(waves)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(batches):
                svc.score(waves)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        report_profile(prof, window_us, batches,
                       f"scoring bucket {bucket} ({seconds:.0f} s), batch 8"
                       + label)
    del pallas
    torch.cuda.empty_cache()


def kernel_line(fwd_rows, bwd_rows, ln, adam, ffn_rows, hgmma, launches):
    """The {"kernels": [...]} entries. Times, errors and bounds are this
    run's, at the shape named in each entry: `ms` the wrapper's time per
    call (CUDA events), `device_ms` the kernel's own device time per call
    (torch.profiler); `launches` come from the main path (scoring, serving
    and training), 0 with --kernels-only."""
    head = next(r for r in fwd_rows if r["T"] == MAIN_PATH_TS[0])
    bhead = next(r for r in bwd_rows if r["T"] == MAIN_PATH_TS[0])
    fhead = next(r for r in ffn_rows if r["M"] == FFN_MAIN_M
                 and r["D"] == 1024 and r["gelu"] == "erf")

    return [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "occm_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "occm_tpu/ops/attention.py:45 (_fwd_kernel), "
                     "occm_tpu/ops/attention.py:234 (_blocked_fwd_kernel)",
         "launches": launches["flash_attn_fwd"],
         "shape": f"[B={B}, T={head['T']}, H={H}, D={D}] bf16 views",
         "max_abs_err": max(r["max_abs_err"] for r in fwd_rows),
         **{k: head[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms",
                                 "library_device_ms")},
         "sass_hgmma": {k: n for k, n in hgmma.items()
                        if "flash_attn_fwd" in k}, "per_T": fwd_rows},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "occm_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "occm_tpu/ops/attention.py:79 (_bwd_kernel), "
                     "occm_tpu/ops/attention.py:350 (_blocked_dq_kernel), "
                     "occm_tpu/ops/attention.py:373 (_blocked_dkv_kernel)",
         "launches": launches["flash_attn_bwd"],
         "shape": f"[B={TRAIN_B}, T={bhead['T']}, H={H}, D={D}] bf16 views",
         "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
         **{k: bhead[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms",
                                  "library_device_ms")},
         "sass_hgmma": {k: n for k, n in hgmma.items()
                        if "flash_attn_bwd" in k}, "per_T": bwd_rows},
        {"name": "layernorm_bwd", "route": "cuda",
         "source": "occm_tpu_torch/csrc/layernorm_bwd.cu",
         "replaces": "occm_tpu/ops/layernorm.py:46 (_bwd_kernel)",
         "launches": launches["layernorm_bwd"],
         "shape": f"[{ln['shape'][0]}, {ln['shape'][1]}] bf16",
         **{k: ln[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms",
                               "library_device_ms", "per_shape")}},
        {"name": "fused_adam", "route": "cuda",
         "source": "occm_tpu_torch/csrc/fused_adam.cu",
         "replaces": "occm_tpu/ops/fused_adam.py:58 (_kernel)",
         "launches": launches["fused_adam"],
         "shape": f"{adam['leaves']} fp32 leaves, {adam['params']} params",
         **{k: adam[k] for k in ("max_abs_err", "ms", "device_ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "library_device_ms")}},
        {"name": "ffn_fwd", "route": "cuda",
         "source": "occm_tpu_torch/csrc/ffn_fwd.cu",
         "replaces": "occm_tpu/ops/ffn.py:50 (_kernel)",
         "launches": launches["ffn_fwd"],
         "shape": f"x [{FFN_MAIN_M}, 1024] x W1 [1024, 4096] bf16, erf GELU",
         "max_abs_err": max(r["max_abs_err"] for r in ffn_rows),
         **{k: fhead[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms",
                                  "library_device_ms")},
         "library": "F.linear, F.gelu, F.linear (ffn_impl=\"xla\")",
         "sass_hgmma": {k: n for k, n in hgmma.items()
                        if "ffn_gemm_kernel" in k}, "per_M": ffn_rows},
    ]


def phase_profile_train(model, batch, cfg):
    """Device time by kernel class for one full training step (12 x 6 s,
    every kernel), through train_step as train() runs it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from occm_tpu_torch.train.state import create_train_state
    from occm_tpu_torch.train.loop import train_step

    state = create_train_state(model, cfg)
    x = torch.from_numpy(batch[0]).to(DEVICE)
    labels = torch.from_numpy(batch[1]).long().to(DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, x, labels, cfg)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, window_us, 1, "training step 12 x 6 s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, print device time by kernel "
                         "for full batches of the two flash buckets and "
                         "for one full training step")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1-3 only (device, build, kernel "
                         "checks); launches are then 0")
    ap.add_argument("--controls-only", action="store_true",
                    help="run phases 1, 2 and 8 only (device, build, the "
                         "training controls); prints no kernels line")
    args = ap.parse_args(argv)

    smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    hgmma = phase_build()
    if args.controls_only:
        from occm_tpu_torch.ops import _build

        workdir = tempfile.mkdtemp(prefix="smoke_", dir=_build.BUILD_DIR)
        try:
            fixture_dir = os.path.join(workdir, "fixture")
            os.makedirs(fixture_dir)
            controls = phase_train_controls(
                workdir, write_fixture(fixture_dir))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(smi)
        print(json.dumps({"controls": controls}, default=str))
        return 0
    fwd_rows = phase_kernels()
    bwd_rows = phase_attention_bwd()
    ln = phase_layernorm_bwd()
    adam = phase_fused_adam()
    ffn_rows = phase_ffn()
    launches = dict.fromkeys(
        ("flash_attn_fwd", "flash_attn_bwd", "layernorm_bwd", "fused_adam",
         "ffn_fwd"), 0)
    graph_launches = dict.fromkeys(launches, 0)
    if not args.kernels_only:
        from occm_tpu_torch.ops import _build

        workdir = tempfile.mkdtemp(prefix="smoke_", dir=_build.BUILD_DIR)
        try:
            fixture_dir = os.path.join(workdir, "fixture")
            os.makedirs(fixture_dir)
            fixture = write_fixture(fixture_dir)
            phase_tiny_auto()
            model, ckpt = build_seed_model(workdir)
            artifacts, score_launches, _ = phase_scoring(
                workdir, model, ckpt, fixture)
            serve_launches, reference = phase_main_path(model, ckpt,
                                                        artifacts)
            if args.profile:
                phase_profile(model, reference, ckpt)
            del model
            train_launches = phase_train(workdir, fixture, args.profile)
            control_counts, replayed, controls = phase_train_controls(
                workdir, fixture)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        launches["flash_attn_fwd"] += serve_launches
        for counts in (score_launches, train_launches):
            for name, n in counts.items():
                launches[name] += n
        # the wrappers' counts of phase 8 (eager steps, warm-ups and
        # captures); a graph's replays launch what its capture recorded
        for name in ("flash_attn_fwd", "layernorm_bwd", "fused_adam",
                     "ffn_fwd"):
            launches[name] += control_counts[name]
            graph_launches[name] = replayed[name]
        launches["flash_attn_bwd"] += control_counts["flash_attn_bwd_dq"]
        graph_launches["flash_attn_bwd"] = replayed["flash_attn_bwd_dq"]
        print(f"[controls] {json.dumps(controls, default=str)}", flush=True)

    print(smi)
    kernels = kernel_line(fwd_rows, bwd_rows, ln, adam, ffn_rows, hgmma,
                          launches)
    for entry in kernels:
        entry["graph_replay_launches"] = graph_launches[entry["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
