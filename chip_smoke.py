#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/H100 port (`occm_tpu_torch`).

    python3 chip_smoke.py                # every phase, one CUDA card
    python3 chip_smoke.py --profile      # every phase + device time by kernel

Phases (any failure ends the run with a non-zero exit and no last line):

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit and turns TF32 off for the comparisons.
2. build: compiles occm_tpu_torch/csrc/*.cu with nvcc (sm_90a).
3. kernels: the flash-attention forward kernel against its plain PyTorch
   version on the card, at B=8, H=16, D=64, bf16, T in {201, 299, 599,
   1500}; prints the error and the kernel, plain and library (SDPA) times.
4. main path: the full-width XLSR-300M + AASIST scorer (random weights
   from a seed) served over HTTP by `occm_tpu_torch.cli.oc_server`: a 4 s
   WAV, a 6 s raw-PCM and a 12 s WAV request plus 8 concurrent 6 s
   requests. Checks every response, that the kernel launched 24 times
   (one per layer) for every batch of a flash bucket, and that the flash
   scores agree with the plain-attention scores.
5. with --profile only: device time by kernel (torch.profiler) for full
   batches of 8 in the two flash buckets.
6. prints {"kernels": [...]}, then {"ok": true, "device": {...}} last.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
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


# ----------------------------------------------------------------- phase 3

def phase_kernels():
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.ops.attention import (
        flash_attention_fwd, flash_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for t in KERNEL_TS:
        q, k, v = (torch.randn((B * H, t, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        out, lse = flash_attention_fwd(q, k, v, t)
        torch.cuda.synchronize()
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
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, t))
        qf, kf, vf = q.float(), k.float(), v.float()
        plain_ms = cuda_ms(lambda: flash_attention_reference(qf, kf, vf, t),
                           iters=5)
        q4, k4, v4 = (x.view(B, H, t, D) for x in (q, k, v))
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4))
        bound_ms, bound_by, flops, nbytes = attention_bound(B * H, t, D)
        row = dict(T=t, max_abs_err=err, lse_max_abs_err=lse_err, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes)
        rows.append(row)
        print(f"[kernel] flash_attn_fwd B={B} H={H} T={t} D={D}: "
              f"max_err {err:.3e} (bound {OUT_ATOL}), lse_err "
              f"{lse_err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops:.4g} flop, {nbytes:.4g} B)", flush=True)
    return rows


# ----------------------------------------------------------------- phase 4

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


def phase_main_path(workdir: str):
    import torch

    from occm_tpu_torch.audio import pad_numpy
    from occm_tpu_torch.cli import oc_server
    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.losses import pairwise_distance
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.ops import attention
    from occm_tpu_torch.serve import ScoringService, make_score_fn
    from occm_tpu_torch.utils import random_init_

    dev = torch.device("cuda")
    xcfg = XLSRConfig()
    per_batch = xcfg.encoder_layers  # one kernel launch per layer
    t0 = time.perf_counter()
    model = random_init_(AModel(AASISTConfig(), xcfg), seed=0).to(dev).eval()
    ckpt = os.path.join(workdir, "amodel_seed0.pt")
    torch.save(model.state_dict(), ckpt)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] AModel(AASISTConfig(), XLSRConfig()): {n_params} params, "
          f"{xcfg.encoder_layers} layers d={xcfg.encoder_embed_dim} "
          f"heads={xcfg.encoder_heads} dtype={xcfg.dtype}; init + save "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # reference embedding and threshold from the model's own embeddings of
    # seeded synthetic waves: mean embedding, median distance
    rng = np.random.default_rng(0)
    enroll = np.stack([pad_numpy(synthetic_wave(rng, 4.0), 64600)
                       for _ in range(8)])
    with torch.inference_mode():
        emb, _ = model(torch.from_numpy(enroll).to(dev),
                       attention_impl="xla")
    emb = emb.float()
    if not (emb.shape == (8, 160) and torch.isfinite(emb).all()):
        fail(f"bad enrolment embeddings: shape {tuple(emb.shape)}")
    reference = emb.mean(dim=0)
    threshold = float(pairwise_distance(emb, reference).median())
    np.save(os.path.join(workdir, "reference_embedding.npy"),
            reference.cpu().numpy())
    np.save(os.path.join(workdir, "threshold.npy"),
            np.asarray(threshold, np.float32))
    print(f"[main] reference embedding from 8 enrolment waves, threshold "
          f"(median distance) {threshold:.6f}", flush=True)

    # --- the server, as a user starts it
    attention.LAUNCHES = 0
    started = threading.Event()
    started.stop = threading.Event()
    errors = []

    def serve():
        try:
            oc_server.main([
                "--pretrained-sslaasist", ckpt, "--allow_random_init",
                "--artifacts_dir", workdir, "--host", "127.0.0.1",
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
    if warm_launches != per_batch:  # one warmup batch in bucket 96 000
        fail(f"warmup launched the kernel {warm_launches} times, want "
             f"{per_batch}")

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
        want = per_batch if bucket >= 80000 else 0
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
                           reference_embedding=reference.cpu().numpy(),
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
    return main_launches, model, reference.cpu().numpy()


# ------------------------------------------------------- optional profile

def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_attn_fwd" in n:
        return "flash_attn_fwd (this port)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "conv" in n or "cudnn" in n or "implicit" in n:
        return "conv (cuDNN)"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90")):
        return "matmul (cuBLAS)"
    if "layer_norm" in n:
        return "layer_norm"
    if "copy_kernel" in n:
        return "dtype casts and layout copies"
    return "other elementwise and reductions"


def phase_profile(model, reference: np.ndarray, batches: int = 3):
    """Device time by kernel for full batches of 8 in the two flash
    buckets, through ScoringService as the server runs them:
    torch.profiler's CUDA events, the busy share of the host's window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from occm_tpu_torch.serve import ScoringService, make_score_fn

    rng = np.random.default_rng(1)
    for seconds, bucket in ((6.0, 96000), (12.0, 192000)):
        svc = ScoringService(score_fn=make_score_fn(model, "flash"),
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
        by_name, by_class = {}, {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            cls = _kernel_class(e.name)
            by_class[cls] = by_class.get(cls, 0.0) + us
        busy = sum(by_name.values())
        if busy <= 0:
            fail("profile: torch.profiler recorded no device time")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        print(f"[profile] bucket {bucket} ({seconds:.0f} s), batch 8, "
              f"{batches} batches: host window {window_us / batches / 1e3:.3f}"
              f" ms/batch, device busy {busy / batches / 1e3:.3f} ms/batch "
              f"({busy / window_us:.3f} of the window)", flush=True)
        for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
            print(f"[profile]   {cls}: {us / batches / 1e3:.3f} ms/batch "
                  f"({us / busy:.3f} of device time)", flush=True)
        for name, us in top:
            print(f"[profile]     {us / batches / 1e3:9.3f} ms  {name[:110]}",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, print device time by kernel "
                         "for full batches of the two flash buckets")
    args = ap.parse_args(argv)

    smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    phase_build()
    rows = phase_kernels()
    from occm_tpu_torch.ops import _build

    workdir = tempfile.mkdtemp(prefix="smoke_", dir=_build.BUILD_DIR)
    try:
        launches, model, reference = phase_main_path(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.profile:
        phase_profile(model, reference)

    main_rows = [r for r in rows if r["T"] in MAIN_PATH_TS]
    head = main_rows[0]
    kernel = {
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "occm_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "occm_tpu/ops/attention.py:45 (_fwd_kernel), "
                    "occm_tpu/ops/attention.py:234 (_blocked_fwd_kernel)",
        "launches": launches,
        "shape": f"[B*H={B * H}, T={head['T']}, D={D}] bf16",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "max_err": max(r["max_abs_err"] for r in rows),
        "kernel_ms": head["ms"],
        "per_T": rows,
    }
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
