"""Per-bucket attention-impl auto-selection (port of
`occm_tpu.classify.impl_select`, with the H100's thresholds).

``attention_impl="auto"`` resolves per serving bucket: the plain "xla"
attention for short buckets, the flash kernels from a measured bucket up.
The policy is a pure function of the bucket's sample length and of the
model, so the scores for an utterance depend only on its bucket. On a CUDA
device the threshold depends on the kernels that take the model
(`ops.attention.cuda_route`): the wgmma kernels at head dim 64 (bf16) from
AUTO_FLASH_MIN_SAMPLES up, under exact and fast numerics alike; their
instances at the other head dims they take up to 256 (bf16, multiples of
8: XLS-R 1B's D 80) from AUTO_WGMMA_OTHER_D_MIN_SAMPLES up; the 3xTF32
forward (fp32 at the head dims of `ops.attention.TF32_FWD_HEAD_DIMS`:
`XLSRConfig(dtype="float32")`'s D 64, `XLSRConfig.tiny()`'s D 16) from
AUTO_TF32_MIN_SAMPLES up; the generic kernels (fp32 at any other head dim
up to 256, or bf16 at one the wgmma kernels do not take) from
AUTO_GENERIC_MIN_SAMPLES up; any route's kernels above head dim 256 (the
panel kernels in bf16, the generic ones' panels otherwise) from
AUTO_OVER_256_MIN_SAMPLES up; never where a threshold is None
(`auto_flash_min_samples`). Every head dim has a kernel in bf16 and fp32;
a pinned "flash" passes through and runs the route's kernels, and raises
only on a dtype no kernel takes.
"""

from __future__ import annotations

from typing import Optional

import torch

from occm_tpu_torch.ops.attention import (
    WGMMA_MAX_SINGLE_PANEL, cuda_kernel_takes, cuda_route)

SR = 16000

#: Bucket sample-count at and above which "flash" replaces "xla" under exact
#: numerics: the first bucket boundary at which the flash kernel wins, from
#: chip_smoke.py's per-bucket scoring throughput (full-width model, batch 8,
#: buckets of 1-13 s, the two impls timed in turns) on an NVIDIA H100 80GB
#: HBM3 at a 700 W power limit. Flash won from the 1 s bucket up; PERF.md
#: has the table. The JAX package's 5 s is a figure of another chip.
#:
#: The same threshold holds under fast numerics (bf16 norms and softmax),
#: where the JAX package always picks "xla" from a TPU measurement.
#: chip_smoke.py phase 13 on an NVIDIA H100 80GB HBM3 at a 700 W power
#: limit, the full-width model with --fast_numerics' fields, flash against
#: xla in turns, two runs (PERF.md has the table):
#:   scoring, batch 8, utt/s (A B B A):  2 s  230.9 vs 223.3, 240.8 vs 228.6
#:                                       6 s  215.2 vs 194.1, 228.8 vs 221.2
#:                                      12 s  160.4 vs 151.2, 155.2 vs 153.7
#:   training, 12 x 6 s, graph of 3 steps, ms a step (two rounds each):
#:                                       132.05, 132.08 vs 148.51, 146.93;
#:                                       132.00, 131.97 vs 146.87, 148.50
AUTO_FLASH_MIN_SAMPLES = 1 * SR

#: Bucket sample-count at and above which "flash" replaces "xla" for a model
#: that the generic kernels take (fp32, or bf16 at a head dim the wgmma
#: kernels do not take; csrc/flash_attn_generic.cu): the first bucket at
#: which they won, from chip_smoke.py phase 20's scoring throughput of the
#: full-width model in fp32 (XLSRConfig(dtype="float32"), batch 8, the
#: plain FFN, flash against xla in turns) on an NVIDIA H100 80GB HBM3 at a
#: 700 W power limit. They won in every bucket measured, from the first, in
#: two runs:
#:   scoring, batch 8, utt/s (xla, flash):   2 s  226.97, 254.37; 274.81, 299.42
#:                                           6 s  119.19, 122.26; 119.59, 122.66
#:                                          12 s   62.26,  63.49;  62.27,  63.46
#: Buckets below 2 s were not measured and keep "xla".
AUTO_GENERIC_MIN_SAMPLES: Optional[int] = 2 * SR

#: Bucket sample-count at and above which "flash" replaces "xla" for a bf16
#: model whose head dim the wgmma kernels take other than 64 (their
#: instances for round_up(D, 16); csrc/flash_attn_fwd.cu): None, "xla" in
#: every bucket. chip_smoke.py phase 21's scoring throughput of XLS-R 1B's
#: widths (48 layers, d 1280, 16 heads of 80, bf16, random weights; batch
#: 8, the plain FFN, flash against xla in turns) on an NVIDIA H100 80GB
#: HBM3 at a 700 W power limit, three runs (PERF.md has the table); xla was
#: ahead in 11 of the 12 readings, flash in one run at 12 s only:
#:   scoring, batch 8, utt/s (xla, flash):
#:     1 s  108.53,  94.46;  96.17, 88.06; 130.30, 120.48
#:     2 s  128.64, 114.65;  76.81, 76.62;  89.36,  83.22
#:     6 s  101.21,  99.58;  91.63, 78.71;  94.73,  86.88
#:    12 s   72.99,  69.28;  76.29, 74.66;  78.20,  85.46
#: A batch took 61-110 ms from 1 s to 12 s (12x the frames), so the eager
#: forward was bound by the host there, not by the attention (the D 80
#: kernel's device time is within 1.3x of SDPA's); at head dim 64 (XLS-R
#: 300M) flash won from 1 s. The instances above D 128 (phase 22: XLS-R
#: 300M's widths with 4 heads of 256, the same measurement, two runs) led
#: in no bucket in both runs, so the threshold holds for them too:
#:     1 s  145.97, 141.45; 199.50, 196.79
#:     2 s  167.23, 139.74; 217.77, 200.55
#:     6 s  172.37, 146.26; 208.22, 191.95
#:    12 s  157.24, 160.63; 203.10, 191.28
AUTO_WGMMA_OTHER_D_MIN_SAMPLES: Optional[int] = None

#: Bucket sample-count at and above which "flash" replaces "xla" for an fp32
#: model whose head dim the 3xTF32 forward takes (csrc/flash_attn_fwd_3xtf32.cu
#: with the 3xTF32 backward; ops.attention.TF32_FWD_HEAD_DIMS): the first
#: bucket at which it won in every run, from chip_smoke.py phase 20's
#: scoring throughput of the full-width model in fp32
#: (XLSRConfig(dtype="float32"), batch 8, in turns) on an NVIDIA H100 80GB
#: HBM3 at a 700 W power limit, four runs ("+ffn": the 3xTF32 FFN kernel
#: as well). Flash won at 2, 6 and 12 s in all four and at 1 s in three
#: (a 1 s batch takes ~30-40 ms, most of it the host's):
#:   scoring, batch 8, utt/s (xla, flash, flash +ffn), runs 1; 2; 3; 4:
#:      1 s  235.45, 315.33, 325.99;  250.76, 263.90, 257.43;
#:           201.73, 192.18, 145.15;  269.64, 341.35, 336.99
#:      2 s  276.23, 309.20, 340.73;  233.23, 236.82, 217.85;
#:           188.43, 205.49, 198.72;  222.16, 246.95, 237.78
#:      6 s  119.29, 126.09, 157.63;  118.97, 126.21, 157.88;
#:           119.73, 127.04, 158.57;  119.90, 126.55, 158.96
#:     12 s   62.26,  67.39,  81.62;   62.19,  67.78,  82.14;
#:            62.30,  67.88,  82.22;   62.26,  67.91,  82.27
#: Buckets below 2 s keep "xla".
AUTO_TF32_MIN_SAMPLES: Optional[int] = 2 * SR

#: Bucket sample-count at and above which "flash" replaces "xla" for a model
#: whose head dim is above 256, on any route (bf16 at a multiple of 8: the
#: panel kernels of csrc/flash_attn_panel.cu; otherwise the generic
#: kernels' panels): None, "xla" in every bucket. AUTO_GENERIC_MIN_SAMPLES
#: was measured at head dim 16 and 64 and is not carried over.
#: chip_smoke.py phase 24 times XLS-R 300M's widths with 2 heads of 512
#: (bf16, batch 8, the plain FFN, xla against flash in turns); utt/s on an
#: NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
#:     bucket   xla      flash
#:      1 s   201.27   185.99
#:      2 s   226.67   215.06
#:      6 s   144.61   156.95
#:     12 s   165.20   139.09
#: Flash is ahead at 6 s only (the scoring is host-bound), so no bucket
#: from which it stays ahead: None.
AUTO_OVER_256_MIN_SAMPLES: Optional[int] = None


def select_attention_impl(bucket_samples: int,
                          base_impl: str = "auto",
                          min_samples: Optional[int] = AUTO_FLASH_MIN_SAMPLES
                          ) -> str:
    """Resolve the attention impl for a bucket of `bucket_samples`.

    Any impl other than "auto" passes through unchanged. Auto resolves to
    "flash" from `min_samples` up (the model's threshold,
    `auto_flash_min_samples`), else to "xla"; None: "xla" in every
    bucket."""
    if base_impl != "auto":
        return base_impl
    if min_samples is None:
        return "xla"
    return "flash" if bucket_samples >= min_samples else "xla"


def _dtype_and_head_dim(xlsr_cfg):
    return (getattr(torch, xlsr_cfg.dtype),
            xlsr_cfg.encoder_embed_dim // xlsr_cfg.encoder_heads)


def flash_kernel_takes(xlsr_cfg, device) -> bool:
    """Whether attention_impl="flash" runs a model of `xlsr_cfg` on
    `device`: on a CUDA device if a CUDA route takes its compute dtype and
    head dim (`ops.attention.cuda_kernel_takes`); on the CPU the plain
    version takes any."""
    if torch.device(device).type != "cuda":
        return True
    return cuda_kernel_takes(*_dtype_and_head_dim(xlsr_cfg))


def auto_flash_min_samples(xlsr_cfg, device) -> Optional[int]:
    """The bucket sample-count from which auto picks "flash" for a model of
    `xlsr_cfg` on `device` (None: never): AUTO_FLASH_MIN_SAMPLES on the CPU
    (the plain version) and on the wgmma route at head dim 64,
    AUTO_WGMMA_OTHER_D_MIN_SAMPLES on the wgmma route at its other head
    dims up to 256, AUTO_TF32_MIN_SAMPLES on the 3xTF32 route,
    AUTO_GENERIC_MIN_SAMPLES on the generic route up to 256,
    AUTO_OVER_256_MIN_SAMPLES above head dim 256 on any route, None where
    no CUDA route takes the model."""
    if torch.device(device).type != "cuda":
        return AUTO_FLASH_MIN_SAMPLES
    dtype, head_dim = _dtype_and_head_dim(xlsr_cfg)
    route = cuda_route(dtype, head_dim)
    if route is not None and head_dim > WGMMA_MAX_SINGLE_PANEL:
        return AUTO_OVER_256_MIN_SAMPLES
    if route == "wgmma":
        return (AUTO_FLASH_MIN_SAMPLES if head_dim == 64
                else AUTO_WGMMA_OTHER_D_MIN_SAMPLES)
    if route == "3xtf32":
        return AUTO_TF32_MIN_SAMPLES
    if route == "generic":
        return AUTO_GENERIC_MIN_SAMPLES
    return None
