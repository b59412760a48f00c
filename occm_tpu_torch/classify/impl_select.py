"""Per-bucket attention-impl auto-selection (port of
`occm_tpu.classify.impl_select`, with the H100's thresholds).

``attention_impl="auto"`` resolves per serving bucket: the plain "xla"
attention for short buckets, the flash kernel from AUTO_FLASH_MIN_SAMPLES
up, under exact and fast numerics alike. The policy is a pure function of
the bucket's sample length and of the model, so the scores for an
utterance depend only on its bucket. On a CUDA device auto never picks a
kernel that cannot take the model: the CUDA flash kernels take bf16 with
head dim 64, so a model in another compute dtype or head dim
(`XLSRConfig.tiny()`: fp32, D = 16) runs "xla" there
(`flash_kernel_takes`). A pinned "flash" passes through and raises on
such a model.
"""

from __future__ import annotations

import torch

from occm_tpu_torch.ops.attention import cuda_kernel_takes

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


def select_attention_impl(bucket_samples: int,
                          base_impl: str = "auto",
                          flash_takes_model: bool = True) -> str:
    """Resolve the attention impl for a bucket of `bucket_samples`.

    Any impl other than "auto" passes through unchanged. Auto resolves to
    "xla" where the flash kernel cannot take the model (flash_takes_model
    False, see `flash_kernel_takes`), else to "flash" from
    AUTO_FLASH_MIN_SAMPLES up, whatever the numerics."""
    if base_impl != "auto":
        return base_impl
    if not flash_takes_model:
        return "xla"
    return "flash" if bucket_samples >= AUTO_FLASH_MIN_SAMPLES else "xla"


def flash_kernel_takes(xlsr_cfg, device) -> bool:
    """Whether attention_impl="flash" runs a model of `xlsr_cfg` on
    `device`: on a CUDA device only if the CUDA kernels take its compute
    dtype and head dim (`ops.attention.cuda_kernel_takes`); on the CPU the
    plain version takes any."""
    if torch.device(device).type != "cuda":
        return True
    return cuda_kernel_takes(getattr(torch, xlsr_cfg.dtype),
                             xlsr_cfg.encoder_embed_dim
                             // xlsr_cfg.encoder_heads)
