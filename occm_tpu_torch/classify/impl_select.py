"""Per-bucket attention-impl auto-selection (port of
`occm_tpu.classify.impl_select`, same policy).

``attention_impl="auto"`` resolves per serving bucket: the plain "xla"
attention for short buckets, the flash kernel from AUTO_FLASH_MIN_SAMPLES
up. The policy is a pure function of the bucket's sample length, so the
scores for an utterance depend only on its bucket.
"""

from __future__ import annotations

SR = 16000

#: Bucket sample-count at and above which "flash" replaces "xla" under exact
#: numerics. The 5 s crossover is a TPU v5e figure (the JAX package's
#: tools/bench_longT.py sweep); it is still to be re-measured on the H100
#: with the port's own kernel.
AUTO_FLASH_MIN_SAMPLES = 5 * SR


def select_attention_impl(bucket_samples: int,
                          base_impl: str = "auto",
                          norm_dtype: str = "float32") -> str:
    """Resolve the attention impl for a bucket of `bucket_samples`.

    Any impl other than "auto" passes through unchanged. Under fast numerics
    (norm_dtype="bfloat16") auto resolves to "xla" everywhere, as in the JAX
    package; the flash crossover applies to exact (fp32-softmax) scoring."""
    if base_impl != "auto":
        return base_impl
    if norm_dtype == "bfloat16":
        return "xla"
    return "flash" if bucket_samples >= AUTO_FLASH_MIN_SAMPLES else "xla"
