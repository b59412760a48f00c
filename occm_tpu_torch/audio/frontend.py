"""Host-side repeat-pad/crop and zero-pad (port of
`occm_tpu.audio.frontend.pad` and `zero_pad_to_max`)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pad(x: np.ndarray, max_len: int = 64600) -> np.ndarray:
    """Repeat-pad/crop to `max_len`, bit-compatible with the reference
    (reference: data_utils_SSL.py:47-54)."""
    x_len = x.shape[0]
    if x_len >= max_len:
        return x[:max_len]
    num_repeats = int(max_len / x_len) + 1
    return np.tile(x, num_repeats)[:max_len]


def zero_pad_to_max(features: Sequence[np.ndarray]) -> np.ndarray:
    """Trailing zero-pad to the in-group maximum length, as the meta-batch
    assembly does (reference: oc_training.py:244-249).
    Returns [len(features), max_len] float32."""
    max_length = max(int(f.shape[0]) for f in features)
    out = np.zeros((len(features), max_length), dtype=np.float32)
    for i, f in enumerate(features):
        out[i, : f.shape[0]] = f
    return out
