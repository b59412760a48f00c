"""Host-side repeat-pad/crop (port of `occm_tpu.audio.frontend.pad`)."""

from __future__ import annotations

import numpy as np


def pad(x: np.ndarray, max_len: int = 64600) -> np.ndarray:
    """Repeat-pad/crop to `max_len`, bit-compatible with the reference
    (reference: data_utils_SSL.py:47-54)."""
    x_len = x.shape[0]
    if x_len >= max_len:
        return x[:max_len]
    num_repeats = int(max_len / x_len) + 1
    return np.tile(x, num_repeats)[:max_len]
