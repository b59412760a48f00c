"""Max-Feature-Map activation (port of `occm_tpu.ops.mfm`; reference:
models/lcnn.py:121-136).

The producing layer emits 2 * out features and MFM takes the elementwise
max of the two halves. The JAX package keeps features on the last axis
(NHWC); the port splits where torch's layouts keep them: the channel dim
(1) of an NCHW conv output, the last dim of a dense output.
"""

from __future__ import annotations

import torch


def mfm_max(x: torch.Tensor, out_features: int, dim: int = -1
            ) -> torch.Tensor:
    """x with 2 * out_features along `dim` -> max(first half, second
    half)."""
    a, b = torch.split(x, out_features, dim=dim)[:2]
    return torch.maximum(a, b)
