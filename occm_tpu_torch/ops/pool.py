"""Pooling with torch's exact semantics, on NCHW.

Port of `occm_tpu.ops.pool`, which re-implements torch's pools on NHWC
for the TPU: `adaptive_avg_pool2d` (torch's variable windows start =
floor(i * H / oh), end = ceil((i + 1) * H / oh), for any pair of sizes,
an output larger than the input included), `global_avg_pool2d`
(AdaptiveAvgPool2d(1) and flatten), `max_pool2d` (stride = kernel by
default, floor mode, -inf padding) and `avg_pool2d` (no padding, floor
mode). The port keeps torch's NCHW layout, so each is torch's own op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """torch.nn.AdaptiveAvgPool2d on NCHW input [..., C, H, W]."""
    return F.adaptive_avg_pool2d(x, output_size)


def global_avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) + flatten: [..., C, H, W] -> [..., C]."""
    return torch.mean(x, dim=(-2, -1))


def max_pool2d(x: torch.Tensor, kernel, stride=None,
               padding=0) -> torch.Tensor:
    """torch F.max_pool2d on NCHW input (floor mode, -inf padding)."""
    return F.max_pool2d(x, kernel, stride=stride, padding=padding)


def avg_pool2d(x: torch.Tensor, kernel, stride=None) -> torch.Tensor:
    """torch F.avg_pool2d (no padding, floor mode) on NCHW input."""
    return F.avg_pool2d(x, kernel, stride=stride)
