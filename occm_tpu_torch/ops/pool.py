"""Max pooling with torch's exact semantics, as AASIST uses it.

Port of `occm_tpu.ops.pool.max_pool2d`, which re-implements torch's
`F.max_pool2d` (stride = kernel by default, floor mode, -inf padding) on
NHWC. The port keeps torch's NCHW layout, so it is torch's own op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, kernel, stride=None,
               padding=0) -> torch.Tensor:
    """torch F.max_pool2d on NCHW input (floor mode, -inf padding)."""
    return F.max_pool2d(x, kernel, stride=stride, padding=padding)
