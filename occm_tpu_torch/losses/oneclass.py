"""One-class scoring distance (port of `occm_tpu.losses.oneclass`).

Only `pairwise_distance` is on the serving path; the training losses come
with the training slice.
"""

from __future__ import annotations

import torch


def pairwise_distance(x: torch.Tensor, y: torch.Tensor, p: float = 2.0,
                      eps: float = 1e-6) -> torch.Tensor:
    """L_p distance along the last axis with torch's eps-on-difference
    convention (`torch.nn.functional.pairwise_distance`): ||x - y + eps||_p."""
    diff = x - y + eps
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, dim=-1))
    return torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p)
