"""A-softmax (SphereFace) angular-margin loss for the LCNN head (port of
`occm_tpu.losses.angle`; reference: models/lcnn.py:86-118).

The reference keeps a mutable iteration counter on the module to anneal
lambda; here, as in the JAX package, the counter is explicit state
(`AngleLossState`), a 0-d integer tensor. The training step passes the
step count that lives on the device, so a CUDA graph of the step anneals
lambda on every replay without a host read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class AngleLossState(NamedTuple):
    it: torch.Tensor  # 0-d integer iteration counter

    @staticmethod
    def create() -> "AngleLossState":
        return AngleLossState(it=torch.zeros((), dtype=torch.int32))


def angle_loss(
    cos_psi: Tuple[torch.Tensor, torch.Tensor],
    target: torch.Tensor,
    state: AngleLossState,
    gamma: float = 0.0,
    lambda_min: float = 5.0,
    lambda_max: float = 1500.0,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, AngleLossState]:
    """Annealed angular-margin cross entropy.

    cos_psi: (cos_theta, psi_theta), each [B, C], the AngleLinear head's
    output. Returns (loss, new_state). lambda = max(lambda_min,
    lambda_max / (1 + 0.1 it)) with it pre-incremented; the output is
    cos_theta blended towards psi_theta at the target class by
    1 / (1 + lambda); pt is detached. weights: an optional [B] 0/1 sample
    mask (the weighted mean equals the plain mean over the kept samples).
    """
    cos_theta, psi_theta = cos_psi
    it = state.it + 1
    lamb = torch.clamp(lambda_max / (1.0 + 0.1 * it.to(cos_theta.dtype)),
                       min=lambda_min)
    onehot = torch.nn.functional.one_hot(
        target.long(), cos_theta.shape[-1]).to(cos_theta.dtype)
    output = cos_theta + onehot * (psi_theta - cos_theta) / (1.0 + lamb)

    logpt = torch.log_softmax(output, dim=1)
    logpt = torch.gather(logpt, 1, target.long()[:, None])[:, 0]
    pt = torch.exp(logpt).detach()

    per_sample = -((1.0 - pt) ** gamma) * logpt
    if weights is None:
        loss = torch.mean(per_sample)
    else:
        w = weights.to(per_sample.dtype)
        loss = torch.sum(per_sample * w) / torch.clamp(torch.sum(w), min=1.0)
    return loss, AngleLossState(it=it)
