"""Deterministic random weights for serving without a checkpoint
(`--allow_random_init`) and for the GPU smoke run.

Counterpart of `occm_tpu.utils.init_template`: values come from a seeded
`torch.Generator` on the CPU, so the same seed gives the same model on any
device. Weights are scaled to their fan-in (normal with std 1/sqrt(fan_in),
Flax's lecun_normal), so a signal keeps its size through all 24 layers and
the AASIST backend and the embedding depends on the input; biases are
normal(0.02); the positional conv's folded kernel is drawn as its weight
norm's v (fairseq's weight_norm sets g = ||v||, so w = v); the graph position and master node
parameters are normal(1.0), as Flax initialises them; LayerNorm and
BatchNorm scales are 1 + normal(0.1); BatchNorm running statistics are
non-trivial (mean normal(0.1), variance uniform(0.5, 1.5)), so eval-mode
BatchNorm is not the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

_NORMS = (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)


@torch.no_grad()
def random_init_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Overwrite every parameter and BatchNorm statistic in place."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, _NORMS) and name == "weight":
                value = 1.0 + normal(p.shape, 0.1)
            elif name == "weight" or name.startswith("att_weight"):
                # [out, in, *kernel] or [in, 1]: contracted over all but
                # the leading axis, except att_weight which contracts dim 0
                fan_in = (p.shape[0] if name.startswith("att_weight")
                          else math.prod(p.shape[1:]))
                value = normal(p.shape, 1.0 / math.sqrt(fan_in))
            elif name in ("pos_S", "master1", "master2"):
                value = normal(p.shape, 1.0)
            else:
                value = normal(p.shape, 0.02)
            p.copy_(value)
        if isinstance(module, (nn.BatchNorm1d, nn.BatchNorm2d)):
            module.running_mean.copy_(normal(module.running_mean.shape, 0.1))
            module.running_var.copy_(
                0.5 + torch.rand(module.running_var.shape, generator=gen))
    return model
