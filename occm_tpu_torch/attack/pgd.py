"""Targeted L-inf PGD by autograd (port of `occm_tpu.attack.pgd`).

Parity target: the reference's torchattacks hook (reference:
oc_training.py:123-127): PGD(eps=8/255, alpha=2/225, steps=10,
random_start=True) targeted at the spoof class, defined but never wired
into the loop. The JAX package runs it as a jitted `lax.fori_loop`; here
each step is one forward and one input-gradient backward of `logits_fn`
on x's device (on a card through the model's kernels: AModel's input
gradient runs the CUDA flash forward and backward and, with
ln_impl="pallas", the LayerNorm backward kernel). The random start is
drawn from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def pgd_attack(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    target: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    eps: float = 8 / 255,
    alpha: float = 2 / 225,
    steps: int = 10,
    random_start: bool = True,
) -> torch.Tensor:
    """L-inf PGD toward the `target` labels.

    logits_fn(x) -> [B, C]; x [B, T] waveform; target [B] int labels;
    generator: the random start's generator, on x's device (required with
    random_start). torchattacks semantics, as the JAX package's: a random
    start uniform in the eps-ball, per step a sign-gradient *descent* on
    the cross-entropy toward the target class, the projection onto the
    ball around x and a clip to [-1, 1] (audio; torchattacks clips images
    to [0, 1]). Returns x_adv, detached; the parameters of logits_fn get
    no gradient."""
    x = x.detach()
    target = target.reshape(-1, 1).long()
    if random_start:
        if generator is None:
            raise ValueError("a random start draws from a torch.Generator: "
                             "pass generator= (or random_start=False)")
        u = torch.rand(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)
        x_adv = x + (-eps + 2 * eps * u)
    else:
        x_adv = x
    for _ in range(steps):
        xa = x_adv.detach().requires_grad_()
        logp = F.log_softmax(logits_fn(xa), dim=-1)
        loss = -logp.gather(1, target).mean()
        (g,) = torch.autograd.grad(loss, xa)
        # targeted: move DOWN the loss toward the target class
        x_adv = xa.detach() - alpha * torch.sign(g)
        x_adv = x + torch.clamp(x_adv - x, -eps, eps)
        x_adv = torch.clamp(x_adv, -1.0, 1.0)
    return x_adv.detach()
