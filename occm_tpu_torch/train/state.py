"""Train state: the model (parameters and BatchNorm statistics), its
optimizer, the step count and the dropout generator (port of
`occm_tpu.train.state`).

The optimizer is `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)` for
"adam" (optax's `adam`, never `fused=True`) or the port's single-pass
`FusedAdam` kernel for "fused_adam". Optimizer state moves in and out in
one form for both, keyed by parameter name: {"kind", "count", "mu": {name:
tensor}, "nu": {name: tensor}}, the form `optimizer_state_from_flax`
gives.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import torch
import torch.nn as nn

from occm_tpu_torch.config import TrainConfig
from occm_tpu_torch.ops.fused_adam import FusedAdam

Optimizer = Union[torch.optim.Adam, FusedAdam]


def make_optimizer(cfg: TrainConfig, params: List[torch.Tensor]) -> Optimizer:
    """"adam": torch.optim.Adam with optax adam's constants (the JAX
    package's constant-lr path); "fused_adam": FusedAdam, the CUDA kernel."""
    if cfg.optimizer == "fused_adam":
        return FusedAdam(cfg.lr).init(params)
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator   # CPU generator of the dropout masks
    step: int = 0

    def named_params(self) -> List[Tuple[str, nn.Parameter]]:
        return list(self.model.named_parameters())

    def apply_gradients(self) -> None:
        """One optimizer step from the parameters' .grad, then clear
        them; BatchNorm statistics were updated by the forward."""
        params = [p for _, p in self.named_params()]
        if isinstance(self.optimizer, FusedAdam):
            self.optimizer.step(params, [p.grad for p in params])
        else:
            self.optimizer.step()
        for p in params:
            p.grad = None
        self.step += 1

    def optimizer_state(self) -> Dict:
        """{"kind", "count", "mu", "nu"} keyed by parameter name."""
        named = self.named_params()
        if isinstance(self.optimizer, FusedAdam):
            opt = self.optimizer
            return {"kind": "fused_adam", "count": opt.count,
                    "mu": {n: m for (n, _), m in zip(named, opt.mu)},
                    "nu": {n: v for (n, _), v in zip(named, opt.nu)}}
        state = self.optimizer.state
        live = [(n, p) for n, p in named if p in state]
        count = int(state[live[0][1]]["step"]) if live else 0
        return {"kind": "adam", "count": count,
                "mu": {n: state[p]["exp_avg"] for n, p in live},
                "nu": {n: state[p]["exp_avg_sq"] for n, p in live}}

    @torch.no_grad()
    def load_optimizer_state(self, opt_state: Dict) -> None:
        """Set the step count and the moments named in `opt_state`; every
        other parameter keeps zero moments."""
        count = int(opt_state["count"])
        named = self.named_params()
        if isinstance(self.optimizer, FusedAdam):
            opt = self.optimizer
            opt.count = count
            for (n, _), m, v in zip(named, opt.mu, opt.nu):
                if n in opt_state["mu"]:
                    m.copy_(opt_state["mu"][n])
                    v.copy_(opt_state["nu"][n])
            return
        for n, p in named:
            if n not in opt_state["mu"]:
                continue
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": opt_state["mu"][n].to(p).clone(),
                "exp_avg_sq": opt_state["nu"][n].to(p).clone(),
            }


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """The optimizer over the model's parameters (where they lie) and a
    dropout generator seeded from cfg.seed."""
    params = [p for p in model.parameters()]
    return TrainState(model=model, optimizer=make_optimizer(cfg, params),
                      generator=torch.Generator().manual_seed(cfg.seed))
