"""Train state: the model (parameters and BatchNorm statistics), its
optimizer and lr schedule, the step count and the dropout generator (port
of `occm_tpu.train.state`), and the model's output kind (what the step's
loss makes of its output: `train.loop._loss`).

The step count is kept twice: `step`, a host int, and `step_t`, a 0-d
int64 tensor on the model's device that `apply_gradients` increments with
a launch of its own. What the step computes from the count reads
`step_t` (the A-softmax loss's lambda, the JAX step's `state.step`), so a
CUDA graph of k steps (`graph.py`) anneals it on every replay; the host
count serves the lr schedule, logging and checkpoint names.

The optimizer is `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)` for
"adam" (optax's `adam`, never `fused=True`) or the port's single-pass
`FusedAdam` kernel for "fused_adam". With an lr schedule (`schedules.py`,
"adam" only, as in JAX) the lr of each update is the schedule at the
number of updates already applied. On a card "adam" is always built
`capturable=True` (its step count on the device) with a device tensor lr,
so eager steps and a CUDA graph of the step (`graph.py`) run one and the
same update; on the CPU it is the plain Adam with a float lr. Optimizer
state moves in and out in one form for both, keyed by parameter name:
{"kind", "count", "mu": {name: tensor}, "nu": {name: tensor}}, the form
`optimizer_state_from_flax` gives.

On a mesh (`parallel.place_state_on_mesh`: `mesh` and `placements` set)
the parameters and moments this rank holds are its shards (tp and fsdp;
under pp its stage's layers, an empty tensor standing in for each of the
other stages'), and `optimizer_state()` gives them as they are held; the
checkpoints gather them whole (`parallel.sharding.full_optimizer_state`). The
optimizer steps only the local shards and moments: FusedAdam's one
multi-tensor launch runs over the shards.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn

from occm_tpu_torch.config import TrainConfig
from occm_tpu_torch.ops.fused_adam import FusedAdam
from occm_tpu_torch.train.schedules import Schedule, make_schedule

Optimizer = Union[torch.optim.Adam, FusedAdam]


def make_optimizer(cfg: TrainConfig, params: List[torch.Tensor]
                   ) -> Optimizer:
    """"adam": torch.optim.Adam with optax adam's constants (the JAX
    package's path; on CUDA parameters capturable, its step count and lr
    on their device, as a CUDA graph needs); "fused_adam": FusedAdam, the
    CUDA kernel."""
    if cfg.optimizer == "fused_adam":
        return FusedAdam(cfg.lr).init(params)
    capturable = bool(params) and params[0].is_cuda
    lr = cfg.lr
    if capturable:
        lr = torch.tensor(cfg.lr, dtype=torch.float32,
                          device=params[0].device)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


#: what the step's loss makes of the model's output (`occm_tpu.train.loop`)
OUTPUT_KINDS = ("dual", "logits", "angle", "occm")


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator   # of the dropout masks, on the model's device
    step: int = 0
    schedule: Optional[Schedule] = None
    #: the CUDA graph runner (`graph.GraphedSteps`) that train() uses on a
    #: card with steps_per_dispatch > 1, else None
    graph: Optional[object] = None
    #: "dual" (emb, logits), "logits", "angle" ((cos, psi) + the angle
    #: loss) or "occm" (((emb, logits), lcnn_logits))
    output_kind: str = "dual"
    #: the step count on the generator's device (made from `step`)
    step_t: Optional[torch.Tensor] = None
    #: the rank mesh the state is placed on (`parallel.place_state_on_mesh`)
    #: and its placement table by parameter name ({}: whole on every rank)
    mesh: Optional[object] = None
    placements: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.output_kind not in OUTPUT_KINDS:
            raise ValueError(f"unknown output_kind {self.output_kind!r} "
                             f"(one of {OUTPUT_KINDS})")
        if self.step_t is None:
            self.step_t = torch.full((), self.step, dtype=torch.int64,
                                     device=self.generator.device)

    def set_step(self, step: int) -> None:
        """Set the step count, on the host and on the device."""
        self.step = int(step)
        self.step_t.fill_(self.step)

    def named_params(self) -> List[Tuple[str, nn.Parameter]]:
        return list(self.model.named_parameters())

    def set_lr(self, lr) -> None:
        """The lr of the next update: a float, or a 0-d device tensor that
        a captured step copies in."""
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                if isinstance(lr, torch.Tensor):
                    group["lr"].copy_(lr)
                else:
                    group["lr"].fill_(float(lr))
            else:
                group["lr"] = float(lr)

    def apply_gradients(self, lr=None) -> None:
        """One optimizer step from the parameters' .grad, then clear
        them; BatchNorm statistics were updated by the forward. With a
        schedule the update's lr is `lr` when given (a captured step's
        device tensor), else the schedule at the current step."""
        params = [p for _, p in self.named_params()]
        if isinstance(self.optimizer, FusedAdam):
            self.optimizer.step(params, [p.grad for p in params])
        else:
            if self.schedule is not None:
                self.set_lr(self.schedule(self.step) if lr is None else lr)
            self.optimizer.step()
        for p in params:
            p.grad = None
        self.step += 1
        self.step_t.add_(1)

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
        other parameter keeps zero moments. Every name of mu and nu must be
        a parameter of the model at its shape, and mu and nu must name the
        same parameters (ValueError otherwise)."""
        count = int(opt_state["count"])
        named = self.named_params()
        shapes = {n: tuple(p.shape) for n, p in named}
        mu, nu = opt_state["mu"], opt_state["nu"]
        if set(mu) != set(nu):
            raise ValueError("mu and nu name other parameters: "
                             f"{sorted(set(mu) ^ set(nu))[:4]}")
        for n in sorted(mu):
            if n not in shapes:
                raise ValueError(f"the moments of {n!r}: the model has no "
                                 "such parameter")
            for key, m in (("mu", mu[n]), ("nu", nu[n])):
                if tuple(m.shape) != shapes[n]:
                    raise ValueError(f"{key} of {n!r} has shape "
                                     f"{tuple(m.shape)}, the parameter "
                                     f"{shapes[n]}")
        if isinstance(self.optimizer, FusedAdam):
            opt = self.optimizer
            opt.count = count
            for (n, _), m, v in zip(named, opt.mu, opt.nu):
                if n in opt_state["mu"]:
                    m.copy_(opt_state["mu"][n])
                    v.copy_(opt_state["nu"][n])
            return
        capturable = self.optimizer.defaults.get("capturable", False)
        for n, p in named:
            if n not in opt_state["mu"]:
                continue
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=p.device if capturable
                                     else "cpu"),
                "exp_avg": opt_state["mu"][n].to(p).clone(),
                "exp_avg_sq": opt_state["nu"][n].to(p).clone(),
            }


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       output_kind: str = "dual") -> TrainState:
    """The optimizer over the model's parameters (where they lie), the lr
    schedule, and a dropout generator on the model's device seeded from
    cfg.seed; `output_kind` is one of OUTPUT_KINDS."""
    params = [p for p in model.parameters()]
    device = params[0].device if params else torch.device("cpu")
    return TrainState(
        model=model, optimizer=make_optimizer(cfg, params),
        generator=torch.Generator(device=device).manual_seed(cfg.seed),
        schedule=make_schedule(cfg), output_kind=output_kind)
