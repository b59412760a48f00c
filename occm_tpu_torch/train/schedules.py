"""Learning-rate schedules (the port's copies of the optax schedules that
`occm_tpu.train.loop.make_optimizer` builds).

Each schedule maps the number of optimizer updates already applied (0 for
the first update, as optax's `scale_by_schedule` counts) to a learning
rate, computed in fp32 as optax computes it (`linear_schedule`,
`cosine_decay_schedule`, `warmup_cosine_decay_schedule`,
`join_schedules`). `make_schedule(cfg)` builds the JAX package's schedule
from a TrainConfig: None for "constant", whose lr stays a plain scalar.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

Schedule = Callable[[int], float]

_F = np.float32


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    """optax.linear_schedule: init_value until `transition_begin`, then a
    straight line to end_value over `transition_steps` updates, then
    end_value; constant init_value when transition_steps <= 0."""
    if transition_steps <= 0:
        return lambda count: float(_F(init_value))
    begin = max(transition_begin, 0)

    def schedule(count: int) -> float:
        c = min(max(count - begin, 0), transition_steps)
        frac = _F(1) - _F(c) / _F(transition_steps)
        return float(_F(init_value - end_value) * frac + _F(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    """optax.cosine_decay_schedule: init_value * ((1 - alpha) * (0.5 * (1 +
    cos(pi * min(t, T) / T))) ** exponent + alpha)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        c = _F(min(count, decay_steps))
        cosine = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * c / _F(decay_steps)))
        decayed = _F(1 - alpha) * cosine ** _F(exponent) + _F(alpha)
        return float(_F(init_value) * decayed)

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: schedules[i + 1] from boundaries[i] on, fed
    the count minus that boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: a linear warmup to peak_value
    over `warmup_steps`, then a cosine decay to end_value by `decay_steps`
    (which includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha, exponent)],
        [warmup_steps])


def make_schedule(cfg) -> Optional[Schedule]:
    """The schedule of the JAX package's `make_optimizer` for cfg: None for
    "constant"; "cosine": warmup from 0 to cfg.lr over warmup_steps, then
    cosine decay over decay_steps to lr * lr_end_ratio; "linear": the same
    warmup (at least one step long), then a straight line."""
    if cfg.lr_schedule == "constant":
        return None
    end = cfg.lr * cfg.lr_end_ratio
    if cfg.lr_schedule == "cosine":
        return warmup_cosine_decay_schedule(
            0.0, cfg.lr, cfg.warmup_steps,
            cfg.warmup_steps + cfg.decay_steps, end)
    return join_schedules(
        [linear_schedule(0.0, cfg.lr, max(cfg.warmup_steps, 1)),
         linear_schedule(cfg.lr, end, cfg.decay_steps)],
        [cfg.warmup_steps])
