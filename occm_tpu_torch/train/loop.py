"""One-class training loop on one GPU (port of `occm_tpu.train.loop`).

Semantics of the JAX package's loop (reference: oc_training.py:344-401):
- meta-batches of 12 (6 bona + 1 spoof + 5 vocoded), G of them stacked
  [G*12, cut] per step;
- loss = cw * compactness (per meta-batch, averaged over the G groups)
  + dw * descriptiveness (over all G*12 utterances);
- Adam ("adam": torch.optim.Adam with optax's constants, or "fused_adam":
  the single-pass CUDA kernel), one optimizer step per batch, BatchNorm
  running statistics updated by the train-mode forward;
- loss.txt running averages every `log_every` steps, per-epoch
  checkpoints through `checkpoint_fn(state, epoch)`.

PyTorch runs eagerly, so there is no jit or donated state; losses stay on
the device between log points, and the host reads them only there (and
when an `on_step` hook asks). Dropout masks come from the state's CPU
generator, seeded from cfg.seed.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from occm_tpu_torch.config import TrainConfig
from occm_tpu_torch.losses import group_one_class_loss
from occm_tpu_torch.train.state import TrainState, create_train_state
from occm_tpu_torch.utils.device import resolve_device
from occm_tpu_torch.utils.logging import MetricsLogger


def train_step(state: TrainState, x: torch.Tensor, labels: torch.Tensor,
               cfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """Forward in train mode, group one-class loss, backward, optimizer
    step. x [G*12, T] and labels [G*12] on the model's device. Returns the
    step's {"loss", "closs", "dloss"} as device scalars."""
    model = state.model
    model.train()
    emb, logits = model(x, generator=state.generator)
    loss, (c_loss, d_loss) = group_one_class_loss(
        emb, logits, labels, cfg.compactness_weight,
        cfg.descriptiveness_weight, cfg.meta_batch)
    loss.backward()
    state.apply_gradients()
    return {"loss": loss.detach(), "closs": c_loss.detach(),
            "dloss": d_loss.detach()}


def train(
    model,
    pipeline,
    cfg: TrainConfig,
    logger: Optional[MetricsLogger] = None,
    checkpoint_fn: Optional[Callable] = None,
    num_epochs: Optional[int] = None,
    device="cuda",
    on_step: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
) -> TrainState:
    """Train `model` (an nn.Module returning (emb, logits)) on
    `pipeline.epoch(e)` batches of numpy (x, labels).

    The model moves to `device` (CUDA unless the caller asks for the CPU).
    checkpoint_fn(state, epoch) runs after every epoch; on_step(step,
    metrics), when given, after every optimizer step (metrics as device
    scalars). Returns the final TrainState."""
    if cfg.rawboost.algo != 0:
        raise NotImplementedError(
            f"RawBoostConfig.algo={cfg.rawboost.algo}: RawBoost in the train "
            "step is not ported to occm_tpu_torch yet (ROADMAP queue A); "
            "pass RawBoostConfig(algo=0)")
    dev = resolve_device(device)
    logger = logger or MetricsLogger(loss_txt=cfg.loss_txt)
    state = create_train_state(model.to(dev), cfg)

    epochs = num_epochs if num_epochs is not None else cfg.num_epochs
    for epoch in range(epochs):
        pending = []   # metrics not yet folded into running (device side)
        running = {"loss": 0.0, "closs": 0.0, "dloss": 0.0}
        steps = 0
        for x, labels in pipeline.epoch(epoch):
            x = torch.as_tensor(x, dtype=torch.float32).to(
                dev, non_blocking=True)
            labels = torch.as_tensor(labels).long().to(dev, non_blocking=True)
            metrics = train_step(state, x, labels, cfg)
            steps += 1
            pending.append(metrics)
            if on_step is not None:
                on_step(state.step, metrics)
            if steps % cfg.log_every == 0:
                _fold(pending, running)
                logger.log_running(epoch, steps - 1, running["loss"],
                                   running["closs"], running["dloss"])
                logger.log_jsonl(epoch=epoch, step=steps - 1,
                                 **{k: running[k] / steps for k in running})
        _fold(pending, running)
        if checkpoint_fn is not None:
            checkpoint_fn(state, epoch)
    return state


def _fold(pending, running) -> None:
    for m in pending:
        for k in running:
            running[k] += float(m[k])
    pending.clear()
