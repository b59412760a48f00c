"""One-class training loop on one GPU (port of `occm_tpu.train.loop`).

Semantics of the JAX package's loop (reference: oc_training.py:344-401):
- meta-batches of 12 (6 bona + 1 spoof + 5 vocoded), G of them stacked
  [G*12, cut] per step;
- loss = cw * compactness (per meta-batch, averaged over the G groups)
  + dw * descriptiveness (over all G*12 utterances);
- Adam ("adam": torch.optim.Adam with optax's constants, under the
  configured lr schedule, or "fused_adam": the single-pass CUDA kernel),
  one optimizer step per batch, BatchNorm running statistics updated by the
  train-mode forward;
- gradient accumulation (`grad_accum`): the batch in equal micro-batches of
  whole meta-batches, each gradient scaled by the micro-batch's share of
  the batch, BatchNorm statistics chained from micro-batch to micro-batch;
- `steps_per_dispatch` = k: full batches in chunks of k; on a card a chunk
  is one CUDA graph launch (`graph.py`), on the CPU k eager steps (the same
  function);
- loss.txt running averages whenever the optimizer-step count crosses a
  multiple of `log_every`, per-epoch checkpoints through
  `checkpoint_fn(state, epoch)`, step checkpoints every
  `checkpoint_every_steps` optimizer steps and on SIGTERM, and resume.

PyTorch runs eagerly, so there is no jit or donated state; losses stay on
the device between log points, and the host reads them only there (and
when an `on_step` hook asks). Dropout masks come from the state's
generator on the model's device, seeded from cfg.seed; its state is part
of every checkpoint, so a resumed run draws the masks the uninterrupted
run would have drawn.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Dict, Optional

import torch

from occm_tpu_torch.config import TrainConfig
from occm_tpu_torch.data.pipeline import chunk_batches
from occm_tpu_torch.losses import group_one_class_loss
from occm_tpu_torch.train.state import TrainState, create_train_state
from occm_tpu_torch.utils.device import resolve_device
from occm_tpu_torch.utils.logging import MetricsLogger


def _loss(state: TrainState, x, labels, cfg: TrainConfig, weights):
    emb, logits = state.model(x, generator=state.generator)
    return group_one_class_loss(
        emb, logits, labels, cfg.compactness_weight,
        cfg.descriptiveness_weight, cfg.meta_batch, weights)


def train_step(state: TrainState, x: torch.Tensor, labels: torch.Tensor,
               cfg: TrainConfig, weights: Optional[torch.Tensor] = None,
               lr=None) -> Dict[str, torch.Tensor]:
    """Forward in train mode, group one-class loss, backward, optimizer
    step. x [G*12, T] and labels [G*12] on the model's device; weights:
    an optional [G*12] 0/1 utterance mask, constant within each
    meta-batch. `lr`: the update's lr as a device tensor (a captured step's
    schedule slot), else the schedule's. Returns the step's {"loss",
    "closs", "dloss"} as device scalars.

    With cfg.grad_accum = a > 1 and a dividing the batch's group count, the
    batch is cut into a micro-batches of whole meta-batches, run one after
    another (BatchNorm statistics chain from one to the next), and each
    one's backward is scaled by its share r_i = sum(w_i) / sum(w) (1/a
    without weights), so the gradients summed in .grad are the big batch's
    and sum_i r_i * loss_i its loss (`occm_tpu/train/loop.py:234-300`). A
    ragged tail whose group count a does not divide takes one pass."""
    state.model.train()
    accum = max(1, cfg.grad_accum)
    if accum > 1 and (x.shape[0] // cfg.meta_batch) % accum:
        accum = 1
    if accum == 1:
        loss, (c_loss, d_loss) = _loss(state, x, labels, cfg, weights)
        loss.backward()
        metrics = {"loss": loss.detach(), "closs": c_loss.detach(),
                   "dloss": d_loss.detach()}
    else:
        mb = x.shape[0] // accum
        if weights is not None:
            total = torch.clamp(torch.sum(weights), min=1.0)
        metrics = {}
        for i in range(accum):
            part = slice(i * mb, (i + 1) * mb)
            w_i = None if weights is None else weights[part]
            r_i = 1.0 / accum if w_i is None else torch.sum(w_i) / total
            loss, (c_loss, d_loss) = _loss(state, x[part], labels[part], cfg,
                                           w_i)
            (r_i * loss).backward()
            for key, value in (("loss", loss), ("closs", c_loss),
                               ("dloss", d_loss)):
                term = r_i * value.detach()
                metrics[key] = term if i == 0 else metrics[key] + term
    state.apply_gradients(lr)
    return metrics


def _stack_mean(steps):
    return {key: torch.stack([m[key] for m in steps]).mean()
            for key in ("loss", "closs", "dloss")}


def train(
    model,
    pipeline,
    cfg: TrainConfig,
    logger: Optional[MetricsLogger] = None,
    checkpoint_fn: Optional[Callable] = None,
    num_epochs: Optional[int] = None,
    device="cuda",
    on_step: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
    resume: bool = False,
) -> TrainState:
    """Train `model` (an nn.Module returning (emb, logits)) on
    `pipeline.epoch(e)` batches of numpy (x, labels).

    The model moves to `device` (CUDA unless the caller asks for the CPU).
    checkpoint_fn(state, epoch) runs after every epoch; on_step(step,
    metrics), when given, after every dispatch (one optimizer step, or a
    chunk of k: metrics as device scalars, a chunk's means, with its
    steps' values under "step_loss", "step_closs", "step_dloss" and
    "step_lr"). resume=True restores the newest epoch checkpoint
    `<checkpoint_prefix>_<e>.pt` of cfg.checkpoint_dir, then a newer step
    checkpoint, whose epoch is replayed: its consumed dispatches are read
    from the pipeline and skipped without being uploaded. Returns the final
    TrainState (after a SIGTERM, the state it saved)."""
    if cfg.rawboost.algo != 0:
        raise NotImplementedError(
            f"RawBoostConfig.algo={cfg.rawboost.algo}: RawBoost in the train "
            "step is not ported to occm_tpu_torch yet (ROADMAP queue A); "
            "pass RawBoostConfig(algo=0)")
    dev = resolve_device(device)
    logger = logger or MetricsLogger(loss_txt=cfg.loss_txt)
    k = max(1, cfg.steps_per_dispatch)
    graphed = dev.type == "cuda" and k > 1
    state = create_train_state(model.to(dev), cfg)

    start_epoch, progress = 0, None
    if resume:
        from occm_tpu_torch.train.checkpoint import (
            latest_epoch, latest_step_checkpoint, restore_checkpoint,
            restore_step_checkpoint)

        last = latest_epoch(cfg.checkpoint_dir, cfg.checkpoint_prefix)
        if last is not None:
            restore_checkpoint(state, cfg.checkpoint_dir,
                               cfg.checkpoint_prefix, last)
            start_epoch = last + 1
            logger.log_jsonl(event="resume", epoch=start_epoch)
        # a step checkpoint not older than the last epoch checkpoint wins:
        # its epoch is replayed up to it
        s_opt = latest_step_checkpoint(cfg.checkpoint_dir,
                                       cfg.checkpoint_prefix)
        if s_opt is not None:
            progress = restore_step_checkpoint(
                state, cfg.checkpoint_dir, cfg.checkpoint_prefix, s_opt,
                min_epoch=start_epoch)
            if progress is not None:
                start_epoch = int(progress["epoch"])
                logger.log_jsonl(event="resume_step", epoch=start_epoch,
                                 opt_steps=int(progress["opt_steps"]))

    runner = None
    if graphed:
        from occm_tpu_torch.train.graph import GraphedSteps

        runner = state.graph = GraphedSteps(state, cfg, k)

    def upload(a, dtype):
        return torch.as_tensor(a).to(dtype).to(dev, non_blocking=True)

    def dispatch(kind, x, labels):
        if kind == "single":
            return train_step(state, upload(x, torch.float32),
                              upload(labels, torch.long), cfg)
        if runner is not None:
            return runner.run(x, labels)
        steps = [train_step(state, upload(x[i], torch.float32),
                            upload(labels[i], torch.long), cfg)
                 for i in range(k)]  # on the CPU: the same k steps eagerly
        metrics = _stack_mean(steps)
        for key in ("loss", "closs", "dloss"):
            metrics["step_" + key] = torch.stack([m[key] for m in steps])
        return metrics

    # SIGTERM (pre-emption) saves a step checkpoint at the next dispatch
    # boundary and returns; the handler is only installed on the main
    # thread (signal's rule) and always restored
    sigterm = [False]
    handler = installed = None
    if (cfg.checkpoint_every_steps > 0
            and threading.current_thread() is threading.main_thread()):
        handler = signal.signal(signal.SIGTERM,
                                lambda *_: sigterm.__setitem__(0, True))
        installed = True

    def save_step(epoch, dispatches, opt_steps, running):
        from occm_tpu_torch.train.checkpoint import save_step_checkpoint

        save_step_checkpoint(
            state, cfg.checkpoint_dir, cfg.checkpoint_prefix,
            {"epoch": epoch, "dispatches": dispatches,
             "opt_steps": opt_steps, "running_loss": running["loss"],
             "running_closs": running["closs"],
             "running_dloss": running["dloss"]})

    epochs = num_epochs if num_epochs is not None else cfg.num_epochs
    full = cfg.groups_per_step * cfg.meta_batch
    try:
        for epoch in range(start_epoch, epochs):
            # opt_steps counts OPTIMIZER steps: a chunk is k of them, and
            # its metrics (chunk means) enter the running sums with weight
            # k, so loss.txt's i is the reference's per-update counter
            pending = []   # (metrics, weight) not yet folded into running
            running = {"loss": 0.0, "closs": 0.0, "dloss": 0.0}
            opt_steps = dispatches = skip = 0
            if progress is not None and int(progress["epoch"]) == epoch:
                dispatches = skip = int(progress["dispatches"])
                opt_steps = int(progress["opt_steps"])
                running = {"loss": progress["running_loss"],
                           "closs": progress["running_closs"],
                           "dloss": progress["running_dloss"]}
                progress = None
            for kind, x, labels in chunk_batches(pipeline.epoch(epoch),
                                                 full, k):
                if skip > 0:  # replay up to the step checkpoint
                    skip -= 1
                    continue
                metrics = dispatch(kind, x, labels)
                w = k if kind == "chunk" else 1
                prev = opt_steps
                opt_steps += w
                dispatches += 1
                pending.append((metrics, w))
                if on_step is not None:
                    on_step(state.step, metrics)
                if prev // cfg.log_every != opt_steps // cfg.log_every:
                    _fold(pending, running)
                    logger.log_running(epoch, opt_steps - 1,
                                       running["loss"], running["closs"],
                                       running["dloss"])
                    logger.log_jsonl(
                        epoch=epoch, step=opt_steps - 1,
                        **{key: running[key] / opt_steps for key in running})
                every = cfg.checkpoint_every_steps
                if every > 0 and (sigterm[0]
                                  or prev // every != opt_steps // every):
                    _fold(pending, running)
                    save_step(epoch, dispatches, opt_steps, running)
                    if sigterm[0]:
                        logger.log_jsonl(event="preempt_save", epoch=epoch,
                                         opt_steps=opt_steps)
                        return state
            _fold(pending, running)
            if checkpoint_fn is not None:
                checkpoint_fn(state, epoch)
    finally:
        if installed:
            signal.signal(signal.SIGTERM, signal.SIG_DFL if handler is None
                          else handler)
    return state


def _fold(pending, running) -> None:
    for m, w in pending:
        for key in running:
            running[key] += float(m[key]) * w
    pending.clear()
