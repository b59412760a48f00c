"""One-class training loop on one GPU or over a rank mesh (port of
`occm_tpu.train.loop`).

Semantics of the JAX package's loop (reference: oc_training.py:344-401):
- meta-batches of 12 (6 bona + 1 spoof + 5 vocoded), G of them stacked
  [G*12, cut] per step;
- the loss of the model's output kind (`occm_tpu/train/loop.py:184-225`):
  "dual" (AModel, SSLResNet34: (emb, logits)) cw * compactness (per
  meta-batch, averaged over the G groups) + dw * descriptiveness (over all
  G*12 utterances); "logits" (SSLLCNN, TotalCNNNet) dw * descriptiveness;
  "angle" (SSLLCNN with the A-softmax head) dw * the angle loss, lambda
  annealed from the step count on the device (`state.step_t`, the count
  before this update); "occm" ((emb, senet logits), lcnn logits) cw *
  compactness of the SE-ResNet embedding + dw * the mean of the two heads'
  descriptiveness;
- Adam ("adam": torch.optim.Adam with optax's constants, under the
  configured lr schedule, or "fused_adam": the single-pass CUDA kernel),
  one optimizer step per batch, BatchNorm running statistics updated by the
  train-mode forward;
- RawBoost (`cfg.rawboost.algo` 1-8; `occm_tpu_torch.augment`) on the
  whole batch, once per optimizer step, before the forward and before the
  accumulation split (`occm_tpu/train/loop.py:175-177`);
- gradient accumulation (`grad_accum`): the batch in equal micro-batches of
  whole meta-batches, each gradient scaled by the micro-batch's share of
  the batch, BatchNorm statistics chained from micro-batch to micro-batch;
- `steps_per_dispatch` = k: full batches in chunks of k; on a card a chunk
  is one CUDA graph launch (`graph.py`), on the CPU k eager steps (the same
  function);
- loss.txt running averages whenever the optimizer-step count crosses a
  multiple of `log_every`, per-epoch checkpoints through
  `checkpoint_fn(state, epoch)`, step checkpoints every
  `checkpoint_every_steps` optimizer steps and on SIGTERM, and resume
  from the port's `.pt` checkpoints or the JAX package's orbax
  directories (`train.checkpoint`).

On a mesh with pp > 1 (the GPipe pipeline over the XLSR layers), each
rank runs its pp_stages / pp consecutive stages of the schedule: rank 0
RawBoost, then the encoder's stage forward (`XLSREncoder.stage_forward`:
rank 0 the frontend, every rank its stages' layers on the M microbatches
tick by tick, a rank's first stage on what it receives from the rank
before, the last stage's outputs gathered into the rank's rows under the
encoder LayerNorm), the last rank the backend and the loss; then the
backward (`_Stage`), in reverse tick order, each stage handing its
inputs' gradients back. The dropout generator travels with the schedule
(each rank draws after the one before, as one process draws), and the
last rank's generator, BatchNorm statistics and metrics are broadcast
to its pipeline at the end.

PyTorch runs eagerly, so there is no jit or donated state; losses stay on
the device between log points, and the host reads them only there (and
when an `on_step` hook asks). RawBoost's draws and then the dropout masks
come from the state's generator on the model's device, seeded from
cfg.seed; its state is part of every checkpoint, so a resumed run draws
the augmentation and the masks the uninterrupted run would have drawn. A
run continued from a JAX directory seeds it from cfg.seed and the step
instead (a JAX PRNG key has no torch counterpart).
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from occm_tpu_torch.augment import batch_rawboost
from occm_tpu_torch.augment.rawboost import draw_rawboost, process_rawboost
from occm_tpu_torch.config import TrainConfig
from occm_tpu_torch.data.pipeline import chunk_batches
from occm_tpu_torch.losses import (
    AngleLossState, angle_loss, descriptiveness_loss, group_one_class_loss)
from occm_tpu_torch.parallel import collectives as C
from occm_tpu_torch.parallel import multihost
from occm_tpu_torch.parallel.mesh import (
    batch_shard, compute_mesh, data_index, data_parallel_size, make_mesh,
    pp_group, pp_peer, sharded_batch)
from occm_tpu_torch.parallel.sharding import (
    gather_fsdp_params, local_rows, place_state_on_mesh, reduce_gradients)
from occm_tpu_torch.train.state import TrainState, create_train_state
from occm_tpu_torch.utils.device import resolve_device
from occm_tpu_torch.utils.logging import MetricsLogger


def _loss(state: TrainState, x, labels, cfg: TrainConfig, weights):
    """The train-mode forward and its loss by `state.output_kind`, as the
    JAX step body composes them -> (loss, (c_loss, d_loss))."""
    out = state.model(x, generator=state.generator)
    shard = batch_shard()
    if shard is not None:
        # the loss of the GLOBAL batch on every rank: the outputs gathered
        # (differentiably) over the data axes, in data-shard order
        out = _tree(out, lambda t: C.gather_rows(t, shard.group))
        labels = C.all_gather_cat(labels, shard.group)
        if weights is not None:
            weights = C.all_gather_cat(weights, shard.group)
    kind = state.output_kind
    cw, dw = cfg.compactness_weight, cfg.descriptiveness_weight
    if kind == "dual":
        emb, logits = out
        return group_one_class_loss(emb, logits, labels, cw, dw,
                                    cfg.meta_batch, weights)
    if kind == "occm":
        # dual-branch OCCM (reference: models/occm.py:48-67; the reference
        # ships no OCCM trainer, so the loss composes its formulas)
        (emb, senet_logits), lcnn_logits = out
        _, (c_loss, d_senet) = group_one_class_loss(
            emb, senet_logits, labels, cw, dw, cfg.meta_batch, weights)
        d_loss = 0.5 * (d_senet + descriptiveness_loss(lcnn_logits, labels,
                                                       weights))
        return cw * c_loss + dw * d_loss, (c_loss, d_loss)
    if kind == "angle":
        # the A-softmax head's (cos, psi) + the angle loss, the step count
        # as the annealing iteration (reference: oc_training.py:334-335)
        d_loss, _ = angle_loss(out, labels, AngleLossState(it=state.step_t),
                               weights=weights)
    else:  # "logits"
        d_loss = descriptiveness_loss(out, labels, weights)
    return dw * d_loss, (torch.zeros_like(d_loss), d_loss)


def _tree(out, fn):
    if isinstance(out, (tuple, list)):
        return type(out)(_tree(o, fn) for o in out)
    return fn(out)


def _rawboost(gen: torch.Generator, x: torch.Tensor, cfg) -> torch.Tensor:
    """RawBoost on the step's batch; on a batch split over ranks, the
    draws are made for the global batch and this rank's rows taken (every
    rank draws what one process draws, and the generators stay in
    step)."""
    shard = batch_shard()
    if shard is None or shard.count == 1 or cfg.algo == 0:
        return batch_rawboost(gen, x, cfg)
    n = x.shape[0]
    draws = draw_rawboost(cfg, n * shard.count, x.shape[-1], gen)
    draws = {stage: {k: v[shard.index * n:(shard.index + 1) * n]
                     for k, v in d.items()} for stage, d in draws.items()}
    return process_rawboost(x, draws, cfg)


@contextlib.contextmanager
def _on_mesh(state: TrainState, replicated: bool):
    if state.mesh is None:
        yield
        return
    with compute_mesh(state.mesh), sharded_batch(state.mesh, replicated):
        yield


def _accum(cfg: TrainConfig, global_rows: int) -> int:
    """The micro-batch count of a batch of `global_rows` rows: cfg's
    grad_accum when it divides the batch's group count, else 1."""
    accum = max(1, cfg.grad_accum)
    if accum > 1 and (global_rows // cfg.meta_batch) % accum:
        accum = 1
    return accum


def first_nan(named) -> Optional[str]:
    """The name of the first of `named` ((name, tensor or None) pairs) that
    holds a NaN, else None: one host read for all of them."""
    named = [(n, t) for n, t in named if t is not None and t.numel()]
    if not named:
        return None
    flags = torch.stack([torch.isnan(t).any() for _, t in named]).cpu()
    bad = [n for (n, _), f in zip(named, flags.tolist()) if f]
    return bad[0] if bad else None


def raise_on_nan(state: TrainState, named, what: str) -> None:
    """--debug_nans (JAX's jax_debug_nans): raise FloatingPointError naming
    the first tensor of `named` that holds a NaN. On a mesh every rank
    joins one flag all-reduce, so a NaN in one rank's shard stops them
    all at the same step."""
    bad = first_nan(named)
    mesh = state.mesh
    if mesh is not None and mesh.groups:
        dev = next(iter(state.model.parameters())).device
        if not C.all_reduce_max_flag(bad is not None, mesh.group("world"),
                                     _flag_device(mesh, dev)):
            return
        bad = bad or "a tensor of another rank"
    if bad is not None:
        raise FloatingPointError(
            f"--debug_nans: NaN in {bad} ({what}, optimizer step "
            f"{state.step})")


def _grads_named(state: TrainState):
    return [(f"the gradient of {n}", p.grad)
            for n, p in state.named_params()]


def _params_named(state: TrainState):
    return [(f"the updated parameter {n}", p)
            for n, p in state.named_params()]


def train_step(state: TrainState, x: torch.Tensor, labels: torch.Tensor,
               cfg: TrainConfig, weights: Optional[torch.Tensor] = None,
               lr=None, replicated: bool = False,
               debug_nans: bool = False) -> Dict[str, torch.Tensor]:
    """Forward in train mode, group one-class loss, backward, optimizer
    step. x [G*12, T] and labels [G*12] on the model's device; weights:
    an optional [G*12] 0/1 utterance mask, constant within each
    meta-batch. `lr`: the update's lr as a device tensor (a captured step's
    schedule slot), else the schedule's. Returns the step's {"loss",
    "closs", "dloss"} as device scalars.

    With cfg.rawboost.algo != 0, x is first augmented by `batch_rawboost`,
    whole, from state.generator (before any dropout mask is drawn), as the
    JAX package augments the step's batch before its accumulation split.

    With cfg.grad_accum = a > 1 and a dividing the batch's group count, the
    batch is cut into a micro-batches of whole meta-batches, run one after
    another (BatchNorm statistics chain from one to the next), and each
    one's backward is scaled by its share r_i = sum(w_i) / sum(w) (1/a
    without weights), so the gradients summed in .grad are the big batch's
    and sum_i r_i * loss_i its loss (`occm_tpu/train/loop.py:234-300`). A
    ragged tail whose group count a does not divide takes one pass.

    On a mesh (`state.mesh`, placed by `parallel.place_state_on_mesh`) x,
    labels and weights are this rank's rows of the global batch (ranks of
    one tp group hold the same rows), or with `replicated` the whole batch
    on every rank. The step computes the global batch's step: BatchNorm
    statistics over the data axes, the loss of the gathered outputs,
    dropout masks and RawBoost drawn for the global batch and sliced; the
    fsdp shards are gathered before the forward and the gradients summed
    (reduce-scattered to the shards) over the data axes before the
    optimizer, which updates only this rank's shards. Under grad_accum the
    rank's rows are its parts of each global micro-batch, in order
    (`parallel.sharding.local_rows`).

    With `debug_nans` the step raises FloatingPointError, naming the
    tensor, when its loss or a gradient holds a NaN (before the update)
    or an updated parameter does (after it); the checks only read."""
    state.model.train()
    with _on_mesh(state, replicated):
        swaps = gather_fsdp_params(state) if state.mesh is not None else []
        metrics = _step_body(state, x, labels, cfg, weights)
        if state.mesh is not None:
            reduce_gradients(state, swaps, replicated)
    if debug_nans:
        raise_on_nan(state, [("the loss", metrics["loss"])]
                     + _grads_named(state), "before the update")
    state.apply_gradients(lr)
    if debug_nans:
        raise_on_nan(state, _params_named(state), "after the update")
    return metrics


def pipeline_encoder(model, pp: int):
    """The XLSR encoder of `model` that a pipeline of `pp` ranks splits: a
    ValueError unless there is exactly one and pp divides its pp_stages
    (each rank then runs pp_stages / pp consecutive stages)."""
    from occm_tpu_torch.models.xlsr import XLSREncoder

    found = [m for m in model.modules() if isinstance(m, XLSREncoder)]
    if len(found) != 1:
        raise ValueError(f"a pipeline splits one XLSR encoder; the model "
                         f"has {len(found)}")
    stages = found[0].cfg.pp_stages
    if stages % pp:
        raise ValueError(
            f"a mesh with pp={pp} runs pp_stages in blocks of S / pp per "
            f"rank: pp={pp} must divide pp_stages={stages}")
    return found[0]


class _Stage:
    """This rank's stages of the GPipe schedule over the XLSR layers on a
    mesh with pp = P > 1. The encoder runs their forward
    (`XLSREncoder.stage_forward`, on the mesh's pp group); this runs their
    backward and hands the last rank's generator, metrics and BatchNorm
    statistics to the pipeline."""

    def __init__(self, state, device):
        self.group, P, self.s = pp_group()
        self.enc = pipeline_encoder(state.model, P)
        self.last = self.s == P - 1
        self.src = pp_peer(state.mesh, P - 1)
        self.device = device

    def backward(self) -> None:
        """The (stage, microbatch) runs of the encoder's last forward in
        reverse tick order: each one's backward through its stage's layers
        from its output's gradient (on the pipeline's last stage from the
        loss's backward; from the next stage's input gradient, handed on
        this rank or received from the next), its input's gradient handed
        to the stage before on this rank or sent back to the previous
        rank; rank 0 then runs the frontend's backward once."""
        p, self.enc.stage_pass = self.enc.stage_pass, None
        handed = {}
        for stage, m, h, y, out in reversed(p.parts):
            if out is not None:
                g = out.grad
            elif stage < p.last:
                g = handed.pop(m)
            else:
                g = C.recv(tuple(y.shape), y.dtype, p.next, y.device,
                           p.group)
            torch.autograd.backward(y, g)
            if stage > p.first:
                handed[m] = h.grad
            elif p.prev is not None:
                C.send(h.grad, p.prev, p.group)
        if p.x0 is not None and p.x0.requires_grad:
            p.x0.backward(p.whole.grad)

    def end_of_pass(self, gen) -> None:
        """Every stage takes the last stage's generator (it drew last)."""
        state = gen.get_state()
        gen.set_state(C.broadcast_(state.clone(), self.src, self.group))

    def finish(self, model, metrics):
        """The last stage's metrics and buffers (BatchNorm statistics,
        which only it updates) on every stage of the pipeline."""
        keys = ("loss", "closs", "dloss")
        if self.last:
            vec = torch.stack([metrics[k].float() for k in keys])
        else:
            vec = torch.zeros(3, device=self.device)
        C.broadcast_(vec, self.src, self.group)
        by_dtype: Dict[torch.dtype, list] = {}
        for b in model.buffers():
            by_dtype.setdefault(b.dtype, []).append(b)
        for bufs in by_dtype.values():
            flat = C.broadcast_(torch.cat([b.reshape(-1) for b in bufs]),
                                self.src, self.group)
            offset = 0
            for b in bufs:
                b.copy_(flat[offset:offset + b.numel()].view_as(b))
                offset += b.numel()
        return dict(zip(keys, vec.unbind()))


def _pass(state, x, labels, cfg, weights, scale, stage):
    """One forward and backward (the backward of scale * loss; of the loss
    when scale is None) -> (loss, (c_loss, d_loss)), or None on a
    pipeline stage other than the last."""
    if stage is None:
        loss, aux = _loss(state, x, labels, cfg, weights)
        (loss if scale is None else scale * loss).backward()
        return loss, aux
    gen = state.generator
    out = None
    if stage.last:
        out = _loss(state, x, labels, cfg, weights)
        loss = out[0]
        (loss if scale is None else scale * loss).backward()
    else:
        # the encoder's stage forward alone: no features leave this stage
        stage.enc(x, generator=gen)
    stage.backward()
    stage.end_of_pass(gen)
    return out


def _step_body(state, x, labels, cfg, weights):
    """RawBoost, the forward(s) and backward(s) of train_step; returns its
    metrics, the gradients left in .grad."""
    stage = None
    if state.mesh is not None and state.mesh.shape["pp"] > 1:
        stage = _Stage(state, x.device)
    if cfg.rawboost.algo != 0 and (stage is None or stage.s == 0):
        x = _rawboost(state.generator, x, cfg.rawboost)
    shard = batch_shard()
    count = 1 if shard is None else shard.count
    accum = _accum(cfg, x.shape[0] * count)
    zero = torch.zeros((), device=x.device)
    if accum == 1:
        out = _pass(state, x, labels, cfg, weights, None, stage)
        loss, (c_loss, d_loss) = out or (zero, (zero, zero))
        metrics = {"loss": loss.detach(), "closs": c_loss.detach(),
                   "dloss": d_loss.detach()}
    else:
        mb = x.shape[0] // accum
        if weights is not None:
            # the global batch's weights: the shares are of its sums
            w_all = weights if shard is None else C.all_gather_cat(
                weights, shard.group)
            w_micro = w_all.reshape(count, accum, mb).sum(dim=(0, 2))
            total = torch.clamp(torch.sum(w_all), min=1.0)
        metrics = {}
        for i in range(accum):
            part = slice(i * mb, (i + 1) * mb)
            w_i = None if weights is None else weights[part]
            r_i = 1.0 / accum if w_i is None else w_micro[i] / total
            out = _pass(state, x[part], labels[part], cfg, w_i, r_i, stage)
            loss, (c_loss, d_loss) = out or (zero, (zero, zero))
            for key, value in (("loss", loss), ("closs", c_loss),
                               ("dloss", d_loss)):
                term = r_i * value.detach()
                metrics[key] = term if i == 0 else metrics[key] + term
    if stage is not None:
        metrics = stage.finish(state.model, metrics)
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
    output_kind: str = "dual",
    mesh=None,
    debug_nans: bool = False,
) -> TrainState:
    """Train `model` (an nn.Module whose output `output_kind` names, see
    `train.state.OUTPUT_KINDS`) on `pipeline.epoch(e)` batches of numpy
    (x, labels).

    The model moves to `device` (CUDA unless the caller asks for the CPU).
    checkpoint_fn(state, epoch) runs after every epoch; on_step(step,
    metrics), when given, after every dispatch (one optimizer step, or a
    chunk of k: metrics as device scalars, a chunk's means, with its
    steps' values under "step_loss", "step_closs", "step_dloss" and
    "step_lr"). resume=True continues from cfg.checkpoint_dir's newest
    checkpoint of cfg.checkpoint_prefix (`train.checkpoint.find_resume`,
    the JAX package's rule): an epoch checkpoint, the port's
    `<prefix>_<e>.pt` or the JAX package's orbax directory `<prefix>_<e>/`
    (training goes on at epoch e + 1), or a newer step checkpoint,
    `<prefix>_step_<n>.pt` or `<prefix>_step_<n>/`, whose epoch is
    replayed: its consumed dispatches are read from the pipeline and
    skipped without being uploaded, and its running loss sums carry on
    into loss.txt. A JAX directory gives the parameters, BatchNorm
    statistics, Adam's moments and count and the step (strictly: what is
    not this model's or this optimizer's raises ValueError before any
    step); its dropout / RawBoost generator is seeded from cfg.seed and
    the step (`train.checkpoint.resume_seed`), so the continued losses are
    not the JAX run's. The "resume" and "resume_step" events go to the
    logger's jsonl as in JAX. Returns the final TrainState (after a
    SIGTERM, the state it saved).

    Multi-GPU (`mesh`, else `parallel.make_mesh(cfg.mesh)` over the process
    group's ranks; `device` is this rank's): after the resume the state is
    placed on the mesh (each rank keeps its tp / fsdp shards), and every
    step is the global batch's (`train_step`). A pipeline sharded over the
    data axes (`shard_count` > 1, `parallel.data_shard_for_process`) gives
    each rank its own batches, and a ragged tail is repeat-padded to the
    full local shape with a 0/1 weight mask (JAX's multi-process tail);
    an unsharded pipeline gives every rank the global batch, of which it
    takes its rows, and a tail the data axes do not divide is replicated
    on every rank. Only the primary rank writes loss.txt, metrics.jsonl
    and checkpoints (which gather the shards, so every rank calls
    checkpoint_fn). A CUDA graph of k steps captures NCCL's collectives;
    Gloo's cannot be captured, so k > 1 on a card over Gloo raises.

    `debug_nans` (the CLI's --debug_nans, JAX's jax_debug_nans): the first
    step whose loss, gradients or updated parameters hold a NaN raises
    FloatingPointError naming the tensor, before anything of that step is
    logged or checkpointed. An eager step checks inside `train_step`; a
    CUDA graph's chunk after its replay (its steps' losses and the
    parameters after it: a NaN gradient reaches them through the update).
    The checks only read, so a finite run gives the same numbers. Without
    it a NaN run goes on, as in JAX. The logger, unless given, is
    loss.txt's, with wandb when cfg.wandb_project is set."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = make_mesh(cfg.mesh)
    distributed = bool(mesh.groups)
    pp = mesh.shape["pp"]
    if pp > 1:
        if max(1, cfg.steps_per_dispatch) > 1:
            raise ValueError(
                f"steps_per_dispatch={cfg.steps_per_dispatch} with pp={pp}: "
                "the pipeline's point-to-point exchanges are not captured "
                "in a CUDA graph yet (ROADMAP queue A item 16, pp under a "
                "CUDA graph); train with steps_per_dispatch 1")
        pipeline_encoder(model, pp)
    if not multihost.is_primary():
        logger = MetricsLogger(loss_txt=None, jsonl=None)
    logger = logger or MetricsLogger(loss_txt=cfg.loss_txt,
                                     wandb_project=cfg.wandb_project)
    k = max(1, cfg.steps_per_dispatch)
    graphed = dev.type == "cuda" and k > 1
    if graphed and distributed and mesh.backend() == "gloo":
        raise ValueError(
            f"steps_per_dispatch={k} on a card needs its collectives inside "
            "a CUDA graph, and Gloo's cannot be captured: train over NCCL "
            "(one rank per GPU) or with steps_per_dispatch 1")
    state = create_train_state(model.to(dev), cfg, output_kind)

    start_epoch, progress = 0, None
    if resume:
        from occm_tpu_torch.train.checkpoint import find_resume, restore

        epoch_ckpt, step_ckpt = find_resume(cfg.checkpoint_dir,
                                            cfg.checkpoint_prefix)
        if epoch_ckpt is not None:
            if step_ckpt is None:  # else the step checkpoint replaces it
                restore(state, epoch_ckpt, cfg)
            start_epoch = epoch_ckpt.number + 1
            logger.log_jsonl(event="resume", epoch=start_epoch)
        # a step checkpoint not older than the last epoch checkpoint wins:
        # its epoch is replayed up to it
        if step_ckpt is not None:
            progress = restore(state, step_ckpt, cfg)
            start_epoch = int(progress["epoch"])
            logger.log_jsonl(event="resume_step", epoch=start_epoch,
                             opt_steps=int(progress["opt_steps"]))

    if distributed:
        place_state_on_mesh(state, mesh)
    n_data = data_parallel_size(mesh) if distributed else 1
    sharded_epoch = getattr(pipeline, "shard_count", 1) > 1
    if n_data > 1 and sharded_epoch and pipeline.shard_count != n_data:
        raise ValueError(
            f"the pipeline's epoch is in {pipeline.shard_count} shards, the "
            f"mesh's data axes in {n_data}")

    runner = None
    if graphed:
        from occm_tpu_torch.train.graph import GraphedSteps

        runner = state.graph = GraphedSteps(state, cfg, k)

    def upload(a, dtype):
        return torch.as_tensor(a).to(dtype).to(dev, non_blocking=True)

    full = cfg.groups_per_step * cfg.meta_batch

    def local(x, labels):
        """This rank's rows of one batch: (x, labels, weights,
        replicated)."""
        if n_data == 1:
            return x, labels, None, False
        if sharded_epoch:
            w = None
            if x.shape[0] != full:
                # repeat whole meta-batches to the full local shape; the
                # weights zero the padding, so the update is the mean over
                # the real groups
                m = x.shape[0]
                reps = -(-full // m)
                x = np.concatenate([x] * reps)[:full]
                labels = np.concatenate([labels] * reps)[:full]
                w = np.concatenate([np.ones((m,), np.float32),
                                    np.zeros((full - m,), np.float32)])
            return x, labels, w, False
        accum = _accum(cfg, x.shape[0])
        if x.shape[0] % (n_data * accum):
            # a ragged tail the data axes do not divide: every rank takes it
            # whole (the gradient sums are divided by the data-axis size)
            return x, labels, None, True
        i = data_index(mesh)
        return (local_rows(x, i, n_data, accum),
                local_rows(labels, i, n_data, accum), None, False)

    def dispatch(kind, x, labels):
        if kind == "single":
            x, labels, w, rep = local(x, labels)
            return train_step(state, upload(x, torch.float32),
                              upload(labels, torch.long), cfg,
                              None if w is None else upload(w, torch.float32),
                              replicated=rep, debug_nans=debug_nans)
        parts = [local(x[i], labels[i]) for i in range(k)]
        rep = parts[0][3]
        if runner is not None:
            metrics = runner.run(np.stack([p[0] for p in parts]),
                                 np.stack([p[1] for p in parts]), rep)
            if debug_nans:
                first = state.step - k
                raise_on_nan(state, [
                    (f"the loss of step {first + i}", loss)
                    for i, loss in enumerate(metrics["step_loss"])]
                    + _params_named(state), "after a CUDA graph's chunk")
            return metrics
        steps = [train_step(state, upload(xi, torch.float32),
                            upload(li, torch.long), cfg, replicated=rep,
                            debug_nans=debug_nans)
                 for xi, li, _, _ in parts]  # on the CPU: k eager steps
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
                if every > 0 and distributed:
                    # a SIGTERM seen by one rank stops them all here
                    sigterm[0] = C.all_reduce_max_flag(
                        sigterm[0], mesh.group("world"), _flag_device(mesh,
                                                                      dev))
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


def _flag_device(mesh, dev: torch.device) -> torch.device:
    """Where a rank's small host-decided collectives run: its card under
    NCCL, the CPU under Gloo."""
    return dev if mesh.backend() == "nccl" else torch.device("cpu")


def _fold(pending, running) -> None:
    for m, w in pending:
        for key in running:
            running[key] += float(m[key]) * w
    pending.clear()
