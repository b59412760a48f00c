"""Epoch and step checkpoints, and resume (port of
`occm_tpu.train.checkpoint` to the reference's `.pt` file scheme).

`<dir>/<prefix>_<epoch>.pt` holds {"model": the model's state dict in the
reference's naming, "optimizer": the optimizer state keyed by parameter
name, "step": the step count (restored on the host and on the device),
"rng": the dropout generator's state}.
`load_reference_state_dict` (and so `oc_server --pretrained-sslaasist`)
unwraps "model" and loads it as it is. A step checkpoint,
`<dir>/<prefix>_step_<opt_steps>.pt`, holds the same and the epoch's
progress (epoch, dispatches consumed, optimizer steps, running loss sums);
older step checkpoints are deleted only after a newer one is saved. Every
file is written under a temporary name and renamed, so a run killed
mid-save leaves the previous file whole.

On a rank mesh the shards are gathered (a collective: every rank calls
the save) and the primary rank writes the file, in exactly the
single-GPU format, so a dp / fsdp / tp / pp checkpoint scores and
resumes on one GPU: under pp each stage's layers (and their moments) are
broadcast from the stage that owns them, and the BatchNorm statistics,
which only the last stage updates, are the last stage's (the train step
broadcasts them to its pipeline). Restoring into a placed state gathers
the parameters whole, loads the checkpoint, and places it again, so a
one-GPU checkpoint resumes sharded.

Resume (`find_resume`, `restore`) reads these files and the JAX package's
own checkpoints of the prefix (`occm_tpu.train.checkpoint`): the orbax
directories `<dir>/<prefix>_<epoch>/` and `<dir>/<prefix>_step_<n>/`, whose
trees hold {"params", "batch_stats", "opt_state", "step"} and, in a step
directory, "progress" (the .pt files' progress keys). A directory is read
by `train.orbax.restore_tree` (no orbax, no JAX) and bridged: the
parameters and BatchNorm statistics through `models.convert.
state_dict_from_flax`, loaded strictly; Adam's moments and count through
`optimizer_state_from_flax`, every parameter of the tree given its mu and
nu; the step on the host and the device. Nothing is partial: a directory
of weights only, an optimizer state of another --optimizer /
--lr_schedule, a moment that is missing or of another shape, or a tree of
another model raises a ValueError that names the directory and the leaf.
A JAX PRNG key has no torch counterpart, so the dropout and RawBoost
generator of a run continued from a directory is seeded from cfg.seed and
the restored step (`resume_seed`): two resumes of one directory draw the
same masks, which are not the JAX run's. The JAX directories are only
read: nothing here writes, renames or deletes them (step-checkpoint
pruning removes `.pt` files only).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from occm_tpu_torch.parallel import multihost
from occm_tpu_torch.parallel.sharding import (
    full_optimizer_state, full_parameters, place_state_on_mesh,
    unplace_state)


def checkpoint_path(directory: str, prefix: str, epoch: int) -> str:
    return os.path.abspath(os.path.join(directory, f"{prefix}_{epoch}.pt"))


def step_checkpoint_path(directory: str, prefix: str, opt_steps: int) -> str:
    return os.path.abspath(
        os.path.join(directory, f"{prefix}_step_{opt_steps}.pt"))


def _cpu(tree):
    return {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                else _cpu(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}


def _payload(state) -> Dict:
    """The state whole (its shards gathered on a mesh), on the CPU."""
    with full_parameters(state):
        model = _cpu(state.model.state_dict())
    return {"model": model,
            "optimizer": _cpu(full_optimizer_state(state)),
            "step": state.step,
            "rng": state.generator.get_state()}


def _write(payload: Dict, path: str) -> str:
    """The primary rank writes; every rank waits for the file."""
    if multihost.is_primary():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    multihost.barrier()
    return path


def save_checkpoint(state, directory: str, prefix: str, epoch: int) -> str:
    """Write one epoch's checkpoint (tensors moved to the CPU); returns
    its path."""
    return _write(_payload(state), checkpoint_path(directory, prefix, epoch))


def _latest(directory: str, pattern: "re.Pattern") -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    found = [int(m.group(1)) for m in map(pattern.match,
                                          os.listdir(directory)) if m]
    return max(found) if found else None


def latest_epoch(directory: str, prefix: str) -> Optional[int]:
    """The newest `<prefix>_<epoch>.pt` epoch, or None."""
    return _latest(directory, re.compile(re.escape(prefix) + r"_(\d+)\.pt$"))


def jax_checkpoint_dirs(directory: str, prefix: str) -> List[str]:
    """The JAX package's checkpoints of `prefix` in `directory`: its
    `<prefix>_<epoch>` and `<prefix>_step_<n>` orbax directories, sorted
    by name."""
    from occm_tpu_torch.train.orbax import is_orbax_dir

    if not os.path.isdir(directory):
        return []
    pattern = re.compile(re.escape(prefix) + r"_(step_)?\d+$")
    return sorted(name for name in os.listdir(directory)
                  if pattern.match(name)
                  and is_orbax_dir(os.path.join(directory, name)))


def _latest_jax(directory: str, prefix: str, step: bool) -> Optional[int]:
    """The newest epoch (or step checkpoint's n) of the prefix's JAX
    directories, or None."""
    pattern = re.compile(re.escape(prefix) + (r"_step_(\d+)$" if step
                                              else r"_(\d+)$"))
    found = [int(m.group(1)) for m in map(
        pattern.match, jax_checkpoint_dirs(directory, prefix)) if m]
    return max(found) if found else None


def _step_re(prefix: str) -> "re.Pattern":
    return re.compile(re.escape(prefix) + r"_step_(\d+)\.pt$")


def latest_step_checkpoint(directory: str, prefix: str) -> Optional[int]:
    """opt_steps of the newest `<prefix>_step_*.pt`, or None."""
    return _latest(directory, _step_re(prefix))


def save_step_checkpoint(state, directory: str, prefix: str,
                         progress: Dict) -> str:
    """Mid-epoch (pre-emption-safe) checkpoint of the whole state and the
    epoch's progress, under `<prefix>_step_<progress["opt_steps"]>.pt`;
    older step checkpoints are deleted only after it is saved."""
    n = int(progress["opt_steps"])
    path = _write({**_payload(state), "progress": dict(progress)},
                  step_checkpoint_path(directory, prefix, n))
    if multihost.is_primary():
        pattern = _step_re(prefix)
        for name in os.listdir(directory):
            m = pattern.match(name)
            if m and int(m.group(1)) != n:
                os.remove(os.path.join(directory, name))
    multihost.barrier()
    return path


def _apply(state, payload: Dict) -> None:
    """Load a checkpoint's payload into `state` in place (parameters,
    BatchNorm statistics, optimizer state, step, generator); a state
    placed on a mesh is gathered whole, loaded and placed again."""
    placed = bool(state.placements)
    if placed:
        unplace_state(state)
    state.model.load_state_dict(payload["model"], strict=True)
    state.load_optimizer_state(payload["optimizer"])
    state.set_step(int(payload["step"]))
    if "rng" in payload:
        state.generator.set_state(payload["rng"])
    if placed:
        place_state_on_mesh(state, state.mesh)


def _load(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(state, directory: str, prefix: str,
                       epoch: Optional[int] = None) -> Tuple[object, int]:
    """Restore an epoch checkpoint (the newest when epoch is None) into
    `state`; returns (state, epoch)."""
    if epoch is None:
        epoch = latest_epoch(directory, prefix)
        if epoch is None:
            raise FileNotFoundError(
                f"no checkpoints matching {prefix}_*.pt in {directory}")
    _apply(state, _load(checkpoint_path(directory, prefix, epoch)))
    return state, epoch


@dataclasses.dataclass(frozen=True)
class Found:
    """A checkpoint that resume restores: a `.pt` file of the port or an
    orbax directory of the JAX package (`jax`), its epoch or, for a step
    checkpoint, its opt_steps (`number`), and a step checkpoint's
    progress."""
    path: str
    jax: bool
    number: int
    progress: Optional[Dict] = None


PROGRESS_INTS = ("epoch", "dispatches", "opt_steps")
PROGRESS_SUMS = ("running_loss", "running_closs", "running_dloss")


def _progress_values(progress: Mapping, path: str) -> Dict:
    """A step checkpoint's progress as Python numbers (a JAX directory
    holds them as 0-d int32 / float32 arrays)."""
    for key in PROGRESS_INTS + PROGRESS_SUMS:
        if key not in progress:
            raise ValueError(f"resume: {path}: its progress has no {key!r}")
    out = {k: int(np.asarray(progress[k])) for k in PROGRESS_INTS}
    out.update({k: float(np.asarray(progress[k])) for k in PROGRESS_SUMS})
    return out


def _pt_progress(path: str) -> Dict:
    """A step .pt's progress (the file is mapped, not read whole)."""
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)["progress"]


def _check_trainer_keys(path: str, keys, step: bool) -> None:
    """A JAX trainer checkpoint's top-level keys, or a ValueError that
    says what the directory is instead."""
    keys = set(keys)
    need = ["params", "batch_stats", "opt_state", "step"]
    if step:
        need.append("progress")
    if "opt_state" not in keys:
        raise ValueError(
            f"resume: {path} holds weights only (top-level keys "
            f"{sorted(keys)[:6]}, no 'opt_state'), not a trainer checkpoint "
            "of the JAX package: there is no optimizer state, step or "
            "epoch to continue. Start from its weights with --init_from "
            f"{path} (a fresh optimizer at epoch 0) instead of --resume")
    missing = [k for k in need if k not in keys]
    if missing:
        raise ValueError(f"resume: {path} is not a trainer checkpoint of the "
                         f"JAX package: it has no {missing[0]!r}")


def _jax_progress(path: str) -> Dict:
    """A JAX step directory's progress (no other array is read)."""
    from occm_tpu_torch.train.orbax import restore_tree, top_level_keys

    _check_trainer_keys(path, top_level_keys(path), step=True)
    return _progress_values(restore_tree(path, subtree="progress"), path)


def find_resume(directory: str, prefix: str
                ) -> Tuple[Optional[Found], Optional[Found]]:
    """(epoch checkpoint, step checkpoint) that resume restores, by the
    JAX package's rule (`occm_tpu.train.loop.train`) over the `.pt` files
    and the JAX directories of `prefix` together: the newest epoch
    checkpoint, then the newest step checkpoint (by its progress' epoch
    and opt_steps) if its epoch is not older than the epoch after that
    one; its epoch is then replayed up to it, and the epoch checkpoint is
    not read. Where a `.pt` and a JAX directory tie, the `.pt` wins: only
    a port run that continued from the directory can have written it.
    Either is None when there is none."""
    def jax_path(name):
        return os.path.abspath(os.path.join(directory, name))

    epochs, steps = [], []
    e = latest_epoch(directory, prefix)
    if e is not None:
        epochs.append(Found(checkpoint_path(directory, prefix, e), False, e))
    e = _latest_jax(directory, prefix, step=False)
    if e is not None:
        epochs.append(Found(jax_path(f"{prefix}_{e}"), True, e))
    epoch = max(epochs, key=lambda f: (f.number, not f.jax), default=None)
    n = latest_step_checkpoint(directory, prefix)
    if n is not None:
        path = step_checkpoint_path(directory, prefix, n)
        steps.append(Found(path, False, n, _pt_progress(path)))
    n = _latest_jax(directory, prefix, step=True)
    if n is not None:
        path = jax_path(f"{prefix}_step_{n}")
        steps.append(Found(path, True, n, _jax_progress(path)))
    step = max(steps, default=None, key=lambda f: (
        int(f.progress["epoch"]), int(f.progress["opt_steps"]), not f.jax))
    start = epoch.number + 1 if epoch is not None else 0
    if step is not None and int(step.progress["epoch"]) < start:
        step = None
    return epoch, step


def restore(state, found: Found, cfg) -> Optional[Dict]:
    """Restore `found` (of `find_resume`) into `state` in place; returns a
    step checkpoint's progress, None for an epoch checkpoint."""
    if found.jax:
        return restore_jax_checkpoint(state, found.path, cfg)
    payload = _load(found.path)
    _apply(state, payload)
    return payload.get("progress")


def resume_seed(seed: int, step: int) -> int:
    """The seed of the dropout and RawBoost generator of a run continued
    from a JAX directory at `step` (a JAX PRNG key has no torch
    counterpart): (seed * 2**32 + step) mod 2**64."""
    return (int(seed) * 2**32 + int(step)) % 2**64


def _xlsr_cfg_of(model):
    """The XLSRConfig of the model's SSL frontend (XLSRConfig() if it has
    none: the bare backends)."""
    from occm_tpu_torch.config import XLSRConfig

    for module in model.modules():
        cfg = getattr(module, "cfg", None)
        if isinstance(cfg, XLSRConfig):
            return cfg
    return XLSRConfig()


def _leaf_shapes(tree, prefix: str = ""):
    """(path, shape) of every array leaf of a tree of dicts and lists."""
    if isinstance(tree, Mapping):
        for k in sorted(tree, key=str):
            yield from _leaf_shapes(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_shapes(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tuple(tree.shape) if isinstance(
            tree, torch.Tensor) else tuple(np.shape(tree))


def _same_leaves(want, got, what: str, path: str) -> None:
    """The leaves of `got` (named `what`) are those of the parameters
    `want`, at their shapes; else a ValueError naming the first one."""
    want, got = dict(_leaf_shapes(want)), dict(_leaf_shapes(got))
    for leaf in sorted(set(want) | set(got)):
        if leaf not in got:
            raise ValueError(f"resume: {path}: {what} has no leaf {leaf} "
                             f"(params{leaf} has one)")
        if leaf not in want:
            raise ValueError(f"resume: {path}: {what}{leaf} has no "
                             "parameter")
        if got[leaf] != want[leaf]:
            raise ValueError(f"resume: {path}: {what}{leaf} has shape "
                             f"{got[leaf]}, params{leaf} {want[leaf]}")


def _same_state(sd: Mapping, model_sd: Mapping, path: str) -> None:
    """The bridged state dict has the model's names and shapes; else a
    ValueError naming the first tensor that is missing or differs."""
    for name in sorted(set(sd) | set(model_sd)):
        if name not in sd:
            raise ValueError(f"resume: {path} is not a checkpoint of this "
                             f"model: it has no {name!r}")
        if name not in model_sd:
            raise ValueError(f"resume: {path} is not a checkpoint of this "
                             f"model: the model has no {name!r}")
        if tuple(sd[name].shape) != tuple(model_sd[name].shape):
            raise ValueError(
                f"resume: {path} is not a checkpoint of this model: "
                f"{name!r} has shape {tuple(sd[name].shape)}, the model's "
                f"{tuple(model_sd[name].shape)}")


def restore_jax_checkpoint(state, path: str, cfg) -> Optional[Dict]:
    """Restore one of the JAX package's trainer directories (an epoch
    `<prefix>_<e>/` or a step `<prefix>_step_<n>/`) into `state` in place:
    the parameters and BatchNorm statistics (strictly; the positional
    conv's kernel as the directory holds it, bit for bit), Adam's moments
    and count (every parameter of the tree's; the form must be the one
    cfg.optimizer and cfg.lr_schedule build), the step, and the generator
    seeded by `resume_seed`. A state placed on a mesh is gathered whole,
    loaded and placed again. Returns a step directory's progress, else
    None. Raises ValueError, naming the directory, before anything is
    loaded when the directory is not a trainer checkpoint of this model
    and optimizer (see the module docstring)."""
    from occm_tpu_torch.models.convert import (
        FLAX_OPTIMIZER_FORMS, flax_optimizer_form, optimizer_state_from_flax,
        state_dict_from_flax)
    from occm_tpu_torch.train.orbax import restore_tree, top_level_keys

    path = os.path.abspath(path)
    keys = top_level_keys(path)
    is_step = "progress" in keys
    _check_trainer_keys(path, keys, is_step)
    tree = restore_tree(path)
    progress = _progress_values(tree["progress"], path) if is_step else None
    try:
        form, (_, mu, nu), _ = flax_optimizer_form(tree["opt_state"])
    except ValueError as e:
        raise ValueError(f"resume: {path}: opt_state is {e}") from None
    want = ("fused_adam" if cfg.optimizer == "fused_adam" else
            "adam" if cfg.lr_schedule == "constant" else "adam_schedule")
    if form != want:
        raise ValueError(
            f"resume: {path} holds the optimizer state of "
            f"{FLAX_OPTIMIZER_FORMS[form]}, and this run's --optimizer "
            f"{cfg.optimizer} --lr_schedule {cfg.lr_schedule} takes "
            f"{FLAX_OPTIMIZER_FORMS[want]}")
    for key, moments in (("mu", mu), ("nu", nu)):
        _same_leaves(tree["params"], moments, f"opt_state {key}", path)
    xlsr_cfg = _xlsr_cfg_of(state.model)
    variables = {"params": tree["params"],
                 "batch_stats": tree["batch_stats"] or {}}
    try:
        sd = state_dict_from_flax(variables, xlsr_cfg)
    except (KeyError, IndexError, ValueError) as e:
        why = f"the bridge found no leaf {e}" if isinstance(e, KeyError) \
            else str(e)
        raise ValueError(f"resume: {path} is not a checkpoint of this "
                         f"model: {why}") from None
    try:  # the schedule's count must be Adam's
        opt = optimizer_state_from_flax(tree["opt_state"], xlsr_cfg)
    except ValueError as e:
        raise ValueError(f"resume: {path}: {e}") from None
    placed = bool(state.placements)
    if placed:
        unplace_state(state)
    _same_state(sd, state.model.state_dict(), path)
    state.model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        # the positional conv trains the directory's kernel w itself: set
        # it from weight_v = w (the weight-norm pair's fold rounds it)
        for name, p in state.model.named_parameters():
            if name.endswith("pos_conv.0.weight"):
                p.copy_(sd[name + "_v"])
    try:
        state.load_optimizer_state(opt)
    except ValueError as e:
        raise ValueError(f"resume: {path}: {e}") from None
    step = int(np.asarray(tree["step"]))
    state.set_step(step)
    state.generator.manual_seed(resume_seed(cfg.seed, step))
    if placed:
        place_state_on_mesh(state, state.mesh)
    return progress
