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
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

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


def jax_checkpoint_dirs(directory: str, prefix: str):
    """The JAX package's checkpoints of `prefix` in `directory`: its
    `<prefix>_<epoch>` and `<prefix>_step_<n>` orbax directories, sorted
    (train(resume=True) does not continue from them)."""
    from occm_tpu_torch.train.orbax import is_orbax_dir

    if not os.path.isdir(directory):
        return []
    pattern = re.compile(re.escape(prefix) + r"_(step_)?\d+$")
    return sorted(name for name in os.listdir(directory)
                  if pattern.match(name)
                  and is_orbax_dir(os.path.join(directory, name)))


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


def restore_step_checkpoint(state, directory: str, prefix: str,
                            opt_steps: int,
                            min_epoch: int = 0) -> Optional[Dict]:
    """Restore a step checkpoint into `state` if its epoch is at least
    `min_epoch` (not older than the epoch checkpoint already restored);
    returns its progress, or None when it was older and left unused."""
    payload = _load(step_checkpoint_path(directory, prefix, opt_steps))
    progress = payload["progress"]
    if int(progress["epoch"]) < min_epoch:
        return None
    _apply(state, payload)
    return progress
