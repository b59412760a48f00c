"""Epoch and step checkpoints, and resume (port of
`occm_tpu.train.checkpoint` to the reference's `.pt` file scheme).

`<dir>/<prefix>_<epoch>.pt` holds {"model": the model's state dict in the
reference's naming, "optimizer": the optimizer state keyed by parameter
name, "step": the step count, "rng": the dropout generator's state}.
`load_reference_state_dict` (and so `oc_server --pretrained-sslaasist`)
unwraps "model" and loads it as it is. A step checkpoint,
`<dir>/<prefix>_step_<opt_steps>.pt`, holds the same and the epoch's
progress (epoch, dispatches consumed, optimizer steps, running loss sums);
older step checkpoints are deleted only after a newer one is saved. Every
file is written under a temporary name and renamed, so a run killed
mid-save leaves the previous file whole.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import torch


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
    return {"model": _cpu(state.model.state_dict()),
            "optimizer": _cpu(state.optimizer_state()),
            "step": state.step,
            "rng": state.generator.get_state()}


def _write(payload: Dict, path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
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
    pattern = _step_re(prefix)
    for name in os.listdir(directory):
        m = pattern.match(name)
        if m and int(m.group(1)) != n:
            os.remove(os.path.join(directory, name))
    return path


def _apply(state, payload: Dict) -> None:
    """Load a checkpoint's payload into `state` in place (parameters,
    BatchNorm statistics, optimizer state, step, generator)."""
    state.model.load_state_dict(payload["model"], strict=True)
    state.load_optimizer_state(payload["optimizer"])
    state.step = int(payload["step"])
    if "rng" in payload:
        state.generator.set_state(payload["rng"])


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
