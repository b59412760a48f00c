"""Per-epoch checkpoints (port of `occm_tpu.train.checkpoint.save_checkpoint`
to the reference's file scheme).

`<dir>/<prefix>_<epoch>.pt` holds {"model": the model's state dict in the
reference's naming, "optimizer": the optimizer state keyed by parameter
name, "step": the step count}. `load_reference_state_dict` (and so
`oc_server --pretrained-sslaasist`) unwraps "model" and loads it as it is.
Resume is not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import os

import torch


def checkpoint_path(directory: str, prefix: str, epoch: int) -> str:
    return os.path.abspath(os.path.join(directory, f"{prefix}_{epoch}.pt"))


def save_checkpoint(state, directory: str, prefix: str, epoch: int) -> str:
    """Write one epoch's checkpoint (tensors moved to the CPU); returns
    its path. The file is written under a temporary name and renamed, so
    a run killed mid-save leaves no truncated checkpoint."""
    path = checkpoint_path(directory, prefix, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def cpu(tree):
        return {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                    else cpu(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}

    payload = {"model": cpu(state.model.state_dict()),
               "optimizer": cpu(state.optimizer_state()),
               "step": state.step}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path
