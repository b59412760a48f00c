"""Process-group initialisation (port of `occm_tpu.parallel.multihost`).

A torch rank is one process that owns one device. `initialize()` joins the
process group once, from the `torchrun` environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR` / `MASTER_PORT`) or from explicit arguments,
and returns the rank's device: `cuda:LOCAL_RANK` for "cuda" (set as the
current device), the CPU for "cpu", or the device named in full. The
backend follows the device: NCCL for CUDA, Gloo for the CPU, unless the
caller names one (the one-card checks run two ranks on `cuda:0` over Gloo,
because NCCL refuses two ranks of one communicator on one device).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _rank_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize(device="cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None) -> torch.device:
    """Join the default process group (idempotent: a second call only
    returns the device) and return this rank's device.

    init_method / world_size / rank: explicit values (for example
    "tcp://localhost:29500", 2, 0); each one left None is read from the
    torchrun environment ("env://", WORLD_SIZE, RANK)."""
    from occm_tpu_torch.utils.device import resolve_device

    dev = _rank_device(resolve_device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    kwargs = {}
    if backend == "nccl":
        # binds the communicator to the rank's device up front
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The world size (1 without a process group)."""
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that writes checkpoints and logs."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if is_initialized():
        dist.barrier()
