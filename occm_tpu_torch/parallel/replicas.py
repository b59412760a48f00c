"""Data-parallel scoring over the local devices of one process: the port's
counterpart of the JAX package's 1-axis ("dp",) scoring mesh
(`occm_tpu/classify/scoring.py:45` `make_dp_mesh`) and of the reference's
`DataParallel` at inference (reference: oc_classifier.py:343).

A `DPMesh` is a list of torch devices. The model is replicated on each
(`replicate`), every batch is split into equal row blocks, block i runs
on device i, and the outputs are gathered on the first device in order
(`DataParallel`). CUDA launches are asynchronous, so the blocks of one
batch run on their devices together. The CPU tests pass `[cpu, cpu]` as
the JAX tests pass virtual CPU devices.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DPMesh:
    """One data-parallel axis over local devices."""

    devices: Tuple[torch.device, ...]

    axis_names = ("dp",)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_dp_mesh(num_devices: Optional[int] = None,
                 device_type: str = "cuda") -> DPMesh:
    """A data-parallel mesh over the first `num_devices` local GPUs (all of
    them by default); raises when more are asked for than are present, as
    the JAX package's make_dp_mesh does. device_type "cpu": the CPU, which
    is one device."""
    if device_type == "cpu":
        devs = [torch.device("cpu")]
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if num_devices is not None:
        if num_devices > len(devs):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devs)} present")
        devs = devs[:num_devices]
    if not devs:
        raise ValueError(f"no {device_type} device present")
    return DPMesh(tuple(devs))


def as_dp_mesh(mesh) -> DPMesh:
    """A DPMesh from a DPMesh or a flat sequence of devices; a mesh of
    more than one axis (or a nested sequence) raises ValueError, as the
    JAX embedder refuses one."""
    if isinstance(mesh, DPMesh):
        return mesh
    names = getattr(mesh, "axis_names", None)
    if names is not None and len(names) != 1:
        raise ValueError(
            f"scoring mesh must have exactly one axis, got {names}")
    if isinstance(mesh, (list, tuple)) and mesh and all(
            isinstance(d, (str, torch.device)) for d in mesh):
        return DPMesh(tuple(torch.device(d) for d in mesh))
    raise ValueError(
        f"scoring mesh must have exactly one axis of devices, got {mesh!r}")


def replicate(model: torch.nn.Module, mesh: DPMesh) -> List[torch.nn.Module]:
    """The model on every mesh device: itself where it already lies, a
    copy elsewhere (in eval mode, as the scorer runs it)."""
    here = next(model.parameters()).device
    return [model if torch.device(d) == here
            else copy.deepcopy(model).to(d).eval() for d in mesh.devices]


def round_up(batch: int, mesh: DPMesh) -> int:
    """The batch size rounded up to a multiple of the mesh size."""
    n = mesh.size
    return ((batch + n - 1) // n) * n


class DataParallel:
    """x [B, ...] -> the outputs of fns[i] on row block i (on device i),
    concatenated in order on the first device. B must divide by the mesh
    size (the embedders round their batch up to it)."""

    def __init__(self, fns: Sequence[Callable], mesh: DPMesh):
        if len(fns) != mesh.size:
            raise ValueError(f"{len(fns)} functions for {mesh.size} devices")
        self.fns = list(fns)
        self.mesh = mesh

    def __call__(self, x: torch.Tensor):
        n = self.mesh.size
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not divide over "
                             f"{n} devices")
        rows = x.shape[0] // n
        outs = [fn(x[i * rows:(i + 1) * rows].to(dev, non_blocking=True))
                for i, (fn, dev) in enumerate(zip(self.fns,
                                                  self.mesh.devices))]
        first = self.mesh.devices[0]
        return tuple(torch.cat([o[j].to(first) for o in outs])
                     for j in range(len(outs[0])))


def per_device(fn, mesh: DPMesh) -> DataParallel:
    """A DataParallel from one callable for every device (one that runs
    where its input lies) or a list of one per device."""
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn] * mesh.size
    return DataParallel(fns, mesh)
