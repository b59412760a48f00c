"""The (dp, pp, fsdp, tp) mesh over torch.distributed ranks (port of
`occm_tpu.parallel.mesh`).

The JAX package lays one `jax.sharding.Mesh` over devices, and a JAX
process may own several of them. A torch rank is one process that owns
one device, so here the mesh lays the world's RANKS out as
`reshape(dp, pp, fsdp, tp)`, in the JAX order (`mesh.py:86`), and builds
one process group per axis for the rank, plus the group of its data axes:

- dp: the batch shards over it; the gradients are summed over it;
- fsdp: ZeRO-3 sharding: parameters and Adam moments are sharded over it
  (`sharding.py`) while the batch ALSO shards over it (an fsdp group is a
  data-parallel group whose weights are gathered before use);
- tp: Megatron tensor parallelism inside the XLSR layers (heads and FFN
  columns, and with `seq_parallel` the residual path on 1/tp of the
  frames); the ranks of one tp group hold the same batch;
- pp: the GPipe pipeline: stage s of a pp group owns the s-th contiguous
  block of the XLSR layers and passes microbatches to stage s + 1
  (`pp_peer`); the ranks of one pipeline hold the same batch.

A group is the WORLD group when it spans every rank (so at world size 1
under NCCL the data-axis collectives still run, and a CUDA graph captures
them), None when it holds only this rank, and a `new_group` otherwise.
Without a process group (one process, nothing initialised) every group is
None and nothing communicates.

`compute_mesh` / `current_mesh` are the registry the models read the mesh
from (tp inside the layers), and `batch_shard` the one the BatchNorm
layers, the loss and the dropout masks read the step's batch split from
(`sharded_batch`, entered by the train step).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from occm_tpu_torch.config import MeshConfig
from occm_tpu_torch.parallel import multihost

AXES = ("dp", "pp", "fsdp", "tp")

_ACTIVE_MESHES: list = []
_ACTIVE_BATCH: list = []


@dataclasses.dataclass
class Mesh:
    """The rank layout and this rank's process groups."""

    #: axis -> size, in AXES order
    shape: Dict[str, int]
    #: [dp, pp, fsdp, tp] array of global ranks
    ranks: np.ndarray
    #: this process's rank
    rank: int
    #: "dp", "pp", "fsdp", "tp", "data" (dp x fsdp) and "world" -> this
    #: rank's group (None where the group is this rank alone; empty when
    #: nothing is initialised)
    groups: Dict[str, Optional[object]] = dataclasses.field(
        default_factory=dict)

    axis_names = AXES

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """rank (this one by default) -> its index on every axis."""
        rank = self.rank if rank is None else rank
        idx = np.argwhere(self.ranks == rank)[0]
        return {a: int(i) for a, i in zip(AXES, idx)}

    def group(self, axis: str):
        return self.groups.get(axis)

    def backend(self) -> Optional[str]:
        """The process group's backend ("nccl", "gloo"), or None."""
        if not multihost.is_initialized():
            return None
        return str(dist.get_backend())


def _subgroups(ranks: np.ndarray, axes: Tuple[str, ...]) -> List[List[int]]:
    """Every group of ranks that differ only along `axes`, in a fixed
    order (each rank calls new_group for all of them, in that order)."""
    keep = [i for i, a in enumerate(AXES) if a not in axes]
    moved = np.moveaxis(ranks, keep, list(range(len(keep))))
    lead = moved.shape[:len(keep)]
    return [sorted(int(r) for r in moved[idx].reshape(-1))
            for idx in np.ndindex(*lead)]


def make_mesh(cfg: Optional[MeshConfig] = None,
              world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """Lay `world_size` ranks (the process group's, else 1) out as
    reshape(dp, pp, fsdp, tp); dp = -1 takes what the other axes leave.
    Raises JAX's ValueError when the factors do not cover the world.
    Process groups are made only when torch.distributed is initialised
    with this world size; every rank must then call make_mesh, in the
    same order as its other group-making calls."""
    cfg = cfg or MeshConfig()
    n = multihost.process_count() if world_size is None else int(world_size)
    rank = multihost.process_index() if rank is None else int(rank)
    tp = max(1, cfg.tp)
    fsdp = max(1, cfg.fsdp)
    pp = max(1, cfg.pp)
    dp = cfg.dp if cfg.dp > 0 else n // (fsdp * tp * pp)
    if dp * fsdp * tp * pp != n:
        raise ValueError(
            f"mesh {dp}x{fsdp}x{tp}x{pp} (dp x fsdp x tp x pp) does not "
            f"cover {n} devices; set MeshConfig.dp/fsdp/tp/pp to factor "
            "the device count")
    ranks = np.arange(n).reshape(dp, pp, fsdp, tp)
    mesh = Mesh(shape={"dp": dp, "pp": pp, "fsdp": fsdp, "tp": tp},
                ranks=ranks, rank=rank)
    if multihost.is_initialized() and multihost.process_count() == n:
        mesh.groups["world"] = dist.group.WORLD
        for name, axes in (("dp", ("dp",)), ("pp", ("pp",)),
                           ("fsdp", ("fsdp",)), ("tp", ("tp",)),
                           ("data", ("dp", "fsdp"))):
            mesh.groups[name] = None
            for members in _subgroups(ranks, axes):
                if len(members) == n:
                    group = dist.group.WORLD
                elif len(members) > 1:
                    group = dist.new_group(members)
                else:
                    group = None
                if rank in members:
                    mesh.groups[name] = group
    return mesh


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the batch shards over: dp plus (when > 1) fsdp; size-1
    axes are dropped, as in JAX."""
    return tuple(a for a in ("dp", "fsdp") if mesh.shape.get(a, 1) > 1)


def data_spec(mesh: Mesh, leading_none: int = 0) -> Tuple:
    """The batch's placement as JAX writes its PartitionSpec: a batch axis
    over the data axes after `leading_none` unsharded axes (a chunk of k
    steps stacks them on axis 0)."""
    axes = data_axes(mesh)
    entry = axes[0] if len(axes) == 1 else (axes or None)
    return (None,) * leading_none + (entry,)


def batch_sharding(mesh: Mesh) -> Tuple:
    """The leading batch axis over the data axes, replicated over tp."""
    return data_spec(mesh)


def replicated(mesh: Mesh) -> Tuple:
    """The placement of a whole tensor on every rank (JAX's P())."""
    return ()


def data_parallel_size(mesh: Mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def data_index(mesh: Mesh, rank: Optional[int] = None) -> int:
    """A rank's coordinate on the data axes: dp outer, fsdp inner (the
    order of the batch's rows, as JAX's P(("dp", "fsdp"))). It does not
    depend on pp or tp: the stages of one pipeline and the ranks of one
    tp group get the same rows."""
    c = mesh.coords(rank)
    return c["dp"] * mesh.shape["fsdp"] + c["fsdp"]


def data_shard_for_process(mesh: Mesh, process_index: Optional[int] = None
                           ) -> Tuple[int, int]:
    """(shard_index, shard_count) of the GLOBAL batch this rank's input
    pipeline loads: its coordinate on the data axes and their size. Ranks
    of one tp group and the stages of one pipeline (which hold replicas
    of one batch shard) load IDENTICAL data, as JAX's 4 hosts on fsdp=2
    x tp=2 form 2 data shards of 2 hosts each. A rank owns one device,
    so JAX's fallback for a process spanning several data shards never
    arises."""
    count = data_parallel_size(mesh)
    if count == 1:
        return 0, 1
    return data_index(mesh, process_index), count


@contextlib.contextmanager
def compute_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Enter `mesh` for the models' forward (tensor parallelism inside the
    XLSR layers reads it through `current_mesh`)."""
    _ACTIVE_MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESHES.pop()


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh entered through compute_mesh(), or None."""
    return _ACTIVE_MESHES[-1] if _ACTIVE_MESHES else None


def tp_group():
    """(group, size, index) of the current mesh's tp axis when it is > 1,
    else None."""
    mesh = current_mesh()
    if mesh is None or mesh.shape["tp"] == 1:
        return None
    return mesh.group("tp"), mesh.shape["tp"], mesh.coords()["tp"]


def pp_group():
    """(group, size, this rank's pp coordinate) of the current mesh's pp
    axis when it is > 1, else None."""
    mesh = current_mesh()
    if mesh is None or mesh.shape["pp"] == 1:
        return None
    return mesh.group("pp"), mesh.shape["pp"], mesh.coords()["pp"]


def pp_stage(mesh: Optional[Mesh] = None) -> int:
    """This rank's pipeline stage on `mesh` (the current one by default);
    0 without a mesh."""
    mesh = mesh or current_mesh()
    return 0 if mesh is None else mesh.coords()["pp"]


def pp_peer(mesh: Mesh, stage: int, rank: Optional[int] = None) -> int:
    """The global rank of `stage` in the pipeline of `rank` (this one by
    default): the same dp, fsdp and tp coordinates."""
    c = mesh.coords(rank)
    return int(mesh.ranks[c["dp"], stage, c["fsdp"], c["tp"]])


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """The step's batch split: this rank holds rows
    [index * n, (index + 1) * n) of a global batch of count * n rows (n
    its own row count), and `group` (the data axes' group) holds the
    rest."""

    group: object
    index: int
    count: int


@contextlib.contextmanager
def sharded_batch(mesh: Optional[Mesh], replicated: bool = False
                  ) -> Iterator[Optional[BatchShard]]:
    """Enter the step's batch split on `mesh`: the BatchNorm layers reduce
    their statistics over the data group, the loss gathers the outputs,
    and the dropout masks are drawn for the global batch and sliced. With
    `replicated` (a ragged tail every rank holds whole), or without a
    data group, nothing is split."""
    shard = None
    if mesh is not None and not replicated:
        group = mesh.group("data")
        if group is not None:
            shard = BatchShard(group, data_index(mesh),
                               data_parallel_size(mesh))
    _ACTIVE_BATCH.append(shard)
    try:
        yield shard
    finally:
        _ACTIVE_BATCH.pop()


def batch_shard() -> Optional[BatchShard]:
    """The split entered by sharded_batch(), or None."""
    return _ACTIVE_BATCH[-1] if _ACTIVE_BATCH else None
