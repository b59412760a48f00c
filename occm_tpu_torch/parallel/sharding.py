"""Parameter, optimizer-state and batch placement on the mesh (port of
`occm_tpu.parallel.sharding`).

The placement table is over the port's torch parameter names (the
reference naming that `models.state_dict_from_flax` produces):

- TP (`_TP_RULES`, Megatron): the column-parallel q/k/v and fc1 of every
  XLSR transformer layer shard their OUTPUT features, which are the rows
  of torch's `Linear.weight` [out, in] (dim 0) and their biases; the
  row-parallel out_proj and fc2 shard their INPUT features, the columns of
  the weight (dim 1), and keep their biases whole (added once, after the
  all-reduce: `models/xlsr.py`). The layers compute on these shards.
- FSDP: every parameter of at least `FSDP_MIN_SIZE` elements is also
  sharded on its largest free axis that the fsdp degree divides (JAX's
  `_add_fsdp_axis`, on the full shape). The shards are gathered before
  the forward and the gradients reduce-scattered back (`train/state.py`).
  JAX's transformer leaves are stacked [L, ...], so which leaves pass the
  size threshold, and on which axis they shard, may differ from JAX; the
  arithmetic does not.
- PP (`stage_of`): with pp = P > 1, the rank at pp coordinate r owns
  `encoder.layers.{l}` for l in [r L/P, (r + 1) L/P), the port's form of
  JAX's P("pp", ...) on the stacked [L, ...] axis. With pp_stages S a
  multiple of P these are the layers of the rank's S / P consecutive
  stages of the schedule (JAX shards the [S, L/S, ...] stage view the
  same way). A rank keeps no tensor of another rank's layers (an empty
  one stands in, parameter and moments alike). It composes with the TP
  and fsdp rules, as JAX composes ("pp", "fsdp", "tp").
- everything else (conv stem, backends, norms, the row-parallel biases,
  BatchNorm statistics, step counts) is replicated. Under sequence
  parallelism the layer leaves that tp replicates (LayerNorms, the
  row-parallel biases) see only the rank's frames, so their gradients
  are summed over tp (`Placement.tp_sum`).

Adam's moments follow their parameters (`opt_state_shardings`); the step
count stays replicated. A placed state keeps, on each rank, only its
shards, each a contiguous tensor of its own (`place_state_on_mesh`);
`full_parameters` gathers them back, over pp too (checkpoints are
written whole, in the single-GPU format), and `unplace_state` makes
them whole for a checkpoint to be loaded into. `local_rows` /
`shard_batch` give a rank its rows of the global batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from occm_tpu_torch.parallel import collectives as C
from occm_tpu_torch.parallel.mesh import (
    Mesh, data_index, data_parallel_size, pp_peer)

# (name suffix inside an XLSR transformer layer, leaf ndim, sharded dim)
_TP_RULES = (
    ("self_attn.q_proj.weight", 2, 0),
    ("self_attn.k_proj.weight", 2, 0),
    ("self_attn.v_proj.weight", 2, 0),
    ("self_attn.q_proj.bias", 1, 0),
    ("self_attn.k_proj.bias", 1, 0),
    ("self_attn.v_proj.bias", 1, 0),
    ("self_attn.out_proj.weight", 2, 1),
    ("fc1.weight", 2, 0),
    ("fc1.bias", 1, 0),
    ("fc2.weight", 2, 1),
)

# Leaves smaller than this stay replicated under fsdp: sharding tiny
# tensors trades negligible memory for a collective each.
FSDP_MIN_SIZE = 4096


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf's shards lie: the dim sharded over tp and the one
    sharded over fsdp (None: not sharded over that axis), its full shape,
    the pp coordinate of the rank that owns it (`stage`: the rank whose
    block of pipeline stages holds its layer; None: every rank holds it),
    and whether its gradient is partial over tp (sequence
    parallelism)."""

    tp_dim: Optional[int]
    fsdp_dim: Optional[int]
    shape: Tuple[int, ...]
    stage: Optional[int] = None
    tp_sum: bool = False

    @property
    def sharded(self) -> bool:
        return (self.tp_dim is not None or self.fsdp_dim is not None
                or self.stage is not None)

    def owned(self, mesh: Mesh, rank: Optional[int] = None) -> bool:
        """Whether `rank` (this one by default) holds this leaf."""
        return self.stage is None or mesh.coords(rank)["pp"] == self.stage


_LAYER = "encoder.layers."


def _layer_index(name: str) -> Optional[int]:
    """l of a leaf under `...encoder.layers.{l}.`, else None."""
    at = name.find(_LAYER)
    if at < 0:
        return None
    return int(name[at + len(_LAYER):].split(".", 1)[0])


def stage_of(name: str, n_layers: int, pp: int) -> Optional[int]:
    """The pp coordinate of the rank that owns the leaf `name` (contiguous
    blocks of n_layers / pp layers: its block of pp_stages / pp pipeline
    stages), None for a leaf outside the layer stack."""
    layer = _layer_index(name)
    if layer is None or pp == 1:
        return None
    return layer // (n_layers // pp)


def _tp_dim(name: str, ndim: int) -> Optional[int]:
    if "encoder.layers." not in name:
        return None
    for suffix, nd, dim in _TP_RULES:
        if name.endswith(suffix) and ndim == nd:
            return dim
    return None


def _fsdp_dim(shape, taken: Optional[int], fsdp: int) -> Optional[int]:
    """The largest still-unsharded axis divisible by fsdp (the first of
    equals), as JAX's _add_fsdp_axis chooses it."""
    best = None
    for i, dim in enumerate(shape):
        if i != taken and dim % fsdp == 0 and dim >= fsdp:
            if best is None or dim > shape[best]:
                best = i
    return best


def param_shardings(named_params, mesh: Mesh,
                    seq_parallel: bool = False) -> Dict[str, Placement]:
    """name -> Placement for every (name, tensor) of full shape: TP rules
    on the XLSR transformer layers, the pp stage of each layer, then fsdp
    on every large-enough leaf. With tp = fsdp = pp = 1 nothing is
    sharded (pure data parallelism). `seq_parallel`: the layers run
    Megatron-SP (the layer leaves tp replicates get `tp_sum`)."""
    named_params = list(named_params)
    tp = mesh.shape["tp"]
    fsdp = mesh.shape["fsdp"]
    pp = mesh.shape["pp"]
    layers = [_layer_index(n) for n, _ in named_params]
    n_layers = 1 + max((l for l in layers if l is not None), default=-1)
    if pp > 1 and n_layers % pp:
        raise ValueError(f"pp={pp} must divide encoder_layers={n_layers}")
    table = {}
    for name, p in named_params:
        shape = tuple(p.shape)
        t_dim = _tp_dim(name, p.dim()) if tp > 1 else None
        if t_dim is not None and shape[t_dim] % tp:
            raise ValueError(f"{name} {shape}: dim {t_dim} does not divide "
                             f"by tp={tp}")
        f_dim = None
        if fsdp > 1 and p.numel() >= FSDP_MIN_SIZE:
            f_dim = _fsdp_dim(shape, t_dim, fsdp)
        tp_sum = (seq_parallel and tp > 1 and t_dim is None
                  and _layer_index(name) is not None)
        table[name] = Placement(t_dim, f_dim, shape,
                                stage_of(name, n_layers, pp), tp_sum)
    return table


def opt_state_shardings(placements: Dict[str, Placement]
                        ) -> Dict[str, Dict[str, Optional[Placement]]]:
    """The optimizer state's placement: each moment ("mu", "nu") as its
    parameter, the step count ("count") replicated (None)."""
    return {"mu": dict(placements), "nu": dict(placements), "count": None}


def train_state_shardings(state, mesh: Mesh) -> Dict:
    """The TrainState's placement: parameters per the TP and fsdp rules,
    the optimizer state matching them, BatchNorm statistics and the step
    replicated (None)."""
    params = param_shardings(state.named_params(), mesh)
    return {"params": params, "opt_state": opt_state_shardings(params),
            "batch_stats": None, "step": None}


def _block(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def shard_of(full: torch.Tensor, placement: Placement, mesh: Mesh,
             rank: Optional[int] = None) -> torch.Tensor:
    """A rank's shard of a full tensor: a contiguous tensor of its own
    (an empty one on a stage that does not own the leaf)."""
    if not placement.owned(mesh, rank):
        return full.new_empty((0,))
    c = mesh.coords(rank)
    t = full
    if placement.tp_dim is not None:
        t = _block(t, placement.tp_dim, mesh.shape["tp"], c["tp"])
    if placement.fsdp_dim is not None:
        t = _block(t, placement.fsdp_dim, mesh.shape["fsdp"], c["fsdp"])
    return t.detach().contiguous().clone()


FULL = ("fsdp", "tp", "pp")


def _gathers(placement: Placement, axes) -> bool:
    """Whether gather_full over `axes` changes the leaf's tensor."""
    return (("fsdp" in axes and placement.fsdp_dim is not None)
            or ("tp" in axes and placement.tp_dim is not None)
            or ("pp" in axes and placement.stage is not None))


def gather_full(shard: torch.Tensor, placement: Placement, mesh: Mesh,
                axes=FULL) -> torch.Tensor:
    """The tensor whole again along `axes` (a collective: every rank of
    those groups calls it). Over pp the owning stage gathers its shards
    and broadcasts the whole tensor to its pipeline."""
    owned = placement.owned(mesh)
    t = shard
    if owned and "fsdp" in axes and placement.fsdp_dim is not None:
        t = C.all_gather_cat(t, mesh.group("fsdp"), placement.fsdp_dim)
    if owned and "tp" in axes and placement.tp_dim is not None:
        t = C.all_gather_cat(t, mesh.group("tp"), placement.tp_dim)
    if "pp" in axes and placement.stage is not None:
        if not owned:
            t = shard.new_empty(placement.shape)
        C.broadcast_(t, pp_peer(mesh, placement.stage), mesh.group("pp"))
    return t


def _moment_lists(state) -> List[Tuple[str, dict, str]]:
    """(param name, holder, key) of every Adam moment of the state, so it
    can be read and replaced in place."""
    from occm_tpu_torch.ops.fused_adam import FusedAdam

    out = []
    opt = state.optimizer
    named = state.named_params()
    if isinstance(opt, FusedAdam):
        for i, (n, _) in enumerate(named):
            out.append((n, opt.mu, i))
            out.append((n, opt.nu, i))
    else:
        for n, p in named:
            if p in opt.state:
                out.append((n, opt.state[p], "exp_avg"))
                out.append((n, opt.state[p], "exp_avg_sq"))
    return out


def _reset_plans(state) -> None:
    from occm_tpu_torch.ops.fused_adam import FusedAdam

    if isinstance(state.optimizer, FusedAdam):
        state.optimizer._plan = None


def seq_parallel_of(model) -> bool:
    """Whether an XLSR encoder of `model` runs sequence parallelism."""
    from occm_tpu_torch.config import XLSRConfig

    return any(isinstance(getattr(m, "cfg", None), XLSRConfig)
               and m.cfg.seq_parallel for m in model.modules())


@torch.no_grad()
def place_state_on_mesh(state, mesh: Mesh):
    """Keep on this rank only its shards of the parameters and of the Adam
    moments (contiguous tensors of their own, swapped into the same
    Parameter objects, so the optimizer keeps its references; empty ones
    for another pipeline stage's layers); BatchNorm statistics and step
    counts stay whole. Every rank starts from the identical full state
    (the same seed or checkpoint). Sets state.mesh and state.placements;
    returns the state."""
    named = state.named_params()
    table = param_shardings(named, mesh, seq_parallel_of(state.model))
    for n, p in named:
        if table[n].sharded:
            p.data = shard_of(p.data, table[n], mesh)
    for n, holder, key in _moment_lists(state):
        if table[n].sharded:
            holder[key] = shard_of(holder[key], table[n], mesh)
    _reset_plans(state)
    state.mesh = mesh
    state.placements = table
    return state


@torch.no_grad()
def unplace_state(state):
    """Drop the placement, for a checkpoint to be loaded (no collective):
    every sharded parameter whole again but uninitialised, to be set by
    the checkpoint's `load_state_dict`, and the Adam moments zero and
    whole (torch Adam's state emptied), to be set by
    `TrainState.load_optimizer_state`. Returns the mesh it was on."""
    from occm_tpu_torch.ops.fused_adam import FusedAdam

    mesh, table = state.mesh, state.placements
    if not table:
        return mesh
    for n, p in state.named_params():
        if table[n].sharded:
            p.data = torch.empty(table[n].shape, dtype=p.dtype,
                                 device=p.device)
    opt = state.optimizer
    if isinstance(opt, FusedAdam):
        params = [p for _, p in state.named_params()]
        opt.mu = [torch.zeros_like(p) for p in params]
        opt.nu = [torch.zeros_like(p) for p in params]
    else:
        opt.state.clear()
    _reset_plans(state)
    state.placements = {}
    return mesh


@contextlib.contextmanager
def full_parameters(state, axes=FULL) -> Iterator[None]:
    """Inside: every parameter whole along `axes` (gathered, a
    collective); after: the same shards as before."""
    table = getattr(state, "placements", None) or {}
    swapped = []
    with torch.no_grad():
        for n, p in state.named_params():
            pl = table.get(n)
            if pl is None or not _gathers(pl, axes):
                continue
            shard = p.data
            p.data = gather_full(shard, pl, state.mesh, axes)
            swapped.append((p, shard))
    try:
        yield
    finally:
        for p, shard in swapped:
            p.data = shard


def full_optimizer_state(state) -> Dict:
    """`state.optimizer_state()` with every moment whole (a collective).
    Under pp a stage has no torch Adam state for another stage's layers:
    which leaves have moments is agreed over the pipeline first, and the
    owning stage broadcasts them."""
    opt = state.optimizer_state()
    table = getattr(state, "placements", None) or {}
    if not table:
        return opt
    mesh = state.mesh
    named = state.named_params()
    present = set(opt["mu"])
    staged = [n for n, _ in named if table[n].stage is not None]
    if staged:
        flags = torch.tensor([float(n in present) for n in staged],
                             device=named[0][1].device)
        C.all_reduce_(flags, mesh.group("pp"))
        present |= {n for n, f in zip(staged, flags.tolist()) if f > 0}
    for key in ("mu", "nu"):
        have = opt[key]
        opt[key] = {n: (gather_full(have.get(n, p.new_empty((0,))),
                                    table[n], mesh)
                        if table[n].sharded else have[n])
                    for n, p in named if n in present}
    return opt


def gather_fsdp_params(state) -> List[Tuple[torch.nn.Parameter,
                                            torch.Tensor, Placement]]:
    """Swap each fsdp-sharded parameter's shard for the whole tensor along
    fsdp (tp shards stay), before the forward, for this rank's pipeline
    stage's leaves; returns the swaps for `reduce_gradients` to undo."""
    table = getattr(state, "placements", None) or {}
    swaps = []
    with torch.no_grad():
        for n, p in state.named_params():
            pl = table.get(n)
            if pl is None or pl.fsdp_dim is None or not pl.owned(
                    state.mesh):
                continue
            shard = p.data
            p.data = C.all_gather_cat(shard, state.mesh.group("fsdp"),
                                      pl.fsdp_dim)
            swaps.append((p, shard, pl))
    return swaps


def _all_reduce_bucket(grads: List[torch.Tensor], group) -> None:
    """Sum a list of gradients over the group in place, as one flat
    collective."""
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    C.all_reduce_(flat, group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset: offset + n].view_as(g))
        offset += n


@torch.no_grad()
def reduce_gradients(state, swaps, replicated: bool = False) -> None:
    """After the backward: the gradient of the global loss on every rank's
    shards. fsdp-sharded leaves are reduce-scattered over fsdp (and put
    back to their shards), then summed over dp; every other leaf is summed
    over the data axes (dp x fsdp); tp shards and the leaves tp replicates
    need nothing over tp, except under sequence parallelism (`tp_sum`:
    summed over tp). With `replicated` (every rank held the whole batch)
    the data-axis sums are divided by the data-axis size. Under pp the
    leaves every stage holds are summed over the pipeline (stage 0 alone
    has the frontend's gradients, the last stage alone the backend's): a
    rank without a gradient that another stage has takes zeros, so every
    stage joins the sum, and a leaf no stage has a gradient for stays
    without one, as in one process."""
    mesh = state.mesh
    table = state.placements
    sharded = {id(p) for p, _, _ in swaps}
    by_group: Dict[str, List[torch.Tensor]] = {"dp": [], "data": []}
    for p, shard, pl in swaps:
        grad = p.grad
        p.data = shard
        if grad is None:
            continue
        p.grad = C.reduce_scatter_sum(grad, mesh.group("fsdp"), pl.fsdp_dim)
        by_group["dp"].append(p.grad)
    named = state.named_params()
    for _, p in named:
        if id(p) not in sharded and p.grad is not None:
            by_group["data"].append(p.grad)
    for name, grads in by_group.items():
        _all_reduce_bucket(grads, mesh.group(name))
    if replicated:
        n = data_parallel_size(mesh)
        if n > 1:
            for grads in by_group.values():
                for g in grads:
                    g.div_(n)
    _all_reduce_bucket([p.grad for n, p in named
                        if table[n].tp_sum and p.grad is not None],
                       mesh.group("tp"))
    if mesh.shape["pp"] > 1:
        _sum_over_pipeline([p for n, p in named if table[n].stage is None],
                           mesh.group("pp"))


def _sum_over_pipeline(params: List[torch.nn.Parameter], group) -> None:
    """Sum the gradients of the leaves every stage holds over the pp
    group, with zeros where a stage has none and another has one."""
    if not params:
        return
    device = params[0].device
    have = torch.tensor([float(p.grad is not None) for p in params],
                        device=device)
    C.all_reduce_(have, group)
    grads = []
    for p, n in zip(params, have.tolist()):
        if n > 0 and p.grad is None:
            p.grad = torch.zeros_like(p)
        if n > 0:
            grads.append(p.grad)
    _all_reduce_bucket(grads, group)


def local_rows(x, index: int, count: int, accum: int = 1):
    """Rows of a global batch [B, ...] (numpy or torch) for data shard
    `index` of `count`: with `accum` micro-batches, the shard's part of
    each micro-batch, in order (so the shard's micro-batch i is its rows
    of the global micro-batch i). B must divide by count * accum."""
    b = x.shape[0]
    per = b // (count * accum)
    rest = tuple(x.shape[1:])
    blocks = x.reshape((accum, count, per) + rest)[:, index]
    return blocks.reshape((accum * per,) + rest)


def shard_batch(batch, mesh: Mesh, accum: int = 1):
    """This rank's rows of each array of a global batch (a tuple), split
    over the data axes (dp, then fsdp); the ranks of one tp group get the
    same rows."""
    count = data_parallel_size(mesh)
    if count == 1:
        return batch
    i = data_index(mesh)
    return tuple(local_rows(a, i, count, accum) for a in batch)


def held_bytes(state) -> Dict[str, int]:
    """Bytes this rank holds in parameters and in Adam moments."""
    params = sum(p.numel() * p.element_size()
                 for _, p in state.named_params())
    moments = sum(holder[key].numel() * holder[key].element_size()
                  for _, holder, key in _moment_lists(state))
    return {"params": int(params), "moments": int(moments)}


def placement_table(placements: Dict[str, Placement]) -> Dict[str, Tuple]:
    """name -> (tp_dim, fsdp_dim) of every leaf sharded over tp or fsdp
    (for printing and tests)."""
    return {n: (pl.tp_dim, pl.fsdp_dim) for n, pl in placements.items()
            if pl.tp_dim is not None or pl.fsdp_dim is not None}


def stage_table(placements: Dict[str, Placement]) -> Dict[str, int]:
    """name -> the pp stage that owns it, for every layer leaf under
    pp > 1."""
    return {n: pl.stage for n, pl in placements.items()
            if pl.stage is not None}
