"""The collectives of the port's parallel paths, and their autograd forms.

Every helper takes a process group (None: this rank alone, the identity)
and works on the rank's own tensors:

- `all_reduce_` (sum, in place), `all_gather_cat` (along any dim) and
  `reduce_scatter_sum` (this rank's block of the sum, along any dim);
- `send` / `recv` to and from one peer (the pipeline's stages) and
  `broadcast_` from one;
- `reduce_sum` and `gather_rows` / `copy_to` / `reduce_from`, the
  differentiable forms the models and the loss use:
  - `reduce_sum`: forward and backward an all-reduce, for a sum over the
    data axes whose result is used with this rank's rows only (BatchNorm
    statistics: each rank's backward holds only its rows' share);
  - `gather_rows`: all-gather along dim 0, backward this rank's rows of
    the gradient (the loss downstream is computed whole on every rank, so
    every rank already holds the whole gradient);
  - `copy_to` / `reduce_from`: Megatron's f and g for a tensor-parallel
    layer: identity forward and all-reduce backward at the input of a
    column-parallel product; all-reduce forward and identity backward at
    the output of a row-parallel one;
  - sequence parallelism on the frames (dim 1 of [B, T, D]):
    `gather_frames` / `scatter_frames`, Megatron-SP's g and its
    conjugate, each the other's backward (all-gather forward and
    reduce-scatter backward before a column-parallel product;
    reduce-scatter forward and all-gather backward after a row-parallel
    one), and `split_frames` / `gather_rows(..., dim=1)` at the stack's
    entry and end, where the tensors outside are whole on every tp rank
    (this rank's block forward, all-gather backward; and the reverse).

Every collective is taken directly, on NCCL and on Gloo. PyTorch 2.11's
Gloo backend (cu128 build, one H100) takes `all_reduce`, `broadcast`,
`all_gather_into_tensor`, `all_gather`, `reduce_scatter_tensor` and
`barrier` on CUDA tensors; `send` / `recv` of a CUDA tensor fail there
("writev ... Bad address"), so under Gloo `send` / `recv` stage a CUDA
tensor through a pinned host buffer of its own (one per message, never
reused), and under NCCL they send it directly. A point-to-point message
travels as its bytes (uint8), whatever its dtype.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum t over the group, in place; returns t."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order."""
    n = group_size(group)
    if group is None:
        return t
    t = t.contiguous()
    # the output concatenates along dim 0 (the layout Gloo requires)
    buf = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(buf, t, group=group)
    if dim == 0:
        return buf
    return torch.cat(buf.view((n,) + tuple(t.shape)).unbind(0), dim=dim)


def reduce_scatter_sum(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block (along `dim`, in group-rank order) of the sum of
    t over the group; t's `dim` must divide by the group's size."""
    if group is None:
        return t
    block = t.shape[dim] // group_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((block,) + tuple(src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _staged(device: torch.device) -> bool:
    """Whether a tensor on `device` travels through the host: a CUDA
    tensor under Gloo."""
    return device.type == "cuda" and dist.get_backend() != "nccl"


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """Send t to global rank `dst` (blocking; the receiver knows its shape
    and dtype)."""
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if _staged(flat.device):
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat)
        flat = host
    elif flat.device.type == "cpu" and dist.get_backend() == "nccl":
        flat = flat.to("cuda")
    dist.send(flat, dst, group=group)


def recv(shape, dtype, src: int, device, group=None) -> torch.Tensor:
    """A tensor of `shape` and `dtype` from global rank `src`, on
    `device` (blocking)."""
    device = torch.device(device)
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    if _staged(device):
        buf = torch.empty((n,), dtype=torch.uint8, pin_memory=True)
    elif device.type == "cpu" and dist.get_backend() == "nccl":
        buf = torch.empty((n,), dtype=torch.uint8, device="cuda")
    else:
        buf = torch.empty((n,), dtype=torch.uint8, device=device)
    dist.recv(buf, src, group=group)
    return buf.to(device).view(dtype).reshape(shape)


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """t from global rank `src` of the group, in place (a CPU tensor under
    NCCL travels through the card); returns t."""
    if group is None:
        return t
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        buf = t.to("cuda")
        dist.broadcast(buf, src, group=group)
        t.copy_(buf)
    else:
        dist.broadcast(t, src, group=group)
    return t


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rows = t.shape[dim]
        return all_gather_cat(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return (g.narrow(ctx.dim, r * ctx.rows, ctx.rows).contiguous(), None,
                None)


class _SplitFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        n, r = group_size(group), group_rank(group)
        block = t.shape[1] // n
        return t.narrow(1, r * block, block).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, 1), None


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather_cat(t, group, 1)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_sum(g, ctx.group, 1), None


class _ScatterFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return reduce_scatter_sum(t, group, 1)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, 1), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_(t.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the gradient is summed over it too."""
    return t if group is None else _ReduceSum.apply(t, group)


def gather_rows(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along `dim` (equal sizes); the gradient is this rank's
    block of the output's."""
    return t if group is None else _GatherRows.apply(t, group, dim)


def split_frames(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the frames (dim 1, which the group's size must
    divide); the gradient is all-gathered (the tensor it came from is
    whole on every rank)."""
    return t if group is None else _SplitFrames.apply(t, group)


def gather_frames(t: torch.Tensor, group) -> torch.Tensor:
    """Megatron-SP's g: all-gather the frames forward, reduce-scatter the
    gradient."""
    return t if group is None else _GatherFrames.apply(t, group)


def scatter_frames(t: torch.Tensor, group) -> torch.Tensor:
    """Megatron-SP's conjugate of g: reduce-scatter the frames forward
    (this rank's block of the sum), all-gather the gradient."""
    return t if group is None else _ScatterFrames.apply(t, group)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, all-reduce backward."""
    return t if group is None else _CopyTo.apply(t, group)


def reduce_from(t: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: all-reduce forward, identity backward."""
    return t if group is None else _ReduceFrom.apply(t, group)


def all_reduce_max_flag(flag: bool, group, device) -> bool:
    """True when any rank of the group passed True (a SIGTERM seen by one
    rank stops every rank at the same step)."""
    if group is None:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item() > 0)
