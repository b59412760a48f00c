"""Remat policies of the XLSR transformer layer (port of
`XLSRConfig.remat_policy`, `occm_tpu/models/xlsr.py:566-597`): which of a
layer's tensors its backward keeps, the rest being recomputed from the
layer's input.

    policy           kept per layer besides its input (JAX's names)
    nothing          -
    dots             every matmul the layer makes itself: the q/k/v, out
                     and fc1 projections, and on the plain path QK^T and
                     P.V (JAX's dots_saveable; a kernel's output is not a
                     dot, and fc2's output is not needed)
    attn_out         the attention block's output after out_proj
    attn_out_inner   + the attention output before out_proj
    attn_probs       + the softmax probabilities (plain attention only)
    attn_all         + q, k and v after their projections (under
                     fused_qkv the one product that makes all three)

The layer marks the op that makes each named tensor with `name(...)`, as
JAX's `checkpoint_name` marks the value. `checkpoint_layer` runs a layer
under `torch.utils.checkpoint` (non-reentrant) with two dispatch modes as
its `context_fn`: in the forward, `_Keep` stores the outputs of the marked
ops the policy keeps; in the backward's recompute, `_Replay` hands those
back in place of running the op, so the recompute runs only the rest. The
autograd graph is that of "nothing" under every policy (the same ops, only
kept instead of recomputed), so every policy gives the same numbers bit
for bit. The recompute stops at the layer's last saved tensor
(checkpoint's early stop), so fc2 never reruns, as under JAX.

Why not PyTorch's selective checkpoint (`create_selective_checkpoint_
contexts`): it replays every op it does not keep, where JAX's remat
recomputes only what the backward reads. Under attn_probs and attn_all the
QK^T product feeds nothing but the kept softmax, so a replay would rerun
it; `_Replay` skips it (an uninitialised tensor stands in, which nothing
reads: softmax's backward reads its output, which is kept). Nested
checkpoint regions, the other design, cannot keep the softmax without
keeping v (P.V reads both), which attn_probs does not keep.

JAX itself recomputes a little more than its names say: its whole-T flash
backward takes q, k, v only, but `jax.nn.softmax`'s custom JVP keeps its
own unnamed output, so under attn_probs and attn_all JAX still recomputes
QK^T and the softmax (the kept probabilities feed only P.V's backward).
The port's recompute is the policy's. Its CUDA flash backward reads the
forward's output and log-sum-exp, which no name keeps, so the recompute
reruns the flash forward under every policy.

On a mesh the recompute reruns the layer's collectives with its ops:
Megatron's all-reduce under tp, the frame all-gathers (and, up to the
last kept tensor, the reduce-scatters) under sequence parallelism. Every
rank's backward reaches its layers' checkpoints in the same order and
stops each recompute at the same kept tensor, so the ranks post the same
collectives in the same order; collectives carry no name, so `_Replay`
runs them (tests/test_torch_pipeline.py holds every policy under tp=2
with sequence parallelism bit for bit against no remat).

The CUDA kernels launch through ctypes, so the dispatcher never sees
them: a kernel's output that a policy keeps by name (the flash output
under attn_out_inner and up) goes through `kernel_output`, a copy the
policy can keep.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

_ATTN_NAMED = ("attn_out", "attn_inner")

#: policy -> the names whose tensors the layer keeps (JAX's
#: save_only_these_names); "dots" keeps every marked matmul instead
NAMED = {
    "nothing": frozenset(),
    "dots": frozenset(),
    "attn_out": frozenset({"attn_out"}),
    "attn_out_inner": frozenset(_ATTN_NAMED),
    "attn_probs": frozenset(_ATTN_NAMED + ("attn_probs",)),
    "attn_all": frozenset(_ATTN_NAMED + ("attn_probs", "attn_q", "attn_k",
                                         "attn_v", "attn_qkv")),
}
_aten = torch.ops.aten
#: the ops whose outputs a name stands for (views and casts around them
#: are recomputed: they cost nothing or are needed anyway)
_MATMULS = frozenset({_aten.mm.default, _aten.addmm.default,
                      _aten.bmm.default, _aten.baddbmm.default})
_KEPT_OPS = _MATMULS | {_aten._softmax.default}
#: the tag prefix of `kernel_output`'s copy, the one clone a name keeps
_KERNEL = "kernel:"

_local = threading.local()


def _tag() -> Optional[str]:
    return getattr(_local, "tag", None)


def _active_policy() -> Optional[str]:
    return getattr(_local, "policy", None)


@contextlib.contextmanager
def name(tag: Optional[str]):
    """Mark the ops run inside as making the tensor `tag` (JAX's
    checkpoint_name; None: no name). Only the layer's own ops go inside: a
    kernel wrapper's ops are not named."""
    prev = _tag()
    _local.tag = tag
    try:
        yield
    finally:
        _local.tag = prev


def kernel_output(t: torch.Tensor, tag: str) -> torch.Tensor:
    """t, a CUDA kernel's output named `tag`: a copy under the name where
    the running policy keeps the name, t itself elsewhere."""
    policy = _active_policy()
    if policy is None or tag not in NAMED[policy]:
        return t
    with name(_KERNEL + tag):
        return t.clone()


def _decision(policy: str, func, tag: Optional[str]) -> str:
    """'keep' the op's output, skip it as 'dead' in the recompute, or
    'run' it again."""
    if tag is None:
        return "run"
    if tag.startswith(_KERNEL):
        return ("keep" if func is _aten.clone.default
                and tag[len(_KERNEL):] in NAMED[policy] else "run")
    if func not in _KEPT_OPS:
        return "run"
    if policy == "dots":
        return "keep" if func in _MATMULS else "run"
    if tag in NAMED[policy]:
        return "keep"
    if (tag == "attn_logits" and func in _MATMULS
            and "attn_probs" in NAMED[policy]):
        return "dead"  # QK^T feeds only the kept softmax
    return "run"


class _PolicyMode(TorchDispatchMode):
    """Sets the thread's running policy while active (`kernel_output`
    reads it)."""

    def __init__(self, policy: str, kept: list):
        super().__init__()
        self.policy = policy
        self.kept = kept

    def __enter__(self):
        self._prev = _active_policy()
        _local.policy = self.policy
        return super().__enter__()

    def __exit__(self, *exc):
        _local.policy = self._prev
        return super().__exit__(*exc)


class _Keep(_PolicyMode):
    """The forward: run every op, and store the kept ones' outputs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _decision(self.policy, func, _tag()) == "keep":
            self.kept.append((func, out.detach()))
        return out


class _Replay(_PolicyMode):
    """The recompute: hand back the kept outputs in order, skip the dead
    ops, run the rest."""

    def __enter__(self):
        self.next = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        decision = _decision(self.policy, func, _tag())
        if decision == "keep":
            kept_func, out = self.kept[self.next]
            if kept_func is not func:
                raise RuntimeError(
                    f"remat replay of {func} met the kept output of "
                    f"{kept_func}: the layer ran other ops in its recompute")
            self.next += 1
            return out.detach()
        if decision == "dead":
            meta = func(*[a.to("meta") if isinstance(a, torch.Tensor) else a
                          for a in args], **(kwargs or {}))
            return torch.empty_like(meta, device=args[0].device)
        return func(*args, **(kwargs or {}))


def _contexts(policy: str):
    kept: list = []
    return _Keep(policy, kept), _Replay(policy, kept)


def checkpoint_layer(layer, policy: str, *args):
    """layer(*args) with its activations recomputed in the backward, except
    what `policy` (one of NAMED, as XLSRConfig checks) keeps."""
    if policy == "nothing":
        return checkpoint(layer, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return checkpoint(layer, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: _contexts(policy))
