"""Single-pass Adam (port of `occm_tpu.ops.fused_adam.FusedAdam`).

`FusedAdam(lr, b1, b2, eps)` keeps the first and second moments of every
parameter leaf and the step count. `step(params, grads)` updates each fp32
leaf in place: on a CUDA tensor it launches the hand-written Hopper kernel
`csrc/fused_adam.cu` once per leaf (replacing the TPU kernel `_kernel`),
which reads p, m, v, g once and writes p, m, v once; on a CPU tensor it runs
`adam_reference`, the same formula (`_adam_math`) in plain PyTorch. The
bias corrections 1/(1 - b^t) are computed on the host in fp32, as the JAX
wrapper computes them outside its kernel. Unlike the functional JAX
optimizer, the update is in place: parameters and moments are not copied.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

#: kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0


def bias_corrections(t: int, b1: float, b2: float):
    """(1/(1 - b1^t), 1/(1 - b2^t)) in fp32, as `_bias_corrections`."""
    tf = np.float32(t)
    one = np.float32(1.0)
    inv_bc1 = one / (one - np.power(np.float32(b1), tf))
    inv_bc2 = one / (one - np.power(np.float32(b2), tf))
    return float(inv_bc1), float(inv_bc2)


def adam_reference(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, inv_bc1: float, inv_bc2: float, lr: float,
                   b1: float, b2: float, eps: float) -> None:
    """Plain version of the kernel: `_adam_math`, written into p, m, v."""
    new_m = b1 * m + (1.0 - b1) * g
    new_v = b2 * v + (1.0 - b2) * g * g
    mhat = new_m * inv_bc1
    vhat = new_v * inv_bc2
    p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
    m.copy_(new_m)
    v.copy_(new_v)


def fused_adam_leaf(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, inv_bc1: float, inv_bc2: float,
                    lr: float, b1: float, b2: float, eps: float) -> None:
    """The kernel's wrapper: one Adam step on one leaf, in place.

    CUDA tensors launch `occm_fused_adam` on the current stream (fp32,
    contiguous p, m, v, g of one shape); CPU tensors take the plain
    version."""
    global LAUNCHES
    if not (p.shape == m.shape == v.shape == g.shape):
        raise ValueError(f"p, m, v, g of different shapes: {tuple(p.shape)}, "
                         f"{tuple(m.shape)}, {tuple(v.shape)}, "
                         f"{tuple(g.shape)}")
    if not (p.device == m.device == v.device == g.device):
        raise ValueError("p, m, v, g on different devices")
    if p.device.type == "cpu":
        adam_reference(p, m, v, g, inv_bc1, inv_bc2, lr, b1, b2, eps)
        return
    if p.device.type != "cuda":
        raise ValueError(f"fused Adam runs on cuda or cpu, not {p.device}")
    if any(x.dtype != torch.float32 for x in (p, m, v, g)):
        raise ValueError("the CUDA kernel takes fp32 p, m, v, g")
    if not all(x.is_contiguous() for x in (p, m, v, g)):
        raise ValueError("the CUDA kernel takes contiguous p, m, v, g")
    if p.numel() == 0:
        return

    from occm_tpu_torch.ops import _build

    lib = _build.load()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        err = lib.occm_fused_adam(
            p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
            p.numel(), lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, inv_bc1,
            inv_bc2, stream)
    if err != 0:
        raise RuntimeError(f"occm_fused_adam failed: cudaError_t {err}")
    LAUNCHES += 1


class FusedAdam:
    """Single-pass Adam over a list of fp32 parameter tensors."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr = float(learning_rate)
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)
        self.count = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, params: Sequence[torch.Tensor]) -> "FusedAdam":
        """Zero moments shaped like `params`, step count 0."""
        self.count = 0
        self.mu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in params]
        self.nu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in params]
        return self

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One update of every leaf in place; the step count goes up by
        one. A leaf whose gradient is None (a parameter the forward never
        used) is left as it is, as torch.optim.Adam leaves it."""
        if not (len(params) == len(grads) == len(self.mu)):
            raise ValueError(
                f"{len(params)} params, {len(grads)} grads, {len(self.mu)} "
                "moments: call init(params) first")
        self.count += 1
        inv_bc1, inv_bc2 = bias_corrections(self.count, self.b1, self.b2)
        for p, m, v, g in zip(params, self.mu, self.nu, grads):
            if g is None:
                continue
            fused_adam_leaf(p.data, m, v, g.to(p.dtype).contiguous(),
                            inv_bc1, inv_bc2, self.lr, self.b1, self.b2,
                            self.eps)
