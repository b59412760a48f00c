"""Fused transformer FFN, y = GELU(x·W1 + b1)·W2 + b2 (port of
`occm_tpu.ops.ffn.fused_ffn`).

`fused_ffn(x [..., D], w1 [D, F], b1 [F], w2 [F, D], b2 [D], approximate)`
keeps the JAX package's layout. It is a `torch.autograd.Function`: on a CUDA
tensor its forward launches the hand-written Hopper kernel
`csrc/ffn_fwd.cu`, which replaces the TPU kernel `_kernel`; on a CPU tensor
it runs `ffn_reference`, the kernel's plain PyTorch version. A tensor on any
other device raises; nothing falls back from the kernel to the plain
version. The kernel reads the weights as `nn.Linear` stores them
(`fc1.weight` [F, D] = W1ᵀ, `fc2.weight` [D, F] = W2ᵀ), so the model passes
`fc1.weight.t()` and the wrapper's `.t()` gets the contiguous tensor back.

Both compute: x·W1 with fp32 accumulation, + b1 in fp32, GELU in fp32 (exact
erf, or the tanh form with `approximate`), the hidden activation rounded to
x's dtype, ·W2 with fp32 accumulation, + b2 in fp32, one rounding to x's
dtype. The backward is JAX's `_ffn_bwd`: the fc1 pre-activation is
recomputed (not the whole forward), every [M, F] intermediate stays in x's
dtype, GELU' runs in fp32, and the five products are plain matrix products
(the JAX package leaves them to XLA).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

_MAX_D = 1024  # the kernel keeps a [64, D] tile of x in shared memory


def _gelu_mode(approximate: bool) -> str:
    return "tanh" if approximate else "none"


def ffn_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor,
                  approximate: bool) -> torch.Tensor:
    """Plain version of the kernel: x [M, D], w1 [D, F], b1 [F], w2 [F, D],
    b2 [D] -> y [M, D] in x's dtype. `_xla_ffn`'s math: fp32 products of
    the given inputs, the hidden activation and the output each rounded
    once to x's dtype."""
    h = torch.matmul(x.float(), w1.float()) + b1.float()
    h = F.gelu(h, approximate=_gelu_mode(approximate)).to(x.dtype)
    y = torch.matmul(h.float(), w2.float()) + b2.float()
    return y.to(x.dtype)


def _check(x, w1, b1, w2, b2):
    if x.dim() != 2:
        raise ValueError(f"expected x [M, D], got {tuple(x.shape)}")
    m, d = x.shape
    f = w1.shape[-1]
    if (w1.shape != (d, f) or b1.shape != (f,) or w2.shape != (f, d)
            or b2.shape != (d,)):
        raise ValueError(
            f"expected w1 [D, F], b1 [F], w2 [F, D], b2 [D] for x "
            f"{tuple(x.shape)}, got {tuple(w1.shape)}, {tuple(b1.shape)}, "
            f"{tuple(w2.shape)}, {tuple(b2.shape)}")
    devices = {t.device for t in (x, w1, b1, w2, b2)}
    if len(devices) != 1:
        raise ValueError(f"x and the weights on different devices: "
                         f"{sorted(str(d) for d in devices)}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with its first element on a 16-byte boundary (the
    kernel's copies move 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ffn_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor,
            approximate: bool) -> torch.Tensor:
    """The kernel's wrapper: x [M, D], w1 [D, F], b1 [F], w2 [F, D], b2 [D]
    -> y [M, D].

    CUDA tensors launch `occm_ffn_fwd` on the current stream (bf16, M >= 1,
    D and F multiples of 64, D <= 1024); CPU tensors take the plain
    version."""
    global LAUNCHES
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return ffn_reference(x, w1, b1, w2, b2, approximate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn runs on cuda or cpu, not {x.device}")
    if any(t.dtype != torch.bfloat16 for t in (x, w1, b1, w2, b2)):
        raise ValueError(
            "the CUDA kernel takes bf16 x and weights, got "
            f"{[str(t.dtype) for t in (x, w1, b1, w2, b2)]}")
    m, d = x.shape
    f = w1.shape[1]
    if m < 1 or d % 64 or f % 64 or d > _MAX_D:
        raise ValueError(f"the CUDA kernel takes M >= 1, D and F multiples of "
                         f"64 and D <= {_MAX_D}; got M={m}, D={d}, F={f}")

    from occm_tpu_torch.ops import _build

    lib = _build.load()
    x = _aligned(x)
    w1t, w2t = _aligned(w1.t()), _aligned(w2.t())  # fc1.weight, fc2.weight
    b1, b2 = _aligned(b1), _aligned(b2)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.occm_ffn_fwd(
            x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), y.data_ptr(), m, d, f, int(approximate), stream)
    if err != 0:
        raise RuntimeError(f"occm_ffn_fwd failed: cudaError_t {err}")
    LAUNCHES += 1
    return y


def ffn_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor, g: torch.Tensor,
            approximate: bool):
    """JAX's `_ffn_bwd` (`occm_tpu/ops/ffn.py:118-154`): gradients of
    x [M, D], w1, b1, w2, b2 from g [M, D]. Recomputes only the fc1
    pre-activation; [M, F] intermediates in x's dtype, GELU' in fp32, db1
    and db2 as fp32 sums."""
    dt = x.dtype
    pre = torch.addmm(b1.to(dt), x, w1.to(dt))                # [M, F]
    h = F.gelu(pre.float(), approximate=_gelu_mode(approximate)).to(dt)
    g_ = g.to(dt)
    dh = torch.matmul(g_, w2.to(dt).t())                      # [M, F]
    dpre = torch.ops.aten.gelu_backward(
        dh.float(), pre.float(), approximate=_gelu_mode(approximate)).to(dt)
    dx = torch.matmul(dpre, w1.to(dt).t())                    # [M, D]
    dw1 = torch.matmul(x.t(), dpre).to(w1.dtype)              # [D, F]
    db1 = dpre.float().sum(dim=0).to(b1.dtype)
    dw2 = torch.matmul(h.t(), g_).to(w2.dtype)                # [F, D]
    db2 = g.float().sum(dim=0).to(b2.dtype)
    return dx, dw1, db1, dw2, db2


class _FusedFFN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, approximate: bool):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.approximate = approximate
        return ffn_fwd(x, w1, b1, w2, b2, approximate)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        return (*ffn_bwd(x, w1, b1, w2, b2, g, ctx.approximate), None)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              approximate: bool = True) -> torch.Tensor:
    """y = GELU(x @ w1 + b1) @ w2 + b2 over the last axis of x [..., D];
    w1 [D, F], w2 [F, D]. The hidden activation stays on chip in the CUDA
    kernel; the gradient is JAX's `_ffn_bwd`."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    y = _FusedFFN.apply(x.reshape(-1, d), w1, b1, w2, b2, approximate)
    return y.reshape(*lead, d)
