"""LayerNorm with a one-pass backward kernel (port of
`occm_tpu.ops.layernorm.fast_layer_norm`).

`fast_layer_norm(x, gamma, beta, eps)` is a `torch.autograd.Function`: its
forward is plain PyTorch math with fp32 statistics and an output in x's
dtype (`_fwd_math`, as the JAX forward is plain XLA); it saves only
(x, gamma). Its backward recomputes the row statistics from x and, on a
CUDA tensor, launches the hand-written Hopper kernel
`csrc/layernorm_bwd.cu`, which replaces the TPU kernel `_bwd_kernel`:

    x_hat = (x - mu) * rstd,  gg = g * gamma
    dx     = rstd * (gg - mean_D(gg) - x_hat * mean_D(gg * x_hat))
    dgamma = sum_M g * x_hat,  dbeta = sum_M g

in one launch per call: one warp per row, and dgamma and dbeta summed to
their final values inside the same launch, in a fixed order (two calls give
identical bits), through a scratch this module keeps per device and stream.

On a CPU tensor it runs `layer_norm_bwd_reference`, the same math in plain
PyTorch (the JAX package's fallback, `layernorm.py:139-155`). A tensor on
any other device raises; nothing falls back from the kernel.
"""

from __future__ import annotations

import torch

#: kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

#: (device, stream) -> the kernel's scratch: the block and group partials
#: of dgamma and dbeta and the tickets that elect the blocks summing them,
#: which every launch leaves at zero. Launches on one stream run in order,
#: so they can share it.
_SCRATCH: dict = {}
#: (device index, M, D, is_bf16) -> bytes of scratch the kernel needs
_SCRATCH_BYTES: dict = {}


def _fwd_math(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype)


def layer_norm_bwd_reference(x: torch.Tensor, gamma: torch.Tensor,
                             g: torch.Tensor, eps: float):
    """Plain version of the kernel: x, g [M, D], gamma [D] -> (dx [M, D]
    in x's dtype, dgamma [D] fp32, dbeta [D] fp32), fp32 statistics."""
    xf, gf = x.float(), g.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    x_hat = xc * rstd
    gg = gf * gamma.float()
    m1 = gg.mean(dim=-1, keepdim=True)
    m2 = (gg * x_hat).mean(dim=-1, keepdim=True)
    dx = (rstd * (gg - m1 - x_hat * m2)).to(x.dtype)
    return dx, torch.sum(gf * x_hat, dim=0), torch.sum(gf, dim=0)


def layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor,
                   eps: float):
    """The kernel's wrapper: x, g [M, D] (g cast to x's dtype, as the JAX
    wrapper does), gamma [D] -> (dx, dgamma fp32, dbeta fp32).

    CUDA tensors launch `occm_layernorm_bwd` on the current stream (x bf16
    or fp32, contiguous, D <= 2048); CPU tensors take the plain version."""
    global LAUNCHES
    if x.dim() != 2 or g.shape != x.shape or gamma.shape != x.shape[-1:]:
        raise ValueError(
            f"expected x, g [M, D] and gamma [D], got {tuple(x.shape)}, "
            f"{tuple(g.shape)}, {tuple(gamma.shape)}")
    if not (x.device == g.device == gamma.device):
        raise ValueError(f"x, g, gamma on different devices: {x.device}, "
                         f"{g.device}, {gamma.device}")
    if g.dtype != x.dtype:
        g = g.to(x.dtype)
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, gamma, g, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd runs on cuda or cpu, not "
                         f"{x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernel takes bf16 or fp32, got {x.dtype}")
    m, d = x.shape
    if m == 0 or d > 2048:
        raise ValueError(f"the CUDA kernel takes 0 < M and D <= 2048, got "
                         f"[{m}, {d}]")

    from occm_tpu_torch.ops import _build

    lib = _build.load()
    x, g = x.contiguous(), g.contiguous()
    if gamma.dtype != torch.float32:
        gamma = gamma.float()
    gamma = gamma.contiguous()
    is_bf16 = int(x.dtype == torch.bfloat16)
    dx = torch.empty_like(x)
    dparams = torch.empty((2, d), dtype=torch.float32, device=x.device)
    with _build.on_device(x.device):
        stream = _build.raw_stream(x.device)
        nbytes = _scratch_bytes(lib, m, d, is_bf16)
        scratch = _SCRATCH.get((x.device, stream))
        if scratch is None or scratch.numel() < nbytes:
            # zeros: the tickets start at zero, and every launch resets them
            scratch = torch.zeros(nbytes, dtype=torch.uint8, device=x.device)
            _SCRATCH[x.device, stream] = scratch
        err = lib.occm_layernorm_bwd(
            x.data_ptr(), gamma.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dparams.data_ptr(), dparams.data_ptr() + 4 * d,
            scratch.data_ptr(), nbytes, m, d, float(eps), is_bf16, stream)
    if err != 0:
        raise RuntimeError(f"occm_layernorm_bwd failed: cudaError_t {err}")
    LAUNCHES += 1
    dgamma, dbeta = dparams.unbind(0)
    return dx, dgamma, dbeta


def _scratch_bytes(lib, m: int, d: int, is_bf16: int) -> int:
    """The kernel's scratch for [m, d] on the current device, asked once
    per shape."""
    key = (torch.cuda.current_device(), m, d, is_bf16)
    nbytes = _SCRATCH_BYTES.get(key)
    if nbytes is None:
        nbytes = lib.occm_layernorm_bwd_scratch_bytes(m, d, is_bf16)
        if nbytes < 0:
            raise RuntimeError(f"occm_layernorm_bwd takes no [{m}, {d}]")
        _SCRATCH_BYTES[key] = nbytes
    return nbytes


class _FastLayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _fwd_math(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        d = x.shape[-1]
        dx, dgamma, dbeta = layer_norm_bwd(x.reshape(-1, d), gamma,
                                           g.reshape(-1, d), ctx.eps)
        return (dx.reshape(x.shape), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)


def fast_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics, output in x's
    dtype, backward through the one-pass kernel."""
    return _FastLayerNorm.apply(x, gamma, beta, eps)
