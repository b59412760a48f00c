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
    dgamma = sum_M g * x_hat,  dbeta = sum_M g  (per-block partials, summed
                                                 here with torch.sum)

On a CPU tensor it runs `layer_norm_bwd_reference`, the same math in plain
PyTorch (the JAX package's fallback, `layernorm.py:139-155`). A tensor on
any other device raises; nothing falls back from the kernel.
"""

from __future__ import annotations

import torch

#: kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0


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
    gamma = gamma.float().contiguous()
    dx = torch.empty_like(x)
    blocks = lib.occm_layernorm_bwd_blocks(m)
    dgamma_part = torch.empty((blocks, d), dtype=torch.float32,
                              device=x.device)
    dbeta_part = torch.empty_like(dgamma_part)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.occm_layernorm_bwd(
            x.data_ptr(), gamma.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dgamma_part.data_ptr(), dbeta_part.data_ptr(), m, d, float(eps),
            int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"occm_layernorm_bwd failed: cudaError_t {err}")
    LAUNCHES += 1
    return dx, dgamma_part.sum(dim=0), dbeta_part.sum(dim=0)


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
