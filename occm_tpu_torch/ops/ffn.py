"""Fused transformer FFN, y = GELU(x·W1 + b1)·W2 + b2 (port of
`occm_tpu.ops.ffn.fused_ffn`).

`fused_ffn(x [..., D], w1 [D, F], b1 [F], w2 [F, D], b2 [D], approximate)`
keeps the JAX package's layout. It is a `torch.autograd.Function`: on a CUDA
tensor its forward launches the hand-written Hopper kernel
`csrc/ffn_fwd.cu` twice (fc1 + GELU into a bf16 [M, F] scratch that stays
in L2, then fc2; `wgmma` fed by TMA), which replaces the TPU kernel
`_kernel`; in fp32 it launches `csrc/ffn_fwd_3xtf32.cu` twice the same way
(`wgmma` fed by TMA in 3xTF32: each product three TF32 products into fp32
sums, D and F multiples of 4), or, at any other fp32 D and F,
`csrc/ffn_fwd_f32.cu` (a SIMT sgemm with the same epilogue, true fp32),
which replace the same TPU kernel where it runs in fp32; on a CPU tensor
it runs
`ffn_reference`, the kernel's plain PyTorch version. A tensor on any other
device raises; nothing falls back from the kernel to the plain version. The kernel reads the weights as `nn.Linear` stores them
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

#: calls of `ffn_fwd` that launched the kernel (two device launches each,
#: fc1 and fc2) since the last reset; chip_smoke.py reads and resets it
LAUNCHES = 0
#: the same for the fp32 kernels: the SIMT sgemm (csrc/ffn_fwd_f32.cu) and
#: the 3xTF32 tensor-core GEMM (csrc/ffn_fwd_3xtf32.cu)
F32_LAUNCHES = 0
TF32_LAUNCHES = 0

#: the epilogue's activation, as `occm_ffn_gemm` takes it
ACT_NONE, ACT_GELU_ERF, ACT_GELU_TANH = 0, 1, 2


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
    """Contiguous, with its first element on a 16-byte boundary (TMA's
    rule for a tensor's base address)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def gemm_bias_act(entry: str, a: torch.Tensor, b: torch.Tensor,
                  bias: torch.Tensor, act: int) -> torch.Tensor:
    """One launch of a kernel of the library on the current stream:
    act(a [M, K] b [N, K]^T + bias [N]) in a's dtype. `entry`:
    "occm_ffn_gemm" (csrc/ffn_fwd.cu, bf16, tiles of 128 x 256; N and K
    multiples of 8), "occm_ffn_gemm_3xtf32" (csrc/ffn_fwd_3xtf32.cu, fp32
    on the tensor cores, tiles of 128 x 192 or 128; N and K multiples of
    4) or "occm_ffn_gemm_f32" (csrc/ffn_fwd_f32.cu, the SIMT fp32 kernel,
    tiles of 128 x 128, any shape). The caller checks the arguments: CUDA,
    contiguous, and for the TMA kernels 16-byte aligned."""
    from occm_tpu_torch.ops import _build

    lib = _build.load()
    m, k = a.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    with _build.on_device(a.device):
        err = getattr(lib, entry)(
            a.data_ptr(), b.data_ptr(), bias.data_ptr(), out.data_ptr(), m,
            n, k, act, _build.raw_stream(a.device))
    if err != 0:
        raise RuntimeError(f"{entry} failed: error {err} (a cudaError_t, "
                           "or -1000 - CUresult of a TMA descriptor)")
    return out


def ffn_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor,
            approximate: bool) -> torch.Tensor:
    """The kernel's wrapper: x [M, D], w1 [D, F], b1 [F], w2 [F, D], b2 [D]
    -> y [M, D].

    CUDA tensors make two device launches on the current stream: fc1 (+ b1,
    GELU, into a bf16 [M, F] scratch that stays in L2) and fc2 (+ b2), in
    output tiles of 128 x 256. It takes bf16, M >= 1 and D, F
    multiples of 8 (TMA needs 16-byte row strides). fp32 x and weights
    launch the 3xTF32 kernel twice the same way (an fp32 [M, F] scratch,
    tiles of 128 x 192 or 128) where D and F are multiples of 4, else the
    SIMT kernel (tiles of 128 x 128, any M, D, F). Mixed dtypes raise. CPU
    tensors take the plain version."""
    global LAUNCHES, F32_LAUNCHES, TF32_LAUNCHES
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return ffn_reference(x, w1, b1, w2, b2, approximate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn runs on cuda or cpu, not {x.device}")
    dtypes = {t.dtype for t in (x, w1, b1, w2, b2)}
    if dtypes == {torch.float32}:
        # TMA reads rows of 16-byte multiples: D and F multiples of 4
        tensor_cores = x.shape[1] % 4 == 0 and w1.shape[1] % 4 == 0
        entry = "occm_ffn_gemm_3xtf32" if tensor_cores else "occm_ffn_gemm_f32"
        w1t, w2t = _aligned(w1.t()), _aligned(w2.t())  # the nn.Linear weights
        h = gemm_bias_act(entry, _aligned(x), w1t, b1.contiguous(),
                          ACT_GELU_TANH if approximate else ACT_GELU_ERF)
        y = gemm_bias_act(entry, h, w2t, b2.contiguous(), ACT_NONE)
        if tensor_cores:
            TF32_LAUNCHES += 1
        else:
            F32_LAUNCHES += 1
        return y
    if dtypes != {torch.bfloat16}:
        raise ValueError(
            "the CUDA kernels take bf16 or fp32 x and weights of one dtype, "
            f"got {[str(t.dtype) for t in (x, w1, b1, w2, b2)]}")
    m, d = x.shape
    f = w1.shape[1]
    if m < 1 or d % 8 or f % 8:
        raise ValueError(f"the CUDA kernel takes M >= 1 and D, F multiples of "
                         f"8 (16-byte row strides); got M={m}, D={d}, F={f}")
    x = _aligned(x)
    w1t, w2t = _aligned(w1.t()), _aligned(w2.t())  # fc1.weight, fc2.weight
    h = gemm_bias_act("occm_ffn_gemm", x, w1t, _aligned(b1),
                      ACT_GELU_TANH if approximate else ACT_GELU_ERF)
    y = gemm_bias_act("occm_ffn_gemm", h, w2t, _aligned(b2), ACT_NONE)
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
    w1 [D, F], w2 [F, D]. On the card the hidden activation goes through
    an L2-resident bf16 scratch; the gradient is JAX's `_ffn_bwd`."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    y = _FusedFFN.apply(x.reshape(-1, d), w1, b1, w2, b2, approximate)
    return y.reshape(*lead, d)
