"""Fused multi-head attention forward for the XLSR transformer.

`flash_attention(q, k, v)` on [B, T, H, D] is the port of
`occm_tpu.ops.attention.flash_attention`. On a CUDA tensor it launches the
hand-written Hopper kernel `csrc/flash_attn_fwd.cu`, which replaces both TPU
forward kernels (the whole-T `_fwd_kernel` and the blocked online-softmax
`_blocked_fwd_kernel`; their split at T = 512 only existed for TPU VMEM). On
a CPU tensor it runs `flash_attention_reference`, the kernel's plain PyTorch
version: same masking, scale folding and dtype casts. A tensor on any other
device raises; nothing falls back from the kernel to the plain version.

For every T the port casts the unnormalised probabilities to bf16 before
P·V and divides by the row sum afterwards, as the blocked TPU kernel does;
the whole-T TPU kernel normalises before the cast. In bf16 the two differ
by one rounding of P (relative 2^-9); in fp32 they agree.

`reference_attention` is the plain einsum attention (the "xla" impl).
"""

from __future__ import annotations

import math

import torch

#: kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, t_valid: int):
    """Plain version of the kernel on its own layout: q, k, v [BH, T, D]
    (keys at index >= t_valid masked) -> (out [BH, T, D] in q's dtype,
    lse [BH, T] fp32). Mirrors the blocked TPU kernel's arithmetic: scale
    folded into q in fp32 before the cast to q's dtype, fp32 logits and
    softmax, unnormalised probabilities cast to v's dtype for the P·V
    product, fp32 sum divided by the row sum at the end."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q.float() * scale).to(q.dtype)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(col >= t_valid, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        t_valid: int):
    """The kernel's wrapper: q, k, v [BH, T, D] -> (out, lse).

    CUDA tensors launch `occm_flash_attn_fwd` on the current stream (bf16,
    D = 64, contiguous); CPU tensors take the plain version."""
    global LAUNCHES
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v on different devices: {q.device}, {k.device}, "
            f"{v.device}")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"expected q, k, v of one shape [BH, T, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, T, d = q.shape
    if not 1 <= t_valid <= T:
        raise ValueError(f"t_valid={t_valid} outside [1, {T}]")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, t_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"the CUDA kernel takes bf16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if d != 64:
        raise ValueError(f"the CUDA kernel takes head dim 64, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous q, k, v")

    from occm_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty_like(q)
    lse = torch.empty((bh, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.occm_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, T, t_valid, d, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"occm_flash_attn_fwd failed: cudaError_t {err}")
    LAUNCHES += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Fused MHA: q, k, v [B, T, H, D] (unscaled q) -> [B, T, H, D]."""
    B, T, H, D = q.shape

    def flat(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()

    out, _ = flash_attention_fwd(flat(q), flat(k), flat(v), T)
    return out.reshape(B, H, T, D).permute(0, 2, 1, 3)


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain einsum attention, same signature and semantics as
    flash_attention: fp32 logits and softmax, probabilities cast to v's
    dtype."""
    D = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * (1.0 / math.sqrt(D)), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
