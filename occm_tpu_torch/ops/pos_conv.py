"""The wav2vec2 relative positional conv (k=128, groups=16) in PyTorch.

Port of `occm_tpu.ops.pos_conv`: one function in three layouts, selected
by `XLSRConfig.pos_conv_impl` (`POS_CONV_IMPLS`):

  grouped   one grouped conv (groups=G)
  batched   the groups folded into a batch dim: G convs of C/G channels,
            one per channel block, batched with torch.func.vmap
  s2d       space-to-depth: T -> T/S positions x S-tap channel blocks, so
            each of the K/S + 1 taps contracts S*(C/G) channels per group;
            the kernel is regathered from the canonical one on every call
            (it trains), and the gather's backward is a scatter-add

The port keeps torch's own layouts: activations [B, C, T] and the weight
[C, C/G, K] (fairseq's `encoder.pos_conv.0` layout), the same tensor in
every layout, so the gradient reaches it (and, through the fold, fairseq's
weight-norm pair) alike. These are plain convs, as in the JAX package
(`lax.conv_general_dilated`, no Pallas kernel). SamePad cropping (fairseq
drops the trailing output for even K) is done by the caller.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def pos_conv_grouped(x: torch.Tensor, w: torch.Tensor, groups: int,
                     bias: torch.Tensor = None) -> torch.Tensor:
    """[B, C, T] x [C, C/G, K] -> [B, C, T + 1 - K % 2] grouped conv with
    K // 2 zero padding on both sides."""
    return F.conv1d(x, w, bias, padding=w.shape[-1] // 2, groups=groups)


def pos_conv_batched(x: torch.Tensor, w: torch.Tensor,
                     groups: int) -> torch.Tensor:
    """The groups folded into a batch dim (JAX's batch_group_count): batch
    group g convolves channel block g of x against filter block g of w ->
    [B, C, T + 1 - K % 2]."""
    b, c, t = x.shape
    cp = c // groups
    pad = w.shape[-1] // 2
    xg = x.reshape(b, groups, cp, t).transpose(0, 1)      # [G, B, C/G, T]
    wg = w.reshape(groups, cp, cp, w.shape[-1])           # [G, C/G, C/G, K]
    out = torch.func.vmap(lambda xi, wi: F.conv1d(xi, wi, padding=pad))(
        xg, wg)                                           # [G, B, C/G, T']
    return out.transpose(0, 1).reshape(b, c, out.shape[-1])


@functools.lru_cache(maxsize=None)
def _s2d_tap_index(k: int, s: int, device: torch.device):
    """tap = s*m + j - r for (m, j, r) flattened, and where it lies in
    [0, k), as tensors on `device` (made once: a CUDA graph cannot capture
    their upload)."""
    m_taps = (k - 1 + s - 1) // s + 1
    m = np.arange(m_taps)[:, None, None]
    j = np.arange(s)[None, :, None]
    r = np.arange(s)[None, None, :]
    tap = s * m + j - r
    valid = (tap >= 0) & (tap < k)
    return (torch.as_tensor(np.where(valid, tap, 0).reshape(-1),
                            device=device),
            torch.as_tensor(valid, device=device), m_taps)


def pos_conv_s2d(x: torch.Tensor, w: torch.Tensor, groups: int,
                 s: int = 8) -> torch.Tensor:
    """Space-to-depth: pos_conv_grouped(x, w, groups)'s first T outputs up
    to fp reassociation, as a conv over T/s positions with s*(C/G)-deep
    contractions per group -> [B, C, T]."""
    b, c, t = x.shape
    cp = c // groups
    k = w.shape[-1]
    pad = k // 2
    taps, valid, m_taps = _s2d_tap_index(k, s, w.device)
    sp = -(-t // s)                       # ceil(T/s) output blocks
    xp = F.pad(x, (pad, pad + s * sp - t))
    ts = xp.shape[-1] // s
    # u[b, (g, j, ci), p] = xp[b, g*cp + ci, p*s + j]: group-major channels,
    # so groups=G splits them contiguously
    u = (xp.reshape(b, groups, cp, ts, s).permute(0, 1, 4, 2, 3)
         .reshape(b, groups * s * cp, ts))
    # w2[(g, r, co), (j, ci), m] = w[g*cp + co, ci, s*m + j - r]
    wg = w.index_select(2, taps).reshape(c, cp, m_taps, s, s)
    wg = torch.where(valid, wg, wg.new_zeros(()))
    w2 = (wg.reshape(groups, cp, cp, m_taps, s, s)
          .permute(0, 5, 1, 4, 2, 3)
          .reshape(groups * s * cp, s * cp, m_taps))
    out = F.conv1d(u, w2, groups=groups)  # [B, (g, r, co), sout]
    sout = out.shape[-1]
    out = (out.reshape(b, groups, s, cp, sout).permute(0, 1, 3, 4, 2)
           .reshape(b, c, sout * s))
    # the s2d blocks round the length; every layout agrees on the first T
    # positions, and the model crops to T (SamePad) anyway
    return out[:, :, :t]


POS_CONV_IMPLS = {
    "grouped": pos_conv_grouped,
    "batched": pos_conv_batched,
    "s2d": pos_conv_s2d,
}
